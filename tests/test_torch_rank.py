"""Kernel K1 and the port's FMDIndex against fermi_tpu, bit for bit.

The port (fermi_tpu_torch, on the CPU: the kernel's plain version) and
fermi_tpu (JAX on the CPU; its Pallas rank kernel in interpret mode) get
the same numpy-seeded inputs.  Every output is an integer, so the
tolerance is equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fermi_tpu import rld as jrld
from fermi_tpu.index import fmd as jfmd
from fermi_tpu.ops import rank_pallas
from fermi_tpu_torch import rld as trld
from fermi_tpu_torch.index import fmd as tfmd
from fermi_tpu_torch.ops import rank_cuda

from native_lock import load_fermi_tpu_native

# The port's CPU ops are small: one thread each keeps parallel test
# workers from oversubscribing the cores, where OpenMP spin-waits
# slow every op by orders of magnitude.
torch.set_num_threads(1)
load_fermi_tpu_native()

FIELDS = ("bwt_blocks", "occ", "cnt", "mcnt", "bwt_packed", "fused")


def _bwt():
    # the tests/test_rank.py case: non-uniform mix, long runs, rare symbols
    rng = np.random.default_rng(42)
    return np.concatenate([rng.integers(0, 6, 3000).astype(np.uint8),
                           np.full(700, 3, np.uint8),
                           np.full(5, 5, np.uint8),
                           rng.integers(1, 5, 2000).astype(np.uint8)])


@pytest.fixture(scope="module")
def pair():
    bwt = _bwt()
    return bwt, jfmd.FMDIndex.from_bwt(bwt), \
        tfmd.FMDIndex.from_bwt(bwt, device="cpu")


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def _rows(n, seed):
    """n random packed block rows (nibbles 0..6) and every offset 0..128."""
    rng = np.random.default_rng(seed)
    nib = rng.integers(0, 7, (n, 16, 8)).astype(np.uint32)
    words = np.zeros((n, 16), np.uint32)
    for s in range(8):
        words |= nib[:, :, s] << (4 * s)
    off = np.arange(n, dtype=np.int32) % 129
    return words.astype(np.int32), off


def test_plain_k1_matches_pallas_and_swar():
    words, off = _rows(129 * 8, seed=1)
    got = rank_cuda.rank_block_counts(torch.from_numpy(words),
                                      torch.from_numpy(off)).numpy()
    pallas = np.asarray(rank_pallas.rank_block_counts(
        jnp.asarray(words), jnp.asarray(off), interpret=True))
    swar = np.asarray(jfmd._swar_rank_count(jnp.asarray(words),
                                            jnp.asarray(off)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got[:, :6], swar)


def test_plain_fused_rank_unsigned_occ():
    """Fused occ patterns >= 2^31 (negative int32) widen as unsigned in the
    int64 domain; every in-block offset, keys at block starts and ends."""
    words, _ = _rows(300, seed=2)
    rng = np.random.default_rng(3)
    occ = rng.integers(2**31 - 1000, 2**32 - 200, (300, 6)).astype(np.uint64)
    fused = np.zeros((300, 24), np.int32)
    fused[:, :16] = words
    fused[:, 16:22] = occ.astype(np.uint32).view(np.int32)
    k = np.concatenate([rng.integers(0, 300 * 128, 4000),
                        np.arange(0, 300 * 128, 127)]).astype(np.int64)
    got = rank_cuda.rank6_fused(torch.from_numpy(fused),
                                torch.from_numpy(k)).numpy()
    blk, off = k >> 7, (k & 127).astype(np.int32)
    within = np.asarray(jfmd._swar_rank_count(jnp.asarray(words[blk]),
                                              jnp.asarray(off)))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, occ[blk].astype(np.int64) + within)


@pytest.mark.parametrize("build", ["from_bwt", "from_runs", "from_arrays"])
def test_index_arrays_match(pair, build):
    bwt, jidx, _ = pair
    if build == "from_bwt":
        tidx = tfmd.FMDIndex.from_bwt(bwt, device="cpu")
    elif build == "from_runs":
        runs = trld.Runs.from_bwt(bwt)
        tidx = tfmd.FMDIndex.from_runs(runs, device="cpu")
        jidx = jfmd.FMDIndex.from_runs(jrld.Runs.from_bwt(bwt))
    else:
        tidx = tfmd.FMDIndex.from_arrays(
            *(np.asarray(getattr(jidx, f)) for f in FIELDS), device="cpu")
    for f in FIELDS:
        _eq(getattr(jidx, f), getattr(tidx, f).numpy())
    assert tidx.idtype == torch.int32 and tidx.total == bwt.size


def test_full_sweep(pair):
    """rank6, rank6_dense, sym_at and lf at every k in [0, n], plus the
    brute-force counts (the `fermi chkbwt -r` property)."""
    bwt, jidx, tidx = pair
    n = bwt.size
    ks = np.arange(n + 1, dtype=np.int64)
    want = np.zeros((n + 1, 6), np.int64)
    for c in range(6):
        want[1:, c] = np.cumsum(bwt == c)
    tk = torch.from_numpy(ks)
    _eq(tidx.rank6(tk).numpy(), want)
    _eq(tidx.rank6_dense(tk).numpy(), want)
    _eq(tidx.rank6(tk).numpy(), jidx.rank6(jnp.asarray(ks)))
    # [B, W] query matrices: the SMEM loop's shape
    sel = np.random.default_rng(3).integers(0, n + 1, (64, 32))
    _eq(tidx.rank6(torch.from_numpy(ks[sel])).numpy(), want[sel])
    _eq(tidx.sym_at(tk[:-1]).numpy(), bwt)
    for a, b in zip(tidx.lf(tk[:-1]), jidx.lf(jnp.asarray(ks[:-1]))):
        _eq(a.numpy(), b)


@pytest.mark.parametrize("is_back", [True, False])
def test_extend6_set_intv(pair, is_back):
    # every k in [0, n] as the primary start, with a size that stays in
    # the BWT
    bwt, jidx, tidx = pair
    n = bwt.size
    rng = np.random.default_rng(4)
    prim = np.arange(n + 1)
    sz = rng.integers(0, n + 1 - prim)
    other = rng.integers(0, n + 1, n + 1)
    kb, kf = (prim, other) if is_back else (other, prim)
    got = tidx.extend6(*(torch.from_numpy(v) for v in (kb, kf, sz)), is_back)
    want = jidx.extend6(*(jnp.asarray(v.astype(np.int32))
                          for v in (kb, kf, sz)), is_back)
    for a, b in zip(got, want):
        _eq(a.numpy(), b)
    c = np.arange(6)
    for a, b in zip(tidx.set_intv(torch.from_numpy(c)),
                    jidx.set_intv(jnp.asarray(c))):
        _eq(a.numpy(), b)


def test_forced_int64_domain(monkeypatch, pair):
    """FERMI_TPU_IDX_DTYPE=int64 on both sides: the port keeps fused rows
    (occ fits 32 bits) and widens through them; fermi_tpu gathers the
    packed words.  Results equal over every k."""
    bwt = pair[0]
    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    jidx = jfmd.FMDIndex.from_bwt(bwt)
    tidx = tfmd.FMDIndex.from_bwt(bwt, device="cpu")
    assert tidx.idtype == torch.int64 and tidx.fused is not None
    ks = np.arange(bwt.size + 1, dtype=np.int64)
    got = tidx.rank6(torch.from_numpy(ks))
    assert got.dtype == torch.int64
    _eq(got.numpy(), jidx.rank6(jnp.asarray(ks)))
    # the packed-words path of rank6 (taken where fused rows cannot exist)
    nofuse = tfmd.FMDIndex(tidx.bwt_blocks, tidx.occ, tidx.cnt, tidx.mcnt,
                           tidx.bwt_packed, None)
    _eq(nofuse.rank6(torch.from_numpy(ks)).numpy(), got.numpy())
    rng = np.random.default_rng(5)
    kb, kf, sz = (rng.integers(0, bwt.size // 2, 128) for _ in range(3))
    for is_back in (True, False):
        for a, b in zip(tidx.extend6(*(torch.from_numpy(v) for v in
                                       (kb, kf, sz)), is_back),
                        jidx.extend6(*(jnp.asarray(v) for v in (kb, kf, sz)),
                                     is_back)):
            _eq(a.numpy(), b)


def test_unfused_rows_int64(monkeypatch, tmp_path):
    """The layout of an index past 2^32 - 128 symbols, and fermi_tpu's for
    every index past 2^31: the int64 domain without fused rows, rank6 by
    a row gather, K1's `rank_block_counts` and the occ row.  rank6 at every
    k and `smem_all` of mutated reads equal the fused index's and
    fermi_tpu's."""
    import dataclasses

    from fermi_tpu.core import dna
    from fermi_tpu.search import smem as jsm
    from fermi_tpu_torch.search import smem as tsm
    from util import build_my_fmd, random_reads

    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    reads = random_reads(150, seed=5, with_genome=True, genome_len=4000)
    fmd = str(tmp_path / "i.fmd")
    build_my_fmd(reads, fmd)
    jidx = jfmd.FMDIndex.restore(fmd)
    fused = tfmd.FMDIndex.restore(fmd, device="cpu")
    assert fused.idtype == torch.int64 and fused.fused is not None
    unfused = dataclasses.replace(fused, fused=None)
    ks = torch.arange(fused.total + 1, dtype=torch.int64)
    got = unfused.rank6(ks)
    assert got.dtype == torch.int64
    assert torch.equal(got, fused.rank6(ks))
    _eq(got.numpy(), jidx.rank6(jnp.asarray(ks.numpy())))
    rng = np.random.default_rng(8)
    seqs = []
    for s in reads[::3]:
        b = dna.encode(s)
        b[rng.integers(0, len(b), 2)] = rng.integers(1, 5, 2)
        seqs.append(b)
    want = tsm.smem_all(fused, seqs)
    assert tsm.smem_all(unfused, seqs) == want == jsm.smem_all(jidx, seqs)
    assert sum(map(len, want)) > len(seqs)


def test_pick_idtype():
    assert tfmd._pick_idtype(1000) == torch.int32
    assert tfmd._pick_idtype(2**31 - tfmd.BLOCK - 1) == torch.int32
    assert tfmd._pick_idtype(2**31) == torch.int64
