"""The port's smem_all and api.smem against fermi_tpu, on the cases of
tests/test_smem.py.

The oracle is fermi_tpu's SMEM search: its device path (JAX on the CPU,
compiled once here, the costly part) for the genome-read case, and its
native sequential engine `smem_all_native` — which emits the same tuples —
for the rest.  Every field is an integer, so the tolerance is equality.
"""

import numpy as np
import pytest
import torch

from fermi_tpu.core import dna
from fermi_tpu.index.fmd import FMDIndex as JIndex
from fermi_tpu.search import smem as jsm
from fermi_tpu_torch import api
from fermi_tpu_torch.index.fmd import FMDIndex as TIndex
from fermi_tpu_torch.search import smem as tsm

from util import random_reads, build_my_fmd

# The port's CPU ops are small: one thread each keeps parallel test
# workers from oversubscribing the cores, where OpenMP spin-waits
# slow every op by orders of magnitude.
torch.set_num_threads(1)


def _pair(tmp_path, reads, name="i.fmd"):
    fmd = str(tmp_path / name)
    build_my_fmd(reads, fmd)
    return JIndex.restore(fmd), TIndex.restore(fmd, device="cpu")


def _mutated(reads, seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in reads:
        b = list(s)
        for _ in range(rng.integers(0, 3)):
            b[rng.integers(0, len(b))] = "ACGT"[rng.integers(0, 4)]
        out.append("".join(b))
    return out


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    idx_reads = random_reads(150, seed=5, with_genome=True, genome_len=4000)
    qry = _mutated(random_reads(60, seed=6, with_genome=True,
                                genome_len=4000), 9)
    jidx, tidx = _pair(tmp_path_factory.mktemp("g"), idx_reads)
    return idx_reads, [dna.encode(s) for s in qry], jidx, tidx


@pytest.mark.parametrize("self_match", [False, True])
def test_genome_reads_match_device_path(genome, self_match):
    _, seqs, jidx, tidx = genome
    got = tsm.smem_all(tidx, seqs, self_match=self_match)
    assert got == jsm.smem_all(jidx, seqs, self_match=self_match)
    assert sum(map(len, got)) > len(seqs)


def test_self_queries_and_api(genome):
    idx_reads, _, jidx, tidx = genome
    seqs = [dna.encode(s) for s in idx_reads[:40]]
    want = jsm.smem_all_native(jidx, seqs, self_match=True)
    assert tsm.smem_all(tidx, seqs, self_match=True) == want
    for s, w in zip(idx_reads[:3], want[:3]):
        assert api.smem(tidx, s, self_match=True) == w


def test_random_queries(tmp_path):
    jidx, tidx = _pair(tmp_path, random_reads(100, seed=1))
    seqs = [dna.encode(s) for s in
            random_reads(50, seed=2, min_len=10, max_len=40)]
    assert tsm.smem_all(tidx, seqs) == jsm.smem_all_native(jidx, seqs)


def test_redo_ladder_forced_by_tiny_buffers(genome):
    """maxi=4, maxm=8: nearly every read overflows and rides the whole
    redo ladder (2x, 8x, guaranteed size); results stay exact."""
    _, seqs, jidx, tidx = genome
    seqs = seqs[:30]
    before = tsm.STATS["redo"]
    got = tsm.smem_all(tidx, seqs, maxi=4, maxm=8)
    assert tsm.STATS["redo"] - before > len(seqs) // 2
    assert got == jsm.smem_all_native(jidx, seqs)


def test_high_coverage_adaptive_maxi(tmp_path):
    """25x coverage: the default width overflows heavily, the ladder keeps
    results exact, the learned width rises above 32, and a second call at
    the learned width stays exact."""
    rng = np.random.default_rng(9)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 9000))
    reads = []
    for _ in range(2500):   # 2500 * 90 / 9000 = 25x
        pos = int(rng.integers(0, len(genome) - 90))
        reads.append(genome[pos:pos + 90])
    jidx, tidx = _pair(tmp_path, reads)
    seqs = [dna.encode(s) for s in reads[:120]]
    want = jsm.smem_all_native(jidx, seqs, self_match=True)
    assert tsm.smem_all(tidx, seqs, self_match=True) == want
    assert getattr(tidx, "_smem_maxi", 32) > 32
    assert tsm.smem_all(tidx, seqs, self_match=True) == want


def test_short_queries_and_empty_reads(genome):
    idx_reads, _, jidx, tidx = genome
    rng = np.random.default_rng(42)
    qry = []
    for _ in range(200):
        src = idx_reads[rng.integers(0, len(idx_reads))]
        L = int(rng.integers(2, 6))
        p = int(rng.integers(0, len(src) - L))
        qry.append(dna.encode(src[p:p + L]))
    qry[5] = qry[77] = np.zeros(0, np.uint8)
    got = tsm.smem_all(tidx, qry)
    assert got[5] == [] and got[77] == []
    assert got == jsm.smem_all_native(jidx, qry)
    assert tsm.smem_all(tidx, [np.zeros(0, np.uint8)] * 3) == [[], [], []]


def _n_queries(reads, seed):
    """Queries from the index's reads: one in three ends in N (a symbol
    the N-free index lacks), some hold an inner N, some are all N."""
    rng = np.random.default_rng(seed)
    out = []
    for i, r in enumerate(reads):
        b = list(r[:int(rng.integers(20, len(r) + 1))])
        if i % 3 == 0:
            b[-1] = "N"
        if i % 4 == 1:
            b[int(rng.integers(0, len(b)))] = "N"
        out.append("".join(b))
    return [dna.encode(s) for s in out + ["N", "AN", "NNN"]]


@pytest.mark.parametrize("self_match", [False, True])
def test_queries_ending_in_n(genome, monkeypatch, self_match):
    """Fault F1: a query whose last symbol is absent from the index ends in
    a zero-size SMEM in fermi_tpu's native engine and its unified path, and
    the port emits it too; fermi_tpu's default split driver drops it (its
    pass B reads liveness from the size), which the port does not copy."""
    idx_reads, _, jidx, tidx = genome
    seqs = _n_queries(idx_reads[:60], 31)
    got = tsm.smem_all(tidx, seqs, self_match=self_match)
    assert got == jsm.smem_all_native(jidx, seqs, self_match=self_match)
    monkeypatch.setenv("FERMI_TPU_SMEM_SPLIT", "0")
    assert got == jsm.smem_all(jidx, seqs, self_match=self_match)
    last = [m[-1] for s, m in zip(seqs, got) if s[-1] == 5 and m]
    assert len(last) > 20
    assert all(m[2] == 0 and m[1] == m[0] + 1 for m in last)
    assert [m[:3] for m in got[-2]][1:] == [(1, 2, 0)]


def test_long_query_raises(genome):
    """A query longer than LONG_QUERY_LEN no longer raises: its batch goes
    whole to the native engine, which gives fermi_tpu's native tuples
    (tests/test_torch_remap.py holds it on queries up to 3,000 bp)."""
    _, seqs, jidx, tidx = genome
    batch = seqs[:5] + [dna.encode("ACGT" * 150)]
    assert tsm.smem_all(tidx, batch) == jsm.smem_all_native(jidx, batch)


def test_dead_slots_take_key_zero(genome, monkeypatch):
    """Every rank key of a dead interval slot is 0.  smem_all runs twice:
    with DEAD_KEY at -1 (no live key is negative) the dead slots of each
    loop step show; at the default, the same steps must send key 0 there
    and the same live keys elsewhere; both give fermi_tpu's tuples."""
    _, seqs, jidx, tidx = genome
    rank6 = TIndex.rank6
    runs = {}
    for dead in (-1, tsm.DEAD_KEY):
        keys = []

        def tap(self, k, keys=keys):
            keys.append(k.clone())
            return rank6(self, k)
        monkeypatch.setattr(tsm, "DEAD_KEY", dead)
        monkeypatch.setattr(TIndex, "rank6", tap)
        runs[dead] = (tsm.smem_all(tidx, seqs), keys)
    (marked, at_m1), (got, at_0) = runs[-1], runs[0]
    assert got == marked == jsm.smem_all(jidx, seqs)
    assert len(at_0) == len(at_m1) > 0
    n_dead = 0
    for a, b in zip(at_m1, at_0):
        dead = a == -1
        assert (b[dead] == 0).all() and torch.equal(a[~dead], b[~dead])
        n_dead += int(dead.sum())
    assert 0 < n_dead < sum(k.numel() for k in at_0)
