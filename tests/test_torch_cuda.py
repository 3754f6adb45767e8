"""The port on the card against the port on the CPU (its plain versions).

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from fermi_tpu_torch.core import dna
from fermi_tpu_torch.ops import rank_cuda
from fermi_tpu_torch.search import extend, smem

from util import random_reads, write_fasta

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    nib = rng.integers(0, 7, (n, 16, 8)).astype(np.uint32)
    words = np.zeros((n, 16), np.uint32)
    for s in range(8):
        words |= nib[:, :, s] << (4 * s)
    return (torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(np.arange(n, dtype=np.int32) % 129))


def test_k1_entry_points(card):
    w, off = _rows(129 * 64, seed=6)
    before = dict(rank_cuda.LAUNCHES)
    got = rank_cuda.rank_block_counts(w.to(card), off.to(card)).cpu()
    assert torch.equal(got, rank_cuda.rank_block_counts_plain(w, off))
    fused = torch.zeros((w.shape[0], 24), dtype=torch.int32)
    fused[:, :16] = w
    g = torch.Generator().manual_seed(7)
    fused[:, 16:22] = torch.randint(-2**31, 2**31 - 1, (w.shape[0], 6),
                                    generator=g, dtype=torch.int32)
    for dt in (torch.int64, torch.int32):
        k = torch.arange(w.shape[0] * 128, dtype=dt)
        got = rank_cuda.rank6_fused(fused.to(card), k.to(card)).cpu()
        assert got.dtype == dt
        assert torch.equal(got, rank_cuda.rank6_fused_plain(fused, k))
    assert rank_cuda.LAUNCHES["rank6_fused"] == before["rank6_fused"] + 2
    with pytest.raises(TypeError):
        rank_cuda.rank6_fused(fused.to(card), k.to(card).to(torch.int16))
    with pytest.raises(ValueError):
        rank_cuda.rank6_fused(fused.to(card), k.to(card)[::2])


@pytest.fixture(scope="module")
def pair(card):
    from fermi_tpu_torch.api import build_index
    reads = random_reads(150, seed=5, with_genome=True, genome_len=4000)
    return reads, build_index(reads, card), build_index(reads, "cpu")


def test_index_and_rank(pair):
    _, gidx, cidx = pair
    for f in ("bwt_blocks", "occ", "cnt", "mcnt", "bwt_packed", "fused"):
        assert torch.equal(getattr(gidx, f).cpu(), getattr(cidx, f)), f
    ks = torch.arange(cidx.total + 1)
    assert torch.equal(gidx.rank6(ks.to(gidx.device)).cpu(), cidx.rank6(ks))


def test_walks(pair):
    _, gidx, cidx = pair
    ids = torch.arange(cidx.n_seqs)
    for a, b in zip(extend.retrieve2(gidx, ids.to(gidx.device), 128),
                    extend.retrieve2(cidx, ids, 128)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(extend.seqrank_walk(gidx, ids.to(gidx.device), 64),
                    extend.seqrank_walk(cidx, ids, 64)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("maxi,self_match", [(None, False), (None, True),
                                             (4, False)])
def test_smem(pair, maxi, self_match):
    reads, gidx, cidx = pair
    qry = [dna.encode(s) for s in
           random_reads(80, seed=6, with_genome=True, genome_len=4000)]
    kw = dict(self_match=self_match)
    if maxi:
        kw.update(maxi=maxi, maxm=8)
    before = rank_cuda.LAUNCHES["rank6_fused"]
    got = smem.smem_all(gidx, qry, **kw)
    assert rank_cuda.LAUNCHES["rank6_fused"] > before
    assert got == smem.smem_all(cidx, qry, **kw)


def test_cli_exact(card, tmp_path):
    from fermi_tpu_torch.cli.main import main

    fa, qfa = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    write_fasta(fa, random_reads(100, seed=8, with_genome=True,
                                 genome_len=3000))
    write_fasta(qfa, random_reads(40, seed=9, with_genome=True,
                                  genome_len=3000))
    outs = []
    for dev in ("cuda", "cpu"):
        fmd = str(tmp_path / f"{dev}.fmd")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["build", "--device", dev, "-fo", fmd, fa]) == 0
            assert main(["unpack", "--device", dev, fmd]) == 0
            assert main(["exact", "--device", dev, fmd, qfa]) == 0
        outs.append((open(fmd, "rb").read(), buf.getvalue()))
    assert outs[0] == outs[1]
