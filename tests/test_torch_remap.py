"""The port's remap (algos/remap.py over native/remap.cpp, and the CLI
`remap`), the pipeline's rank and remap stages, and long-query SMEMs (the
native engine native/smem.cpp, and `exact` of queries over 512 bp) against
fermi_tpu on the CPU.  Bytes and integers: tolerance zero."""

import contextlib
import gzip
import io
import json

import numpy as np
import pytest
import torch

from fermi_tpu.cli.main import main as jmain
from fermi_tpu.core import dna
from fermi_tpu.index.fmd import FMDIndex as JIndex
from fermi_tpu.pipeline.driver import Pipeline as JPipeline
from fermi_tpu.search import smem as jsm
from fermi_tpu_torch.algos import remap as TR
from fermi_tpu_torch.algos.pykhash import KHash64
from fermi_tpu_torch.cli.main import main as tmain
from fermi_tpu_torch.core import fastx as tfastx
from fermi_tpu_torch.index.fmd import FMDIndex as TIndex
from fermi_tpu_torch.pipeline.driver import Pipeline as TPipeline
from fermi_tpu_torch.search import smem as tsm

from test_pipeline import make_pe_fastq
from util import random_reads, write_fasta

torch.set_num_threads(1)

STAGES = ("stage_raw_fmd", "stage_correct", "stage_ec_fmd", "stage_rank",
          "stage_unitig", "stage_clean", "stage_remap")


def _read(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """make_pe_fastq's paired reads of a 6 kbp genome (1,000 pairs of 70
    bp, insert 230 +- 20) through every stage to remap, in fermi_tpu (one
    unitig thread) and in the port."""
    d = tmp_path_factory.mktemp("pe")
    fq = make_pe_fastq(d, glen=6000, n_pairs=1000)
    pipes = (JPipeline(str(d / "j"), n_threads=2, unitig_k=40, paired=True,
                       unitig_threads=1),
             TPipeline(str(d / "t"), n_threads=2, unitig_k=40, paired=True,
                       device="cpu"))
    for p in pipes:
        for stage in STAGES:
            fn = getattr(p, stage)
            fn([fq]) if stage in STAGES[:2] else fn()
    return d


def test_rank_and_remap_stages(paired):
    """ec.rank, p3.mag.gz and insert.json equal fermi_tpu's stages."""
    d = paired
    for sfx in ("ec.fmd", "ec.rank", "p2.mag.gz", "p3.mag.gz"):
        assert _read(d / f"t.{sfx}") == _read(d / f"j.{sfx}"), sfx
    ins = json.loads(_read(d / "t.insert.json"))
    assert ins == json.loads(_read(d / "j.insert.json"))
    assert 200 < ins["avg"] < 260 and ins["cap"] > ins["avg"]


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return out.getvalue(), [ln for ln in err.getvalue().splitlines()
                            if ln.startswith("[M::remap]")]


@pytest.mark.parametrize("mode", ["cov", "rank", "broken"])
def test_cli_remap(paired, mode):
    """remap without the .rank array (coverage only), with it (pair
    links, the insert line) and `-c 2 -D cap` (contigs broken at
    unsupported stretches) prints fermi_tpu's bytes and insert line."""
    d = paired
    cap = str(json.loads(_read(d / "j.insert.json"))["cap"])
    flags = {"cov": [], "rank": ["-r", str(d / "j.ec.rank")],
             "broken": ["-c", "2", "-D", cap, "-r", str(d / "j.ec.rank")]}
    argv = ["remap", *flags[mode], str(d / "j.ec.fmd"),
            str(d / "j.p2.mag.gz")]
    got = _cli(tmain, argv)
    assert got == _cli(jmain, argv)
    assert len(got[1]) == 1 and got[0].count("\n") >= 4
    assert ("avg = 0.00" in got[1][0]) == (mode == "cov")
    assert ("_0\t" in got[0]) == (mode == "broken")


def test_native_paircov_equals_plain(paired):
    """native/remap.cpp's paircov equals the Python paircov over KHash64
    (fresh hash past 256 buckets, the pairing hash carried across
    contigs), contig by contig, with and without the .rank array."""
    d = paired
    idx = TIndex.restore(str(d / "t.ec.fmd"), "cpu")
    rank = np.fromfile(d / "t.ec.rank", np.uint64)
    # the contigs cut into pieces of 1,500 bp (pairs across a cut stay
    # unpaired), and a piece reversed
    seqs = [dna.encode(r.seq[i:i + 1500])
            for r in tfastx.read_fastx(str(d / "t.p2.mag.gz"))
            for i in range(0, len(r.seq), 1500)]
    seqs.append(seqs[0][::-1].copy())
    mems = tsm.smem_all_native(idx, seqs)
    for sorted_arr, skip in ((rank, 50), (None, -1)):
        pc = TR._NativePaircov(idx, sorted_arr, skip, 1000)
        try:
            got = pc.run_batch(seqs[:2]) + pc.run_batch(seqs[2:])
            got_rec = pc.stats()
        finally:
            pc.close()
        h, rec = KHash64(), [0, 0, 0]
        n_unp = 0
        for s, m, g in zip(seqs, mems, got):
            if h.n_buckets >= 256:
                h = KHash64()
            cov, pcv, n_supp, unp = TR.paircov(idx.n_seqs, sorted_arr, m,
                                               len(s), skip, 1000, h, rec)
            assert np.array_equal(g[0], cov) and np.array_equal(g[1], pcv)
            assert (g[2], g[3]) == (n_supp, unp)
            n_unp += len(unp)
        assert got_rec == rec
        if sorted_arr is not None:
            assert rec[0] > 100 and n_unp > 0


# -- long queries ---------------------------------------------------------


@pytest.fixture(scope="module")
def long_queries(tmp_path_factory):
    """A 6 kbp genome's reads, its index, and queries of 513-3,000 bp
    drawn from it with 1% substitutions (some with an N, some from a
    foreign genome)."""
    d = tmp_path_factory.mktemp("long")
    reads = random_reads(400, seed=71, with_genome=True, genome_len=6000)
    fa = str(d / "reads.fa")
    write_fasta(fa, reads)
    fmd = str(d / "i.fmd")
    assert tmain(["build", "--device", "cpu", "-fo", fmd, fa]) == 0
    rng = np.random.default_rng(72)
    qry = random_reads(24, seed=71, min_len=513, max_len=3000,
                       with_genome=True, genome_len=6000)
    qry += random_reads(3, seed=73, min_len=513, max_len=900)
    out = []
    for i, q in enumerate(qry):
        b = np.frombuffer(q.encode(), np.uint8).copy()
        err = np.flatnonzero(rng.random(b.size) < 0.01)
        b[err] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, err.size)]
        if i % 5 == 0:
            b[rng.integers(0, b.size)] = ord("N")
        out.append(b.tobytes().decode())
    qfa = str(d / "q.fa")
    write_fasta(qfa, out + ["ACGTAC" * 10])
    return fmd, qfa, [dna.encode(s) for s in out]


@pytest.mark.parametrize("self_match", [False, True])
def test_long_query_smems(long_queries, self_match):
    """smem_all sends a batch holding a query over LONG_QUERY_LEN to the
    native engine: the tuples of fermi_tpu's smem_all_native."""
    fmd, _, seqs = long_queries
    tidx = TIndex.restore(fmd, "cpu")
    want = jsm.smem_all_native(JIndex.restore(fmd), seqs, self_match)
    assert tsm.smem_all(tidx, seqs, self_match=self_match) == want
    assert tsm.smem_all_native(tidx, seqs, self_match) == want
    flat, counts = tsm.smem_all_native_raw(tidx, seqs, self_match)
    assert flat.shape == (sum(map(len, want)), 5) and counts.sum() > 100
    assert tidx._native_arrays[0].shape == tuple(tidx.bwt_blocks.shape)


@pytest.mark.parametrize("flag", [[], ["-s"]])
def test_cli_exact_long_queries(long_queries, flag):
    fmd, qfa, _ = long_queries
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tmain(["exact", "--device", "cpu", *flag, fmd, qfa]) == 0
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        assert jmain(["exact", *flag, fmd, qfa]) == 0
    assert out.getvalue() == want.getvalue()
    assert out.getvalue().count("SQ\t") == 28
