"""`merge` of chunk indexes as run-fermi.pl -B runs it after its build
jobs (the benchmark's celegans.merge cell, at a tiny size): chunks drawn
by portbench/reads.py, each indexed by Pipeline.build_index, merged
through the CLI on the CPU, and the merged .fmd decoded by the frozen
decoder (portbench/reference/rld.py) held to the plain BWT of the chunks'
reads in order (portbench/reference/bwt.py), header counts included.
Written to a file on disk or to a memfd, as the cell keeps its files in
RAM, the bytes are the same."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fermi_tpu_torch.algos import merge as mg  # noqa: E402
from fermi_tpu_torch.cli.main import main as cli  # noqa: E402
from fermi_tpu_torch.pipeline import driver  # noqa: E402
from portbench import reads  # noqa: E402
from portbench.reference import bwt as ref_bwt  # noqa: E402
from portbench.reference import rld as ref_rld  # noqa: E402

SEED = 2**33 + 21
TINY = {"genome_len": 6000, "n_pairs": 900}


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """Three chunks of one genome, each its own stream of the seed, as
    (.fmd path, its reads: mates 1 then mates 2)."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "celegans-srr065390-merge16.json")) as f:
        cfg = dict(json.load(f), **TINY)
    d = tmp_path_factory.mktemp("chunks")
    g = reads.genome(reads.rng_for(SEED, 0), cfg)
    out = []
    for c in range(3):
        fq = [str(d / f"c{c}_{m}.fq") for m in (1, 2)]
        r1, r2 = reads.pairs(reads.rng_for(SEED, 3 + c), g, cfg, fq)
        fmd = str(d / f"c{c}.fmd")
        driver.Pipeline(str(d / f"c{c}"), device="cpu").build_index(
            iter(()), fmd, paths=fq)
        out.append((fmd, np.concatenate([r1, r2])))
    return out


def _merge(fmds, out):
    assert cli(["merge", "-f", "-t", "8", "--device", "cpu", "-o", out,
                *fmds]) == 0
    with open(out, "rb") as f:
        return f.read()


def _memfd_path():
    fd = os.memfd_create("merged.fmd")
    return fd, f"/proc/self/fd/{fd}"


def _reference(chunks, **kw):
    text = ref_bwt.text_of(np.concatenate([r for _, r in chunks]))
    return ref_bwt.bwt_of_text(text, "cpu", **kw)


@pytest.mark.parametrize("where", ["disk", "ram"])
@pytest.mark.parametrize("n", [2, 3])
def test_merge_equals_the_plain_bwt(chunks, tmp_path, n, where):
    """Two chunks (the cell's fold), three (a rebuild of the running
    index between folds)."""
    fmds = [p for p, _ in chunks[:n]]
    if where == "ram":
        fd, path = _memfd_path()
        try:
            raw = _merge(fmds, path)
        finally:
            os.close(fd)
        assert raw == _merge(fmds, str(tmp_path / "merged.fmd"))
    else:
        raw = _merge(fmds, str(tmp_path / "merged.fmd"))
    assert ("rebuild" in mg.FILE_STATS["seconds"]) == (n == 3)
    counts, got, whole = ref_rld.decode(raw, "cpu")
    ref = _reference(chunks[:n])
    assert whole and got.numel() == ref.numel() == sum(
        mg.fmd_counts(p)[0] for p in fmds)
    assert torch.equal(got, ref)
    assert np.array_equal(counts, ref_bwt.counts_of(ref))


def test_the_comparison_can_fail(chunks, tmp_path):
    """The BWT of a generic suffix sort (every sentinel one symbol) is not
    the merged one: the comparison above tells them apart."""
    raw = _merge([p for p, _ in chunks[:2]], str(tmp_path / "merged.fmd"))
    _, got, _ = ref_rld.decode(raw, "cpu")
    wrong = _reference(chunks[:2], sentinels_ordered=False)
    assert got.numel() == wrong.numel()
    assert int((got != wrong).sum()) > 0
