"""The port's `ropebwt` (fermi_tpu_torch/cli/main.py) against fermi_tpu's
CLI: the three engines (the host rope bpr, the device BCR, the device
prefix doubling `sais`) on the CPU, text and `-b` RLE6, with and without
-N, -O, -F and -R, byte-equal to fermi_tpu's output on the same FASTQ; and
the rope builder itself against fermi_tpu's on reads holding N."""

import numpy as np
import pytest
import torch

from fermi_tpu.cli.main import main as jmain
from fermi_tpu.construct.bprope import bpr_bwt as jbpr
from fermi_tpu.construct import suffix as jsuffix
from fermi_tpu_torch.cli.main import main as tmain
from fermi_tpu_torch.construct.bprope import bpr_bwt as tbpr

from native_lock import load_fermi_tpu_native
from util import random_reads

torch.set_num_threads(1)
load_fermi_tpu_native()

FLAGS = [[], ["-N"], ["-O"], ["-F"], ["-R"], ["-N", "-R"]]


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """Genome reads, one in five with an N, and two reverse-complement
    palindromes (trimmed by 1 bp unless -O, -F or -R)."""
    rng = np.random.default_rng(11)
    reads = random_reads(80, min_len=30, max_len=90, seed=12,
                         with_genome=True, genome_len=1200)
    for i in range(0, len(reads), 5):
        b = list(reads[i])
        b[int(rng.integers(0, len(b)))] = "N"
        reads[i] = "".join(b)
    reads += ["ACGTACGT", "GGATCC"]
    path = tmp_path_factory.mktemp("rope") / "r.fq"
    path.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                            for i, r in enumerate(reads)))
    return str(path)


@pytest.fixture(scope="module")
def fermi_out(fastq, tmp_path_factory):
    """fermi_tpu's CLI output for each (flags, -b), by its rope engine."""
    d = tmp_path_factory.mktemp("fermi")
    out = {}
    for flags in FLAGS:
        for binary in (False, True):
            path = d / f"{''.join(flags)}{int(binary)}.out"
            argv = ["ropebwt", "-a", "bpr", *flags, *(["-b"] if binary
                                                      else []),
                    "-o", str(path), fastq]
            assert jmain(argv) == 0
            out[tuple(flags), binary] = path.read_bytes()
    return out


@pytest.mark.parametrize("binary", [False, True], ids=["text", "rle6"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join(f) or "none")
@pytest.mark.parametrize("algo", ["bpr", "bcr", "sais"])
def test_ropebwt_equals_fermi_tpu(fastq, fermi_out, tmp_path, algo, flags,
                                  binary):
    path = tmp_path / "o"
    argv = ["ropebwt", "-a", algo, "--device", "cpu", *flags,
            *(["-b"] if binary else []), "-o", str(path), fastq]
    assert tmain(argv) == 0
    got = path.read_bytes()
    assert got == fermi_out[tuple(flags), binary]
    if algo != "bpr":
        # fermi_tpu's own engine of the same name agrees too
        want = tmp_path / "w"
        assert jmain([a for a in argv if a not in ("--device", "cpu")
                      ][:-3] + ["-o", str(want), fastq]) == 0
        assert got == want.read_bytes()


def test_ropebwt_to_stdout(fastq, fermi_out, capsysbinary):
    assert tmain(["ropebwt", "-b", fastq]) == 0
    assert capsysbinary.readouterr().out == fermi_out[(), True]
    assert tmain(["ropebwt", fastq]) == 0
    assert capsysbinary.readouterr().out == fermi_out[(), False]


def test_ropebwt_long_runs(tmp_path):
    """Runs longer than 31 symbols are cut into 31s in the RLE6 stream."""
    path = tmp_path / "r.fa"
    path.write_text("".join(f">r{i}\n{'A' * 70}\n" for i in range(40)))
    for engine in ("bpr", "sais"):
        out = {}
        for main, dv in ((tmain, ["--device", "cpu"]), (jmain, [])):
            o = tmp_path / f"{engine}{len(dv)}"
            assert main(["ropebwt", "-a", engine, *dv, "-b", "-R", "-o",
                         str(o), str(path)]) == 0
            out[main] = o.read_bytes()
        assert out[tmain] == out[jmain]
        assert (31 << 3 | 1) in out[tmain]


def test_bpr_bwt_reads_with_n():
    rng = np.random.default_rng(5)
    seqs = [rng.integers(1, 6, int(rng.integers(1, 120))).astype(np.uint8)
            for _ in range(300)]
    got = tbpr(seqs)
    assert np.array_equal(got, jbpr(seqs))
    assert np.array_equal(got, jsuffix.multistring_bwt(
        jsuffix.build_text(seqs, both_strands=False, trim_palindrome=False)))
    assert tbpr([]).size == 0
