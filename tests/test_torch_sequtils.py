"""The port's sequence tools (fermi_tpu_torch.cli.sequtils: splitfa,
trimseq, pe2cofq, cg2cofq, cnt2qual) against fermi_tpu on the CPU, by
function and through the CLI: bytes, tolerance zero."""

import contextlib
import gzip
import io

import numpy as np
import pytest

from fermi_tpu.cli import sequtils as jsu
from fermi_tpu.cli.main import main as jmain
from fermi_tpu_torch.cli import sequtils as tsu
from fermi_tpu_torch.cli.main import main as tmain

from native_lock import load_fermi_tpu_native

load_fermi_tpu_native()


def _records(rng, n, names):
    """FASTQ text: reads of 0-60 bp (N in some, low-quality tails and
    heads in others) named by `names(i)`, some with a comment."""
    out = []
    for i in range(n):
        ln = int(rng.integers(0, 61))
        s = "".join("ACGTN"[c] for c in rng.choice(5, ln, p=[.24] * 4 + [.04]))
        q = rng.integers(2, 41, ln)
        if rng.random() < 0.3:
            q[-int(rng.integers(1, 20)):] = 2
        if rng.random() < 0.2:
            q[:int(rng.integers(1, 10))] = 2
        qual = "".join(chr(33 + int(x)) for x in q)
        cm = f" c{i}" if i % 3 == 0 else ""
        out.append(f"@{names(i)}{cm}\n{s}\n+\n{qual}\n")
    return "".join(out)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("su")
    rng = np.random.default_rng(8)
    # mates named r/1 r/2, pairs under one name, and unpaired reads
    names = [f"p{i // 2}/{i % 2 + 1}" if i < 120 else
             f"q{(i - 120) // 2}" if i < 200 else f"s{i}" for i in range(260)]
    fq = d / "mix.fq"
    fq.write_text(_records(rng, 260, lambda i: names[i]))
    r1, r2 = d / "r1.fq", d / "r2.fq.gz"
    r1.write_text(_records(rng, 90, lambda i: f"m{i}/1"))
    r2.write_bytes(gzip.compress(_records(rng, 87, lambda i: f"m{i}/2")
                                 .encode()))
    cg = d / "cg.fq"
    cg.write_text("".join(
        f"@cg{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(
            ["ACGTAC..GGTTAA", "ACGT", "....ACGT", "AC--GT--CA", "ACGT..",
             ""])))
    fa = d / "cg.fa"
    fa.write_text(">a\nACGG..TTA\n>b x\nAC\n")
    return dict(fq=str(fq), r1=str(r1), r2=str(r2), cg=str(cg), fa=str(fa),
                dir=d)


@pytest.mark.parametrize("opts", [dict(), dict(min_l=30, min_q=10),
                                  dict(min_q=0, drop_ambi=False),
                                  dict(min_l=5, min_q=20, drop_ambi=False)])
def test_trimseq(inputs, opts):
    a, b = io.StringIO(), io.StringIO()
    tsu.trimseq(inputs["fq"], a, **opts)
    jsu.trimseq(inputs["fq"], b, **opts)
    assert a.getvalue() == b.getvalue() != ""


@pytest.mark.parametrize("pair", [("r1", "r2"), ("r2", "r1"), ("fq", "fq")])
def test_pe2cofq(inputs, pair):
    """Collated mates (the shorter file ends it; /1 and /2 dropped)."""
    a, b = io.StringIO(), io.StringIO()
    tsu.pe2cofq(inputs[pair[0]], inputs[pair[1]], a)
    jsu.pe2cofq(inputs[pair[0]], inputs[pair[1]], b)
    assert a.getvalue() == b.getvalue() != ""


@pytest.mark.parametrize("src", ["cg", "fa", "fq"])
def test_cg2cofq(inputs, src):
    a, b = io.StringIO(), io.StringIO()
    tsu.cg2cofq(inputs[src], a)
    jsu.cg2cofq(inputs[src], b)
    assert a.getvalue() == b.getvalue() != ""


@pytest.mark.parametrize("q", [1, 3, 17])
def test_cnt2qual(inputs, q):
    for src in ("fq", "fa"):
        a, b = io.StringIO(), io.StringIO()
        tsu.cnt2qual(inputs[src], a, q=q)
        jsu.cnt2qual(inputs[src], b, q=q)
        assert a.getvalue() == b.getvalue() != ""


def test_splitfa(inputs):
    d = inputs["dir"]
    tsu.splitfa(inputs["fq"], str(d / "t"), 3)
    jsu.splitfa(inputs["fq"], str(d / "j"), 3)
    for i in range(3):
        with gzip.open(d / f"t.{i:04d}.fq.gz") as a, \
                gzip.open(d / f"j.{i:04d}.fq.gz") as b:
            assert a.read() == b.read()


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [
    ["trimseq", "{fq}"], ["trimseq", "-q", "12", "-l", "25", "-N", "{fq}"],
    ["pe2cofq", "{r1}", "{r2}"], ["cg2cofq", "{cg}"], ["cnt2qual", "{fq}"],
    ["cnt2qual", "{fq}", "5"], ["fltuniq", "-k", "11", "{fq}"]])
def test_cli_sequtils(inputs, argv):
    argv = [a.format(**inputs) for a in argv]
    got, want = _cli(tmain, argv), _cli(jmain, argv)
    assert got[0] == 0 and got[1] == want[1]
    assert got[1] or argv[0] == "fltuniq"


def test_cli_splitfa(inputs):
    d = inputs["dir"]
    for main, pre in ((tmain, "ct"), (jmain, "cj")):
        assert _cli(main, ["splitfa", inputs["r1"], str(d / pre)])[0] == 0
    for i in range(8):
        with gzip.open(d / f"ct.{i:04d}.fq.gz") as a, \
                gzip.open(d / f"cj.{i:04d}.fq.gz") as b:
            assert a.read() == b.read()
