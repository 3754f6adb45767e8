"""The wide index tier of the port in small, against fermi_tpu on the CPU.

Fault F5: `api.build_index`, `api.save_index` and `ropebwt -a sais` sorted
every text by prefix doubling, which refuses texts of `MAX_TEXT` (2^31 - 8)
symbols; they now go through `construct.blocked.device_bwt`, which sends
such texts to the blocked builder.  `MAX_TEXT` and the block size are
patched small here, as tests/test_torch_builders.py does for `build`.

The chain of the card's 2.26 Gsym run, on a few thousand symbols with the
index forced into the int64 domain (FERMI_TPU_IDX_DTYPE) and the build
forced through the blocked builder: the driver's raw_fmd stage, `chkbwt
-r`, SMEMs, `exact -M` and `unpack`, each equal to fermi_tpu.  Every
output is integers or bytes: tolerance zero."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from fermi_tpu import api as japi
from fermi_tpu import rld as jrld
from fermi_tpu.cli.main import main as jmain
from fermi_tpu.index.fmd import FMDIndex as JFMDIndex
from fermi_tpu.pipeline.driver import Pipeline as JPipeline
from fermi_tpu.search import smem as jsm
from fermi_tpu_torch import api as tapi
from fermi_tpu_torch import rld
from fermi_tpu_torch.cli import main as tcli
from fermi_tpu_torch.construct import blocked, suffix_device
from fermi_tpu_torch.core import dna
from fermi_tpu_torch.index.fmd import FMDIndex
from fermi_tpu_torch.pipeline.driver import Pipeline as TPipeline
from fermi_tpu_torch.search import smem as tsm

from test_pipeline import make_pe_fastq
from native_lock import load_fermi_tpu_native
from util import random_reads

torch.set_num_threads(1)
load_fermi_tpu_native()

MAX_TEXT = 2000                 # prefix doubling's limit, patched
BLOCK = 1500                    # the blocked builder's block, patched
# the builder as imported: the module fixture below keeps its patch on
_DEVICE_BUILD_TEXT = blocked.device_build_text


def _small_blocks(mp):
    """Patch MAX_TEXT and the block size small; returns the sizes of the
    texts the blocked builder is handed."""
    mp.setattr(suffix_device, "MAX_TEXT", MAX_TEXT)
    calls = []
    orig = _DEVICE_BUILD_TEXT

    def small(text, device=None):
        calls.append(text.size)
        return orig(text, block_symbols=BLOCK, device=device)
    mp.setattr(blocked, "device_build_text", small)
    return calls


def _out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    return buf.getvalue()


# -- F5 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def reads():
    return random_reads(60, seed=31, with_genome=True, genome_len=2500)


def _bwt_of(jidx):
    n = int(np.asarray(jidx.mcnt)[0])
    return np.asarray(jidx.bwt_blocks).reshape(-1)[:n]


@pytest.mark.parametrize("entry", ["build_index", "save_index",
                                   "ropebwt_sais", "ropebwt_sais_b"])
def test_f5_entries_route_by_size(reads, tmp_path, monkeypatch, entry):
    """Past the (patched) MAX_TEXT each entry takes the blocked builder in
    more than 3 blocks and gives fermi_tpu's bytes (calling prefix
    doubling directly, each raised NotImplementedError here)."""
    calls = _small_blocks(monkeypatch)
    if entry == "build_index":
        got = tapi.build_index(reads, device="cpu").bwt().numpy()
        assert np.array_equal(got, _bwt_of(japi.build_index(reads)))
    elif entry == "save_index":
        tapi.save_index(reads, str(tmp_path / "t.fmd"), device="cpu")
        japi.save_index(reads, str(tmp_path / "j.fmd"))
        assert (tmp_path / "t.fmd").read_bytes() == \
            (tmp_path / "j.fmd").read_bytes()
    else:
        fq = tmp_path / "r.fq"
        fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                              for i, r in enumerate(reads)))
        flags = ["-b"] if entry.endswith("_b") else []
        for main, dv, name in ((tcli.main, ["--device", "cpu"], "t"),
                               (jmain, [], "j")):
            assert main(["ropebwt", "-a", "sais", *dv, *flags, "-o",
                         str(tmp_path / name), str(fq)]) == 0
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert calls and calls[0] > MAX_TEXT and blocked.STATS["blocks"] > 3


def test_f5_prefix_doubling_keeps_its_guard(monkeypatch):
    """multistring_bwt_device itself still refuses a text at MAX_TEXT and
    names the entry for texts of any length."""
    monkeypatch.setattr(suffix_device, "MAX_TEXT", MAX_TEXT)
    with pytest.raises(NotImplementedError, match="blocked.device_bwt"):
        suffix_device.multistring_bwt_device(np.zeros(MAX_TEXT, np.uint8),
                                             "cpu")
    text = np.zeros(MAX_TEXT - 1, np.uint8)
    text[::3] = 1
    text[-1] = 0
    assert suffix_device.multistring_bwt_device(text, "cpu").size == \
        MAX_TEXT - 1


# -- the wide chain in small ------------------------------------------------

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Paired FASTQ (120 pairs of 70 bp, 0.5% substitutions), fermi_tpu's
    raw_fmd and its index, and the port's raw_fmd built on the CPU through
    the blocked builder with the index in the int64 domain (the patches
    and FERMI_TPU_IDX_DTYPE stay on for the module's tests)."""
    d = tmp_path_factory.mktemp("wide")
    fq = make_pe_fastq(d, seed=7, glen=2000, n_pairs=120)
    jp = JPipeline(str(d / "j"), n_threads=2, paired=True)
    jp.stage_raw_fmd([fq])
    jfmd = jp._p("raw.fmd")
    jidx = JFMDIndex.restore(jfmd)
    with pytest.MonkeyPatch.context() as mp:
        calls = _small_blocks(mp)
        mp.setenv("FERMI_TPU_IDX_DTYPE", "int64")
        tp = TPipeline(str(d / "t"), n_threads=2, paired=True, device="cpu")
        with contextlib.redirect_stderr(io.StringIO()):
            tp.stage_raw_fmd([fq])
        tfmd = tp._p("raw.fmd")
        blocks = blocked.STATS["blocks"]
        tidx = FMDIndex.restore(tfmd, "cpu")
        recs = [ln.strip() for i, ln in enumerate(open(fq)) if i % 4 == 1]
        rng = np.random.default_rng(8)
        queries = []
        for r in recs[::3]:
            b = list(r)
            for p in rng.integers(0, len(b), 1):
                b[p] = "ACGT"[(("ACGT".index(b[p])) + 1) % 4]
            queries.append("".join(b))
        qfa = str(d / "q.fa")
        with open(qfa, "w") as f:
            f.writelines(f">q{i}\n{s}\n" for i, s in enumerate(queries))
        yield dict(fq=fq, jfmd=jfmd, tfmd=tfmd, jidx=jidx, tidx=tidx,
                   calls=calls, blocks=blocks, qfa=qfa,
                   seqs=[dna.encode(s) for s in queries], recs=recs)


def test_wide_raw_fmd_equals_fermi_tpu(chain):
    """The driver's raw_fmd of paired FASTQ: fermi_tpu's bytes, built by
    the blocked builder; the restored index is int64 with fused rows."""
    assert open(chain["tfmd"], "rb").read() == open(chain["jfmd"],
                                                    "rb").read()
    assert chain["calls"] and chain["calls"][0] > MAX_TEXT
    assert chain["blocks"] > 3
    idx = chain["tidx"]
    assert idx.idtype == torch.int64 and idx.fused is not None
    assert idx.total == 2 * len(chain["recs"]) * 71


def test_raw_fmd_of_two_files_past_fused_max(tmp_path, monkeypatch):
    """The smoke test's index past 2^32 in small: two FASTQ files of one
    genome (a library's two lanes), FUSED_MAX lowered between one file's
    symbols and both files', the index int64, the build blocked.  The
    driver's raw_fmd of both files (its last folds walk an accumulated
    index without fused rows), the CLI's `merge` of each file's own
    raw_fmd and fermi_tpu's raw_fmd of both files: the same bytes."""
    from fermi_tpu_torch.algos import merge as tmerge
    from fermi_tpu_torch.index import fmd as tfmd

    src = open(make_pe_fastq(tmp_path, seed=9, glen=2500, n_pairs=240)
               ).read().splitlines(True)
    fqs = [str(tmp_path / f) for f in ("a.fq", "b.fq")]
    for path, part in zip(fqs, (src[:960], src[960:])):
        with open(path, "w") as f:
            f.writelines(part)
    jp = JPipeline(str(tmp_path / "j"), n_threads=2, paired=True)
    jp.stage_raw_fmd(fqs)
    want = open(jp._p("raw.fmd"), "rb").read()

    _small_blocks(monkeypatch)
    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    one = 2 * 240 * 71
    monkeypatch.setattr(tfmd, "FUSED_MAX", one * 3 // 2)
    seen = []
    orig = tmerge.compute_gap_bits

    def spy(e0, e1, **kw):
        seen.append(e0.fused is not None)
        return orig(e0, e1, **kw)
    monkeypatch.setattr(tmerge, "compute_gap_bits", spy)

    def raw_fmd(prefix, paths):
        tp = TPipeline(str(tmp_path / prefix), n_threads=2, paired=True,
                       device="cpu")
        with contextlib.redirect_stderr(io.StringIO()):
            tp.stage_raw_fmd(paths)
        return tp._p("raw.fmd")
    both = raw_fmd("ab", fqs)
    assert blocked.STATS["blocks"] == len(seen) + 1 > 40
    assert True in seen and False in seen
    parts = [raw_fmd(p, [f]) for p, f in zip("ab", fqs)]
    assert all(FMDIndex.restore(p, "cpu").total == one for p in parts)
    merged = str(tmp_path / "m.fmd")
    seen.clear()
    _out(tcli.main, ["merge", "--device", "cpu", "-fo", merged, *parts])
    assert seen == [True]
    got = open(both, "rb").read()
    assert got == open(merged, "rb").read() == want
    idx = FMDIndex.restore(both, "cpu")
    assert idx.total == 2 * one and idx.fused is None


def test_wide_chkbwt(chain, monkeypatch):
    """`chkbwt -r` of the int64 index passes in many chunks, with
    fermi_tpu's messages, and check_ranks passes on the restored index."""
    monkeypatch.setattr(tcli, "CHKBWT_CHUNK", 997)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main(["chkbwt", "--device", "cpu", "-r",
                          chain["tfmd"]]) == 0
        assert tcli.check_ranks(chain["tidx"],
                                chain["tidx"].mcnt.numpy()) == 0
    lines = [ln for ln in err.getvalue().splitlines() if "::chkbwt]" in ln]
    jerr = io.StringIO()
    with contextlib.redirect_stderr(jerr):
        assert jmain(["chkbwt", "-r", chain["jfmd"]]) == 0
    jl = [ln for ln in jerr.getvalue().splitlines() if "::chkbwt]" in ln]
    assert lines[:len(jl)] == jl
    assert lines.count("[M::chkbwt] rank check passed") == 2


@pytest.mark.parametrize("self_match", [False, True])
def test_wide_smem(chain, monkeypatch, self_match):
    """smem_all on the int64 index equals fermi_tpu's unified path and the
    port's native engine over the same index."""
    got = tsm.smem_all(chain["tidx"], chain["seqs"], self_match=self_match)
    assert got == tsm.smem_all_native(chain["tidx"], chain["seqs"],
                                      self_match=self_match)
    monkeypatch.setenv("FERMI_TPU_SMEM_SPLIT", "0")
    assert got == jsm.smem_all(chain["jidx"], chain["seqs"],
                               self_match=self_match)
    assert sum(len(m) for m in got) > len(chain["seqs"])


def test_wide_exact_bytes(chain):
    """`exact -M` prints the bytes of the card path (`--device cpu`) on the
    int64 index and of fermi_tpu's `exact -M`; write_exact over the
    restored index's SMEMs prints them too."""
    got = _out(tcli.main, ["exact", "-M", chain["tfmd"], chain["qfa"]])
    assert got == _out(tcli.main, ["exact", "--device", "cpu",
                                   chain["tfmd"], chain["qfa"]])
    assert got == _out(jmain, ["exact", "-M", chain["jfmd"], chain["qfa"]])
    buf = io.StringIO()
    tcli.write_exact(chain["tidx"], [f"q{i}" for i in range(len(
        chain["seqs"]))], chain["seqs"],
        tsm.smem_all(chain["tidx"], chain["seqs"]), buf)
    assert buf.getvalue() == got and got.count("SQ\t") == len(chain["seqs"])


@pytest.mark.parametrize("ids", ["some", "all"])
def test_wide_unpack(chain, ids):
    """`unpack` of the int64 index equals fermi_tpu's; id x is read x // 2,
    reverse-complemented when x is odd."""
    sel = ["-i", "0", "-i", "5", "-i", "239", "-i", "100000"] \
        if ids == "some" else []
    got = _out(tcli.main, ["unpack", "--device", "cpu", *sel,
                           chain["tfmd"]])
    assert got == _out(jmain, ["unpack", *sel, chain["jfmd"]])
    if ids == "all":
        comp = str.maketrans("ACGT", "TGCA")
        seqs = [ln.split("\t")[0] for ln in got.splitlines()]
        assert seqs[0::2] == chain["recs"]
        assert seqs[1::2] == [r.translate(comp)[::-1] for r in chain["recs"]]


# -- found by the card's 2.26 Gsym run ----------------------------------------

def _runs_bwt(shape, n=1 << 22):
    rng = np.random.default_rng(5)
    if shape == "long_runs":
        return np.repeat(rng.integers(0, 6, n // 64).astype(np.uint8), 64)
    if shape == "random":
        return rng.integers(0, 6, n).astype(np.uint8)
    return np.full(n if shape == "one_run" else 1, 4, np.uint8)


@pytest.mark.parametrize("shape", ["long_runs", "random", "one_run",
                                   "one_symbol"])
def test_runs_from_bwt_equals_fermi_tpu(shape):
    """Runs.from_bwt, whose runs now come from the native codec and its
    marginal counts from the runs, gives fermi_tpu's runs and counts,
    dtypes included."""
    bwt = _runs_bwt(shape)
    got, want = rld.Runs.from_bwt(bwt), jrld.Runs.from_bwt(bwt)
    for f in ("lengths", "symbols", "mcnt"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


_RSS_CHILD = """
import resource
import numpy as np
from {pkg} import rld
rng = np.random.default_rng(5)
bwt = np.repeat(rng.integers(0, 6, {n} // 64).astype(np.uint8), 64)
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rld.Runs.from_bwt(bwt)
print(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - base)
"""


def test_runs_from_bwt_does_not_copy_the_bwt_to_int64():
    """The RLE of a BWT on the host: a bincount of the BWT copies it to
    int64, 8 bytes a symbol (18 GB at 2.26 G symbols).  The runs come
    from two native passes and the marginal counts from their lengths, as
    in fermi_tpu's from_bwt, so the peak resident set that from_bwt of a
    BWT of long runs adds, measured in a child process, stays under 3
    bytes a symbol (the bincount path adds about 7.5)."""
    import subprocess
    import sys

    n = 1 << 26
    p = subprocess.run([sys.executable, "-c", _RSS_CHILD.format(
        pkg="fermi_tpu_torch", n=n)], capture_output=True, text=True,
        check=True, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    assert int(p.stdout) * 1024 < 3 * n
