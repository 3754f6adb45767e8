"""The port's CLI (`--device cpu`) against fermi_tpu's CLI: build, unpack,
exact and chkbwt give the same output bytes on one small fixture."""

import contextlib
import io

import numpy as np
import pytest
import torch

from fermi_tpu.cli.main import main as jmain
from fermi_tpu_torch.cli.main import main as tmain

from native_lock import load_fermi_tpu_native
from util import random_reads, write_fasta

# The port's CPU ops are small: one thread each keeps parallel test
# workers from oversubscribing the cores, where OpenMP spin-waits
# slow every op by orders of magnitude.
torch.set_num_threads(1)
load_fermi_tpu_native()


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    reads = random_reads(120, seed=21, with_genome=True, genome_len=3000)
    reads += ["ACGTACGT", "NNACGTNN"]      # a revcomp palindrome, N bases
    fa = str(d / "reads.fa")
    write_fasta(fa, reads)
    qry = random_reads(30, seed=22, with_genome=True, genome_len=3000)
    qfa = str(d / "q.fa")
    write_fasta(qfa, qry + random_reads(10, seed=23, max_len=50))
    jfmd, tfmd = str(d / "j.fmd"), str(d / "t.fmd")
    _run(jmain, ["build", "-fo", jfmd, fa])
    _run(tmain, ["build", "--device", "cpu", "-fo", tfmd, fa])
    return fa, qfa, jfmd, tfmd


def test_build_bytes(fixture_files):
    _, _, jfmd, tfmd = fixture_files
    assert open(tfmd, "rb").read() == open(jfmd, "rb").read()


def test_unpack_output(fixture_files):
    _, _, jfmd, tfmd = fixture_files
    ids = ["-i", "0", "-i", "7", "-i", "241", "-i", "100000"]
    assert _run(tmain, ["unpack", "--device", "cpu", *ids, tfmd]) == \
        _run(jmain, ["unpack", *ids, jfmd])
    full = _run(tmain, ["unpack", "--device", "cpu", tfmd])
    assert full == _run(jmain, ["unpack", jfmd])
    assert len(full.splitlines()) == 2 * 122


def test_unpack_reads_past_2_16(tmp_path):
    """`unpack` walks every read to its sentinel: a read of 70,000 bp comes
    back whole (fermi_tpu's `unpack` stops its walks at 2^16 symbols), as
    `unpack -M` gives it."""
    rng = np.random.default_rng(25)
    reads = ["".join("ACGT"[c] for c in rng.integers(0, 4, n))
             for n in (70000, 90, 1500)]
    fa, fmd = str(tmp_path / "r.fa"), str(tmp_path / "i.fmd")
    write_fasta(fa, reads)
    _run(tmain, ["build", "--device", "cpu", "-fo", fmd, fa])
    got = _run(tmain, ["unpack", "--device", "cpu", fmd])
    assert got == _run(tmain, ["unpack", "-M", fmd])
    seqs = sorted(ln.split("\t")[0] for ln in got.splitlines())
    comp = str.maketrans("ACGT", "TGCA")
    assert seqs == sorted(reads + [r.translate(comp)[::-1] for r in reads])


@pytest.mark.parametrize("self_match", [False, True])
def test_exact_output(fixture_files, self_match):
    _, qfa, jfmd, tfmd = fixture_files
    flag = ["-s"] if self_match else []
    got = _run(tmain, ["exact", "--device", "cpu", *flag, tfmd, qfa])
    assert got == _run(jmain, ["exact", *flag, jfmd, qfa])
    assert got.count("EM\t") > 40


def test_exact_query_ending_in_n_differs_from_split_driver(tmp_path):
    """Fault F1 at the CLI: a 51 bp query ending in N.  The port (like
    fermi_tpu's native engine and unified path) prints a final zero-size
    SMEM over the N; fermi_tpu's default CLI, through its split driver,
    drops it.  The difference is on purpose: the port does not copy the
    split driver's liveness rule."""
    fa = str(tmp_path / "acgt.fa")          # an index without N
    write_fasta(fa, random_reads(120, seed=21, with_genome=True,
                                 genome_len=3000))
    jfmd, tfmd = str(tmp_path / "j.fmd"), str(tmp_path / "t.fmd")
    _run(jmain, ["build", "-fo", jfmd, fa])
    _run(tmain, ["build", "--device", "cpu", "-fo", tfmd, fa])
    first = open(fa).read().split("\n")[1]
    qfa = str(tmp_path / "n.fa")
    with open(qfa, "w") as f:
        f.write(f">a\n{first[:50]}N\n")
    got = _run(tmain, ["exact", "--device", "cpu", tfmd, qfa]).splitlines()
    want = _run(jmain, ["exact", jfmd, qfa]).splitlines()
    assert got[0] == "SQ\ta\t51\t2" and want[0] == "SQ\ta\t51\t1"
    assert got[2] == "EM\t50\t51\t0\tOO"
    assert got[1] == want[1] and got[3] == want[2] == "//"


def _run_rc(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), [ln for ln in err.getvalue().splitlines()
                                if "::chkbwt]" in ln]


def _corrupt(fmd, path, same_length):
    """A copy of fmd with one byte of its run data changed, chosen so that
    the decoded BWT differs, keeping the header's length or not, while the
    header's counts stay."""
    from fermi_tpu_torch import rld

    raw = open(fmd, "rb").read()
    want = rld.read_fmd(fmd).expand()
    for at in range(len(raw) // 2, len(raw)):
        b = bytearray(raw)
        b[at] ^= 0x10
        with open(path, "wb") as f:
            f.write(b)
        got = rld.read_fmd(path).expand()
        if (got.size == want.size) == same_length and \
                not np.array_equal(got, want):
            return path
    raise AssertionError("no byte of the runs changes the BWT")


@pytest.mark.parametrize("flags", [[], ["-r"], ["-p"], ["-r", "-p"]])
def test_chkbwt(fixture_files, tmp_path, monkeypatch, flags):
    """chkbwt (marginal counts; -r the rank check; -p the BWT) prints
    fermi_tpu's stdout and messages and exits as it does, on the index and
    on copies with one run corrupted (the BWT's length kept, or not: the
    header then claims more or fewer symbols than the runs hold); the
    port's -r checks in chunks of 997 positions (so the index's 25 k
    symbols take many)."""
    from fermi_tpu_torch.cli import main as tcli

    monkeypatch.setattr(tcli, "CHKBWT_CHUNK", 997)
    _, _, _, tfmd = fixture_files
    bad = [_corrupt(tfmd, str(tmp_path / f"bad{same}.fmd"), same)
           for same in (True, False)]
    for fmd, rc in ((tfmd, 0), *((b, 1 if "-r" in flags else 0)
                                 for b in bad)):
        got = _run_rc(tmain, ["chkbwt", "--device", "cpu", *flags, fmd])
        assert got == _run_rc(jmain, ["chkbwt", *flags, fmd])
        assert got[0] == rc and ("-p" in flags and rc == 0) == bool(got[1])
    # -M runs on the host and refuses a device
    assert tmain(["chkbwt", "--device", "cpu", "-M", tfmd]) == 1


def test_chkbwt_reports_first_rank_mismatch(fixture_files, monkeypatch):
    """A rank6 that is wrong at two positions (a stand-in for a faulty
    kernel): -r names the first, symbol and position, in the message
    fermi_tpu prints, across chunk boundaries."""
    from fermi_tpu_torch.cli import main as tcli
    from fermi_tpu_torch.index.fmd import FMDIndex

    _, _, _, tfmd = fixture_files
    rank6 = FMDIndex.rank6

    def faulty(self, k):
        r = rank6(self, k).clone()
        r[(k == 5001) | (k == 9001), 3] += 1     # positions 5000 and 9000
        return r
    monkeypatch.setattr(FMDIndex, "rank6", faulty)
    monkeypatch.setattr(tcli, "CHKBWT_CHUNK", 997)
    rc, _, err = _run_rc(tmain, ["chkbwt", "--device", "cpu", "-r", tfmd])
    assert rc == 1 and err[-1] == "[E::chkbwt] rank(3,5000) mismatch"
