"""The port's CLI (`--device cpu`) against fermi_tpu's CLI: build, unpack
and exact give the same output bytes on one small fixture."""

import contextlib
import io

import pytest
import torch

from fermi_tpu.cli.main import main as jmain
from fermi_tpu_torch.cli.main import main as tmain

from util import random_reads, write_fasta

# The port's CPU ops are small: one thread each keeps parallel test
# workers from oversubscribing the cores, where OpenMP spin-waits
# slow every op by orders of magnitude.
torch.set_num_threads(1)


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


@pytest.mark.parametrize("self_match", [False, True])
def test_exact_output(fixture_files, self_match):
    _, qfa, jfmd, tfmd = fixture_files
    flag = ["-s"] if self_match else []
    got = _run(tmain, ["exact", "--device", "cpu", *flag, tfmd, qfa])
    assert got == _run(jmain, ["exact", *flag, jfmd, qfa])
    assert got.count("EM\t") > 40


def test_unported_flags_exit_with_roadmap_item(fixture_files, capsys):
    fa, qfa, _, tfmd = fixture_files
    assert tmain(["exact", "--device", "cpu", "-M", tfmd, qfa]) == 1
    assert tmain(["unpack", "--device", "cpu", "-M", tfmd]) == 1
    assert capsys.readouterr().err.count("ROADMAP") == 2
