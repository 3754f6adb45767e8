"""The port's pipeline driver (fermi_tpu_torch.pipeline.driver), its read
encoders, fltuniq and the CLI `run` against fermi_tpu on the CPU.  Every
artifact is bytes: tolerance zero, gzipped ones compared decompressed."""

import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from fermi_tpu.cli import sequtils as jsu
from fermi_tpu.cli.main import main as jmain
from fermi_tpu.construct import suffix as jsuffix
from fermi_tpu.core import fastx as jfastx
from fermi_tpu.pipeline.driver import Pipeline as JPipeline
from fermi_tpu_torch.cli import sequtils as tsu
from fermi_tpu_torch.cli.main import main as tmain
from fermi_tpu_torch.construct import suffix as tsuffix
from fermi_tpu_torch.core import fastx as tfastx
from fermi_tpu_torch.pipeline.driver import Pipeline as TPipeline

from test_pipeline import make_pe_fastq
from test_torch_scaf import linked_pair_reads
from test_torch_unitig import long_reads
from util import write_fasta

torch.set_num_threads(1)

ARTIFACTS = ("raw.fmd", "ec.fq.gz", "ec.fmd", "p0.mag.gz", "p1.mag.gz",
             "p2.mag.gz")
PAIRED_ARTIFACTS = ARTIFACTS[:3] + ("ec.rank",) + ARTIFACTS[3:] + (
    "p3.mag.gz", "p4.fa.gz", "p5.fq.gz")


def _read(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """make_pe_fastq's shape at 3 kbp and 600 pairs (1,200 reads of 70 bp,
    0.5% substitutions), run as unpaired reads."""
    return make_pe_fastq(tmp_path_factory.mktemp("pl"), glen=3000,
                         n_pairs=600)


@pytest.mark.parametrize("skip_ec", [False, True])
def test_pipeline_artifacts(reads, tmp_path, skip_ec):
    """raw.fmd, ec.fq.gz, ec.fmd and p0-p2.mag.gz equal fermi_tpu's
    Pipeline with one unitig thread (without -C: no raw index nor ec.fq)."""
    jp = JPipeline(str(tmp_path / "j"), n_threads=2, unitig_k=40,
                   skip_ec=skip_ec, unitig_threads=1)
    tp = TPipeline(str(tmp_path / "t"), n_threads=2, unitig_k=40,
                   skip_ec=skip_ec, device="cpu")
    assert jp.run([reads]).endswith("j.p2.mag.gz")
    assert tp.run([reads]) == str(tmp_path / "t.p2.mag.gz")
    made = 0
    for sfx in ARTIFACTS:
        jf, tf = tmp_path / f"j.{sfx}", tmp_path / f"t.{sfx}"
        assert jf.exists() == tf.exists(), sfx
        if jf.exists():
            assert _read(tf) == _read(jf), sfx
            made += 1
    assert made == (4 if skip_ec else 6)
    assert len(_read(tmp_path / "t.p2.mag.gz")) > 2000


def test_pipeline_resumes_and_reads_fasta(reads, tmp_path):
    """A stage whose artifact exists is skipped; FASTA input takes the
    record path and gives the index of the same reads."""
    recs = list(jfastx.read_fastx(reads))
    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, [r.seq for r in recs])
    tp = TPipeline(str(tmp_path / "a"), n_threads=2, unitig_k=40,
                   skip_ec=True, device="cpu")
    tp.stage_raw_fmd([fa])
    jp = JPipeline(str(tmp_path / "b"), n_threads=2, unitig_k=40,
                   skip_ec=True, unitig_threads=1)
    jp.stage_raw_fmd([reads])
    assert _read(tmp_path / "a.ec.fmd") == _read(tmp_path / "b.ec.fmd")
    before = (tmp_path / "a.ec.fmd").stat().st_mtime_ns
    tp.stage_raw_fmd([fa])
    assert (tmp_path / "a.ec.fmd").stat().st_mtime_ns == before


def _out(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_run(reads, tmp_path):
    """`run` (and `run -C`) write the Pipeline's artifacts."""
    for flag in ([], ["-C"]):
        pre = str(tmp_path / f"r{len(flag)}")
        rc, _, err = _out(tmain, ["run", "--device", "cpu", *flag, "-t", "2",
                                  "-k", "40", "-p", pre, reads])
        assert rc == 0 and "stage unitig" in err
        jp = JPipeline(pre + "j", n_threads=2, unitig_k=40,
                       skip_ec=bool(flag), unitig_threads=1)
        jp.run([reads])
        for sfx in ARTIFACTS[2:]:
            assert _read(f"{pre}.{sfx}") == _read(f"{pre}j.{sfx}"), sfx


@pytest.fixture(scope="module")
def linked_fq(tmp_path_factory):
    """Interleaved FASTQ of tests/test_scaf.py's linked-pair genome (a
    repeat, and a dead zone where no read starts): its scaftigs, unlike
    those of make_pe_fastq's random genome, are not empty."""
    path = tmp_path_factory.mktemp("lk") / "linked.fq"
    reads = linked_pair_reads()
    with open(path, "w") as f:
        for i, s in enumerate(reads):
            f.write(f"@p{i // 2}\n{s}\n+\n{'I' * len(s)}\n")
    return str(path)


@pytest.mark.parametrize("which", ["random", "linked"])
def test_cli_run_paired(reads, linked_fq, tmp_path, which):
    """`run -P` writes every artifact of fermi_tpu's Pipeline(paired=True)
    (one unitig thread), raw.fmd through p5.fq.gz, compared decompressed:
    on make_pe_fastq's genome, whose p4 and p5 are empty (the final remap
    of no scaftig), and on the linked-pair genome, whose are not."""
    fq = reads if which == "random" else linked_fq
    pre = str(tmp_path / "t")
    rc, _, err = _out(tmain, ["run", "--device", "cpu", "-P", "-t", "2", "-k",
                              "40", "-p", pre, fq])
    assert rc == 0 and "stage scaf" in err and "stage final_remap" in err
    JPipeline(str(tmp_path / "j"), n_threads=2, unitig_k=40, paired=True,
              unitig_threads=1).run([fq])
    for sfx in PAIRED_ARTIFACTS:
        assert _read(f"{pre}.{sfx}") == _read(tmp_path / f"j.{sfx}"), sfx
    p4, p5 = _read(f"{pre}.p4.fa.gz"), _read(f"{pre}.p5.fq.gz")
    if which == "random":
        assert p4 == p5 == b""
        assert "avg = 0.00 std = 0.00 cap = 1" in err
    else:
        assert p4.count(b">") >= 1 and p5.count(b"\n+\n") >= 1


# -- the read encoders and fltuniq ---------------------------------------


def test_frag_encoders_and_text(reads, tmp_path):
    """The fragments of plain and gzipped FASTQ (native ffastq_frags, and
    fencode_frags over fastq_seq_spans) and build_text_packed's text equal
    fermi_tpu's; N splits a read, lower case counts as its base."""
    data = open(reads, "rb").read()
    data = data.replace(b"\nACG", b"\nNaCg", 40).replace(b"T\n+", b"N\n+", 7)
    data = data.replace(b"ACGTA", b"ACNTA", 10)     # inner N (no T in quals)
    fq, gz = tmp_path / "r.fq", tmp_path / "r.fq.gz"
    fq.write_bytes(data)
    gz.write_bytes(gzip.compress(data))
    for path in (str(fq), str(gz)):
        want = JPipeline._frags_from_fastq([path])
        got = TPipeline._frags_from_fastq([path])
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    two = TPipeline._frags_from_fastq([str(fq), str(gz)])
    assert all(np.array_equal(g, w) for g, w in zip(
        two, JPipeline._frags_from_fastq([str(fq), str(gz)])))
    spans = tfastx.fastq_seq_spans(data)
    want = jfastx.fastq_seq_spans(data)
    assert all(np.array_equal(g, w) for g, w in zip(spans, want))
    assert tfastx.fastq_seq_spans(b"@a\nAC\n") is None
    F, offs = TPipeline._encode_spans(*spans)
    assert len(offs) - 1 > len(spans[1])            # N split some reads
    for both in (True, False):
        for trim in (True, False):
            assert np.array_equal(
                tsuffix.build_text_packed(F, offs, both, trim),
                jsuffix.build_text_packed(F, offs, both, trim))
    pal = np.array([1, 2, 3, 4, 1, 4], np.uint8)    # ACGT (a palindrome), AT
    po = np.array([0, 4, 6], np.int64)
    assert np.array_equal(tsuffix.build_text_packed(pal, po),
                          jsuffix.build_text_packed(pal, po))
    assert tsuffix.build_text_packed(pal[:0], po[:1]).size == 0
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGT\n")
    assert TPipeline._frags_from_fastq([str(fa)]) is None


@pytest.fixture(scope="module")
def ec_fq(reads, tmp_path_factory):
    """fermi_tpu's corrected reads of the fixture (a gzipped FASTQ whose
    records the paired names group), plus a FASTA copy."""
    d = tmp_path_factory.mktemp("flt")
    jp = JPipeline(str(d / "j"), n_threads=2, unitig_k=40, unitig_threads=1)
    jp.stage_raw_fmd([reads])
    jp.stage_correct([reads])
    gz = str(d / "j.ec.fq.gz")
    fa = str(d / "ec.fa")
    write_fasta(fa, [r.seq for r in jfastx.read_fastx(gz)])
    return gz, fa


@pytest.mark.parametrize("k", [0, 15, 21])
def test_fltuniq(ec_fq, k):
    """fltuniq's bytes (span path on FASTQ, record path on FASTA), its
    kept spans, and the native and plain keep flags equal fermi_tpu's."""
    for path in ec_fq:
        got, want = io.StringIO(), io.StringIO()
        tsu.fltuniq(path, got, k=k, verbose=False)
        jsu.fltuniq(path, want, k=k, verbose=False)
        assert got.getvalue() == want.getvalue()
        assert 0 < got.getvalue().count("\n") < 4 * 1200
    gz = ec_fq[0]
    a, b = tsu.fltuniq_kept_seq_spans(gz, k), jsu.fltuniq_kept_seq_spans(gz, k)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert tsu.fltuniq_auto_k(gz) == jsu.fltuniq_auto_k(gz)
    recs = list(jfastx.read_fastx(gz))
    recs[3].seq = recs[3].seq[:30] + "N" + recs[3].seq[31:]
    kk = k or 17
    want = jsu._flt_keep_numpy(recs, kk)
    assert np.array_equal(tsu._flt_keep_native(recs, kk), want)
    assert np.array_equal(tsu._flt_keep_numpy(recs, kk), want)
    assert not want[3] and want.sum() > 100
    for s in (recs[0].seq, "ACGTNACGTACGTTTGCAAC"):
        for x, y in zip(tsu._kmer_codes(s, 5), jsu._kmer_codes(s, 5)):
            assert np.array_equal(x, y)


def test_cli_fltuniq(ec_fq):
    for path in ec_fq:
        for k in ([], ["-k", "19"]):
            got = _out(tmain, ["fltuniq", *k, path])
            want = _out(jmain, ["fltuniq", *k, path])
            assert got[0] == want[0] == 0 and got[1] == want[1]
            assert ("set the k-mer size" in got[2]) == (not k)


@pytest.mark.parametrize("paired", [False, True])
def test_stage_unitig_long_reads(tmp_path, paired):
    """The driver's unitig stage on 1,024-3,000 bp reads (`run -C` up to
    p0.mag.gz; with pairs through ec.rank): fermi_tpu's Pipeline, whose
    stage takes its host walk, byte for byte."""
    fq = str(tmp_path / "long.fq")
    with open(fq, "w") as f:
        for i, s in enumerate(long_reads(glen=9000, cov=10)):
            f.write(f"@p{i // 2}\n{s}\n+\n{'I' * len(s)}\n")
    for name, pl in (("j", JPipeline(str(tmp_path / "j"), n_threads=2,
                                     unitig_k=100, skip_ec=True,
                                     paired=paired, unitig_threads=1)),
                     ("t", TPipeline(str(tmp_path / "t"), n_threads=2,
                                     unitig_k=100, skip_ec=True,
                                     paired=paired, device="cpu"))):
        pl.stage_raw_fmd([fq])
        pl.stage_rank()
        pl.stage_unitig()
    for sfx in ("ec.fmd", "ec.rank", "p0.mag.gz"):
        jf, tf = tmp_path / f"j.{sfx}", tmp_path / f"t.{sfx}"
        assert jf.exists() == tf.exists() == (paired or sfx != "ec.rank")
        if jf.exists():
            assert _read(tf) == _read(jf), sfx
    assert _read(tmp_path / "t.p0.mag.gz").count(b"\n+\n") > 1
