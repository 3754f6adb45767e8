"""The port's build path against fermi_tpu: text layout, device BWT
(run on the CPU here), .fmd bytes, and the FASTA reader."""

import gzip
import os

import numpy as np
import pytest
import torch

from fermi_tpu import rld as jrld
from fermi_tpu.construct import suffix as jsuf
from fermi_tpu.core import dna as jdna
from fermi_tpu_torch import rld as trld
from fermi_tpu_torch.construct import suffix as tsuf
from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device
from fermi_tpu_torch.core import dna as tdna, fastx as tfastx

from native_lock import load_fermi_tpu_native
from util import random_reads, revcomp_str, write_fasta

# The port's CPU ops are small: one thread each keeps parallel test
# workers from oversubscribing the cores, where OpenMP spin-waits
# slow every op by orders of magnitude.
torch.set_num_threads(1)
load_fermi_tpu_native()


def _read_sets():
    rng = np.random.default_rng(7)
    genome = random_reads(80, seed=11, with_genome=True, genome_len=3000)
    with_n = ["".join("ACGTN"[c] for c in rng.integers(0, 5, L))
              for L in rng.integers(1, 60, 40)]
    half = ["".join("ACGT"[c] for c in rng.integers(0, 4, L))
            for L in rng.integers(1, 20, 30)]
    pals = [h + revcomp_str(h) for h in half]      # revcomp palindromes
    return {"genome": genome, "n_bases": with_n, "palindromes": pals + half,
            "one": ["A"]}


@pytest.mark.parametrize("name", sorted(_read_sets()))
@pytest.mark.parametrize("trim", [True, False])
def test_text_and_device_bwt(name, trim):
    seqs = [jdna.encode(s) for s in _read_sets()[name]]
    want_text = jsuf.build_text(seqs, trim_palindrome=trim)
    text = tsuf.build_text([tdna.encode(tdna.decode(s)) for s in seqs],
                           trim_palindrome=trim)
    np.testing.assert_array_equal(text, want_text)
    np.testing.assert_array_equal(multistring_bwt_device(text, "cpu"),
                                  jsuf.multistring_bwt(want_text))


def test_bwt_from_sa_and_runs():
    seqs = [jdna.encode(s) for s in _read_sets()["n_bases"]]
    text = jsuf.build_text(seqs)
    sa = jsuf.suffix_array_multi_numpy(text)
    bwt = tsuf.bwt_from_sa(text, sa)
    np.testing.assert_array_equal(bwt, jsuf.bwt_from_sa(text, sa))
    want, got = jrld.Runs.from_bwt(bwt), trld.Runs.from_bwt(bwt)
    for f in ("lengths", "symbols", "mcnt"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.expand(), bwt)


@pytest.mark.parametrize("sbits", [3, 5])
def test_fmd_bytes_and_roundtrip(tmp_path, sbits):
    reads = random_reads(300, seed=3, with_genome=True, genome_len=6000)
    text = jsuf.build_text([jdna.encode(s) for s in reads])
    bwt = jsuf.multistring_bwt(text)
    jp, tp = str(tmp_path / "j.fmd"), str(tmp_path / "t.fmd")
    jrld.write_fmd(jrld.Runs.from_bwt(bwt), jp, sbits=sbits)
    trld.write_fmd(trld.Runs.from_bwt(bwt), tp, sbits=sbits)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    back = trld.read_fmd(tp)
    want = jrld.read_fmd(jp)
    for f in ("lengths", "symbols", "mcnt"):
        np.testing.assert_array_equal(getattr(back, f), getattr(want, f))
    np.testing.assert_array_equal(back.expand(), bwt)


def test_fastx_matches_and_truncated_gzip_fails(tmp_path):
    from fermi_tpu.core import fastx as jfastx

    reads = random_reads(50, seed=4)
    fa = str(tmp_path / "r.fa")
    write_fasta(fa, reads)
    raw = open(fa, "rb").read()
    gz = str(tmp_path / "r.fa.gz")
    with gzip.open(gz, "wb") as f:
        f.write(raw)
    for path in (fa, gz):
        assert list(tfastx.read_fastx(path)) == \
            [tfastx.SeqRecord(**vars(r)) for r in jfastx.read_fastx(path)]
    # a truncated .gz must not pass as a short file: the reader checks the
    # decompressor's exit status once it has drained the stream
    bad = str(tmp_path / "bad.fa.gz")
    data = open(gz, "rb").read()
    with open(bad, "wb") as f:
        f.write(data[: len(data) * 2 // 3])
    with pytest.raises((OSError, EOFError)):
        list(tfastx.read_fastx(bad))
    os.remove(bad)
