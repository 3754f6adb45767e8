"""seqsort / seqrank in the port (fermi_tpu_torch.algos.seqsort, CLI
`seqsort`/`seqrank`) against fermi_tpu on the CPU: the .rank array equals
fermi_tpu's device `seqsort` and its host engine `seqsort_native`, word for
word."""

import numpy as np
import pytest
import torch

from fermi_tpu.algos import seqsort as jss
from fermi_tpu.index.fmd import FMDIndex as JFMD
from fermi_tpu_torch.algos import seqsort as tss
from fermi_tpu_torch.index.fmd import FMDIndex

from util import build_my_fmd, random_reads

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """Genome reads (duplicates and containment arise), exact duplicates and
    contained reads added explicitly (the recipe of tests/test_seqsort.py)."""
    d = tmp_path_factory.mktemp("ss")
    reads = random_reads(120, seed=21, with_genome=True, genome_len=2000)
    reads += reads[:10]
    reads += [r[5:60] for r in reads[:8]]
    fmd = str(d / "i.fmd")
    build_my_fmd(reads, fmd)
    jidx = JFMD.restore(fmd)
    want = jss.seqsort(jidx, batch=64, max_len=128, verbose=False)
    assert np.array_equal(want, jss.seqsort_native(jidx, n_threads=2,
                                                   verbose=False))
    return fmd, want


@pytest.mark.parametrize("batch", [32768, 64, 7])
def test_seqsort_matches_fermi_tpu(fixture, batch):
    fmd, want = fixture
    got = tss.seqsort(FMDIndex.restore(fmd, "cpu"), batch=batch,
                      verbose=False)
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)
    assert np.array_equal(np.sort(got >> np.uint64(2)),
                          np.arange(len(got), dtype=np.uint64))


@pytest.mark.parametrize("name", ["seqsort", "seqrank"])
def test_cli_seqsort_bytes(fixture, capsysbinary, name):
    from fermi_tpu.cli.main import main as jmain
    from fermi_tpu_torch.cli.main import main as tmain

    fmd, want = fixture
    assert tmain([name, "--device", "cpu", fmd]) == 0
    got = capsysbinary.readouterr().out
    assert jmain([name, fmd]) == 0
    assert got == capsysbinary.readouterr().out == want.tobytes()
    # -M: the host walks off the mapped record cache, fermi_tpu's bytes
    assert tmain([name, "-M", "-t", "2", fmd]) == 0
    got = capsysbinary.readouterr().out
    assert jmain([name, "-M", fmd]) == 0
    assert got == capsysbinary.readouterr().out == want.tobytes()


@pytest.fixture(scope="module")
def long_fixture(tmp_path_factory):
    """Reads of 4,097-6,000 bp from a 15 kbp genome, an exact duplicate and
    a contained read among them, with a few 100 bp reads: walks longer
    than fermi_tpu's device walk's 4,096 steps.  The oracle is fermi_tpu's
    host engine `seqsort_native`, which its CLI runs."""
    rng = np.random.default_rng(61)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 15000))
    reads = []
    for i in range(14):
        n = int(rng.integers(4097, 6001)) if i < 10 else 100
        p = int(rng.integers(0, len(genome) - n))
        reads.append(genome[p: p + n])
    reads += [reads[0], reads[1][50:4500]]
    fmd = str(tmp_path_factory.mktemp("ss_long") / "i.fmd")
    build_my_fmd(reads, fmd)
    want = jss.seqsort_native(JFMD.restore(fmd), n_threads=2, verbose=False)
    return fmd, want


def test_seqsort_reads_past_4096_bp(long_fixture):
    """Every walk runs to its sentinel: fermi_tpu's `seqsort_native` array
    word for word (a walk cut at 4,096 steps writes mid-read ranks)."""
    fmd, want = long_fixture
    got = tss.seqsort(FMDIndex.restore(fmd, "cpu"), verbose=False)
    assert np.array_equal(got, want)
    assert (want & np.uint64(2)).any() and (want & np.uint64(1)).any()


def test_cli_seqsort_reads_past_4096_bp(long_fixture, capsysbinary):
    """The CLI `seqsort` of the long reads: fermi_tpu's CLI bytes."""
    from fermi_tpu.cli.main import main as jmain
    from fermi_tpu_torch.cli.main import main as tmain

    fmd, want = long_fixture
    assert tmain(["seqsort", "--device", "cpu", fmd]) == 0
    got = capsysbinary.readouterr().out
    assert jmain(["seqsort", fmd]) == 0
    assert got == capsysbinary.readouterr().out == want.tobytes()


def test_seqrank_walk_raises_on_a_live_lane(fixture, monkeypatch):
    """A walk that outlasts the index's length (here: an index that claims
    to be shorter) raises instead of returning a mid-read rank."""
    from fermi_tpu_torch.search import extend

    idx = FMDIndex.restore(fixture[0], "cpu")
    monkeypatch.setattr(FMDIndex, "total", property(lambda self: 40))
    with pytest.raises(RuntimeError, match="without reaching a sentinel"):
        extend.seqrank_walk(idx, torch.arange(0, 8, 2))
