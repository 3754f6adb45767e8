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
