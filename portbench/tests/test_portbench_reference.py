"""The plain reference agrees with fermi_tpu_torch on tiny inputs (the
port's plain PyTorch versions, on the CPU), and its control does not."""

import numpy as np
import pytest
import torch

from conftest import TINY
from portbench import reads
from portbench.reference import bwt as ref_bwt
from portbench.reference import rld as ref_rld
from portbench.reference import smem as ref_smem

CFG = dict(TINY, read_len=100, insert_mean=300, insert_sd=20,
           insert_min=110, insert_max=1000, sub_rate=0.01, sub_qual=14,
           qual=38)


@pytest.fixture(scope="module")
def data():
    rng = reads.rng_for(2**31 + 3, 0)
    g = reads.genome(rng, CFG)
    r1, r2 = reads.pairs(rng, g, CFG)
    rd = np.concatenate([r1, r2])
    rd[5] = np.tile([0, 1, 2, 3], 25)     # its own reverse complement
    return g, rd


def _port_bwt(rd):
    from fermi_tpu_torch.construct import suffix, suffix_device

    n, L = rd.shape
    text = suffix.build_text_packed(rd.reshape(-1) + 1,
                                    np.arange(n + 1, dtype=np.int64) * L)
    return text, suffix_device.multistring_bwt_device(text, "cpu")


def test_text_and_bwt_equal_the_ports(data):
    _, rd = data
    text, port = _port_bwt(rd)
    mine = ref_bwt.text_of(rd)
    assert np.array_equal(mine, text)
    assert mine.size == rd.size * 2 + 2 * len(rd) - 2   # one read trimmed
    ref = ref_bwt.bwt_of_text(mine, "cpu").numpy()
    assert np.array_equal(ref, port)
    counts = ref_bwt.counts_of(torch.from_numpy(ref))
    assert counts[0] == ref.size and counts[1] == 2 * len(rd)


def test_control_breaks_the_sentinel_order(data):
    _, rd = data
    text = ref_bwt.text_of(rd)
    ref = ref_bwt.bwt_of_text(text, "cpu")
    ctl = ref_bwt.bwt_of_text(text, "cpu", sentinels_ordered=False)
    assert int((ref != ctl).sum()) > 0
    assert torch.equal(torch.bincount(ref.long()), torch.bincount(ctl.long()))


def _fmd(tmp_path, bwt):
    from fermi_tpu_torch import rld

    runs = rld.Runs.from_bwt(bwt)
    path = str(tmp_path / "x.fmd")
    rld.write_fmd(runs, path)
    return open(path, "rb").read(), runs


def test_decoder_reads_the_ports_fmd(data, tmp_path):
    _, rd = data
    _, port = _port_bwt(rd)
    raw, runs = _fmd(tmp_path, port)
    counts, bwt, whole = ref_rld.decode(raw, "cpu")
    assert whole and np.array_equal(bwt.numpy(), port)
    assert np.array_equal(counts[1:], runs.mcnt[1:].astype(np.int64))
    assert counts[0] == port.size
    assert not ref_rld.decode(raw[:-8], "cpu")[2]


def test_decoder_long_runs_and_wide_headers(tmp_path):
    """Runs past 2^15 symbols a block take 32-bit headers; runs of every
    length up to 2^20 take every width of code."""
    rng = np.random.default_rng(11)
    lens = np.concatenate([rng.integers(1, 4, 5000),
                           2 ** rng.integers(0, 21, 3000)])
    rng.shuffle(lens)
    sym = np.cumsum(rng.integers(1, 6, lens.size)) % 6
    bwt = np.repeat(sym.astype(np.uint8), lens)
    raw, runs = _fmd(tmp_path, bwt)
    counts, got, whole = ref_rld.decode(raw, "cpu")
    assert whole and np.array_equal(got.numpy(), bwt)
    assert np.array_equal(counts[1:], np.bincount(bwt, minlength=6))


def test_smems_equal_the_ports(data):
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import smem

    g, rd = data
    _, port = _port_bwt(rd)
    q = reads.queries(reads.rng_for(9, 1), g, 40, 100, 0.01)
    q[:4, 60:] = 1 + np.random.default_rng(1).integers(0, 4, (4, 40))
    got = smem.smem_all(FMDIndex.from_bwt(port, "cpu"), list(q))
    idx = ref_smem.Index(ref_bwt.bwt_of_text(ref_bwt.text_of(rd), "cpu"))
    want = [ref_smem.smems(idx, x) for x in q]
    assert got == want
    assert sum(map(len, want)) > 2 * len(q)
    assert any(m[3] for w in want for m in w)       # a left-closed match
