"""The run-length encoder of the port (`rld.Runs.from_bwt` over
native/rld_codec.cpp's `frle_count` and `frle_fill`) against fermi_tpu's
`Runs.from_bwt` on the CPU.

The native pass cuts the BWT into chunks, one thread each; a chunk owns the
runs that start in it and follows its last run into the chunks after it.
The entries take the thread count as an argument, so the shapes here run on
1 to 8 threads though `Runs.from_bwt` would give them one: runs that cross
every chunk, boundaries on every chunk edge, fewer symbols than threads.
Runs and counts are integers: equal, dtypes included."""

import os

import numpy as np
import pytest

from fermi_tpu import rld as jrld
from fermi_tpu_torch import native, rld

from native_lock import load_fermi_tpu_native

load_fermi_tpu_native()

THREADS = [1, 2, 3, 7, 8]


def _bwt(shape):
    rng = np.random.default_rng(20)
    if shape == "random":
        return rng.integers(0, 6, 10_007).astype(np.uint8)
    if shape == "runs_of_64":
        return np.repeat(rng.integers(0, 6, 157).astype(np.uint8), 64)
    if shape == "one_run":            # one run across every chunk
        return np.full(5_000, 2, np.uint8)
    if shape == "chunk_edges":
        # 840 symbols split evenly by every thread count here, into chunks
        # of 840, 420, 280, 120 or 105: runs of 15 put a boundary on every
        # chunk edge, each run's symbol the one before's plus one, mod 6
        return (np.arange(840) // 15 % 6).astype(np.uint8)
    if shape == "fewer_than_threads":
        return np.array([3, 3, 0, 5, 5], np.uint8)
    if shape == "one_symbol":
        return np.array([4], np.uint8)
    if shape == "six_symbols":        # every symbol, each with its own total
        lens = rng.integers(1, 200, 600)
        return np.repeat(np.arange(600) % 6, lens).astype(np.uint8)
    raise ValueError(shape)


SHAPES = ["random", "runs_of_64", "one_run", "chunk_edges",
          "fewer_than_threads", "one_symbol", "six_symbols"]


def _native_runs(bwt, n_threads, asize=6):
    """The two native calls on n_threads threads, mcnt summed as
    Runs.from_bwt sums it."""
    lib = native.get_lib()
    first = np.empty(n_threads, np.int64)
    n_runs = lib.frle_count(bwt.ctypes.data, bwt.size, n_threads,
                            first.ctypes.data)
    assert n_runs >= 0
    symbols = np.empty(n_runs, np.uint8)
    lengths = np.empty(n_runs, np.int64)
    counts = np.empty((n_threads, asize), np.uint64)
    assert lib.frle_fill(bwt.ctypes.data, bwt.size, n_threads,
                         first.ctypes.data, symbols.ctypes.data,
                         lengths.ctypes.data, asize, counts.ctypes.data) == 0
    mcnt = np.empty(asize + 1, np.uint64)
    mcnt[0] = bwt.size
    mcnt[1:] = counts.sum(axis=0, dtype=np.uint64)
    return rld.Runs(lengths, symbols, mcnt, asize)


def _assert_runs_equal(got, want):
    for f in ("lengths", "symbols", "mcnt"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("n_threads", THREADS)
@pytest.mark.parametrize("shape", SHAPES)
def test_threaded_runs_equal_one_thread_and_fermi_tpu(shape, n_threads):
    """The runs and counts on n_threads threads equal those on one thread
    and fermi_tpu's from_bwt."""
    bwt = _bwt(shape)
    got = _native_runs(bwt, n_threads)
    _assert_runs_equal(got, _native_runs(bwt, 1))
    _assert_runs_equal(got, jrld.Runs.from_bwt(bwt))


@pytest.mark.parametrize("n_threads", [1, 3])
def test_symbols_past_the_alphabet_are_not_counted(n_threads):
    """A symbol from asize up is a run like any other but no count, as in
    fermi_tpu's bincount cut to asize."""
    bwt = np.array([0, 1, 7, 7, 1, 9, 2, 2, 2], np.uint8)
    _assert_runs_equal(_native_runs(bwt, n_threads, asize=4),
                       jrld.Runs.from_bwt(bwt, asize=4))


@pytest.fixture
def eight_cpus(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))


def test_thread_count_rule(eight_cpus, monkeypatch):
    """One thread below two minimum chunks, one per minimum chunk above,
    never more than the CPUs the process may run on."""
    m = rld.RLE_MIN_CHUNK
    assert [rld.rle_threads(n) for n in (0, 1, m - 1, m, 2 * m - 1)] == \
        [1] * 5
    assert [rld.rle_threads(n) for n in (2 * m, 3 * m + 1, 7 * m)] == \
        [2, 3, 7]
    assert rld.rle_threads(8 * m) == rld.rle_threads(10 ** 12) == 8
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    assert rld.rle_threads(10 ** 12) == 1


@pytest.mark.parametrize("shape", ["random", "one_run", "six_symbols"])
def test_from_bwt_on_threads_writes_fermi_tpus_bytes(shape, eight_cpus,
                                                     monkeypatch, tmp_path):
    """Runs.from_bwt with a minimum chunk small enough that it takes eight
    threads: fermi_tpu's runs and counts, and its .fmd bytes."""
    bwt = _bwt(shape)
    monkeypatch.setattr(rld, "RLE_MIN_CHUNK", bwt.size // 8)
    assert rld.rle_threads(bwt.size) == 8
    got, want = rld.Runs.from_bwt(bwt), jrld.Runs.from_bwt(bwt)
    _assert_runs_equal(got, want)
    rld.write_fmd(got, str(tmp_path / "t.fmd"))
    jrld.write_fmd(want, str(tmp_path / "j.fmd"))
    assert (tmp_path / "t.fmd").read_bytes() == \
        (tmp_path / "j.fmd").read_bytes()
