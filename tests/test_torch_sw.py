"""Kernel K2's port (fermi_tpu_torch.ops.sw_cuda) against fermi_tpu on the
CPU: the port's sw_score_batch(device="cpu") (the plain version of
csrc/sw.cu) equals fermi_tpu's Pallas sw_score_batch (interpret mode) and
algos.ksw.sw_score, score for score (integers: tolerance zero)."""

import numpy as np
import pytest
import torch

from fermi_tpu.algos.ksw import sw_score
from fermi_tpu.ops import sw_pallas
from fermi_tpu_torch.ops import sw_cuda

# The port's CPU ops are small: one thread each keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)


def _pairs(n, seed, qmax=200, tmax=300):
    """The recipe of tests/test_sw_pallas.py: half the pairs overlap (the
    target holds a mutated copy of the query), half are unrelated."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(n):
        ql = int(rng.integers(1, qmax))
        tl = int(rng.integers(1, tmax))
        q = rng.integers(0, 4, ql).astype(np.int8)
        if rng.random() < 0.5:
            t = q.copy()
            for _ in range(int(rng.integers(0, 6))):
                t[int(rng.integers(0, ql))] = int(rng.integers(0, 4))
            pad = rng.integers(0, 4, max(0, tl - ql)).astype(np.int8)
            t = np.concatenate([t, pad])
        else:
            t = rng.integers(0, 4, tl).astype(np.int8)
        qs.append(q)
        ts.append(t)
    return qs, ts


def _degenerate():
    """Length-1 pairs, no-match pairs (score 0), an empty query and target,
    and a pair whose target is longer than a warp pass of the kernel."""
    one, a, t = (np.array([1], np.int8), np.array([0], np.int8),
                 np.array([3], np.int8))
    empty = np.zeros(0, np.int8)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 40).astype(np.int8)
    long_t = np.concatenate([rng.integers(0, 4, 700), q,
                             rng.integers(0, 4, 300)]).astype(np.int8)
    qs = [one, a, one, empty, a, q, np.full(5, 2, np.int8)]
    ts = [one, t, np.array([1, 1, 1], np.int8), t, empty, long_t,
          np.full(9, 1, np.int8)]
    return qs, ts


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_sw_score_batch_matches_fermi_tpu(case):
    qs, ts = _pairs(40, seed=5) if case == "random" else _degenerate()
    got = sw_cuda.sw_score_batch(qs, ts, device="cpu")
    want = np.array([sw_score(q, t) for q, t in zip(qs, ts)], np.int32)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got, sw_pallas.sw_score_batch(qs, ts))


def test_sw_edge_values():
    one = np.array([1], np.int8)
    assert sw_cuda.sw_score_batch([], [], device="cpu").size == 0
    assert sw_cuda.sw_score_batch([one], [one], device="cpu")[0] == 5
    assert sw_cuda.sw_score_batch([np.array([0], np.int8)],
                                  [np.array([3], np.int8)],
                                  device="cpu")[0] == 0
    with pytest.raises(ValueError):
        sw_cuda.sw_score_batch([one], [], device="cpu")


def test_sw_other_scores_and_chunks():
    """Non-default scoring, and the plain version's chunking (pairs padded
    per chunk) against one chunk for the whole batch."""
    qs, ts = _pairs(30, seed=9, qmax=60, tmax=90)
    kw = dict(match=2, mismatch=-3, gapo=3, gape=1)
    want = np.array([sw_score(q, t, **kw) for q, t in zip(qs, ts)], np.int32)
    assert np.array_equal(sw_cuda.sw_score_batch(qs, ts, device="cpu", **kw),
                          want)
    (qc, qo), (tc, to) = sw_cuda.pack(qs), sw_cuda.pack(ts)
    t = [torch.from_numpy(a) for a in (qc, qo, tc, to)]
    chunked = sw_cuda.sw_score_batch_plain(*t, **kw, chunk=7)
    assert np.array_equal(chunked.numpy(), want)
    assert sw_cuda.LAUNCHES["sw_score_batch"] == 0
