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
    and a pair whose target is over a thousand columns long."""
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


def test_sw_plan_carries_its_offsets():
    """sw_scores takes the pairs' offsets from its plan: on the CPU the
    plan's offsets, sliced ones too, run the plain version; sw_plan refuses
    offsets that fall, start below 0 or do not pair."""
    qs, ts = _pairs(12, seed=2, qmax=40, tmax=60)
    (qc, qo), (tc, to) = sw_cuda.pack(qs), sw_cuda.pack(ts)
    q, t = torch.from_numpy(qc), torch.from_numpy(tc)
    want = sw_cuda.sw_score_batch(qs, ts, device="cpu")
    whole = sw_cuda.sw_plan(qo, to, "cpu")
    assert whole.tasks is None
    assert np.array_equal(sw_cuda.sw_scores(q, t, whole).numpy(), want)
    part = sw_cuda.sw_plan(qo[4:9], to[4:9], "cpu")
    assert np.array_equal(sw_cuda.sw_scores(q, t, part).numpy(), want[4:8])
    for bad in (qo[::-1].copy(), qo - 1, qo[:-1]):
        with pytest.raises(ValueError, match="non-decreasing"):
            sw_cuda.sw_plan(bad, to, "cpu")
    assert sw_cuda.LAUNCHES["sw_score_batch"] == 0


def _boundary(rows=sw_cuda.ROWS, tlens=(1, 255, 256, 257, 6000), seed=21):
    """Every query length at an edge of the kernel's layout (R = rows a
    lane holds: 1, R, R + 1, one chunk of 32 R, one more, three chunks and
    5 rows) against every target length in tlens, in random order; half the
    targets hold a mutated copy of the query."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for ql in (1, rows, rows + 1, 32 * rows, 32 * rows + 1, 96 * rows + 5):
        for tl in tlens:
            q = rng.integers(0, 4, ql).astype(np.int8)
            t = rng.integers(0, 4, tl).astype(np.int8)
            if rng.random() < 0.5:
                m = q[: max(1, tl // 2)].copy()
                m[rng.integers(0, m.size, 3)] = rng.integers(0, 4, 3)
                at = int(rng.integers(0, tl))
                t = np.concatenate([t[:at], m, t[at:]])[:max(tl, m.size)]
            qs.append(q)
            ts.append(t)
    order = rng.permutation(len(qs))
    return [qs[i] for i in order], [ts[i] for i in order]


def test_sw_layout_boundaries_match_fermi_tpu():
    """Query and target lengths at the edges of the kernel's lanes, chunks
    and wavefront, through the plain version, against fermi_tpu's Pallas
    kernel (interpret mode) and algos.ksw.sw_score."""
    qs, ts = _boundary()
    got = sw_cuda.sw_score_batch(qs, ts, device="cpu")
    assert np.array_equal(got, np.array([sw_score(q, t) for q, t in
                                         zip(qs, ts)], np.int32))
    assert np.array_equal(got, sw_pallas.sw_score_batch(qs, ts))
    assert got.max() > 100


def test_schedule_covers_each_pair_once():
    """The kernel's warp tasks: a query of more than one chunk fills one
    block of BLOCK_WARPS PIPE tasks of G = 32 that name it alone, such
    blocks first; every other pair in exactly one slot, in a group of 4 to
    32 lanes that holds its query, 32 / G pairs a warp, warps in falling
    order of their steps; carry offsets only for pairs of more than one
    chunk, (chunks - 1) * tlen entries each."""
    R, W = sw_cuda.ROWS, sw_cuda.BLOCK_WARPS
    qs, ts = _boundary()
    rng = np.random.default_rng(4)
    qs += [rng.integers(0, 4, n).astype(np.int8) for n in (0, 3, 40, 200,
                                                           40 * R)]
    ts += [rng.integers(0, 4, n).astype(np.int8) for n in (7, 0, 90, 11, 0)]
    (_, qo), (_, to) = sw_cuda.pack(qs), sw_cuda.pack(ts)
    tasks, coff, total = sw_cuda.schedule(qo, to)
    qlen, tlen = np.diff(qo), np.diff(to)
    chunks = np.maximum(1, -(-qlen // (32 * R)))
    multi = chunks > 1
    G = tasks[:, 0] & (sw_cuda.PIPE - 1)
    ids = tasks[:, 1:]
    pipe = (tasks[:, 0] & sw_cuda.PIPE) > 0
    n_pipe = int(pipe.sum())
    assert n_pipe == W * multi.sum() and pipe[:n_pipe].all()
    blocks = ids[:n_pipe].reshape(-1, W, sw_cuda.TASK_SLOTS)
    assert (G[:n_pipe] == 32).all() and (blocks[:, :, 1:] == -1).all()
    assert (blocks[:, :, 0] == blocks[:, :1, 0]).all()
    assert np.array_equal(np.sort(blocks[:, 0, 0]), np.flatnonzero(multi))
    pwork = [-(-chunks[p] // W) * (tlen[p] + 31) for p in blocks[:, 0, 0]]
    assert pwork == sorted(pwork, reverse=True)
    rest = ids[n_pipe:]
    assert np.array_equal(np.sort(rest[rest >= 0]), np.flatnonzero(~multi))
    steps = []
    for g, row in zip(G[n_pipe:], rest):
        assert g in sw_cuda.GROUP_SIZES
        per = 32 // g
        assert (row[per:] == -1).all() and row[0] >= 0
        p = row[:per][row[:per] >= 0]
        assert (qlen[p] <= g * R).all()
        assert (g == 4) | (qlen[p] > g // 2 * R).all()
        steps.append(int(tlen[p].max()) + g - 1)
    assert steps == sorted(steps, reverse=True)
    assert total == ((chunks - 1) * tlen)[multi].sum()
    assert np.array_equal(coff[multi], np.concatenate(
        [[0], np.cumsum(((chunks - 1) * tlen)[multi])[:-1]]))


def _wavefront(qs, ts, rows, match=5, mismatch=-4, gapo=5, gape=2):
    """csrc/sw.cu lane by lane and step by step on its schedule: lane g of
    a group holds `rows` query rows and takes column s - g at step s, its
    first row's diagonal, H and E above from lane g - 1's previous step
    (or the boundary, or, for lane 0 of chunk c > 0, boundary c - 1 of the
    carry, which chunk c - 1 wrote whole: on the card the chunks of a PIPE
    block run as a pipeline); F is carried along each row; PIPE warps take
    E below from H without E (the short-chain form)."""
    neg = sw_cuda.NEG
    (qc, qo), (tc, to) = sw_cuda.pack(qs), sw_cuda.pack(ts)
    tasks, coff, total = sw_cuda.schedule(qo, to, rows)
    carry = np.zeros((max(total, 1), 2), np.int64)
    out = np.full(len(qs), -1, np.int64)
    go_e, e_top = gapo + gape, max(neg - gape, -(gapo + gape))
    for task in tasks:
        G = int(task[0]) & (sw_cuda.PIPE - 1)
        short = bool(task[0] & sw_cuda.PIPE)
        for p in task[1: 1 + 32 // G]:
            if p < 0 or out[p] >= 0:     # a PIPE block names its pair 4 times
                continue
            q, t = qc[qo[p]: qo[p + 1]], tc[to[p]: to[p + 1]]
            chunks = max(1, -(-len(q) // (32 * rows)))
            assert chunks == 1 or task[0] & sw_cuda.PIPE
            best = 0
            for c in range(chunks):
                rd = coff[p] + (c - 1) * len(t)
                wr = coff[p] + c * len(t)
                r0 = c * G * rows
                H = np.zeros((G, rows), np.int64)
                F = np.full((G, rows), neg, np.int64)
                out_prev = [(0, e_top)] * G   # lane's last (H, E below)
                diag0 = [0] * G
                for s in range(len(t) + G - 1):
                    sent = list(out_prev)
                    for g in range(G):
                        j = s - g
                        if not 0 <= j < len(t):
                            continue
                        if g:
                            h_in, e = sent[g - 1]
                        elif c:
                            h_in, e = carry[rd + j]
                        else:
                            h_in, e = 0, e_top
                        diag = diag0[g]
                        for r in range(rows):
                            i = r0 + g * rows + r
                            sc = match if i < len(q) and q[i] == t[j] \
                                else mismatch
                            x = max(diag + sc, F[g, r], 0)
                            h = max(x, e)
                            diag, H[g, r] = H[g, r], h
                            # the short-chain form drops E - (gapo + gape)
                            e = max(e - gape, (x if short else h) - go_e)
                            F[g, r] = max(F[g, r] - gape, h - go_e)
                            if i < len(q):
                                best = max(best, h)
                        out_prev[g] = (H[g, -1], e)
                        diag0[g] = h_in
                        if g == G - 1 and c + 1 < chunks:
                            carry[wr + j] = out_prev[g]
            out[p] = best
    return out


@pytest.mark.parametrize("scores", [{}, dict(match=2, mismatch=-3, gapo=3,
                                              gape=1)])
def test_wavefront_order_matches_plain(scores):
    """The kernel's order of work, emulated on the host at 2 rows a lane
    (so chunks come at 64 rows), gives the plain version's scores: carried
    F equals the lazy-F closed form, the short-chain form of the long
    queries' blocks equals the plain one, and the lane relay, the chunk
    carry and the rows past qlen are as the kernel does them."""
    qs, ts = _boundary(rows=2, tlens=(1, 63, 64, 65, 300))
    (qc, qo), (tc, to) = sw_cuda.pack(qs), sw_cuda.pack(ts)
    want = sw_cuda.sw_score_batch_plain(
        *(torch.from_numpy(a) for a in (qc, qo, tc, to)), **scores)
    assert np.array_equal(_wavefront(qs, ts, 2, **scores), want.numpy())
