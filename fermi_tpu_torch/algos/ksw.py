"""Local alignment (Smith-Waterman, affine gaps) on the host.

The port's copy of fermi_tpu/algos/ksw.py.  `sw_score` is the score graph
cleaning (algos/mag.py, reference bubble.c) consumes, so `clean` scores its
bubbles on the host exactly as fermi_tpu does.  `ksw_align` gives the
coordinates of scaffolding's end-overlap join (algos/scaf.py, one
alignment per failed gap); kernel K2 (ops/sw_cuda.py) computes the score
alone, so it is not this function.  Both are numpy Gotoh recurrences,
row-vectorized with the lazy-F prefix-max trick.  A gap of length L costs
gapo + gape*L, matching ksw_u8/ksw_i16; scores match bubble.c:230-233
(match 5, mismatch -4, gapo 5, gape 2).

The lazy-F closed form is exact: a gap opened from a cell whose value came
from another horizontal gap is always dominated by extending the original
gap, so F can be computed from the pre-F row by one prefix max.
"""

import numpy as np


def _sw_rows(query, target, mat, m, gapo, gape, endsc):
    """Striped-SW-equivalent DP (ksw_i16 semantics): returns
    (score, te, Hmax_row) where te is the first target row attaining the
    global max and Hmax_row is the padded H row at te (8-lane striping pad).
    Stops early once score >= endsc."""
    qlen = len(query)
    slen = (qlen + 7) // 8
    vlen = slen * 8
    go_e = gapo + gape
    # per-symbol padded score rows: fake columns (>= qlen) score 0
    prof = np.zeros((m, vlen), np.int32)
    for c in range(m):
        prof[c, :qlen] = mat[c * m + np.asarray(query, np.int32)]
    jj = gape * np.arange(vlen, dtype=np.int32)
    H_prev = np.zeros(vlen + 1, np.int32)
    E = np.zeros(vlen, np.int32)
    gmax, te = 0, -1
    Hmax = np.zeros(vlen, np.int32)
    for i in range(len(target)):
        s = prof[target[i]]
        H_pre = np.maximum(H_prev[:-1] + s, E)
        H_pre = np.maximum(H_pre, 0)
        M = np.maximum.accumulate(H_pre + jj)
        H = H_pre.copy()
        if vlen > 1:
            F = M[:-1] - gapo - jj[1:]
            np.maximum(H[1:], F, out=H[1:])
            np.maximum(H, 0, out=H)
        E = np.maximum(E - gape, H - go_e)
        np.maximum(E, 0, out=E)
        imax = int(H.max())
        if imax > gmax:
            gmax, te = imax, i
            Hmax = H.copy()
            if gmax >= endsc:
                H_prev[1:] = H
                break
        H_prev[1:] = H
    return gmax, te, Hmax, slen


def _qe_from_row(Hmax, slen):
    """ksw's qe: scan the striped row in memory order (vector-major) and take
    the first strictly-greater cell (ksw.c:311-313)."""
    vlen = slen * 8
    qpos = np.arange(vlen)
    mem_order = (qpos % slen) * 8 + qpos // slen
    order = np.argsort(mem_order, kind="stable")
    row = Hmax[order]
    best = -1
    qe = -1
    for idx, val in zip(order, row):
        if int(val) > best:
            best = int(val)
            qe = int(idx)
    return qe


def ksw_align(query, target, m, mat, gapo=5, gape=2, xstart=False):
    """ksw_align (i16 path) semantics: returns (score, qb, qe, tb, te) with
    0-based inclusive ends; qb/tb are -1 unless xstart and recoverable."""
    query = np.asarray(query, np.int32)
    target = np.asarray(target, np.int32)
    mat = np.asarray(mat, np.int32)
    score, te, Hmax, slen = _sw_rows(query, target, mat, m, gapo, gape,
                                     0x10000)
    qe = _qe_from_row(Hmax, slen)
    qb = tb = -1
    if xstart and score > 0 and qe >= 0 and te >= 0:
        rq = query[: qe + 1][::-1]
        rt = target[: te + 1][::-1]
        s2, te2, Hmax2, slen2 = _sw_rows(rq, rt, mat, m, gapo, gape, score)
        qe2 = _qe_from_row(Hmax2, slen2)
        if s2 == score:
            tb = te - te2
            qb = qe - qe2
    return score, qb, qe, tb, te


def sw_score(query: np.ndarray, target: np.ndarray, match=5, mismatch=-4,
             gapo=5, gape=2) -> int:
    """Best local alignment score between nt4 sequences (values 0..3)."""
    q = np.asarray(query, dtype=np.int8)
    t = np.asarray(target, dtype=np.int8)
    if q.size == 0 or t.size == 0:
        return 0
    m, n = q.size, t.size
    NEG = np.int32(-(10 ** 6))
    go_e = gapo + gape
    jj = gape * np.arange(n, dtype=np.int32)
    H_prev = np.zeros(n + 1, np.int32)   # final H of previous row, index 0..n
    E = np.full(n, NEG, np.int32)        # vertical-gap state for columns 1..n
    best = 0
    for i in range(m):
        s = np.where(t == q[i], match, mismatch).astype(np.int32)
        E = np.maximum(E - gape, H_prev[1:] - go_e)
        H_pre = np.maximum(H_prev[:-1] + s, E)
        H_pre = np.maximum(H_pre, 0)
        # lazy F: F[j] = max_{j'<j}(H_pre[j'] + gape*j') - gapo - gape*j
        M = np.maximum.accumulate(H_pre + jj)
        H = H_pre.copy()
        if n > 1:
            F = M[:-1] - gapo - jj[1:]
            np.maximum(H[1:], F, out=H[1:])
            np.maximum(H, 0, out=H)
        best = max(best, int(H.max()))
        H_prev[1:] = H
    return best
