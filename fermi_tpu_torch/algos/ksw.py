"""Local alignment score (Smith-Waterman, affine gaps) on the host.

The port's copy of fermi_tpu/algos/ksw.py's `sw_score`, the score graph
cleaning (algos/mag.py, reference bubble.c) consumes, so `clean` scores its
bubbles on the host exactly as fermi_tpu does.  A numpy Gotoh recurrence,
row-vectorized with the lazy-F prefix-max trick.  A gap of length L costs
gapo + gape*L, matching ksw_u8/ksw_i16; scores match bubble.c:230-233
(match 5, mismatch -4, gapo 5, gape 2).  `ksw_align` (scaffolding's
coordinates) comes with algos/scaf.py (ROADMAP queue 1).

The lazy-F closed form is exact: a gap opened from a cell whose value came
from another horizontal gap is always dominated by extending the original
gap, so F can be computed from the pre-F row by one prefix max.
"""

import numpy as np


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
