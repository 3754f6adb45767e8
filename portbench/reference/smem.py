"""Supermaximal exact matches (SMEMs) of queries against an FMD-index, by a
plain sequential copy of fermi's fm6_smem1_core and fm6_smem (smem.c:13-80,
397-411).

The index is the reference's own: the BWT that reference/bwt.py works out,
with a count of each symbol before every 64th position.  Each match is
(start, end, size, left_closed, kf), in the order fm6_smem emits them:
[start, end) on the query, the size of its bi-interval, whether a
sentinel can precede it (a read starts with it) and the start of its
interval in the forward index.
"""

import numpy as np
import torch

STEP = 64


def _comp(c):
    return 5 - c if 1 <= c <= 4 else c


class Index:
    """Rank over a BWT held on the host, its counts sampled every STEP
    symbols (worked out on `device`)."""

    def __init__(self, bwt: torch.Tensor):
        n = bwt.numel()
        nb = n // STEP + 1
        pad = torch.full((nb * STEP,), 7, dtype=torch.uint8,
                         device=bwt.device)
        pad[:n] = bwt
        blocks = pad.view(nb, STEP)
        per = torch.stack([(blocks == c).sum(1) for c in range(6)], 1)
        occ = torch.zeros((nb + 1, 6), dtype=torch.int64, device=bwt.device)
        occ[1:] = torch.cumsum(per, 0)
        self.occ = occ.cpu().numpy()
        self.bwt = bwt.cpu().numpy()
        tot = self.occ[-1]
        self.cnt = [0] * 7
        for c in range(6):
            self.cnt[c + 1] = self.cnt[c] + int(tot[c])
        self.n_seqs = int(tot[0])

    def rank6(self, k):
        b = k // STEP
        r = self.occ[b]
        lo = b * STEP
        if k > lo:
            r = r + np.bincount(self.bwt[lo:k], minlength=6)[:6]
        return r.tolist()

    def extend(self, ik, back):
        """The six one-symbol extensions of the bi-interval ik = (kb, kf,
        sz): backward (prepend) or forward (append the complement)."""
        kb, kf, sz = ik
        prim = kb if back else kf
        tk = self.rank6(prim)
        tl = self.rank6(prim + sz)
        osz = [tl[c] - tk[c] for c in range(6)]
        other = [0] * 6
        other[0] = kf if back else kb
        other[4] = other[0] + osz[0]
        other[3] = other[4] + osz[4]
        other[2] = other[3] + osz[3]
        other[1] = other[2] + osz[2]
        other[5] = other[1] + osz[1]
        outp = [self.cnt[c] + tk[c] for c in range(6)]
        if back:
            return [(outp[c], other[c], osz[c]) for c in range(6)]
        return [(other[c], outp[c], osz[c]) for c in range(6)]


def _smem1(idx, q, x, mems, self_match):
    """fm6_smem1_core: the SMEMs that cover position x; returns where the
    next search starts."""
    n = len(q)
    c = q[x]
    ik = (idx.cnt[c], idx.cnt[_comp(c)], idx.cnt[c + 1] - idx.cnt[c])
    info = x + 1
    curr = []
    i = x + 1
    while i < n:                                  # forward
        c = _comp(q[i])
        ok = idx.extend(ik, False)
        if ok[c][2] != ik[2]:
            if ik[2] != ok[0][2]:
                curr.append((ik, info))
            if not self_match and ok[0][2]:
                curr.append((ok[0], i))
        if (not self_match and ok[c][2] == 0) or \
                (self_match and ok[c][2] < 2):
            break
        ik, info = ok[c], i + 1
        i += 1
    if i == n:
        curr.append((ik, info))
        if not self_match:
            ok = idx.extend(ik, False)
            if ok[0][2]:
                curr.append((ok[0], n))
    curr.reverse()
    ret = curr[0][1] if curr else (n if i >= n else i)
    prev = curr
    first = len(mems)
    i = x - 1
    while i >= -1:                                # backward
        c = 0 if i < 0 else q[i]
        curr = []
        for p, pinfo in prev:
            ok = idx.extend(p, True)
            fl = ok[0][2] != 0 and p[1] < idx.n_seqs
            cont = ok[c][2] > 1 if self_match else ok[c][2] != 0
            if (not cont or fl or i == -1) and (not curr or fl):
                if fl or len(mems) == first or i + 1 < mems[-1][0]:
                    mems.append((i + 1, pinfo, p[2], ok[0][2] != 0, p[1]))
            if cont and (p[1] < idx.n_seqs or not curr or
                         ok[c][2] != curr[-1][0][2]):
                curr.append((ok[c], pinfo))
        if not curr:
            break
        prev = curr
        i -= 1
    mems[first:] = mems[first:][::-1]
    return ret


def smems(idx: Index, q, self_match=False):
    """All SMEMs of one query (nt6 codes 1-4), in fm6_smem's order."""
    q = [int(c) for c in q]
    mems = []
    x = 0
    while x < len(q):
        nx = _smem1(idx, q, x, mems, self_match)
        x = nx if nx > x else x + 1
    return mems
