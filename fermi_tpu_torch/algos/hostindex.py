"""Host (numpy) FMD-index of a small read set.

The port of fermi_tpu/algos/hostindex.py's numpy paths, with the same
queries and results.  It serves the local assemblies of scaffolding and
`example` (algos/scaf.py `fm6_api_unitig`: a few hundred to a few thousand
reads), whose unitig walk (algos/unitig.py) is host control flow over one
small interval set at a time, so the cost of a query is its call overhead.
It therefore keeps the count of every symbol before every position (an
[n + 1, 6] table, 48 bytes a symbol) and answers rank6 with one gather,
where fermi_tpu counts within a 128-symbol block.  It never holds a full
index: that lives on the device (index/fmd.py).
"""

import numpy as np


class HostIndex:
    def __init__(self, bwt: np.ndarray):
        self.bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        n = self.bwt.size
        # occ[k, c] = #c in bwt[0..k-1], for k in [0, n]
        self.occ = np.zeros((n + 1, 6), np.int64)
        np.cumsum(self.bwt[:, None] == np.arange(6, dtype=np.uint8), axis=0,
                  out=self.occ[1:])
        self.mcnt = np.zeros(7, np.int64)
        self.mcnt[0] = n
        self.mcnt[1:] = self.occ[n]
        self.cnt = np.zeros(7, np.int64)
        self.cnt[1:] = np.cumsum(self.mcnt[1:7])
        self._cnt6 = self.cnt[:6].tolist()

    @property
    def n_seqs(self) -> int:
        return int(self.mcnt[1])

    def rank6(self, k):
        """Counts of symbols 0..5 in BWT[0..k-1]; k scalar or [B] -> [B,6]."""
        return self.occ[np.asarray(k, dtype=np.int64)]

    def extend6(self, kb, kf, sz, is_back: bool):
        """Vectorized fm6_extend over interval arrays -> ([B,6],)*3."""
        kb = np.atleast_1d(np.asarray(kb, np.int64))
        kf = np.atleast_1d(np.asarray(kf, np.int64))
        sz = np.atleast_1d(np.asarray(sz, np.int64))
        primary = kb if is_back else kf
        tk = self.occ[primary]
        osz = self.occ[primary + sz] - tk
        outp = self.cnt[:6][None, :] + tk
        other_base = kf if is_back else kb
        other = np.empty_like(outp)
        other[:, 0] = other_base
        other[:, 4] = other[:, 0] + osz[:, 0]
        other[:, 3] = other[:, 4] + osz[:, 4]
        other[:, 2] = other[:, 3] + osz[:, 3]
        other[:, 1] = other[:, 2] + osz[:, 2]
        other[:, 5] = other[:, 1] + osz[:, 1]
        if is_back:
            return outp, other, osz
        return other, outp, osz

    def extend1(self, kb: int, kf: int, sz: int, is_back: bool):
        """extend6 of one interval in Python ints: (KB, KF, SZ), lists of
        6.  The unitig walk extends one interval at a time along every read
        it checks; numpy's call overhead would be most of such a call."""
        primary = kb if is_back else kf
        tk = self.occ[primary].tolist()
        osz = [b - a for a, b in zip(tk, self.occ[primary + sz].tolist())]
        outp = [c + t for c, t in zip(self._cnt6, tk)]
        o0 = kf if is_back else kb
        o4 = o0 + osz[0]
        o3 = o4 + osz[4]
        o2 = o3 + osz[3]
        o1 = o2 + osz[2]
        other = [o0, o1, o2, o3, o4, o1 + osz[1]]
        if is_back:
            return outp, other, osz
        return other, outp, osz

    def set_intv(self, c: int):
        comp = 5 - c if 1 <= c <= 4 else c
        return (int(self.cnt[c]), int(self.cnt[comp]),
                int(self.cnt[c + 1] - self.cnt[c]))

    def retrieve(self, x: int):
        """Sequence (forward order, nt6) of the x-th read + final rank."""
        k = int(x)
        out = []
        while True:
            c = int(self.bwt[k])
            k = int(self.cnt[c] + self.occ[k, c])
            if c == 0:
                return np.array(out[::-1], dtype=np.uint8), k
            out.append(c)

    def retrieve_batch(self, xs, max_len: int = 1 << 16):
        """Vectorized LF walks for many sentinel ranks at once.

        Returns (seqs: list of forward nt6 arrays, final_ranks int64[N])."""
        k = np.asarray(xs, np.int64).copy()
        n = len(k)
        done = np.zeros(n, bool)
        cols = []
        for _ in range(max_len):
            c = self.bwt[k].astype(np.int64)
            c[done] = 0
            kp = self.cnt[c] + self.occ[k, c]
            hit = ~done & (c == 0)
            emit = ~done & (c != 0)
            cols.append(np.where(emit, c, 0).astype(np.uint8))
            k = np.where(done, k, kp)
            done |= hit
            if done.all():
                break
        mat = np.stack(cols, axis=1) if cols else np.zeros((n, 0), np.uint8)
        lens = (mat != 0).sum(axis=1)
        return [mat[i, :lens[i]][::-1].copy() for i in range(n)], k
