"""Out-of-core FMD-index: rank queries on the compressed .fmd through mmap.

The port's copy of fermi_tpu/index/mmapfmd.py.  Reference fermi offers
`-M` everywhere: rld_restore_mmap (rld.c:327-346) maps the delta-compressed
index read-only and every rank walks the compressed blocks through the
sampled frame index (rld_locate_blk, rld.c:352-392), so an index far larger
than RAM is usable with RSS bounded by the pages actually touched.  The
native codec (native/rld_codec.cpp fmmap_*) maps the file and answers
batched exclusive rank queries from the compressed domain; extend6,
backward_search and retrieve build on it with index/fmd.FMDIndex's
conventions.  Host code: numpy arrays in and out, no device.

Memory: only O(batch) query and result arrays; the index stays on disk
(MADV_RANDOM mapped pages, evictable under pressure).
"""

import os

import numpy as np

from fermi_tpu_torch import native


class MmapIndex:
    """Compressed-domain FMD-index over an mmapped .fmd file."""

    def __init__(self, path: str, n_threads: int | None = None):
        self._h = None
        self._lib = native.get_lib()
        info = np.zeros(24, np.int64)
        self._h = self._lib.fmmap_open(path.encode(), info.ctypes.data)
        if not self._h:
            raise OSError(f"cannot mmap-open {path} (RLD\\2 only)")
        self.asize = int(info[0])
        self.sbits = int(info[1])
        self.n_bytes = int(info[3])
        self.cnt = info[5: 5 + self.asize + 1].copy()
        self.mcnt = info[13: 13 + self.asize + 1].copy()
        self.t = n_threads or min(os.cpu_count() or 1, 8)

    @property
    def total(self) -> int:
        return int(self.mcnt[0])

    @property
    def n_seqs(self) -> int:
        return int(self.mcnt[1])

    def close(self):
        if self._h:
            self._lib.fmmap_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def rank6(self, k) -> np.ndarray:
        """Counts of symbols 0..5 in BWT[0..k-1]; k int array -> [n, 6]."""
        k = np.ascontiguousarray(np.atleast_1d(np.asarray(k, np.int64)))
        if k.size and (k.min() < 0 or k.max() > self.total):
            raise ValueError(f"rank6: positions outside [0, {self.total}]")
        out = np.empty((k.size, self.asize), np.int64)
        self._lib.fmmap_rank6(self._h, k.ctypes.data, k.size,
                              out.ctypes.data, self.t)
        return out

    def extend6(self, kb, kf, sz, is_back: bool):
        """Batched fm6_extend (exact.c:72-88) in the compressed domain:
        ([n, 6] kb, [n, 6] kf, [n, 6] sz)."""
        kb = np.asarray(kb, np.int64)
        kf = np.asarray(kf, np.int64)
        sz = np.asarray(sz, np.int64)
        primary = kb if is_back else kf
        both = self.rank6(np.concatenate([primary, primary + sz]))
        tk, tl = both[: primary.size], both[primary.size:]
        osz = tl - tk
        out_primary = self.cnt[:6] + tk
        o0 = kf if is_back else kb
        o4 = o0 + osz[:, 0]
        o3 = o4 + osz[:, 4]
        o2 = o3 + osz[:, 3]
        o1 = o2 + osz[:, 2]
        o5 = o1 + osz[:, 1]
        other = np.stack([o0, o1, o2, o3, o4, o5], axis=-1)
        if is_back:
            return out_primary, other, osz
        return other, out_primary, osz

    def backward_search(self, patterns) -> list[tuple[int, int]]:
        """(start, size) SA interval per nt6 pattern (exact.c:7-23)."""
        out = []
        for p in patterns:
            lo, sz = 0, self.total
            for c in np.asarray(p)[::-1].tolist():
                r = self.rank6(np.array([lo, lo + sz]))
                lo = int(self.cnt[c] + r[0, c])
                sz = int(r[1, c] - r[0, c])
                if sz == 0:
                    break
            out.append((lo, sz))
        return out

    def retrieve(self, ranks, return_ranks: bool = False):
        """The sequences whose sentinels have these ranks, by LF walks
        (exact.c:59-70) batched across lanes a step at a time.  With
        return_ranks, also the sentinel rank each walk ended on
        (fm_retrieve's return)."""
        ranks = np.asarray(ranks, np.int64)
        k = ranks.copy()
        final = np.zeros(k.size, np.int64)
        alive = np.ones(k.size, bool)
        seqs = [[] for _ in range(k.size)]
        while alive.any():
            idx = np.flatnonzero(alive)
            r = self.rank6(k[idx] + 1)
            prev = self.rank6(k[idx])
            c = np.argmax(r - prev, axis=1)     # BWT[k]: its one-hot
            kp = self.cnt[c] + prev[np.arange(c.size), c]
            stop = c == 0
            for j, ci in zip(idx[~stop].tolist(), c[~stop].tolist()):
                seqs[j].append(ci)
            final[idx[stop]] = kp[stop]          # rank among sentinels
            k[idx[~stop]] = kp[~stop]
            alive[idx[stop]] = False
        out = [np.array(s, np.uint8)[::-1] for s in seqs]
        if return_ranks:
            return out, final
        return out
