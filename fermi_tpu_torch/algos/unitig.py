"""Unitig construction on the host (overlap assembly core).

The port's copy of fermi_tpu/algos/unitig.py's Python builder.  Control
flow mirrors reference unitig.c (fm6_get_nei:93-179, unitig_unidir:227-262,
unitig1:274-317), so the MAG graph matches the reference exactly in
single-thread seed order.  Interval-set extensions are batched numpy calls
over the whole set (HostIndex.extend6); a single interval, the walk along
one read, extends in Python ints (HostIndex.extend1), where numpy's call
overhead would be most of the cost.  The port runs it only on the small
indexes of local assemblies (algos/scaf.py `fm6_api_unitig`: scaffolding's
gaps and `example`); a full index's unitigs come from the device link
records (algos/unitig_bulk.py), or, for the out-of-core `-M` path, from the
native host walk (`fm6_unitig_native`, native/unitig.cpp funitig_run_blk,
with the same control flow, threaded as the reference's `-t N`).

Interval representation: python lists [kb, kf, sz, info].
"""

import ctypes

import numpy as np

from fermi_tpu_torch import native
from fermi_tpu_torch.algos.hostindex import HostIndex


def comp6(c):
    return 5 - c if 1 <= c <= 4 else c


class UnitigBuilder:
    def __init__(self, e: HostIndex, min_match: int, sorted_arr=None):
        self.e = e
        self.min_match = min_match
        self.sorted = sorted_arr
        n = e.n_seqs
        self.used = np.zeros(n, bool)
        self.bend = np.zeros(n, bool)
        self.visited = np.zeros(n, bool)
        self._retrieve_cache = None

    def prefetch_retrieves(self):
        """Batch all seed retrieves up front (reads never change, so the
        per-seed LF walks vectorize regardless of seed processing order)."""
        n1 = self.e.n_seqs
        seeds = [i for j in range(0, (n1 >> 2) + 1)
                 for i in range(j << 2 | 1, min((j << 2) + 4, n1), 2)]
        seqs, ks = self.e.retrieve_batch(np.array(seeds, np.int64))
        self._retrieve_cache = {s: (q, int(k))
                                for s, q, k in zip(seeds, seqs, ks)}

    # -- bitmap helpers (reference unitig.c:15-36) -------------------------

    def set_bits(self, intv):
        kb, kf, sz = int(intv[0]), int(intv[1]), int(intv[2])
        if self.sorted is not None:
            self.used[(self.sorted[kb:kb + sz] >> np.uint64(2)).astype(np.int64)] = True
            self.used[(self.sorted[kf:kf + sz] >> np.uint64(2)).astype(np.int64)] = True
        else:
            self.used[kb:kb + sz] = True
            self.used[kf:kf + sz] = True

    # -- batched extension helpers ------------------------------------------

    def _extend_set(self, intvs, is_back):
        """extend6 over a list of intervals -> (KB, KF, SZ) [J,6] arrays."""
        kb = np.fromiter((p[0] for p in intvs), np.int64, len(intvs))
        kf = np.fromiter((p[1] for p in intvs), np.int64, len(intvs))
        sz = np.fromiter((p[2] for p in intvs), np.int64, len(intvs))
        return self.e.extend6(kb, kf, sz, is_back)

    # -- overlap_intv (unitig.c:38-64) --------------------------------------

    def overlap_intv(self, seq, min_match, j, at5, inc_sentinel):
        e = self.e
        out = []
        l = len(seq)
        dlt = 1 if at5 else -1
        end = l if at5 else -1
        c = seq[j]
        ik = list(e.set_intv(c)) + [0]
        depth = 1
        j += dlt
        while j != end:
            c = comp6(seq[j]) if at5 else seq[j]
            KB, KF, SZ = e.extend1(ik[0], ik[1], ik[2], not at5)
            if SZ[c] == 0:
                break
            if depth >= min_match and SZ[0]:
                if inc_sentinel:
                    out.append([KB[0], KF[0], SZ[0], j - dlt])
                else:
                    out.append([ik[0], ik[1], ik[2], j - dlt])
            ik = [KB[c], KF[c], SZ[c], 0]
            j += dlt
            depth += 1
        out.reverse()
        return ik, out

    # -- fm6_is_contained (unitig.c:77-91) -----------------------------------

    def is_contained(self, s):
        assert len(s) > self.min_match
        ik, ovlp = self.overlap_intv(s, self.min_match, len(s) - 1, 0, 0)
        KB, KF, SZ = self.e.extend1(ik[0], ik[1], ik[2], True)
        assert SZ[0]
        ret = -1 if ik[2] != SZ[0] else 0
        ik2 = [KB[0], KF[0], SZ[0], 0]
        KB, KF, SZ = self.e.extend1(ik2[0], ik2[1], ik2[2], False)
        assert SZ[0]
        if ik2[2] != SZ[0]:
            ret = -1
        intv0 = [KB[0], KF[0], SZ[0], 0]
        return ret, intv0, ovlp

    # -- fm6_get_nei (unitig.c:93-179) ----------------------------------------

    def get_nei(self, beg, s, prev):
        """s: python list of nt6 ints (mutated: grows by one base per round).
        prev: interval list (consumed). Returns (rbeg, nei_list)."""
        e = self.e
        ori_l = len(s)
        nei = []
        is_forked = False
        if not prev:
            _, prev = self.overlap_intv(s[beg:], self.min_match,
                                        len(s) - beg - 1, 0, 0)
            if not prev:
                return -1, nei
            for p in prev:
                p[3] += beg
        cat = [0] * len(prev)
        while prev:
            curr = []
            J = len(prev)
            KB, KF, SZ = self._extend_set(prev, is_back=False)  # forward
            # batched backward sentinel test of ok[0] and ok[1..4]: the
            # candidate (c, j) is row c*J + j
            BKB, BKF, BSZ = e.extend6(KB[:, :5].T.ravel(), KF[:, :5].T.ravel(),
                                      SZ[:, :5].T.ravel(), True)
            # Python ints from here on: the loops below read single cells
            KB, KF, SZ = KB.tolist(), KF.tolist(), SZ.tolist()
            BKB, BKF, BSZ = (BKB[:, 0].tolist(), BKF[:, 0].tolist(),
                             BSZ[:, 0].tolist())
            for j in range(J):
                if cat[j] < 0:
                    continue
                p = prev[j]
                ok0_sz = SZ[j][0]
                if ok0_sz and ori_l != len(s):
                    sb = (BKB[j], BKF[j], BSZ[j])
                    if sb[2]:
                        if ok0_sz == p[2] and p[2] == sb[2]:
                            cat0 = cat[j]
                            info = ori_l - (p[3] & 0xffffffff)
                            i = j
                            while i < J and cat[i] == cat0:
                                cat[i] = -1
                                i += 1
                            nei.append([sb[0], sb[1], sb[2], info])
                            continue
                        elif self.used is not None:
                            self.set_bits(sb)
                if cat[j] < 0:
                    continue
                for c in range(1, 5):
                    if SZ[j][c]:
                        if BSZ[c * J + j]:
                            info = (p[3] & 0xFFFFFFF0FFFFFFFF) | c << 32
                            curr.append([KB[j][c], KF[j][c], SZ[j][c], info])
            if curr:
                c = curr[0][3] >> 32 & 0xf
                s.append(comp6(c))
                curr.sort(key=lambda p: p[3])
                last = curr[0][3] >> 32
                cat = [0] * len(curr)
                curr[0][3] &= 0xffffffff
                cat0 = 0
                for j in range(1, len(curr)):
                    if curr[j][3] >> 32 != last:
                        last = curr[j][3] >> 32
                        cat0 = j
                    cat[j] = cat0
                    curr[j][3] = (curr[j][3] & 0xffffffff) | cat0 << 36
                if cat0 != 0:
                    is_forked = True
            prev = curr
        if not nei:
            return -1, nei
        rbeg = ori_l - (nei[0][3] & 0xffffffff)
        if len(nei) == 1 and is_forked:
            # contained-read artifact: re-derive the extension (unitig.c:158-176)
            ok0 = list(self.e.set_intv(0)) + [0]
            for i in range(rbeg, ori_l):
                KB, KF, SZ = e.extend1(ok0[0], ok0[1], ok0[2], False)
                c = comp6(s[i])
                ok0 = [KB[c], KF[c], SZ[c], 0]
            i = ori_l
            while i < len(s):
                KB, KF, SZ = e.extend1(ok0[0], ok0[1], ok0[2], False)
                c0, nhit = -1, 0
                for c in range(1, 5):
                    if SZ[c] and KB[c] <= nei[0][0] and \
                       KB[c] + SZ[c] >= nei[0][0] + nei[0][2]:
                        nhit += 1
                        c0 = c
                if nhit == 0 and SZ[0]:
                    break
                assert nhit == 1
                s[i] = comp6(c0)
                ok0 = [KB[c0], KF[c0], SZ[c0], 0]
                i += 1
            del s[i:]
        if len(nei) > 1:
            del s[ori_l:]
        return rbeg, nei

    # -- check_left (unitig.c:186-225) ----------------------------------------

    def check_left_simple(self, beg, rbeg, s):
        _, prev = self.overlap_intv(s, self.min_match, rbeg, 1, 1)
        for i in range(rbeg - 1, beg - 1, -1):
            if not prev:
                break
            KB, KF, SZ = (a.tolist() for a in
                          self._extend_set(prev, is_back=True))
            curr = []
            c = s[i]
            for j, p in enumerate(prev):
                if SZ[j][0]:
                    self.set_bits((KB[j][0], KF[j][0], SZ[j][0]))
                if SZ[j][0] + SZ[j][c] != p[2]:
                    return -1
                curr.append([KB[j][c], KF[j][c], SZ[j][c], p[3]])
            prev = curr
        return 0

    def check_left(self, beg, rbeg, s, nei):
        assert len(nei) == 1
        if self.check_left_simple(beg, rbeg, s) == 0:
            return 0
        rc = [comp6(c) for c in s[rbeg:][::-1]]
        _, nei2 = self.get_nei(0, rc, [])
        assert len(nei2) >= 1
        return -1 if len(nei2) > 1 else 0

    # -- unitig_unidir (unitig.c:227-262) -------------------------------------

    def unidir(self, s, cov, beg0, k0, end, prev=None):
        """Returns (n_reads, end, is_loop, nei). prev seeds the first get_nei
        (the right-overlap list from is_contained, reference unitig.c:300)."""
        beg, ori_l, n_reads = beg0, len(s), 0
        is_loop = False
        prev = prev or []
        nei = []
        while True:
            rbeg, nei = self.get_nei(beg, s, prev)
            prev = []
            if rbeg < 0:
                break
            if len(nei) > 1:
                self.bend[end] = True
                break
            k = nei[0][0]
            if k == end:
                break
            if self.bend[k] or self.check_left(beg, rbeg, s, nei) < 0:
                self.bend[k] = True
                break
            if k == k0:
                is_loop = True
                break
            if nei[0][1] == end:
                nei = []
                break
            end = nei[0][1]
            self.set_bits(nei[0])
            n_reads += 1
            del cov[len(s):]
            while len(cov) < len(s):
                cov.append(ord('"'))
            for i in range(rbeg, ori_l):
                if cov[i] != ord('~'):
                    cov[i] += 1
            beg, ori_l = rbeg, len(s)
        del s[ori_l:]
        del cov[ori_l:]
        return n_reads, end, is_loop, nei

    # -- unitig1 (unitig.c:274-317) -------------------------------------------

    def unitig1(self, seed):
        """Returns None on skip, else dict(seq, cov, k, nei, nsr)."""
        if self.sorted is not None and self.used[seed]:
            return None
        if self._retrieve_cache is not None and seed in self._retrieve_cache:
            s_arr, k = self._retrieve_cache[seed]
        else:
            s_arr, k = self.e.retrieve(seed)
        s = list(map(int, s_arr))
        seed_len = len(s)
        if len(s) <= self.min_match:
            return None
        if self.sorted is None and self.used[k]:
            return None
        ret, intv0, ovlp = self.is_contained(s)
        self.set_bits(intv0)
        if ret < 0:
            return None
        n_reads = 1
        cov = [ord('"')] * len(s)
        end = [intv0[1], intv0[0]]
        nei_out = [[], []]
        if ovlp:
            nr, end0, is_loop, nei = self.unidir(s, cov, 0, intv0[0], end[0],
                                                 prev=ovlp)
            n_reads += nr
            end[0] = end0
            nei_out[0] = [(p[0], p[3]) for p in nei]
            if is_loop:
                nei_out[1] = [(end[0], nei[0][3])]
                return dict(seq=s, cov=cov, k=end, nei=nei_out, nsr=n_reads)
            # pass the overlap list for the other direction? reference resets
        s = [comp6(c) for c in s[::-1]]
        cov.reverse()
        nr, end1, is_loop, nei = self.unidir(s, cov, len(s) - seed_len,
                                             intv0[1], end[1])
        n_reads += nr
        end[1] = end1
        nei_out[1] = [(p[0], p[3]) for p in nei]
        return dict(seq=s, cov=cov, k=end, nei=nei_out, nsr=n_reads)

    def run(self, out_fp):
        """Seed loop in reference t=1 order (unitig.c:333-357)."""
        if self._retrieve_cache is None:
            self.prefetch_retrieves()
        n1 = self.e.n_seqs
        for j in range(0, (n1 >> 2) + 1):
            for i in range(j << 2 | 1, min((j << 2) + 4, n1), 2):
                z = self.unitig1(i)
                if z is None:
                    continue
                k0, k1 = z["k"]
                if self.visited[k0] or self.visited[k1]:
                    continue
                self.visited[k0] = self.visited[k1] = True
                out_fp.write(mag_v_format(z))


def mag_v_format(z) -> str:
    """MAG record text (reference mag.c:149-174)."""
    if len(z["seq"]) <= 0:
        return ""
    parts = [f"@{z['k'][0]}:{z['k'][1]}\t{z['nsr']}"]
    for j in range(2):
        r = z["nei"][j]
        field = "".join(f"{x},{y & 0xffffffff};" for x, y in r
                        if (x, y) is not None)
        parts.append(field if r else ".")
    head = "\t".join(parts)
    seq = "".join("ACGT"[c - 1] for c in z["seq"])
    cov = "".join(chr(c) for c in z["cov"])
    return f"{head}\n{seq}\n+\n{cov}\n"


def fm6_unitig(e: HostIndex, min_match: int, out_fp, sorted_arr=None):
    """The unitigs of a host index as MAG text, in the reference's t=1
    seed order."""
    UnitigBuilder(e, min_match, sorted_arr).run(out_fp)


def fm6_unitig_native(e, min_match: int, sorted_arr=None,
                      n_threads: int = 1) -> str:
    """The unitigs as MAG text by the native host walk (native/unitig.cpp):
    over the mapped record cache when `e` is a BlkIndex (`-M`), else over
    the host arrays of an FMDIndex (copied once and cached on it).

    n_threads == 1 gives the bytes of the reference's `unitig -t 1`.
    n_threads > 1 follows the reference's `-t N` (unitig.c:378-407): stride
    workers over shared atomic bitmaps, so which unitig claims a read at a
    boundary depends on timing, as in the threaded reference; the output's
    order is deterministic."""
    from fermi_tpu_torch.index.blkidx import BlkIndex
    from fermi_tpu_torch.search.smem import _native_index_arrays

    lib = native.get_unitig_lib()
    srt = None
    if sorted_arr is not None:
        srt = np.ascontiguousarray(sorted_arr, dtype=np.uint64)
        if srt.size != e.n_seqs:
            raise ValueError(f".rank array of {srt.size} entries for "
                             f"{e.n_seqs} sequences")
    out_len = ctypes.c_int64()
    if isinstance(e, BlkIndex):
        ptr = lib.funitig_run_blk(e.path.encode(), min_match,
                                  None if srt is None else srt.ctypes.data,
                                  n_threads, ctypes.byref(out_len))
    else:
        blocks, occ, cnt8, n_seqs = _native_index_arrays(e)
        ptr = lib.funitig_run(blocks.ctypes.data, occ.ctypes.data,
                              blocks.shape[0], cnt8.ctypes.data, n_seqs,
                              min_match,
                              None if srt is None else srt.ctypes.data,
                              n_threads, ctypes.byref(out_len))
    if not ptr:
        if out_len.value < 0:
            raise OSError(f"funitig_run_blk: cannot map {e.path}")
        raise MemoryError("funitig_run: out of memory")
    try:
        return ctypes.string_at(ptr, out_len.value).decode("latin1")
    finally:
        lib.funitig_free(ptr)
