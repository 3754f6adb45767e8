"""remap: contig coverage and paired-end statistics (reference
smem.c:114-394).

The port of fermi_tpu/algos/remap.py.  Contigs are the queries, the read
index the database.  Host code: every contig's SMEMs come from the native
sequential engine (search/smem.smem_all_native_raw over the index's host
arrays, or over the mapped record cache of `-M` when the index is an
index/blkidx.BlkIndex) and feed the native paircov engine (native/remap.cpp), which keeps
the reference's pairing bookkeeping, khash bucket order included (the
UR:Z: lists it emits feed the scaffolder in bucket-scan order).  `paircov`
over `KHash64` is that engine's plain version, which the tests hold it
against.
"""

import sys

import numpy as np

from fermi_tpu_torch import native
from fermi_tpu_torch.algos.pykhash import KHash64
from fermi_tpu_torch.core import dna
from fermi_tpu_torch.search import smem as sm


def paircov(e_n_seqs, sorted_arr, mems, length, skip, max_dist, h: KHash64,
            rec):
    """Reference paircov (smem.c:140-204) for one contig, given its SMEMs:
    the plain version of native/remap.cpp fpaircov_batch."""
    cov = np.zeros(length + 1, np.int32)
    pcv = np.zeros(length + 1, np.int32)
    n_supp = 0
    unpaired = []
    for (start, end, size, closed, kf) in mems:
        if closed and kf < e_n_seqs:
            cov[start:end] += 1
            n_supp += 1
            if skip <= 0 or sorted_arr is None:
                continue
            for l in range(size):
                k = int(sorted_arr[kf + l] >> np.uint64(2))
                if (k & 1) == 0:
                    to_add = 0
                    kk = h.get(k)
                    beg = 0
                    if kk != h.n_buckets:
                        beg = h.vals[kk] >> 32
                        e_ = end
                        if e_ - beg < max_dist:
                            rec[0] += 1
                            rec[1] += e_ - beg
                            rec[2] += (e_ - beg) * (e_ - beg)
                        else:
                            to_add = 1
                    else:
                        to_add = 1
                    if to_add:
                        unpaired.append((k ^ 1, start << 32 | end))
                        continue
                    beg += skip
                    e_ -= skip
                    if beg > e_:
                        beg, e_ = e_, beg
                    if beg < 0:
                        beg = 0
                    if e_ > length:
                        e_ = length
                    pcv[beg:e_] += 1
                    h.delete(kk)
                else:
                    kk, _ = h.put(k ^ 3)
                    h.vals[kk] = start << 32 | end
    for key, val in h.items_in_bucket_order():
        unpaired.append((key ^ 2, val))
    h.clear()
    return (np.minimum(cov[:length], 255).astype(np.uint8),
            np.minimum(pcv[:length], 255).astype(np.uint8), n_supp, unpaired)


def mask_pcv(seq_u8, pcv, skip, min_pcv):
    """Case-mask a contig by paired coverage (smem.c:209-229). seq_u8: nt6
    array; returns ASCII bytes with lowercase = unsupported."""
    l = len(seq_u8)
    UP = np.frombuffer(b"$ACGTN", np.uint8)
    LO = np.frombuffer(b"$acgtn", np.uint8)
    out = np.empty(l, np.uint8)
    sup = pcv >= min_pcv
    idx = np.flatnonzero(sup)
    if idx.size == 0:
        return UP[seq_u8].tobytes()
    beg, end = int(idx[0]), int(idx[-1]) + 1
    for i in range(0, beg):
        out[i] = UP[seq_u8[i]] if beg < skip << 1 else LO[seq_u8[i]]
    for i in range(end, l):
        out[i] = UP[seq_u8[i]] if l - end < skip << 1 else LO[seq_u8[i]]
    mid = np.arange(beg, end)
    out[mid] = np.where(sup[mid], UP[seq_u8[mid]], LO[seq_u8[mid]])
    return out.tobytes()


def remap(index, contigs_path: str, out_fp, sorted_arr=None, skip=50,
          min_pcv=0, max_dist=1000, batch=512):
    """Full `fermi remap`; writes annotated (or, with min_pcv, broken)
    contigs to out_fp and the insert-size line to stderr.  Returns (avg,
    std, cap) for the pipeline."""
    from fermi_tpu_torch.core import fastx

    if sorted_arr is None:
        skip, min_pcv = -1, 0
    pc = _NativePaircov(index, sorted_arr, skip, max_dist)
    try:
        recs = list(fastx.read_fastx(contigs_path))
        for lo in range(0, len(recs), batch):
            chunk = recs[lo: lo + batch]
            seqs = [dna.encode(r.seq) for r in chunk]
            for rec_i, s, (cov, pcv, n_supp, unpaired) in zip(
                    chunk, seqs, pc.run_batch(seqs)):
                cov_q = np.minimum(cov.astype(np.int32) + 33,
                                   126).astype(np.uint8)
                if min_pcv > 0:
                    masked = mask_pcv(s, pcv, skip, min_pcv)
                    _emit_broken(out_fp, rec_i.name, masked, cov_q, n_supp)
                    continue
                hdr = f"@{rec_i.name}"
                if rec_i.comment:
                    c = rec_i.comment
                    neg = c[:1] == "-"
                    j = 1 if neg else 0
                    while j < len(c) and c[j].isdigit():
                        j += 1
                    if j > (1 if neg else 0) and j < len(c) and \
                            c[j].isspace():
                        hdr += f"\t{n_supp}\t{c[j+1:]}"
                if unpaired:
                    hdr += "\tUR:Z:" + "".join(
                        f"{x},{y >> 32},{y & 0xFFFFFFFF};"
                        for x, y in unpaired)
                out_fp.write(hdr + "\n")
                out_fp.write(dna.decode(s) + "\n+\n")
                out_fp.write(cov_q.tobytes().decode("latin1") + "\n")
        rec = pc.stats()
    finally:
        pc.close()
    avg = rec[1] / rec[0] if rec[0] else 0.0
    std = (rec[2] / rec[0] - avg * avg) ** 0.5 if rec[0] else 0.0
    cap = int(avg + std * 2.0 + 1.499)
    sys.stderr.write(f"[M::remap] avg = {avg:.2f} std = {std:.2f} "
                     f"cap = {cap}\n")
    return avg, std, cap


class _NativePaircov:
    """Native SMEMs (raw rows) and paircov through native/remap.cpp; one
    engine per remap call, whose pairing hash persists across batches as
    the reference's does."""

    def __init__(self, index, sorted_arr, skip, max_dist):
        self.lib = native.get_remap_lib()
        self.index = index
        self.n_seqs = index.n_seqs
        self.sorted_arr = (np.ascontiguousarray(sorted_arr, np.uint64)
                           if sorted_arr is not None else None)
        self.hd = self.lib.fpaircov_create(int(skip), int(max_dist))

    def run_batch(self, seqs):
        """(cov, pcv, n_supp, unpaired) per contig of the batch."""
        flat, counts = sm.smem_all_native_raw(self.index, seqs)
        lens = np.array([len(s) for s in seqs], np.int64)
        flat = np.ascontiguousarray(flat, np.int64)
        counts = np.ascontiguousarray(counts, np.int64)
        cov = np.zeros(int(lens.sum()), np.uint8)
        pcv = np.zeros(int(lens.sum()), np.uint8)
        n_supp = np.zeros(len(seqs), np.int64)
        # every full-length member can yield at most one unpaired entry
        # (directly or through the hash drain)
        cap = int(flat[:, 2].sum()) + len(seqs) + 8 if len(flat) else 8
        unp_k = np.zeros(cap, np.int64)
        unp_v = np.zeros(cap, np.int64)
        unp_counts = np.zeros(len(seqs), np.int64)
        sa = self.sorted_arr
        self.lib.fpaircov_batch(
            self.hd, flat.ctypes.data, counts.ctypes.data, lens.ctypes.data,
            len(seqs), None if sa is None else sa.ctypes.data, self.n_seqs,
            cov.ctypes.data, pcv.ctypes.data, n_supp.ctypes.data,
            unp_k.ctypes.data, unp_v.ctypes.data, unp_counts.ctypes.data)
        outs = []
        co = uo = 0
        for t, l in enumerate(lens.tolist()):
            nu = int(unp_counts[t])
            unpaired = list(zip(unp_k[uo: uo + nu].tolist(),
                                unp_v[uo: uo + nu].tolist()))
            outs.append((cov[co: co + l], pcv[co: co + l],
                         int(n_supp[t]), unpaired))
            co += l
            uo += nu
        return outs

    def stats(self):
        rec = np.zeros(3, np.int64)
        self.lib.fpaircov_stats(self.hd, rec.ctypes.data)
        return [int(x) for x in rec]

    def close(self):
        if self.hd is not None:
            self.lib.fpaircov_destroy(self.hd)
            self.hd = None


def _emit_broken(out_fp, name, masked: bytes, cov_q, n_supp):
    """Split a case-masked contig at lowercase stretches (smem.c:255-272)."""
    l = len(masked)
    s = masked.decode("latin1")
    j = 0
    while j < l and not s[j].isupper():
        j += 1
    beg = j
    k = 0
    j = beg + 1
    while j <= l:
        cur_low = s[j].islower() if j < l else False
        prev_up = s[j - 1].isupper() if j >= 1 else False
        if (cur_low or j == l) and prev_up:
            out_fp.write(f"@{name}_{k}\t{j - beg}\t{n_supp}\n")
            out_fp.write(s[beg:j] + "\n+\n")
            out_fp.write(cov_q[beg:j].tobytes().decode("latin1") + "\n")
            k += 1
        if j < l and s[j].isupper() and s[j - 1].islower():
            beg = j
        j += 1
