"""k-mer error correction: the port of fermi_tpu/algos/correct.py.

Phase 1 (collect) runs on the index's device: the reference's per-suffix DFS
over the (k+1)-mer trie (correct.c:35-87) becomes a level-synchronous
backward BFS, each level one batched extend6 over the whole frontier (kernel
K1 on the card), the frontier kept on the device between levels.  Phase 2
(fix) is the best-first search per read in the port's native/ec.cpp across
threads, fed by the collected solid-k-mer table; FERMI_TPU_DEVICE_FIX=1
sends it to the bounded-beam device fix (search/ecfix_device.py) instead.

On the out-of-core record cache of `-M` (index/blkidx.BlkIndex), collect
runs on the host instead: the native walk of native/smem.cpp over the mapped
records (collect_solid_kmers_native, fermi_tpu's native collect), and the
fix on the host engine.

Output is byte-identical to fermi_tpu's `ec_correct` and reference
`fermi correct`.
"""

import ctypes
import math
import os
import sys
import time

import numpy as np
import torch

from fermi_tpu_torch import native
from fermi_tpu_torch.index.blkidx import BlkIndex
from fermi_tpu_torch.index.fmd import FMDIndex

MAX_KMER = 27

# Counters of the last collect / fix, for measurement (the chip smoke test
# reads them): BFS levels and extend6 calls, the widest frontier, seconds.
STATS = {"levels": 0, "extend_calls": 0, "max_frontier": 0,
         "collect_s": 0.0, "fix_s": 0.0, "reads": 0}


def auto_k(total_symbols: int) -> int:
    w = int(math.log(total_symbols) / math.log(4) + 8.499)
    return min(w, MAX_KMER)


def _extend_batched(index: FMDIndex, kb, kf, sz, batch: int):
    """Backward extend6 over a device frontier, `batch` intervals per call;
    the results stay on the device."""
    n = kb.numel()
    if n <= batch:
        STATS["extend_calls"] += 1
        return index.extend6(kb, kf, sz, is_back=True)
    parts = []
    for lo in range(0, n, batch):
        STATS["extend_calls"] += 1
        parts.append(index.extend6(kb[lo: lo + batch], kf[lo: lo + batch],
                                   sz[lo: lo + batch], is_back=True))
    return tuple(torch.cat(p) for p in zip(*parts))


def collect_solid_kmers(index: FMDIndex, w: int, min_occ: int,
                        batch: int = 1 << 22):
    """Enumerate solid (k+1)-mers: for every w-mer with a dominant preceding
    base of >= min_occ occurrences, compute the packed key/value of reference
    ec_collect (correct.c:56-75).

    Returns (cls, key, val, (n_total, n_informative)): numpy arrays —
    suffix class id int64, uint32 key (prefix<<2 | best_base), uint8 value
    (ratio<<3 | min(rest,7)).

    uint32 keys and classes are held in int64 (torch has no uint32
    arithmetic); they fit in 32 bits and become uint32 on the way out."""
    t0 = time.perf_counter()
    STATS.update(levels=0, extend_calls=0, max_frontier=0)
    suf_len = w - 15 if w > 15 else 1
    dev = index.device
    four = torch.arange(4, dtype=torch.int64, device=dev)

    # phase 1: enumerate depth-suf_len suffix intervals with their class ids
    kb = torch.zeros(1, dtype=index.idtype, device=dev)
    kf = torch.zeros_like(kb)
    sz = torch.full_like(kb, index.total)
    cls = torch.zeros(1, dtype=torch.int64, device=dev)
    for d in range(suf_len):
        KB, KF, SZ = _extend_batched(index, kb, kf, sz, batch)
        # children c = 1..4, class bit (c-1) << 2d
        kb = KB[:, 1:5].reshape(-1)
        kf = KF[:, 1:5].reshape(-1)
        csz = SZ[:, 1:5].reshape(-1)
        ccls = (cls[:, None] | (four << (2 * d))).reshape(-1)
        keep = csz > 0
        kb, kf, sz, cls = kb[keep], kf[keep], csz[keep], ccls[keep]
        STATS["levels"] += 1
        STATS["max_frontier"] = max(STATS["max_frontier"], kb.numel())

    # phase 2: descend to depth w keeping counts >= min_occ
    key = torch.zeros(kb.numel(), dtype=torch.int64, device=dev)
    for d in range(suf_len, w):
        KB, KF, SZ = _extend_batched(index, kb, kf, sz, batch)
        kb = KB[:, 1:5].reshape(-1)
        kf = KF[:, 1:5].reshape(-1)
        csz = SZ[:, 1:5].reshape(-1)
        ccls = cls.repeat_interleave(4)
        ckey = (key[:, None] | (four << (2 * (d - suf_len)))).reshape(-1)
        keep = csz >= min_occ
        kb, kf, sz, cls, key = (kb[keep], kf[keep], csz[keep], ccls[keep],
                                ckey[keep])
        STATS["levels"] += 1
        STATS["max_frontier"] = max(STATS["max_frontier"], kb.numel())

    # final extension: pick dominant preceding base, compute value
    _, _, SZ = _extend_batched(index, kb, kf, sz, batch)
    STATS["levels"] += 1
    SZ = SZ.to(torch.int64)
    ext = SZ[:, 1:5]                            # counts of A,C,G,T prepends
    max_c = torch.argmax(ext, 1)                # first max = smallest c (ref ties)
    mx = ext.gather(1, max_c[:, None])[:, 0]
    keep = mx >= min_occ
    sz, cls, key, max_c, mx, SZ = (sz[keep].to(torch.int64), cls[keep],
                                   key[keep], max_c[keep], mx[keep], SZ[keep])
    rest = sz - mx - SZ[:, 0] - SZ[:, 5]
    # the ratio is rounded in float64, as numpy does in fermi_tpu
    mxf = mx.to(torch.float64)
    r = torch.where(rest == 0, mxf, mxf / rest.clamp_min(1).to(torch.float64))
    r = r.clamp_max(31.0)
    n_info = int(((rest <= 7) & (r >= min_occ)).sum())
    val = ((r + 0.499).to(torch.int64) << 3 | rest.clamp_max(7)).to(torch.uint8)
    out_key = key << 2 | max_c
    STATS["collect_s"] = time.perf_counter() - t0
    return (cls.cpu().numpy(), out_key.cpu().numpy().astype(np.uint32),
            val.cpu().numpy(), (int(val.numel()), n_info))


def collect_solid_kmers_native(index, w: int, min_occ: int,
                               n_threads: int | None = None):
    """collect_solid_kmers on the host (native/smem.cpp fec_collect, or
    fec_collect_blk over the mapped record cache when `index` is a
    BlkIndex): the same (cls, key, val) set, in another order, and the same
    counts; suffix classes are walked in parallel."""
    from fermi_tpu_torch.search.smem import _native_index_arrays

    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    lib = native.get_smem_lib()
    counts = np.zeros(3, np.int64)
    if isinstance(index, BlkIndex):
        ptr = lib.fec_collect_blk(index.path.encode(), w, min_occ, n_threads,
                                  counts.ctypes.data)
    else:
        blocks, occ, cnt, n_seqs = _native_index_arrays(index)
        ptr = lib.fec_collect(blocks.ctypes.data, occ.ctypes.data,
                              blocks.shape[0], cnt.ctypes.data, n_seqs, w,
                              min_occ, n_threads, counts.ctypes.data)
    if not ptr:
        if counts[0] == -1:
            raise OSError(f"fec_collect_blk: cannot map {index.path}")
        raise MemoryError("fec_collect: out of memory")
    n = int(counts[0])
    try:
        flat = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int64)),
            shape=(3 * n + 1,))[: 3 * n].reshape(n, 3).copy()
    finally:
        lib.fsmem_free(ptr)
    return (flat[:, 0].copy(), flat[:, 1].astype(np.uint32),
            flat[:, 2].astype(np.uint8), (int(counts[1]), int(counts[2])))


class SolidTable:
    """Host handle over the native per-class hash tables (native/ec.cpp)."""

    def __init__(self, w: int, cls, key, val):
        suf_len = w - 15 if w > 15 else 1
        suf_num = 1 << (2 * suf_len)
        order = np.argsort(cls, kind="stable")
        cls_s = cls[order]
        self._keys = np.ascontiguousarray(key[order], dtype=np.uint32)
        self._vals = np.ascontiguousarray(val[order], dtype=np.uint8)
        self._offsets = np.zeros(suf_num + 1, np.int64)
        counts = np.bincount(cls_s, minlength=suf_num)
        np.cumsum(counts, out=self._offsets[1:])
        lib = native.get_ec_lib()
        self._lib = lib
        self._ctx = lib.fec_create(w, suf_len, self._keys.ctypes.data,
                                   self._vals.ctypes.data,
                                   self._offsets.ctypes.data)

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.fec_destroy(self._ctx)
            self._ctx = None


class _EcOpt(ctypes.Structure):
    _fields_ = [("w", ctypes.c_int), ("min_occ", ctypes.c_int),
                ("keep_bad", ctypes.c_int), ("is_paired", ctypes.c_int),
                ("trim_l", ctypes.c_int), ("step", ctypes.c_int),
                ("max_corr", ctypes.c_float)]


def fix_reads(table: SolidTable, opt, seqs: list[bytes], quals: list[bytes],
              n_threads: int = 8):
    """Correct a batch of reads. Returns (seqs, quals, info, n_query) —
    corrected ASCII sequences (case marks corrections), adjusted quals,
    per-read info word, hash queries made."""
    n = len(seqs)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, seqs), np.int64, n), out=offsets[1:])
    seq_buf = np.frombuffer(b"".join(seqs), np.uint8).copy()
    qual_buf = np.frombuffer(b"".join(quals), np.uint8).copy()
    info = np.zeros(n, np.int32)
    copt = _EcOpt(w=opt["w"], min_occ=opt["min_occ"],
                  keep_bad=int(opt.get("keep_bad", 0)),
                  is_paired=int(opt.get("is_paired", 0)),
                  trim_l=opt.get("trim_l", 0), step=opt.get("step", 5),
                  max_corr=opt.get("max_corr", 0.3))
    n_query = table._lib.fec_fix(table._ctx, ctypes.addressof(copt), n,
                                 seq_buf.ctypes.data, qual_buf.ctypes.data,
                                 offsets.ctypes.data, info.ctypes.data,
                                 n_threads)
    out_seqs = [seq_buf[offsets[i]:offsets[i + 1]].tobytes() for i in range(n)]
    out_quals = [qual_buf[offsets[i]:offsets[i + 1]].tobytes() for i in range(n)]
    return out_seqs, out_quals, info, n_query


def ec_correct(index, fastx_path, out_fp, w: int = -1,
               min_occ: int = 3, keep_bad=False, is_paired=False,
               max_corr=0.3, trim_l=0, step=5, n_threads: int = 8,
               verbose: bool = True):
    """Full `fermi correct` pipeline; writes corrected FASTQ to out_fp
    (byte-identical to fermi_tpu and the reference).  On an FMDIndex,
    collect runs on the index's device; the fix on the host engine, or on
    the index's device with FERMI_TPU_DEVICE_FIX=1 (flagged reads redone
    on the host engine).  On a BlkIndex (`-M`), both run on the host:
    collect by the native walk over the mapped records, the fix on the host
    engine."""
    from fermi_tpu_torch.core import fastx

    if w < 0:
        w = auto_k(index.total)
        if verbose:
            sys.stderr.write(f"[M::ec_correct] set k-mer length to {w}\n")
    on_device = not isinstance(index, BlkIndex)
    if on_device:
        cls, key, val, (n_tot, n_info) = collect_solid_kmers(index, w,
                                                             min_occ)
    else:
        t0 = time.perf_counter()
        cls, key, val, (n_tot, n_info) = collect_solid_kmers_native(
            index, w, min_occ, n_threads)
        STATS["collect_s"] = time.perf_counter() - t0
    if verbose:
        sys.stderr.write(
            f"[M::ec_correct] collected {n_info} informative and "
            f"{n_tot - n_info} ambiguous k-mers\n")
    table = SolidTable(w, cls, key, val)
    opt = dict(w=w, min_occ=min_occ, keep_bad=keep_bad, is_paired=is_paired,
               max_corr=max_corr, trim_l=trim_l, step=step)
    dev_table = None
    if on_device and os.environ.get("FERMI_TPU_DEVICE_FIX", "0") == "1":
        from fermi_tpu_torch.search.ecfix_device import build_device_table
        dev_table = build_device_table(cls, key, val, w, device=index.device)
    STATS.update(fix_s=0.0, reads=0)

    BATCH = 1_000_000
    pending_s, pending_q, base_id = [], [], 0

    def flush():
        nonlocal base_id
        if not pending_s:
            return
        t0 = time.perf_counter()
        if dev_table is not None:
            from fermi_tpu_torch.search.ecfix_device import fix_reads_device
            seqs, quals, info, st = fix_reads_device(
                dev_table, opt, pending_s, pending_q, native_table=table,
                n_threads=n_threads)
            if verbose:
                sys.stderr.write(
                    f"[M::ec_correct] device fix: {st['n']} reads, "
                    f"{st['n_redo']} native redos\n")
        else:
            seqs, quals, info, _ = fix_reads(table, opt, pending_s,
                                             pending_q, n_threads)
        STATS["fix_s"] += time.perf_counter() - t0
        STATS["reads"] += len(pending_s)
        emit(out_fp, seqs, quals, info, base_id, opt)
        base_id += len(pending_s)
        pending_s.clear()
        pending_q.clear()

    paths = [fastx_path] if isinstance(fastx_path, str) else fastx_path
    for path in paths:
        for rec in fastx.read_fastx(path):
            pending_s.append(rec.seq.encode())
            q = rec.qual.encode() if rec.qual else bytes([33 + 15] * len(rec.seq))
            pending_q.append(q)
            if len(pending_s) >= BATCH:
                flush()
    flush()


def emit(out_fp, seqs, quals, info, base_id, opt):
    """Reference output loop (correct.c:401-428): drop bad reads (and their
    mates when paired), rename to @id_qsum_scorediff, optional trim."""
    n = len(seqs)
    bad = (info >> 16 & 1).astype(bool)
    parts = []
    for i in range(n):
        k = base_id + i
        is_bad = bad[i]
        if opt.get("is_paired"):
            mate = i ^ 1
            if 0 <= mate < n and bad[mate]:
                is_bad = True
        if is_bad and not opt.get("keep_bad"):
            continue
        qsum = int(info[i]) & 0xffff
        sdiff = int(info[i]) >> 18
        sep = " " if opt.get("is_paired") else "_"
        name = k >> 1 if opt.get("is_paired") else k
        s, q = seqs[i], quals[i]
        tl = opt.get("trim_l", 0)
        if tl and tl < len(s):
            s, q = s[:tl], q[:tl]
        parts.append(f"@{name}{sep}{qsum}{sep}{sdiff}\n")
        parts.append(s.decode() + "\n+\n" + q.decode() + "\n")
    out_fp.write("".join(parts))
