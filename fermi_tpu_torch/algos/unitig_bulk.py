"""Bulk-link unitig: link records on the device, stitched on the host.

The port of fermi_tpu/algos/unitig_bulk.py's device path.  The reference's
fm6_get_nei at a contig tip (unitig.c:93-179) only reads the bases of the
last consumed read, so the neighbor-extension result of every possible tip
is a per-stored-sequence property of the immutable FMD-index.  Assembly
splits into:

  pass 1 -- "links" (search/unitig_links.py, on the index's device): for
    every stored sequence a LINK RECORD from its bases alone: the overlap
    walk + containment bi-interval and the get_nei round loop, recording
    neighbor intervals, fork flags and the used-bit intervals the
    sequential algorithm would set.  Batched extend6 calls, kernel K1.

  pass 2 -- "stitch" (native/unitig.cpp, host): a sequential walk that
    replays unitig1 / unitig_unidir (unitig.c:227-317, 333-357) in the
    reference t=1 seed order over the records.  Output is byte-identical
    to `fermi unitig -t 1`.

fermi_tpu's Python `stitch` and `compute_link_host` are the specifications
of both passes; the port's tests hold these against them.
"""

import ctypes
import sys
import time

import numpy as np

from fermi_tpu_torch import native
from fermi_tpu_torch.search.smem import _native_index_arrays


class Link:
    """Per-stored-sequence link record (all ranks are absolute)."""

    __slots__ = ("ok", "ret", "intv0", "has_ovlp", "nei",
                 "forked", "sbits", "redo")

    def __init__(self):
        self.ok = False        # record valid (len > min_match)
        self.ret = 0           # is_contained verdict (-1 contained)
        self.intv0 = (0, 0, 0)  # sentinel-bounded bi-interval of the seq
        self.has_ovlp = False  # overlap list non-empty
        self.nei = []          # [(kb, kf, sz, ov, ext)] in append order
        self.forked = False    # is_forked at get_nei return
        self.sbits = []        # [(kb, kf, sz)] used-interval side effects
        self.redo = False      # device overflow -> host recompute


def stitch_native(index, store, seqs, own_ks, min_match, sorted_arr=None):
    """C++ stitch (native/unitig.cpp funitig_stitch) over a LinkStore on
    the host arrays of the port's `index` (its blocks, occ widened to
    int64, cnt[8]; copied once and cached on the index, which the native
    SMEM engine shares).  Redo rows and check_left run in the native
    engine.
    Returns (mag_text, n_recover)."""
    lib = native.get_unitig_lib()
    n = int(index.n_seqs)
    flat = np.ascontiguousarray(np.concatenate(seqs) if n else
                                np.zeros(0, np.uint8), np.uint8)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    ks = np.ascontiguousarray(np.asarray(own_ks[:n], np.int64))
    srt = None
    if sorted_arr is not None:
        srt = np.ascontiguousarray(sorted_arr, dtype=np.uint64)
    blocks, occ, cnt8, _ = _native_index_arrays(index)
    # every array below stays referenced until the call returns
    la = [np.ascontiguousarray(a) for a in (
        store.valid.view(np.uint8), store.ret, store.intv0,
        store.has_ovlp.view(np.uint8), *store.nei_buf[:3])]
    nov, nex, nein = (np.ascontiguousarray(a, np.int32) for a in (
        store.nei_buf[3], store.nei_buf[4], store.nein))
    sb = [np.ascontiguousarray(a) for a in store.sb_buf]
    sbn = np.ascontiguousarray(store.sbn, np.int32)
    redo = np.ascontiguousarray(store.redo.view(np.uint8))
    idt64 = int(store.nei_buf[0].dtype == np.int64)
    out_len = ctypes.c_int64()
    n_rec = ctypes.c_int64()
    ptr = lib.funitig_stitch(
        blocks.ctypes.data, occ.ctypes.data, blocks.shape[0],
        cnt8.ctypes.data, n, min_match,
        None if srt is None else srt.ctypes.data, flat.ctypes.data,
        offs.ctypes.data, ks.ctypes.data, *(a.ctypes.data for a in la),
        nov.ctypes.data, nex.ctypes.data, nein.ctypes.data,
        store.nei_buf[0].shape[1], *(a.ctypes.data for a in sb),
        sbn.ctypes.data, store.sb_buf[0].shape[1], redo.ctypes.data, idt64,
        ctypes.byref(out_len), ctypes.byref(n_rec))
    if not ptr:
        raise MemoryError("funitig_stitch: out of memory")
    try:
        text = ctypes.string_at(ptr, out_len.value).decode("latin1")
    finally:
        lib.funitig_free(ptr)
    return text, int(n_rec.value)


def fm6_unitig_device(index, min_match, out_fp, sorted_arr=None,
                      verbose=True):
    """Unitig construction: every stored sequence retrieved on the index's
    device, link records computed there (pass 1), the native stitch on the
    host (pass 2); the MAG text goes to out_fp.  Byte-identical to
    fermi_tpu's `unitig -t 1`.  Seconds by part and counts land in
    search.unitig_links.STATS."""
    from fermi_tpu_torch.search.extend import retrieve_strings
    from fermi_tpu_torch.search.unitig_links import STATS, compute_links_device

    def log(m):
        if verbose:
            sys.stderr.write(f"[unitig_device] {m}\n")

    n = int(index.n_seqs)
    t0 = time.perf_counter()
    seqs, own_ks = retrieve_strings(index, np.arange(n))
    t_retrieve = time.perf_counter() - t0
    log(f"retrieve {n} seqs: {t_retrieve:.1f}s")
    store = compute_links_device(index, seqs, min_match, verbose=verbose,
                                 device=index.device)
    t1 = time.perf_counter()
    log(f"device links: {t1 - t0 - t_retrieve:.1f}s "
        f"(redo {int(store.redo.sum())})")
    text, nrec = stitch_native(index, store, seqs, own_ks, min_match,
                               sorted_arr=sorted_arr)
    STATS.update(retrieve_s=t_retrieve, stitch_s=time.perf_counter() - t1,
                 stitch_recoveries=nrec)
    log(f"native stitch: {STATS['stitch_s']:.1f}s (recoveries {nrec})")
    out_fp.write(text)
