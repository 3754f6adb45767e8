"""seqsort / seqrank: the rank -> read-id permutation (reference seqsort.c).

The port of fermi_tpu/algos/seqsort.py.  For every forward-strand sequence
id i (even), walk to its sentinel rank k and full-read bi-interval
(search.extend.seqrank_walk, kernel K1 on the card), then record
sorted[k] = i<<2 | contained<<1 | dup, plus the mirrored entry for the
reverse complement.  The walks run batched on the index's device; the
scatter is a host numpy write, in batch order, as in fermi_tpu.

`seqsort_native` is fermi_tpu's host engine (native/seqsort.cpp, the same
walk in striped threads), for the `-M` path's record cache
(index/blkidx.BlkIndex) or the host arrays of an index.
"""

import sys

import numpy as np
import torch

from fermi_tpu_torch import native

from fermi_tpu_torch.index.fmd import FMDIndex
from fermi_tpu_torch.search.extend import seqrank_walk


def seqsort_native(index, n_threads: int = 4,
                   verbose: bool = True) -> np.ndarray:
    """The .rank array by the host engine: over the mapped record cache
    when `index` is a BlkIndex (`-M`), else over the index's host arrays."""
    from fermi_tpu_torch.index.blkidx import BlkIndex
    from fermi_tpu_torch.search.smem import _native_index_arrays

    lib = native.get_seqsort_lib()
    sorted_arr = np.zeros(index.n_seqs, np.uint64)
    if isinstance(index, BlkIndex):
        rc = lib.fseqsort_blk(index.path.encode(), sorted_arr.ctypes.data,
                              n_threads)
    else:
        blocks, occ, cnt, n_seqs = _native_index_arrays(index)
        rc = lib.fseqsort(blocks.ctypes.data, occ.ctypes.data,
                          blocks.shape[0], cnt.ctypes.data, n_seqs,
                          sorted_arr.ctypes.data, n_threads)
    if rc:
        raise OSError(f"seqsort_native failed (rc={rc})")
    if verbose:
        _report(sorted_arr)
    return sorted_arr


def _report(sorted_arr):
    zeros = int((sorted_arr == 0).sum())
    ncont = int(((sorted_arr != 0) & (sorted_arr & 2 != 0)).sum())
    ndup = int(((sorted_arr != 0) & (sorted_arr & 2 == 0)
                & (sorted_arr & 1 != 0)).sum())
    sys.stderr.write(
        f"[M::seqsort] #zeros={zeros}, #contained={ncont}, #duplicates={ndup}\n")


def seqsort(index: FMDIndex, batch: int = 32768,
            verbose: bool = True) -> np.ndarray:
    """The .rank array: uint64 [n_seqs], entry k = id << 2 | flags of the
    sequence whose sentinel has rank k.  Every walk runs to its sentinel,
    whatever the read's length."""
    n_seqs = index.n_seqs
    sorted_arr = np.zeros(n_seqs, np.uint64)
    ids = np.arange(0, n_seqs, 2, dtype=np.int64)
    for lo in range(0, len(ids), batch):
        chunk = ids[lo: lo + batch]
        x = torch.from_numpy(chunk).to(index.device)
        k, kb, kf, sz, contained = (
            a.cpu().numpy().astype(np.int64)
            for a in seqrank_walk(index, x))
        flag = ((contained != 0).astype(np.uint64) << 1) | \
               ((sz > 1) & (k != kb)).astype(np.uint64)
        i64 = chunk.astype(np.uint64)
        sorted_arr[k] = i64 << 2 | flag
        mirror = np.where(kb != kf, kf + (k - kb), k + 1)
        sorted_arr[mirror] = (i64 | 1) << 2 | flag
    if verbose:
        _report(sorted_arr)
    return sorted_arr
