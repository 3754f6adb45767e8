"""Out-of-core FMD-index handle over a blocked record cache (.fmd.blk).

The port's copy of fermi_tpu/index/blkidx.py.  The reference runs every
command off the mmapped compressed index with `-M` (rld_restore_mmap,
rld.c:327-346; cmd.c:54-69).  The native engines read the interleaved
record layout of native/fmindex.h, so the `-M` form here is a one-time
streaming conversion of the .fmd into a `.fmd.blk` sidecar (fmblk_build,
bounded RSS), byte-equal to fermi_tpu's, which every engine then maps
read-only with MADV_RANDOM: the index may be larger than RAM, and RSS stays
bounded by the pages the walks touch.

`BlkIndex` is a handle (path and header) that the native engines' wrappers
take in place of a resident index: search/smem.smem_all_native,
algos/seqsort.seqsort_native, algos/unitig.fm6_unitig_native,
algos/correct.collect_solid_kmers_native and the remap paircov.  Host code:
nothing of it touches a device.
"""

import os

import numpy as np

from fermi_tpu_torch import native


class BlkIndex:
    """Handle to a .fmd.blk record cache; the engines map it on use."""

    def __init__(self, blk_path: str):
        info = np.zeros(12, np.int64)
        rc = native.get_lib().fmblk_info(blk_path.encode(), info.ctypes.data)
        if rc:
            raise OSError(f"not a .fmd.blk cache: {blk_path} (rc={rc})")
        self.path = blk_path
        self.n_rows = int(info[0])
        self.total = int(info[1])
        self.n_seqs = int(info[2])
        self.wide = bool(info[3])
        self.cnt = info[4:12].copy()


def ensure_blk(fmd_path: str, blk_path: str | None = None,
               n_threads: int | None = None) -> BlkIndex:
    """The .fmd's record cache (default: the .fmd's path + ".blk"), built
    when it is missing or older than the .fmd."""
    blk_path = blk_path or fmd_path + ".blk"
    fresh = (os.path.exists(blk_path)
             and os.path.getmtime(blk_path) >= os.path.getmtime(fmd_path))
    if not fresh:
        t = n_threads or min(os.cpu_count() or 1, 8)
        rc = native.get_lib().fmblk_build(fmd_path.encode(),
                                          blk_path.encode(), t)
        if rc == -7:
            raise OSError(f"{fmd_path}: its runs hold another number of "
                          "symbols than its header (a damaged index)")
        if rc:
            raise OSError(f"fmblk_build({fmd_path}) failed rc={rc}")
    return BlkIndex(blk_path)
