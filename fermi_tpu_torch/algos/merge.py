"""FMD-index merging (reference merge.c).

The port of fermi_tpu/algos/merge.py.  The gap bits (for every symbol of
e1, its insertion point into e0) come from walking all of e1's sequences
backwards through both indexes at once: each read is a device lane, each
step one `e1.lf` plus one `e0.rank6` (two launches of kernel K1 on the
card; merge.c:31-66 made batch-parallel).  The bits stay on the device;
lanes are tested for "all finished" once a chunk of steps, where finished
lanes are dropped.  The interleave of the two BWTs (merge.c:100-137) is two
masked writes.

Unlike fermi_tpu (whose walk makes e0's position in e1's integer type and
raises when e0's is wider), the position in e1 stays in e1's index domain
and the position in e0 in e0's, so a wide index merges with a narrow one.

`build -i` appends a text block to an index on disk by one of two routes
with the same bytes: `fm_append_card` restores the old index on the device
and merges there (`compute_gap_bits`, `merge_bwts`); `fm_append_streaming`
never expands the old index (fermi_tpu's host engine over the mmapped
record cache, native/rld_codec.cpp fappend_*).  `append_route` chooses
before anything is allocated on the device: the card route when its
device peak, reckoned from the old .fmd's header, fits the device's free
memory, else the streaming route.
"""

import contextlib
import sys
import time

import numpy as np
import torch

from fermi_tpu_torch import native
from fermi_tpu_torch.index.fmd import FMDIndex

# Counters of the last compute_gap_bits, for measurement (the chip smoke
# test reads them): walk steps, lanes, batch, chunk length, seconds.
STATS = {"steps": 0, "lanes": 0, "batch": 0, "chunk_steps": 0,
         "seconds": 0.0}


def _gap_walk_chunk(e1, e0, k, i, done, steps: int):
    """Advance all lanes by `steps` LF steps.  Returns (k, i, done, pos):
    pos int64 [steps, lanes] holds the merged position k + i + 1 each
    active lane marks at each step, -1 where a lane is inactive.  e1 and
    e0 are FMDIndex objects or anything with their lf / rank6 / cnt (the
    tp-sharded views of dist/sharded.py)."""
    pos = torch.full((steps, k.numel()), -1, dtype=torch.int64,
                     device=k.device)
    for s in range(steps):
        c, kp = e1.lf(k)
        ci = c.long()
        r0 = e0.rank6(i + 1)
        ip = e0.cnt[ci] + r0.gather(1, ci[:, None])[:, 0] - 1
        hit_end = c == 0
        active = ~done & ~hit_end
        k = torch.where(active, kp, k)
        i = torch.where(active, ip, i)
        pos[s] = torch.where(active, k.long() + i.long() + 1, -1)
        done = done | hit_end
    STATS["steps"] += steps
    return k, i, done, pos


def compute_gap_bits(e0: FMDIndex, e1: FMDIndex, batch: int = 1 << 20,
                     chunk_steps: int = 8) -> torch.Tensor:
    """bool [n0 + n1] on e0's device: True where the merged BWT takes its
    symbol from e1.  The bits do not depend on batch or chunk_steps."""
    t0 = time.perf_counter()
    dev = e0.device
    n0, n1 = e0.total, e1.total
    STATS.update(steps=0, lanes=e1.n_seqs, batch=batch,
                 chunk_steps=chunk_steps)
    spare = n0 + n1
    bits = torch.zeros(n0 + n1 + 1, dtype=torch.bool, device=dev)
    for lo in range(0, e1.n_seqs, batch):
        k = torch.arange(lo, min(lo + batch, e1.n_seqs), dtype=e1.idtype,
                         device=dev)
        i = torch.full_like(k, e0.n_seqs - 1, dtype=e0.idtype)
        done = torch.zeros(k.numel(), dtype=torch.bool, device=dev)
        # the first mark (merge.c:42) comes before any step
        bits[k.long() + i.long() + 1] = True
        while True:
            k, i, done, pos = _gap_walk_chunk(e1, e0, k, i, done,
                                              chunk_steps)
            bits[torch.where(pos >= 0, pos, spare)] = True
            live = ~done
            if not bool(live.any()):
                break
            k, i, done = k[live], i[live], done[live]
    STATS["seconds"] = time.perf_counter() - t0
    return bits[: n0 + n1]


MERGE_CHUNK = 1 << 28       # merged symbols interleaved at a time


def merge_bwts(bwt0: torch.Tensor, bwt1: torch.Tensor, bits: torch.Tensor,
               chunk: int = MERGE_CHUNK) -> torch.Tensor:
    """The merged BWT: bwt1's symbols where bits is set, bwt0's elsewhere
    (uint8 tensors on bits' device), `chunk` merged symbols at a time, so
    a masked write's index list is a chunk's, not the whole BWT's."""
    n = bits.numel()
    out = torch.empty(n, dtype=torch.uint8, device=bits.device)
    starts = range(0, n, chunk)
    ones = torch.stack([bits[lo: lo + chunk].sum() for lo in starts]
                       ).tolist() if n else []
    o0 = o1 = 0
    for lo, c1 in zip(starts, ones):
        m = bits[lo: lo + chunk]
        c0 = m.numel() - c1
        part = out[lo: lo + chunk]
        part[m] = bwt1[o1: o1 + c1]
        part[~m] = bwt0[o0: o0 + c0]
        o0, o1 = o0 + c0, o1 + c1
    return out


def _part_timer(device, secs, peak):
    """A context manager factory: `with part(name):` adds the block's
    seconds to secs[name] and, on CUDA, keeps in peak[name] the largest
    device peak (bytes allocated) seen in a block of that name."""
    on_card = device.type == "cuda"

    @contextlib.contextmanager
    def part(name):
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        yield
        if on_card:
            torch.cuda.synchronize(device)
            peak[name] = max(peak.get(name, 0),
                             torch.cuda.max_memory_allocated(device))
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
    return part


# Seconds and device peaks (bytes, on CUDA) by part of the last merge_files
# call, for measurement: the restores, gap walks, interleaves and rebuilds
# of the running index summed over the folds, the host copy with the RLE,
# and the dump.
FILE_STATS = {"seconds": {}, "device_peak": {}}


def merge_files(paths, out: str, device) -> None:
    """`merge`: the .fmd files folded left to right on `device` (each fold
    a gap walk and an interleave), the merged BWT run-length coded on the
    host and written to `out` ("-": standard output)."""
    from fermi_tpu_torch import rld

    secs, peak = {}, {}
    FILE_STATS.update(seconds=secs, device_peak=peak)
    part = _part_timer(device, secs, peak)
    with part("restore"):
        e0 = FMDIndex.restore(paths[0], device)
    bwt = e0.bwt()
    for fn in paths[1:]:
        if e0 is None:
            with part("rebuild"):
                e0 = FMDIndex._from_symbols(bwt)
            bwt = e0.bwt()              # the index's blocks: one copy
        with part("restore"):
            e1 = FMDIndex.restore(fn, device)
        with part("gap_walk"):
            bits = compute_gap_bits(e0, e1)
        with part("merge_bwts"):
            bwt = merge_bwts(bwt, e1.bwt(), bits)
        e0 = e1 = bits = None           # freed before the next rebuild
        sys.stderr.write(f"[M::merge] merged `{fn}'\n")
    with part("rle"):
        runs = rld.Runs.from_bwt(bwt.cpu().numpy())
    del bwt
    with part("dump"):
        rld.write_fmd(runs, out)


def fm_merge(e0: FMDIndex, bwt0: np.ndarray, e1: FMDIndex, bwt1: np.ndarray,
             batch: int = 1 << 20) -> np.ndarray:
    """Merged BWT of the two indexes (e0's reads first, then e1's)."""
    bits = compute_gap_bits(e0, e1, batch=batch)
    dev = bits.device
    return merge_bwts(torch.from_numpy(np.ascontiguousarray(bwt0)).to(dev),
                      torch.from_numpy(np.ascontiguousarray(bwt1)).to(dev),
                      bits).cpu().numpy()


# The route of the last `build -i` (fm_append_card or fm_append_streaming)
# and its seconds and device peaks (bytes, on CUDA) by part, for
# measurement.
APPEND_STATS = {"route": None, "seconds": {}, "device_peak": {}}

# Device bytes of the card route beyond the two indexes' layouts: the gap
# bits and the merged BWT (1 B a merged symbol each), a restore slice's
# temporaries (2.75 B a RESTORE_CHUNK symbol) and a merge_bwts chunk's
# inverted mask and index list (9 B a MERGE_CHUNK symbol).
APPEND_BYTES_PER_MERGED_SYMBOL = 2
RESTORE_SLICE_BYTES_PER_SYMBOL = 2.75
MERGE_CHUNK_BYTES_PER_SYMBOL = 9


def fmd_counts(path: str) -> tuple[int, int]:
    """(symbols, sequences) of an RLD\\2 .fmd from its header alone (the
    encoder's dump, native/rld_codec.cpp: magic, asize << 16 | sbits, two
    words, the frame count, then each symbol's count), no run decoded."""
    with open(path, "rb") as f:
        head = f.read(32)
        if len(head) < 32 or head[:4] != b"RLD\2":
            raise ValueError(f"{path}: not an RLD\\2 index")
        asize = int.from_bytes(head[4:8], "little") >> 16
        counts = np.fromfile(f, np.uint64, asize)
    if counts.size != asize or asize < 1:
        raise ValueError(f"{path}: a truncated RLD\\2 header")
    return int(counts.sum()), int(counts[0])


def index_layout_bytes(n: int) -> int:
    """Device bytes of an n-symbol FMDIndex's arrays as a restore or
    from_bwt lays them out: a row of BLOCK symbols, 16 packed words, 8
    counts in the index's integer type and, below FUSED_MAX, a fused row
    of 24 words, for each of n / BLOCK + 1 rows (fmd._from_blocks)."""
    from fermi_tpu_torch.index import fmd

    row = fmd.BLOCK + 16 * 4 + 8 * fmd._pick_idtype(n).itemsize
    if n < fmd.FUSED_MAX:
        row += 24 * 4
    return ((n + fmd.BLOCK - 1) // fmd.BLOCK + 1) * row


def card_append_bytes(n_old: int, n_new: int) -> int:
    """The card route's reckoned device peak for appending n_new symbols
    to an n_old-symbol index: both indexes' layouts, the gap bits and the
    merged BWT, and the restore's and the interleave's chunk
    temporaries."""
    from fermi_tpu_torch.index import fmd

    return int(index_layout_bytes(n_old) + index_layout_bytes(n_new)
               + APPEND_BYTES_PER_MERGED_SYMBOL * (n_old + n_new)
               + RESTORE_SLICE_BYTES_PER_SYMBOL * fmd._slice_rows()
               * fmd.BLOCK
               + MERGE_CHUNK_BYTES_PER_SYMBOL * MERGE_CHUNK)


def free_bytes(device: torch.device) -> int | None:
    """The device's free memory (torch.cuda.mem_get_info), None off
    CUDA."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def append_route(n_old: int, n_new: int,
                 device) -> tuple[str, int, int | None]:
    """`build -i`'s route for appending n_new symbols to an n_old-symbol
    index on `device`: "card" when the card route's reckoned peak fits
    the free memory (and always off CUDA), else "stream".  Returns the
    route, the reckoned bytes and the free bytes (None off CUDA).  Pure
    arithmetic: nothing is allocated on the device."""
    need = card_append_bytes(n_old, n_new)
    free = free_bytes(torch.device(device))
    return ("card" if free is None or need <= free else "stream"), need, free


def fm_append_card(old_fmd: str, new_text: np.ndarray, out_fmd: str,
                   sbits: int = 3, device=None):
    """`build -i` on the device: the new block's BWT sorted there, the old
    index restored there, the gap bits walked over both and the two BWTs
    interleaved there; the merged BWT run-length coded on the host and
    written to out_fmd ("-": standard output).  Its device peak is about
    card_append_bytes."""
    from fermi_tpu_torch import resolve_device, rld
    from fermi_tpu_torch.construct import blocked

    device = resolve_device(device)
    secs, peak = {}, {}
    APPEND_STATS.update(route="card", seconds=secs, device_peak=peak)
    part = _part_timer(device, secs, peak)
    with part("sort"):
        bwt1 = blocked.device_bwt(new_text, device)
    with part("restore"):
        e0 = FMDIndex.restore(old_fmd, device)
    with part("block_index"):
        e1 = FMDIndex.from_bwt(bwt1, device)
    with part("gap_walk"):
        bits = compute_gap_bits(e0, e1)
    with part("interleave"):
        bwt = merge_bwts(e0.bwt(), e1.bwt(), bits)
    e0 = e1 = bits = None
    with part("rle"):
        runs = rld.Runs.from_bwt(bwt.cpu().numpy())
    del bwt
    with part("dump"):
        rld.write_fmd(runs, out_fmd, sbits=sbits)


def fm_append_streaming(old_fmd: str, new_text: np.ndarray, out_fmd: str,
                        n_threads: int = 4, sbits: int = 3, device=None):
    """Append a text block to an index on disk at the reference's fm_append
    memory model (merge.c:139-209, fermi.1:253-261): the old index is never
    expanded in RAM.  Its rank queries go through its mapped .fmd.blk
    record cache (built beside it when missing or stale; file-backed,
    evictable), and its runs are stream-decoded straight into the RLD
    encoder with the new symbols inserted.  The new block's BWT is sorted
    on `device` (default CUDA; "cpu" runs the plain version), then its
    walks run on the host.  Anonymous memory is O(block): the block's BWT,
    its host index and one int64 position per new symbol.  The output's
    bytes equal fm_append_card's."""
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.construct import blocked
    from fermi_tpu_torch.index.blkidx import ensure_blk
    from fermi_tpu_torch.search.smem import _native_index_arrays

    device = resolve_device(device)
    secs, peak = {}, {}
    APPEND_STATS.update(route="stream", seconds=secs, device_peak=peak)
    part = _part_timer(device, secs, peak)
    lib = native.get_lib()
    with part("blk"):
        blk0 = ensure_blk(old_fmd, n_threads=n_threads)
    with part("sort"):
        bwt1 = np.ascontiguousarray(blocked.device_bwt(
            np.ascontiguousarray(new_text, np.uint8), device), np.uint8)
    with part("block_index"):
        blocks, occ, cnt8, n_seqs1 = _native_index_arrays(
            FMDIndex.from_bwt(bwt1, "cpu"))
    n1 = int(bwt1.size)
    pos = np.empty(n1, np.int64)
    with part("gaps"):
        rc = lib.fappend_gaps(blk0.path.encode(), blocks.ctypes.data,
                              occ.ctypes.data, blocks.shape[0],
                              cnt8.ctypes.data, n_seqs1, blk0.n_seqs,
                              pos.ctypes.data, n_threads)
    if rc:
        raise OSError(f"fappend_gaps({old_fmd}) failed rc={rc}")
    with part("sort_positions"):
        lib.fappend_sort(pos.ctypes.data, n1)
    with part("interleave"):
        rc = lib.fappend_interleave(old_fmd.encode(), bwt1.ctypes.data,
                                    pos.ctypes.data, n1, out_fmd.encode(),
                                    sbits)
    if rc:
        raise OSError(f"fappend_interleave({old_fmd}) failed rc={rc}")
