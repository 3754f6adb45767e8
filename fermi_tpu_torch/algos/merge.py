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

`build` chooses the same way (`build_route`): when `build_bytes`, the one-
piece builder's reckoned device peak, does not fit the free memory, the
text is cut into the largest spans that fit (`span_cuts`) and folded by
`build -i`'s routes (`fold_spans`), with fermi_tpu's bytes.
"""

import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

from fermi_tpu_torch import native, spans
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


GAP_BATCH = 1 << 20         # lanes a gap walk advances at a time


def compute_gap_bits(e0: FMDIndex, e1: FMDIndex, batch: int = GAP_BATCH,
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


def _part_timer(device, secs, peak, span_names=None):
    """A context manager factory: `with part(name):` adds the block's
    seconds to secs[name] and, on CUDA, keeps in peak[name] the largest
    device peak (bytes allocated) read at the end of a block of that name.
    The peak counter is never reset here, so that reading is the highest
    since the process or its caller last reset it.  With `span_names`, a
    part is also the recorder's span span_names[name] (spans.py), opened
    before the block and closed after its synchronisation, and secs adds
    the span's seconds."""
    on_card = device.type == "cuda"

    @contextlib.contextmanager
    def part(name):
        if on_card:
            torch.cuda.synchronize(device)
        with (spans.span(span_names[name]) if span_names
              else contextlib.nullcontext()) as sp:
            t0 = time.perf_counter()
            yield
            if on_card:
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
        if on_card:
            peak[name] = max(peak.get(name, 0),
                             torch.cuda.max_memory_allocated(device))
        secs[name] = secs.get(name, 0.0) + (sp.seconds if sp else t1 - t0)
    return part


# Seconds and device peaks (bytes, on CUDA) by part of the last merge_files
# call, for measurement: the restores, gap walks, interleaves and rebuilds
# of the running index summed over the folds, the merged BWT's copy to the
# host, the RLE and the dump; each part's seconds are its span's.
FILE_STATS = {"seconds": {}, "device_peak": {}}

# merge_files' parts and the spans they open: under the root `merge`, the
# RLE's and the writer's as the index build names them, so that their own
# spans (rle/*, dump/*) nest under them.
MERGE_SPANS = {"restore": "merge/restore", "rebuild": "merge/rebuild",
               "gap_walk": "merge/gap_walk",
               "interleave": "merge/interleave",
               "download": "merge/download", "rle": "rle", "dump": "dump"}


def merge_files(paths, out: str, device) -> None:
    """`merge`: the .fmd files folded left to right on `device` (each fold
    a gap walk and an interleave), the merged BWT run-length coded on the
    host and written to `out` ("-": standard output)."""
    from fermi_tpu_torch import rld

    secs, peak = {}, {}
    FILE_STATS.update(seconds=secs, device_peak=peak)
    part = _part_timer(device, secs, peak, MERGE_SPANS)
    with spans.span("merge"):
        with part("restore"):
            e0 = FMDIndex.restore(paths[0], device)
        bwt = e0.bwt()
        for fn in paths[1:]:
            if e0 is None:
                with part("rebuild"):
                    e0 = FMDIndex._from_symbols(bwt)
                bwt = e0.bwt()          # the index's blocks: one copy
            with part("restore"):
                e1 = FMDIndex.restore(fn, device)
            with part("gap_walk"):
                bits = compute_gap_bits(e0, e1)
            with part("interleave"):
                bwt = merge_bwts(bwt, e1.bwt(), bits)
            e0 = e1 = bits = None       # freed before the next rebuild
            sys.stderr.write(f"[M::merge] merged `{fn}'\n")
        with part("download"):
            host = bwt.cpu().numpy()
        del bwt
        with part("rle"):
            runs = rld.Runs.from_bwt(host)
        del host
        with part("dump"):
            rld.write_fmd(runs, out)


def fm_merge(e0: FMDIndex, bwt0: np.ndarray, e1: FMDIndex, bwt1: np.ndarray,
             batch: int = GAP_BATCH) -> np.ndarray:
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


def _slice_temp_bytes(n: int) -> int:
    """A restore or rebuild slice's temporaries for an n-symbol index: a
    RESTORE_CHUNK of rows, or the index's rows when it has fewer."""
    from fermi_tpu_torch.index import fmd

    rows = min(fmd._slice_rows(), (n + fmd.BLOCK - 1) // fmd.BLOCK + 1)
    return int(RESTORE_SLICE_BYTES_PER_SYMBOL * rows * fmd.BLOCK)


def _interleave_temp_bytes(n: int) -> int:
    """An interleave chunk's temporaries for n merged symbols: a
    MERGE_CHUNK, or n when fewer."""
    return MERGE_CHUNK_BYTES_PER_SYMBOL * min(MERGE_CHUNK, n)


def card_append_bytes(n_old: int, n_new: int) -> int:
    """The card route's reckoned device peak for appending n_new symbols
    to an n_old-symbol index: both indexes' layouts, the gap bits and the
    merged BWT, and the restore's and the interleave's chunk
    temporaries (each at most the indexes' own size)."""
    return int(index_layout_bytes(n_old) + index_layout_bytes(n_new)
               + APPEND_BYTES_PER_MERGED_SYMBOL * (n_old + n_new)
               + _slice_temp_bytes(max(n_old, n_new))
               + _interleave_temp_bytes(n_old + n_new))


# Device bytes of `build`'s one-piece builder (construct/blocked.device_bwt)
# for build_bytes.  Prefix doubling (suffix_device.multistring_bwt_device)
# peaks in a round's sort: the text (1 B a symbol), the packed key (8),
# torch.sort's sorted keys and order (8 each), the positions it sorts
# beside the keys (8) and the radix sort's alternate key and value buffers
# (16).
DOUBLING_BYTES_PER_SYMBOL = 49
# A wsort block (wsort._wsort_bwt) peaks in a key pair's sort, or in the
# window built before it: the positions, first sentinels and distances to
# them (int32, 4 each), the padded text (8), the last sort's sorted keys,
# permutation and composed order (8 each), the key (8), and either
# torch.sort's 40 (as above) or the shifted key and a window's old,
# shifted, masked and new words (40).
WSORT_BYTES_PER_SYMBOL = 92
# The radix sort's one-sweep passes also keep per-tile digit counters:
# 256 of 8 B for each tile of at least 4,096 keys.
SORT_COUNTER_BYTES_PER_SYMBOL = 0.5
# A gap walk's lane (compute_gap_bits): the chunk's marked positions and
# their masked copy (136), the lane's state (17) and a step's rank
# temporaries in either index domain (at most 359).
WALK_BYTES_PER_LANE = 512


def doubling_bytes(n: int) -> int:
    """Prefix doubling's reckoned device peak for an n-symbol text."""
    return int((DOUBLING_BYTES_PER_SYMBOL + SORT_COUNTER_BYTES_PER_SYMBOL)
               * n)


def _fold_bytes(n: int, m: int, b: int) -> int:
    """The blocked builder's fold of a b-symbol block's BWT onto an
    m-symbol accumulated one, in an n-symbol text: the text and both BWTs,
    then the larger of the accumulator's index with a rebuild slice, both
    indexes with the block's rebuild slice, both indexes with the gap
    bits and a walk's lanes, and the gap bits, the merged BWT and an
    interleave chunk (blocked.device_build_text)."""
    t = min(n, m + b)
    acc, blk = index_layout_bytes(m), index_layout_bytes(b)
    lanes = min(GAP_BATCH, b // 2)
    return n + t + max(acc + _slice_temp_bytes(m),
                       acc + blk + _slice_temp_bytes(b),
                       acc + blk + t + WALK_BYTES_PER_LANE * lanes,
                       2 * t + _interleave_temp_bytes(t))


def blocked_bytes(n: int, n_seqs: int | None = None) -> int:
    """The blocked builder's reckoned device peak for an n-symbol text of
    n_seqs sequences (at most n / 2): the text with its sentinel mask and
    positions; the text, the accumulated BWT and a block's sort; the last
    fold, and below it the last fold onto an accumulator with fused rows
    (whose layout is the larger)."""
    from fermi_tpu_torch.construct import blocked
    from fermi_tpu_torch.index import fmd

    seqs = n // 2 if n_seqs is None else n_seqs
    b = min(blocked.BLOCK_SYMBOLS, n)
    sort = 2 * n - b + (WSORT_BYTES_PER_SYMBOL
                        + SORT_COUNTER_BYTES_PER_SYMBOL) * b
    folds = [_fold_bytes(n, n - 1, b)]
    if n > fmd.FUSED_MAX:
        folds.append(_fold_bytes(n, fmd.FUSED_MAX - 1, b))
    return int(max(2 * n + 8 * seqs, sort, *folds))


def build_bytes(n: int, n_seqs: int | None = None) -> int:
    """`build`'s reckoned device peak for an n-symbol text of n_seqs
    sequences: that of the builder blocked.device_bwt takes at n."""
    from fermi_tpu_torch.construct import suffix_device

    if n < suffix_device.MAX_TEXT:
        return doubling_bytes(n)
    return blocked_bytes(n, n_seqs)


# Held back from the device's free memory: allocations outside the caching
# allocator (kernel modules loaded at their first launch) and its rounding
# of each array.
DEVICE_RESERVE = 1 << 28


def free_bytes(device: torch.device) -> int | None:
    """The device memory this process can still allocate, None off CUDA:
    the CUDA runtime's free bytes (torch.cuda.mem_get_info) and the caching
    allocator's unused blocks (reserved less allocated), less
    DEVICE_RESERVE."""
    if device.type != "cuda":
        return None
    free = (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    return max(0, int(free) - DEVICE_RESERVE)


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


# `build`'s last route, reckoned device peak and free bytes; in the span
# route the spans' symbols, the first span's seconds and device peaks
# (bytes, on CUDA) by part, and each fold's route, reckoned peak, free
# bytes, symbols, seconds and device peaks by part; for measurement.
BUILD_STATS = {"route": None, "need": 0, "free": None, "spans": [],
               "seconds": {}, "device_peak": {}, "folds": []}


def build_route(n: int, device,
                n_seqs: int | None = None) -> tuple[str, int, int | None]:
    """`build`'s route for an n-symbol text of n_seqs sequences on
    `device`: "card" when build_bytes fits the free memory (and always off
    CUDA), else "spans".  Returns the route, the reckoned bytes and the
    free bytes (None off CUDA).  Pure arithmetic: nothing is allocated on
    the device."""
    need = build_bytes(n, n_seqs)
    free = free_bytes(torch.device(device))
    route = "card" if free is None or need <= free else "spans"
    BUILD_STATS.update(route=route, need=need, free=free, spans=[],
                       seconds={}, device_peak={}, folds=[])
    return route, need, free


def _last_true(lo: int, hi: int, pred) -> int | None:
    """The largest j in [lo, hi) with pred(j), for a pred true up to some
    j and false after it; None when pred(lo) is false or the range is
    empty."""
    if lo >= hi or not pred(lo):
        return None
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if pred(mid):
            lo = mid
        else:
            hi = mid
    return lo


def span_cuts(text: np.ndarray, free: int,
              paired: bool = True) -> list[tuple[int, int]]:
    """The (start, end) symbol offsets of the spans `build` folds a text
    in, left to right, each the largest whose build_bytes fits `free`.  A
    span ends after a sentinel: after every second one when `paired`
    (construct/suffix.build_text's fwd 0 rc 0 layout, so each read keeps
    both strands in one span), after any one otherwise.  build_bytes
    drops at suffix_device.MAX_TEXT (the blocked builder takes over from
    prefix doubling), so spans at least that long are tried first.  A
    span of one read is taken even when it does not fit."""
    from fermi_tpu_torch.construct import suffix_device

    unit = 2 if paired else 1
    ends = (np.flatnonzero(np.asarray(text) == 0) + 1)[unit - 1::unit]
    if ends.size == 0 or ends[-1] != text.size:
        ends = np.append(ends, text.size)
    cuts, lo, i = [], 0, 0
    while i < ends.size:
        def fits(j, lo=lo, i=i):
            return build_bytes(int(ends[j]) - lo, unit * (j - i + 1)) <= free
        wide = int(np.searchsorted(ends, lo + suffix_device.MAX_TEXT))
        j = _last_true(wide, ends.size, fits)
        if j is None:
            j = _last_true(i, min(wide, ends.size), fits)
        j = i if j is None else j
        cuts.append((lo, int(ends[j])))
        lo, i = int(ends[j]), j + 1
    return cuts


def append_fmd(old_fmd: str, text: np.ndarray, out: str, sbits: int = 3,
               device=None, tag: str = "build") -> tuple[str, int, int | None]:
    """`build -i`: the text appended to the index old_fmd and written to
    out ("-": standard output) by the route append_route chooses from the
    old .fmd's header and the free memory, printed on stderr before
    anything is allocated on the device.  Returns append_route's
    figures."""
    n_old, n_seqs = fmd_counts(old_fmd)
    route, need, free = append_route(n_old, text.size, device)
    sys.stderr.write(
        f"[M::{tag}] append {text.size} symbols to {n_old} ({n_seqs} "
        f"sequences) by the {route} route: reckoned device peak {need} "
        f"bytes, free {'-' if free is None else free}\n")
    sys.stdout.flush()                  # the codec writes `-' to fd 1
    append = fm_append_card if route == "card" else fm_append_streaming
    append(old_fmd, text, out, sbits=sbits, device=device)
    return route, need, free


def fold_spans(text: np.ndarray, cuts, out: str, sbits: int = 3,
               device=None, tag: str = "build") -> None:
    """`build` of a text in the spans `cuts` (span_cuts): the first span's
    BWT sorted by blocked.device_bwt and written as a temporary .fmd
    beside `out` (in the temporary directory when out is "-"), each later
    span appended to the index so far by append_fmd (`build -i`'s card or
    streaming route), the last append written to `out`.  The temporaries
    and the .fmd.blk record caches the streaming route builds beside them
    are removed.  The bytes are those of the one-piece build."""
    from fermi_tpu_torch import resolve_device, rld
    from fermi_tpu_torch.construct import blocked

    device = resolve_device(device)
    secs, peak, folds = {}, {}, []
    BUILD_STATS.update(spans=[hi - lo for lo, hi in cuts], seconds=secs,
                       device_peak=peak, folds=folds)
    part = _part_timer(device, secs, peak)
    where = None if out == "-" else os.path.dirname(os.path.abspath(out))
    with tempfile.TemporaryDirectory(prefix=".spans-", dir=where) as tmp:
        acc = out if len(cuts) == 1 else os.path.join(tmp, "0.fmd")
        lo, hi = cuts[0]
        with part("sort"):
            bwt = blocked.device_bwt(text[lo:hi], device)
        with part("rle"):
            runs = rld.Runs.from_bwt(bwt)
        del bwt
        sys.stdout.flush()
        with part("dump"):
            rld.write_fmd(runs, acc, sbits=sbits)
        del runs
        for k, (lo, hi) in enumerate(cuts[1:], 1):
            dst = out if k == len(cuts) - 1 else os.path.join(tmp, f"{k}.fmd")
            t0 = time.perf_counter()
            route, need, free = append_fmd(acc, text[lo:hi], dst, sbits,
                                           device, tag)
            folds.append(dict(route=route, need=need, free=free,
                              symbols=hi - lo,
                              seconds=time.perf_counter() - t0,
                              device_peak=dict(APPEND_STATS["device_peak"])))
            for f in (acc, acc + ".blk"):
                if os.path.exists(f):
                    os.remove(f)
            acc = dst


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
