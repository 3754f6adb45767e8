"""Blocked device BWT construction: wsort blocks folded by the gap-bit merge.

The port of fermi_tpu/construct/blocked.py.  The reference scales index
construction by splitting the reads into blocks, building each block's
BWT and merging (run-fermi.pl:108-121: splitfa, build x N, merge); here:

  * each block's multi-string BWT is one wsort (construct/wsort.py) on
    the device, so the block size caps the sort's memory however large
    the text;
  * the blocks are folded left to right with the gap-bit merge
    (algos/merge.py, two K1 launches a walk step), and the accumulated
    index is rebuilt on the device between folds.

Blocks partition the reads in order and a merge puts e1's reads after
e0's, so sentinel order is kept (merge.c:175); the result is byte-identical
to the whole-text sort at any block size.  The merge keeps each index in
its own integer domain, so the accumulated index may pass 2^31 symbols
while its blocks stay int32.
"""

import numpy as np
import torch

from fermi_tpu_torch import resolve_device, spans
from fermi_tpu_torch.algos import merge as mg
from fermi_tpu_torch.construct import wsort
from fermi_tpu_torch.index.fmd import FMDIndex

BLOCK_SYMBOLS = 40 << 20

# Counters of the last build, for measurement (the chip smoke test reads
# them): blocks, seconds sorting and seconds merging (index rebuilds
# included), the sums of its `bwt/block_sort` and `bwt/fold` spans, and
# walk steps of the merges.
STATS = {"blocks": 0, "sort_s": 0.0, "merge_s": 0.0, "merge_steps": 0}


def _block_slices(lens: np.ndarray, block_symbols: int):
    """Partition reads (in order) into blocks of <= block_symbols symbols
    (sentinels included); a single oversized read gets its own block."""
    cum = np.concatenate([[0], np.cumsum(np.asarray(lens, np.int64) + 1)])
    out, s = [], 0
    while s < len(lens):
        e = int(np.searchsorted(cum, cum[s] + block_symbols, "right")) - 1
        e = max(e, s + 1)
        out.append((s, e))
        s = e
    return out


def device_build_bwt(seqs: list[np.ndarray],
                     block_symbols: int = BLOCK_SYMBOLS,
                     device=None) -> np.ndarray:
    """Multi-string BWT of nt6 reads (already strand-expanded, in final
    sentinel order), built on `device` in blocks.  Byte-identical to
    construct.suffix's SA rule over the same text."""
    if not seqs:
        return np.zeros(0, np.uint8)
    lens = np.array([len(s) for s in seqs], np.int64)
    if (lens == 0).any():
        raise ValueError("empty read")
    text = np.zeros(int(lens.sum()) + len(seqs), np.uint8)
    text[np.arange(int(lens.sum())) + np.repeat(np.arange(len(seqs)), lens)] \
        = np.concatenate(seqs)
    return device_build_text(text, block_symbols, device)


def device_build_text(text: np.ndarray, block_symbols: int = BLOCK_SYMBOLS,
                      device=None) -> np.ndarray:
    """device_build_bwt over an already concatenated sentinel-terminated
    text (what `build` hands over)."""
    dev = resolve_device(device)
    text = np.asarray(text, np.uint8)
    STATS.update(blocks=0, sort_s=0.0, merge_s=0.0, merge_steps=0)
    if text.size == 0:
        return np.zeros(0, np.uint8)
    if text[-1] != 0:
        raise ValueError("text must end with a sentinel")
    with spans.span("bwt/upload"):
        t = torch.from_numpy(text).to(dev)
    ends = torch.nonzero(t == 0)[:, 0].cpu().numpy()
    lens = np.diff(ends, prepend=-1) - 1
    max_len = int(lens.max())
    starts = np.concatenate([[0], ends + 1])
    blocks = _block_slices(lens, block_symbols)
    STATS["blocks"] = len(blocks)
    acc = None
    # each block's sort and fold ends in a synchronize, so the one that
    # follows starts with the device idle
    for bi, (lo, hi) in enumerate(blocks):
        with spans.span("bwt/block_sort") as sp:
            bwt = wsort._wsort_text(t[starts[lo]: starts[hi]], max_len)
            _sync(dev)
        STATS["sort_s"] += sp.seconds
        if acc is None:
            acc = bwt
            continue
        with spans.span("bwt/fold") as sp:
            bits = mg.compute_gap_bits(FMDIndex._from_symbols(acc),
                                       FMDIndex._from_symbols(bwt))
            STATS["merge_steps"] += mg.STATS["steps"]
            acc = mg.merge_bwts(acc, bwt, bits)
            del bits
            _sync(dev)
        STATS["merge_s"] += sp.seconds
    with spans.span("bwt/download"):
        return acc.cpu().numpy()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_bwt(text: np.ndarray, device=None) -> np.ndarray:
    """The BWT of a text on `device`: prefix doubling, or this blocked
    builder for texts too long for its packed sort key."""
    from fermi_tpu_torch.construct import suffix_device

    if text.size >= suffix_device.MAX_TEXT:
        return device_build_text(text, device=device)
    return suffix_device.multistring_bwt_device(text, device)
