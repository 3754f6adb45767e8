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

Not ported: `fm_append_streaming`, fermi_tpu's host engine over the
mmapped record cache (ROADMAP queue 1, item 3c); the port's `build -i`
gets the same bytes from `compute_gap_bits` on the device.
"""

import time

import numpy as np
import torch

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


def merge_bwts(bwt0: torch.Tensor, bwt1: torch.Tensor,
               bits: torch.Tensor) -> torch.Tensor:
    """The merged BWT: bwt1's symbols where bits is set, bwt0's elsewhere
    (uint8 tensors on bits' device)."""
    out = torch.empty(bits.numel(), dtype=torch.uint8, device=bits.device)
    out[~bits] = bwt0
    out[bits] = bwt1
    return out


def fm_merge(e0: FMDIndex, bwt0: np.ndarray, e1: FMDIndex, bwt1: np.ndarray,
             batch: int = 1 << 20) -> np.ndarray:
    """Merged BWT of the two indexes (e0's reads first, then e1's)."""
    bits = compute_gap_bits(e0, e1, batch=batch)
    dev = bits.device
    return merge_bwts(torch.from_numpy(np.ascontiguousarray(bwt0)).to(dev),
                      torch.from_numpy(np.ascontiguousarray(bwt1)).to(dev),
                      bits).cpu().numpy()
