"""Contrast assembly support (reference cmp.c): select the reads carrying
k-mers absent from the other of two indexes.

The port of fermi_tpu/algos/contrast.py.  The reference's synchronized
dual-index DFS is a level-synchronous dual BFS: one batched extend6 on
each index a level (kernel K1 on the card), the paired frontier kept on
the device and compacted with masks.  Where one side's interval dies, the
other side's subtree is harvested by a backward BFS to the sentinels
(collect_tips).  The result is a set of bits, so it does not depend on the
order of the frontier: the port gathers every level's dead-side intervals
and harvests them in one BFS per side at the end, and marks each level's
sentinel ranges through a difference array and one cumsum.
"""

import time

import numpy as np
import torch

from fermi_tpu_torch.algos.correct import _extend_batched
from fermi_tpu_torch.index.fmd import FMDIndex

SUF_LEN = 4
BATCH = 1 << 22

# Counters of the last fm6_contrast, for measurement (the chip smoke test
# reads them): dual-BFS levels and its widest paired frontier, tip-BFS
# levels and the intervals harvested, seconds of each part.
STATS = {"levels": 0, "max_frontier": 0, "tip_levels": 0, "tip_roots": 0,
         "bfs_s": 0.0, "tips_s": 0.0}


def _descend_all(e: FMDIndex, suf_len: int):
    """Intervals of all 4^suf_len suffixes, indexed like cmp.c descend():
    the base added at step i sits in bits [2i, 2i+2) of the suffix id."""
    dev = e.device
    cnt = e.cnt
    kb = cnt[1:5].clone()
    kf = cnt[[4, 3, 2, 1]]
    sz = cnt[2:6] - cnt[1:5]
    four = torch.arange(4, dtype=torch.int64, device=dev)
    ids = four.clone()
    for i in range(1, suf_len):
        KB, KF, SZ = _extend_batched(e, kb, kf, sz, BATCH)
        kb = KB[:, 1:5].reshape(-1)
        kf = KF[:, 1:5].reshape(-1)
        sz = SZ[:, 1:5].reshape(-1)
        ids = (ids[:, None] | (four << (2 * i))).reshape(-1)
    order = torch.sort(ids, stable=True).indices
    return kb[order], kf[order], sz[order]


def collect_tips_batch(e: FMDIndex, kb, kf, sz, bits: torch.Tensor,
                       batch: int = BATCH) -> None:
    """Set in bits (bool [n_seqs] on e's device) the sentinel ranks of all
    reads reachable by backward extension from the given intervals
    (cmp.c:22-43) through any base, N included; whole frontier at once."""
    # +1 at each sentinel range's start, -1 at its end (a range of reads
    # KB[:, 0] + [0, SZ[:, 0]) lies within [0, n_seqs])
    diff = torch.zeros(bits.numel() + 1, dtype=torch.int32,
                       device=bits.device)
    while kb.numel():
        KB, KF, SZ = _extend_batched(e, kb, kf, sz, batch)
        STATS["tip_levels"] += 1
        b0, hit = KB[:, 0].long(), (SZ[:, 0] > 0).to(torch.int32)
        diff.index_add_(0, b0, hit)
        diff.index_add_(0, b0 + SZ[:, 0].long(), -hit)
        # every non-sentinel child, N (5) included: a read with an N
        # between the tip and its start reaches its sentinel only through
        # it (fermi_tpu follows A-T only, and its selections of such reads
        # lose their pair symmetry)
        kb = KB[:, 1:6].reshape(-1)
        kf = KF[:, 1:6].reshape(-1)
        csz = SZ[:, 1:6].reshape(-1)
        keep = csz > 0
        kb, kf, sz = kb[keep], kf[keep], csz[keep]
    bits |= torch.cumsum(diff[:-1], 0) > 0


def fm6_contrast(e0: FMDIndex, e1: FMDIndex, kmer: int, min_occ: int):
    """(sub0, sub1): numpy bool arrays over sentinel-rank space marking the
    reads that contain a k-mer absent from the other index."""
    t0 = time.perf_counter()
    STATS.update(levels=0, max_frontier=0, tip_levels=0, tip_roots=0)
    sides = []
    for e in (e0, e1):
        kb, kf, sz = _descend_all(e, SUF_LEN)
        sides.append([kb, kf, sz])
    # each side's intervals whose partner on the other side died
    tips = ([], [])

    def harvest():
        """Move the entries with a dead side to the other side's tips and
        keep the entries alive on both."""
        (kb0, kf0, sz0), (kb1, kf1, sz1) = sides
        dead0, dead1 = sz0 == 0, sz1 == 0
        tips[1].append((kb1[dead0], kf1[dead0], sz1[dead0]))
        tips[0].append((kb0[dead1], kf0[dead1], sz0[dead1]))
        both = ~dead0 & ~dead1
        for s in sides:
            s[:] = [a[both] for a in s]

    depth = SUF_LEN
    while True:
        harvest()          # at depth == kmer too: the last level collects
        if not sides[0][0].numel() or depth >= kmer:
            break
        STATS["levels"] += 1
        STATS["max_frontier"] = max(STATS["max_frontier"],
                                    sides[0][0].numel())
        ext = [_extend_batched(e, *s, BATCH) for e, s in zip((e0, e1), sides)]
        c0 = ext[0][2][:, 1:5].reshape(-1)
        c1 = ext[1][2][:, 1:5].reshape(-1)
        keep = (c0 >= min_occ) | (c1 >= min_occ)
        for s, X in zip(sides, ext):
            s[:] = [a[:, 1:5].reshape(-1)[keep] for a in X]
        depth += 1
    t1 = time.perf_counter()
    out = []
    for e, side in zip((e0, e1), tips):
        bits = torch.zeros(e.n_seqs, dtype=torch.bool, device=e.device)
        kb, kf, sz = (torch.cat(a) for a in zip(*side))
        STATS["tip_roots"] += kb.numel()
        collect_tips_batch(e, kb, kf, sz, bits)
        out.append(bits.cpu().numpy())
    STATS["bfs_s"] = t1 - t0
    STATS["tips_s"] = time.perf_counter() - t1
    return out[0], out[1]


def sub_conv(sub: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """Rank-space selection -> read-id space (cmp.c:128-144)."""
    out = np.zeros(len(sub), bool)
    ids = (rank[np.flatnonzero(sub)] >> np.uint64(2)).astype(np.int64)
    out[ids] = True
    # pair symmetry (cmp.c:141-142): both strands of a read or neither
    if not np.array_equal(out[0::2], out[1::2]):
        raise AssertionError("contrast pair asymmetry")
    return out
