"""The multi-string BWT of reads and their reverse complements, plainly.

fermi indexes each read and its reverse complement, each ended by a
sentinel: fwd0 $ rc0 $ fwd1 $ rc1 $ ...  Every sentinel is a symbol of its
own, below the bases and ordered by its place in the text (fermi
ksa.c:53-54), so a suffix comparison stops at the first sentinel.  An
even-length read equal to its own reverse complement loses its last base
first (fermi cmd.c:458-462), so that the two strands differ.

Symbols are nt6: 0 the sentinel, 1-4 A C G T.
"""

import numpy as np
import torch


def text_of(reads: np.ndarray) -> np.ndarray:
    """The text of reads given as nt4 codes (0-3 for ACGT) [n, L]."""
    reads = np.asarray(reads, np.uint8)
    n, L = reads.shape
    fwd = reads + 1
    rc = (4 - reads[:, ::-1]).astype(np.uint8)
    pal = np.zeros(n, bool)
    if L % 2 == 0:
        pal = (fwd == rc).all(1)
    if not pal.any():
        out = np.zeros((n, 2 * L + 2), np.uint8)
        out[:, :L] = fwd
        out[:, L + 1: 2 * L + 1] = rc
        return out.reshape(-1)
    parts = []
    for f, pl in zip(fwd, pal):
        if pl:
            f = f[:-1]
        parts += [f, [0], (5 - f[::-1]), [0]]
    return np.concatenate(parts).astype(np.uint8)


def bwt_of_text(text: np.ndarray, device, sentinels_ordered=True):
    """The BWT of `text` by prefix doubling (Manber and Myers) on `device`,
    as a uint8 tensor there.

    With `sentinels_ordered` False every sentinel is the same symbol and
    suffix comparisons run on past it into the next read: the order a
    generic suffix sort of the concatenated text gives.  That breaks
    fermi's guarantee, and is the benchmark's control."""
    t = torch.from_numpy(np.ascontiguousarray(text, np.uint8)).to(device)
    n = t.numel()
    if n == 0:
        return t
    i64 = torch.int64
    if sentinels_ordered:
        sent = t == 0
        n_sent = int(sent.sum())
        rank = torch.where(sent, torch.cumsum(sent, 0, dtype=i64) - 1,
                           n_sent - 1 + t.to(i64))
        del sent
    else:
        rank = t.to(i64)
    order = torch.arange(n, dtype=i64, device=device)
    h = 1
    while True:
        # the pair (rank of i, rank of i + h), the second 0 past the end
        key = rank << 32
        if h < n:
            key[: n - h] += rank[h:] + 1
        del rank
        key, order = torch.sort(key)
        new = torch.zeros(n, dtype=i64, device=device)
        new[1:] = key[1:] != key[:-1]
        del key
        new = torch.cumsum(new, 0)
        distinct = int(new[-1]) == n - 1
        rank = torch.empty(n, dtype=i64, device=device)
        rank[order] = new
        del new
        if distinct or h >= n:
            break
        h *= 2
    del rank
    prev = order - 1
    bwt = torch.where(order == 0, torch.zeros((), dtype=torch.uint8,
                                              device=device),
                      t[prev.clamp(min=0)])
    return bwt


def counts_of(bwt: torch.Tensor) -> np.ndarray:
    """The RLD header's marginal counts: [total, n of $, A, C, G, T, N]."""
    c = torch.bincount(bwt.to(torch.int64), minlength=6)[:6].cpu().numpy()
    return np.concatenate([[c.sum()], c]).astype(np.int64)
