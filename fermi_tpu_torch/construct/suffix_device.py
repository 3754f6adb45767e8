"""Multi-string BWT construction by prefix doubling on the device.

Same algorithm as fermi_tpu's construct/suffix_jax.py: sentinels get unique
initial ranks by position (all below letters), then Manber–Myers doubling
with one stable sort of the whole text per round.  Reads are short, so the
ranks are all distinct after ceil(log2(max_read_len + 2)) rounds and the loop
exits there.

Each round sorts one int64 key, (rank, next-rank + 1) packed as
rank * (max_rank + 2) + next-rank + 1, which fits while n < 2^31.
"""

import numpy as np
import torch

from fermi_tpu_torch import resolve_device

MAX_TEXT = 2**31 - 8


def multistring_bwt_device(text: np.ndarray, device=None) -> np.ndarray:
    """BWT of a 0-terminated multi-sentinel text, computed on `device`."""
    dev = resolve_device(device)
    text = np.asarray(text, dtype=np.uint8)
    n = text.size
    if n == 0:
        return np.zeros(0, np.uint8)
    if n >= MAX_TEXT:
        raise NotImplementedError(
            f"text of {n} symbols: the packed sort key needs n < 2^31; "
            "texts this large wait for the device BCR/blocked constructions "
            "(ROADMAP queue 1, item 10)")
    t = torch.from_numpy(text).to(dev)
    i64 = torch.int64
    is_sent = t == 0
    n_sent = int(is_sent.sum())
    rank = torch.where(is_sent, torch.cumsum(is_sent, 0, dtype=i64) - 1,
                       n_sent - 1 + t.to(i64))
    del is_sent
    # rounds needed = ceil(log2(longest suffix comparison)) <= ceil(log2(n))
    max_iters = max(1, int(np.ceil(np.log2(n))))
    for it in range(max_iters):
        top = int(rank.max())
        if top == n - 1:
            break
        h = 1 << it
        # next-rank + 1 lies in [0, top + 1] (0 past the end of the text)
        key = rank * (top + 2)
        key[: n - h] += rank[h:] + 1
        del rank
        # trouble spot: at ~3e8 symbols a round holds the key, the sorted
        # keys and the order (int64 each); the previous round's arrays are
        # freed before the sort
        sk, order = torch.sort(key, stable=True)
        del key
        changed = torch.zeros(n, dtype=i64, device=dev)
        changed[1:] = sk[1:] != sk[:-1]
        del sk
        new_sorted = torch.cumsum(changed, 0)
        del changed
        rank = torch.empty(n, dtype=i64, device=dev)
        rank[order] = new_sorted
        del order, new_sorted
    sa = torch.empty(n, dtype=i64, device=dev)
    sa[rank] = torch.arange(n, dtype=i64, device=dev)
    del rank
    bwt = torch.where(sa > 0, t[(sa - 1).clamp(min=0)], 0).to(torch.uint8)
    return bwt.cpu().numpy()
