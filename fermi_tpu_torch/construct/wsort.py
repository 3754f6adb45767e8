"""Multi-string BWT by one stable multi-key sort over packed windows.

The port of fermi_tpu/construct/wsort.py.  Every suffix of the
sentinel-separated text ends at its read's sentinel, at most Lmax+1
symbols away, so suffix comparison never needs more than Lmax+1 symbols:

  * window j of suffix p packs text[p+10j .. p+10j+9] as 10 x 3-bit
    symbols (big-endian, so integer order is lexicographic order);
  * symbols at or past the suffix's first sentinel are masked to 0, so a
    comparison stops at the sentinel as the reference's distinct
    per-read sentinels make it;
  * suffixes with all windows equal end in a sentinel after the same
    prefix and take text position order, which a stable sort keeps.

torch.sort takes one key, so two windows are packed into one non-negative
int64 (60 bits) and ceil(J/2) stable sorts run from the least significant
key up, each carrying the order of the one before (an LSD sort over keys
instead of digits).  Positions are int32, so a text (a block of the
blocked builder) holds fewer than 2^31 symbols.
"""

import numpy as np
import torch

from fermi_tpu_torch import resolve_device

SYMS_PER_WORD = 10          # 3 bits/symbol, 30 bits per window


def _wsort_bwt(t: torch.Tensor, n_windows: int) -> torch.Tensor:
    """BWT of the sentinel-terminated uint8 text t, on t's device."""
    n = t.numel()
    dev = t.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    # next0[p]: the first sentinel at or after p (a suffix is never keyed
    # past it), a reverse running minimum of the sentinel positions
    sent_pos = torch.where(t == 0, idx, n)
    next0 = torch.flip(torch.cummin(torch.flip(sent_pos, (0,)), 0).values,
                       (0,))
    del sent_pos
    # padded so that every offset of every window has a slice
    txp = torch.zeros(n + n_windows * SYMS_PER_WORD, dtype=torch.int64,
                      device=dev)
    txp[:n] = t
    lim = next0 - idx                     # symbols before the sentinel

    def window(j):
        w = torch.zeros(n, dtype=torch.int64, device=dev)
        for o in range(SYMS_PER_WORD):
            off = j * SYMS_PER_WORD + o
            s = txp[off: off + n]
            w = (w << 3) | torch.where(lim > off, s, 0)
        return w

    order = None
    # LSD over keys: the least significant pair of windows first
    for j in reversed(range(0, n_windows, 2)):
        key = window(j)
        if j + 1 < n_windows:
            key = (key << 30) | window(j + 1)
        if order is not None:
            key = key[order]
        _, o = torch.sort(key, stable=True)
        del key
        order = o if order is None else order[o]
    sa = order
    prev = torch.where(sa == 0, n - 1, sa - 1)
    return t[prev]


def wsort_bwt(text: np.ndarray, max_read_len: int | None = None,
              device=None) -> np.ndarray:
    """Multi-string BWT of a sentinel-terminated nt6 text, byte-identical to
    construct.suffix's SA rule (reference ksa_bwt order), sorted on
    `device`.

    max_read_len bounds the longest read; windows cover max_read_len+1
    symbols so every suffix is keyed through its sentinel."""
    dev = resolve_device(device)
    text = np.asarray(text, np.uint8)
    if text.size == 0:
        return np.zeros(0, np.uint8)
    return _wsort_text(torch.from_numpy(text).to(dev),
                       max_read_len).cpu().numpy()


def _wsort_text(t: torch.Tensor, max_read_len: int | None) -> torch.Tensor:
    """wsort_bwt on a text already on its device."""
    n = t.numel()
    if n >= 2**31:
        raise ValueError(f"text of {n} symbols: wsort's positions are int32")
    if int(t[-1]) != 0:
        raise ValueError("text must end with a sentinel")
    if max_read_len is None:
        max_read_len = _longest_read(t)
    n_windows = max(1, (max_read_len + SYMS_PER_WORD) // SYMS_PER_WORD)
    return _wsort_bwt(t, n_windows)


def _longest_read(t: torch.Tensor) -> int:
    """The longest sentinel-free run of a sentinel-terminated text."""
    sent = torch.nonzero(t == 0)[:, 0]
    gaps = torch.diff(sent, prepend=sent.new_full((1,), -1))
    return int(gaps.max()) - 1
