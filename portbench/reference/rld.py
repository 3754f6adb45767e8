"""A frozen decoder of fermi's RLD\\2 `.fmd` files (rld.c:47-263), in plain
PyTorch.

The file: "RLD\\2", a 32-bit word (alphabet size << 16 | block bits), 8
zero bytes, the payload's bytes and the frame count (64 bits each), the
count of each symbol (64 bits each), the payload, then the frames.  The
payload is blocks of 2^sbits 64-bit words; each starts with a header of
16-bit (or, with its top bit set, 32-bit) counts and holds runs, each an
Elias-delta code of its length followed by its symbol in
floor(log2(asize)) + 1 bits, written from the top bit of each word down.
Zero bits, or a symbol past the alphabet, end a block.  The last block of
each 2^23-word superblock keeps its last word spare.

Every block decodes apart from the others, so all blocks step at once:
one run of each block per step.  The frames (the sampled rank index) are
not decoded.
"""

import numpy as np
import torch

SUPER_WORDS = 1 << 23
# width of the gamma-coded part of a delta code, by the top four bits of
# a window whose top bit is 0 (rld.c's table)
_GAMMA_WIDTH = [(0x333333335555779B >> (4 * i)) & 0xF for i in range(16)]


def _lsr(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int64 words by s in [0, 64]."""
    s = torch.as_tensor(s, dtype=torch.int64, device=x.device)
    sc = s.clamp(max=63)
    y = (x >> sc) & ((torch.ones_like(sc) << (64 - sc)) - 1)
    return torch.where(s >= 64, torch.zeros_like(y), y)


def read_header(raw: bytes):
    """(asize, sbits, payload words as int64, counts [total, c0..], whole):
    `whole` is False where the file's length is not what its header
    says."""
    if raw[:4] != b"RLD\x02":
        raise ValueError("not an RLD\\2 file")
    a = int.from_bytes(raw[4:8], "little")
    asize, sbits = a >> 16, a & 0xFFFF
    n_bytes = int.from_bytes(raw[16:24], "little")
    n_frames = int.from_bytes(raw[24:32], "little")
    head = 32 + 8 * asize
    counts = np.frombuffer(raw[32:head], "<u8").astype(np.int64)
    words = np.frombuffer(raw[head: head + n_bytes], "<u8").view(np.int64)
    whole = len(raw) == head + n_bytes + 8 * n_frames * (asize + 1)
    return asize, sbits, words, np.concatenate([[counts.sum()], counts]), \
        whole


def decode(raw: bytes, device):
    """(counts from the header [total, c0..c5], the BWT as a uint8 tensor
    on `device`, whether the file's length matches its header)."""
    asize, sbits, words_np, counts, whole = read_header(raw)
    abits = int(np.floor(np.log2(asize))) + 1
    ssize = 1 << sbits
    hdr16 = ((asize + 1) * 16 + 63) // 64
    hdr32 = ((asize + 1) * 32 + 63) // 64
    words = torch.from_numpy(words_np.copy()).to(device)
    n_words = words.numel()
    n_blks = n_words >> sbits
    if n_blks == 0:
        return counts, torch.zeros(0, dtype=torch.uint8, device=device), whole
    i64 = torch.int64
    gamma = torch.tensor(_GAMMA_WIDTH, dtype=i64, device=device)
    shead = torch.arange(n_blks, dtype=i64, device=device) * ssize
    wide = (_lsr(words[shead], 31) & 1) == 1
    p = shead + torch.where(wide, hdr32, hdr16)
    last = ((shead & (SUPER_WORDS - 1)) + ssize) == SUPER_WORDS
    stail = shead + ssize - torch.where(last, 2, 1)
    r = torch.full_like(p, 64)
    active = torch.ones(n_blks, dtype=torch.bool, device=device)
    lens, syms, valid = [], [], []
    while bool(active.any()):
        wp = words[p.clamp(max=n_words - 1)]
        nxt = words[(p + 1).clamp(max=n_words - 1)]
        look = (p != stail) & (r != 64)
        x = (wp << (64 - r)) | torch.where(look, _lsr(nxt, r),
                                           torch.zeros_like(nxt))
        one = _lsr(x, 63) == 1
        w = gamma[_lsr(x, 59) & 15]
        pad = ~one & (w == 11) & (_lsr(x, 58) == 0)
        y = torch.where(one, torch.zeros_like(w), _lsr(x, 64 - w) - 1)
        y = y.clamp(min=0, max=62)
        ln = _lsr(x << w, 64 - y) | (torch.ones_like(y) << y)
        ln = torch.where(one, torch.ones_like(ln), ln)
        w = torch.where(one, torch.ones_like(w), w + y)
        c = _lsr(x << w, 64 - abits)
        w = w + abits
        ok = active & ~pad & (c <= asize) & (p <= stail)
        lens.append(torch.where(ok, ln, torch.zeros_like(ln)))
        syms.append(c.to(torch.uint8))
        valid.append(ok)
        step = r > w
        p = torch.where(ok & ~step, p + 1, p)
        r = torch.where(ok, torch.where(step, r - w, 64 + r - w), r)
        active = ok
    ok = torch.stack(valid, 1).reshape(-1)
    ln = torch.stack(lens, 1).reshape(-1)[ok]
    sy = torch.stack(syms, 1).reshape(-1)[ok]
    del lens, syms, valid
    return counts, torch.repeat_interleave(sy, ln), whole
