"""Multi-string BWT by BCR on the device (the reference's bcr.c:378-460).

The port of fermi_tpu/construct/bcr_jax.py.  Each cycle inserts one column
of symbols (every read's next symbol from its end) into the growing
partial BWT:

  * insert positions t = C[c] + rank_c(B, pos) are distinct and monotone
    within a class (the partial-BWT entry at a read's position is the
    symbol it inserts next), so reads never need reordering: the state
    of a read is its position;
  * rank is one [6, NB] block count plus a cumsum, and an [m, 128] row
    gather with a masked count inside the block;
  * the dense insert is an indicator scatter, a cumsum and one gather
    (old index = y - #inserts at or before y).

fermi_tpu runs the cycles in one jit; here each cycle is a few tens of
torch ops from a host loop, with no device-to-host sync.  Positions are
int32, so the text must hold fewer than 2^31 - 128 symbols.
"""

import numpy as np
import torch

from fermi_tpu_torch import resolve_device


def _bcr_cycles(rev: torch.Tensor, lens: torch.Tensor, n_alive: np.ndarray,
                N: int) -> torch.Tensor:
    """All BCR cycles; returns the length-N multi-string BWT on rev's
    device.

    rev:     uint8 [Lmax+2, m], rev[j, k] = seqs[k][len_k - j] (row 0
             unused, rows past a read's end 0 = sentinel)
    lens:    int32 [m] read lengths
    n_alive: host int64 [Lmax+2], n_alive[j] = #reads of length >= j
    N:       BWT length, sum(lens) + m
    """
    dev = rev.device
    Lmax, m = rev.shape[0] - 2, rev.shape[1]
    NB = (N + 127) // 128
    NP = NB * 128                          # block-aligned capacity
    i32 = torch.int32
    jN = torch.arange(NP, dtype=i32, device=dev)
    j128 = torch.arange(128, dtype=i32, device=dev)
    # slot NP is a spare that dead reads' inserts land in
    B = torch.zeros(NP + 1, dtype=torch.uint8, device=dev)
    B[:m] = rev[1]            # sentinels in read order, each read's last symbol
    A = torch.zeros(6, dtype=i32, device=dev)
    A[0] = m
    pos = torch.arange(m, dtype=i32, device=dev)
    n = m
    for j in range(1, Lmax + 1):
        alive = lens >= j
        c = rev[j].long()
        v = rev[j + 1]
        # blocked occ of B[:n] (stale bytes past n masked to class 6)
        blocks = torch.where(jN < n, B[:NP], 6).view(NB, 128)
        # occ[c, b]: symbol c in blocks before b (a scan along the
        # innermost dimension; the outer-dimension scan is sequential)
        occ = torch.zeros((6, NB + 1), dtype=i32, device=dev)
        occ[:, 1:] = torch.cumsum(torch.stack(
            [(blocks == cc).sum(1, dtype=i32) for cc in range(6)]), 1,
            dtype=i32)
        # rank_c(B, pos): a row gather and a masked count inside the block
        blk = (pos >> 7).long()
        rows = blocks[blk]                                   # [m, 128]
        within = ((rows == c[:, None].to(torch.uint8))
                  & (j128 < (pos & 127)[:, None])).sum(1, dtype=i32)
        del rows, blocks
        rank = occ[c, blk] + within
        # class offsets after this cycle's inserts (reference set_bwt order)
        A = A.index_add(0, c, alive.to(i32))
        C = torch.cat([A.new_zeros(1), torch.cumsum(A, 0, dtype=i32)[:5]])
        t = torch.where(alive, C[c] + rank, NP)
        # dense insert: B'[t_i] = v_i; everything else moves up by the
        # inserts at or before it (t distinct, so ind is 0/1)
        ind = torch.zeros(NP + 1, dtype=i32, device=dev)
        ind[t] = 1
        ind = ind[:NP]
        src = (jN - torch.cumsum(ind, 0, dtype=i32)).clamp_(0, NP - 1)
        nB = torch.empty_like(B)
        nB[:NP] = torch.where(ind > 0, 0, B.index_select(0, src))
        del ind, src
        nB[t] = v
        B = nB
        pos = torch.where(alive, t, pos)
        n += int(n_alive[j])
    if n != N:
        raise AssertionError(f"BCR inserted {n} symbols, expected {N}")
    return B[:N]


def bcr_bwt_device(seqs: list[np.ndarray], device=None) -> np.ndarray:
    """Multi-string BWT of nt6 reads on `device`; byte-identical to the SA
    rule over build_text(seqs, both_strands=False, trim_palindrome=False)
    and to the reference's ksa/bcr builders."""
    dev = resolve_device(device)
    m = len(seqs)
    if m == 0:
        return np.zeros(0, np.uint8)
    lens = np.array([len(s) for s in seqs], np.int64)
    if (lens == 0).any():
        raise ValueError("empty read")
    Lmax = int(lens.max())
    S = int(lens.sum())
    N = S + m
    if (N + 127) // 128 * 128 >= 2**31:
        raise ValueError(f"{N} symbols: BCR's positions are int32")
    # rev[j, k] = seqs[k][len_k - j], built on the device: symbol p of the
    # concatenation belongs to read r and lands in row j = end_r - p
    F = torch.from_numpy(np.concatenate(seqs).astype(np.uint8)).to(dev)
    lt = torch.from_numpy(lens).to(dev)
    r = torch.repeat_interleave(torch.arange(m, device=dev), lt,
                                output_size=S)
    end = torch.cumsum(lt, 0)                 # one past each read's last
    j = end[r] - torch.arange(S, device=dev)
    rev = torch.zeros((Lmax + 2) * m, dtype=torch.uint8, device=dev)
    rev[j * m + r] = F
    del F, r, j, end
    n_alive = np.cumsum(np.bincount(lens, minlength=Lmax + 2)[::-1])[::-1]
    return _bcr_cycles(rev.view(Lmax + 2, m), lt.to(torch.int32), n_alive,
                       N).cpu().numpy()
