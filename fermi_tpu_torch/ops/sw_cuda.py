"""Kernel K2, the Smith-Waterman local-alignment score: the wrapper for
csrc/sw.cu, its plain PyTorch version, and the entry `sw_score_batch`.

The counterpart of fermi_tpu/ops/sw_pallas.py.  Scores are affine-gap local
alignment scores, score only (match 5, mismatch -4, gap open 5, gap extend 2
by default: reference bubble.c:230-233), equal to fermi_tpu's
`sw_score_batch` and `algos.ksw.sw_score` pair for pair.

Pairs travel as ragged batches: the sequences of each side concatenated
(int8) with int64 offsets [B+1].  The wrapper `sw_scores` runs the plain
version for tensors on the CPU and launches the kernel for CUDA tensors; a
CUDA tensor the kernel cannot take raises.  The kernel is built with nvcc
into fermi_tpu_torch/build/ at its first launch.

LAUNCHES counts kernel launches (plain-version calls do not count).
"""

import ctypes

import numpy as np
import torch

from fermi_tpu_torch import native, resolve_device
from fermi_tpu_torch.ops.rank_cuda import _check, _raise_on

NEG = -(10 ** 6)       # sw_pallas.py NEG: "minus infinity" of the prefix max
Q_PAD, T_PAD = -1, -2  # distinct pads: padding never matches (sw_pallas.py:156)

LAUNCHES = {"sw_score_batch": 0}


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack(seqs) -> tuple[np.ndarray, np.ndarray]:
    """A list of nt4 arrays as (concatenated int8, int64 offsets [B+1])."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    cat = (np.concatenate([np.asarray(s, np.int8) for s in seqs])
           if off[-1] else np.zeros(0, np.int8))
    return cat, off


def _padded(cat: torch.Tensor, off: torch.Tensor, lo: int, hi: int,
            fill: int):
    """Pairs lo..hi-1 of one side as int32 [b, max(1, longest)] padded with
    `fill`, and their lengths int64 [b]."""
    lens = off[lo + 1: hi + 1] - off[lo: hi]
    width = max(1, int(lens.max()))
    col = torch.arange(width, device=cat.device)
    inside = col < lens[:, None]
    src = (off[lo: hi, None] + col).clamp(max=max(cat.numel() - 1, 0))
    vals = cat[src].to(torch.int32) if cat.numel() else \
        torch.zeros_like(src, dtype=torch.int32)
    return torch.where(inside, vals, fill), lens


# ---------------------------------------------------------------------------
# plain version (CPU, and the reference the kernel is held to on the card)
# ---------------------------------------------------------------------------

def sw_score_batch_plain(qcat, qoff, tcat, toff, match=5, mismatch=-4,
                         gapo=5, gape=2, chunk: int = 4096) -> torch.Tensor:
    """The row recurrence of sw_pallas.py:73-91 with torch ops, on any
    device: int32 [B].  Pairs go in chunks, each padded to its own longest
    query and target (pads -1 and -2), so one long pair does not widen the
    whole batch."""
    n = qoff.numel() - 1
    out = torch.zeros(n, dtype=torch.int32, device=qcat.device)
    go_e = gapo + gape
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        q, qlen = _padded(qcat, qoff, lo, hi, Q_PAD)
        t, tlen = _padded(tcat, toff, lo, hi, T_PAD)
        b, tm = t.shape
        col = torch.arange(tm, dtype=torch.int32, device=t.device)
        jj = gape * col
        valid_t = col < tlen[:, None]
        H = torch.zeros((b, tm), dtype=torch.int32, device=t.device)
        E = torch.full_like(H, NEG)
        best = torch.zeros_like(H)
        zero_col = torch.zeros((b, 1), dtype=torch.int32, device=t.device)
        neg_col = torch.full_like(zero_col, NEG)
        for i in range(q.shape[1]):
            active = (qlen > i)[:, None]
            s = torch.where(t == q[:, i: i + 1], match, mismatch)
            e2 = torch.maximum(E - gape, H - go_e)
            hm1 = torch.cat([zero_col, H[:, :-1]], 1)
            h_pre = torch.maximum(hm1 + s, e2).clamp_min(0)
            m = torch.cummax(h_pre + jj, 1).values
            f = torch.cat([neg_col, m[:, :-1]], 1) - gapo - jj
            h_new = torch.maximum(h_pre, f).clamp_min(0)
            best = torch.maximum(best, torch.where(valid_t & active, h_new, 0))
            H = torch.where(active, h_new, H)
            E = torch.where(active, e2, E)
        out[lo:hi] = best.amax(1)
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def get_lib() -> ctypes.CDLL:
    """csrc/sw.cu, built on first use."""
    return native.load(native.sw_job)


def sw_scores(qcat: torch.Tensor, qoff: torch.Tensor, tcat: torch.Tensor,
              toff: torch.Tensor, match=5, mismatch=-4, gapo=5,
              gape=2) -> torch.Tensor:
    """Local-alignment scores of B ragged pairs (K2): int32 [B].

    qcat, tcat: int8 concatenated query / target symbols; qoff, toff: int64
    [B+1] offsets.  CPU tensors run the plain version; CUDA tensors launch
    the kernel."""
    tensors = (qcat, qoff, tcat, toff)
    if all(x.device.type == "cpu" for x in tensors):
        return sw_score_batch_plain(qcat, qoff, tcat, toff, match, mismatch,
                                    gapo, gape)
    dev = qoff.device
    if dev.type != "cuda":
        raise ValueError(f"sw_scores: no kernel for device {dev}")
    _check(qcat, "qcat", (torch.int8,), 1, dev)
    _check(tcat, "tcat", (torch.int8,), 1, dev)
    _check(qoff, "qoff", (torch.int64,), 1, dev)
    _check(toff, "toff", (torch.int64,), 1, dev)
    n = qoff.numel() - 1
    if n < 0 or toff.numel() != n + 1:
        raise ValueError(f"sw_scores: offsets {tuple(qoff.shape)} and "
                         f"{tuple(toff.shape)} do not pair")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        lib = get_lib()
        qlen = qoff[1:] - qoff[:-1]
        tlen = toff[1:] - toff[:-1]
        # boundary carry for pairs the warp strip-mines: 4 int32 per row
        need = torch.where(tlen > lib.k2_tile(), 4 * qlen, 0)
        coff = torch.cumsum(need, 0) - need
        carry = torch.empty(int(need.sum()), dtype=torch.int32, device=dev)
        rc = lib.k2_sw_score(
            qcat.data_ptr(), qoff.data_ptr(), tcat.data_ptr(),
            toff.data_ptr(), n, match, mismatch, gapo, gape,
            carry.data_ptr() if carry.numel() else None, coff.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "k2_sw_score")
        LAUNCHES["sw_score_batch"] += 1
    return out


def sw_score_batch(queries, targets, match=5, mismatch=-4, gapo=5, gape=2,
                   device=None) -> np.ndarray:
    """Local-alignment scores for pairs (queries[i], targets[i]) of nt4
    int8 arrays, on `device` (CUDA unless named): numpy int32 [B], equal to
    fermi_tpu's sw_score_batch and algos.ksw.sw_score per pair."""
    dev = resolve_device(device)
    if len(queries) != len(targets):
        raise ValueError(f"{len(queries)} queries and {len(targets)} targets")
    if not queries:
        return np.zeros(0, np.int32)
    (qcat, qoff), (tcat, toff) = pack(queries), pack(targets)
    t = [torch.from_numpy(a).to(dev) for a in (qcat, qoff, tcat, toff)]
    return sw_scores(*t, match, mismatch, gapo, gape).cpu().numpy()
