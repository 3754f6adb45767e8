"""Kernel K2, the Smith-Waterman local-alignment score: the wrapper for
csrc/sw.cu, its plain PyTorch version, and the entry `sw_score_batch`.

The counterpart of fermi_tpu/ops/sw_pallas.py.  Scores are affine-gap local
alignment scores, score only (match 5, mismatch -4, gap open 5, gap extend 2
by default: reference bubble.c:230-233), equal to fermi_tpu's
`sw_score_batch` and `algos.ksw.sw_score` pair for pair.

Pairs travel as ragged batches: the sequences of each side concatenated
(int8) with int64 offsets [B+1].  `sw_plan` puts the offsets on a device,
with the kernel's warp schedule and scratch sizes made from them on the
host (`schedule`) for a CUDA device; the wrapper `sw_scores` takes the
sequences and that plan, runs the plain version for tensors on the CPU and
launches the kernel for CUDA tensors, reading nothing back from the card;
a CUDA tensor the kernel cannot take raises.  The kernel is
built with nvcc into fermi_tpu_torch/build/ at its first launch.

LAUNCHES counts kernel launches (plain-version calls do not count).
"""

import ctypes
from dataclasses import dataclass

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


# the kernel's layout (csrc/sw.cu): query rows a lane holds and warps a
# block holds (kRows and kWarpsPerBlock, which sw_plan checks against the
# built kernel), group sizes, and a warp task's pair slots after its group
# size and flags
ROWS = 8
BLOCK_WARPS = 4
GROUP_SIZES = (4, 8, 16, 32)
TASK_SLOTS = 8
PIPE = 512             # flag on a task's group size: a warp of a block
                       # that runs one long query


def schedule(qoff: np.ndarray, toff: np.ndarray, rows: int = ROWS):
    """K2's warp tasks from host offsets, for a kernel whose lanes hold
    `rows` query rows each.

    A pair takes G lanes, the least power of two from 4 to 32 whose G *
    rows rows hold its query; 32 / G pairs of one G share a warp, which
    runs longest target + G - 1 steps, so pairs of a class go into warps in
    the order of their steps.  A longer query runs in chunks of 32 * rows
    rows on all BLOCK_WARPS warps of one block, as a pipeline: its
    BLOCK_WARPS tasks are flagged PIPE and name the pair in their first
    slot, and each warp runs ceil(chunks / BLOCK_WARPS) * (tlen + 31)
    steps.  Those blocks come first, longest first, then the other warps,
    largest first.  Returns (tasks int32 [T, 1 +
    TASK_SLOTS]: G | flags, then pair ids, -1 where none; carry offsets
    int64 [B], in 8-byte entries, (chunks - 1) * tlen of them for each pair
    of more than one chunk; the carry's total entries)."""
    qlen = np.diff(np.asarray(qoff, np.int64))
    tlen = np.diff(np.asarray(toff, np.int64))
    lanes = np.maximum(-(-qlen // rows), 1)
    G = np.full(qlen.shape, GROUP_SIZES[0], np.int64)
    for g in GROUP_SIZES[1:]:
        G[lanes > g // 2] = g
    wide = GROUP_SIZES[-1]
    chunks = np.where(qlen > wide * rows, -(-qlen // (wide * rows)), 1)
    multi = chunks > 1
    ids = np.flatnonzero(multi)
    pwork = -(-chunks[ids] // BLOCK_WARPS) * (tlen[ids] + wide - 1)
    first = np.argsort(-pwork, kind="stable")
    ids, pwork = ids[first], pwork[first]
    pipe = np.full((ids.size * BLOCK_WARPS, 1 + TASK_SLOTS), -1, np.int32)
    pipe[:, 0] = wide | PIPE
    pipe[:, 1] = np.repeat(ids, BLOCK_WARPS)
    tasks, work = [], []
    steps = tlen + G - 1
    for g in GROUP_SIZES:
        ids = np.flatnonzero((G == g) & ~multi)
        if not ids.size:
            continue
        ids = ids[np.argsort(-steps[ids], kind="stable")]
        per = wide // g
        ids = np.concatenate([ids, np.full(-ids.size % per, -1)])
        slots = ids.reshape(-1, per)
        t = np.full((slots.shape[0], 1 + TASK_SLOTS), -1, np.int32)
        t[:, 0] = g
        t[:, 1: 1 + per] = slots
        tasks.append(t)
        work.append(steps[slots[:, 0]])
    tasks = (np.concatenate(tasks) if tasks
             else np.zeros((0, 1 + TASK_SLOTS), np.int32))
    work = np.concatenate(work) if work else np.zeros(0, np.int64)
    order = np.argsort(-work, kind="stable")
    tasks = np.concatenate([pipe, tasks[order]])
    need = np.where(multi, (chunks - 1) * tlen, 0)
    coff = np.cumsum(need) - need
    return tasks, coff, int(need.sum())


@dataclass(frozen=True)
class SwPlan:
    """The pairs of one batch for `sw_scores`: their offsets into the
    concatenated sequences, on one device, and on a CUDA device K2's
    schedule of them, all made from the same host offsets, so the kernel
    never runs a schedule made for other pairs."""
    qoff: torch.Tensor                  # int64 [B+1]
    toff: torch.Tensor
    qend: int                           # qoff[-1], toff[-1]: where the
    tend: int                           # sequences must reach
    tasks: torch.Tensor | None = None   # `schedule` on CUDA, else None
    coff: torch.Tensor | None = None
    carry: int = 0


def sw_plan(qoff: np.ndarray, toff: np.ndarray, device) -> SwPlan:
    """The pairs with host offsets qoff, toff (int64 [B+1], non-decreasing
    from 0 or more) on `device`; on CUDA with the kernel's schedule,
    uploaded once, so a launch reads nothing back from the card."""
    qoff = np.asarray(qoff, np.int64)
    toff = np.asarray(toff, np.int64)
    if (qoff.ndim != 1 or qoff.shape != toff.shape or not qoff.size
            or min(qoff[0], toff[0]) < 0 or (np.diff(qoff) < 0).any()
            or (np.diff(toff) < 0).any()):
        raise ValueError(f"sw_plan: offsets {qoff.shape} and {toff.shape} "
                         "are not two non-decreasing [B+1] arrays from >= 0")
    dev = torch.device(device)
    plan = dict(qoff=torch.from_numpy(qoff).to(dev),
                toff=torch.from_numpy(toff).to(dev),
                qend=int(qoff[-1]), tend=int(toff[-1]))
    if dev.type == "cuda":
        lib = get_lib()
        if (lib.k2_rows(), lib.k2_block_warps()) != (ROWS, BLOCK_WARPS):
            raise RuntimeError(
                f"csrc/sw.cu holds {lib.k2_rows()} rows a lane and "
                f"{lib.k2_block_warps()} warps a block, sw_cuda says {ROWS} "
                f"and {BLOCK_WARPS}")
        tasks, coff, carry = schedule(qoff, toff)
        plan.update(tasks=torch.from_numpy(tasks).to(dev),
                    coff=torch.from_numpy(coff).to(dev), carry=carry)
    return SwPlan(**plan)


def sw_scores(qcat: torch.Tensor, tcat: torch.Tensor, plan: SwPlan,
              match=5, mismatch=-4, gapo=5, gape=2) -> torch.Tensor:
    """Local-alignment scores of the pairs of `plan` (K2): int32 [B].

    qcat, tcat: int8 concatenated query / target symbols, which the plan's
    offsets index.  CPU tensors run the plain version; CUDA tensors launch
    the kernel with the plan's offsets and schedule.  The launch puts only
    the kernel on the stream and does not synchronise."""
    dev = plan.qoff.device
    if all(x.device.type == "cpu" for x in (qcat, tcat, plan.qoff)):
        return sw_score_batch_plain(qcat, plan.qoff, tcat, plan.toff, match,
                                    mismatch, gapo, gape)
    if dev.type != "cuda" or plan.tasks is None:
        raise ValueError(f"sw_scores: no kernel for a plan on {dev}")
    _check(qcat, "qcat", (torch.int8,), 1, dev)
    _check(tcat, "tcat", (torch.int8,), 1, dev)
    if qcat.numel() < plan.qend or tcat.numel() < plan.tend:
        raise ValueError(f"sw_scores: the plan's offsets reach {plan.qend} "
                         f"and {plan.tend}, the sequences hold "
                         f"{qcat.numel()} and {tcat.numel()}")
    if gapo < 0:
        # carried F equals the closed form of the plain version only when
        # opening a gap costs something (csrc/sw.cu)
        raise ValueError(f"sw_scores: the kernel takes gapo >= 0, not {gapo}")
    n = plan.qoff.numel() - 1
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        lib = get_lib()
        carry = torch.empty((plan.carry, 2), dtype=torch.int32, device=dev)
        rc = lib.k2_sw_score(
            qcat.data_ptr(), plan.qoff.data_ptr(), tcat.data_ptr(),
            plan.toff.data_ptr(), plan.tasks.data_ptr(), plan.tasks.shape[0],
            match, mismatch, gapo, gape,
            carry.data_ptr() if plan.carry else None, plan.coff.data_ptr(),
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
    plan = sw_plan(qoff, toff, dev)
    return sw_scores(torch.from_numpy(qcat).to(dev),
                     torch.from_numpy(tcat).to(dev), plan, match, mismatch,
                     gapo, gape).cpu().numpy()
