"""Kernel K1, the FMD rank count: wrappers for csrc/rank.cu and their
plain PyTorch versions.

The CUDA kernel replaces fermi_tpu/ops/rank_pallas.py `_rank_kernel`; the
plain versions port fermi_tpu/index/fmd.py `_swar_rank_count`.  A wrapper
runs the plain version for tensors on the CPU and launches the kernel for
CUDA tensors; a CUDA tensor the kernel cannot take raises.  The kernel is
built with nvcc into fermi_tpu_torch/build/ at its first launch.

LAUNCHES counts kernel launches per entry point (plain-version calls do
not count), so a run can show that its main path went through the kernel.
"""

import ctypes

import torch

from fermi_tpu_torch import native

NIB1 = 0x11111111  # bit 0 of every nibble
BLOCK = 128

LAUNCHES = {"rank_block_counts": 0, "rank6_fused": 0}


# ---------------------------------------------------------------------------
# plain versions (CPU, and the reference the kernel is held to on the card)
# ---------------------------------------------------------------------------

def _swar_counts(words: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Per-symbol prefix counts within 128-symbol blocks.

    words: int32 [N, 16] nibble-packed symbols; off: int [N] prefix length
    in [0, 128].  Returns int64 [N, 6].

    Trouble spot: the TPU math relies on int32 wraparound in
    (zeros * 0x11111111) >> 28.  Here every step runs in int64 on the
    32-bit pattern and the product is masked to 32 bits before the shift,
    so nothing depends on how torch overflows int32."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    jpos = torch.arange(16, dtype=torch.int64, device=words.device) * 8
    t = (off.to(torch.int64)[:, None] - jpos).clamp(0, 8)
    allowed = torch.where(t >= 8, NIB1,
                          ((1 << (4 * t.clamp(max=7))) - 1) & NIB1)
    outs = []
    for c in range(6):
        x = w ^ (c * NIB1)
        nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & NIB1
        zeros = (nz ^ NIB1) & allowed
        per_word = (((zeros * NIB1) & 0xFFFFFFFF) >> 28) & 15
        outs.append(per_word.sum(-1))
    return torch.stack(outs, -1)


def rank_block_counts_plain(words: torch.Tensor,
                            off: torch.Tensor) -> torch.Tensor:
    """Plain version of k1_rank_block_counts: int32 [N, 8], cols 6-7 zero."""
    out = torch.zeros((words.shape[0], 8), dtype=torch.int32,
                      device=words.device)
    out[:, :6] = _swar_counts(words, off).to(torch.int32)
    return out


def rank6_fused_plain(fused: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version of k1_rank6_fused: [N, 6] in k's dtype."""
    blk = (k.to(torch.int64) >> 7).clamp(0, fused.shape[0] - 1)
    row = fused[blk]
    within = _swar_counts(row[:, :16], k.to(torch.int64) & (BLOCK - 1))
    # Trouble spot: fused occ counts of indexes with 2^31 <= n < 2^32 are
    # negative int32 patterns; reinterpret as unsigned before widening.
    occ = row[:, 16:22].to(torch.int64) & 0xFFFFFFFF
    return (occ + within).to(k.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def get_lib() -> ctypes.CDLL:
    """csrc/rank.cu, built on first use."""
    return native.load(native.rank_job)


def _check(t: torch.Tensor, name: str, dtypes, ndim: int, device,
           vector_rows: bool = False) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if vector_rows and t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def rank_block_counts(words: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Within-block prefix counts for N rank queries (K1, parity entry).

    words: int32 [N, 16] gathered nibble-packed block rows; off: int32 [N]
    prefix lengths in [0, 128].  Returns int32 [N, 8] (cols 6-7 zero)."""
    if words.device.type == "cpu" and off.device.type == "cpu":
        return rank_block_counts_plain(words, off)
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"rank_block_counts: no kernel for device {dev}")
    _check(words, "words", (torch.int32,), 2, dev, vector_rows=True)
    _check(off, "off", (torch.int32,), 1, dev)
    if words.shape[1] != 16 or off.shape[0] != words.shape[0]:
        raise ValueError(f"rank_block_counts: words {tuple(words.shape)} "
                         f"and off {tuple(off.shape)} do not pair")
    n = words.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n:
        lib = get_lib()
        rc = lib.k1_rank_block_counts(
            words.data_ptr(), off.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "k1_rank_block_counts")
        LAUNCHES["rank_block_counts"] += 1
    return out


def rank6_fused(fused: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """rank6 over fused rank rows (K1, the entry FMDIndex.rank6 launches).

    fused: int32 [NB+1, 24] rows (16 packed words, 6 occ patterns, 2 pad);
    k: int32 or int64 [N] positions in [0, n].  Returns [N, 6] counts of
    symbols 0..5 in BWT[0..k-1], in k's dtype."""
    if fused.device.type == "cpu" and k.device.type == "cpu":
        return rank6_fused_plain(fused, k)
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"rank6_fused: no kernel for device {dev}")
    _check(fused, "fused", (torch.int32,), 2, dev, vector_rows=True)
    _check(k, "k", (torch.int32, torch.int64), 1, dev)
    if fused.shape[1] != 24:
        raise ValueError(f"rank6_fused: fused rows {tuple(fused.shape)} "
                         "are not [NB+1, 24]")
    n = k.shape[0]
    out = torch.empty((n, 6), dtype=k.dtype, device=dev)
    if n:
        lib = get_lib()
        rc = lib.k1_rank6_fused(
            fused.data_ptr(), fused.shape[0], k.data_ptr(), out.data_ptr(), n,
            int(k.dtype == torch.int64),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "k1_rank6_fused")
        LAUNCHES["rank6_fused"] += 1
    return out
