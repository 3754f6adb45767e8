"""Index subsetting (reference sub.c): the sub-index holding only the
selected reads.

The port of fermi_tpu/algos/sub.py.  Every selected read's LF walk runs as a
device lane, one `FMDIndex.lf` a step (kernel K1 on the card), and marks
the positions it visits in a bit array kept on the device; the walks test
"every lane finished" once a chunk of steps, drop finished lanes there, and
the bits come back to the host once.  Filtering the BWT by the bits is a
numpy boolean index on the host, as in fermi_tpu.
"""

import time

import numpy as np
import torch

from fermi_tpu_torch.index.fmd import FMDIndex

# Counters of the last mark_read_positions, for measurement (the chip
# smoke test reads them): walk steps, lanes, seconds.
STATS = {"steps": 0, "lanes": 0, "seconds": 0.0}


def _walk_chunk(e: FMDIndex, k, done, bits, steps: int):
    """Advance LF walks by `steps`, marking visited positions (the
    pre-step k, so a read's sentinel position is marked on the step that
    reads its sentinel) in bits; finished lanes mark the spare last slot."""
    spare = bits.numel() - 1
    for _ in range(steps):
        bits[torch.where(done, spare, k.long())] = True
        c, kp = e.lf(k)
        hit_end = c == 0
        k = torch.where(done | hit_end, k, kp)
        done = done | hit_end
    STATS["steps"] += steps
    return k, done


def mark_read_positions(e: FMDIndex, seq_ids: np.ndarray, n_total: int,
                        batch: int = 1 << 20,
                        chunk_steps: int = 8) -> torch.Tensor:
    """bool [n_total] on e's device, True at every BWT position on a
    selected read's LF cycle (including its sentinel position).  The bits
    do not depend on batch or chunk_steps."""
    t0 = time.perf_counter()
    STATS.update(steps=0, lanes=len(seq_ids))
    bits = torch.zeros(n_total + 1, dtype=torch.bool, device=e.device)
    for lo in range(0, len(seq_ids), batch):
        k = torch.from_numpy(np.asarray(seq_ids[lo: lo + batch], np.int64)
                             ).to(e.device).to(e.idtype)
        done = torch.zeros(k.numel(), dtype=torch.bool, device=e.device)
        while k.numel():
            k, done = _walk_chunk(e, k, done, bits, chunk_steps)
            live = ~done
            if not bool(live.any()):
                break
            k, done = k[live], done[live]
    STATS["seconds"] = time.perf_counter() - t0
    return bits[:n_total]


def fm_sub(e: FMDIndex, bwt: np.ndarray, sub_bits: np.ndarray,
           is_comp: bool = False) -> np.ndarray:
    """Sub-index BWT: keep the positions of reads whose bit is set in
    sub_bits (sequence-id space), the others with is_comp."""
    ids = np.flatnonzero(sub_bits[: e.n_seqs])
    marked = mark_read_positions(e, ids, bwt.size).cpu().numpy()
    return bwt[~marked if is_comp else marked]


def unpack_bitfile(path: str) -> np.ndarray:
    """Read the <n_seqs><bits> binary bit-array format (cmd.c:702-715)."""
    raw = np.fromfile(path, np.uint64)
    n = int(raw[0])
    words = raw[1: 1 + (n + 63) // 64]
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:n]
    return bits.astype(bool)


def pack_bitfile(path_or_fp, bits: np.ndarray) -> None:
    n = len(bits)
    words = np.packbits(bits.astype(np.uint8), bitorder="little")
    pad = (n + 63) // 64 * 8 - len(words)
    data = np.concatenate([words, np.zeros(pad, np.uint8)])
    out = np.concatenate([np.array([n], np.uint64).view(np.uint8), data])
    if hasattr(path_or_fp, "write"):
        path_or_fp.write(out.tobytes())
    else:
        out.tofile(path_or_fp)
