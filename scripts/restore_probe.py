#!/usr/bin/env python3
"""The port's index restore on the card, alone: FMDIndex.from_runs of
in-memory runs shaped like chip_smoke.py's [huge] index (670,000,000 runs
of 1-12 symbols, about 4.36 Gsym), timed and its device peak taken.

    python3 scripts/restore_probe.py [--runs N] [--against TREE]

- the restore by parts: the slices' cuts on the host, the expansion into
  the blocks, the layout (occ, packed words);
- with --against TREE (another checkout, e.g. the parent commit unpacked
  with `git archive` into the ignored smoke_tree/), that tree's
  FMDIndex.from_runs on the same runs, in turns (other, this, this,
  other), with the arrays of both held equal;
- this tree's restore at RESTORE_CHUNK 2^26, 2^28 and 2^30: the peak
  above the layout, in bytes a slice symbol;
- `chkbwt -r`'s running count over one 2^22-position chunk: a scan along
  the six rows' own dimension against one scan over the rows laid end to
  end.

Prints the card's name and power limit, then one JSON line a measurement.
Needs a CUDA card; the runs take about 6 GB of host memory.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fermi_tpu_torch import rld  # noqa: E402
from fermi_tpu_torch.index import fmd  # noqa: E402


def log(tag, **kv):
    print(json.dumps({"tag": tag, **kv}), flush=True)


def restore(mod, runs, dev):
    """mod.FMDIndex.from_runs(runs) on dev: (index, seconds, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = mod.FMDIndex.from_runs(runs, dev)
    torch.cuda.synchronize()
    return idx, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def layout_bytes(idx):
    return sum(a.numel() * a.element_size() for a in (
        idx.bwt_blocks, idx.occ, idx.bwt_packed, idx.fused) if a is not None)


def digest(idx):
    return [int(idx.bwt_blocks.sum()), idx.occ[-1].tolist(),
            int(idx.bwt_packed.long().sum())]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=670_000_000)
    ap.add_argument("--against", metavar="TREE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("restore_probe: no CUDA device\n")
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(31)
    lens = rng.integers(1, 13, args.runs, dtype=np.int64)
    syms = (np.cumsum(rng.integers(1, 6, args.runs, dtype=np.int8),
                      dtype=np.int64) % 6).astype(np.uint8)
    runs = rld.Runs(lens, syms, np.zeros(7, np.uint64))
    log("data", runs=args.runs, symbols=int(lens.sum()))

    t0 = time.perf_counter()
    fmd._slice_cuts(lens, fmd._slice_rows() * fmd.BLOCK)
    cuts_s = time.perf_counter() - t0
    parts = {}
    layout = fmd.FMDIndex._from_blocks

    def timed_layout(blocks, n):
        torch.cuda.synchronize()
        parts["layout_start"] = time.perf_counter()
        out = layout(blocks, n)
        torch.cuda.synchronize()
        parts["layout_s"] = time.perf_counter() - parts["layout_start"]
        return out
    fmd.FMDIndex._from_blocks = staticmethod(timed_layout)

    other = None
    if args.against:
        spec = importlib.util.spec_from_file_location(
            "against_fmd", os.path.join(args.against, "fermi_tpu_torch",
                                        "index", "fmd.py"))
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
    order = [other, fmd, fmd, other] if other else [fmd, fmd]
    want = None
    for mod in order:
        t_call = time.perf_counter()
        idx, secs, peak = restore(mod, runs, dev)
        got = digest(idx)
        want = want or got
        if got != want:
            raise AssertionError("the two restores' arrays differ")
        rec = dict(tree=args.against if mod is other else "this",
                   seconds=secs, peak_gb=peak / 1e9,
                   layout_gb=layout_bytes(idx) / 1e9)
        if mod is fmd:
            rec.update(cuts_s=cuts_s, layout_s=parts["layout_s"],
                       expand_s=parts["layout_start"] - t_call - cuts_s)
        log("restore", **rec)
        del idx

    for bits in (26, 28, 30):
        fmd.RESTORE_CHUNK = 1 << bits
        idx, secs, peak = restore(fmd, runs, dev)
        over = peak - layout_bytes(idx)
        log("restore_chunk", chunk_bits=bits, seconds=secs,
            transient_gb=over / 1e9,
            transient_bytes_per_slice_symbol=over / fmd.RESTORE_CHUNK)
        del idx

    n = 1 << 22
    bwt = torch.randint(0, 6, (n,), dtype=torch.uint8, device=dev)
    syms6 = torch.arange(6, dtype=torch.uint8, device=dev)[:, None]

    def rows_scan():
        return torch.cumsum(bwt == syms6, 1)

    def flat_scan():
        run = torch.cumsum((bwt == syms6).view(-1), 0).view(6, -1)
        ends = run[:, -1].clone()
        run[1:] -= ends[:-1, None]
        return run
    if not torch.equal(rows_scan(), flat_scan()):
        raise AssertionError("the two scans differ")
    ms = {}
    for name, fn in (("rows", rows_scan), ("flat", flat_scan)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    log("chkbwt_scan", positions=n, rows_ms=ms["rows"], flat_ms=ms["flat"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
