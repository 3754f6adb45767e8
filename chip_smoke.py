#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fermi_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--queries N]

Run from the repository root on a machine with a CUDA card.  It builds the
kernels from the sources in the checkout, holds kernel K1 (csrc/rank.cu)
bit-equal to its plain PyTorch version on the card, then drives the port's
main path through its CLI at the size of a bacterial re-sequencing run:
`build` of 30x error-free 100 bp reads of a random 4,641,652 bp genome (the
length of E. coli K-12 MG1655; about 281 Msym of index), `unpack` of 1,000
ids, and `exact` of 100,000 reads with 1% substitutions.  The first 512
queries are searched again on the CPU (the plain versions) and must give
the same SMEM tuples bit for bit.

A last phase profiles one 4,096-read `exact` batch (device busy and idle
share, device time by kernel).

Every phase prints one line; then a JSON line of the kernels, the card's
name and power limit, and last `{"ok": true, "device": {...}}`.  Any failure
raises and exits non-zero; so does a machine without CUDA.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

GENOME_LEN = 4_641_652          # E. coli K-12 MG1655
READ_LEN = 100
N_READS = 1_392_496             # 30x
N_UNPACK = 1000
N_CROSS = 512
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_OPS_PER_S = 67e12          # 32-bit non-tensor rate (fp32 data sheet)
K1_OPS_PER_QUERY = 16 * (6 * 10 + 5)   # per word: mask + 6 x SWAR count


def log(tag, **kv):
    print(f"[{tag}] " + json.dumps(kv), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps=20):
    """Median device time of fn() over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def random_rows(rng, n):
    """n nibble-packed 128-symbol blocks (symbols 0..6) as int32 [n, 16]."""
    nib = rng.integers(0, 7, (n, 16, 8), dtype=np.uint8).astype(np.uint32)
    words = np.zeros((n, 16), np.uint32)
    for s in range(8):
        words |= nib[:, :, s] << (4 * s)
    return words.view(np.int32)


def bound_ms(nbytes, n_queries):
    """Least time on the card for K1 over n_queries: the bytes it must move
    against the HBM rate, its SWAR operations against the ALU rate; the
    larger, in ms, and which of the two it is."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = n_queries * K1_OPS_PER_QUERY / H100_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_bound_ms(k):
    """rank6_fused on keys k: each touched 96 B row read once, each key
    read and its six counts written once."""
    rows = torch.unique(k.long() >> 7).numel()
    return bound_ms(rows * 96 + k.numel() * k.element_size() * 7, k.numel())


def k1_parity(rng, dev, n=1 << 20):
    """Both K1 entry points against the plain version on the card, on n
    random rows; keys cover every offset, occ patterns >= 2^31 in the int64
    domain.  Returns the largest absolute difference (must be 0)."""
    from fermi_tpu_torch.ops import rank_cuda as rc

    words = torch.from_numpy(random_rows(rng, n)).to(dev)
    off = torch.from_numpy(np.arange(n, dtype=np.int32) % 129).to(dev)
    err = 0
    got = rc.rank_block_counts(words, off)
    want = rc.rank_block_counts_plain(words, off)
    err = max(err, int((got - want).abs().max()))
    out = {"rank_block_counts": (
        time_ms(lambda: rc.rank_block_counts(words, off)),
        time_ms(lambda: rc.rank_block_counts_plain(words, off)),
        bound_ms(n * (64 + 4 + 32), n)[0])}
    fused = torch.zeros((n, 24), dtype=torch.int32, device=dev)
    fused[:, :16] = words
    for name, dt, occ_hi in (("int32", torch.int32, 2**31 - 2**20),
                             ("int64", torch.int64, 2**32 - 256)):
        occ = rng.integers(0, occ_hi, (n, 6), dtype=np.int64)
        occ[: n // 4] = rng.integers(max(0, occ_hi - 2**20), occ_hi,
                                     (n // 4, 6))
        fused[:, 16:22] = torch.from_numpy(
            occ.astype(np.uint32).view(np.int32)).to(dev)
        # stride 127 walks every in-block offset; the rest are random
        k = np.concatenate([np.arange(0, (n // 2) * 127, 127),
                            rng.integers(0, n * 128, n - n // 2)])
        kt = torch.from_numpy(k).to(dev).to(dt)
        got = rc.rank6_fused(fused, kt)
        want = rc.rank6_fused_plain(fused, kt)
        assert got.dtype == dt
        err = max(err, int((got.long() - want.long()).abs().max()))
        out[f"rank6_fused_{name}"] = (
            time_ms(lambda: rc.rank6_fused(fused, kt)),
            time_ms(lambda: rc.rank6_fused_plain(fused, kt)),
            fused_bound_ms(kt)[0])
    torch.cuda.synchronize()
    times = {}
    for name, (ms, plain, bound) in out.items():
        times.update({f"{name}_ms": ms, f"{name}_plain_ms": plain,
                      f"{name}_bound_ms": bound})
    log("k1_parity", rows=n, max_abs_err=err, **times, library_ms=None,
        library_note="no single PyTorch call computes a masked nibble rank")
    if err:
        raise AssertionError(f"K1 differs from its plain version: {err}")
    return err


def make_data(rng, workdir, genome_len, n_reads, n_queries):
    """Random genome, error-free reads (half reverse-complemented) as the
    index input, and queries with 1% substitutions (the recipe of
    bench.py's make_dataset), both as FASTA.  Returns paths and the reads."""
    genome = rng.integers(0, 4, genome_len).astype(np.int8)

    def sample(n, err):
        pos = rng.integers(0, genome_len - READ_LEN + 1, n)
        reads = genome[pos[:, None] + np.arange(READ_LEN)]
        if err:
            nerr = rng.binomial(READ_LEN, err, n)
            rid = np.repeat(np.arange(n), nerr)
            col = rng.integers(0, READ_LEN, rid.size)
            sub = 1 + rng.integers(0, 3, rid.size)
            for r, c, s in zip(rid, col, sub):
                reads[r, c] = (reads[r, c] + s) % 4
        flip = rng.random(n) < 0.5
        reads[flip] = 3 - reads[flip, ::-1]
        return reads

    def write(path, reads):
        asc = np.frombuffer(b"ACGT", np.uint8)[reads]
        with open(path, "wb") as f:
            for lo in range(0, len(asc), 65536):
                f.write(b"".join(b">r%d\n%s\n" % (lo + i, r.tobytes())
                                 for i, r in enumerate(asc[lo: lo + 65536])))
        return asc

    reads_fa = os.path.join(workdir, "reads.fa")
    q_fa = os.path.join(workdir, "q.fa")
    reads = write(reads_fa, sample(n_reads, 0.0))
    write(q_fa, sample(n_queries, 0.01))
    return reads_fa, q_fa, reads


def run_cli(argv, out_path=None):
    """The port's CLI in-process; stdout to out_path (or captured)."""
    from fermi_tpu_torch.cli.main import main

    t0 = time.perf_counter()
    err = io.StringIO()              # the CLI's telemetry lines
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stderr(err))
        if out_path:
            out = stack.enter_context(open(out_path, "w"))
        else:
            out = io.StringIO()
        stack.enter_context(contextlib.redirect_stdout(out))
        rc = main(argv)
        text = None if out_path else out.getvalue()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"fermi_tpu_torch {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0, text


def main_path(rng, workdir, dev, genome_len, n_reads, n_queries):
    """build -> unpack -> exact through the CLI on `dev`.  Returns what the
    cross-check and the kernel line need."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.ops import rank_cuda as rc
    from fermi_tpu_torch.search import smem as sm

    t0 = time.perf_counter()
    reads_fa, q_fa, reads = make_data(rng, workdir, genome_len, n_reads,
                                      n_queries)
    log("data", genome_bp=genome_len, reads=n_reads, queries=n_queries,
        seconds=time.perf_counter() - t0)
    dv = ["--device", str(dev)]
    on_card = dev.type == "cuda"
    for key in rc.LAUNCHES:
        rc.LAUNCHES[key] = 0
    sm.STATS.update(reads=0, redo=0, maxi=None)

    # build: the BWT is sorted on the device
    fmd = os.path.join(workdir, "idx.fmd")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_build, _ = run_cli(["build", *dv, "-fo", fmd, reads_fa])
    runs = rld.read_fmd(fmd)
    n_sym = runs.total
    peak_build = torch.cuda.max_memory_allocated() if on_card else 0
    if n_sym != 2 * n_reads * (READ_LEN + 1):
        raise AssertionError(f"index holds {n_sym} symbols")
    if on_card and peak_build < 8 * n_sym:
        raise AssertionError("build did not sort on the card")
    log("build", seconds=t_build, msym=n_sym / 1e6,
        fmd_mb=os.path.getsize(fmd) / 2**20, runs=len(runs.lengths),
        device_peak_gb=peak_build / 2**30)

    # unpack: ids x are sequence x of the text (read x//2, its reverse
    # complement when x is odd)
    ids = np.sort(rng.choice(2 * n_reads, N_UNPACK, replace=False))
    before = dict(rc.LAUNCHES)
    t_unpack, text = run_cli(["unpack", *dv,
                              *[a for x in ids for a in ("-i", str(x))], fmd])
    lines = text.splitlines()
    if len(lines) != N_UNPACK:
        raise AssertionError(f"unpack printed {len(lines)} lines")
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for x, line in zip(ids, lines):
        r = reads[x // 2].tobytes()
        want = r if x % 2 == 0 else r.translate(comp)[::-1]
        if line.split("\t")[0].encode() != want:
            raise AssertionError(f"unpack id {x}: {line[:40]}...")
    k1_unpack = rc.LAUNCHES["rank6_fused"] - before["rank6_fused"]
    log("unpack", ids=N_UNPACK, seconds=t_unpack, k1_launches=k1_unpack)

    # exact
    out_path = os.path.join(workdir, "exact.txt")
    before = dict(rc.LAUNCHES)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_exact, _ = run_cli(["exact", *dv, fmd, q_fa], out_path)
    k1_exact = rc.LAUNCHES["rank6_fused"] - before["rank6_fused"]
    with open(out_path) as f:
        exact_text = f.read()
    n_sq = exact_text.count("SQ\t")
    n_em = exact_text.count("\nEM\t")
    if n_sq != n_queries or n_em < n_queries:
        raise AssertionError(f"exact: {n_sq} records, {n_em} SMEMs")
    log("exact", queries=n_queries, seconds=t_exact,
        reads_per_s=n_queries / t_exact, smems=n_em,
        redo_reads=sm.STATS["redo"], learned_maxi=sm.STATS["maxi"],
        k1_launches=k1_exact,
        device_peak_gb=(torch.cuda.max_memory_allocated() / 2**30
                        if on_card else 0))
    launches = dict(rc.LAUNCHES)
    if on_card and (k1_unpack <= 0 or k1_exact <= 0):
        raise AssertionError("a query phase did not launch K1 on the card")
    return dict(fmd=fmd, q_fa=q_fa, exact_text=exact_text,
                launches=launches, maxi=sm.STATS["maxi"] or sm.DEFAULT_MAXI)


def cross_check(fmd, q_fa, exact_text, dev, n=N_CROSS):
    """The first n queries on `dev` and on the CPU (plain versions): equal
    SMEM tuples, and equal to the CLI's text for those queries."""
    from fermi_tpu_torch.core import dna, fastx
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import smem as sm

    recs = []
    for r in fastx.read_fastx(q_fa):
        recs.append(r)
        if len(recs) == n:
            break
    seqs = [dna.encode(r.seq) for r in recs]
    t0 = time.perf_counter()
    gidx = FMDIndex.restore(fmd, dev)
    got = sm.smem_all(gidx, seqs)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    cidx = FMDIndex.restore(fmd, "cpu")
    want = sm.smem_all(cidx, seqs)
    t_cpu = time.perf_counter() - t0
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"{bad} of {n} queries differ card vs CPU")
    text = []
    for r, s, mems in zip(recs, seqs, got):
        text.append(f"SQ\t{r.name}\t{len(s)}\t{len(mems)}\n")
        text += ["EM\t" + sm.format_smem(gidx, m) + "\n" for m in mems]
        text.append("//\n")
    text = "".join(text)
    if not exact_text.startswith(text):
        raise AssertionError("CLI output differs from smem_all tuples")
    log("cross_check", queries=n, equal=True, smems=sum(map(len, got)),
        device_seconds=t_dev, cpu_seconds=t_cpu)
    return gidx


def k1_at_main_path_shape(idx, maxi, rng):
    """K1 at the shape of one SMEM loop step: lanes x 2 x maxi keys over the
    index's own fused rows, kernel against plain version on the card."""
    from fermi_tpu_torch.ops import rank_cuda as rc
    from fermi_tpu_torch.search import smem as sm

    n = sm.LANES * 2 * maxi
    k = torch.from_numpy(rng.integers(0, idx.total + 1, n)).to(
        idx.device).to(idx.idtype)
    got = rc.rank6_fused(idx.fused, k)
    err = int((got.long() - rc.rank6_fused_plain(idx.fused, k).long())
              .abs().max())
    ms = time_ms(lambda: rc.rank6_fused(idx.fused, k))
    plain_ms = time_ms(lambda: rc.rank6_fused_plain(idx.fused, k))
    bound, by = fused_bound_ms(k)
    log("k1_main_shape", keys=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by)
    if err:
        raise AssertionError(f"K1 differs from its plain version: {err}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def profile_exact(idx, q_fa, lo=N_CROSS, n=4096):
    """Where one `exact` batch (4,096 reads, one smem_all call) spends its
    time on the card: the call timed alone after a warm-up at the learned
    width, then once under torch.profiler for device time by kernel.  The
    idle share is 1 - device busy time / unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fermi_tpu_torch.core import dna, fastx
    from fermi_tpu_torch.ops import rank_cuda as rc
    from fermi_tpu_torch.search import smem as sm

    seqs = []
    for i, r in enumerate(fastx.read_fastx(q_fa)):
        if i >= lo + n:
            break
        if i >= lo:
            seqs.append(dna.encode(r.seq))
    sm.smem_all(idx, seqs)                       # learns the width
    before = rc.LAUNCHES["rank6_fused"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm.smem_all(idx, seqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = rc.LAUNCHES["rank6_fused"] - before
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sm.smem_all(idx, seqs)
        torch.cuda.synchronize()
    dev_us = {}                                  # device time by kernel
    n_dev = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_us[e.name] = dev_us.get(e.name, 0) + e.time_range.elapsed_us()
            n_dev += 1
    busy = sum(dev_us.values()) / 1e6
    k1 = sum(t for key, t in dev_us.items() if "rank6_fused" in key) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
    log("profile_exact", queries=n, maxi=getattr(idx, "_smem_maxi", None),
        wall_s=wall, reads_per_s=n / wall, loop_steps=steps,
        host_ms_per_step=1e3 * wall / max(steps, 1),
        device_busy_s=busy if busy else "not measured",
        idle_share=1 - busy / wall if busy else "not measured",
        k1_device_s=k1, device_ops_per_step=n_dev / max(steps, 1),
        top_device_us={k[:60]: v for k, v in top})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--queries", type=int, default=100_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this test runs on the "
                         "card only\n")
        return 2
    from fermi_tpu_torch import native
    from fermi_tpu_torch.ops import rank_cuda

    dev = torch.device("cuda")
    card = gpu_line()
    t0 = time.perf_counter()
    native.build_all([native.codec_job(), rank_cuda.kernel_job()])
    native.get_lib()
    rank_cuda.get_lib()
    log("header", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), build_seconds=time.perf_counter() - t0)

    rng = np.random.default_rng(args.seed)
    err = k1_parity(rng, dev)
    with tempfile.TemporaryDirectory() as workdir:
        res = main_path(rng, workdir, dev, GENOME_LEN, N_READS, args.queries)
        gidx = cross_check(res["fmd"], res["q_fa"], res["exact_text"], dev)
        k1 = k1_at_main_path_shape(gidx, res["maxi"], rng)
        profile_exact(gidx, res["q_fa"])
    print(json.dumps({"kernels": [{
        "name": "rank6_fused", "route": "cuda",
        "source": "fermi_tpu_torch/csrc/rank.cu",
        "replaces": "fermi_tpu/ops/rank_pallas.py:49",
        "launches": res["launches"]["rank6_fused"],
        "max_abs_err": max(err, k1["max_abs_err"]),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
