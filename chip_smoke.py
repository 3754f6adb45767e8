#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fermi_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--queries N] [--against TREE]

Run from the repository root on a machine with a CUDA card.  It builds the
kernels and native engines from the sources in the checkout (all compilers
at once; `nvcc -Xptxas -v` beside them reports each kernel's registers and
spills), holds kernels K1 (csrc/rank.cu) and K2 (csrc/sw.cu) bit-equal to
their plain PyTorch versions on the card, then drives the port's paths
through their entry points at the size of a bacterial re-sequencing run of
a random 1,042,519 bp genome (the length of Chlamydia trachomatis
D/UW-3/CX), 30x of 100 bp reads:

- K2's entry `sw_score_batch` on 65,536 alignment pairs (and one 300 bp
  query in a 6,000 bp target, longer than one chunk of the kernel's rows);
- `build` of error-free reads (about 63 Msym of index), `unpack` of 1,000
  ids, and `exact` of 40,000 reads with 1% substitutions; the first 128
  queries are searched again on the CPU and must give the same SMEM tuples;
  then K1 on uniform keys at the shape of a loop step, K1 on the keys of
  every loop step of one 4,096-read `exact` batch (dead interval slots at
  fermi_tpu's spread keys and at key 0), and that batch profiled both ways
  (device busy and idle share, device time by kernel);
- `build` of reads with 1% substitutions at quality 14 (FASTQ), `correct`
  of all of them, then of the first 16,384 with the host fix and with the
  device fix, whose outputs must be byte-equal; the corrected reads are
  compared with the known genome;
- `build` of the corrected reads and `seqsort`, whose .rank array must be a
  permutation;
- `unitig -l 50` of the corrected reads' index (the pipeline's unpaired
  path), then `clean` and `clean -C -A -O -F -o 60` of its MAG as the
  pipeline runs them: seconds by part, counts, N50, and the share of unitig
  bases in unitigs found exactly in the genome; then the link records of
  one batch of 65,536 of its sequences profiled (device busy and idle
  share, kernels a round, K1's device time);
- the collect, seqsort and unitig (with and without the .rank array) of a
  12.5 kbp window of the reads, and both cleans of its MAG, on the card and
  on the CPU (the plain versions), which must be equal;
- the text of the error-free reads through each device builder alone
  (prefix doubling, the blocked builder: 40 Mi-symbol wsort blocks folded
  by the gap-bit merge, and BCR), each index byte-equal to `build`'s;
- run-fermi.pl -B's shape: the reads split into 4 files, each built,
  `merge` of the 4, and `merge` of 3 then `build -i` of the fourth, both
  byte-equal to `build` of all of them;
- `sub` and `sub -c` of the index with 40% of the reads chosen, each
  byte-equal to `build` of the chosen reads or of the others;
- contrast of two related samples: sample B's genome has a substitution
  every 2,000 bp and 10 insertions of 2,000 bp, 30x of its reads are
  built; `seqsort` of both, `contrast -k 55 -o 3`, `sub` of each side;
  at least 95% of B's reads inside an insertion are selected, and at
  least 99% of the selected reads on either side touch a difference;
- merge, sub, contrast and the three device builders on the reads of a
  12.5 kbp window of both genomes (the blocked builder in two blocks), on
  the card and on the CPU: equal;
- `run -t 8 -k 50`, the unpaired pipeline (run-fermi.pl) from the noisy
  reads of the genome's first 500 kbp (FASTQ) to p2.mag.gz: seconds by
  stage, and p2's unitigs, N50 and share of bases in unitigs found exactly
  in the genome (at least 99%); `run` of the 12.5 kbp window's reads on the
  card and on the CPU, every artifact equal;
- `chkbwt -r` of the 63 Msym index (K1 at every position against a
  running count), and of a copy with one run corrupted, which must fail;
- `exact` of 200 queries of 2,000 bp (the native long-query engine) with
  the index on the card and on the CPU: equal bytes;
- 30x of error-free read pairs (insert 300 +- 20) from a 100 kbp window:
  `build`, `seqsort`, `remap -r` with the window as the one contig (its
  mean insert within 2% of the drawn one) and `remap -c 2 -D cap`;
- genome P: the genome with 4 families of short repeats (60, 120, 200 and
  300 bp, 50 exact copies each) written over it; 30x of 2 x 100 bp pairs
  (insert 300 +- 20, 1% substitutions at quality 14) in two mate files,
  `pe2cofq` of them, then `run -P -t 8 -k 50` (run-fermi.pl -P: raw reads
  to scaftigs, p4.fa.gz, and p5.fq.gz): seconds and K1 launches by stage,
  scaf's gaps (examined, patched by local assembly, joined by SW, SW
  failures) and its local assemblies' BWT time, p2 and p4 by count and
  N50, the share of p4 in scaftigs found exactly in genome P; scaf must
  examine a gap and launch K1; `run -P` of the pairs of a 25 kbp window
  holding at least 4 repeat copies on the card and on the CPU, every
  artifact equal;
- `example -e -c` of the 12.5 kbp window's reads on the card and on the
  CPU: equal;
- the dp×tp layer (ranks are processes): two ranks sharing the card over
  gloo, the 63 Msym index split tp=2 (each rank restores the whole
  `.fmd` on the host and keeps its half of the rank rows on the card),
  ShardedSMEM of the first 2,048 `exact` queries equal to the
  single-process port's; the same through a world of one over NCCL;
  dp=2 `fm_merge_sharded` of two of the 4 parts, byte-equal to
  `fm_merge`; `dryrun_multichip(4)` on the card; per rank its seconds,
  K1 launches (each rank must launch K1), all-reduces and their ms, device
  peak and backend;
- `ropebwt -a bpr|bcr|sais` of the 12.5 kbp window's reads, text and `-b`:
  the six outputs equal in each format, and the device engines' `-b`
  equal to theirs on the CPU;
- `-M`, out of core on the host, over the files above, each call held to
  launch no kernel and allocate nothing on the card: the .fmd.blk record
  cache of the 63 Msym index (seconds, size); `exact -M` of the first
  4,096 queries equal to the card's `exact` of them, with reads/s and each
  call's peak RSS in a child process; `unpack -M` of the 1,000 ids;
  `seqsort -M -t 8` of the corrected index equal to its .rank; `correct -M
  -t 8` of the fix rerun's reads equal to the card's; `unitig -M -t 1 -l
  50 -r` of the window equal to the card's, and `-t 8` of the corrected
  index under the reference's threaded contract against the card's p0;
  `chkbwt -M -r` of the index and of a corrupted copy; `remap -M -r` of
  the pairs window equal to `remap`; `fm_append_streaming` of the fourth
  part onto the merge of three, equal to `build` of all the reads;
- reads past 1 kbp: 20x of reads of 1,000-8,000 bp (uniform, 0.1%
  substitutions, half reverse-complemented) of genome P's first 500 kbp
  (about 2,200 reads, an index of about 20 Msym), `build`, `seqsort`
  equal to the host engine
  `seqsort_native`, `unitig -l 100 -r` equal to the native host walk
  `fm6_unitig_native(..., 1)` (run beside it), with N50 and the share of
  unitig bases found exactly in genome P, and `retrieve_mates` of 4,096
  reads equal to the host walk of the mapped .fmd; seconds and K1
  launches by call, the longest walk, the route unitig took, the device
  peak;
- the wide index tier, last, at the size of fermi_tpu's own 2.26 Gsym run
  (scripts/uint32_run.py): 5.6 M pairs of 2 x 100 bp from a random 44.8
  Mbp genome (25x, insert 300 +- 30, 0.5% substitutions) as FASTQ, the
  pipeline's raw_fmd stage on the card (the blocked builder folds 54
  blocks past 2^31 symbols), the index restored once in the int64 domain
  with fused rows, then `chkbwt -r`, rank6 at 64 positions against a host
  scan, `exact` of 20,000 matched reads byte-equal to the native engine and
  to `exact -M`, `unpack` of 1,000 ids against the reads; seconds by part,
  device and host peaks; K1 at the main path's shape on the wide rows, and
  one 4,096-read batch's K1 time against its wall time and idle share;
- an index past 2^32 symbols, inside the wide tier: `merge` of the 2.26
  Gsym index with itself on the card (4,524,800,000 symbols: past 2^32 -
  128 every index is int64 without fused rows, rank6 a row gather and K1's
  `rank_block_counts`), restored once, then `chkbwt -r`, rank6 at 64
  positions (half past 2^32) against a host scan, `exact` of the first
  4,096 wide queries byte-equal to the native engine, to `exact -M` over
  the 256 B-record .fmd.blk and to the wide index's records with every
  size doubled, `unpack` of ids x and x + n_seqs against the reads;
  seconds and device peaks by part, host peak, file sizes, K1's launches
  of each entry.

Kernel times (`ms`) are device time alone: launches on several input sets
captured in a CUDA graph and replayed between two events, with the
profiler's (CUPTI) kernel durations beside them (`cupti_ms`); `call_ms` is
one call between two events from the host, its host work included.  With
`--against TREE` (a checkout of another commit, e.g. the parent unpacked
with `git archive` into the ignored smoke_tree/; the option may be given
more than once) that tree's kernels are built too, launched through that
tree's own wrappers, and timed in turns with these (old, new, new, old) on
the same inputs.

Every launch counter is set to 0 just before each path and read just after
it; a path that launched none of its kernels fails.  Every phase prints one
line; then a JSON line of the kernels, the card's name and power limit, and
last `{"ok": true, "device": {...}}`.  Any failure raises and exits
non-zero; so does a machine without CUDA.
"""

import argparse
import contextlib
import ctypes
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_START = time.perf_counter()

GENOME_LEN = 1_042_519          # Chlamydia trachomatis D/UW-3/CX
READ_LEN = 100
N_READS = 312_756               # 30x
N_UNPACK = 1000
N_CROSS = 512                   # exact queries before the profiled batch
N_SW_PAIRS = 65_536
N_CROSS_CPU = 128               # of them, searched again on the CPU
N_FIX_SUB = 16_384              # reads of the host-vs-device fix rerun
CROSS_WINDOW = 12_500           # genome bp whose reads the CPU re-checks
RUN_GENOME = 500_000            # genome bp whose noisy reads `run` takes
SETOPS_WINDOW = 12_500          # the same for merge, sub, contrast, builders
PAIRS_WINDOW = 100_000          # genome bp of remap's read pairs
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_SMS = 132
# Results per clock per SM for compute capability 9.0 (NVIDIA's CUDA C++
# documentation, arithmetic instruction throughput table): 32-bit integer
# logic, shift, compare, select and min/max 64, on the integer pipe;
# population count 16, on its own pipe.  Adds and left shifts run on the
# integer pipe or, as IMAD, on the FMA pipe (64 more).  The four schedulers
# of an SM dispatch at most 128 thread instructions per clock in all.
RATE_PER_CLK = {"alu": 64, "popc": 16}
DISPATCH_PER_CLK = 128
# The integer operations each kernel's function needs, counted once from
# its arithmetic (the compiled kernels do more: `cuobjdump -sass` on a built
# library shows what), by class: "alu" on the integer pipe only (logic,
# right shift, compare, select, max, and Hopper's DPX fused add-max and
# 3-way max, one instruction each, priced at the integer pipe's rate);
# "add" on the integer or the FMA pipe; "popc".
#
# K1, per 8-symbol word below the query's offset, a bit-plane count: the
# three planes (2 shifts, 3 ANDs), one 3-input logic op for each of the
# symbols 1-5 and the pad 6 (symbol 0 is what is left), 6 popcounts and 6
# adds into the counts.
K1_OPS_PER_WORD = {"alu": 11, "add": 6, "popc": 6}
# K1, per query: block and offset of the key (shift, AND), the partial
# word's mask (AND, shift, AND; 2 adds), the row's address (1 add), symbol
# 0's count (the offset less the other six: 6 adds), the six occ counts
# added (6 adds; 12 for int64 keys, two halves each).
K1_OPS_PER_QUERY = {"alu": 5, "add": 15, "popc": 0}
# K2, per alignment cell (i, j), the Gotoh recurrence:
#   s = t[j] == q[i] ? match : mismatch          compare, select
#   o = H[i][j] - (gapo + gape)                   add (feeds E below, F right)
#   E = max(E - gape, o), F = max(F - gape, o)    2 DPX add-max
#   H = max(H[i-1][j-1] + s, E, F, 0)             add, DPX 3-way max with 0
#   best = max(best, H)                           max
K2_OPS_PER_CELL = {"alu": 6, "add": 2, "popc": 0}


def log(tag, **kv):
    """One phase's line, with the seconds since the script started."""
    kv["at_s"] = time.perf_counter() - T_START
    print(f"[{tag}] " + json.dumps(kv), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def call_ms(fn, reps=20):
    """Median time of one call of fn() from the host's view: an event, the
    call (its host work and its launches), an event, on an idle card.  A
    host-bound loop pays this per call."""
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


def graph_ms(fns, replays=3):
    """Device time per call of the calls fns[0](), fns[1](), ... (each a
    launch on its own inputs): all captured in one CUDA graph, replayed
    between two events, divided by the calls.  No host work in the window."""
    for f in fns:                 # warm-up, outside the capture
        f()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for f in fns:
            f()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    del g
    return a.elapsed_time(b) / (replays * len(fns))


def device_records(prof):
    """(name, µs) of every device record of a finished torch.profiler run,
    read from its raw (kineto) results: prof.events() would first parse
    every record into a function event, which took over a minute for one
    `exact` batch profiled with its host operators."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_us_by_name(prof):
    """Device µs by kernel name, and the number of device records."""
    recs = device_records(prof)
    by_name = {}
    for name, us in recs:
        by_name[name] = by_name.get(name, 0) + us
    return by_name, len(recs)


def cupti_ms(fns, kernel):
    """Device time per call of fns[0](), fns[1](), ... read from the
    profiler's (CUPTI) record of the kernels whose name holds `kernel`:
    (mean over the records found, their count; it should be len(fns))."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f in fns:
            f()
        torch.cuda.synchronize()
    us = [t for name, t in device_records(prof) if kernel in name]
    return (sum(us) / 1e3 / len(us) if us else "not measured"), len(us)


def random_rows(rng, n):
    """n nibble-packed 128-symbol blocks (symbols 0..6) as int32 [n, 16]."""
    nib = rng.integers(0, 7, (n, 16, 8), dtype=np.uint8).astype(np.uint32)
    words = np.zeros((n, 16), np.uint32)
    for s in range(8):
        words |= nib[:, :, s] << (4 * s)
    return words.view(np.int32)


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def bound_ms(nbytes, ops, clock_hz):
    """Least time on the card for a kernel's work: the bytes it must move
    against the HBM rate, and its operations (`ops`: totals by class) on
    the card's SMs at their max clock, where the integer pipe, the popcount
    pipe or the dispatch of all of them sets the pace; the larger of the
    two, in ms, and which it is."""
    t_bytes = nbytes / H100_BYTES_PER_S
    clocks = max(ops["alu"] / RATE_PER_CLK["alu"],
                 ops["popc"] / RATE_PER_CLK["popc"],
                 sum(ops.values()) / DISPATCH_PER_CLK)
    t_ops = clocks / (H100_SMS * clock_hz)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_ops(off, wide=False):
    """The operations K1's function needs for queries of prefix lengths
    `off` (a tensor): the words below each offset, and each query's own."""
    words = int(((off.long() + 7) >> 3).sum())
    n = off.numel()
    ops = {c: K1_OPS_PER_WORD[c] * words + K1_OPS_PER_QUERY[c] * n
           for c in K1_OPS_PER_WORD}
    ops["add"] += 6 * n if wide else 0
    return ops


def k1_bytes(k):
    """The bytes rank6_fused must move for keys k, counted in 32-byte
    sectors of the fused rows (96 B apart, so sector-aligned): for each
    touched row its occ sector and the sectors of packed words below the
    largest offset among its keys (symbols 0-63 one, 64-127 two); each key
    read once and its six counts written once."""
    kl = k.long()
    blk = kl >> 7
    top = torch.full((int(blk.max()) + 1,), -1, dtype=torch.int64,
                     device=k.device)
    top.scatter_reduce_(0, blk, kl & 127, "amax")
    top = top[top >= 0]
    return 32 * int((1 + (top + 63) // 64).sum()) + k.numel() * k.element_size() * 7


def fused_bound_ms(k, clock_hz):
    """rank6_fused's bound on keys k: k1_bytes against the operations."""
    return bound_ms(k1_bytes(k), k1_ops(k.long() & 127,
                                        k.dtype == torch.int64), clock_hz)


def block_counts_bound_ms(off, clock_hz):
    """rank_block_counts' bound: of each 64-byte row the sectors below its
    offset, each offset read once, each row of 8 counts written once."""
    sectors = int(((off.long() + 63) // 64).sum())
    return bound_ms(32 * sectors + off.numel() * (4 + 32), k1_ops(off),
                    clock_hz)


def k1_parity(rng, dev, clock_hz, n=1 << 20):
    """Both K1 entry points against the plain version on the card, on n
    random rows; keys cover every offset, occ patterns >= 2^31 in the int64
    domain.  Returns the largest absolute difference (must be 0) and
    rank_block_counts' figures for the kernels line (device ms, host call
    ms, plain ms, bound ms and what sets it)."""
    from fermi_tpu_torch.ops import rank_cuda as rc

    words = torch.from_numpy(random_rows(rng, n)).to(dev)
    off = torch.from_numpy(np.arange(n, dtype=np.int32) % 129).to(dev)
    err = 0
    got = rc.rank_block_counts(words, off)
    want = rc.rank_block_counts_plain(words, off)
    err = max(err, int((got - want).abs().max()))
    bound, bound_by = block_counts_bound_ms(off, clock_hz)
    out = {"rank_block_counts": (
        graph_ms([lambda: rc.rank_block_counts(words, off)] * 8),
        call_ms(lambda: rc.rank_block_counts_plain(words, off)), bound)}
    counts = dict(ms=out["rank_block_counts"][0],
                  call_ms=call_ms(lambda: rc.rank_block_counts(words, off)),
                  plain_ms=out["rank_block_counts"][1], bound_ms=bound,
                  bound_by=bound_by, max_abs_err=err)
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
            graph_ms([lambda: rc.rank6_fused(fused, kt)] * 8),
            call_ms(lambda: rc.rank6_fused_plain(fused, kt)),
            fused_bound_ms(kt, clock_hz)[0])
    torch.cuda.synchronize()
    times = {}
    for name, (ms, plain, bound) in out.items():
        times.update({f"{name}_ms": ms, f"{name}_plain_ms": plain,
                      f"{name}_bound_ms": bound})
    log("k1_parity", rows=n, max_abs_err=err, **times, library_ms=None,
        library_note="no single PyTorch call computes a masked nibble rank")
    if err:
        raise AssertionError(f"K1 differs from its plain version: {err}")
    return err, counts


def sample_reads(rng, genome, n, err=0.0):
    """n reads of READ_LEN from random places of genome (nt4 codes), with
    substitutions at rate err, half reverse-complemented.  Returns (start
    positions, reads as nt4 codes [n, READ_LEN])."""
    pos = rng.integers(0, len(genome) - READ_LEN + 1, n)
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
    return pos, reads


def write_fasta(path, asc):
    """ASCII reads [n, READ_LEN] as FASTA records >r0, >r1, ..."""
    with open(path, "wb") as f:
        for lo in range(0, len(asc), 65536):
            f.write(b"".join(b">r%d\n%s\n" % (lo + i, r.tobytes())
                             for i, r in enumerate(asc[lo: lo + 65536])))


ASCII = np.frombuffer(b"ACGT", np.uint8)


def make_data(rng, workdir, genome_len, n_reads, n_queries):
    """Random genome, error-free reads (half reverse-complemented) as the
    index input, and queries with 1% substitutions (the recipe of
    bench.py's make_dataset), both as FASTA.  Returns the paths, the reads
    (ASCII), their start positions and the genome."""
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    reads_fa = os.path.join(workdir, "reads.fa")
    q_fa = os.path.join(workdir, "q.fa")
    pos, reads = sample_reads(rng, genome, n_reads)
    reads = ASCII[reads]
    write_fasta(reads_fa, reads)
    write_fasta(q_fa, ASCII[sample_reads(rng, genome, n_queries, 0.01)[1]])
    return reads_fa, q_fa, reads, pos, genome


def run_cli(argv, out_path=None):
    """The port's CLI in-process; stdout to out_path (or captured).
    Returns (seconds, stdout text or None, stderr text)."""
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
    return time.perf_counter() - t0, text, err.getvalue()


def reset_launches():
    """Every kernel launch counter to 0."""
    from fermi_tpu_torch.ops import rank_cuda, sw_cuda

    for counts in (rank_cuda.LAUNCHES, sw_cuda.LAUNCHES):
        for key in counts:
            counts[key] = 0


def launches():
    from fermi_tpu_torch.ops import rank_cuda, sw_cuda

    return {**rank_cuda.LAUNCHES, **sw_cuda.LAUNCHES}


def main_path(rng, workdir, dev, genome_len, n_reads, n_queries):
    """build -> unpack -> exact through the CLI on `dev`.  Returns what the
    cross-check and the kernel line need."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.ops import rank_cuda as rc
    from fermi_tpu_torch.search import smem as sm

    t0 = time.perf_counter()
    reads_fa, q_fa, reads, pos, genome = make_data(
        rng, workdir, genome_len, n_reads, n_queries)
    log("data", genome_bp=genome_len, reads=n_reads, queries=n_queries,
        seconds=time.perf_counter() - t0)
    dv = ["--device", str(dev)]
    on_card = dev.type == "cuda"
    reset_launches()
    sm.STATS.update(reads=0, redo=0, maxi=None)

    # build: the BWT is sorted on the device
    fmd = os.path.join(workdir, "idx.fmd")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_build, _, _ = run_cli(["build", *dv, "-fo", fmd, reads_fa])
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
    t_unpack, text, _ = run_cli(["unpack", *dv,
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
    t_exact, _, _ = run_cli(["exact", *dv, fmd, q_fa], out_path)
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
    counts = launches()
    if on_card and (k1_unpack <= 0 or k1_exact <= 0):
        raise AssertionError("a query phase did not launch K1 on the card")
    return dict(fmd=fmd, q_fa=q_fa, exact_text=exact_text, genome=genome,
                reads_fa=reads_fa, reads=reads, pos=pos, t_build=t_build,
                launches=counts, maxi=sm.STATS["maxi"] or sm.DEFAULT_MAXI,
                unpack_ids=ids, unpack_text=text)


def cross_check(fmd, q_fa, exact_text, dev, n=N_CROSS_CPU):
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


def in_turns(old, new):
    """Old and new timed in turns (old, new, new, old): each one's mean,
    and the four times in order."""
    t = [old(), new(), new(), old()]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def k1_at_main_path_shape(idx, maxi, rng, clock_hz, against=(), sets=16,
                          tag="k1_main_shape"):
    """K1 at the shape of one SMEM loop step: lanes x 2 x maxi keys, drawn
    uniformly over the index's own fused rows, kernel against plain version
    on the card.  `sets` different key sets are launched in turn, so rows
    one launch brings into L2 are not what the next one reads.  Each tree
    of `against` is timed in turns with this one on the same keys."""
    from fermi_tpu_torch.ops import rank_cuda as rc
    from fermi_tpu_torch.search import smem as sm

    n = sm.LANES * 2 * maxi
    keys = [torch.from_numpy(rng.integers(0, idx.total + 1, n)).to(
        idx.device).to(idx.idtype) for _ in range(sets)]
    k = keys[0]
    got = rc.rank6_fused(idx.fused, k)
    err = int((got.long() - rc.rank6_fused_plain(idx.fused, k).long())
              .abs().max())
    fns = [lambda x=x: rc.rank6_fused(idx.fused, x) for x in keys]
    ms = graph_ms(fns)
    cupti, n_rec = cupti_ms(fns, "rank6_fused")
    res = dict(keys=n, live_keys=n, key_sets=sets, max_abs_err=err, ms=ms,
               cupti_ms=cupti, cupti_records=n_rec,
               call_ms=call_ms(lambda: rc.rank6_fused(idx.fused, k)),
               plain_ms=call_ms(lambda: rc.rank6_fused_plain(idx.fused, k),
                                reps=5))
    bounds = [fused_bound_ms(x, clock_hz) for x in keys]
    res.update(bound_ms=float(np.mean([b for b, _ in bounds])),
               bound_by=bounds[0][1],
               bound_bytes=float(np.mean([k1_bytes(x) for x in keys])))
    res["share"] = res["bound_ms"] / ms
    res["against"] = {}
    for a in against:
        old = [lambda x=x, a=a: a.rank6_fused(idx.fused, x) for x in keys]
        err = max(err, int((a.rank6_fused(idx.fused, k).long()
                            - got.long()).abs().max()))
        r = res["against"][a.name] = {}
        r["ms"], r["this_ms"], r["turns_ms"] = in_turns(
            lambda: graph_ms(old), lambda: graph_ms(fns))
    res["max_abs_err"] = err
    log(tag, **res)
    if err:
        raise AssertionError(f"K1 differs from its plain version: {err}")
    return res


def dead_spread(shape, n_total, idt, device):
    """The keys fermi_tpu gives the dead slots of a [B, 2W] step (its
    search/smem.py `_dead_spread`, salt 1 for the low ends, 2 for the high
    ends): a pseudo-random spread over [0, n_total)."""
    b, w2 = shape
    halves = []
    for salt in (1, 2):
        v = ((torch.arange(b * w2 // 2, dtype=torch.int64, device=device)
              + salt * 40503) * 2654435761) & 0xFFFFFFFF
        halves.append((v % max(n_total & 0xFFFFFFFF, 1)).to(idt)
                      .view(b, w2 // 2))
    return torch.cat(halves, 1)


@contextlib.contextmanager
def marked_dead_slots(idx, tap):
    """smem_all on idx with the search's DEAD_KEY at -1 (no live key is
    negative), so a step's dead slots show, and each rank6 call's keys
    passed through tap(keys) first; both restored after, as found."""
    from fermi_tpu_torch.search import smem as sm

    was = sm.DEAD_KEY
    orig = idx.rank6
    sm.DEAD_KEY = -1
    idx.rank6 = lambda k: orig(tap(k))
    try:
        yield
    finally:
        sm.DEAD_KEY = was
        del idx.rank6


def spread_fill(idx):
    """Dead slots' keys (-1 under marked_dead_slots) as fermi_tpu spreads
    them."""
    cache = {}

    def fill(k):
        if k.shape not in cache:
            cache[k.shape] = dead_spread(k.shape, idx.total, k.dtype,
                                         k.device)
        return torch.where(k == -1, cache[k.shape], k)
    return fill


def exact_batch(q_fa, lo=N_CROSS, n=4096):
    """Queries lo..lo+n-1 of q_fa, one `exact` batch (one smem_all call)."""
    from fermi_tpu_torch.core import dna, fastx

    seqs = []
    for i, r in enumerate(fastx.read_fastx(q_fa)):
        if i >= lo + n:
            break
        if i >= lo:
            seqs.append(dna.encode(r.seq))
    return seqs


def k1_stream(idx, seqs, clock_hz, against=(), tag="k1_stream",
              spread=True):
    """K1 on the keys of every loop step of one `exact` batch, captured from
    FMDIndex.rank6, with the dead slots' keys as fermi_tpu spreads them and
    at 0 (this port's; only at 0 without `spread`): device time per step
    against the bound, and each tree of `against` in turns with this one.
    Returns the spread keys of every step, in order (None without
    `spread`), and the figures logged."""
    from fermi_tpu_torch.ops import rank_cuda as rc
    from fermi_tpu_torch.search import smem as sm

    sm.smem_all(idx, seqs)                       # learns the width
    rec = []

    def tap(k):
        rec.append(k.clone())
        return k
    with marked_dead_slots(idx, tap):
        sm.smem_all(idx, seqs)
    steps = len(rec)
    live = sum(int((k != -1).sum()) for k in rec)
    nkeys = sum(k.numel() for k in rec)
    fills = [("zero", lambda k: torch.where(k == -1, 0, k))]
    if spread:
        fills.insert(0, ("spread", spread_fill(idx)))
    res = dict(steps=steps, keys_per_step=nkeys / steps,
               live_keys_per_step=live / steps, live_share=live / nkeys)
    err = 0
    spread_keys = None
    for name, fill in fills:
        keys = [fill(k).reshape(-1).contiguous() for k in rec]
        for x in keys[::max(1, steps // 8)]:
            err = max(err, int((rc.rank6_fused(idx.fused, x).long()
                                - rc.rank6_fused_plain(idx.fused, x).long())
                               .abs().max()))
        fns = [lambda x=x: rc.rank6_fused(idx.fused, x) for x in keys]
        bound = sum(fused_bound_ms(x, clock_hz)[0] for x in keys)
        ms = graph_ms(fns, replays=1)
        cupti, n_rec = cupti_ms(fns, "rank6_fused")
        r = dict(us_per_step=1e3 * ms, bound_us_per_step=1e3 * bound / steps,
                 share=bound / steps / ms,
                 cupti_us_per_step=(1e3 * cupti if isinstance(cupti, float)
                                    else cupti), cupti_records=n_rec)
        r["against"] = {}
        for a in against:
            old = [lambda x=x, a=a: a.rank6_fused(idx.fused, x) for x in keys]
            p_ms, t_ms, turns = in_turns(lambda: graph_ms(old, replays=1),
                                         lambda: graph_ms(fns, replays=1))
            r["against"][a.name] = dict(
                us_per_step=1e3 * p_ms, this_us_per_step=1e3 * t_ms,
                turns_us_per_step=[1e3 * t for t in turns])
        res[name] = r
        if name == "spread":
            spread_keys = [x.view(k.shape) for x, k in zip(keys, rec)]
        del keys, fns
    res["max_abs_err"] = err
    log(tag, **res)
    if err:
        raise AssertionError(f"K1 differs from its plain version: {err}")
    return spread_keys, res


def profile_exact(idx, seqs, keys=None, tag="profile_exact"):
    """Where one `exact` batch (4,096 reads, one smem_all call) spends its
    time on the card: the call timed alone after a warm-up at the learned
    width, then once under torch.profiler for device time by kernel.  The
    idle share is 1 - device busy time / unprofiled wall time.  With `keys`
    (k1_stream's spread keys of each step) K1 gets those at each step in
    place of the search's own, which differ only in the dead slots: the
    same search and kernels, dead slots at fermi_tpu's spread instead of 0.
    Returns the SMEM tuples and the figures logged."""
    from torch.profiler import ProfilerActivity, profile

    from fermi_tpu_torch.ops import rank_cuda as rc
    from fermi_tpu_torch.search import smem as sm

    def run():
        if keys is None:
            return sm.smem_all(idx, seqs)
        steps = iter(keys)

        def fed(k):
            x = next(steps)
            if x.shape != k.shape:
                raise AssertionError("the search's steps changed")
            return orig(x)
        orig = idx.rank6
        idx.rank6 = fed
        try:
            return sm.smem_all(idx, seqs)
        finally:
            del idx.rank6

    run()                                        # learns the width
    before = rc.LAUNCHES["rank6_fused"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mems = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = rc.LAUNCHES["rank6_fused"] - before
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_us, n_dev = device_us_by_name(prof)      # device time by kernel
    busy = sum(dev_us.values()) / 1e6
    k1 = sum(t for key, t in dev_us.items() if "rank6_fused" in key) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
    info = dict(
        dead_keys="zero" if keys is None else "spread",
        queries=len(seqs), maxi=getattr(idx, "_smem_maxi", None),
        wall_s=wall, reads_per_s=len(seqs) / wall, loop_steps=steps,
        host_ms_per_step=1e3 * wall / max(steps, 1),
        device_busy_s=busy if busy else "not measured",
        idle_share=1 - busy / wall if busy else "not measured",
        k1_device_s=k1, k1_device_us_per_step=1e6 * k1 / max(steps, 1),
        device_ops_per_step=n_dev / max(steps, 1),
        top_device_us={k[:60]: v for k, v in top})
    log(tag, **info)
    return mems, info


def sw_pairs(rng, n):
    """n alignment pairs by the recipe of tests/test_sw_pallas.py scaled
    up: query 1-256 bp, target 1-512 bp, half of the pairs overlapping (the
    target holds a copy of the query with up to 5 substitutions); the last
    pair is a 300 bp query inside a 6,000 bp target, whose query runs in two
    chunks of the kernel's rows (its score is 1,500)."""
    qlen = rng.integers(1, 257, n)
    tlen = rng.integers(1, 513, n)
    overlap = rng.random(n) < 0.5
    qs, ts = [], []
    for i in range(n - 1):
        q = rng.integers(0, 4, qlen[i]).astype(np.int8)
        if overlap[i]:
            t = q.copy()
            nsub = int(rng.integers(0, 6))
            t[rng.integers(0, qlen[i], nsub)] = rng.integers(0, 4, nsub)
            t = np.concatenate([t, rng.integers(0, 4, max(0, tlen[i] - qlen[i]))
                                .astype(np.int8)])
        else:
            t = rng.integers(0, 4, tlen[i]).astype(np.int8)
        qs.append(q)
        ts.append(t)
    q = rng.integers(0, 4, 300).astype(np.int8)
    qs.append(q)
    ts.append(np.concatenate([rng.integers(0, 4, 2500), q,
                              rng.integers(0, 4, 3200)]).astype(np.int8))
    return qs, ts


def k2_lane_share(qo, to, rows):
    """From K2's schedule of these pairs (a host count): the share of the
    lane-row-steps the kernel runs that are cells of the pairs, and the
    share left after the rows past each query alone (G is a power of
    two)."""
    from fermi_tpu_torch.ops import sw_cuda

    tasks, _, _ = sw_cuda.schedule(qo, to, rows)
    qlen, tlen = np.diff(qo), np.diff(to)
    ids = tasks[:, 1:]
    G = (tasks[:, 0] & (sw_cuda.PIPE - 1)).astype(np.int64)
    tl = np.where(ids >= 0, tlen[ids.clip(0)], 0).max(1)
    ql = np.where(ids >= 0, qlen[ids.clip(0)], 0).max(1)
    # chunks each warp runs: one, or for warp w of a PIPE block (those
    # come first) chunks w, w + BLOCK_WARPS, ...
    chunks = -(-ql // (32 * rows))
    w = np.arange(len(tasks)) % sw_cuda.BLOCK_WARPS
    pipe = (tasks[:, 0] & sw_cuda.PIPE) > 0
    ch = np.where(pipe, -(-(chunks - w) // sw_cuda.BLOCK_WARPS), 1).clip(0)
    cells = int((qlen * tlen).sum())
    row_slots = 0
    for g, r, c in zip(G, ids, ch):
        p = r[r >= 0]
        row_slots += int((g * rows * c * tlen[p]).sum())
    return dict(warps=len(tasks), pipe_blocks=int(pipe.sum())
                // sw_cuda.BLOCK_WARPS,
                cell_share=cells / int((32 * rows * ch * (tl + G - 1)).sum()),
                row_share=cells / row_slots)


def k2_phase(rng, dev, clock_hz, against=(), n=N_SW_PAIRS):
    """K2's path, its entry sw_score_batch on n pairs (launch counts from 0
    just before, read just after), then the same inputs through the plain
    version on the card: equal scores, and the kernel's device time beside
    the plain version's and the bound; the time without the longest pair
    and of that pair alone; each tree of `against` timed in turns with this
    one on the whole batch and on the longest pair alone."""
    from fermi_tpu_torch.ops import sw_cuda

    qs, ts = sw_pairs(rng, n)
    reset_launches()
    t0 = time.perf_counter()
    got = sw_cuda.sw_score_batch(qs, ts, device=dev)
    entry_s = time.perf_counter() - t0
    n_launch = launches()["sw_score_batch"]
    if dev.type == "cuda" and n_launch < 1:
        raise AssertionError("sw_score_batch did not launch K2")
    (qc, qo), (tc, to) = sw_cuda.pack(qs), sw_cuda.pack(ts)
    args = [torch.from_numpy(a).to(dev) for a in (qc, qo, tc, to)]
    want = sw_cuda.sw_score_batch_plain(*args).cpu().numpy()
    err = int(np.abs(got.astype(np.int64) - want).max())
    if err or got[-1] != 1500:
        raise AssertionError(f"K2 differs from its plain version: {err}, "
                             f"long pair {got[-1]}")
    cells = int((np.diff(qo) * np.diff(to)).sum())
    qcat, tcat = args[0], args[2]

    def this(lo, hi):
        """A launch of this tree's K2 on pairs lo..hi-1 alone."""
        plan = sw_cuda.sw_plan(qo[lo: hi + 1], to[lo: hi + 1], dev)
        return lambda: sw_cuda.sw_scores(qcat, tcat, plan)

    whole, longest = this(0, n), this(n - 1, n)
    ms = graph_ms([whole] * 3)
    res = dict(launches=n_launch, max_abs_err=err, ms=ms,
               cupti_ms=cupti_ms([whole] * 3, "sw_wavefront")[0],
               call_ms=call_ms(whole, reps=10))
    without_longest = graph_ms([this(0, n - 1)] * 3)
    longest_alone = graph_ms([longest] * 3)
    res["plain_ms"] = call_ms(lambda: sw_cuda.sw_score_batch_plain(*args),
                              reps=2)
    nbytes = qc.size + tc.size + 8 * (qo.size + to.size) + 4 * n
    res["bound_ms"], res["bound_by"] = bound_ms(
        nbytes, {c: v * cells for c, v in K2_OPS_PER_CELL.items()}, clock_hz)
    res["share"] = res["bound_ms"] / ms
    rows = sw_cuda.get_lib().k2_rows()
    turns = {}
    for a in against:
        old_whole = a.sw_run(qcat, tcat, qo, to)
        old_longest = a.sw_run(qcat, tcat, qo[n - 1:], to[n - 1:])
        if not np.array_equal(old_whole().cpu().numpy(), got):
            raise AssertionError(f"K2 of {a.name} differs from this one")
        r = {}
        r["ms"], r["this_ms"], r["turns_ms"] = in_turns(
            lambda: graph_ms([old_whole] * 3), lambda: graph_ms([whole] * 3))
        (r["longest_pair_ms"], r["this_longest_pair_ms"],
         r["longest_pair_turns_ms"]) = in_turns(
            lambda: graph_ms([old_longest] * 3),
            lambda: graph_ms([longest] * 3))
        turns[a.name] = r
    log("k2_parity", pairs=n, cells=cells,
        longest_target=int(np.diff(to).max()), entry_seconds=entry_s,
        **res, ms_without_longest_pair=without_longest,
        ms_longest_pair_alone=longest_alone, rows_per_lane=rows,
        **k2_lane_share(qo, to, rows), ops_per_cell=K2_OPS_PER_CELL,
        library_ms=None,
        library_note="no PyTorch call computes an alignment score",
        against=turns)
    return res


def import_tree(tree, names):
    """Modules `names` of another checkout's fermi_tpu_torch, imported from
    that tree apart from this one's (which is restored after): each keeps
    its own tree's native loader, signatures, schedule and counters."""
    import importlib

    def ours(key):
        return key == "fermi_tpu_torch" or key.startswith("fermi_tpu_torch.")
    saved = {k: v for k, v in sys.modules.items() if ours(k)}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, os.path.abspath(tree))
    importlib.invalidate_caches()
    try:
        return [importlib.import_module(n) for n in names]
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


class Against:
    """The kernels of another checkout of this repository (e.g. the parent
    commit unpacked with `git archive`), launched through that tree's own
    wrappers (ops/rank_cuda.py, ops/sw_cuda.py), so its kernels' C
    interfaces and K2's schedule are that tree's: the yardstick of
    `--against`.  Its launches count on its own counters, not on these."""

    def __init__(self, tree):
        self.name = os.path.basename(os.path.normpath(tree))
        native, self.rc, self.sw = import_tree(tree, (
            "fermi_tpu_torch.native", "fermi_tpu_torch.ops.rank_cuda",
            "fermi_tpu_torch.ops.sw_cuda"))
        native.build_all([native.rank_job(), native.sw_job()])
        self.rc.get_lib()
        self.sw.get_lib()

    def rank6_fused(self, fused, k):
        return self.rc.rank6_fused(fused, k)

    def sw_run(self, qcat, tcat, qo, to):
        """A function that launches this tree's K2 once on the pairs with
        host offsets qo, to into qcat, tcat (on the card) and puts nothing
        else on the stream (so a CUDA graph can capture it)."""
        sw = self.sw
        if hasattr(sw, "sw_plan"):
            plan = sw.sw_plan(qo, to, qcat.device)
            return lambda: sw.sw_scores(qcat, tcat, plan)
        # the wrapper of PR 2's kernel sizes its carry on the card and reads
        # it back, which a capture forbids: the same launch, sized here
        lib = sw.get_lib()
        dev = qcat.device
        n = len(qo) - 1
        need = np.where(np.diff(to) > lib.k2_tile(), 4 * np.diff(qo), 0)
        qoff, toff, coff = (torch.from_numpy(a).to(dev)
                            for a in (qo, to, np.cumsum(need) - need))
        carry = torch.empty(max(int(need.sum()), 1), dtype=torch.int32,
                            device=dev)

        def run():
            out = torch.empty(n, dtype=torch.int32, device=dev)
            sw._raise_on(lib.k2_sw_score(
                qcat.data_ptr(), qoff.data_ptr(), tcat.data_ptr(),
                toff.data_ptr(), n, 5, -4, 5, 2, carry.data_ptr(),
                coff.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream), "k2_sw_score")
            return out
        return run


def write_fastq(path, seq, qual, first_id=0):
    with open(path, "wb") as f:
        for lo in range(0, len(seq), 65536):
            f.write(b"".join(
                b"@r%d\n%s\n+\n%s\n" % (first_id + lo + i, s.tobytes(),
                                          q.tobytes())
                for i, (s, q) in enumerate(zip(seq[lo: lo + 65536],
                                               qual[lo: lo + 65536]))))


def noisy_reads(rng, genome, n):
    """n reads of 100 bp with 1% substitutions at quality 14 and quality 38
    elsewhere (the recipe of tests/test_correct.py), half of them reverse
    complemented, one in 64 with an N.  Returns (start positions, ASCII
    reads, ASCII quals, true ASCII sequences as written), uint8 [n, 100]."""
    pos = rng.integers(0, len(genome) - READ_LEN + 1, n)
    truth = genome[pos[:, None] + np.arange(READ_LEN)]
    reads = truth.copy()
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()))) % 4
    qual = np.where(err, 14 + 33, 38 + 33).astype(np.uint8)
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    truth[flip] = 3 - truth[flip, ::-1]
    qual[flip] = qual[flip, ::-1]
    asc = np.frombuffer(b"ACGT", np.uint8)
    seq = asc[reads]
    with_n = np.flatnonzero(rng.random(n) < 1 / 64)
    seq[with_n, rng.integers(0, READ_LEN, with_n.size)] = ord("N")
    return pos, seq, qual, asc[truth]


def truth_share(path, truth):
    """Of the records of a corrected FASTQ (names @<id>_<qsum>_<sdiff>),
    how many, and the share whose bases (case ignored) equal the genome."""
    lines = open(path, "rb").read().split(b"\n")
    m = len(lines) // 4
    ids = np.array([int(h[1:].split(b"_")[0]) for h in lines[0: 4 * m: 4]])
    seqs = np.frombuffer(b"".join(lines[1: 4 * m: 4]), np.uint8)
    seqs = seqs.reshape(m, READ_LEN) & 0xDF          # upper case
    return m, float((seqs == truth[ids]).all(1).mean()) if m else 0.0


def correct_phase(rng, workdir, dev, genome, n_reads, n_sub=N_FIX_SUB):
    """The correct path on `dev`: build of noisy reads, `correct` of all of
    them through the CLI, then of the first n_sub with the host fix and with
    the device fix (byte-equal outputs).  Returns what the seqsort phase and
    the cross-check need."""
    from fermi_tpu_torch.algos import correct as ec
    from fermi_tpu_torch.search import ecfix_device as ef

    t0 = time.perf_counter()
    pos, seq, qual, truth = noisy_reads(rng, genome, n_reads)
    fq = os.path.join(workdir, "noisy.fq")
    write_fastq(fq, seq, qual)
    sub_fq = os.path.join(workdir, "sub.fq")
    write_fastq(sub_fq, seq[:n_sub], qual[:n_sub])
    window = np.flatnonzero(pos <= CROSS_WINDOW - READ_LEN)
    win_fq = os.path.join(workdir, "window.fq")
    write_fastq(win_fq, seq[window], qual[window])
    head = np.flatnonzero(pos <= RUN_GENOME - READ_LEN)
    run_fq = os.path.join(workdir, "run.fq")
    write_fastq(run_fq, seq[head], qual[head])
    raw_equal = float((seq == truth).all(1).mean())
    log("ec_data", reads=n_reads, raw_equal_share=raw_equal,
        window_reads=int(window.size), run_reads=int(head.size),
        seconds=time.perf_counter() - t0)

    dv = ["--device", str(dev)]
    fmd = os.path.join(workdir, "noisy.fmd")
    t_build, _, _ = run_cli(["build", *dv, "-fo", fmd, fq])
    threads = str(os.cpu_count() or 1)
    ec_fq = os.path.join(workdir, "ec.fq")
    reset_launches()
    t_corr, _, err = run_cli(["correct", *dv, "-t", threads, fmd, fq], ec_fq)
    k1 = launches()["rank6_fused"]
    if dev.type == "cuda" and k1 < 1:
        raise AssertionError("correct did not launch K1")
    kmers = re.search(r"collected (\d+) informative and (\d+) ambiguous", err)
    n_out, share = truth_share(ec_fq, truth)
    log("correct", reads=n_reads, build_seconds=t_build, seconds=t_corr,
        threads=int(threads), k=int(re.search(r"k-mer length to (\d+)",
                                               err).group(1)),
        collect_seconds=ec.STATS["collect_s"], bfs_levels=ec.STATS["levels"],
        extend_calls=ec.STATS["extend_calls"],
        max_frontier=ec.STATS["max_frontier"],
        informative_kmers=int(kmers.group(1)),
        ambiguous_kmers=int(kmers.group(2)), k1_launches=k1,
        fix_seconds=ec.STATS["fix_s"],
        fix_reads_per_s=n_reads / ec.STATS["fix_s"],
        reads_out=n_out, corrected_equal_share=share,
        raw_equal_share=raw_equal)

    outs = {}
    for mode in ("0", "1"):
        os.environ["FERMI_TPU_DEVICE_FIX"] = mode
        ef.STATS.update(waves=0, rounds=0, round_s=0.0, n=0, n_redo=0)
        out = os.path.join(workdir, f"sub{mode}.fq")
        try:
            t, _, _ = run_cli(["correct", *dv, "-t", threads, fmd, sub_fq],
                              out)
        finally:
            os.environ.pop("FERMI_TPU_DEVICE_FIX")
        outs[mode] = open(out, "rb").read()
        extra = {}
        if mode == "1":
            extra = dict(redo=ef.STATS["n_redo"], waves=ef.STATS["waves"],
                         rounds=ef.STATS["rounds"],
                         host_ms_per_round=(1e3 * ef.STATS["round_s"]
                                            / max(ef.STATS["rounds"], 1)))
        log("correct_fix", fix="device" if mode == "1" else "host",
            reads=n_sub, seconds=t, collect_seconds=ec.STATS["collect_s"],
            fix_seconds=ec.STATS["fix_s"],
            fix_reads_per_s=n_sub / ec.STATS["fix_s"], **extra)
    if outs["0"] != outs["1"]:
        raise AssertionError("device fix output differs from host fix output")
    log("correct_fix_equal", reads=n_sub, bytes=len(outs["0"]), equal=True)
    return dict(fq=fq, ec_fq=ec_fq, win_fq=win_fq, run_fq=run_fq,
                k1_launches=k1, fmd=fmd, sub_fq=sub_fq,
                sub_out=os.path.join(workdir, "sub0.fq"))


def seqsort_phase(workdir, ec_fq, dev):
    """The seqsort path: build of the corrected reads, then `seqsort`
    through the CLI; the .rank array must be a permutation of the ids.
    Returns the index's path and the K1 launches."""
    from fermi_tpu_torch import rld

    dv = ["--device", str(dev)]
    fmd = os.path.join(workdir, "ec.fmd")
    t_build, _, _ = run_cli(["build", *dv, "-fo", fmd, ec_fq])
    n_seqs = rld.read_fmd(fmd).n_seqs
    rank = os.path.join(workdir, "ec.rank")
    reset_launches()
    t, _, _ = run_cli(["seqsort", *dv, fmd], rank)
    k1 = launches()["rank6_fused"]
    if dev.type == "cuda" and k1 < 1:
        raise AssertionError("seqsort did not launch K1")
    arr = np.fromfile(rank, np.uint64)
    if arr.size != n_seqs or not np.array_equal(
            np.sort(arr >> np.uint64(2)), np.arange(n_seqs, dtype=np.uint64)):
        raise AssertionError("seqsort: the .rank array is not a permutation")
    log("seqsort", seqs=n_seqs, build_seconds=t_build, seconds=t,
        k1_launches=k1, permutation=True)
    return dict(fmd=fmd, k1_launches=k1, rank=rank)


def decompressed(path):
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def mag_seqs(path):
    """The sequence line of every record of a MAG file (gzipped or not)."""
    lines = decompressed(path).split(b"\n")
    return [lines[i + 1] for i in range(0, len(lines) - 1, 4)
            if lines[i].startswith(b"@")]


def assembly_stats(seqs):
    """Unitig count, total bp, N50 and the longest unitig."""
    lens = sorted((len(s) for s in seqs), reverse=True)
    total = sum(lens)
    acc, n50 = 0, 0
    for n in lens:
        acc += n
        if 2 * acc >= total:
            n50 = n
            break
    return dict(unitigs=len(lens), total_bp=total, n50=n50,
                longest=lens[0] if lens else 0)


class GenomeIndex:
    """Exact occurrence of a sequence in a genome or its reverse complement:
    the sorted K-mer codes of both strands, each sequence looked up by its
    first K-mer and compared whole at the hits."""

    K = 31

    def __init__(self, genome):
        asc = np.frombuffer(b"ACGT", np.uint8)
        fwd = np.asarray(genome, np.int64)
        self.strands = [asc[fwd].tobytes(), asc[3 - fwd[::-1]].tobytes()]
        codes = [self._codes(fwd), self._codes(3 - fwd[::-1])]
        self.n = len(codes[0])
        keys = np.concatenate(codes)
        self.order = np.argsort(keys, kind="stable")
        self.keys = keys[self.order]

    def _codes(self, a):
        n = len(a) - self.K + 1
        c = np.zeros(max(n, 0), np.int64)
        for j in range(self.K):
            c = (c << 2) | a[j: j + n]
        return c

    def occurs(self, s: bytes) -> bool:
        if len(s) < self.K:
            return any(s in g for g in self.strands)
        code = int(self._codes(np.frombuffer(s[: self.K].translate(
            bytes.maketrans(b"ACGT", b"\0\1\2\3")), np.uint8)
            .astype(np.int64))[0])
        lo = np.searchsorted(self.keys, code, "left")
        hi = np.searchsorted(self.keys, code, "right")
        for i in self.order[lo:hi]:
            g, p = divmod(int(i), self.n)
            if self.strands[g][p: p + len(s)] == s:
                return True
        return False

    def exact_share(self, seqs):
        """The share of the bases of `seqs` in sequences found exactly."""
        total = sum(len(s) for s in seqs)
        hit = sum(len(s) for s in seqs if self.occurs(s))
        return hit / total if total else 0.0


def unitig_phase(workdir, fmd, genome, dev, min_match=50):
    """The unitig path on `dev`: `unitig -l 50` of the corrected reads'
    index through the CLI (the pipeline's unpaired path: no .rank array),
    then `clean` and `clean -C -A -O -F -o 60` as the pipeline runs them.
    Seconds by part from unitig_links.STATS, counts, N50, and the share of
    unitig bases in unitigs found exactly in the genome before and after
    clean (which must be at least 99%)."""
    from fermi_tpu_torch.search import unitig_links as ul

    dv = ["--device", str(dev)]
    p0, p1, p2 = (os.path.join(workdir, f"p{i}.mag") for i in range(3))
    reset_launches()
    t_unitig, _, _ = run_cli(["unitig", *dv, "-l", str(min_match), fmd], p0)
    k1 = launches()["rank6_fused"]
    st = dict(ul.STATS)
    if dev.type == "cuda" and st["k1_launches"] < 1:
        raise AssertionError("unitig's link records did not launch K1")
    t_clean1, _, _ = run_cli(["clean", p0], p1)
    o = str(int(min_match * 1.2 + 0.499))
    t_clean2, _, _ = run_cli(["clean", "-C", "-A", "-O", "-F", "-o", o, p1],
                             p2)
    t0 = time.perf_counter()
    gi = GenomeIndex(genome)
    mags = {name: mag_seqs(p) for name, p in (("p0", p0), ("p1", p1),
                                              ("p2", p2))}
    share = {k: gi.exact_share(mags[k]) for k in ("p0", "p2")}
    # the reads come from the genome and nearly all were corrected to it
    if min(share.values()) < 0.99:
        raise AssertionError(f"unitig bases found in the genome: {share}")
    log("unitig", min_match=min_match, seconds=t_unitig,
        retrieve_s=st["retrieve_s"], walk_s=st["walk_s"],
        get_nei_s=st["getnei_s"], ladder_s=st["ladder_s"],
        stitch_s=st["stitch_s"], clean_s=t_clean1, clean2_s=t_clean2,
        unique_seqs=st["unique"], walk_rounds=st["walk_rounds"],
        get_nei_rounds=st["getnei_rounds"], ladder_rows=st["ladder_rows"],
        redo_left=st["redo_left"], stitch_recoveries=st["stitch_recoveries"],
        k1_launches=k1, links_k1_launches=st["k1_launches"],
        batch=st["batch"], ladder_batch=st["ladder_batch"],
        **{f"{name}_{k}": v for name, seqs in mags.items()
           for k, v in assembly_stats(seqs).items()},
        p0_exact_share=share["p0"], p2_exact_share=share["p2"],
        check_seconds=time.perf_counter() - t0)
    return dict(k1_launches=k1, p0=p0)


def profile_unitig(fmd, dev, n=1 << 16, min_match=50):
    """Where the link records of one batch (the first n stored sequences of
    the index: walk, get_nei, ladder) spend their time on the card: wall
    time after a warm-up, then once under torch.profiler for the device's
    busy time, the kernels a round (walk and get_nei rounds) and K1's
    device time.  The idle share is 1 - device busy time / unprofiled
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import unitig_links as ul
    from fermi_tpu_torch.search.extend import retrieve_strings

    idx = FMDIndex.restore(fmd, dev)
    seqs, _ = retrieve_strings(idx, np.arange(n))

    def run():
        return ul.compute_links_device(idx, seqs, min_match, device=dev)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(ul.STATS)
    rounds = st["walk_rounds"] + st["getnei_rounds"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_us, n_dev = device_us_by_name(prof)
    busy = sum(dev_us.values()) / 1e6
    k1 = sum(t for key, t in dev_us.items() if "rank6_fused" in key) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
    log("profile_unitig", seqs=n, unique=st["unique"], wall_s=wall,
        walk_s=st["walk_s"], get_nei_s=st["getnei_s"],
        ladder_s=st["ladder_s"], walk_rounds=st["walk_rounds"],
        get_nei_rounds=st["getnei_rounds"], ladder_rows=st["ladder_rows"],
        k1_launches=st["k1_launches"], host_ms_per_round=1e3 * wall / rounds,
        device_busy_s=busy if busy else "not measured",
        idle_share=1 - busy / wall if busy else "not measured",
        device_ops_per_round=n_dev / rounds, k1_device_s=k1,
        k1_device_share=k1 / busy if busy else "not measured",
        top_device_us={k[:60]: v for k, v in top})


def cross_check_ec(workdir, win_fq, dev):
    """collect and seqsort of the reads of one genome window on `dev` and on
    the CPU (the plain versions): equal (cls, key, val) sets and equal
    .rank arrays.  Returns the window's index and .rank paths."""
    from fermi_tpu_torch.algos import correct as ec
    from fermi_tpu_torch.algos.seqsort import seqsort
    from fermi_tpu_torch.index.fmd import FMDIndex

    fmd = os.path.join(workdir, "window.fmd")
    run_cli(["build", "--device", str(dev), "-fo", fmd, win_fq])
    res, secs = [], {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        idx = FMDIndex.restore(fmd, d)
        w = ec.auto_k(idx.total)
        cls, key, val, counts = ec.collect_solid_kmers(idx, w, 3)
        arr = seqsort(idx, verbose=False)
        secs[d.type] = time.perf_counter() - t0
        res.append((sorted(zip(cls.tolist(), key.tolist(), val.tolist())),
                    counts, arr))
    if res[0][:2] != res[1][:2]:
        raise AssertionError("collect differs card vs CPU")
    if not np.array_equal(res[0][2], res[1][2]):
        raise AssertionError("seqsort differs card vs CPU")
    log("cross_check_ec", window_bp=CROSS_WINDOW, seqs=int(res[0][2].size),
        k=w, kmers=res[0][1][0], collect_equal=True, seqsort_equal=True,
        device_seconds=secs[dev.type], cpu_seconds=secs["cpu"])
    rank = os.path.join(workdir, "window.rank")
    res[0][2].tofile(rank)
    return fmd, rank


def cross_check_unitig(workdir, fmd, rank, dev, min_match=50):
    """unitig of the window's index without and with its .rank array, and
    both cleans of each MAG: through the CLI on `dev`, and on the CPU (link
    records computed once, stitched both ways): equal bytes."""
    from fermi_tpu_torch.algos.unitig_bulk import stitch_native
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import unitig_links as ul
    from fermi_tpu_torch.search.extend import retrieve_strings

    mm = str(min_match)
    o = str(int(min_match * 1.2 + 0.499))
    t0 = time.perf_counter()
    texts = {}
    for r in ([], ["-r", rank]):
        _, texts["dev", bool(r)], _ = run_cli(
            ["unitig", "--device", str(dev), "-l", mm, *r, fmd])
    t_dev = time.perf_counter() - t0
    st = dict(ul.STATS)
    t0 = time.perf_counter()
    idx = FMDIndex.restore(fmd, "cpu")
    seqs, ks = retrieve_strings(idx, np.arange(idx.n_seqs))
    store = ul.compute_links_device(idx, seqs, min_match, device="cpu")
    srt = np.fromfile(rank, np.uint64)
    for use in (False, True):
        texts["cpu", use] = stitch_native(idx, store, seqs, ks, min_match,
                                          srt if use else None)[0]
    t_cpu = time.perf_counter() - t0
    cleaned = {}
    for key, text in texts.items():
        p0 = os.path.join(workdir, f"w_{key[0]}_{int(key[1])}.mag")
        with open(p0, "w") as f:
            f.write(text)
        _, c1, _ = run_cli(["clean", p0])
        with open(p0 + ".1", "w") as f:
            f.write(c1)
        _, c2, _ = run_cli(["clean", "-C", "-A", "-O", "-F", "-o", o,
                            p0 + ".1"])
        cleaned[key] = (c1, c2)
    for use in (False, True):
        if texts["dev", use] != texts["cpu", use]:
            raise AssertionError(f"unitig (rank {use}) differs card vs CPU")
        if cleaned["dev", use] != cleaned["cpu", use]:
            raise AssertionError(f"clean (rank {use}) differs card vs CPU")
    log("cross_check_unitig", window_bp=CROSS_WINDOW, seqs=len(seqs),
        min_match=min_match, unitigs=texts["dev", False].count("\n+\n"),
        unitigs_rank=texts["dev", True].count("\n+\n"),
        cleaned_unitigs=cleaned["dev", False][1].count("\n+\n"),
        ladder_rows=st["ladder_rows"], redo_left=st["redo_left"],
        unitig_equal=True, clean_equal=True, device_seconds=t_dev,
        cpu_seconds=t_cpu)
    return texts["dev", True]


def nt6_text(asc):
    """The text `build` indexes for ASCII reads [n, READ_LEN] (each read
    and its reverse complement, sentinel-terminated), and the strands as a
    list (what BCR takes)."""
    from fermi_tpu_torch.construct import suffix

    codes = np.zeros(256, np.uint8)
    codes[np.frombuffer(b"ACGT", np.uint8)] = (1, 2, 3, 4)
    text = suffix.build_text(list(codes[asc]))
    ends = np.flatnonzero(text == 0)
    starts = np.concatenate([[0], ends[:-1] + 1])
    return text, [text[a:b] for a, b in zip(starts, ends)]


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def write_bwt(bwt, path):
    from fermi_tpu_torch import rld

    rld.write_fmd(rld.Runs.from_bwt(bwt), path)
    return path


def timed(dev, fn):
    """fn() and its seconds, the device's work included, with the device's
    peak memory during the call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def builders_phase(workdir, res, dev):
    """The text `build` indexed in main_path through each device builder
    alone: prefix doubling (construct/suffix_device.py, what `build` runs
    below 2^31 symbols), the blocked builder (40 Mi-symbol wsort blocks
    folded by the gap-bit merge) and BCR on the strands; the BWTs written
    as .fmd must equal main_path's index byte for byte.  Returns the K1
    launches."""
    from fermi_tpu_torch.construct import bcr_device, blocked
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device

    t0 = time.perf_counter()
    text, strands = nt6_text(res["reads"])
    prep_s = time.perf_counter() - t0
    out = {}
    bwt, out["doubling_s"], out["doubling_peak_gb"] = timed(
        dev, lambda: multistring_bwt_device(text, dev))
    ok = same_bytes(write_bwt(bwt, os.path.join(workdir, "pd.fmd")),
                    res["fmd"])
    del bwt
    reset_launches()
    bwt, out["blocked_s"], out["blocked_peak_gb"] = timed(
        dev, lambda: blocked.device_build_text(text, device=dev))
    k1 = launches()["rank6_fused"]
    ok_blk = same_bytes(write_bwt(bwt, os.path.join(workdir, "blk.fmd")),
                        res["fmd"])
    del bwt
    bwt, out["bcr_s"], out["bcr_peak_gb"] = timed(
        dev, lambda: bcr_device.bcr_bwt_device(strands, device=dev))
    ok_bcr = same_bytes(write_bwt(bwt, os.path.join(workdir, "bcr.fmd")),
                        res["fmd"])
    del bwt, strands
    st = dict(blocked.STATS)
    for k in list(out):
        if k.endswith("_gb"):
            out[k] /= 2**30
    log("builders", msym=text.size / 1e6, seqs=int((text == 0).sum()),
        set_up_s=prep_s, **out, blocks=st["blocks"],
        block_symbols=blocked.BLOCK_SYMBOLS, sort_s=st["sort_s"],
        merge_s=st["merge_s"], merge_steps=st["merge_steps"],
        k1_launches=k1, cli_build_s=res["t_build"], doubling_equal=ok,
        blocked_equal=ok_blk, bcr_equal=ok_bcr)
    if not (ok and ok_blk and ok_bcr):
        raise AssertionError("an index built alone differs from build's")
    if k1 < 1:
        raise AssertionError("the blocked builder did not launch K1")
    return k1


@contextlib.contextmanager
def fold_log():
    """Each compute_gap_bits call's seconds, walk steps, lanes and K1
    launches, appended to the list this yields."""
    from fermi_tpu_torch.algos import merge as mg

    folds, orig = [], mg.compute_gap_bits

    def logged(e0, e1, **kw):
        before = launches()["rank6_fused"]
        bits = orig(e0, e1, **kw)
        folds.append(dict(seconds=mg.STATS["seconds"],
                          steps=mg.STATS["steps"], lanes=mg.STATS["lanes"],
                          batch=mg.STATS["batch"],
                          chunk_steps=mg.STATS["chunk_steps"],
                          k1_launches=launches()["rank6_fused"] - before))
        return bits
    mg.compute_gap_bits = logged
    try:
        yield folds
    finally:
        mg.compute_gap_bits = orig


def merge_phase(workdir, res, dev, parts=4):
    """run-fermi.pl -B's shape: the error-free reads split into `parts`
    contiguous files, each built, then `merge` of all of them, and `merge`
    of all but the last followed by `build -i` of the last: both must
    equal main_path's index byte for byte.  Returns the K1 launches."""
    dv = ["--device", str(dev)]
    reads = res["reads"]
    cut = np.linspace(0, len(reads), parts + 1).astype(np.int64)
    fas, fmds = [], []
    t_build = 0.0
    for i in range(parts):
        fa = os.path.join(workdir, f"part{i}.fa")
        write_fasta(fa, reads[cut[i]: cut[i + 1]])
        fmds.append(os.path.join(workdir, f"part{i}.fmd"))
        t_build += run_cli(["build", *dv, "-fo", fmds[i], fa])[0]
        fas.append(fa)
    out = {}
    all_fmd = os.path.join(workdir, "merged.fmd")
    reset_launches()
    with fold_log() as folds:
        out["merge_s"] = run_cli(["merge", *dv, "-fo", all_fmd, *fmds])[0]
    k1 = launches()["rank6_fused"]
    head = os.path.join(workdir, "merged_head.fmd")
    app = os.path.join(workdir, "appended.fmd")
    with fold_log() as folds_i:
        out["merge_head_s"] = run_cli(["merge", *dv, "-fo", head,
                                       *fmds[:-1]])[0]
        out["append_s"] = run_cli(["build", *dv, "-fo", app, "-i", head,
                                   fas[-1]])[0]
    k1_all = launches()["rank6_fused"]
    ok = same_bytes(all_fmd, res["fmd"]), same_bytes(app, res["fmd"])
    log("merge", parts=parts, part_build_s=t_build, **out, folds=folds,
        head_and_append_folds=folds_i, k1_launches_merge=k1,
        k1_launches=k1_all, merged_equal=ok[0], appended_equal=ok[1])
    if not all(ok):
        raise AssertionError(f"merged / appended index differs: {ok}")
    if k1 < 1 or k1_all <= k1:
        raise AssertionError("merge or build -i did not launch K1")
    return k1_all


@contextlib.contextmanager
def fd_stdout(path):
    """File descriptor 1 (where the native codec writes `-`) to path."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "wb") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        os.dup2(saved, 1)
        os.close(saved)


def run_sub(dv, fmd, bits, out_path, comp=False):
    """`sub` through the CLI, its .fmd bytes (written to stdout by the
    native codec) to out_path; returns its seconds."""
    with fd_stdout(out_path):
        t = run_cli(["sub", *dv, *(["-c"] if comp else []), fmd, bits])[0]
    return t


def sub_phase(rng, workdir, res, dev, share=0.4):
    """`sub` and `sub -c` of main_path's index with `share` of the reads
    chosen (both strands together): each must equal `build` of the chosen
    reads, or of the others, byte for byte.  Returns the K1 launches."""
    from fermi_tpu_torch.algos import sub as sb

    dv = ["--device", str(dev)]
    reads = res["reads"]
    sel = rng.random(len(reads)) < share
    bits = os.path.join(workdir, "sel.bits")
    sb.pack_bitfile(bits, np.repeat(sel, 2))
    out, ok, k1 = {}, [], 0
    for comp, chosen in ((False, sel), (True, ~sel)):
        tag = "sub_c" if comp else "sub"
        got = os.path.join(workdir, f"{tag}.fmd")
        reset_launches()
        out[f"{tag}_s"] = run_sub(dv, res["fmd"], bits, got, comp)
        k1 += launches()["rank6_fused"]
        out[f"{tag}_steps"] = sb.STATS["steps"]
        out[f"{tag}_walk_s"] = sb.STATS["seconds"]
        fa = os.path.join(workdir, f"{tag}.fa")
        write_fasta(fa, reads[chosen])
        want = os.path.join(workdir, f"{tag}_build.fmd")
        out[f"{tag}_build_s"] = run_cli(["build", *dv, "-fo", want, fa])[0]
        ok.append(same_bytes(got, want))
    log("sub", reads_chosen=int(sel.sum()), reads=len(reads), **out,
        k1_launches=k1, sub_equal=ok[0], sub_c_equal=ok[1])
    if not all(ok):
        raise AssertionError(f"sub index differs from build: {ok}")
    if k1 < 1:
        raise AssertionError("sub did not launch K1")
    return k1


SNP_EVERY = 2000                # sample B: one substitution per 2,000 bp
N_INSERTS = 10                  # and 10 private insertions
INSERT_LEN = 2000


def sample_b(rng, genome):
    """Genome B: the genome with one substitution per SNP_EVERY bp and
    N_INSERTS random insertions of INSERT_LEN bp.  Returns B, its SNP
    positions and insertion intervals in B's coordinates, the SNP
    positions and insertion points in A's, and the map of an A position
    to B's."""
    g = len(genome)
    snp_a = np.sort(rng.choice(g, g // SNP_EVERY, replace=False))
    mutated = genome.copy()
    mutated[snp_a] = (mutated[snp_a] + rng.integers(1, 4, snp_a.size)) % 4
    ins_a = np.sort(rng.choice(np.arange(1, g), N_INSERTS, replace=False))
    pieces, last = [], 0
    for a in ins_a:
        pieces += [mutated[last:a],
                   rng.integers(0, 4, INSERT_LEN).astype(genome.dtype)]
        last = a
    pieces.append(mutated[last:])
    b = np.concatenate(pieces)

    def to_b(x):                # position x of A in B (inserted before a)
        return x + INSERT_LEN * np.searchsorted(ins_a, x, "right")
    ins_b = ins_a + INSERT_LEN * np.arange(N_INSERTS)
    return dict(genome=b, snp_b=to_b(snp_a), ins_b=ins_b, snp_a=snp_a,
                ins_a=ins_a, to_b=to_b)


def holds(pos, points, lo=0):
    """Reads at `pos` that hold one of the sorted `points` in
    [pos + lo, pos + READ_LEN)."""
    return (np.searchsorted(points, pos + READ_LEN, "left")
            > np.searchsorted(points, pos + lo, "left"))


def contrast_phase(rng, workdir, res, dev, kmer=55, min_occ=3):
    """Contrast of two related samples, the contrast assembly's shape:
    sample A is main_path's reads, sample B 30x of error-free reads of
    genome B (sample_b).  `build` of B, `seqsort` of both, `contrast -k
    55 -o 3`, then `sub` of each side's selection.  Gates: at least 95%
    of B's reads lying wholly inside an insertion are selected on B's
    side, and at least 99% of the reads selected on either side touch a
    difference (a SNP, an insertion, or for A an insertion point inside
    the read).  Returns the K1 launches and what the window check needs."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.algos import contrast as ct
    from fermi_tpu_torch.algos import sub as sb

    dv = ["--device", str(dev)]
    t0 = time.perf_counter()
    B = sample_b(rng, res["genome"])
    n_b = len(B["genome"]) * 30 // READ_LEN
    pos_b, reads_b = sample_reads(rng, B["genome"], n_b)
    reads_b = ASCII[reads_b]
    fa_b = os.path.join(workdir, "b.fa")
    write_fasta(fa_b, reads_b)
    set_up_s = time.perf_counter() - t0
    fmd_b = os.path.join(workdir, "b.fmd")
    t_build = run_cli(["build", *dv, "-fo", fmd_b, fa_b])[0]
    ranks, t_sort = [], 0.0
    for tag, fmd in (("a", res["fmd"]), ("b", fmd_b)):
        ranks.append(os.path.join(workdir, f"{tag}.rank"))
        t_sort += run_cli(["seqsort", *dv, fmd], ranks[-1])[0]
    subs = [os.path.join(workdir, f"{t}.sub") for t in ("a", "b")]
    reset_launches()
    t_con, _, err = run_cli(["contrast", *dv, "-k", str(kmer), "-o",
                             str(min_occ), res["fmd"], ranks[0], subs[0],
                             fmd_b, ranks[1], subs[1]])
    k1 = launches()["rank6_fused"]
    st = dict(ct.STATS)
    sel = [sb.unpack_bitfile(p)[0::2] for p in subs]
    t_sub, sub_seqs = 0.0, []
    for tag, fmd, bits in (("a", res["fmd"], subs[0]),
                           ("b", fmd_b, subs[1])):
        out = os.path.join(workdir, f"{tag}_sel.fmd")
        t_sub += run_sub(dv, fmd, bits, out)
        sub_seqs.append(rld.read_fmd(out).n_seqs)
    k1_sub = launches()["rank6_fused"] - k1
    inside = np.zeros(n_b, bool)
    for s in B["ins_b"]:
        inside |= (pos_b >= s) & (pos_b + READ_LEN <= s + INSERT_LEN)
    # an A read differs where it holds a SNP or an insertion point (bases
    # on both sides of it), a B read where it holds a SNP or inserted bases
    diff_a = holds(res["pos"], B["snp_a"]) | holds(res["pos"], B["ins_a"], 1)
    diff_b = holds(pos_b, B["snp_b"]) | holds(pos_b, B["ins_b"],
                                              1 - INSERT_LEN)
    inside_share = float(sel[1][inside].mean())
    touch_share = [float(diff[s].mean()) if s.any() else 1.0
                   for diff, s in ((diff_a, sel[0]), (diff_b, sel[1]))]
    log("contrast", genome_b_bp=len(B["genome"]), snps=len(B["snp_a"]),
        inserts=N_INSERTS, reads_b=n_b, set_up_s=set_up_s,
        build_b_s=t_build, seqsort_s=t_sort, kmer=kmer, min_occ=min_occ,
        seconds=t_con, bfs_s=st["bfs_s"], tips_s=st["tips_s"],
        levels=st["levels"], max_frontier=st["max_frontier"],
        tip_levels=st["tip_levels"], tip_roots=st["tip_roots"],
        k1_launches=k1, selected_a=int(sel[0].sum()),
        selected_b=int(sel[1].sum()),
        cli_says=re.findall(r"(\d+) reads selected", err),
        reads_inside_inserts=int(inside.sum()),
        inside_selected_share=inside_share,
        selected_touching_share_a=touch_share[0],
        selected_touching_share_b=touch_share[1],
        sub_s=t_sub, sub_seqs=sub_seqs, sub_k1_launches=k1_sub)
    if inside_share < 0.95 or min(touch_share) < 0.99:
        raise AssertionError("contrast gates failed")
    if sub_seqs != [2 * int(s.sum()) for s in sel]:
        raise AssertionError("sub of the selection holds other reads")
    if k1 < 1 or k1_sub < 1:
        raise AssertionError("contrast or its sub did not launch K1")
    return dict(k1_launches=k1 + k1_sub, B=B, pos_b=pos_b, reads_b=reads_b)


def cross_check_setops(workdir, res, con, dev, window=SETOPS_WINDOW):
    """merge, sub, contrast and the three device builders on the reads of
    a window of both genomes (window bp of A from half a window before
    B's first insertion, the matching stretch of B with that insertion),
    on `dev` and on the CPU (the plain versions): equal bits and BWTs."""
    from fermi_tpu_torch.algos import contrast, merge, sub
    from fermi_tpu_torch.construct import bcr_device, blocked, wsort
    from fermi_tpu_torch.index.fmd import FMDIndex

    B = con["B"]
    a0 = max(int(B["ins_a"][0]) - window // 2, 0)
    a1 = a0 + window
    b0, b1 = int(B["to_b"](a0)), int(B["to_b"](a1))
    fmds = []
    for tag, pos, reads, lo, hi in (
            ("a", res["pos"], res["reads"], a0, a1),
            ("b", con["pos_b"], con["reads_b"], b0, b1)):
        fa = os.path.join(workdir, f"w{tag}.fa")
        write_fasta(fa, reads[(pos >= lo) & (pos <= hi - READ_LEN)])
        fmds.append(os.path.join(workdir, f"w{tag}.fmd"))
        run_cli(["build", "--device", str(dev), "-fo", fmds[-1], fa])
    text, strands = nt6_text(res["reads"][(res["pos"] >= a0)
                                          & (res["pos"] <= a1 - READ_LEN)])
    blk = text.size // 2 + 1          # two blocks: one fold
    out, secs = {}, {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        e0, e1 = FMDIndex.restore(fmds[0], d), FMDIndex.restore(fmds[1], d)
        ids = np.flatnonzero(np.arange(e0.n_seqs) % 5 < 2)
        r = [merge.compute_gap_bits(e0, e1).cpu().numpy(),
             sub.mark_read_positions(e0, ids, e0.total).cpu().numpy(),
             *contrast.fm6_contrast(e0, e1, 55, 3),
             wsort.wsort_bwt(text, device=d),
             blocked.device_build_text(text, block_symbols=blk, device=d),
             bcr_device.bcr_bwt_device(strands, device=d)]
        secs[d.type] = time.perf_counter() - t0
        out[d.type] = r
    names = ("gap_bits", "sub_bits", "contrast_a", "contrast_b", "wsort",
             "blocked", "bcr")
    bad = [n for n, x, y in zip(names, out[dev.type], out["cpu"])
           if not np.array_equal(x, y)]
    log("cross_check_setops", window_bp=window, a_from=a0, b_from=b0,
        seqs=[int(x.size) for x in out["cpu"][2:4]],
        msym_text=text.size / 1e6, blocks=blocked.STATS["blocks"],
        selected=[int(out["cpu"][2].sum()), int(out["cpu"][3].sum())],
        equal=not bad, differ=bad, device_seconds=secs[dev.type],
        cpu_seconds=secs["cpu"])
    if bad:
        raise AssertionError(f"card and CPU differ: {bad}")


# -- slice 6: the pipeline driver, chkbwt, long queries, remap ------------


RUN_ARTIFACTS = ("raw.fmd", "ec.fq.gz", "ec.fmd", "p0.mag.gz", "p1.mag.gz",
                 "p2.mag.gz")


def run_phase(workdir, fq, win_fq, genome, dev, unitig_k=50):
    """`run -t 8 -k 50` (the unpaired pipeline, raw reads to p2.mag.gz) on
    the noisy reads of the genome's first RUN_GENOME bp: seconds by stage
    from the pipeline's log, K1 launches, p2's unitigs, N50 and the share of
    its bases in unitigs found exactly in the genome (at least 99%).  Then
    `run` of the window's reads on `dev` and on the CPU: every artifact
    equal, decompressed.  Returns the prefix of the full run's artifacts
    and its K1 launches."""
    from fermi_tpu_torch.algos import correct as ec
    from fermi_tpu_torch.search import unitig_links as ul

    prefix = os.path.join(workdir, "pl")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t, _, err = run_cli(["run", "--device", str(dev), "-t", "8", "-k",
                         str(unitig_k), "-p", prefix, fq])
    k1 = launches()["rank6_fused"]
    if dev.type == "cuda" and k1 < 1:
        raise AssertionError("run did not launch K1")
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[pipeline::run\] stage (\w+): ([\d.]+)s", err)}
    frags = [int(m.group(1)) for m in re.finditer(r"(\d+) fragments", err)]
    kept = re.search(r"fltuniq: kept (\d+) reads", err)
    st = dict(ul.STATS)
    t0 = time.perf_counter()
    p2 = mag_seqs(prefix + ".p2.mag.gz")
    share = GenomeIndex(genome).exact_share(p2)
    if share < 0.99:
        raise AssertionError(f"run: p2 bases found in the genome: {share}")
    log("run", genome_bp=RUN_GENOME, seconds=t, stage_seconds=stages,
        fragments=frags,
        fltuniq_kept=int(kept.group(1)), collect_s=ec.STATS["collect_s"],
        fix_s=ec.STATS["fix_s"], unitig_retrieve_s=st["retrieve_s"],
        unitig_walk_s=st["walk_s"], unitig_get_nei_s=st["getnei_s"],
        unitig_stitch_s=st["stitch_s"], k1_launches=k1,
        **{f"p2_{k}": v for k, v in assembly_stats(p2).items()},
        p2_exact_share=share, check_seconds=time.perf_counter() - t0,
        device_peak_gb=(torch.cuda.max_memory_allocated() / 2**30
                        if dev.type == "cuda" else 0))

    secs = {}
    for d in (str(dev), "cpu"):
        pre = os.path.join(workdir, f"wrun_{d}")
        secs[d], _, _ = run_cli(["run", "--device", d, "-t", "8", "-k",
                                 str(unitig_k), "-p", pre, win_fq])
    for sfx in RUN_ARTIFACTS:
        a = decompressed(os.path.join(workdir, f"wrun_{dev}.{sfx}"))
        if a != decompressed(os.path.join(workdir, f"wrun_cpu.{sfx}")):
            raise AssertionError(f"run: {sfx} differs card vs CPU")
    log("run_window", window_bp=CROSS_WINDOW, artifacts=len(RUN_ARTIFACTS),
        equal=True, device_seconds=secs[str(dev)], cpu_seconds=secs["cpu"])
    return dict(prefix=prefix, k1_launches=k1)


def corrupt_copy(fmd, path):
    """A copy of fmd with one byte of its run data flipped, the first from
    the middle on whose decoded runs differ from fmd's (the header's
    marginal counts stay)."""
    from fermi_tpu_torch import rld

    raw = open(fmd, "rb").read()
    want = rld.read_fmd(fmd)
    for at in range(len(raw) // 2, len(raw)):
        b = bytearray(raw)
        b[at] ^= 0x10
        with open(path, "wb") as f:
            f.write(b)
        try:
            got = rld.read_fmd(path)
        except IOError:
            continue
        if len(got.lengths) != len(want.lengths) or not (
                np.array_equal(got.lengths, want.lengths)
                and np.array_equal(got.symbols, want.symbols)):
            return at
    raise AssertionError("no byte of the runs changes the BWT")


def chkbwt_phase(workdir, fmd, dev):
    """`chkbwt -r` of the main path's index on `dev` (K1 at every position
    against a running count): it must pass; then of a copy with one run
    corrupted, which must exit 1."""
    from fermi_tpu_torch.cli.main import main

    dv = ["--device", str(dev)]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t, _, err = run_cli(["chkbwt", *dv, "-r", fmd])
    k1 = launches()["rank6_fused"]
    peak = torch.cuda.max_memory_allocated()
    if "rank check passed" not in err or (dev.type == "cuda" and k1 < 1):
        raise AssertionError(f"chkbwt -r: {err[-300:]}")
    bad = os.path.join(workdir, "bad.fmd")
    at = corrupt_copy(fmd, bad)
    e = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(e):
        rc = main(["chkbwt", *dv, "-r", bad])
    t_bad = time.perf_counter() - t0
    msg = [ln for ln in e.getvalue().splitlines() if "[E::chkbwt]" in ln]
    if rc != 1 or not msg:
        raise AssertionError(f"chkbwt -r of a corrupted index exited {rc}")
    os.remove(bad)
    log("chkbwt", seconds=t, k1_launches=k1, device_peak_gb=peak / 2**30,
        passed=True, corrupted_byte=at, corrupted_rc=rc,
        corrupted_message=msg[0], corrupted_seconds=t_bad)
    return k1


def exact_long_phase(rng, workdir, genome, fmd, dev, n=200, length=2000):
    """`exact` of n queries of `length` bp with 1% substitutions (the
    native engine over the index's host arrays) with the index restored on
    `dev` and on the CPU: byte-equal outputs."""
    pos = rng.integers(0, len(genome) - length + 1, n)
    q = genome[pos[:, None] + np.arange(length)]
    err = rng.random(q.shape) < 0.01
    q[err] = (q[err] + rng.integers(1, 4, int(err.sum()))) % 4
    q_fa = os.path.join(workdir, "long.fa")
    write_fasta(q_fa, ASCII[q])
    outs, secs = {}, {}
    for d in (str(dev), "cpu"):
        secs[d], outs[d], _ = run_cli(["exact", "--device", d, fmd, q_fa])
    if outs[str(dev)] != outs["cpu"]:
        raise AssertionError("exact of long queries differs card vs CPU")
    text = outs["cpu"]
    if text.count("SQ\t") != n:
        raise AssertionError("exact of long queries: missing records")
    log("exact_long", queries=n, query_bp=length, seconds=secs[str(dev)],
        cpu_seconds=secs["cpu"], smems=text.count("\nEM\t"),
        smems_per_query=text.count("\nEM\t") / n, equal=True)


def remap_pairs_phase(rng, workdir, genome, dev, window=PAIRS_WINDOW,
                      rl=READ_LEN, insert=300, sd=20):
    """30x of error-free read pairs (mates adjacent, the second reverse
    complemented, insert 300 +- 20) from a window of the genome: `build`,
    `seqsort`, then `remap -r` with the window as the one contig, whose
    insert line must be within 2% of the drawn mean insert; and `remap -c
    2 -D cap`, which breaks the contig at unsupported stretches."""
    g = genome[:window]
    n = window * 30 // (2 * rl)
    ins = np.clip(np.rint(rng.normal(insert, sd, n)).astype(np.int64),
                  rl + 10, 1000)
    pos = rng.integers(0, window - ins + 1)
    left = g[pos[:, None] + np.arange(rl)]
    right = 3 - g[(pos + ins - 1)[:, None] - np.arange(rl)]
    reads = np.empty((2 * n, rl), np.int64)
    reads[0::2], reads[1::2] = left, right
    fa = os.path.join(workdir, "pairs.fa")
    write_fasta(fa, ASCII[reads])
    ctg = os.path.join(workdir, "window_ctg.fa")
    with open(ctg, "wb") as f:
        f.write(b">w\n" + ASCII[g].tobytes() + b"\n")
    dv = ["--device", str(dev)]
    fmd, rank = (os.path.join(workdir, f"pairs.{s}") for s in ("fmd", "rank"))
    run_cli(["build", *dv, "-fo", fmd, fa])
    run_cli(["seqsort", *dv, fmd], rank)
    t, text, err = run_cli(["remap", "-r", rank, fmd, ctg])
    m = re.search(r"avg = (\S+) std = (\S+) cap = (\S+)", err)
    avg, std, cap = float(m.group(1)), float(m.group(2)), int(m.group(3))
    drawn = float(ins.mean())
    if abs(avg - drawn) > 0.02 * drawn:
        raise AssertionError(f"remap: insert {avg} against drawn {drawn}")
    t_c, broken, _ = run_cli(["remap", "-c", "2", "-D", str(cap), "-r", rank,
                              fmd, ctg])
    pieces = broken.count("\n+\n")
    if pieces < 1 or "UR:Z:" in broken:
        raise AssertionError("remap -c 2: no piece of the contig")
    log("remap_pairs", window_bp=window, pairs=int(n), insert_drawn=drawn,
        insert_sd_drawn=float(ins.std()), avg=avg, std=std, cap=cap,
        within_2pct=True, seconds=t, unpaired_lists=text.count("UR:Z:"),
        broken_seconds=t_c, broken_pieces=pieces)
    return dict(fmd=fmd, rank=rank, ctg=ctg, text=text)


# slice 7: the paired chain on genome P
N_PAIRS = 156_378               # 30x of 2 x 100 bp pairs
INSERT, INSERT_SD = 300, 20
# short interspersed repeat families (bp, exact copies), as a bacterial
# genome's REP/BIME and IS elements
REPEAT_FAMILIES = ((60, 50), (120, 50), (200, 50), (300, 50))
PAIRED_WINDOW = 25_000          # genome-P bp of the card-vs-CPU paired run
PAIRED_ARTIFACTS = ("raw.fmd", "ec.fq.gz", "ec.fmd", "ec.rank", "p0.mag.gz",
                    "p1.mag.gz", "p2.mag.gz", "p3.mag.gz", "p4.fa.gz",
                    "p5.fq.gz")


def genome_p(rng, genome):
    """The genome with REPEAT_FAMILIES written over it at random
    non-overlapping places (length unchanged).  Returns (genome P, copy
    starts, copy lengths), the copies in genome order."""
    lens = np.array([bp for bp, n in REPEAT_FAMILIES for _ in range(n)])
    fams = [rng.integers(0, 4, bp).astype(genome.dtype)
            for bp, _ in REPEAT_FAMILIES]
    fam_of = np.repeat(np.arange(len(REPEAT_FAMILIES)),
                       [n for _, n in REPEAT_FAMILIES])
    order = rng.permutation(lens.size)
    lens, fam_of = lens[order], fam_of[order]
    gaps = np.sort(rng.integers(0, len(genome) - lens.sum() + 1, lens.size))
    starts = gaps + np.concatenate([[0], np.cumsum(lens)[:-1]])
    g = genome.copy()
    for st, f in zip(starts, fam_of):
        g[st: st + len(fams[f])] = fams[f]
    return g, starts, lens


def paired_reads(rng, genome, n):
    """n pairs of READ_LEN bp, insert INSERT +- INSERT_SD, the second mate
    reverse-complemented, 1% substitutions at quality 14 (38 elsewhere).
    Returns (pair starts, inserts, ASCII reads [2n, READ_LEN] with mates
    adjacent, ASCII quals)."""
    ins = np.clip(np.rint(rng.normal(INSERT, INSERT_SD, n)).astype(np.int64),
                  READ_LEN + 10, 1000)
    pos = rng.integers(0, len(genome) - ins + 1)
    reads = np.empty((2 * n, READ_LEN), np.int64)
    reads[0::2] = genome[pos[:, None] + np.arange(READ_LEN)]
    reads[1::2] = 3 - genome[(pos + ins - 1)[:, None] - np.arange(READ_LEN)]
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()))) % 4
    qual = np.where(err, 14 + 33, 38 + 33).astype(np.uint8)
    return pos, ins, ASCII[reads], qual


def write_pairs(path, seq, qual, ids, mate=None):
    """FASTQ of pairs `ids` (rows 2i, 2i+1 of seq/qual): both mates named
    @p<i> in turn, or with mate=1/2 that mate alone named @p<i>/<mate>."""
    rows = (np.stack([2 * ids, 2 * ids + 1], 1).ravel() if mate is None
            else 2 * ids + mate - 1)
    tail = b"" if mate is None else b"/%d" % mate
    with open(path, "wb") as f:
        for lo in range(0, len(rows), 65536):
            f.write(b"".join(
                b"@p%d%s\n%s\n+\n%s\n" % (r >> 1, tail, seq[r].tobytes(),
                                            qual[r].tobytes())
                for r in rows[lo: lo + 65536].tolist()))


def fasta_seqs(path):
    """The sequences of a FASTA file (gzipped or not), one line each."""
    lines = decompressed(path).split(b"\n")
    return [lines[i + 1] for i in range(0, len(lines) - 1, 2)
            if lines[i].startswith(b">")]


def stage_launches():
    """Wraps the pipeline driver's log so each `stage NAME` line also
    records K1's launches since the previous one; returns the dict it fills
    and a function that restores the log."""
    from fermi_tpu_torch.ops import rank_cuda
    from fermi_tpu_torch.pipeline import driver

    counts, orig = {}, driver.log
    last = [rank_cuda.LAUNCHES["rank6_fused"]]

    def log_(stage, msg):
        m = re.match(r"stage (\w+):", msg)
        if m:
            now = rank_cuda.LAUNCHES["rank6_fused"]
            counts[m.group(1)] = now - last[0]
            last[0] = now
        orig(stage, msg)

    driver.log = log_
    return counts, lambda: setattr(driver, "log", orig)


def paired_phase(rng, workdir, genome, dev, unitig_k=50):
    """Genome P, 30x of read pairs from it in two mate files, `pe2cofq` of
    them, then `run -P -t 8 -k 50` (raw reads to p5.fq.gz) on `dev`:
    seconds and K1 launches by stage, the device peak, scaf's counts, p2
    and p4 by count and N50 and the share of p4 bases in scaftigs found
    exactly in genome P; scaf must examine a gap and launch K1.  Then `run
    -P` of the pairs of a PAIRED_WINDOW bp window holding at least four
    repeat copies, on `dev` and on the CPU: every artifact equal,
    decompressed.  Returns the K1 launches of the full run and genome P."""
    from fermi_tpu_torch.algos import scaf

    t0 = time.perf_counter()
    gp, starts, lens = genome_p(rng, genome)
    pos, ins, seq, qual = paired_reads(rng, gp, N_PAIRS)
    ids = np.arange(N_PAIRS)
    r1, r2 = (os.path.join(workdir, f"r{m}.fq") for m in (1, 2))
    for mate, path in ((1, r1), (2, r2)):
        write_pairs(path, seq, qual, ids, mate)
    log("paired_data", genome_bp=len(gp), repeat_copies=int(starts.size),
        repeat_bp=int(lens.sum()), pairs=N_PAIRS,
        insert_drawn=float(ins.mean()), insert_sd_drawn=float(ins.std()),
        seconds=time.perf_counter() - t0)

    pe_fq = os.path.join(workdir, "pe.fq")
    t, _, _ = run_cli(["pe2cofq", r1, r2], pe_fq)
    n_rec = sum(1 for _ in open(pe_fq, "rb")) // 4
    if n_rec != 2 * N_PAIRS:
        raise AssertionError(f"pe2cofq wrote {n_rec} records")
    log("pe2cofq", seconds=t, records=n_rec,
        mb=os.path.getsize(pe_fq) / 2**20)
    os.remove(r1)
    os.remove(r2)

    prefix = os.path.join(workdir, "pe")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    by_stage, restore = stage_launches()
    try:
        t, _, err = run_cli(["run", "--device", str(dev), "-P", "-t", "8",
                             "-k", str(unitig_k), "-p", prefix, pe_fq])
    finally:
        restore()
    k1 = launches()["rank6_fused"]
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else 0)
    st = dict(scaf.STATS)
    if st["gaps"] < 1:
        raise AssertionError("run -P: scaf examined no gap")
    if dev.type == "cuda" and (k1 < 1 or by_stage.get("scaf", 0) < 1):
        raise AssertionError("run -P: scaf's mate walk did not launch K1")
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[pipeline::run\] stage (\w+): ([\d.]+)s", err)}
    t1 = time.perf_counter()
    p2, p4 = mag_seqs(prefix + ".p2.mag.gz"), fasta_seqs(prefix + ".p4.fa.gz")
    gidx = GenomeIndex(gp)
    p5 = decompressed(prefix + ".p5.fq.gz").count(b"\n+\n")
    insert = json.load(open(prefix + ".insert.json"))
    log("run_paired", seconds=t, stage_seconds=stages, k1_by_stage=by_stage,
        k1_launches=k1, device_peak_gb=peak, insert=insert,
        scaf_gaps=st["gaps"], scaf_assembled=st["assembled"],
        scaf_sw_joined=st["sw_joined"], scaf_sw_failed=st["sw_failed"],
        scaf_mates=st["mates"], scaf_mate_walk_s=st["mate_s"],
        scaf_gap_loop_s=st["gap_loop_s"], mini_bwts=st["mini_bwts"],
        mini_bwt_s=st["mini_bwt_s"],
        mini_bwt_ms_per_gap=1e3 * st["mini_bwt_s"] / max(st["gaps"], 1),
        gap_loop_ms_per_gap=1e3 * st["gap_loop_s"] / max(st["gaps"], 1),
        **{f"p2_{k}": v for k, v in assembly_stats(p2).items()},
        **{f"p4_{k}": v for k, v in assembly_stats(p4).items()},
        p2_exact_share=gidx.exact_share(p2),
        p4_exact_share=gidx.exact_share(p4), p5_records=p5,
        check_seconds=time.perf_counter() - t1)
    del gidx

    for first in starts:
        w = max(0, int(first) - 2000)
        inside = (starts >= w) & (starts + lens <= w + PAIRED_WINDOW)
        if inside.sum() >= 4:
            break
    else:
        raise AssertionError("no window of genome P holds 4 repeat copies")
    win = np.flatnonzero((pos >= w) & (pos + ins <= w + PAIRED_WINDOW))
    win_fq = os.path.join(workdir, "pe_window.fq")
    write_pairs(win_fq, seq, qual, win)
    secs = {}
    for d in (str(dev), "cpu"):
        secs[d], _, _ = run_cli(["run", "--device", d, "-P", "-t", "8", "-k",
                                 str(unitig_k), "-p",
                                 os.path.join(workdir, f"wpe_{d}"), win_fq])
    for sfx in PAIRED_ARTIFACTS:
        a = decompressed(os.path.join(workdir, f"wpe_{dev}.{sfx}"))
        if a != decompressed(os.path.join(workdir, f"wpe_cpu.{sfx}")):
            raise AssertionError(f"run -P: {sfx} differs card vs CPU")
    w4 = fasta_seqs(os.path.join(workdir, "wpe_cpu.p4.fa.gz"))
    log("run_paired_window", window_start=w, window_bp=PAIRED_WINDOW,
        repeat_copies=int(inside.sum()), pairs=int(win.size),
        artifacts=len(PAIRED_ARTIFACTS), equal=True, p4_scaftigs=len(w4),
        scaf_gaps=scaf.STATS["gaps"], device_seconds=secs[str(dev)],
        cpu_seconds=secs["cpu"])
    return k1, gp


def example_phase(workdir, win_fq, dev):
    """`example -e -c` (the API walk-through: correct, then a local
    assembly, cleaned) of the CROSS_WINDOW reads on `dev` and on the CPU:
    equal MAG bytes; the card's run launches K1 (the collect)."""
    outs, secs = {}, {}
    for d in (str(dev), "cpu"):
        reset_launches()
        secs[d], outs[d], _ = run_cli(["example", "--device", d, "-e", "-c",
                                       win_fq])
        if d == str(dev):
            k1 = launches()["rank6_fused"]
    if dev.type == "cuda" and k1 < 1:
        raise AssertionError("example -e did not launch K1")
    if outs[str(dev)] != outs["cpu"]:
        raise AssertionError("example -e -c differs card vs CPU")
    seqs = [ln for ln in outs["cpu"].split("\n")[1::4]]
    log("example", window_bp=CROSS_WINDOW, seconds=secs[str(dev)],
        cpu_seconds=secs["cpu"], k1_launches=k1, equal=True,
        **assembly_stats(seqs))
    return k1



# -- slice 8: the dp×tp layer on torch.distributed, ropebwt ---------------


N_DIST_QUERIES = 2048           # `exact` queries of the sharded SMEM
LANES_STEP = 2048               # lanes of an SMEM loop step (smem.LANES)
DIST_TIMEOUT_S = 300            # bound on every collective and rank


def digest(a):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def rank_counters():
    """This process's K1 launches and tp all-reduces to 0."""
    from fermi_tpu_torch.dist import sharded as sh

    reset_launches()
    sh.STATS.update(all_reduce=0, all_reduce_s=0.0)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def rank_line(dev, t0, k1):
    """A rank's seconds, K1 launches, all-reduces and device peak."""
    from fermi_tpu_torch.dist import sharded as sh

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
    n = sh.STATS["all_reduce"]
    return dict(seconds=time.perf_counter() - t0, k1_launches=k1,
                all_reduce=n,
                ms_per_all_reduce=(sh.STATS["all_reduce_s"] / n * 1e3
                                   if n else None),
                device_peak_gb=(torch.cuda.max_memory_allocated(dev) / 2**30
                                if on_card else 0.0))


def dist_rank(rank, world, init_method, device, fmd, queries, parts):
    """One of the two ranks of [dist] (a) and (c), both on `device` (the
    one card: over gloo): (a) tp=2, the whole .fmd restored on the host,
    the rank's half of the rank rows on the card, ShardedSMEM of the
    queries; (c) dp=2, fm_merge_sharded of two parts restored on the
    card."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.dist import sharded as sh
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import smem as sm

    dev = sh.init_ranks(rank, world, init_method, device, DIST_TIMEOUT_S)
    out = {}
    rank_counters()
    reset_peak(dev)
    t0 = time.perf_counter()
    index = FMDIndex.restore(fmd, "cpu")
    restore_s = time.perf_counter() - t0
    eng = sh.ShardedSMEM(index, sh.make_mesh(dp=1, tp=2, device=dev))
    t1 = time.perf_counter()
    smems = eng.smem_all(queries)
    out["smem"] = dict(
        backend=eng.mesh.backend, host_restore_s=restore_s,
        smem_s=time.perf_counter() - t1, redo_reads=sm.STATS["redo"],
        shard_rows=eng.view.packed_l.shape[0],
        **rank_line(dev, t0, launches()["rank6_fused"]))
    del eng, index
    rank_counters()
    reset_peak(dev)
    t0 = time.perf_counter()
    mesh = sh.make_mesh(dp=2, tp=1, device=dev)
    bwts = [rld.read_fmd(p).expand() for p in parts]
    e0, e1 = (FMDIndex.from_bwt(b, dev) for b in bwts)
    t1 = time.perf_counter()
    merged = sh.fm_merge_sharded(e0, bwts[0], e1, bwts[1], mesh)
    out["merge"] = dict(backend=mesh.backend,
                        merge_s=time.perf_counter() - t1,
                        **rank_line(dev, t0, launches()["rank6_fused"]))
    out["smem_result"] = smems if rank == 0 else None
    out["merge_digest"] = digest(merged)
    out["all_reduce_step_ms"] = all_reduce_ms(dev, mesh.group)
    return out


def all_reduce_ms(dev, group, reps=10):
    """ms of one all-reduce of a loop step's rank partials (2,048 lanes x
    64 keys x 6 int32) over `group`: on tensors on `dev` (what the tp view
    does) and on host tensors."""
    import torch.distributed as tdist

    out = {}
    for where in (dev, torch.device("cpu")):
        x = torch.ones((LANES_STEP * 64, 6), dtype=torch.int32, device=where)
        tdist.all_reduce(x, group=group)
        if where.type == "cuda":
            torch.cuda.synchronize(where)
        t0 = time.perf_counter()
        for _ in range(reps):
            tdist.all_reduce(x, group=group)
        if where.type == "cuda":
            torch.cuda.synchronize(where)
        out[where.type] = (time.perf_counter() - t0) / reps * 1e3
    return out


def dist_phase(rng, workdir, fmd, q_fa, dev):
    """The dp×tp layer on the card at the cell's size: (a) two ranks on
    cuda:0 over gloo, the main path's index split tp=2, ShardedSMEM of the
    first N_DIST_QUERIES `exact` queries, equal to the single-process
    port's smem_all; (b) the same queries through a world of one over
    NCCL; (c) dp=2, fm_merge_sharded of two of the four parts of
    merge_phase (chosen by rng), byte-equal to the port's fm_merge; (d)
    dryrun_multichip(4) on the card.  Every rank must launch K1.  Returns
    the K1 launches of every rank."""
    import torch.distributed as tdist

    from fermi_tpu_torch import rld
    from fermi_tpu_torch.algos import merge as mg
    from fermi_tpu_torch.dist import sharded as sh
    from fermi_tpu_torch.dist.launch import spawn_ranks
    from fermi_tpu_torch.graft_entry import dryrun_multichip
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import smem as sm

    t_phase = time.perf_counter()
    queries = exact_batch(q_fa, lo=0, n=N_DIST_QUERIES)
    parts = [os.path.join(workdir, f"part{i}.fmd")
             for i in sorted(rng.choice(4, 2, replace=False))]
    # the single-process port, and (b) a world of one over NCCL
    gidx = FMDIndex.restore(fmd, dev)
    t0 = time.perf_counter()
    want = sm.smem_all(gidx, queries)
    single_s = rank_line(dev, t0, 0)["seconds"]
    rank_counters()
    reset_peak(dev)
    t0 = time.perf_counter()
    sh.init_ranks(0, 1, "file://" + os.path.join(workdir, "nccl_init"),
                  str(dev), DIST_TIMEOUT_S)
    try:
        mesh = sh.make_mesh(device=dev)
        got1 = sh.ShardedSMEM(gidx, mesh).smem_all(queries)
        nccl = dict(backend=mesh.backend,
                    **rank_line(dev, t0, launches()["rank6_fused"]))
    finally:
        tdist.destroy_process_group()
    del gidx
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if got1 != want:
        raise AssertionError("ShardedSMEM over NCCL (world 1) != smem_all")
    # (a) and (c): two ranks sharing the card
    t0 = time.perf_counter()
    ranks = spawn_ranks(dist_rank, 2, (str(dev), fmd, queries, parts),
                        DIST_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    bwts = [rld.read_fmd(p).expand() for p in parts]
    e0, e1 = (FMDIndex.from_bwt(b, dev) for b in bwts)
    t0 = time.perf_counter()
    merged = mg.fm_merge(e0, bwts[0], e1, bwts[1])
    merge_single_s = rank_line(dev, t0, 0)["seconds"]
    del e0, e1
    # (d)
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device=dev)
    dry_s = time.perf_counter() - t0
    k1 = ([nccl["k1_launches"]]
          + [r[p]["k1_launches"] for r in ranks for p in ("smem", "merge")]
          + [r["k1_launches"] for r in dry])
    smem_ok = ranks[0]["smem_result"] == want
    merge_ok = all(r["merge_digest"] == digest(merged) for r in ranks)
    for r in ranks:
        r.pop("smem_result")
    log("dist", queries=len(queries), parts=parts, smems=sum(map(len, want)),
        single_smem_s=single_s, nccl_world1=nccl,
        tp2_smem=[r["smem"] for r in ranks],
        dp2_merge=[r["merge"] for r in ranks], spawn_and_ranks_s=ranks_s,
        all_reduce_step_ms=[r["all_reduce_step_ms"] for r in ranks],
        merge_msym=len(merged) / 1e6, single_merge_s=merge_single_s,
        dryrun4=dry, dryrun4_s=dry_s, smem_equal=smem_ok,
        merge_equal=merge_ok, phase_seconds=time.perf_counter() - t_phase)
    if not (smem_ok and merge_ok):
        raise AssertionError(f"sharded SMEM equal {smem_ok}, sharded merge "
                             f"equal {merge_ok}")
    if dev.type == "cuda" and min(k1) < 1:
        raise AssertionError(f"a rank launched no K1: {k1}")
    return sum(k1)


def ropebwt_phase(workdir, win_fq, dev):
    """`ropebwt -a bpr|bcr|sais` of the CROSS_WINDOW reads, text and -b, on
    `dev` (bpr is host code): the three engines' outputs equal in each
    format, and the device engines' -b equal to theirs on the CPU."""
    t_phase = time.perf_counter()
    outs, secs = {}, {}
    for algo in ("bpr", "bcr", "sais"):
        for fmt in ("text", "rle6"):
            o = os.path.join(workdir, f"rope_{algo}_{fmt}")
            secs[f"{algo}_{fmt}"] = run_cli(
                ["ropebwt", "-a", algo, "--device", str(dev),
                 *(["-b"] if fmt == "rle6" else []), "-o", o, win_fq])[0]
            with open(o, "rb") as f:
                outs[algo, fmt] = f.read()
    for algo in ("bcr", "sais"):
        o = os.path.join(workdir, f"rope_{algo}_cpu")
        secs[f"{algo}_rle6_cpu"] = run_cli(
            ["ropebwt", "-a", algo, "--device", "cpu", "-b", "-o", o,
             win_fq])[0]
        with open(o, "rb") as f:
            outs[algo, "cpu"] = f.read()
    same = {fmt: len({outs[a, fmt] for a in ("bpr", "bcr", "sais")}) == 1
            for fmt in ("text", "rle6")}
    same["cpu"] = all(outs[a, "cpu"] == outs["bpr", "rle6"]
                      for a in ("bcr", "sais"))
    log("ropebwt", window_bp=CROSS_WINDOW,
        msym=(len(outs["bpr", "text"]) - 1) / 1e6,
        rle6_bytes=len(outs["bpr", "rle6"]), seconds=secs, equal=same,
        phase_seconds=time.perf_counter() - t_phase)
    if not all(same.values()):
        raise AssertionError(f"ropebwt engines differ: {same}")


# slice 9: `-M`, out of core on the host
N_OOC_QUERIES = 4096            # `exact` queries searched with and without -M
OOC_THREADS = 8                 # -t of ensure_blk, seqsort, correct, unitig
ROOT = os.path.dirname(os.path.abspath(__file__))
# The child samples its own resident set (/proc/self/statm) every 5 ms:
# ru_maxrss would carry the parent's peak over the fork and exec, and not
# every /proc has VmHWM.  The baseline child only imports the CLI.
RSS_CHILD = """
import os, sys, threading, time
from fermi_tpu_torch.cli.main import main
peak = [-1]
def sample():
    page = os.sysconf("SC_PAGE_SIZE")
    while True:
        try:
            with open("/proc/self/statm") as f:
                peak[0] = max(peak[0], int(f.read().split()[1]) * page)
        except OSError:
            return
        time.sleep(0.005)
threading.Thread(target=sample, daemon=True).start()
time.sleep(0.02)
rc = 0
if sys.argv[1] != "-":
    with open(sys.argv[1], "w") as out:
        sys.stdout = out
        rc = main(sys.argv[2:])
        out.flush()
time.sleep(0.02)
sys.stderr.write("peak_rss_kib %d\\n" % (peak[0] >> 10))
sys.exit(rc)
"""


def child_maxrss(argv, out_path):
    """One CLI call (none with out_path "-") in a child process of its
    own: (seconds, its peak resident set in KiB or a negative number when
    /proc cannot tell, its stdout)."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", RSS_CHILD, out_path, *argv],
                       capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    t = time.perf_counter() - t0
    if p.returncode != 0:
        raise RuntimeError(f"child {' '.join(argv)} exited {p.returncode}: "
                           f"{p.stderr[-500:]}")
    rss = int(re.search(r"peak_rss_kib (-?\d+)", p.stderr).group(1))
    if out_path == "-":
        return t, rss, None
    with open(out_path) as f:
        return t, rss, f.read()


def host_only(name, fn):
    """fn() must run on the host alone: no kernel launched, nothing
    allocated on the card.  Returns fn()'s result and its seconds."""
    reset_launches()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    t = time.perf_counter() - t0
    used = torch.cuda.max_memory_allocated() - before
    if any(launches().values()) or used > 0:
        raise AssertionError(f"{name} touched the card: {launches()}, "
                             f"{used} bytes")
    return out, t


def mag_ends_mass(path):
    """The unitig end ids and the total bp of a MAG file."""
    lines = decompressed(path).split(b"\n")
    ends = [x for i in range(0, len(lines) - 1, 4)
            if lines[i].startswith(b"@")
            for x in lines[i][1:].split(b"\t")[0].split(b":")]
    return ends, sum(len(x) for x in mag_seqs(path))


def outofcore_phase(workdir, dev, res, ec_res, ss, ut, win, rp):
    """`-M` on the host, over the files of the earlier phases, each call
    held to launch no kernel and allocate nothing on the card: the record
    cache of the main path's index; `exact -M` of the first N_OOC_QUERIES
    queries equal to the card's `exact` of them, with each call's peak RSS
    in a child process; `unpack -M` of [unpack]'s ids; `seqsort -M`,
    `correct -M` of the fix rerun's reads and `unitig -M -r` (one thread on
    the window, OOC_THREADS on the corrected index under the threaded
    contract against [unitig]'s p0); `chkbwt -M -r` of the index and of a
    corrupted copy; `remap -M -r` of the pairs window; fm_append_streaming
    of the last part onto the merge of the others, equal to `build` of all
    the reads."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.algos.merge import fm_append_streaming
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.construct import suffix
    from fermi_tpu_torch.core import dna, fastx
    from fermi_tpu_torch.index.blkidx import ensure_blk
    from fermi_tpu_torch.index.mmapfmd import MmapIndex

    t_phase = time.perf_counter()
    fmd, t_ = res["fmd"], str(OOC_THREADS)
    out, secs, eq = {}, {}, {}
    n_sym = MmapIndex(fmd).total
    blk, secs["ensure_blk"] = host_only(
        "ensure_blk", lambda: ensure_blk(fmd, n_threads=OOC_THREADS))
    size = os.path.getsize(blk.path)
    if blk.total != n_sym or size != 4096 + 192 * blk.n_rows:
        raise AssertionError(f"record cache: {blk.total} symbols, {size} B")
    out.update(blk_rows=blk.n_rows, blk_gb=size / 1e9, blk_wide=blk.wide)

    # exact: the card's and -M's bytes, reads/s and each call's peak RSS
    q_fa = os.path.join(workdir, "q_ooc.fa")
    with open(res["q_fa"]) as f, open(q_fa, "w") as g:
        g.writelines(f.readlines()[: 2 * N_OOC_QUERIES])
    secs["exact_card"], card, _ = run_cli(["exact", "--device", str(dev),
                                           fmd, q_fa])
    (secs["exact_M"], text, _), _ = host_only(
        "exact -M", lambda: run_cli(["exact", "-M", fmd, q_fa]))
    eq["exact"] = text == card and text.count("SQ\t") == N_OOC_QUERIES
    rss = {"import": child_maxrss([], "-")[1]}
    for key, argv in (("M", ["exact", "-M", fmd, q_fa]),
                      ("card", ["exact", "--device", str(dev), fmd, q_fa])):
        secs[f"exact_{key}_child"], rss[key], child_text = child_maxrss(
            argv, os.path.join(workdir, f"exact_{key}.txt"))
        eq[f"exact_{key}_child"] = child_text == card
    out.update(exact_reads_per_s_card=N_OOC_QUERIES / secs["exact_card"],
               exact_reads_per_s_M=N_OOC_QUERIES / secs["exact_M"],
               **{f"peak_rss_gib_{k}": v / 2**20 for k, v in rss.items()})

    # unpack of [unpack]'s ids
    ids = [a for x in res["unpack_ids"] for a in ("-i", str(x))]
    (secs["unpack_M"], text, _), _ = host_only(
        "unpack -M", lambda: run_cli(["unpack", "-M", *ids, fmd]))
    eq["unpack"] = text == res["unpack_text"]

    # seqsort of the corrected index: [seqsort]'s .rank
    rank_m = os.path.join(workdir, "ec_M.rank")
    (secs["seqsort_M"], _, _), _ = host_only("seqsort -M", lambda: run_cli(
        ["seqsort", "-M", "-t", t_, ss["fmd"]], rank_m))
    eq["seqsort"] = same_bytes(rank_m, ss["rank"])

    # correct of the fix rerun's reads: the card's correct of them
    sub_m = os.path.join(workdir, "sub_M.fq")
    (secs["correct_M"], _, _), _ = host_only("correct -M", lambda: run_cli(
        ["correct", "-M", "-t", t_, ec_res["fmd"], ec_res["sub_fq"]], sub_m))
    eq["correct"] = same_bytes(sub_m, ec_res["sub_out"])

    # unitig: one thread on the window (the card's bytes), then
    # OOC_THREADS on the corrected index (the reference's -t N contract
    # against [unitig]'s p0: unique end ids, mass within 2%)
    win_fmd, win_rank, win_text = win
    (secs["unitig_window_M"], text, _), _ = host_only(
        "unitig -M -t 1", lambda: run_cli(
            ["unitig", "-M", "-t", "1", "-l", "50", "-r", win_rank,
             win_fmd]))
    eq["unitig_window"] = text == win_text
    p0_m = os.path.join(workdir, "p0_M.mag")
    (secs["unitig_M"], _, _), _ = host_only("unitig -M -t N", lambda: run_cli(
        ["unitig", "-M", "-t", t_, "-l", "50", "-r", ss["rank"], ss["fmd"]],
        p0_m))
    ends, mass = mag_ends_mass(p0_m)
    _, mass_p0 = mag_ends_mass(ut["p0"])
    eq["unitig_unique_ends"] = len(ends) == len(set(ends))
    eq["unitig_mass_2pct"] = abs(mass - mass_p0) <= 0.02 * mass_p0
    out.update(unitig_mass_M=mass, unitig_mass_p0=mass_p0,
               unitigs_M=len(ends) // 2)

    # chkbwt -r of the index (passes), then of a corrupted copy
    (secs["chkbwt_M"], _, err), _ = host_only(
        "chkbwt -M -r", lambda: run_cli(["chkbwt", "-M", "-r", fmd]))
    eq["chkbwt_passes"] = "rank check passed" in err
    bad = os.path.join(workdir, "bad_M.fmd")
    at = corrupt_copy(fmd, bad)
    same_len = int(rld.read_fmd(bad).lengths.sum()) == n_sym
    e = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(e):
        try:
            outcome = main(["chkbwt", "-M", "-r", bad])
        except OSError as x:
            outcome = f"OSError: {x}"
    secs["chkbwt_M_corrupted"] = time.perf_counter() - t0
    msg = [ln for ln in e.getvalue().splitlines() if "::chkbwt]" in ln]
    # a copy whose BWT keeps its length must fail; one whose runs hold
    # another length may pass, as in fermi_tpu (fault F4)
    if same_len:
        eq["chkbwt_corrupted_fails"] = outcome == 1
    for p in (bad, bad + ".blk"):
        if os.path.exists(p):
            os.remove(p)
    out.update(corrupted_byte=at, corrupted_same_length=same_len,
               corrupted_outcome=outcome, corrupted_messages=msg[-2:])

    # remap of the pairs window
    (secs["remap_M"], text, _), _ = host_only("remap -M", lambda: run_cli(
        ["remap", "-M", "-r", rp["rank"], rp["fmd"], rp["ctg"]]))
    eq["remap"] = text == rp["text"]

    # streaming append of the last part onto the merge of the others
    part = os.path.join(workdir, "part3.fa")
    text4 = suffix.build_text([dna.encode(r.seq)
                               for r in fastx.read_fastx(part)])
    app = os.path.join(workdir, "appended_stream.fmd")
    t0 = time.perf_counter()
    fm_append_streaming(os.path.join(workdir, "merged_head.fmd"), text4, app,
                        n_threads=OOC_THREADS, device=dev)
    secs["append_streaming"] = time.perf_counter() - t0
    eq["append_streaming"] = same_bytes(app, fmd)

    log("outofcore", msym=n_sym / 1e6, threads=OOC_THREADS,
        queries=N_OOC_QUERIES, **out, seconds=secs, equal=eq,
        phase_seconds=time.perf_counter() - t_phase)
    if not all(eq.values()):
        raise AssertionError(f"-M differs: {eq}")


# slice 11: reads past 1 kbp, of genome P
LONG_GENOME = 500_000           # genome-P bp read (a cut: PERF.md §4)
LONG_COVERAGE = 20              # PacBio-CCS-like reads of that stretch
LONG_LEN = (1000, 8000)         # read lengths, uniform, bp
LONG_ERR = 0.001                # substitutions
LONG_MIN_MATCH = 100            # unitig -l
N_LONG_MATES = 4096             # reads walked by retrieve_mates


def long_reads(rng, genome, path):
    """LONG_COVERAGE x of reads of `genome` (nt4 codes), lengths uniform in
    LONG_LEN, LONG_ERR substitutions, half reverse-complemented, as FASTA
    records >r0, >r1, ...  Returns the read lengths."""
    n = int(len(genome) * LONG_COVERAGE * 2 // sum(LONG_LEN))
    lens = rng.integers(LONG_LEN[0], LONG_LEN[1] + 1, n)
    pos = rng.integers(0, len(genome) - lens + 1)
    flip = rng.random(n) < 0.5
    with open(path, "wb") as f:
        for i in range(n):
            r = genome[pos[i]: pos[i] + lens[i]].astype(np.int64)
            err = np.flatnonzero(rng.random(lens[i]) < LONG_ERR)
            r[err] = (r[err] + rng.integers(1, 4, err.size)) % 4
            if flip[i]:
                r = 3 - r[::-1]
            f.write(b">r%d\n%s\n" % (i, ASCII[r].tobytes()))
    return lens


def blk_retrieve(blk, ids):
    """The reads whose sentinels have ranks `ids`, forward, by LF walks on
    the host over the .fmd.blk record cache (numpy over its mapped records,
    no kernel and no torch): the oracle of the card's walks."""
    wide = 256 if blk.wide else 192
    raw = np.memmap(blk.path, np.uint8, "r", offset=4096)
    raw = raw.reshape(blk.n_rows, wide)
    odt = np.uint64 if blk.wide else np.uint32
    cnt = np.asarray(blk.cnt, np.int64)
    k = np.asarray(ids, np.int64).copy()
    lane = np.arange(k.size)
    col = np.arange(128)
    walked_lane, walked_sym = [], []
    while lane.size:
        rows = raw[k >> 7]
        off = k & 127
        c = rows[np.arange(lane.size), off].astype(np.int64)
        occ = rows[:, 128: 128 + 6 * odt().itemsize].copy().view(odt)
        within = ((rows[:, :128] == c[:, None]) & (col < off[:, None])).sum(1)
        kp = cnt[c] + occ[np.arange(lane.size), c].astype(np.int64) + within
        go = c != 0
        walked_lane.append(lane[go])
        walked_sym.append(c[go])
        k, lane = kp[go], lane[go]
    lanes = np.concatenate(walked_lane) if walked_lane else np.zeros(0, int)
    syms = np.concatenate(walked_sym) if walked_sym else np.zeros(0, int)
    order = np.argsort(lanes, kind="stable")
    parts = np.split(syms[order].astype(np.uint8),
                     np.cumsum(np.bincount(lanes, minlength=len(ids)))[:-1])
    return [p[::-1] for p in parts]


def long_reads_phase(rng, workdir, gp, dev, min_match=LONG_MIN_MATCH):
    """Reads past 1 kbp through the port on `dev`: LONG_COVERAGE x of reads
    of 1-8 kbp of genome P's first LONG_GENOME bp, `build`, `seqsort`
    (walks of up to 8 kbp, past fermi_tpu's device walk's 4,096 steps)
    equal to the host engine
    `seqsort_native` over the record cache, `unitig -l 100 -r` (link
    records of reads past the 10-bit key's 1,023 bp, the card's route)
    equal to the native host walk `fm6_unitig_native(..., 1)`, with N50 and
    the share of unitig bases found exactly in genome P, and
    `retrieve_mates` of N_LONG_MATES reads (walks past the first bound of
    1,024, the bound doubling) equal to the host walk of the .fmd.blk
    record cache.
    Seconds and K1 launches by call, the longest walk, the device peak.
    Every equality is a gate.  Returns K1's launches."""
    from concurrent.futures import ThreadPoolExecutor

    from fermi_tpu_torch.algos.scaf import retrieve_mates
    from fermi_tpu_torch.algos.seqsort import seqsort_native
    from fermi_tpu_torch.algos.unitig import fm6_unitig_native
    from fermi_tpu_torch.index.blkidx import ensure_blk
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import unitig_links as ul

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    gp = gp[:LONG_GENOME]
    wd = os.path.join(workdir, "long")
    os.makedirs(wd)
    secs, k1 = {}, {}
    fa, fmd = os.path.join(wd, "long.fa"), os.path.join(wd, "long.fmd")
    rank, mag = os.path.join(wd, "long.rank"), os.path.join(wd, "long.mag")
    t0 = time.perf_counter()
    lens = long_reads(rng, gp, fa)
    secs["data"] = time.perf_counter() - t0
    dv = ["--device", str(dev)]
    reset_peak(dev)

    def card_call(name, argv, out_path=None):
        reset_launches()
        secs[name], text, _ = run_cli(argv, out_path)
        k1[name] = launches()["rank6_fused"]
        return text
    card_call("build", ["build", *dv, "-fo", fmd, fa])
    card_call("seqsort", ["seqsort", *dv, fmd], rank)
    blk, secs["ensure_blk"] = host_only(
        "ensure_blk", lambda: ensure_blk(fmd, n_threads=OOC_THREADS))
    want_rank, secs["seqsort_native"] = host_only(
        "seqsort_native", lambda: seqsort_native(blk, OOC_THREADS, False))
    if not np.array_equal(np.fromfile(rank, np.uint64), want_rank):
        raise AssertionError("long reads: seqsort != seqsort_native")
    # the oracle's one-thread walk runs beside the card's call (ctypes
    # lets go of the interpreter lock)
    with ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        oracle = pool.submit(fm6_unitig_native, blk, min_match, want_rank,
                             1)
        oracle.add_done_callback(lambda _: secs.__setitem__(
            "unitig_native", time.perf_counter() - t0))
        card_call("unitig", ["unitig", *dv, "-l", str(min_match), "-r",
                             rank, fmd], mag)
        st = dict(ul.STATS)
        want_mag = oracle.result()
    with open(mag) as f:
        if f.read() != want_mag:
            raise AssertionError("long reads: unitig != fm6_unitig_native")
    del want_mag
    t0 = time.perf_counter()
    utg = mag_seqs(mag)
    share = GenomeIndex(gp).exact_share(utg)
    secs["unitig_check"] = time.perf_counter() - t0

    idx = FMDIndex.restore(fmd, dev)
    ids = np.sort(rng.choice(idx.n_seqs, min(N_LONG_MATES, idx.n_seqs),
                             replace=False))
    ids = ids.tolist()
    reset_launches()
    t0 = time.perf_counter()
    mates = retrieve_mates(idx, ids)
    if on_card:
        torch.cuda.synchronize(dev)
    secs["mates"] = time.perf_counter() - t0
    k1["mates"] = launches()["rank6_fused"]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0
    del idx
    host, secs["mates_host"] = host_only(
        "blk retrieve", lambda: blk_retrieve(blk, ids))
    if any(mates[x] != s.tobytes() for x, s in zip(ids, host)):
        raise AssertionError("long reads: retrieve_mates != the host walk")
    if on_card and min(k1[n] for n in ("seqsort", "unitig", "mates")) < 1:
        raise AssertionError(f"long reads: a walk launched no K1: {k1}")
    longest = max(len(s) for s in mates.values())
    shutil.rmtree(wd)
    log("long_reads", reads=int(lens.size), genome_bp=len(gp),
        read_bp_min=int(lens.min()), read_bp_max=int(lens.max()),
        read_bp_mean=float(lens.mean()), symbols=int(blk.total),
        seconds=secs, k1_launches=k1, unitig_route="card",
        seqsort_walk_steps=int(lens.max()) + 1,
        mate_walk_steps=longest + 1, mates=len(ids),
        unitig_walk_rounds=st["walk_rounds"],
        unitig_get_nei_rounds=st["getnei_rounds"],
        unitig_ladder_rows=st["ladder_rows"],
        unitig_redo_left=st["redo_left"], unitig_unique=st["unique"],
        **{f"unitig_{k}": st[k] for k in ("retrieve_s", "walk_s", "getnei_s",
                                          "ladder_s", "stitch_s")},
        **{f"p0_{k}": v for k, v in assembly_stats(utg).items()},
        p0_exact_share=share, seqsort_equal=True, unitig_equal=True,
        mates_equal=True, device_peak_gb=peak,
        phase_seconds=time.perf_counter() - t_phase)
    return sum(k1.values())


# slice 10: the wide index tier at the size of fermi_tpu's own 2.26 Gsym
# run (scripts/uint32_run.py, whose data is scripts/scale_bench.py make_pe)
WIDE_PAIRS = 5_600_000          # 2 x 100 bp pairs: 11.2 M reads, 25x of
WIDE_COVERAGE = 25              # a random 44.8 Mbp genome
WIDE_INSERT, WIDE_INSERT_SD = 300, 30
WIDE_ERR = 0.005                # substitutions, quality 15 (38 elsewhere)
WIDE_CHUNK = 1 << 19            # pairs drawn and written at a time
WIDE_QUERIES = 20_000           # matched `exact` reads, 1% fresh substitutions
WIDE_PROFILED = 4096            # of them, the batch of k1_stream and profile
WIDE_SPOTS = 64                 # rank6 positions checked by a host scan
WIDE_MIN_SYMBOLS = 2**31        # the index must reach the int64 domain
HUGE_MIN_SYMBOLS = 2**32        # the merged index must pass 2^32
HUGE_QUERIES = 4096             # of the wide queries, searched in [huge]


def wide_reads(rng, path, n_pairs):
    """make_pe's data, drawn here: a random genome of 2 * n_pairs * 100 /
    25 bp, pairs at an insert of 300 +- 30 (clipped to [110, 420]), the
    second mate reverse-complemented, 0.5% substitutions, as plain 4-line
    FASTQ with both mates of pair i named @p<i> (nine digits).  Returns the
    reads as nt4 codes [2 * n_pairs, READ_LEN], in file order."""
    rl = READ_LEN
    glen = 2 * n_pairs * rl // WIDE_COVERAGE
    top = WIDE_INSERT + 4 * WIDE_INSERT_SD
    genome = rng.integers(0, 4, glen + top, dtype=np.int8)
    windows = np.lib.stride_tricks.sliding_window_view(genome, rl)
    reads = np.empty((2 * n_pairs, rl), np.uint8)
    width = 12 + 2 * (rl + 1) + 2          # header, seq, "+", qual
    with open(path, "wb") as f:
        for lo in range(0, n_pairs, WIDE_CHUNK):
            m = min(WIDE_CHUNK, n_pairs - lo)
            ins = np.clip(rng.normal(WIDE_INSERT, WIDE_INSERT_SD, m)
                          .astype(np.int64), rl + 10, top)
            pos = rng.integers(0, glen, m)
            r = reads[2 * lo: 2 * (lo + m)]
            r[0::2] = windows[pos]
            r[1::2] = 3 - windows[pos + ins - rl][:, ::-1]
            nerr = rng.binomial(rl, WIDE_ERR, 2 * m)
            rows = np.repeat(np.arange(2 * m), nerr)
            at = rng.integers(0, rl, rows.size)
            r[rows, at] = (r[rows, at] + rng.integers(1, 4, rows.size)) % 4
            rec = np.empty((2 * m, width), np.uint8)
            rec[:, :2] = np.frombuffer(b"@p", np.uint8)
            ids = np.repeat(np.arange(lo, lo + m), 2)
            for d in range(9):
                rec[:, 2 + d] = 48 + ids // 10 ** (8 - d) % 10
            rec[:, 11] = 10
            rec[:, 12: 12 + rl] = ASCII[r]
            rec[:, 12 + rl: 15 + rl] = np.frombuffer(b"\n+\n", np.uint8)
            qual = rec[:, 15 + rl: 15 + 2 * rl]
            qual[:] = 38 + 33
            qual[rows, at] = 15 + 33
            rec[:, -1] = 10
            rec.tofile(f)
    return reads


def host_peak_gib():
    """This process's peak resident set so far (getrusage), GiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def host_rank_scan(flat, ks):
    """rank6 of the BWT `flat` at each of the sorted positions ks, by a
    running bincount on the host (no K1)."""
    scan = np.zeros((len(ks), 6), np.int64)
    acc = np.zeros(6, np.int64)
    prev = 0
    for t, k in enumerate(ks):
        # 1 Mi-symbol slices: bincount's int64 copy of each stays in cache
        for a in range(prev, k, 1 << 20):
            acc += np.bincount(flat[a: min(k, a + (1 << 20))],
                               minlength=6)[:6]
        scan[t] = acc
        prev = k
    return scan


def wide_phase(rng, workdir, dev, maxi, clock_hz, n_pairs=WIDE_PAIRS):
    """The wide index tier end to end: 2 x n_pairs reads written as FASTQ,
    the driver's raw_fmd stage on `dev` (native encoders, the text, the
    blocked builder past 2^31 symbols, RLE and dump on the host), the index
    restored once (int64 domain, fused rows), then over it: `chkbwt -r`
    (its command's check_ranks), rank6 at WIDE_SPOTS positions against a
    host bincount scan, `exact` of WIDE_QUERIES matched reads on the card
    byte-equal to the native engine over the same index's host arrays and
    to the CLI's `exact -M` over the .fmd.blk record cache, and `unpack` of
    N_UNPACK ids against the reads.  Every step is a gate.  Then K1 timed
    at the main path's shape on the wide rows, and one WIDE_PROFILED batch
    through k1_stream and profile_exact for ROADMAP item 3a's rule.
    Last, before the files go, huge_phase over raw.fmd.  Returns K1's
    launches on the paths: rank6_fused's (the wide index's queries and the
    merge's gap walk), rank_block_counts' (the merged index's queries)."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.cli.main import (CHKBWT_CHUNK, check_ranks,
                                          write_exact)
    from fermi_tpu_torch.construct import blocked
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.index.blkidx import ensure_blk
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.pipeline import driver
    from fermi_tpu_torch.search import extend as se
    from fermi_tpu_torch.search import smem as sm

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    wd = os.path.join(workdir, "wide")
    os.makedirs(wd)
    secs, out = {}, {"host_peak_gib_before": host_peak_gib()}
    fq = os.path.join(wd, "pairs.fq")
    t0 = time.perf_counter()
    reads = wide_reads(rng, fq, n_pairs)
    secs["data"] = time.perf_counter() - t0
    out["fastq_gb"] = os.path.getsize(fq) / 1e9
    pick = rng.integers(0, len(reads), WIDE_QUERIES)
    q = reads[pick]
    err = rng.random(q.shape) < 0.01
    q[err] = (q[err] + rng.integers(1, 4, int(err.sum()))) % 4
    q_fa = os.path.join(wd, "q.fa")
    write_fasta(q_fa, ASCII[q])
    del q, err

    # the path: the driver's raw_fmd stage, one restore, the queries
    reset_launches()
    torch.cuda.empty_cache()
    peak = {}                            # device peak by part, GB
    pl = driver.Pipeline(os.path.join(wd, "w"), n_threads=8, device=dev)
    with contextlib.redirect_stderr(io.StringIO()):
        _, secs["raw_fmd"], peak["build"] = timed(
            dev, lambda: pl.stage_raw_fmd([fq]))
    fmd = pl._p("raw.fmd")
    del pl
    os.remove(fq)
    b = driver.BUILD_STATS
    secs.update({k[:-2]: b[k] for k in ("frags_s", "text_s", "bwt_s",
                                        "rle_s", "dump_s")})
    secs.update(blocked_sort=blocked.STATS["sort_s"],
                blocked_merge=blocked.STATS["merge_s"])
    out.update(symbols=b["symbols"], fragments=b["fragments"],
               blocks=blocked.STATS["blocks"],
               merge_steps=blocked.STATS["merge_steps"],
               fmd_gb=os.path.getsize(fmd) / 1e9,
               host_peak_gib_build=host_peak_gib())
    if b["symbols"] != 2 * len(reads) * (READ_LEN + 1):
        raise AssertionError(f"the wide index holds {b['symbols']} symbols")
    if blocked.STATS["blocks"] < 2:
        raise AssertionError("the wide build did not take the blocked path")

    def restore():
        runs = rld.read_fmd(fmd)
        return runs.mcnt.copy(), len(runs.lengths), FMDIndex.from_runs(
            runs, dev)
    (mcnt, out["runs"], idx), secs["restore"], peak["restore"] = timed(
        dev, restore)
    occ_max = int(idx.occ[-1, :6].max())
    out.update(idtype=str(idx.idtype), fused=idx.fused is not None,
               cnt_top=int(idx.cnt[5]), occ_max=occ_max,
               host_peak_gib_restore=host_peak_gib())
    if (idx.total < WIDE_MIN_SYMBOLS or idx.idtype != torch.int64
            or idx.fused is None or idx.total >= 2**32 - 128):
        raise AssertionError(f"wide index: {idx.total} symbols, "
                             f"{idx.idtype}, fused {idx.fused is not None}")

    # chkbwt -r: K1 at every position against a running count
    e = io.StringIO()
    with contextlib.redirect_stderr(e):
        rc, secs["chkbwt"], peak["chkbwt"] = timed(
            dev, lambda: check_ranks(idx, mcnt))
    if rc or "rank check passed" not in e.getvalue():
        raise AssertionError(f"chkbwt -r of the wide index: {e.getvalue()}")
    out["chkbwt_chunks"] = -(-idx.total // CHKBWT_CHUNK)

    # rank6 at sampled positions, half of them past 2^31, against a host
    # scan of the BWT that does not use K1
    t0 = time.perf_counter()
    blocks_h = sm._native_index_arrays(idx)[0]
    flat = blocks_h.reshape(-1)[: idx.total]
    lo_k = min(WIDE_MIN_SYMBOLS, idx.total)
    ks = np.sort(np.concatenate([
        rng.integers(0, idx.total + 1, WIDE_SPOTS // 2),
        rng.integers(lo_k, idx.total + 1, WIDE_SPOTS - WIDE_SPOTS // 2)]))
    got = idx.rank6(torch.from_numpy(ks).to(dev)).cpu().numpy()
    scan = host_rank_scan(flat, ks)
    spots_ok = int((got == scan).all(1).sum())
    secs["rank_spots"] = time.perf_counter() - t0
    out.update(rank_spots=len(ks), rank_spots_exact=spots_ok,
               rank_spots_past_2_31=int((ks >= 2**31).sum()))
    if spots_ok != len(ks):
        raise AssertionError(f"rank6 spot check: {spots_ok}/{len(ks)}")

    # exact on the card (the CLI's batches and records), the native engine
    # over the same index's host arrays, and `exact -M`
    names = [f"r{i}" for i in range(WIDE_QUERIES)]
    seqs = [dna.encode(x) for x in
            (ln.strip() for ln in open(q_fa) if not ln.startswith(">"))]
    sm.STATS.update(reads=0, redo=0, maxi=None)
    mems, secs["exact_card"], peak["exact"] = timed(dev, lambda: [
        m for lo in range(0, len(seqs), 4096)
        for m in sm.smem_all(idx, seqs[lo: lo + 4096])])
    card = io.StringIO()
    write_exact(idx, names, seqs, mems, card)
    out.update(exact_reads_per_s=len(seqs) / secs["exact_card"],
               smems=sum(len(m) for m in mems), redo_reads=sm.STATS["redo"],
               learned_maxi=sm.STATS["maxi"])
    t0 = time.perf_counter()
    nat = sm.smem_all_native(idx, seqs)
    secs["exact_native"] = time.perf_counter() - t0
    if nat != mems:
        raise AssertionError("wide exact: card != native engine")
    del nat

    # unpack of sampled ids: x is read x // 2, reverse-complemented when
    # x is odd
    ids = np.sort(rng.choice(idx.n_seqs, N_UNPACK, replace=False))
    (got, _), secs["unpack"], _ = timed(
        dev, lambda: se.retrieve_strings(idx, ids))
    for x, s in zip(ids, got):
        r = reads[x // 2] + 1
        want = r if x % 2 == 0 else (5 - r)[::-1]
        if not np.array_equal(s, want):
            raise AssertionError(f"wide unpack of id {x}")
    k1 = launches()["rank6_fused"]
    out["device_peak_gb"] = {k: v / 1e9 for k, v in peak.items()}
    if on_card and k1 < 1:
        raise AssertionError("the wide path launched no K1")

    # exact -M over the record cache, on the host
    blk, secs["ensure_blk"] = host_only(
        "ensure_blk", lambda: ensure_blk(fmd, n_threads=OOC_THREADS))
    out.update(blk_rows=blk.n_rows,
               blk_gb=os.path.getsize(blk.path) / 1e9, blk_wide=blk.wide)
    (secs["exact_M"], text, _), _ = host_only(
        "exact -M", lambda: run_cli(["exact", "-M", fmd, q_fa]))
    if text != card.getvalue() or text.count("SQ\t") != WIDE_QUERIES:
        raise AssertionError("wide exact: card != exact -M")
    out.update(exact_reads_per_s_M=WIDE_QUERIES / secs["exact_M"],
               host_peak_gib=host_peak_gib())
    del blocks_h, flat

    # K1 on the wide rows: the main path's shape, then one batch's steps,
    # and the batch profiled (ROADMAP item 3a's rule)
    k1_main = k1_at_main_path_shape(idx, maxi, rng, clock_hz,
                                    tag="wide_k1_main_shape")
    batch = seqs[:WIDE_PROFILED]
    _, stream = k1_stream(idx, batch, clock_hz, tag="wide_k1_stream",
                          spread=False)
    prof_mems, prof = profile_exact(idx, batch, tag="wide_profile_exact")
    if prof_mems != mems[:WIDE_PROFILED]:
        raise AssertionError("the profiled batch's SMEMs changed")
    k1_s = stream["zero"]["us_per_step"] * stream["steps"] / 1e6
    share = k1_s / prof["wall_s"]
    idle = prof["idle_share"]
    close = share < 0.25 or (isinstance(idle, float) and idle >= 0.5)
    log("wide_3a", k1_graph_s=k1_s, wall_s=prof["wall_s"],
        k1_share_of_wall=share, idle_share=idle,
        decision="close" if close else "keep")

    # [wide]'s records of the queries [huge] searches again
    wide_text = io.StringIO()
    write_exact(idx, names[:HUGE_QUERIES], seqs[:HUGE_QUERIES],
                mems[:HUGE_QUERIES], wide_text)
    n_seqs, total = idx.n_seqs, idx.total
    del idx, mems
    torch.cuda.empty_cache()
    log("wide", pairs=n_pairs, seconds=secs, k1_launches=k1,
        k1_main_shape_ms=k1_main["ms"], k1_main_shape_bound_ms=k1_main[
            "bound_ms"], **out, phase_seconds=time.perf_counter() - t_phase)
    # the wide cache goes first: [huge] writes one of 2.6 times its size
    os.remove(blk.path)
    k1_merge, k1_huge = huge_phase(rng, wd, dev, fmd, reads, q_fa,
                                   wide_text.getvalue(), (total, n_seqs))
    shutil.rmtree(wd)
    return k1 + k1_merge, k1_huge


def doubled_sizes(exact_text):
    """`exact`'s records with every SMEM's size (the EM line's fourth
    field) doubled."""
    out = []
    for ln in exact_text.splitlines(True):
        if ln.startswith("EM\t"):
            f = ln.split("\t")
            f[3] = str(2 * int(f[3]))
            ln = "\t".join(f)
        out.append(ln)
    return "".join(out)


def huge_phase(rng, wd, dev, fmd, reads, q_fa, wide_text, wide_shape):
    """An index past 2^32 symbols: `merge` of the wide index `fmd` with
    itself through the CLI on `dev` (the gap walk over two resident 2.26
    Gsym indexes with fused rows), twice the symbols and sequences
    (`wide_shape` is the wide index's (total, n_seqs)).  Past 2^32 - 128
    symbols the restored index is int64 without fused rows, so every rank
    below is a row gather and K1's `rank_block_counts`.  Over it, each a
    gate: `chkbwt -r`; rank6 at WIDE_SPOTS positions, half past 2^32,
    against a host scan; `exact` of the first HUGE_QUERIES queries of q_fa
    on the card, byte-equal to the native engine over the same index's
    host arrays, to `exact -M` over the new .fmd.blk (256 B records) and
    to `wide_text` (the wide index's records of them) with every size
    doubled: each SA interval doubles, kf with n_seqs, so the flags stay;
    `unpack` of N_UNPACK ids x and x + n_seqs, both the read behind x.
    Returns K1's launches: rank6_fused's in the merge, rank_block_counts'
    on the merged index."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.algos import merge as mg
    from fermi_tpu_torch.cli.main import (CHKBWT_CHUNK, check_ranks,
                                          write_exact)
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.index import fmd as fmd_mod
    from fermi_tpu_torch.index.blkidx import ensure_blk
    from fermi_tpu_torch.search import extend as se
    from fermi_tpu_torch.search import smem as sm

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    with open("/proc/meminfo") as f:
        ram = int(re.search(r"MemTotal:\s+(\d+)", f.read()).group(1))
    secs, peak = {}, {}
    out = {"host_ram_gib": ram / 2**20,
           "disk_free_gb": shutil.disk_usage(wd).free / 1e9,
           "host_peak_gib_before": host_peak_gib()}
    big = os.path.join(wd, "huge.fmd")

    # merge on the card, its parts timed by merge_files
    reset_launches()
    torch.cuda.empty_cache()
    secs["merge"] = run_cli(["merge", "--device", str(dev), "-fo", big, fmd,
                             fmd])[0]
    for k, v in mg.FILE_STATS["seconds"].items():
        secs[f"merge_{k}"] = v
    for k, v in mg.FILE_STATS["device_peak"].items():
        peak[f"merge_{k}"] = v
    k1_merge = launches()
    out.update(merge_steps=mg.STATS["steps"], merge_lanes=mg.STATS["lanes"],
               fmd_gb=os.path.getsize(big) / 1e9,
               host_peak_gib_merge=host_peak_gib())
    if on_card and (k1_merge["rank6_fused"] < 1
                    or k1_merge["rank_block_counts"]):
        raise AssertionError(f"huge: the merge's launches: {k1_merge}")

    def restore():
        runs = rld.read_fmd(big)
        return runs.mcnt.copy(), len(runs.lengths), \
            fmd_mod.FMDIndex.from_runs(runs, dev)
    reset_launches()
    (mcnt, out["runs"], idx), secs["restore"], peak["restore"] = timed(
        dev, restore)
    out.update(symbols=idx.total, idtype=str(idx.idtype),
               fused=idx.fused is not None,
               host_peak_gib_restore=host_peak_gib())
    if (idx.total != 2 * wide_shape[0] or idx.n_seqs != 2 * wide_shape[1]
            or idx.total < HUGE_MIN_SYMBOLS or idx.idtype != torch.int64
            or idx.fused is not None or idx.total < fmd_mod.FUSED_MAX):
        raise AssertionError(f"huge index: {idx.total} symbols, "
                             f"{idx.n_seqs} sequences, {idx.idtype}, "
                             f"fused {idx.fused is not None}")

    e = io.StringIO()
    with contextlib.redirect_stderr(e):
        rc, secs["chkbwt"], peak["chkbwt"] = timed(
            dev, lambda: check_ranks(idx, mcnt))
    if rc or "rank check passed" not in e.getvalue():
        raise AssertionError(f"chkbwt -r of the huge index: {e.getvalue()}")
    out["chkbwt_chunks"] = -(-idx.total // CHKBWT_CHUNK)

    t0 = time.perf_counter()
    blocks_h = sm._native_index_arrays(idx)[0]
    flat = blocks_h.reshape(-1)[: idx.total]
    lo_k = min(HUGE_MIN_SYMBOLS, idx.total)
    ks = np.sort(np.concatenate([
        rng.integers(0, idx.total + 1, WIDE_SPOTS // 2),
        rng.integers(lo_k, idx.total + 1, WIDE_SPOTS - WIDE_SPOTS // 2)]))
    got = idx.rank6(torch.from_numpy(ks).to(dev)).cpu().numpy()
    spots_ok = int((got == host_rank_scan(flat, ks)).all(1).sum())
    secs["rank_spots"] = time.perf_counter() - t0
    out.update(rank_spots=len(ks), rank_spots_exact=spots_ok,
               rank_spots_past_2_32=int((ks >= 2**32).sum()))
    if spots_ok != len(ks):
        raise AssertionError(f"huge rank6 spot check: {spots_ok}/{len(ks)}")
    del blocks_h, flat

    # exact on the card, the native engine, [wide]'s records doubled
    with open(q_fa) as f:
        head = [next(f) for _ in range(2 * HUGE_QUERIES)]
    names = [ln[1:].strip() for ln in head[0::2]]
    seqs = [dna.encode(ln.strip()) for ln in head[1::2]]
    mems, secs["exact_card"], peak["exact"] = timed(
        dev, lambda: sm.smem_all(idx, seqs))
    card = io.StringIO()
    write_exact(idx, names, seqs, mems, card)
    out.update(exact_reads_per_s=len(seqs) / secs["exact_card"],
               smems=sum(len(m) for m in mems))
    if card.getvalue() != doubled_sizes(wide_text):
        raise AssertionError("huge exact: the card's records != the wide "
                             "index's with every size doubled")
    t0 = time.perf_counter()
    if sm.smem_all_native(idx, seqs) != mems:
        raise AssertionError("huge exact: card != native engine")
    secs["exact_native"] = time.perf_counter() - t0

    # unpack: ids x and x + n_seqs are both the read behind x
    ids = np.sort(rng.choice(wide_shape[1], N_UNPACK, replace=False))
    both = np.concatenate([ids, ids + wide_shape[1]])
    (got, _), secs["unpack"], peak["unpack"] = timed(
        dev, lambda: se.retrieve_strings(idx, both))
    for x, s in zip(both, got):
        y = x % wide_shape[1]
        r = reads[y // 2] + 1
        want = r if y % 2 == 0 else (5 - r)[::-1]
        if not np.array_equal(s, want):
            raise AssertionError(f"huge unpack of id {x}")
    k1 = launches()
    if on_card and (k1["rank_block_counts"] < 1 or k1["rank6_fused"]):
        raise AssertionError(f"huge: the merged index's launches: {k1}")
    del idx
    torch.cuda.empty_cache()

    # exact -M over the 256 B-record cache, on the host
    blk, secs["ensure_blk"] = host_only(
        "ensure_blk", lambda: ensure_blk(big, n_threads=OOC_THREADS))
    out.update(blk_rows=blk.n_rows, blk_gb=os.path.getsize(blk.path) / 1e9,
               blk_wide=blk.wide)
    # 256 B records past 2^32 - 1 symbols (fmblk_build's switch)
    if blk.total != 2 * wide_shape[0] or blk.wide != (blk.total >= 2**32):
        raise AssertionError(f"huge .fmd.blk: wide {blk.wide}, {blk.total}")
    hq_fa = os.path.join(wd, "hq.fa")
    with open(hq_fa, "w") as f:
        f.writelines(head)
    (secs["exact_M"], text, _), _ = host_only(
        "exact -M", lambda: run_cli(["exact", "-M", big, hq_fa]))
    if text != card.getvalue():
        raise AssertionError("huge exact: card != exact -M")
    out.update(exact_reads_per_s_M=len(seqs) / secs["exact_M"],
               host_peak_gib=host_peak_gib())
    log("huge", seconds=secs,
        device_peak_gb={k: v / 1e9 for k, v in peak.items()},
        k1_merge=k1_merge, k1_merged_index=k1, **out,
        phase_seconds=time.perf_counter() - t_phase)
    return k1_merge["rank6_fused"], k1["rank_block_counts"]


def ptxas_report(jobs):
    """Start `nvcc -Xptxas -v` on each CUDA job's source (the build's own
    flags, output discarded); returns a function that waits and gives, per
    source, the ptxas lines on registers and spills."""
    procs = []
    for job in jobs:
        cmd = [c for c in job.command if c not in ("-shared", "-Xcompiler",
                                                   "-fPIC")]
        procs.append((os.path.basename(job.source), subprocess.Popen(
            [*cmd, "-cubin", "-Xptxas", "-v", "-o", os.devnull],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def wait():
        out = {}
        for name, p in procs:
            text, _ = p.communicate()
            out[name] = [ln.split("ptxas info    :")[-1].strip()
                         for ln in text.splitlines()
                         if "registers" in ln or "spill" in ln
                         or "Function properties" in ln]
        return out
    return wait


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--queries", type=int, default=40_000)
    ap.add_argument("--against", metavar="TREE", action="append",
                    default=[],
                    help="another checkout of the repository (e.g. the "
                         "parent commit), may be given more than once: its "
                         "kernels are built too and timed in turns with "
                         "these on the same inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this test runs on the "
                         "card only\n")
        return 2
    from fermi_tpu_torch import native
    from fermi_tpu_torch.ops import rank_cuda, sw_cuda

    dev = torch.device("cuda")
    card_line = gpu_line()
    t0 = t_script = time.perf_counter()
    ptxas = ptxas_report([native.rank_job(), native.sw_job()])
    native.build_all([*native.host_jobs(), native.rank_job(),
                      native.sw_job()])
    for get in (native.get_lib, native.get_ec_lib, native.get_unitig_lib,
                native.get_frags_lib, native.get_sequtil_lib,
                native.get_smem_lib, native.get_seqsort_lib,
                native.get_remap_lib, native.get_bprope_lib):
        get()
    rank_cuda.get_lib()
    sw_cuda.get_lib()
    against = [Against(tree) for tree in args.against]
    build_s = time.perf_counter() - t0
    clock_hz = max_sm_clock_hz()
    nvcc = subprocess.run([native.rank_job().command[0], "--version"],
                          capture_output=True, text=True, check=True)
    log("header", card=card_line, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        nvcc=nvcc.stdout.strip().splitlines()[-1],
        build_seconds=build_s, sm_clock_max_mhz=clock_hz / 1e6,
        ptxas=ptxas(), against=args.against,
        k1_ops_per_word=K1_OPS_PER_WORD, k1_ops_per_query=K1_OPS_PER_QUERY,
        k2_ops_per_cell=K2_OPS_PER_CELL)

    rng = np.random.default_rng(args.seed)
    err, block_counts = k1_parity(rng, dev, clock_hz)
    k2 = k2_phase(rng, dev, clock_hz, against)
    with tempfile.TemporaryDirectory() as workdir:
        res = main_path(rng, workdir, dev, GENOME_LEN, N_READS, args.queries)
        gidx = cross_check(res["fmd"], res["q_fa"], res["exact_text"], dev)
        k1 = k1_at_main_path_shape(gidx, res["maxi"], rng, clock_hz,
                                   against)
        seqs = exact_batch(res["q_fa"])
        spread_keys, _ = k1_stream(gidx, seqs, clock_hz, against)
        if (profile_exact(gidx, seqs, spread_keys)[0]
                != profile_exact(gidx, seqs)[0]):
            raise AssertionError("dead slots' keys changed the SMEMs")
        del gidx, spread_keys
        torch.cuda.empty_cache()
        ec_res = correct_phase(rng, workdir, dev, res["genome"], N_READS)
        ss = seqsort_phase(workdir, ec_res["ec_fq"], dev)
        ut = unitig_phase(workdir, ss["fmd"], res["genome"], dev)
        profile_unitig(ss["fmd"], dev)
        win_fmd, win_rank = cross_check_ec(workdir, ec_res["win_fq"], dev)
        win_unitig = cross_check_unitig(workdir, win_fmd, win_rank, dev)
        # slice 6: each phase draws from a stream of its own, so the draws
        # of the phases around them stay as they were
        run = run_phase(workdir, ec_res["run_fq"], ec_res["win_fq"],
                        res["genome"], dev)
        k1_chkbwt = chkbwt_phase(workdir, res["fmd"], dev)
        exact_long_phase(np.random.default_rng(args.seed + 1), workdir,
                         res["genome"], res["fmd"], dev)
        rp = remap_pairs_phase(np.random.default_rng(args.seed + 2),
                               workdir, res["genome"], dev)
        # slice 7, from a stream of its own too
        k1_paired, gp = paired_phase(np.random.default_rng(args.seed + 3),
                                     workdir, res["genome"], dev)
        k1_example = example_phase(workdir, ec_res["win_fq"], dev)
        setops = [builders_phase(workdir, res, dev),
                  merge_phase(workdir, res, dev),
                  sub_phase(rng, workdir, res, dev)]
        con = contrast_phase(rng, workdir, res, dev)
        setops.append(con["k1_launches"])
        cross_check_setops(workdir, res, con, dev)
        # slice 8, from a stream of its own
        k1_dist = dist_phase(np.random.default_rng(args.seed + 4), workdir,
                             res["fmd"], res["q_fa"], dev)
        ropebwt_phase(workdir, ec_res["win_fq"], dev)
        # slice 9: -M, out of core on the host, over the files above
        outofcore_phase(workdir, dev, res, ec_res, ss, ut,
                        (win_fmd, win_rank, win_unitig), rp)
        # slice 11: reads past 1 kbp, from a stream of its own
        k1_long = long_reads_phase(np.random.default_rng(args.seed + 6),
                                   workdir, gp, dev)
        # slice 10: the wide index tier, from a stream of its own
        # and past 2^32 symbols (the wide index merged with itself)
        k1_wide, k1_unfused = wide_phase(np.random.default_rng(args.seed + 5),
                                         workdir, dev, res["maxi"], clock_hz)
    k1_launches = (res["launches"]["rank6_fused"] + ec_res["k1_launches"]
                   + ss["k1_launches"] + ut["k1_launches"]
                   + run["k1_launches"] + k1_chkbwt + sum(setops)
                   + k1_paired + k1_example + k1_dist + k1_long + k1_wide)
    log("total", seconds=time.perf_counter() - t_script)
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    print(json.dumps({"kernels": [{
        "name": "rank6_fused", "route": "cuda",
        "source": "fermi_tpu_torch/csrc/rank.cu",
        "replaces": "fermi_tpu/ops/rank_pallas.py:49",
        "launches": k1_launches,
        "max_abs_err": max(err, k1["max_abs_err"]),
        **{key: k1[key] for key in keys}, "library_ms": None}, {
        "name": "rank_block_counts", "route": "cuda",
        "source": "fermi_tpu_torch/csrc/rank.cu",
        "replaces": "fermi_tpu/ops/rank_pallas.py:49",
        "launches": k1_unfused, "max_abs_err": block_counts["max_abs_err"],
        **{key: block_counts[key] for key in keys}, "library_ms": None}, {
        "name": "sw_score_batch", "route": "cuda",
        "source": "fermi_tpu_torch/csrc/sw.cu",
        "replaces": "fermi_tpu/ops/sw_pallas.py:59",
        "launches": k2["launches"], "max_abs_err": k2["max_abs_err"],
        **{key: k2[key] for key in keys}, "library_ms": None}]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
