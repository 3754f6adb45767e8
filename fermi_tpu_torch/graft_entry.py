"""Entry points of the port's flagship step and of its multi-rank dry run:
the counterparts of fermi_tpu's __graft_entry__.py.

entry() gives one batched SMEM pass (search/smem._smem_batch) and its
example arguments on the card.  dryrun_multichip(n) starts n ranks as
processes (dist/launch.py) and runs the dp×tp-sharded steps of
__graft_entry__.py:43-129 on them, each held to the single-process path:
sharded SMEM, the distributed merge, and a mini pipeline on a distributed
build.
"""

import time

import numpy as np
import torch

from fermi_tpu_torch import resolve_device


def _tiny_index(device):
    """fermi_tpu's dry-run index: 64 reads of 80 bp from a random 2,000 bp
    genome (seed 0), both strands, on `device`."""
    from fermi_tpu_torch.construct import suffix
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device
    from fermi_tpu_torch.index.fmd import FMDIndex

    rng = np.random.default_rng(0)
    genome = rng.integers(1, 5, 2000).astype(np.uint8)
    seqs = []
    for _ in range(64):
        pos = int(rng.integers(0, 1900))
        seqs.append(genome[pos:pos + 80].copy())
    bwt = multistring_bwt_device(suffix.build_text(seqs), device)
    return FMDIndex.from_bwt(bwt, device), seqs


def entry(device=None):
    """One batched SMEM pass of the flagship loop (forward/backward
    bidirectional extension over the FMD-index): (fn, example_args), the
    arguments on `device` (CUDA unless named)."""
    from fermi_tpu_torch.search.smem import _smem_batch

    dev = resolve_device(device)
    index, seqs = _tiny_index(dev)
    B, L = 32, 80
    q = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        q[i, : len(seqs[i])] = seqs[i]
        lens[i] = len(seqs[i])

    def fn(index, q, l):
        return _smem_batch(index, q, l, False, L, 16, 64)

    return fn, (index, torch.from_numpy(q).to(dev),
                torch.from_numpy(lens).to(dev))


def _dryrun_rank(rank, world, init_method, device, timeout_s):
    """One rank of dryrun_multichip; returns its counters (and the ok line
    on rank 0)."""
    import io

    from fermi_tpu_torch.algos import correct as C
    from fermi_tpu_torch.algos import merge as mg
    from fermi_tpu_torch.algos.hostindex import HostIndex
    from fermi_tpu_torch.algos.unitig import fm6_unitig
    from fermi_tpu_torch.algos.unitig_bulk import fm6_unitig_device
    from fermi_tpu_torch.construct import suffix
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device
    from fermi_tpu_torch.dist import sharded as sh
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.ops import rank_cuda
    from fermi_tpu_torch.search import smem as sm

    torch.set_num_threads(1)
    dev = sh.init_ranks(rank, world, init_method, device, timeout_s)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dp = max(world // 2, 1)
    tp = world // dp
    mesh = sh.make_mesh(dp=dp, tp=tp, device=dev)

    # (1) sharded SMEM, parity with the single-process loop
    index, seqs = _tiny_index(dev)
    queries = seqs[:4 * dp]
    k1_before = dict(rank_cuda.LAUNCHES)
    got = sh.ShardedSMEM(index, mesh).smem_all(queries)
    k1_sharded = sum(rank_cuda.LAUNCHES.values()) - sum(k1_before.values())
    if got != sm.smem_all(index, queries):
        raise AssertionError("sharded SMEM != single-process SMEM")

    # (2) distributed merge, parity with fm_merge
    def bwt_of(reads):
        return multistring_bwt_device(suffix.build_text(reads), dev)

    b0, b1 = bwt_of(seqs[:24]), bwt_of(seqs[24:48])
    e0, e1 = FMDIndex.from_bwt(b0, dev), FMDIndex.from_bwt(b1, dev)
    got_bwt = sh.fm_merge_sharded(e0, b0, e1, b1, mesh, batch=4 * dp)
    if not np.array_equal(got_bwt, mg.fm_merge(e0, b0, e1, b1)):
        raise AssertionError("sharded merge != fm_merge")
    nmem = sum(len(r) for r in got)

    # (3) mini pipeline on the mesh: distributed build -> EC collect ->
    # device unitig links -> sharded SMEM query, each step checked
    per = (len(seqs) + 3) // 4
    texts = [suffix.build_text(seqs[i * per:(i + 1) * per]) for i in range(4)]
    built = sh.build_fmd_distributed(texts, mesh)
    if not np.array_equal(built, bwt_of(seqs)):
        raise AssertionError("distributed build != direct build")
    eb = FMDIndex.from_bwt(built, dev)
    _, key, _, _ = C.collect_solid_kmers(eb, 16, 2)
    if len(key) == 0:
        raise AssertionError("EC collect found no solid k-mers")
    # the device link records, stitched, against the host builder's walk
    dev_mag, host_mag = io.StringIO(), io.StringIO()
    fm6_unitig_device(eb, 30, dev_mag, verbose=False)
    fm6_unitig(HostIndex(built), 30, host_mag)
    if dev_mag.getvalue() != host_mag.getvalue():
        raise AssertionError("device unitig links != host unitig walk")
    got2 = sh.ShardedSMEM(eb, mesh).smem_all(queries[:2 * dp])
    if got2 != sm.smem_all(eb, queries[:2 * dp]):
        raise AssertionError("pipeline SMEM mismatch")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = dict(rank=rank, backend=mesh.backend, seconds=time.perf_counter() - t0,
               k1_launches=sum(rank_cuda.LAUNCHES.values()),
               k1_sharded_smem=k1_sharded,
               all_reduce=sh.STATS["all_reduce"],
               all_reduce_s=sh.STATS["all_reduce_s"],
               device_peak_gb=(torch.cuda.max_memory_allocated(dev) / 2**30
                               if dev.type == "cuda" else 0.0))
    if rank == 0:
        out["ok"] = (
            f"[dryrun_multichip] ok: mesh dp={dp} tp={tp}, sharded SMEM "
            f"({nmem} matches) + distributed merge ({len(got_bwt)} symbols) "
            f"+ pipeline [dist build {len(built)} syms -> collect "
            f"{len(key)} kmers -> device unitig links -> sharded remap "
            f"query] verified on {world} ranks ({mesh.backend})")
    return out


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 600.0):
    """Run the dp×tp-sharded production steps on n_devices ranks, each a
    process (dp = n // 2, tp = n // dp, as in fermi_tpu): (1) the SMEM loop
    with queries split over dp and the index over tp, every rank query an
    all-reduce over tp; (2) a distributed two-index merge; (3) a
    distributed build, EC collect, device unitig links and a sharded SMEM
    query.  Each is held to the single-process path; a mismatch fails the
    rank and the call.  Ranks run on `device` (CUDA unless named; several
    ranks share a card over gloo when there are fewer cards than ranks).
    Prints fermi_tpu's ok line; returns each rank's counters."""
    from fermi_tpu_torch.dist.launch import spawn_ranks

    dev = resolve_device(device)
    res = spawn_ranks(_dryrun_rank, n_devices,
                      (str(dev), timeout_s), timeout_s)
    print(res[0]["ok"])
    return res
