"""Ranks as processes: start `world` fresh Python processes (spawn), each
running one rank's function, and collect what each returns.

fermi_tpu runs its mesh in one process under shard_map; the port's ranks
are processes of one torch.distributed group (dist/sharded.py), and this
is how a caller in one process starts them: dryrun_multichip does, and so
does the chip smoke test.
"""

import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import tempfile
import time


def _rank_main(fn, rank, world, init_method, out_path, args):
    import torch
    import torch.distributed as dist

    # the ranks share the host's cores; more threads than cores makes
    # torch's CPU ops spin against each other
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        result = fn(rank, world, init_method, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn, world: int, args=(), timeout_s: float = 600.0) -> list:
    """Run fn(rank, world, init_method, *args) for rank 0..world-1, each in
    a process of its own, and return their results in rank order.  fn must
    be importable by name (a module-level function) and return something
    picklable; init_method is a file:// rendezvous under a temporary
    directory, for init_process_group.  A rank that exits with an error
    fails the call at once, and so does the time limit; every rank still
    running is then killed."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "init")
        outs = [os.path.join(d, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, outs[r], tuple(args)))
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            alive = list(procs)
            while alive:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{len(alive)} of {world} ranks still "
                                       f"running after {timeout_s:.0f} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in alive], timeout=left)
                for p in alive:
                    if p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {procs.index(p)} of "
                                           f"{world} exited {p.exitcode}")
                alive = [p for p in alive if p.exitcode is None]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
