"""Which torch.distributed collectives gloo runs on CUDA tensors, with two
ranks sharing cuda:0, what an all-reduce of an SMEM loop step's rank
partials costs there on CUDA and on host tensors, and a world of one over
NCCL.  Needs one CUDA card:

    python3 scripts/gloo_cuda_probe.py

Prints the Python, torch and CUDA versions, the card's name and power
limit, and one JSON object per rank."""
import datetime, json, os, sys, tempfile, time
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, world, init, out):
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    res = {}
    def tryit(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # probe: record what gloo refuses
            res[name] = f"{type(e).__name__}: {str(e)[:160]}"
    for dt in (torch.int64, torch.int32, torch.uint8, torch.bool):
        t = torch.ones(8, dtype=dt, device=dev)
        tag = str(dt).split(".")[1]
        tryit(f"all_reduce_{tag}", lambda: dist.all_reduce(t))
        tryit(f"broadcast_{tag}", lambda: dist.broadcast(t, 0))
        tryit(f"all_gather_{tag}", lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t))
    t = torch.ones(8, dtype=torch.int64, device=dev)
    tryit("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty(8 * world, dtype=torch.int64, device=dev), t))
    tryit("all_to_all_single", lambda: dist.all_to_all_single(
        torch.empty(8, dtype=torch.int64, device=dev), t))
    tryit("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty(8 // world, dtype=torch.int64, device=dev), t))
    tryit("all_gather_object", lambda: dist.all_gather_object(
        [None] * world, {"r": rank}))
    dist.barrier()
    # all-reduce cost of an SMEM step's rank partials (2048 lanes x 64 keys x 6)
    for shape in ((2048 * 64, 6), (1 << 20, 6)):
        x = torch.ones(shape, dtype=torch.int32, device=dev)
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        res[f"all_reduce_ms_{shape[0]}x6_int32"] = (time.perf_counter() - t0) / 20 * 1e3
        xh = x.cpu()
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(xh)
        res[f"all_reduce_host_ms_{shape[0]}x6_int32"] = (time.perf_counter() - t0) / 20 * 1e3
    sub = dist.new_group([0, 1])
    x = torch.ones(4, dtype=torch.int64, device=dev)
    dist.all_reduce(x, group=sub)
    res["subgroup_all_reduce"] = x.tolist()
    dist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)


def nccl_one(init):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=init, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.ones(8, dtype=torch.int64, device="cuda")
    dist.all_reduce(x)
    g = [None]
    dist.all_gather_object(g, {"a": 1})
    sub = dist.new_group([0])
    dist.all_reduce(x, group=sub)
    torch.cuda.synchronize()
    out = {"nccl_world1": x.tolist(), "obj": g, "nccl_version": str(torch.cuda.nccl.version())}
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    import subprocess
    print(sys.version, torch.__version__, torch.version.cuda)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
    d = tempfile.mkdtemp()
    t0 = time.perf_counter()
    mp.start_processes(worker, args=(2, f"file://{d}/init", f"{d}/out"), nprocs=2, start_method="spawn")
    print("spawn+run s", time.perf_counter() - t0)
    for r in range(2):
        print(r, open(f"{d}/out.{r}").read())
    print(nccl_one(f"file://{d}/init1"))
