"""One run of one cell: set-up, a warm-up unit, the measured window, the
trace if asked for, then the check against the plain reference.

Everything about a cell is found by name under the benchmark's root (the
checkout, or any directory laid out like it):

  BENCHMARK.json                  the cells, metrics and run length
  portbench/configs/<config>.json a deployment's sizes
  portbench/traffic/<mix>.json    a traffic mix's parameters; its "kind"
                                  names the unit driver
  portbench/units/<kind>.py       how a unit of that kind runs and is checked
  portbench/metrics/<metric>.py   a per-layer metric's reader, read(ctx);
                                  else <family>.py, the family being the
                                  name before its first "."

so a later cell, configuration, mix or metric is new files and entries.
"""

import gc
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fermi_tpu")
# A traced run measures at most this long: the SMEM cells' device trace
# holds ~40,000 records a second, and reading a full window's took over
# two minutes of the run's six (profiler stop and record reading).
TRACE_SECONDS = 20


def log(tag, **kv):
    sys.stderr.write(f"[portbench:{tag}] " + json.dumps(kv, default=str)
                     + "\n")
    sys.stderr.flush()


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix,
    unit driver and metrics, read from `root`."""

    def __init__(self, name, root=ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.bench = bench
        self.workload = by_name[name]
        self.name = name
        self.root = root
        here = os.path.join(root, "portbench")
        with open(os.path.join(here, "configs",
                               self.workload["config"] + ".json")) as f:
            self.config = json.load(f)
        with open(os.path.join(here, "traffic",
                               self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        kind = self.traffic["kind"]
        self.units = load_module(os.path.join(here, "units", kind + ".py"),
                                 f"portbench_units_{kind}")
        self.metrics_dir = os.path.join(here, "metrics")

    def _listed(self, metric):
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self._listed(m)]

    def per_layer(self):
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self._listed(m) and m["moves"] in reported]

    def reader(self, metric):
        name = metric["name"]
        path = os.path.join(self.metrics_dir, name + ".py")
        if not os.path.exists(path):
            name = name.split(".")[0]
            path = os.path.join(self.metrics_dir, name + ".py")
        return load_module(path, "portbench_metric_" + name
                           .replace(".", "_").replace("-", "_")).read


def host_yardstick():
    """Seconds of a fixed single-thread NumPy workload (the best of three
    sorts of 2^22 keys from a fixed seed), for telling hosts apart."""
    keys = np.random.default_rng(20240601).integers(0, 2**62, 1 << 22)
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        np.sort(keys, kind="quicksort")
        best = min(best, time.perf_counter() - t)
    return best


def card_line():
    """The card's name, power limit and top SM clock by nvidia-smi, or
    None where it cannot be read."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


class UnitClock:
    """Per unit of the window: wall, process CPU and main-thread CPU
    seconds, seconds in Python's garbage collector and its full
    collections, and the process's involuntary context switches (the
    host taking the core away).  It tells a unit slowed by the host from
    one slowed by the harness or by more work."""

    def __init__(self):
        self.rows = []
        self._gc_s = 0.0
        self._gc_full = 0
        self._gc_t = 0.0

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self._gc_s += time.perf_counter() - self._gc_t
            self._gc_full += info.get("generation") == 2

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)

    def _now(self):
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return (time.perf_counter(), time.process_time(), time.thread_time(),
                self._gc_s, self._gc_full, ru.ru_nivcsw)

    def start(self):
        self._t = self._now()

    def stop(self):
        t = self._now()
        self.rows.append([round(b - a, 4) for a, b in zip(self._t, t)])

    def log(self):
        """Columns and rows for the window's log line."""
        return {"cols": ["wall_s", "cpu_s", "main_cpu_s", "gc_s",
                         "gc_full", "nivcsw"], "rows": self.rows}


def parts_by_unit(rows):
    """For each unit of the window, the seconds of the spans inside it,
    summed by name."""
    out = []
    for n, a, b, _ in rows:
        if n == "unit":
            parts = {}
            for m, c, d, _ in rows:
                if m != "unit" and a <= c and d <= b:
                    parts[m] = round(parts.get(m, 0.0) + (d - c) / 1e9, 4)
            out.append(parts)
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def workdir_for(name):
    """The run's scratch directory: a fixed path under TMPDIR."""
    return os.path.join(tempfile.gettempdir(), "portbench", name)


def run(name, seed, seconds, traced, device, t_start, root=ROOT):
    """One run of cell `name`, its process started at `t_start`
    (time.perf_counter()); returns (exit code, result dict or None)."""
    cell = Cell(name, root)
    device = torch.device(device)
    on_card = device.type == "cuda"
    wd = workdir_for(name)
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    spans = trace.Spans()
    try:
        log("run", workload=name, seed=seed, seconds=seconds, trace=traced,
            device=str(device), card=card_line() if on_card else None,
            torch=torch.__version__)
        yard = host_yardstick()
        log("host", yardstick_sort_s=yard, cpus=os.cpu_count())
        drv = cell.units.Driver(cell.config, cell.traffic, seed, device, wd,
                                spans, seconds)
        with spans("setup"):
            drv.setup()
        with spans("warmup"):
            drv.run_unit(-1)
        trace.sync(device)
        parts = {}
        for n, a, b, _ in spans.rows:
            parts[n] = parts.get(n, 0.0) + (b - a) / 1e9
        log("setup", seconds_by_span=parts)
        before = drv.counters()
        prof = trace.start() if traced and on_card else None
        trace.sync(device)
        t0, t0_ns = time.perf_counter(), time.time_ns()
        cpu0 = time.process_time()
        setup_s = t0 - t_start
        n_units = 0
        limit = min(seconds, TRACE_SECONDS) if traced else seconds
        with UnitClock() as clock:
            while time.perf_counter() - t0 < limit:
                clock.start()
                with spans("unit"):
                    drv.run_unit(n_units)
                    trace.sync(device)
                clock.stop()
                n_units += 1
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
        cpu_s = time.process_time() - cpu0
        after = drv.counters()
        summary = None
        if prof is not None:
            t = time.perf_counter()
            prof.stop()
            stop_s = time.perf_counter() - t
            recs = trace.device_records(prof)
            del prof
            first = trace.first_record_ns(recs)
            if first is not None and not t0_ns - 5e9 < first < t1_ns + 5e9:
                log("trace", warning="device clock off the host's",
                    first_record_ns=first, window_start_ns=t0_ns)
            summary = trace.summary(recs, t0_ns, t1_ns,
                                    [s for s in spans.rows
                                     if s[2] > t0_ns and s[1] < t1_ns])
            del recs
            log("trace", records=summary["n_records"], stop_s=stop_s,
                read_s=time.perf_counter() - t - stop_s)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        work = drv.work()
        rates = {k: v / window_s for k, v in work.items()}
        counters = {k: after[k] - before.get(k, 0) for k in after}
        log("window", units=n_units, window_s=window_s, setup_s=setup_s,
            process_cpu_s=cpu_s, host_peak_gib=resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2**20,
            work=work, rates=rates, traced=bool(traced), counters=counters,
            per_unit=clock.log(), parts_by_unit=parts_by_unit(spans.rows),
            yardstick_after_s=host_yardstick())
        ctx = {"window_s": window_s, "units": n_units, "work": work,
               "counters": counters, "trace": summary, "spans": spans.rows}
        drv.release()
        if on_card:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks, attempted, failed = drv.check()
        log("reference", seconds=time.perf_counter() - t)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    if traced:
        for m in cell.per_layer():
            v = cell.reader(m)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in rates:
                metrics[m["name"]] = {"value": rates[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    # last, after the check and the readers: whatever the run loaded
    bad = forbidden_modules()
    if bad:
        log("error", forbidden_modules=bad)
        return 3, None
    for k, (v, lim) in checks.items():
        sys.stderr.write(f"check {k} = {v} (limit {lim})\n")
    sys.stderr.flush()
    return 0, result
