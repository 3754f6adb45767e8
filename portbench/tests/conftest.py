"""Fixtures of the benchmark's CPU tests: tiny cells in a copy of the
benchmark's data laid out under a temporary root.

    python3 -m pytest portbench/tests -q

The tests run the port's plain PyTorch versions on the CPU; the one test
that needs a card carries the `cuda` marker and skips here.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"genome_len": 6000, "n_pairs": 900,
        "repeat_families": [[60, 4], [120, 2]]}
SEED = 2**31 + 77          # larger than 32 signed bits hold

# The smem kind's metrics, which BENCHMARK.json holds in no cell yet: the
# entries that a cell of that kind brings with it (PERF.md, Open
# questions), added here for tiny.smem.
SMEM_METRICS = {
    "end_to_end": [
        {"name": "smem_reads_per_s", "unit": "reads/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": []}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": layer, "moves": "smem_reads_per_s", "workloads": []}
        for name, unit, source, layer in [
            ("idle_share.smem", "%", "device_trace", "device"),
            ("k1_busy_share.smem", "%", "device_trace", "kernel K1"),
            ("k1_launches_per_read.smem", "launches/read",
             "program_counter", "kernel K1"),
            ("redo_share.smem", "%", "program_counter", "search loop")]]}


def make_root(path):
    """A copy of BENCHMARK.json and the benchmark's data, reader and
    unit files under `path`, with a tiny configuration and mix, the
    smem kind's metrics, and the cells tiny.smem and tiny.index added as
    new files and entries."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    for d in ("configs", "traffic", "units", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", d),
                        os.path.join(path, "portbench", d))
    here = os.path.join(path, "portbench")
    with open(os.path.join(here, "configs",
                           "celegans-srr065390-chunk16.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name="tiny")
    with open(os.path.join(here, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "traffic", "smem_fresh.json")) as f:
        tr = json.load(f)
    tr.update(batch=48, check_sample=24)
    with open(os.path.join(here, "traffic", "tiny_smem.json"), "w") as f:
        json.dump(tr, f)
    bench_path = os.path.join(path, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    for key, entries in SMEM_METRICS.items():
        bench[key] += [dict(m, workloads=[]) for m in entries]
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    cells = {"tiny.smem": ("tiny_smem", "smem_reads_per_s"),
             "tiny.index": ("raw_fmd", "index_msym_per_s")}
    for name, (mix, _) in cells.items():
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        moves = m.get("moves", m["name"])
        for name, (_, e2e) in cells.items():
            if "workloads" in m and moves == e2e:
                m["workloads"].append(name)
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def run_tiny(tiny_root, tmp_path, monkeypatch):
    """run_tiny(cell, trace=0) -> the result of one CPU run of a tiny
    cell, its scratch files under this test's own directory."""
    import time

    from portbench import harness

    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))

    def run(cell, trace=0, seed=SEED, seconds=0.2):
        rc, res = harness.run(cell, seed, seconds, trace, "cpu",
                              time.perf_counter(), root=tiny_root)
        assert rc == 0
        return res
    return run
