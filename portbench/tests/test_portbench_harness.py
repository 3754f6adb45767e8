"""Whole runs of tiny cells on the CPU: the result line, the per-layer
metrics, a cell added by new files and entries alone, and the check
coming out false under the control and under each fault a cell can
have."""

import hashlib
import json
import os

import numpy as np
import pytest

from conftest import ROOT, SEED

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _digest(top):
    h = {}
    for d, _, names in os.walk(top):
        for n in names:
            if "__pycache__" not in d:
                p = os.path.join(d, n)
                h[p] = hashlib.sha1(open(p, "rb").read()).hexdigest()
    return h


@pytest.mark.parametrize("cell, e2e, checks", [
    ("tiny.smem", "smem_reads_per_s",
     ["bwt_mismatch", "count_mismatch", "smem_mismatch"]),
    ("tiny.index", "index_msym_per_s",
     ["bwt_mismatch", "count_mismatch", "unit_mismatch"])])
def test_a_run_is_correct(run_tiny, cell, e2e, checks):
    res = run_tiny(cell)
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {e2e, "setup_s"}
    assert res["metrics"][e2e]["value"] > 0
    assert list(res["checks"]) == checks
    assert all(v == {"value": 0, "limit": 0}
               for v in res["checks"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell, layer", [
    ("tiny.smem", {"k1_launches_per_read.smem", "redo_share.smem"}),
    ("tiny.index", {"encode_share.index", "bwt_share.index",
                    "rle_share.index", "dump_share.index"})])
def test_traced_run_reads_its_layers(run_tiny, cell, layer):
    """On the CPU there is no device trace, so the device's metrics are
    left out, never reported as 0."""
    res = run_tiny(cell, trace=1)
    assert res["correct"] and set(res["metrics"]) == layer
    assert "busy_s" not in res["device"]
    for m in res["metrics"].values():
        assert 0 <= m["value"] and m["unit"] in ("%", "launches/read")


def test_a_cell_added_by_new_files_alone(tiny_root, run_tiny):
    """A configuration, a traffic mix, a per-layer metric and a cell,
    added as new files and new entries: no existing file changes."""
    before = _digest(os.path.join(ROOT, "portbench"))
    here = os.path.join(tiny_root, "portbench")
    with open(os.path.join(here, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny2", genome_len=5000, n_pairs=400)
    with open(os.path.join(here, "configs", "tiny2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "traffic", "short_q.json"), "w") as f:
        json.dump({"kind": "smem", "batch": 16, "query_len": 40,
                   "sub_rate": 0.02, "check_sample": 16}, f)
    with open(os.path.join(here, "metrics", "units_run.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['units'])\n")
    bench_path = os.path.join(tiny_root, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["configs"].append({"name": "tiny2", "source": "test",
                             "file": "portbench/configs/tiny2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny2.short", "config": "tiny2",
                               "traffic": "short_q", "chips": 1,
                               "why": "test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "smem_reads_per_s")["workloads"].append(
        "tiny2.short")
    bench["per_layer"].append({"name": "units_run", "unit": "units",
                               "better": "higher", "source":
                               "program_counter", "layer": "harness",
                               "moves": "smem_reads_per_s",
                               "workloads": ["tiny2.short"]})
    json.dump(bench, open(bench_path, "w"))
    res = run_tiny("tiny2.short", trace=1)
    assert res["correct"] and res["metrics"]["units_run"]["value"] >= 1
    assert _digest(os.path.join(ROOT, "portbench")) == before


def test_control_is_not_correct(run_tiny):
    from portbench import control

    for cell in ("tiny.smem", "tiny.index"):
        with control.controlled():
            res = run_tiny(cell)
        assert not res["correct"]
        assert res["checks"]["bwt_mismatch"]["value"] > 0


def _altered_smem(orig):
    def smem_all(index, seqs, *a, **k):
        res = orig(index, seqs, *a, **k)
        for i, r in enumerate(res):
            if r:
                s, e, size, closed, kf = r[0]
                res[i] = [(s, e, size + 1, closed, kf)] + list(r[1:])
        return res
    return smem_all


def _half_smem(orig):
    def smem_all(index, seqs, *a, **k):
        half = len(seqs) // 2
        return orig(index, seqs[:half], *a, **k) + [[]] * (len(seqs) - half)
    return smem_all


def _stale_smem(orig):
    last = []

    def smem_all(index, seqs, *a, **k):
        if not last:
            last.append(orig(index, seqs, *a, **k))
        return last[0]
    return smem_all


@pytest.mark.parametrize("fault", [_altered_smem, _half_smem, _stale_smem])
def test_smem_faults_are_caught(run_tiny, monkeypatch, fault):
    """An answer altered where it is produced; half of the batch left
    out; a call that hands back its state unchanged."""
    from fermi_tpu_torch.search import smem

    monkeypatch.setattr(smem, "smem_all", fault(smem.smem_all))
    res = run_tiny("tiny.smem", seconds=0.5)
    assert not res["correct"]
    assert res["checks"]["smem_mismatch"]["value"] > 0


def _altered_bwt(orig):
    def device_bwt(text, device=None):
        b = orig(text, device).copy()
        b[len(b) // 2] = (b[len(b) // 2] % 4) + 1
        return b
    return ("fermi_tpu_torch.construct.blocked", "device_bwt", device_bwt)


def _half_reads(orig):
    from fermi_tpu_torch.pipeline import driver

    build = driver.Pipeline.build_index

    def build_index(self, reads_iter, out_fmd, paths=None):
        return build(self, reads_iter, out_fmd, paths=paths[:1])
    return ("fermi_tpu_torch.pipeline.driver", "Pipeline.build_index",
            build_index)


def _no_write(orig):
    def build_index(self, reads_iter, out_fmd, paths=None):
        return None
    return ("fermi_tpu_torch.pipeline.driver", "Pipeline.build_index",
            build_index)


@pytest.mark.parametrize("fault", [_altered_bwt, _half_reads, _no_write])
def test_index_faults_are_caught(run_tiny, monkeypatch, fault):
    """A BWT symbol altered where it is produced; half of the reads left
    out of the build; a unit that leaves the state as it was (writes
    nothing)."""
    import importlib

    from fermi_tpu_torch.construct import blocked

    mod, attr, fn = fault(blocked.device_bwt)
    target = importlib.import_module(mod)
    if "." in attr:
        cls, attr = attr.split(".")
        target = getattr(target, cls)
    monkeypatch.setattr(target, attr, fn)
    res = run_tiny("tiny.index", seconds=0.5)
    assert not res["correct"]
    assert res["checks"]["bwt_mismatch"]["value"] > 0 or \
        res["checks"]["unit_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny.smem", "tiny.index"])
def test_jax_loaded_by_the_check_gives_no_result(tiny_root, run_tiny,
                                                 monkeypatch, cell):
    """A module of the JAX side loaded as late as the reference's check
    (a stub named jax here): the run ends with another code than 0 and
    no result."""
    import sys
    import time
    import types

    from portbench import harness, judge

    ref = judge.reference_of

    def reference_of(*a, **k):
        sys.modules["jax"] = types.ModuleType("jax")
        return ref(*a, **k)
    monkeypatch.setattr(judge, "reference_of", reference_of)
    had = sys.modules.get("jax")
    try:
        rc, res = harness.run(cell, SEED, 0.2, 0, "cpu",
                              time.perf_counter(), root=tiny_root)
    finally:
        sys.modules.pop("jax", None)
        if had is not None:
            sys.modules["jax"] = had
    assert rc != 0 and res is None
    assert not harness.forbidden_modules() or had is not None


def test_seeds_draw_the_same_work(run_tiny):
    a = run_tiny("tiny.index", seed=SEED)
    b = run_tiny("tiny.index", seed=SEED + 1)
    per_unit = [r["metrics"]["index_msym_per_s"]["value"] for r in (a, b)]
    assert all(v > 0 for v in per_unit)
    assert np.isfinite(per_unit).all()
