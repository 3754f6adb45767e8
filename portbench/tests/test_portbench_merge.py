"""The merge cell's unit driver (units/merge.py) and its readers on the
CPU: a tiny merge cell added to the tiny root as new files and entries,
its check, its span shares, a flipped symbol caught, its configuration's
sizes, and no file of its own on disk."""

import json
import os
import shutil

import pytest

from conftest import ROOT, TINY

SPAN_SHARES = ["restore_share.merge", "decode_share.merge",
               "gap_walk_share.merge", "interleave_share.merge",
               "rle_share.merge", "dump_share.merge"]
CONFIG = "celegans-srr065390-merge16"


def _add_tiny_merge(root):
    """tiny.merge: the merge configuration at the tiny sizes, the
    merge_fmd mix, listed by index_msym_per_s and the .merge metrics."""
    here = os.path.join(root, "portbench")
    with open(os.path.join(here, "configs", CONFIG + ".json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name="tiny_merge")
    with open(os.path.join(here, "configs", "tiny_merge.json"), "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_merge", "source": "test",
                             "file": "portbench/configs/tiny_merge.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.merge", "config": "tiny_merge",
                               "traffic": "merge_fmd", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "celegans.merge" in m.get("workloads", ()):
            m["workloads"].append("tiny.merge")
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def merge_root(tiny_root):
    _add_tiny_merge(tiny_root)
    return tiny_root


def test_config_sizes():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry, = [c for c in bench["configs"] if c["name"] == CONFIG]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "configs",
                           "celegans-srr065390-chunk16.json")) as f:
        chunk = json.load(f)
    assert entry["reduced"] == cfg["reduced"] == ["inputs"]
    assert (cfg["inputs"], cfg["source_inputs"]) == (2, chunk["chunks"])
    assert cfg["symbols"] == cfg["inputs"] * chunk["symbols"] == 835_636_832
    for k, v in chunk.items():
        if k not in ("name", "source", "deployment", "assumed", "reduced",
                     "symbols"):
            assert cfg[k] == v, k
    assert set(chunk["assumed"]) < set(cfg["assumed"])
    cell, = [w for w in bench["workloads"] if w["name"] == "celegans.merge"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (CONFIG, "merge_fmd", 1)
    assert "RAM" in cell["why"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["index_msym_per_s"]["workloads"] == ["celegans.index",
                                                    "celegans.merge"]
    mine = [m for m in bench["per_layer"]
            if m.get("workloads") == ["celegans.merge"]]
    assert sorted(m["name"] for m in mine) == sorted(
        SPAN_SHARES + ["idle_share.merge", "k1_busy_share.merge"])
    assert all(m["moves"] == "index_msym_per_s" for m in mine)


def test_a_run_is_correct(merge_root, run_tiny):
    res = run_tiny("tiny.merge")
    assert res["correct"] and res["attempted"] >= 1 and not res["failed"]
    assert set(res["metrics"]) == {"index_msym_per_s", "setup_s"}
    assert res["metrics"]["index_msym_per_s"]["value"] > 0
    assert {k: v["value"] for k, v in res["checks"].items()} == {
        "bwt_mismatch": 0, "count_mismatch": 0, "unit_mismatch": 0}
    assert all(v["limit"] == 0 for v in res["checks"].values())


def test_traced_run_reads_the_span_shares(merge_root, run_tiny):
    """On the CPU there is no device trace: the six span shares alone,
    and the parts lie inside the window."""
    res = run_tiny("tiny.merge", trace=1)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == set(SPAN_SHARES)
    assert all(0 < v < 100 for v in got.values())
    parts = sum(got[k] for k in SPAN_SHARES if k != "decode_share.merge")
    assert got["decode_share.merge"] < got["restore_share.merge"]
    assert parts < 100


def test_a_flipped_symbol_is_caught(merge_root, run_tiny, monkeypatch):
    from fermi_tpu_torch.algos import merge as mg

    orig = mg.merge_bwts

    def flipped(*a, **kw):
        out = orig(*a, **kw)
        k = out.numel() // 2
        out[k] = 1 + out[k] % 4          # another base, or a base for $
        return out
    monkeypatch.setattr(mg, "merge_bwts", flipped)
    res = run_tiny("tiny.merge")
    assert not res["correct"]
    assert res["checks"]["bwt_mismatch"]["value"] >= 1


def test_no_file_of_the_run_on_disk(merge_root, run_tiny, monkeypatch):
    """Every file of the cell lives in RAM: the run's directory on disk,
    as the harness removes it, holds no file over 1 MB."""
    from portbench import harness

    seen, rmtree = [], shutil.rmtree

    def spy(path, *a, **kw):
        for d, _, names in os.walk(path):
            seen.extend(os.path.getsize(os.path.join(d, n)) for n in names)
        seen.append(0)
        return rmtree(path, *a, **kw)
    monkeypatch.setattr(harness.shutil, "rmtree", spy)
    assert run_tiny("tiny.merge")["correct"]
    assert seen and max(seen) <= 1 << 20


def test_the_parent_without_spans_reads_none(merge_root, run_tiny,
                                             monkeypatch):
    """A program whose merge records no spans (the commit before them)
    runs the cell to its end: correct, and no span share."""
    import contextlib
    import types

    from fermi_tpu_torch.algos import merge as mg
    from fermi_tpu_torch.index import fmd

    @contextlib.contextmanager
    def quiet(name):
        yield None
    none = types.SimpleNamespace(span=quiet)
    monkeypatch.setattr(mg, "MERGE_SPANS", None)
    monkeypatch.setattr(mg, "spans", none)
    monkeypatch.setattr(fmd, "spans", none)
    res = run_tiny("tiny.merge", trace=1)
    assert res["correct"] and not set(res["metrics"]) & set(SPAN_SHARES)
