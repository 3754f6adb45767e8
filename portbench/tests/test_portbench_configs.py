"""BENCHMARK.json and the configurations against the benchmark's
contract: names, units, files, bounds, and each configuration's symbols
following from its file."""

import json
import os
import re

import pytest

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _cfg(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, entry["file"])) as f:
        return entry, json.load(f)


@pytest.mark.parametrize("name, symbols", [
    ("celegans-srr065390-chunk16", 417_818_416)])
def test_symbols_follow_from_the_file(name, symbols):
    """Each read and its reverse complement, each with its sentinel."""
    entry, cfg = _cfg(name)
    assert 2 * cfg["n_pairs"] * 2 * (cfg["read_len"] + 1) == symbols
    assert cfg["symbols"] == symbols
    assert entry["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert key in cfg and NAME.match(key)


def test_celegans_chunk_is_one_of_sixteen():
    _, cfg = _cfg("celegans-srr065390-chunk16")
    assert cfg["chunks"] * cfg["n_pairs"] == cfg["source_n_pairs"]
    cov = 2 * cfg["n_pairs"] * cfg["read_len"] / cfg["genome_len"]
    assert 2.0 < cov < 2.1


def test_benchmark_json_shape():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", w["traffic"] + ".json"))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
        assert any(os.path.exists(os.path.join(
            ROOT, "portbench", "metrics", f + ".py"))
            for f in (m["name"], m["name"].split(".")[0]))
    for w in cells:   # every cell: setup_s, another end-to-end, a layer
        mine = [m for m in BENCH["end_to_end"]
                if w in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
