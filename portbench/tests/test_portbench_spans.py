"""The readers of the index build's program spans (metrics/_spans.py and
the seven metrics on it): hand-built windows, rows inside and outside the
window's units, a program without the recorder, and a traced tiny run."""

import os
import sys

import pytest

from conftest import ROOT

from fermi_tpu_torch import spans
from portbench.harness import load_module

S = 10**9
NEW = {"rle_count_share.index": ["rle/count"],
       "rle_fill_share.index": ["rle/fill"],
       "rle_mcnt_share.index": ["rle/mcnt"],
       "dump_encode_share.index": ["dump/encode"],
       "dump_write_share.index": ["dump/write"],
       "bwt_copy_share.index": ["bwt/upload", "bwt/download"]}


def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    return load_module(path, "t_" + name.replace(".", "_")).read


def _build(at, ids):
    """The spans of one build starting at `at` seconds, at hand-picked
    offsets (ns): build_index [0, 10] s with frags [0, 1), text [1, 1.5),
    bwt [1.5, 3.5) (upload 0.1 s, download 0.2 s), rle [3.5, 8) (count
    0.5, fill 2, mcnt 1.75 s), dump [8, 9.75) (encode 1.5, write 0.2 s):
    self time 0.25 s, at its end."""
    rows = []

    def add(name, a, b, parent):
        s = spans.Span(next(ids), name, parent, 1)
        s.start_ns, s.end_ns = int((at + a) * S), int((at + b) * S)
        rows.append(s)
        return s.index
    root = add("build_index", 0, 10, None)
    add("frags", 0, 1, root)
    add("text", 1, 1.5, root)
    bwt = add("bwt", 1.5, 3.5, root)
    add("bwt/upload", 1.5, 1.6, bwt)
    add("bwt/round", 1.6, 3.0, bwt)
    add("bwt/download", 3.3, 3.5, bwt)
    rle = add("rle", 3.5, 8.0, root)
    add("rle/count", 3.5, 4.0, rle)
    add("rle/fill", 4.0, 6.0, rle)
    add("rle/mcnt", 6.0, 7.75, rle)
    dump = add("dump", 8.0, 9.75, root)
    add("dump/encode", 8.0, 9.5, dump)
    add("dump/write", 9.5, 9.7, dump)
    return rows


@pytest.fixture
def window(monkeypatch):
    """A window of two units at [100, 111) s and [111, 122) s, one build
    in each; a warm-up build before and a check's build after."""
    import itertools

    ids = itertools.count()
    rows = _build(80, ids) + _build(100.5, ids) + _build(111.5, ids) + \
        _build(130, ids)
    monkeypatch.setattr(spans, "rows", lambda: list(rows))
    harness_rows = [("warmup", 80 * S, 90 * S, 1),
                    ("unit", 100 * S, 111 * S, 1),
                    ("build_index", int(100.5 * S), int(110.5 * S), 2),
                    ("unit", 111 * S, 122 * S, 1),
                    ("build_index", int(111.5 * S), int(121.5 * S), 2)]
    return {"window_s": 22.0, "units": 2, "work": {}, "counters": {},
            "trace": None, "spans": harness_rows}


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_share_sums_the_window_units_rows(window, name):
    per_build = {"rle/count": 0.5, "rle/fill": 2.0, "rle/mcnt": 1.75,
                 "dump/encode": 1.5, "dump/write": 0.2, "bwt/upload": 0.1,
                 "bwt/download": 0.2}
    want = 100.0 * 2 * sum(per_build[n] for n in NEW[name]) / 22.0
    assert _reader(name)(window) == pytest.approx(want, rel=1e-9)


def test_build_self_share(window):
    # 10 s less 1 + 0.5 + 2 + 4.5 + 1.75 covered, in each of two builds
    want = 100.0 * 2 * 0.25 / 22.0
    assert _reader("build_self_share.index")(window) == \
        pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", sorted(NEW) + ["build_self_share.index"])
def test_no_rows_read_none(window, monkeypatch, name):
    read = _reader(name)
    monkeypatch.setattr(spans, "rows", lambda: [])
    assert read(window) is None
    assert read(dict(window, units=0, spans=[])) is None


@pytest.mark.parametrize("name", sorted(NEW) + ["build_self_share.index"])
def test_rows_outside_every_unit_read_none(window, name):
    assert _reader(name)(dict(window, spans=[
        s for s in window["spans"] if s[0] != "unit"])) is None


@pytest.mark.parametrize("name", sorted(NEW) + ["build_self_share.index"])
def test_a_program_without_the_recorder_reads_none(window, monkeypatch,
                                                   name):
    """The parent of the recorder's commit: the import fails, the reader
    reads None and does not raise."""
    import fermi_tpu_torch

    monkeypatch.delattr(fermi_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "fermi_tpu_torch.spans", None)
    assert _reader(name)(window) is None


def test_traced_tiny_index_reads_the_spans(run_tiny):
    """A traced CPU run of the tiny index cell reports the seven span
    metrics beside the four build parts, and each part's children lie
    inside it."""
    res = run_tiny("tiny.index", trace=1)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"]
    assert set(m) == set(NEW) | {"build_self_share.index",
                                 "encode_share.index", "bwt_share.index",
                                 "rle_share.index", "dump_share.index"}
    assert all(v >= 0 for v in m.values())
    assert res["metrics"]["rle_fill_share.index"]["unit"] == "%"
    eps = 1e-6
    assert m["rle_count_share.index"] + m["rle_fill_share.index"] + \
        m["rle_mcnt_share.index"] <= m["rle_share.index"] + eps
    assert m["dump_encode_share.index"] + m["dump_write_share.index"] <= \
        m["dump_share.index"] + eps
    assert m["bwt_copy_share.index"] <= m["bwt_share.index"] + eps
    assert m["build_self_share.index"] < 100.0 - sum(
        m[k] for k in ("encode_share.index", "bwt_share.index",
                       "rle_share.index", "dump_share.index")) + eps
