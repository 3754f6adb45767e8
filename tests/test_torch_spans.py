"""The port's span recorder (fermi_tpu_torch/spans.py) and the spans of
the index build: nesting, the ring, the epoch clock, the build's span
tree, BUILD_STATS and blocked.STATS as the spans' durations, and the
writer's bytes against the one-call encoder."""

import ctypes
import gzip
import threading
import time

import numpy as np
import pytest
import torch

from fermi_tpu_torch import native, rld, spans
from fermi_tpu_torch.construct import blocked, suffix
from fermi_tpu_torch.core import dna
from fermi_tpu_torch.pipeline import driver

from util import random_reads, write_fasta, write_fastq

torch.set_num_threads(1)

BUILD_TREE = {"build_index": None, "frags": "build_index",
              "text": "build_index", "bwt": "build_index",
              "bwt/upload": "bwt", "bwt/round": "bwt",
              "bwt/download": "bwt", "rle": "build_index",
              "rle/count": "rle", "rle/fill": "rle", "rle/mcnt": "rle",
              "dump": "build_index", "dump/encode": "dump",
              "dump/write": "dump"}


def test_nesting_parents_and_threads():
    rec = spans.Recorder()
    with rec.span("a") as a:
        with rec.span("b") as b:
            pass
    box = []

    def other():
        with rec.span("c") as c:
            box.append(c)
    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    c, = box
    assert [r.name for r in rec.rows()] == ["b", "a", "c"]
    assert (a.parent, b.parent, c.parent) == (None, a.index, None)
    assert len({a.index, b.index, c.index}) == 3
    assert a.thread == b.thread == threading.get_ident() != c.thread
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns


def test_a_span_closes_on_an_exception():
    rec = spans.Recorder()
    with pytest.raises(KeyError), rec.span("x"):
        raise KeyError(1)
    with rec.span("y") as y:
        pass
    assert [r.name for r in rec.rows()] == ["x", "y"] and y.parent is None


def test_the_ring_keeps_the_last_rows():
    rec = spans.Recorder(maxlen=4)
    for i in range(10):
        with rec.span(f"s{i}"):
            pass
    assert [r.name for r in rec.rows()] == ["s6", "s7", "s8", "s9"]
    rec.clear()
    assert rec.rows() == []
    assert spans.RING == 65536 and \
        spans._recorder._ring.maxlen == spans.RING


def test_times_are_epoch_ns():
    rec = spans.Recorder()
    before = time.time_ns()
    with rec.span("x") as x:
        time.sleep(0.01)
    after = time.time_ns()
    assert before <= x.start_ns <= x.end_ns <= after
    assert x.seconds >= 0.01 and x.end_ns - x.start_ns >= 10_000_000


def _fastq_pair(tmp_path):
    reads = random_reads(600, min_len=60, max_len=101, seed=19,
                         with_genome=True, genome_len=4000)
    fq = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    write_fastq(fq[0], reads[:300])
    write_fastq(fq[1], reads[300:])
    return fq


def _tree(rows, root):
    """The spans under `root` (itself included), by index."""
    by = {root.index: root}
    for r in sorted(rows, key=lambda r: r.index):
        if r.parent in by:
            by[r.index] = r
    return by


def _maximal_runs(runs):
    x = runs.expand()
    return int(np.count_nonzero(x[1:] != x[:-1])) + 1 if x.size else 0


def test_build_index_span_tree(tmp_path):
    fq = _fastq_pair(tmp_path)
    out = str(tmp_path / "o.fmd")
    p = driver.Pipeline(str(tmp_path / "x"), device="cpu")
    spans.clear()
    driver.BUILD_STATS.clear()
    p.build_index(iter(()), out, paths=fq)
    rows = spans.rows()
    root, = [r for r in rows if r.name == "build_index"]
    tree = _tree(rows, root)
    names = {r.name for r in tree.values()}
    assert names == set(BUILD_TREE)
    for r in tree.values():
        want = BUILD_TREE[r.name]
        assert (tree[r.parent].name if r.parent is not None else None) \
            == want, r
        if r.parent is not None:
            up = tree[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    kids = sorted((r for r in tree.values() if r.parent == root.index),
                  key=lambda r: r.start_ns)
    assert [r.name for r in kids] == ["frags", "text", "bwt", "rle", "dump"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    by_name = {r.name: r for r in kids}

    # BUILD_STATS: the five child spans' durations, and the symbols
    st = driver.BUILD_STATS
    assert sorted(st) == sorted(["fragments", "symbols", "frags_s",
                                 "text_s", "bwt_s", "rle_s", "dump_s"])
    for k, r in by_name.items():
        assert st[f"{k}_s"] == r.seconds
    got = rld.read_fmd(out)
    assert st["symbols"] == got.total
    assert len(p._runs(out).lengths) == _maximal_runs(got)
    rounds = [r for r in tree.values() if r.name == "bwt/round"]
    assert 1 <= len(rounds) <= 8            # reads of at most 100 bp


def test_build_index_from_reads_and_fasta(tmp_path):
    """The record route (reads as strings, or a file the native encoders
    refuse) gives one `frags` span and the same index."""
    reads = random_reads(120, min_len=30, max_len=80, seed=5)
    fa = str(tmp_path / "r.fa")
    write_fasta(fa, reads)
    p = driver.Pipeline(str(tmp_path / "x"), device="cpu")
    outs = []
    for i, paths in enumerate((None, [fa])):
        out = str(tmp_path / f"o{i}.fmd")
        spans.clear()
        p.build_index(iter(reads), out, paths=paths)
        rows = spans.rows()
        assert [r.name for r in rows].count("frags") == 1
        assert [r.name for r in rows].count("build_index") == 1
        frags, = [r for r in rows if r.name == "frags"]
        assert driver.BUILD_STATS["frags_s"] == frags.seconds
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


def test_ec_fmd_spans(tmp_path):
    reads = random_reads(300, min_len=60, max_len=101, seed=23,
                         with_genome=True, genome_len=3000)
    pre = str(tmp_path / "x")
    with gzip.open(pre + ".ec.fq.gz", "wt") as f:
        for i, s in enumerate(reads):
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    p = driver.Pipeline(pre, device="cpu")
    spans.clear()
    p.stage_ec_fmd()
    rows = spans.rows()
    kids = sorted((r for r in rows if r.parent is None),
                  key=lambda r: r.start_ns)
    assert [r.name for r in kids] == ["frags", "text", "bwt", "rle", "dump"]
    assert driver.BUILD_STATS["frags_s"] == kids[0].seconds
    assert rld.read_fmd(pre + ".ec.fmd").total == \
        driver.BUILD_STATS["symbols"]


def test_blocked_stats_are_its_spans():
    reads = random_reads(200, min_len=40, max_len=90, seed=31)
    text = suffix.build_text([dna.encode(s) for s in reads])
    spans.clear()
    got = blocked.device_build_text(text, block_symbols=3000, device="cpu")
    rows = spans.rows()
    sorts = [r for r in rows if r.name == "bwt/block_sort"]
    folds = [r for r in rows if r.name == "bwt/fold"]
    st = blocked.STATS
    assert st["blocks"] == len(sorts) == len(folds) + 1 > 2
    assert st["sort_s"] == pytest.approx(sum(r.seconds for r in sorts))
    assert st["merge_s"] == pytest.approx(sum(r.seconds for r in folds))
    assert [r.name for r in rows].count("bwt/upload") == 1
    assert [r.name for r in rows][-1] == "bwt/download"
    from fermi_tpu_torch.construct.suffix_device import \
        multistring_bwt_device
    assert np.array_equal(got, multistring_bwt_device(text, "cpu"))


def _encode_file(runs, path, sbits=3):
    """The one-call encoder, frld_encode_file."""
    lib = native.get_lib()
    lengths = np.ascontiguousarray(runs.lengths, np.int64)
    symbols = np.ascontiguousarray(runs.symbols, np.uint8)
    rc = lib.frld_encode_file(
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(lengths), runs.asize, sbits, path.encode())
    assert rc == 0


def _random_runs(n, seed, merge):
    """n runs of random symbols and lengths; adjacent equal symbols are
    left in unless `merge`."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 6, n).astype(np.uint8)
    if merge and n:
        sym[1:] = (sym[:-1] + 1 + rng.integers(0, 5, n - 1)) % 6
    lens = rng.choice([1, 1, 2, 3, 17, 300, 70_000], n).astype(np.int64)
    mcnt = np.zeros(7, np.uint64)
    mcnt[1:] = np.bincount(sym, weights=lens, minlength=6)[:6]
    mcnt[0] = lens.sum()
    return rld.Runs(lens, sym, mcnt, 6)


@pytest.mark.parametrize("n, seed, merge", [
    (0, 0, True), (1, 1, True), (7, 2, False), (5000, 3, True),
    (5000, 4, False), (200_000, 5, False)])
def test_write_fmd_bytes_equal_the_one_call_encoder(tmp_path, n, seed, merge):
    runs = _random_runs(n, seed, merge)
    a, b = str(tmp_path / "a.fmd"), str(tmp_path / "b.fmd")
    spans.clear()
    rld.write_fmd(runs, a)
    _encode_file(runs, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    names = [r.name for r in spans.rows()]
    assert names == ["dump/encode", "dump/write"]


def test_write_fmd_of_a_build_equals_the_one_call_encoder(tmp_path):
    fq = _fastq_pair(tmp_path)
    out, one = str(tmp_path / "o.fmd"), str(tmp_path / "one.fmd")
    p = driver.Pipeline(str(tmp_path / "x"), device="cpu")
    p.build_index(iter(()), out, paths=fq)
    _encode_file(p._runs(out), one)
    assert open(out, "rb").read() == open(one, "rb").read()


def test_write_fmd_raises_on_an_unwritable_path(tmp_path):
    runs = _random_runs(10, 6, True)
    with pytest.raises(IOError):
        rld.write_fmd(runs, str(tmp_path / "no" / "such" / "dir.fmd"))


def test_write_fmd_to_standard_output(tmp_path, capfdbinary):
    runs = _random_runs(3000, 7, True)
    a = str(tmp_path / "a.fmd")
    _encode_file(runs, a)
    capfdbinary.readouterr()
    spans.clear()
    rld.write_fmd(runs, "-")
    assert capfdbinary.readouterr().out == open(a, "rb").read()
    assert [r.name for r in spans.rows()] == ["dump/encode", "dump/write"]


# merge_files' parts under its root `merge`, in order, for n inputs
def _merge_parts(n):
    fold = ["merge/restore", "merge/gap_walk", "merge/interleave"]
    return (["merge/restore"] + fold
            + (["merge/rebuild"] + fold) * (n - 2)
            + ["merge/download", "rle", "dump"])


MERGE_KIDS = {"merge/restore": ["restore/decode", "restore/layout"],
              "rle": ["rle/count", "rle/fill", "rle/mcnt"],
              "dump": ["dump/encode", "dump/write"]}


@pytest.mark.parametrize("n", [2, 3])
def test_merge_span_tree(tmp_path, n):
    """merge_files opens `merge` with its parts in order, one restore an
    input and a gap walk and an interleave a fold (a rebuild of the
    running index before each fold past the first); each restore holds
    the decoder's and the layout's spans, the RLE's and the writer's
    their own; FILE_STATS' seconds are the parts' spans' seconds."""
    from fermi_tpu_torch.algos import merge as mg

    reads = random_reads(300 * n, min_len=60, max_len=101, seed=23,
                         with_genome=True, genome_len=4000)
    fmds = []
    for i in range(n):
        fq = str(tmp_path / f"r{i}.fq")
        write_fastq(fq, reads[300 * i: 300 * (i + 1)])
        fmds.append(str(tmp_path / f"r{i}.fmd"))
        driver.Pipeline(str(tmp_path / f"x{i}"), device="cpu").build_index(
            iter(()), fmds[-1], paths=[fq])
    spans.clear()
    mg.merge_files(fmds, str(tmp_path / "m.fmd"), torch.device("cpu"))
    rows = spans.rows()
    root, = [r for r in rows if r.name == "merge"]
    assert root.parent is None
    tree = _tree(rows, root)
    kids = sorted((r for r in tree.values() if r.parent == root.index),
                  key=lambda r: r.start_ns)
    assert [r.name for r in kids] == _merge_parts(n)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    for k in kids:
        assert root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns
        under = sorted((r for r in tree.values() if r.parent == k.index),
                       key=lambda r: r.start_ns)
        assert [r.name for r in under] == MERGE_KIDS.get(k.name, [])
        assert all(k.start_ns <= r.start_ns <= r.end_ns <= k.end_ns
                   for r in under)
    assert len(tree) == len(kids) + 1 + sum(
        len(MERGE_KIDS.get(k.name, [])) for k in kids)
    secs = mg.FILE_STATS["seconds"]
    assert {mg.MERGE_SPANS[k] for k in secs} == set(_merge_parts(n))
    for k, v in secs.items():
        assert v == sum(r.seconds for r in kids
                        if r.name == mg.MERGE_SPANS[k]), k
    assert mg.FILE_STATS["device_peak"] == {}
