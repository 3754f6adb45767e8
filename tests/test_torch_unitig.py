"""Unitig and clean in the port (fermi_tpu_torch.search.unitig_links,
algos.unitig_bulk, algos.mag, CLI `unitig` and `clean`) against fermi_tpu on
the CPU.  Link records are integers and the MAG files bytes: tolerance zero.

Fixtures follow tests/test_unitig_bulk.py: 15x error-free reads with exact
duplicates, 12x error-free, and 42x with up to 2% substitutions (wide
interval sets, dense category groups, rows for the redo ladder)."""

import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from fermi_tpu import rld as jrld
from fermi_tpu.algos import unitig_bulk as JB
from fermi_tpu.algos.hostindex import HostIndex
from fermi_tpu.cli import main as jcli
from fermi_tpu.index.fmd import FMDIndex as JIndex
from fermi_tpu.search import unitig_links as JL
from fermi_tpu_torch.algos import unitig_bulk as TB
from fermi_tpu_torch.cli import main as tcli
from fermi_tpu_torch.index.fmd import FMDIndex
from fermi_tpu_torch.search import unitig_links as TL

from native_lock import load_fermi_tpu_native
from util import build_my_fmd

torch.set_num_threads(1)
load_fermi_tpu_native()

# name: (seed, genome bp, read bp, coverage, max substitution rate,
#        exact duplicates, min_match, batch)
RECIPES = {"15x": (7, 2000, 80, 15, 0.0, 10, 30, 256),
           "12x": (13, 1500, 80, 12, 0.0, 0, 30, 256),
           "42x": (43, 1200, 92, 42, 0.02, 0, 28, 512)}


def _reads(seed, glen, L, cov, err, dups):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen)
    comp = np.array([3, 2, 1, 0])
    reads = []
    for _ in range(glen * cov // L):
        p = int(rng.integers(0, glen - L))
        r = genome[p:p + L].copy()
        if err:
            ne = rng.binomial(L, rng.uniform(0, err))
            if ne:
                pos = rng.integers(0, L, ne)
                r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
        if rng.random() < 0.5:
            r = comp[r][::-1]
        reads.append("".join("ACGT"[c] for c in r))
    return reads + reads[:dups]


_CASES = {}


@pytest.fixture()
def case(request, tmp_path_factory):
    """One recipe's index (fermi_tpu's host index and the port's, on the
    CPU), its stored sequences and fermi_tpu's device link records; made
    once per recipe and module."""
    name = request.param
    if name not in _CASES:
        seed, glen, L, cov, err, dups, mm, batch = RECIPES[name]
        fmd = str(tmp_path_factory.mktemp(name) / "i.fmd")
        build_my_fmd(_reads(seed, glen, L, cov, err, dups), fmd)
        e = HostIndex.from_runs(jrld.read_fmd(fmd))
        seqs, ks = JB.retrieve_all(e)
        jstore = JL.compute_links_device(JIndex.restore(fmd), seqs, mm,
                                         batch=batch)
        _CASES[name] = dict(name=name, fmd=fmd, e=e, seqs=seqs, ks=ks, mm=mm,
                            batch=batch, jstore=jstore,
                            tidx=FMDIndex.restore(fmd, "cpu"))
    return _CASES[name]


def _arrays(store):
    return [store.valid, store.ret, store.intv0, store.has_ovlp, store.nein,
            store.sbn, store.forked, store.redo, *store.nei_buf,
            *store.sb_buf]


def _assert_same(a, b, dtype=True):
    for x, y in zip(_arrays(a), _arrays(b)):
        assert x.shape == y.shape
        if dtype:
            assert x.dtype == y.dtype
        assert np.array_equal(x, y)


@pytest.mark.parametrize("case", list(RECIPES), indirect=True)
def test_links_equal_fermi_tpu(case):
    """Every LinkStore array, redo and forked included, equals fermi_tpu's
    device records; the 42x case runs the ladder."""
    store = TL.compute_links_device(case["tidx"], case["seqs"], case["mm"],
                                    batch=case["batch"], device="cpu")
    _assert_same(store, case["jstore"])
    assert TL.STATS["unique"] == len({s.tobytes() for s in case["seqs"]})
    if case["name"] == "42x":
        assert TL.STATS["ladder_rows"] > 0
        assert store.forked.any()


@pytest.mark.parametrize("case", ["42x"], indirect=True)
def test_links_independent_of_batch(case):
    got = [TL.compute_links_device(case["tidx"], case["seqs"], case["mm"],
                                   batch=b, ladder_batch=lb, device="cpu")
           for b, lb in ((97, 37), (4096, 4096))]
    _assert_same(got[0], got[1])
    _assert_same(got[0], case["jstore"])


@pytest.mark.parametrize("case", ["42x"], indirect=True)
def test_int64_domain(case, monkeypatch):
    """The wide index domain gives the same records (in int64 buffers) and
    the same MAG bytes."""
    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    idx64 = FMDIndex.restore(case["fmd"], "cpu")
    assert idx64.idtype == torch.int64
    store = TL.compute_links_device(idx64, case["seqs"], case["mm"],
                                    batch=case["batch"], device="cpu")
    assert store.nei_buf[0].dtype == np.int64
    _assert_same(store, case["jstore"], dtype=False)
    want, _ = JB.stitch_native(case["e"], case["jstore"], case["seqs"],
                               case["ks"], case["mm"])
    got, _ = TB.stitch_native(idx64, store, case["seqs"], case["ks"],
                              case["mm"])
    assert got == want


@pytest.mark.parametrize("case", ["42x"], indirect=True)
def test_stitch_native_equals_fermi_tpu(case):
    """The port's stitch on the port's store equals fermi_tpu's stitch on the
    same store, without and with a rank array."""
    from fermi_tpu.algos.seqsort import seqsort_native

    store = TL.compute_links_device(case["tidx"], case["seqs"], case["mm"],
                                    batch=case["batch"], device="cpu")
    srt = seqsort_native(case["e"], verbose=False)
    for use_srt in (None, srt):
        want = JB.stitch_native(case["e"], store, case["seqs"], case["ks"],
                                case["mm"], sorted_arr=use_srt)
        got = TB.stitch_native(case["tidx"], store, case["seqs"],
                               case["ks"], case["mm"], sorted_arr=use_srt)
        assert got == want and got[0].count("\n+\n") > 3


@pytest.mark.parametrize("case", ["12x"], indirect=True)
def test_records_equal_host_spec(case, tmp_path):
    """The port's records read as Link objects equal fermi_tpu's host
    specification `compute_link_host`; fermi_tpu's Python `stitch` over the
    port's store gives the MAG of its sequential oracle; a saved store loads
    back equal."""
    from fermi_tpu.algos.unitig import UnitigBuilder

    e, seqs, mm = case["e"], case["seqs"], case["mm"]
    store = TL.compute_links_device(case["tidx"], seqs, mm, device="cpu")
    fields = ("ok", "ret", "intv0", "has_ovlp", "nei", "forked", "sbits")
    for x in range(len(seqs)):
        lh, ld = JB.compute_link_host(e, seqs[x], mm), store[x]
        assert [getattr(lh, f) for f in fields] == \
            [getattr(ld, f) for f in fields], x
    want, got = io.StringIO(), io.StringIO()
    UnitigBuilder(e, mm).run(want)
    JB.stitch(e, store, seqs, case["ks"], mm, got)
    assert got.getvalue() == want.getvalue()
    TL.save_store(store, str(tmp_path / "s.npz"))
    _assert_same(TL.load_store(str(tmp_path / "s.npz")), store)


def test_seg_cummin_equals_loop():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 40, (50, 32)).astype(np.int32)
    v[rng.random(v.shape) < 0.5] = 2**31 - 1
    b = rng.random(v.shape) < 0.3
    b[:, 0] = True
    want = v.copy()
    for r in range(v.shape[0]):
        for j in range(1, v.shape[1]):
            if not b[r, j]:
                want[r, j] = min(want[r, j - 1], v[r, j])
    got = TL._seg_cummin(torch.from_numpy(v), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["12x"], indirect=True)
def test_reads_of_1024_bp_raise(case):
    """Sequences of 1,024 bp and more, which fermi_tpu's device records
    refuse (its 10-bit key), get records in the port, whose key has room
    for any length; the stored sequences beside them keep fermi_tpu's host
    records `compute_link_host` (tests/test_torch_unitig.py's long-read
    cases hold whole MAGs of long reads to fermi_tpu's `unitig`)."""
    fields = ("ok", "ret", "intv0", "has_ovlp", "nei", "forked", "sbits")
    seqs = case["seqs"][:3] + [np.ones(1023, np.uint8),
                               np.ones(1024, np.uint8)]
    with pytest.raises(ValueError, match="1024"):
        JL.compute_links_device(JIndex.restore(case["fmd"]), seqs, 30)
    store = TL.compute_links_device(case["tidx"], seqs, 30, device="cpu")
    for x in range(3):
        lh, ld = JB.compute_link_host(case["e"], seqs[x], 30), store[x]
        assert [getattr(lh, f) for f in fields] == \
            [getattr(ld, f) for f in fields], x
    assert store.valid[-2:].all()


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def rank_file(tmp_path_factory):
    """The 42x index and its .rank array, from fermi_tpu."""
    from fermi_tpu.algos.seqsort import seqsort_native

    d = tmp_path_factory.mktemp("rank")
    fmd = str(d / "i.fmd")
    build_my_fmd(_reads(*RECIPES["42x"][:6]), fmd)
    rank = str(d / "i.rank")
    seqsort_native(HostIndex.from_runs(jrld.read_fmd(fmd)),
                   verbose=False).tofile(rank)
    return fmd, rank


@pytest.mark.parametrize("mm", [30, 50])
@pytest.mark.parametrize("with_rank", [False, True])
def test_cli_unitig_equals_fermi_tpu(rank_file, mm, with_rank):
    """`unitig --device cpu` equals fermi_tpu's CLI `unitig` (its host engine,
    -t 1) byte for byte."""
    fmd, rank = rank_file
    args = ["-l", str(mm), *(["-r", rank] if with_rank else []), fmd]
    rc, want, _ = _run(jcli.main, ["unitig", *args])
    assert rc == 0 and want.count("\n+\n") > 3
    rc, got, _ = _run(tcli.main, ["unitig", "--device", "cpu", *args])
    assert rc == 0
    assert got == want


def test_cli_unitig_threads_take_the_card_path(rank_file):
    """Without -M, `unitig -t 4` runs the card path (its plain versions
    here) and prints `-t 1`'s bytes, fermi_tpu's CLI `unitig -t 1`."""
    fmd, rank = rank_file
    args = ["-l", "30", "-r", rank, fmd]
    rc, want, _ = _run(jcli.main, ["unitig", "-t", "1", *args])
    assert rc == 0 and want.count("\n+\n") > 3
    for t in ("4", "1"):
        rc, got, _ = _run(tcli.main, ["unitig", "--device", "cpu", "-t", t,
                                      *args])
        assert rc == 0 and got == want


def long_reads(seed=17, glen=12000, cov=15, lo=1024, hi=3000):
    """Reads of lo-hi bp (1,024 is the first length fermi_tpu's device
    records refuse), cov-x of a random genome with a 1,500 bp repeat at two
    places and 0.2% substitutions, half reverse-complemented: unitigs that
    branch at the repeat."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen)
    genome[7000:8500] = genome[1500:3000]
    reads = []
    for _ in range(glen * cov // ((lo + hi) // 2)):
        n = int(rng.integers(lo, hi + 1))
        p = int(rng.integers(0, glen - n))
        r = genome[p:p + n].copy()
        err = rng.random(n) < 0.002
        r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads.append("".join("ACGT"[c] for c in r))
    return reads


@pytest.fixture(scope="module")
def long_rank_file(tmp_path_factory):
    """The long reads' index and its .rank array, from fermi_tpu."""
    from fermi_tpu.algos.seqsort import seqsort_native

    d = tmp_path_factory.mktemp("long")
    fmd = str(d / "i.fmd")
    build_my_fmd(long_reads(), fmd)
    rank = str(d / "i.rank")
    seqsort_native(HostIndex.from_runs(jrld.read_fmd(fmd)),
                   verbose=False).tofile(rank)
    return fmd, rank


@pytest.mark.parametrize("with_rank", [False, True])
def test_cli_unitig_long_reads(long_rank_file, with_rank):
    """`unitig --device cpu -l 100` of 1,024-3,000 bp reads: fermi_tpu's CLI
    `unitig` (its host walk) byte for byte; the card path takes them (its
    records cover every length)."""
    fmd, rank = long_rank_file
    args = ["-l", "100", *(["-r", rank] if with_rank else []), fmd]
    rc, want, _ = _run(jcli.main, ["unitig", *args])
    assert rc == 0 and want.count("\n+\n") > 1
    rc, got, _ = _run(tcli.main, ["unitig", "--device", "cpu", *args])
    assert rc == 0
    assert got == want
    assert TL.STATS["unique"] > 0 and TL.STATS["walk_rounds"] >= 1024


def _repeat_reads():
    """Two copies of a 500 bp core around 800 bp, and a SNP haplotype over
    part of it: bubbles and repeats for the clean stage (the recipe of
    tests/test_mag.py)."""
    rng = np.random.default_rng(43)
    core = "".join("ACGT"[c] for c in rng.integers(0, 4, 500))
    g1 = core + "".join("ACGT"[c] for c in rng.integers(0, 4, 800)) + core
    reads = [g1[p:p + 75] for p in range(0, len(g1) - 75, 6)]
    g2 = list(g1)
    g2[700] = "A" if g2[700] != "A" else "C"
    g2 = "".join(g2)
    return reads + [g2[p:p + 75] for p in range(400, 1100, 11)]


def _noisy_reads(seed=41, n=700, glen=6000, rl=80, err=0.005):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen)
    reads = []
    for _ in range(n):
        pos = int(rng.integers(0, glen - rl))
        r = genome[pos:pos + rl].copy()
        for _ in range(rng.binomial(rl, err)):
            p = int(rng.integers(0, rl))
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads.append("".join("ACGT"[c] for c in r))
    return reads


@pytest.fixture(scope="module", params=["repeats", "noisy"])
def mag_file(request, tmp_path_factory):
    """A MAG file from fermi_tpu's `unitig`, plain and gzipped."""
    d = tmp_path_factory.mktemp("mag")
    fmd = str(d / "i.fmd")
    reads, mm = ((_repeat_reads(), 40) if request.param == "repeats"
                 else (_noisy_reads(), 30))
    build_my_fmd(reads, fmd)
    rc, mag, _ = _run(jcli.main, ["unitig", "-l", str(mm), fmd])
    assert rc == 0
    path = str(d / "p0.mag")
    with open(path, "w") as f:
        f.write(mag)
    with gzip.open(path + ".gz", "wt") as f:
        f.write(mag)
    return path


@pytest.mark.parametrize("flags", [[], ["-C"],
                                   ["-C", "-A", "-O", "-F", "-o", "60"]])
@pytest.mark.parametrize("gz", [False, True])
def test_cli_clean_equals_fermi_tpu(mag_file, flags, gz):
    path = mag_file + (".gz" if gz else "")
    rc, want, _ = _run(jcli.main, ["clean", *flags, path])
    assert rc == 0 and want
    rc, got, _ = _run(tcli.main, ["clean", *flags, path])
    assert rc == 0
    assert got == want


def test_truncated_gz_mag_raises(tmp_path):
    """The MAG reader checks its gzip child's exit status."""
    from fermi_tpu_torch.algos import mag

    text = "".join(f"@{2 * i}:{2 * i + 1}\t1\t.\t.\n{'ACGT' * 100}\n+\n"
                   f"{'#' * 400}\n" for i in range(500))
    blob = gzip.compress(text.encode())
    path = tmp_path / "t.mag.gz"
    path.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(OSError, match="gzip"):
        mag.mag_read(str(path), dict(mag.DEFAULT_OPT))
