"""The port's scaffolder (fermi_tpu_torch.algos.scaf) and the host code
under it (ksw_align, HostIndex, the unitig builder, fm6_api_unitig)
against fermi_tpu on the CPU.  Outputs are bytes and integers: tolerance
zero.

The scaffolding fixture is the linked-pair genome of tests/test_scaf.py (a
160 bp repeat and a dead zone where no read starts), taken through
fermi_tpu's own seqsort, unitig -l 40 -r, clean -CAOFo 48 and remap -r:
its p3 has gaps that the local assemblies patch, and at other insert sizes
gaps that the t-test rejects or the SW join fails on."""

import contextlib
import io

import numpy as np
import pytest
import torch

from fermi_tpu import rld as jrld
from fermi_tpu.algos import mag as JM
from fermi_tpu.algos import scaf as JS
from fermi_tpu.algos.hostindex import HostIndex as JHostIndex
from fermi_tpu.algos.ksw import ksw_align as j_ksw_align
from fermi_tpu.algos.remap import remap as jremap
from fermi_tpu.algos.seqsort import seqsort_native
from fermi_tpu.algos.unitig import fm6_unitig as j_fm6_unitig
from fermi_tpu.cli.main import main as jmain
from fermi_tpu.construct import suffix as jsuffix
from fermi_tpu.core import dna as jdna
from fermi_tpu_torch import rld as trld
from fermi_tpu_torch.algos import mag as TM
from fermi_tpu_torch.algos import scaf as TS
from fermi_tpu_torch.algos.hostindex import HostIndex as THostIndex
from fermi_tpu_torch.algos.ksw import ksw_align as t_ksw_align
from fermi_tpu_torch.algos.unitig import fm6_unitig as t_fm6_unitig
from fermi_tpu_torch.cli.main import main as tmain
from fermi_tpu_torch.index.fmd import FMDIndex
from fermi_tpu_torch.ops import rank_cuda

from util import build_my_fmd, random_reads, revcomp_str

torch.set_num_threads(1)


def linked_pair_reads(seed=1, rl=70, insert=240):
    """tests/test_scaf.py's linked-pair genome: two copies of a 160 bp
    repeat, and a dead zone of 48 bp at one junction where no read starts;
    ~3,900 pairs, mates adjacent, the second reverse-complemented."""
    rng = np.random.default_rng(seed)
    rep = "".join("ACGT"[c] for c in rng.integers(0, 4, 160))
    segs = ["".join("ACGT"[c] for c in rng.integers(0, 4, n))
            for n in (2200, 1400, 2000, 1500)]
    genome = segs[0] + rep + segs[1] + segs[2] + rep + segs[3]
    jn = len(segs[0]) + 160 + len(segs[1])
    dead = (jn - 38, jn + 10)
    reads = []
    for _ in range(4000):
        ins = int(np.clip(rng.normal(insert, 22), rl + 10, 450))
        pos = int(rng.integers(0, len(genome) - ins))
        r0 = pos + ins - rl
        if dead[0] < pos < dead[1] or dead[0] < r0 < dead[1]:
            continue
        reads.append(genome[pos:pos + rl])
        reads.append(revcomp_str(genome[r0:r0 + rl]))
    return reads


@pytest.fixture(scope="module")
def linked(tmp_path_factory):
    """(fmd, p3 path, avg, std) of the linked-pair reads through
    fermi_tpu's chain."""
    d = tmp_path_factory.mktemp("scaf")
    fmd = str(d / "br.fmd")
    runs = build_my_fmd(linked_pair_reads(), fmd)
    host = JHostIndex.from_runs(runs)
    arr = seqsort_native(host, n_threads=1)
    p0 = io.StringIO()
    j_fm6_unitig(host, 40, p0, arr, n_threads=1)
    (d / "p0.mag").write_text(p0.getvalue())
    opt = dict(JM.DEFAULT_OPT)
    opt.update(flag_clean=True, flag_aggressive=True, flag_read_ori=True,
               flag_no_amend=True, min_ovlp=48)
    g = JM.mag_read(str(d / "p0.mag"), opt)
    JM.g_clean(g, opt)
    with open(d / "p2.mag", "w") as f:
        JM.mag_print(g, f)
    with open(d / "p3.mag", "w") as f, \
            contextlib.redirect_stderr(io.StringIO()):
        avg, std, _ = jremap(host, str(d / "p2.mag"), f, arr)
    return fmd, str(d / "p3.mag"), avg, std


def _scaf(fn, index, p3, avg, std, pr_links):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        fn(index, p3, avg, std, pr_links=pr_links, out_fp=out)
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("distort,pr_links", [(1.0, True), (2.5, False),
                                              (0.4, False)])
def test_scaf_core(linked, monkeypatch, distort, pr_links):
    """Scaftig bytes and every stderr line (rdist, SW, and with -P the CT
    and LK dumps) equal fermi_tpu's at the fitted insert size (gaps patched
    by local assembly), at 2.5x (the t-test rejects every patch) and at
    0.4x (the SW join fails and says so).  The mates are walked in one
    batch (K1 on the card; on the CPU the plain version, which counts no
    launch), never one read at a time."""
    fmd, p3, avg, std = linked
    avg, std = avg * distort, std * distort
    patched, ts, walks = [], [], []
    assemble, compute_t = TS.assemble, TS.compute_t
    retrieve = TS.retrieve_mates

    def spy_assemble(*a):
        ext = assemble(*a)
        patched.append(ext["patched"])
        return ext

    def spy_t(*a):
        t = compute_t(*a)
        ts.append(t)
        return t

    monkeypatch.setattr(TS, "assemble", spy_assemble)
    monkeypatch.setattr(TS, "compute_t", spy_t)
    monkeypatch.setattr(TS, "retrieve_mates", lambda index, ids: walks.append(
        len(ids)) or retrieve(index, ids))
    idx = FMDIndex.from_runs(trld.read_fmd(fmd), "cpu")
    before = dict(rank_cuda.LAUNCHES)
    got = _scaf(TS.scaf_core, idx, p3, avg, std, pr_links)
    assert rank_cuda.LAUNCHES == before
    want = _scaf(JS.scaf_core, JHostIndex(jrld.read_fmd(fmd).expand()), p3,
                 avg, std, pr_links)
    assert got == want
    sw = [ln for ln in got[1].splitlines() if ln.startswith("SW\t")]
    st = TS.STATS
    assert st["gaps"] >= 2 and walks == [st["mates"]] and st["mates"] > 50
    assert st["mini_bwts"] == len(patched)
    if distort == 1.0:
        assert 1 in patched and st["assembled"] >= 1
        assert got[0].count(">") < 4 and "\nLK\t" in got[1]
    elif distort == 2.5:
        assert 1 in patched and ts and max(ts) < 1e-10
        assert st["assembled"] == 0
    else:
        assert sw and st["sw_failed"] == len(sw)


def test_retrieve_mates(linked, monkeypatch):
    """The batched mate walks give fermi_tpu's one-read retrieves, in any
    chunking and in the int64 index domain; a read longer than the walk's
    first bound walks on to its sentinel (the bound doubles), as
    fermi_tpu's `HostIndex.retrieve` does."""
    fmd = linked[0]
    runs = trld.read_fmd(fmd)
    host = JHostIndex(jrld.read_fmd(fmd).expand())
    ids = list(range(1, runs.n_seqs, 97))
    want = {x: host.retrieve(x)[0].tobytes() for x in ids}
    idx = FMDIndex.from_runs(runs, "cpu")
    assert TS.retrieve_mates(idx, ids) == want
    assert TS.retrieve_mates(idx, ids, chunk=7) == want
    assert TS.retrieve_mates(idx, ids, bound=70) == want        # 70 bp reads
    assert TS.retrieve_mates(idx, ids, bound=69) == want
    assert TS.retrieve_mates(idx, ids, bound=5, chunk=3) == want
    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    wide = FMDIndex.from_runs(runs, "cpu")
    assert wide.idtype == torch.int64
    assert TS.retrieve_mates(wide, ids, chunk=16) == want


def test_cli_scaf(linked):
    """`scaf` (and `scaf -P -m 3`) of the CLI: fermi_tpu's bytes (at the
    0.4x insert size, whose SW path is the quickest to run)."""
    fmd, p3, avg, std = linked
    avg, std = avg * 0.4, std * 0.4
    for flags in ([], ["-P", "-m", "3", "-t", "4"]):
        got, want = io.StringIO(), io.StringIO()
        ge, we = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(got), contextlib.redirect_stderr(ge):
            assert tmain(["scaf", "--device", "cpu", *flags, fmd, p3,
                          str(avg), str(std)]) == 0
        with contextlib.redirect_stdout(want), contextlib.redirect_stderr(we):
            jmain(["scaf", *flags, fmd, p3, str(avg), str(std)])
        assert got.getvalue() == want.getvalue() != ""
        assert _no_telemetry(ge) == _no_telemetry(we)


LONG_INSERT, LONG_SD = 3000, 150


def long_mate_reads(seed=1, n_pairs=300):
    """Pairs of 1,025-1,400 bp mates (insert 3,000 +- 150, the second
    reverse-complemented) from a random 18.3 kbp genome with a 1,600 bp
    repeat at two places and a 300 bp stretch that no read touches, far
    from both: the gap that scaf links across and walks the mates of."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 18300)
    rep = rng.integers(0, 4, 1600)
    g[1000:2600] = rep
    g[14300:15900] = rep
    genome = "".join("ACGT"[c] for c in g)
    hole = (9000, 9300)
    reads = []
    while len(reads) < 2 * n_pairs:
        a, b = (int(x) for x in rng.integers(1025, 1401, 2))
        ins = int(rng.normal(LONG_INSERT, LONG_SD))
        pos = int(rng.integers(0, len(genome) - ins))
        if (pos < hole[1] and pos + a > hole[0]) or \
                (pos + ins - b < hole[1] and pos + ins > hole[0]):
            continue
        reads.append(genome[pos:pos + a])
        reads.append(revcomp_str(genome[pos + ins - b:pos + ins]))
    return reads


@pytest.fixture(scope="module")
def long_mates(tmp_path_factory):
    """(fmd, p3 path) of the long-mate pairs through fermi_tpu's chain, as
    `linked`'s (remap's insert estimate stops at 1,000 bp, so scaf gets the
    drawn insert)."""
    d = tmp_path_factory.mktemp("scaf_long")
    fmd = str(d / "lm.fmd")
    host = JHostIndex.from_runs(build_my_fmd(long_mate_reads(), fmd))
    arr = seqsort_native(host, n_threads=1, verbose=False)
    p0 = io.StringIO()
    j_fm6_unitig(host, 40, p0, arr, n_threads=1)
    (d / "p0.mag").write_text(p0.getvalue())
    opt = dict(JM.DEFAULT_OPT)
    opt.update(flag_clean=True, flag_aggressive=True, flag_read_ori=True,
               flag_no_amend=True, min_ovlp=48)
    g = JM.mag_read(str(d / "p0.mag"), opt)
    JM.g_clean(g, opt)
    with open(d / "p2.mag", "w") as f:
        JM.mag_print(g, f)
    with open(d / "p3.mag", "w") as f, \
            contextlib.redirect_stderr(io.StringIO()):
        jremap(host, str(d / "p2.mag"), f, arr)
    return fmd, str(d / "p3.mag")


def test_retrieve_mates_past_1024_bp(long_mates):
    """Mates of 1,025-1,400 bp walk to their sentinels: fermi_tpu's
    `HostIndex.retrieve` bytes (the walk's first bound is 1,024)."""
    fmd = long_mates[0]
    runs = trld.read_fmd(fmd)
    host = JHostIndex(jrld.read_fmd(fmd).expand())
    ids = list(range(1, runs.n_seqs, 31))
    want = {x: host.retrieve(x)[0].tobytes() for x in ids}
    assert min(len(s) for s in want.values()) > TS.MATE_BOUND
    idx = FMDIndex.from_runs(runs, "cpu")
    assert TS.retrieve_mates(idx, ids) == want
    assert TS.retrieve_mates(idx, ids, bound=300, chunk=8) == want


def test_cli_scaf_long_mates(long_mates):
    """`scaf -a 10` across the gap of the long-mate genome: fermi_tpu's
    bytes and messages; the gap is examined and its mates walked."""
    fmd, p3 = long_mates
    args = ["-P", "-a", "10", fmd, p3, str(LONG_INSERT), str(LONG_SD)]
    got, want = io.StringIO(), io.StringIO()
    ge, we = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(got), contextlib.redirect_stderr(ge):
        assert tmain(["scaf", "--device", "cpu", *args]) == 0
    with contextlib.redirect_stdout(want), contextlib.redirect_stderr(we):
        jmain(["scaf", *args])
    assert got.getvalue() == want.getvalue() != ""
    assert _no_telemetry(ge) == _no_telemetry(we)
    assert TS.STATS["gaps"] >= 1 and TS.STATS["mates"] > 50


def _no_telemetry(err):
    return [ln for ln in err.getvalue().splitlines()
            if not ln.startswith("[M::main]")]


# -- the host code under scaf ----------------------------------------------


def _near_pairs(rng, n):
    """Query/target pairs with related ends, as scaf's SW join sees them:
    a target, and a query sharing a mutated stretch of it."""
    for _ in range(n):
        t = rng.integers(1, 5, int(rng.integers(1, 120)))
        lo = int(rng.integers(0, len(t)))
        q = t[lo: lo + int(rng.integers(1, 80))].copy()
        mut = rng.random(len(q)) < 0.08
        q[mut] = rng.integers(1, 5, int(mut.sum()))
        if rng.random() < 0.3:
            q = np.concatenate([rng.integers(1, 5, int(rng.integers(0, 9))),
                                q, rng.integers(1, 5, int(rng.integers(0, 9)))])
        if rng.random() < 0.2:
            q = rng.integers(1, 5, int(rng.integers(1, 60)))
        yield q.astype(np.uint8), t.astype(np.uint8)


@pytest.mark.parametrize("xstart", [False, True])
def test_ksw_align(xstart):
    """ksw_align's (score, qb, qe, tb, te) equal fermi_tpu's on seeded
    pairs, with scaf's matrix (1/-3, N scoring -3) and bubble's (5/-4)."""
    rng = np.random.default_rng(5)
    scaf_mat = [1 if i == j else -3 for i in range(5) for j in range(5)]
    bub_mat = [5 if i == j else -4 for i in range(5) for j in range(5)]
    n_starts = 0
    for i, (q, t) in enumerate(_near_pairs(rng, 300)):
        mat, go, ge = (scaf_mat, 5, 2) if i % 2 else (bub_mat, 5, 2)
        got = t_ksw_align(q, t, 5, mat, go, ge, xstart=xstart)
        assert got == j_ksw_align(q, t, 5, mat, go, ge, xstart=xstart)
        n_starts += got[1] >= 0
    assert (n_starts > 200) == xstart


def test_host_index():
    """HostIndex's queries equal fermi_tpu's on a random read set's BWT."""
    reads = random_reads(60, 20, 90, seed=9)
    text = jsuffix.build_text([jdna.encode(s) for s in reads],
                              trim_palindrome=False)
    bwt = jsuffix.multistring_bwt(text)
    t, j = THostIndex(bwt), JHostIndex(bwt)
    n = bwt.size
    assert t.n_seqs == j.n_seqs == 120
    assert np.array_equal(t.cnt, j.cnt) and np.array_equal(t.mcnt, j.mcnt)
    ks = np.arange(n + 1)
    assert np.array_equal(t.rank6(ks), j.rank6(ks))
    assert np.array_equal(t.rank6(n // 2), j.rank6(n // 2))
    rng = np.random.default_rng(2)
    kb = rng.integers(0, n, 200)
    sz = rng.integers(0, 40, 200).clip(max=n - kb)
    kf = rng.integers(0, n, 200).clip(max=n - sz)
    for back in (True, False):
        for a, b in zip(t.extend6(kb, kf, sz, back),
                        j.extend6(kb, kf, sz, back)):
            assert np.array_equal(a, b)
    for c in range(6):
        assert t.set_intv(c) == j.set_intv(c)
    for x in (0, 1, 57, 119):
        a, b = t.retrieve(x), j.retrieve(x)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    sa, ka = t.retrieve_batch(np.arange(120))
    sb, kb_ = j.retrieve_batch(np.arange(120))
    assert np.array_equal(ka, kb_)
    assert all(np.array_equal(x, y) for x, y in zip(sa, sb))


def _noisy_reads(seed, n, glen=1500, rl=60, err=0.01):
    rng = np.random.default_rng(seed)
    genome = rng.integers(1, 5, glen).astype(np.uint8)
    out = []
    for _ in range(n):
        p = int(rng.integers(0, glen - rl))
        r = genome[p:p + rl].copy()
        e = rng.random(rl) < err
        r[e] = rng.integers(1, 5, int(e.sum()))
        out.append(r if rng.random() < 0.5 else jdna.revcomp(r))
    return out


@pytest.mark.parametrize("seed,n,min_match", [(1, 150, 20), (2, 150, 17),
                                              (3, 100, 30)])
def test_fm6_api_unitig(seed, n, min_match):
    """A local assembly's graph (fm6_api_unitig: the BWT sorted by the
    device builder, here on the CPU) prints fermi_tpu's MAG bytes, raw and
    after scaf's cleanup calls."""
    blob = b"".join(r.tobytes() + b"\x00" for r in _noisy_reads(seed, n))
    g_t = TS.fm6_api_unitig(min_match, blob, torch.device("cpu"))
    g_j = JS.fm6_api_unitig(min_match, blob)
    assert _mag(g_t, TM) == _mag(g_j, JM) and _mag(g_t, TM).count("@") > 1
    for g, M in ((g_t, TM), (g_j, JM)):
        M.Mag.g_merge(g, True)
        M.g_simplify_bubble(g, 25, 120)
        M.g_pop_simple(g, 10.0, 0.15, True)
    assert _mag(g_t, TM) == _mag(g_j, JM)


def _mag(g, M):
    out = io.StringIO()
    M.mag_print(g, out)
    return out.getvalue()


def test_unitig_builder_run():
    """The host builder's seed loop (fm6_unitig), with and without a .rank
    array, gives fermi_tpu's Python builder's MAG text."""
    reads = _noisy_reads(4, 100, glen=800, err=0.0)
    text = jsuffix.build_text(reads, trim_palindrome=False)
    bwt = jsuffix.multistring_bwt(text)
    srt = np.arange(2 * len(reads), dtype=np.uint64)[::-1] << np.uint64(2)
    for sorted_arr in (None, srt):
        a, b = io.StringIO(), io.StringIO()
        t_fm6_unitig(THostIndex(bwt), 30, a, sorted_arr)
        j_fm6_unitig(JHostIndex(bwt), 30, b, sorted_arr, use_native=False)
        assert a.getvalue() == b.getvalue() != ""


def _tip_graph(M):
    """Vertex p's right-hand overlaps: 30 bp to a tip q (50 bp, one read,
    nothing on its right) and 20 bp to a long vertex r.  g_rm_edge with
    min_len 100 and min_nsr 5 finds q the longest overlap's end and resets
    the longest overlap to min_ovlp."""
    g = M.Mag()
    g.v = [M.MagVertex(len=200, nsr=10, k=[1, 2],
                       nei=[[], [[3, 30], [5, 20]]]),
           M.MagVertex(len=50, nsr=1, k=[3, 4], nei=[[[2, 30]], []]),
           M.MagVertex(len=300, nsr=10, k=[5, 6], nei=[[[2, 20]], []])]
    g.build_hash()
    return g


@pytest.mark.parametrize("min_ovlp", [0, 1])
def test_rm_edge_longest_overlap_a_tip(min_ovlp):
    """scaf's local assembly calls g_rm_edge(0, 0.8, ...): when the longest
    overlap leads to a tip, its maximum falls to 0, and mag.c's double
    division gives inf, so no edge goes.  fermi_tpu divides Python ints and
    raises ZeroDivisionError there (fault F10); at min_ovlp 1 both agree."""
    tg = _tip_graph(TM)
    tg.g_rm_edge(min_ovlp, 0.8, 100, 5)
    assert [p.nei for p in tg.v] == [[[], [[3, 30], [5, 20]]],
                                     [[[2, 30]], []], [[[2, 20]], []]]
    jg = _tip_graph(JM)
    if min_ovlp == 0:
        with pytest.raises(ZeroDivisionError):
            jg.g_rm_edge(min_ovlp, 0.8, 100, 5)
    else:
        jg.g_rm_edge(min_ovlp, 0.8, 100, 5)
        assert [p.nei for p in jg.v] == [p.nei for p in tg.v]
