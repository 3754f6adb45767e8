"""Error correction in the port (fermi_tpu_torch.algos.correct,
search.ecfix_device, api.correct, CLI `correct`) against fermi_tpu on the
CPU.  Outputs are integers and bytes: tolerance zero.

The fixture is a 5 kbp genome at 20x with 1% substitutions at quality 14
(the recipe of tests/test_correct.py), N bases, junk and short reads, plus
reads built to meet what fermi_tpu's device fix gets wrong and the port does
not copy: an N at a hash miss in a read that has hits, reads with no hit at
all, and a read whose first strand is too short but whose second is not."""

import contextlib
import io

import numpy as np
import pytest
import torch

from fermi_tpu import rld as jrld
from fermi_tpu.algos import correct as jec
from fermi_tpu.algos.hostindex import HostIndex
from fermi_tpu.search import ecfix_device as jfix
from fermi_tpu_torch.algos import correct as tec
from fermi_tpu_torch.index.fmd import FMDIndex
from fermi_tpu_torch.search import ecfix_device as tfix

from util import build_my_fmd, write_fastq

torch.set_num_threads(1)

GLEN, L = 5000, 80


def _reads(seed=17):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, GLEN)
    comp = np.array([3, 2, 1, 0])
    asc = np.frombuffer(b"ACGT", np.uint8)
    reads, quals = [], []
    for i in range(GLEN * 20 // L):
        p = int(rng.integers(0, GLEN - L))
        r = genome[p:p + L].copy()
        qv = np.full(L, 38 + 33, np.uint8)
        ne = rng.binomial(L, 0.01)
        if ne:
            pos = rng.integers(0, L, ne)
            r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            qv[pos] = 14 + 33
        if rng.random() < 0.5:
            r = comp[r][::-1]
            qv = qv[::-1].copy()
        s = asc[r].tobytes().decode()
        if i % 23 == 0:
            k = int(rng.integers(0, L))
            s = s[:k] + "N" + s[k + 1:]
        reads.append(s)
        quals.append(qv.tobytes().decode("latin1"))

    def junk(n):
        return asc[rng.integers(0, 4, n)].tobytes().decode()

    for _ in range(10):                      # junk: no hit at all
        reads.append(junk(L))
        quals.append(chr(60) * L)
    for p in (100, 2000, 3500):              # N at a miss, hits elsewhere
        left = junk(40)
        reads.append(left[:20] + "N" + left[21:]
                     + asc[genome[p:p + 60]].tobytes().decode())
        quals.append(chr(60) * 100)
    # first strand (reverse complement) too short, second strand not: an N
    # and 18 genome bases (k = 17 below)
    reads.append("N" + asc[genome[1200:1218]].tobytes().decode())
    quals.append(chr(60) * 19)
    reads.append("ACGTACGT")                 # short
    quals.append(chr(60) * 8)
    return reads, quals


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("ec")
    reads, quals = _reads()
    fq = str(d / "r.fq")
    write_fastq(fq, reads, quals)
    fmd = str(d / "i.fmd")
    build_my_fmd(reads, fmd)
    jidx = HostIndex.from_runs(jrld.read_fmd(fmd))
    return dict(fq=fq, fmd=fmd, jidx=jidx, tidx=FMDIndex.restore(fmd, "cpu"))


def _triples(cls, key, val):
    return sorted(zip(cls.tolist(), key.tolist(), val.tolist()))


@pytest.mark.parametrize("k", [17, 19, 21, -1])
def test_collect_matches_fermi_tpu(fixture, k):
    from fermi_tpu.index.fmd import FMDIndex as JFMD

    tidx = fixture["tidx"]
    assert tec.auto_k(tidx.total) == jec.auto_k(tidx.total)
    w = k if k > 0 else tec.auto_k(tidx.total)
    got = tec.collect_solid_kmers(tidx, w, 3)
    assert got[1].dtype == np.uint32 and got[2].dtype == np.uint8
    jdev = jec.collect_solid_kmers(JFMD.restore(fixture["fmd"]), w, 3)
    jnat = jec.collect_solid_kmers_native(fixture["jidx"], w, 3)
    assert got[3] == jdev[3] == jnat[3]
    assert _triples(*got[:3]) == _triples(*jdev[:3]) == _triples(*jnat[:3])


def test_collect_dominant_base_tie():
    """A w-mer preceded by A and by C equally often: the dominant base is
    the first maximum (A), as np.argmax picks in fermi_tpu."""
    from fermi_tpu.algos.hostindex import HostIndex as H
    from fermi_tpu_torch.api import build_index

    x = "GATTACAGGCTTAACGTCA"
    reads = ["A" + x] * 3 + ["C" + x] * 3 + ["TT" + x[:12]] * 4
    tidx = build_index(reads, "cpu")
    cls, key, val, counts = tec.collect_solid_kmers(tidx, 17, 3)
    from fermi_tpu.construct import suffix
    from fermi_tpu.core import dna
    bwt = suffix.multistring_bwt(suffix.build_text(
        [dna.encode(s) for s in reads], trim_palindrome=False))
    jcls, jkey, jval, jcounts = jec.collect_solid_kmers_native(
        H(bwt), 17, 3)
    assert counts == jcounts
    assert _triples(cls, key, val) == _triples(jcls, jkey, jval)
    assert (val & 7 == 3).any()              # the tie: 3 A + 3 C
    assert (key[val & 7 == 3] & 3 == 0).all()


def test_device_table_and_lookup(fixture):
    cls, key, val, _ = tec.collect_solid_kmers(fixture["tidx"], 17, 3)
    mine = tfix.build_device_table(cls, key, val, 17, device="cpu")
    ref = jfix.build_device_table(cls, key, val, 17)
    assert (mine["logt"], mine["mult"], mine["probes"]) == \
        (ref["logt"], ref["mult"], ref["probes"])
    assert np.array_equal(mine["slots"].numpy(), np.asarray(ref["slots"]))
    assert np.array_equal(mine["vals"].numpy(), np.asarray(ref["vals"]))
    # hash values against numpy's uint64 arithmetic
    suf = mine["suf_len"]
    ids = ((key.astype(np.int64) >> 2) << (2 * suf)) | cls
    rng = np.random.default_rng(4)
    miss = rng.integers(0, 1 << 34, 3000, dtype=np.int64)
    x = np.concatenate([ids, miss, [0, (1 << 34) - 1]])
    m = np.uint64(mine["mult"] % (1 << 64))
    want_h = ((x.view(np.uint64) * m) >> np.uint64(64 - mine["logt"]))
    got_h = tfix.table_hash(torch.from_numpy(x), mine["logt"], mine["mult"])
    assert np.array_equal(got_h.numpy(), want_h.astype(np.int64))
    got = tfix._lookup(mine["slots"], mine["vals"], mine["logt"],
                       mine["mult"], mine["probes"], torch.from_numpy(x))
    want = jfix._lookup(ref["slots"], ref["vals"], ref["logt"], ref["mult"],
                        ref["probes"], np.asarray(x))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert got[0][: len(ids)].all() and got[0].sum() >= len(ids)


def test_skip_ratio_boundary():
    """The skip-mode test is (double)occ / occ_last >= 0.8, as the host
    engine computes it, also at the boundary occ = 0.8 * occ_last and for
    occ_last = 0 (x / 0 = inf)."""
    occ_last = torch.tensor([10, 15, 20, 25, 10, 10, 7, 0, 0],
                            dtype=torch.int32)
    occ = torch.tensor([8, 12, 16, 20, 7, 9, 5, 5, 0], dtype=torch.int32)
    want = [o / l >= 0.8 if l else o > 0 for o, l in
            zip(occ.tolist(), occ_last.tolist())]
    assert tfix.ratio_ok(occ, occ_last).tolist() == want
    assert want[:4] == [True] * 4 and want[4] is False


def _ec(fn, idx, fq, **kw):
    buf = io.StringIO()
    fn(idx, fq, buf, verbose=False, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("device_fix,paired,keep_bad", [
    ("0", False, False), ("0", True, True),
    ("1", False, False), ("1", True, True), ("1", False, True)])
def test_ec_correct_matches_fermi_tpu(fixture, monkeypatch, device_fix,
                                      paired, keep_bad):
    kw = dict(min_occ=3, is_paired=paired, keep_bad=keep_bad, w=17)
    monkeypatch.delenv("FERMI_TPU_DEVICE_FIX", raising=False)
    want = _ec(jec.ec_correct, fixture["jidx"], fixture["fq"], **kw)
    monkeypatch.setenv("FERMI_TPU_DEVICE_FIX", device_fix)
    tfix.STATS.update(n=0, n_redo=0)
    got = _ec(tec.ec_correct, fixture["tidx"], fixture["fq"], **kw)
    assert got == want
    assert got.count("\n+\n") > 1000
    if device_fix == "1":
        assert tfix.STATS["n"] > 1000
        assert tfix.STATS["n_redo"] < tfix.STATS["n"] // 10
    if keep_bad:            # the bad short-strand read is emitted as is
        assert any(len(x) == 19 and x[0] == "N" for x in got.split("\n"))


def test_device_fix_faults_fermi_tpu_has(fixture):
    """On the fault reads, fermi_tpu's device fix differs from the host
    engine where the port's does not (the reads are in the fixture)."""
    cls, key, val, _ = tec.collect_solid_kmers(fixture["tidx"], 17, 3)
    reads, quals = _reads()
    seqs = [s.encode() for s in reads[-6:-1]]
    qs = [q.encode("latin1") for q in quals[-6:-1]]
    opt = dict(w=17, min_occ=3, keep_bad=1, is_paired=0, max_corr=0.3,
               trim_l=0, step=5)
    nat = tec.fix_reads(tec.SolidTable(17, cls, key, val), opt, seqs, qs, 1)
    mine = tfix.fix_reads_device(
        tfix.build_device_table(cls, key, val, 17, device="cpu"), opt,
        seqs, qs)
    ref = jfix.fix_reads_device(jfix.build_device_table(cls, key, val, 17),
                                opt, seqs, qs)
    assert mine[0] == nat[0] and mine[1] == nat[1]
    assert np.array_equal(mine[2], nat[2])
    assert nat[2][0] >> 16 & 1                        # junk: no hit, bad
    # fermi_tpu keeps the N at the miss (its qsum lacks that correction)
    # and corrects the short read's N on the strand the host never runs
    assert not np.array_equal(ref[2][1:4], nat[2][1:4])
    assert ref[0][4] != nat[0][4] and nat[0][4].startswith(b"N")


def test_cli_correct_bytes(fixture, monkeypatch):
    from fermi_tpu.cli.main import main as jmain
    from fermi_tpu_torch.cli.main import main as tmain

    monkeypatch.delenv("FERMI_TPU_DEVICE_FIX", raising=False)
    outs = []
    for main, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["correct", *extra, "-t", "2", "-k", "19",
                         fixture["fmd"], fixture["fq"]]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n+\n") > 1000
    assert tmain(["correct", "--device", "cpu", "-M", fixture["fmd"],
                  fixture["fq"]]) == 1


def test_api_correct():
    from fermi_tpu import api as japi
    from fermi_tpu_torch import api as tapi

    reads, quals = _reads(seed=5)
    reads, quals = reads[:300], quals[:300]
    assert tapi.correct(reads, quals, device="cpu") == \
        japi.correct(reads, quals)
    assert tapi.correct(reads[:200], device="cpu") == japi.correct(reads[:200])
