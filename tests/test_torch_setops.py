"""Index set algebra in the port (fermi_tpu_torch.algos.merge, sub,
contrast; the CLI `merge`, `sub`, `contrast`, `bitand`, `recode` and
`build -i`) against fermi_tpu on the CPU.  Bits and bytes: tolerance zero.

Fixtures follow tests/test_setops.py, whose parity tests need the reference
binary; here fermi_tpu's own functions are the oracle, and the merged and
sub indexes are also held to `build` of the concatenated or chosen reads.
"""

import numpy as np
import pytest
import torch

from fermi_tpu import rld as jrld
from fermi_tpu.algos import contrast as JC
from fermi_tpu.algos import merge as JM
from fermi_tpu.algos import seqsort as JSS
from fermi_tpu.algos import sub as JS
from fermi_tpu.cli.main import main as jmain
from fermi_tpu.index.fmd import FMDIndex as JIndex
from fermi_tpu_torch.algos import contrast as TC
from fermi_tpu_torch.algos import merge as TM
from fermi_tpu_torch.algos import sub as TS
from fermi_tpu_torch.cli.main import main as tmain
from fermi_tpu_torch.index import fmd as tfmd
from fermi_tpu_torch.index.fmd import FMDIndex

from native_lock import load_fermi_tpu_native
from util import build_my_fmd, random_reads, write_fasta

torch.set_num_threads(1)
load_fermi_tpu_native()


def _bwt(path):
    return jrld.read_fmd(path).expand()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two read sets of one 2 kbp genome (test_setops.py:19-39), their
    indexes, fermi_tpu's gap bits and merged BWT, and the index of the
    concatenated reads."""
    d = tmp_path_factory.mktemp("merge")
    r0 = random_reads(120, seed=51, with_genome=True, genome_len=2000)
    r1 = random_reads(90, seed=52, with_genome=True, genome_len=2000)
    paths = [str(d / n) for n in ("a.fmd", "b.fmd", "all.fmd")]
    for reads, p in ((r0, paths[0]), (r1, paths[1]), (r0 + r1, paths[2])):
        build_my_fmd(reads, p)
    b0, b1 = _bwt(paths[0]), _bwt(paths[1])
    bits = JM.compute_gap_bits(JIndex.from_bwt(b0), JIndex.from_bwt(b1))
    merged = JM.fm_merge(JIndex.from_bwt(b0), b0, JIndex.from_bwt(b1), b1)
    assert np.array_equal(merged, _bwt(paths[2]))
    return dict(d=d, r0=r0, r1=r1, paths=paths, b0=b0, b1=b1, bits=bits,
                merged=merged)


@pytest.mark.parametrize("batch,chunk", [(1 << 20, 32), (37, 5)])
def test_gap_bits_and_merge(pair, batch, chunk):
    b0, b1 = pair["b0"], pair["b1"]
    e0, e1 = FMDIndex.from_bwt(b0, "cpu"), FMDIndex.from_bwt(b1, "cpu")
    bits = TM.compute_gap_bits(e0, e1, batch=batch, chunk_steps=chunk)
    assert bits.dtype == torch.bool and bits.numel() == b0.size + b1.size
    assert np.array_equal(bits.numpy(), pair["bits"])
    assert np.array_equal(TM.fm_merge(e0, b0, e1, b1, batch=batch),
                          pair["merged"])


def _index_in(dtype, bwt, monkeypatch):
    """The port's and fermi_tpu's index of bwt in the index domain dtype."""
    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", dtype)
    out = FMDIndex.from_bwt(bwt, "cpu"), JIndex.from_bwt(bwt)
    monkeypatch.delenv("FERMI_TPU_IDX_DTYPE")
    return out


@pytest.mark.parametrize("dt0,dt1", [("int64", "int32"), ("int32", "int64")])
def test_merge_mixed_domains(pair, monkeypatch, dt0, dt1):
    """The port merges an index of either domain into one of the other.
    fermi_tpu raises when e0 is wider than e1 (its walk holds e0's position
    in e1's type), so there the oracle is the build of all the reads."""
    b0, b1 = pair["b0"], pair["b1"]
    e0, j0 = _index_in(dt0, b0, monkeypatch)
    e1, j1 = _index_in(dt1, b1, monkeypatch)
    assert (e0.idtype, e1.idtype) == (getattr(torch, dt0),
                                      getattr(torch, dt1))
    got = TM.fm_merge(e0, b0, e1, b1)
    assert np.array_equal(got, _bwt(pair["paths"][2]))
    if dt0 == "int64":
        with pytest.raises(TypeError):
            JM.fm_merge(j0, b0, j1, b1)
    else:
        assert np.array_equal(JM.fm_merge(j0, b0, j1, b1), got)


def test_blocked_wide_accumulator(pair, monkeypatch):
    """The blocked builder with its accumulated index in int64 and its
    blocks in int32 (fermi_tpu's merge raises on that pair) gives the
    host build's BWT."""
    from fermi_tpu_torch.construct import blocked
    from fermi_tpu_torch.construct import suffix as tsuffix
    from fermi_tpu_torch.core import dna

    blk = 3000
    monkeypatch.setattr(tfmd, "_pick_idtype", lambda n: torch.int64
                        if n > blk else torch.int32)
    seen = []
    orig = TM.compute_gap_bits

    def spy(e0, e1, **kw):
        seen.append((e0.idtype, e1.idtype))
        return orig(e0, e1, **kw)
    monkeypatch.setattr(TM, "compute_gap_bits", spy)
    text = tsuffix.build_text([dna.encode(r) for r in pair["r0"] + pair["r1"]])
    got = blocked.device_build_text(text, block_symbols=blk, device="cpu")
    assert np.array_equal(got, _bwt(pair["paths"][2]))
    assert (torch.int64, torch.int32) in seen and len(seen) >= 3
    assert blocked.STATS["blocks"] == len(seen) + 1


@pytest.fixture(scope="module")
def subset(tmp_path_factory):
    """150 reads of one genome, 40% chosen (both strands together;
    test_setops.py:42-66), the indexes of the chosen and the other reads."""
    d = tmp_path_factory.mktemp("sub")
    reads = random_reads(150, seed=53, with_genome=True, genome_len=2500)
    sel = np.random.default_rng(5).random(len(reads)) < 0.4
    paths = {k: str(d / f"{k}.fmd") for k in ("all", "in", "out")}
    build_my_fmd(reads, paths["all"])
    build_my_fmd([r for r, s in zip(reads, sel) if s], paths["in"])
    build_my_fmd([r for r, s in zip(reads, sel) if not s], paths["out"])
    bits = np.repeat(sel, 2)
    bitfile = str(d / "sel.bits")
    JS.pack_bitfile(bitfile, bits)
    return dict(paths=paths, bits=bits, bitfile=bitfile)


@pytest.mark.parametrize("batch,chunk", [(1 << 20, 32), (13, 7)])
def test_mark_read_positions(subset, batch, chunk):
    bwt = _bwt(subset["paths"]["all"])
    ids = np.flatnonzero(subset["bits"])
    want = JS.mark_read_positions(JIndex.from_bwt(bwt), ids.astype(np.int64),
                                  bwt.size)
    got = TS.mark_read_positions(FMDIndex.from_bwt(bwt, "cpu"), ids,
                                 bwt.size, batch=batch, chunk_steps=chunk)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("is_comp", [False, True])
def test_fm_sub(subset, is_comp):
    """sub and sub -c equal fermi_tpu's and `build` of the chosen reads
    (-c: of the others)."""
    bwt = _bwt(subset["paths"]["all"])
    bits = subset["bits"]
    got = TS.fm_sub(FMDIndex.from_bwt(bwt, "cpu"), bwt, bits, is_comp)
    assert np.array_equal(got, JS.fm_sub(JIndex.from_bwt(bwt), bwt, bits,
                                         is_comp))
    assert np.array_equal(got, _bwt(subset["paths"]["out" if is_comp
                                                   else "in"]))


@pytest.fixture(scope="module")
def two_genomes(tmp_path_factory):
    """Two read sets sharing a 3 kbp genome, each with an 800 bp private
    region (test_setops.py:70-99), their indexes and .rank arrays."""
    d = tmp_path_factory.mktemp("contrast")
    rng = np.random.default_rng(7)
    shared = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    g0 = shared + "".join("ACGT"[c] for c in rng.integers(0, 4, 800))
    g1 = shared + "".join("ACGT"[c] for c in rng.integers(0, 4, 800))
    reads0 = [g0[p:p + 80] for p in range(0, len(g0) - 80, 11)]
    reads1 = [g1[p:p + 80] for p in range(0, len(g1) - 80, 13)]
    out = []
    for tag, reads in (("a", reads0), ("b", reads1)):
        fmd, rank = str(d / f"{tag}.fmd"), str(d / f"{tag}.rank")
        build_my_fmd(reads, fmd)
        JSS.seqsort(JIndex.restore(fmd), verbose=False).tofile(rank)
        out.append((fmd, rank))
    return d, out


@pytest.mark.parametrize("k", [31, 55])
def test_contrast(two_genomes, k):
    """fm6_contrast's two arrays and the .sub bytes after sub_conv equal
    fermi_tpu's; the private regions' reads are selected."""
    d, ((f0, r0), (f1, r1)) = two_genomes
    want = JC.fm6_contrast(JIndex.restore(f0), JIndex.restore(f1), k, 3)
    got = TC.fm6_contrast(FMDIndex.restore(f0, "cpu"),
                          FMDIndex.restore(f1, "cpu"), k, 3)
    for g, w, rank_fn in zip(got, want, (r0, r1)):
        assert g.dtype == bool and np.array_equal(g, w)
        rank = np.fromfile(rank_fn, np.uint64)
        sel = TC.sub_conv(g, rank)
        assert np.array_equal(sel, JC.sub_conv(w, rank))
        assert sel.sum() > 40
    assert TC.STATS["levels"] == k - TC.SUF_LEN
    with pytest.raises(AssertionError, match="asymmetry"):
        TC.sub_conv(np.eye(1, len(got[0]), 0, bool)[0],
                    np.fromfile(r0, np.uint64))


# -- the CLI -------------------------------------------------------------


def _out(capfdbinary, main, argv):
    assert main(argv) == 0
    return capfdbinary.readouterr().out


def test_cli_merge_and_recode(pair, capfdbinary):
    d = pair["d"]
    a, b, _ = pair["paths"]
    jout, tout = str(d / "j.fmd"), str(d / "t.fmd")
    assert jmain(["merge", "-fo", jout, a, b, b, a]) == 0
    assert tmain(["merge", "--device", "cpu", "-fo", tout, a, b, b, a]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read()
    assert tmain(["merge", "--device", "cpu", "-o", tout, a, b]) == 1
    assert _out(capfdbinary, tmain, ["recode", b]) == \
        _out(capfdbinary, jmain, ["recode", b]) == open(b, "rb").read()


def _doubled_sizes(exact_text):
    """`exact`'s records with every SMEM's size (the EM line's fourth
    field) doubled."""
    out = []
    for ln in exact_text.splitlines(True):
        if ln.startswith("EM\t"):
            f = ln.split("\t")
            f[3] = str(2 * int(f[3]))
            ln = "\t".join(f)
        out.append(ln)
    return "".join(out)


@pytest.mark.parametrize("domain", ["int32", "int64"])
def test_cli_merge_with_self(pair, tmp_path, monkeypatch, capsys, domain):
    """`merge x.fmd x.fmd`, the shape of the 4.52 Gsym index the smoke
    test makes: fermi_tpu's bytes; every SA interval doubles, so `exact`
    prints x's records with each size doubled (the flags stay: kf doubles
    with n_seqs); ids i and i + n_seqs unpack to x's read i.  In int64
    every index is restored without fused rows (FUSED_MAX lowered), the
    layout past 2^32 - 128 symbols, the merge's gap walk included."""
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.search import extend as se

    x = pair["paths"][0]
    jout, tout = str(tmp_path / "j.fmd"), str(tmp_path / "t.fmd")
    assert jmain(["merge", "-fo", jout, x, x]) == 0
    if domain == "int64":
        monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
        monkeypatch.setattr(tfmd, "FUSED_MAX", 0)
    seen = []
    orig = TM.compute_gap_bits

    def spy(e0, e1, **kw):
        seen.append((e0.idtype, e0.fused is None, e1.fused is None))
        return orig(e0, e1, **kw)
    monkeypatch.setattr(TM, "compute_gap_bits", spy)
    assert tmain(["merge", "--device", "cpu", "-fo", tout, x, x]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read()
    unfused = domain == "int64"
    assert seen == [(getattr(torch, domain), unfused, unfused)]

    rng = np.random.default_rng(54)
    qry = []
    for s in pair["r0"][::3]:
        b = list(s)
        for at in rng.integers(0, len(b), 2):
            b[at] = "ACGT"[int(rng.integers(0, 4))]
        qry.append("".join(b))
    qfa = str(tmp_path / "q.fa")
    write_fasta(qfa, qry)
    capsys.readouterr()
    text = {}
    for f in (x, tout):
        assert tmain(["exact", "--device", "cpu", f, qfa]) == 0
        text[f] = capsys.readouterr().out
    assert text[tout] == _doubled_sizes(text[x])
    assert text[x].count("EM\t") > len(qry)

    one, two = (FMDIndex.restore(f, "cpu") for f in (x, tout))
    assert two.total == 2 * one.total and two.n_seqs == 2 * one.n_seqs
    assert two.idtype == getattr(torch, domain)
    assert (two.fused is None) == unfused
    ids = np.arange(one.n_seqs)
    want, _ = se.retrieve_strings(one, ids)
    for lo in (0, one.n_seqs):
        got, _ = se.retrieve_strings(two, ids + lo)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert [dna.decode(want[2 * i]) for i in range(3)] == pair["r0"][:3]


@pytest.mark.parametrize("chunk", [1, 7, 1 << 28])
def test_merge_bwts_chunks(pair, chunk):
    """The interleave a chunk at a time gives fermi_tpu's merged BWT at
    every chunk length."""
    b0, b1 = (torch.from_numpy(pair[k]) for k in ("b0", "b1"))
    bits = torch.from_numpy(pair["bits"])
    got = TM.merge_bwts(b0, b1, bits, chunk=chunk)
    assert np.array_equal(got.numpy(), pair["merged"])


def test_cli_build_append(pair):
    """build -i appends a read file to an index: the bytes of fermi_tpu's
    build -i (its streaming host engine) and of build of all the reads."""
    d = pair["d"]
    fa = str(d / "r1.fa")
    write_fasta(fa, pair["r1"])
    jout, tout = str(d / "ja.fmd"), str(d / "ta.fmd")
    assert jmain(["build", "-fo", jout, "-i", pair["paths"][0], fa]) == 0
    assert tmain(["build", "--device", "cpu", "-fo", tout, "-i",
                  pair["paths"][0], fa]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read() == \
        open(pair["paths"][2], "rb").read()


@pytest.mark.parametrize("comp", [[], ["-c"]])
def test_cli_sub(subset, capfdbinary, comp):
    argv = ["sub", *comp, subset["paths"]["all"], subset["bitfile"]]
    got = _out(capfdbinary, tmain, [argv[0], "--device", "cpu", *argv[1:]])
    assert got == _out(capfdbinary, jmain, argv)
    assert got == open(subset["paths"]["out" if comp else "in"], "rb").read()


def test_cli_sub_refuses_other_lengths(subset, tmp_path, capfdbinary):
    bad = str(tmp_path / "bad.bits")
    TS.pack_bitfile(bad, subset["bits"][:-2])
    assert tmain(["sub", "--device", "cpu", subset["paths"]["all"], bad]) == 1
    assert b"unmatched" in capfdbinary.readouterr().err


def test_cli_contrast_and_bitand(two_genomes, capfdbinary):
    d, ((f0, r0), (f1, r1)) = two_genomes
    outs = {}
    for tag, main, dv in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        subs = [str(d / f"{tag}{i}.sub") for i in (0, 1)]
        assert main(["contrast", *dv, "-k", "31", f0, r0, subs[0], f1, r1,
                     subs[1]]) == 0
        outs[tag] = [open(s, "rb").read() for s in subs]
        assert capfdbinary.readouterr().err.count(b"reads selected") == 2
    assert outs["t"] == outs["j"]
    a, b = str(d / "t0.sub"), str(d / "j0.sub")
    got = _out(capfdbinary, tmain, ["bitand", a, b, a])
    assert got == _out(capfdbinary, jmain, ["bitand", a, b, a])
    assert got == outs["j"][0]


# -- contrast on reads with N (fault F2) ----------------------------------


def _revcomp(s):
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


@pytest.fixture(scope="module")
def n_samples(tmp_path_factory):
    """Two samples of 70 bp reads: a 3 kbp genome with a 200 bp insertion
    and a variant of it with a SNP every 500 bp; one read in eight has an
    N at a random position.  Their indexes, .rank arrays and reads."""
    d = tmp_path_factory.mktemp("contrast_n")
    rng = np.random.default_rng(17)
    g = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    ins = "".join("ACGT"[c] for c in rng.integers(0, 4, 200))
    v = list(g)
    for p in range(250, 3000, 500):
        v[p] = "ACGT"[("ACGT".index(v[p]) + 1) % 4]
    genomes = (g[:1500] + ins + g[1500:], "".join(v))
    out = []
    for tag, genome in zip("ab", genomes):
        reads = []
        for p in range(0, len(genome) - 70, 7):
            r = list(genome[p:p + 70])
            if rng.random() < 1 / 8:
                r[int(rng.integers(0, 70))] = "N"
            r = "".join(r)
            reads.append(_revcomp(r) if rng.random() < 0.5 else r)
        fmd, rank = str(d / f"{tag}.fmd"), str(d / f"{tag}.rank")
        build_my_fmd(reads, fmd)
        JSS.seqsort(JIndex.restore(fmd), verbose=False).tofile(rank)
        out.append((fmd, rank, reads))
    return out


def _absent_kmer_reads(reads, other, k):
    """Brute force of contrast with min_occ 1: read i is selected iff it
    holds an A/C/G/T string of SUF_LEN to k bases absent from every read of
    `other` and its reverse complement.  Bool per stored sequence (read i's
    two strands at 2i and 2i+1)."""
    seen = set()
    for r in other:
        for s in (r, _revcomp(r)):
            for i in range(len(s)):
                for j in range(i + TC.SUF_LEN, min(i + k, len(s)) + 1):
                    seen.add(s[i:j])
    sel = []
    for r in reads:
        hit = False
        for run in r.split("N"):
            w = min(k, len(run))
            if w >= TC.SUF_LEN:
                hit |= any(run[i:i + w] not in seen
                           for i in range(len(run) - w + 1))
        sel.append(hit)
    return np.repeat(sel, 2)


def test_contrast_reads_with_n(n_samples):
    """fermi_tpu's tip BFS follows A-T only, so a read with an N between a
    tip and its start is reached on one strand only, and sub_conv rejects
    the asymmetry.  The port follows N too: its selections are symmetric
    and equal the brute force on both sides."""
    (f0, r0, reads0), (f1, r1, reads1) = n_samples
    k = 31
    want = JC.fm6_contrast(JIndex.restore(f0), JIndex.restore(f1), k, 1)
    got = TC.fm6_contrast(FMDIndex.restore(f0, "cpu"),
                          FMDIndex.restore(f1, "cpu"), k, 1)
    with pytest.raises(AssertionError, match="asymmetry"):
        for w, rank_fn in zip(want, (r0, r1)):
            JC.sub_conv(w, np.fromfile(rank_fn, np.uint64))
    for g, rank_fn, reads, other in ((got[0], r0, reads0, reads1),
                                     (got[1], r1, reads1, reads0)):
        sel = TC.sub_conv(g, np.fromfile(rank_fn, np.uint64))
        assert np.array_equal(sel, _absent_kmer_reads(reads, other, k))
        assert 0 < sel.sum() < len(sel)
