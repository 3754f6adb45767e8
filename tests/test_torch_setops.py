"""Index set algebra in the port (fermi_tpu_torch.algos.merge, sub,
contrast; the CLI `merge`, `sub`, `contrast`, `bitand`, `recode` and
`build -i`) against fermi_tpu on the CPU.  Bits and bytes: tolerance zero.

Fixtures follow tests/test_setops.py, whose parity tests need the reference
binary; here fermi_tpu's own functions are the oracle, and the merged and
sub indexes are also held to `build` of the concatenated or chosen reads.
"""

import os
import shutil

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


def _scaled_sizes(exact_text, factor=2):
    """`exact`'s records with every SMEM's size (the EM line's fourth
    field) times `factor`."""
    out = []
    for ln in exact_text.splitlines(True):
        if ln.startswith("EM\t"):
            f = ln.split("\t")
            f[3] = str(factor * int(f[3]))
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
    assert text[tout] == _scaled_sizes(text[x])
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


@pytest.mark.parametrize("domain", ["int32", "int64"])
def test_cli_merge_of_merged_with_self(pair, tmp_path, monkeypatch, capsys,
                                       domain):
    """`merge y y` of y = `merge x x`, the smoke test's 9.05 Gsym shape,
    with every restore a few blocks at a time (RESTORE_CHUNK lowered):
    fermi_tpu's bytes, and `exact` prints x's records with every size
    times 4.  In int64 no index has fused rows (FUSED_MAX lowered)."""
    x = pair["paths"][0]
    y, jout, tout = (str(tmp_path / f) for f in ("y.fmd", "j.fmd", "t.fmd"))
    assert jmain(["merge", "-fo", y, x, x]) == 0
    assert jmain(["merge", "-fo", jout, y, y]) == 0
    monkeypatch.setattr(tfmd, "RESTORE_CHUNK", 384)
    if domain == "int64":
        monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
        monkeypatch.setattr(tfmd, "FUSED_MAX", 0)
    assert tmain(["merge", "--device", "cpu", "-fo", tout, y, y]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read()
    four = FMDIndex.restore(tout, "cpu")
    assert four.total > 8 * tfmd.RESTORE_CHUNK
    assert four.idtype == getattr(torch, domain)
    assert (four.fused is None) == (domain == "int64")

    qfa = str(tmp_path / "q.fa")
    write_fasta(qfa, pair["r0"][::4])
    capsys.readouterr()
    text = {}
    for f in (x, tout):
        assert tmain(["exact", "--device", "cpu", f, qfa]) == 0
        text[f] = capsys.readouterr().out
    assert text[tout] == _scaled_sizes(text[x], 4)
    assert text[x].count("EM\t") >= len(pair["r0"][::4])


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


def _unfused_int64(monkeypatch, fused_max):
    """Every index the port builds or restores from here on is int64, with
    fused rows only below fused_max symbols."""
    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    monkeypatch.setattr(tfmd, "FUSED_MAX", fused_max)


@pytest.mark.parametrize("fused_max", ["none", "between"])
def test_cli_merge_two_indexes_unfused(pair, tmp_path, monkeypatch,
                                       fused_max):
    """`merge a b b a` of two different indexes in the int64 domain with
    no fused rows (FUSED_MAX 0), or with FUSED_MAX between a's symbols and
    a + b's, so the running index loses its fused rows after the first
    fold: fermi_tpu's bytes (its merge in its own default domain)."""
    a, b, _ = pair["paths"]
    jout, tout = str(tmp_path / "j.fmd"), str(tmp_path / "t.fmd")
    assert jmain(["merge", "-fo", jout, a, b, b, a]) == 0
    n0, n1 = pair["b0"].size, pair["b1"].size
    _unfused_int64(monkeypatch, 0 if fused_max == "none" else n0 + n1 // 2)
    seen = []
    orig = TM.compute_gap_bits

    def spy(e0, e1, **kw):
        seen.append((e0.idtype, e0.fused is not None, e1.fused is not None))
        return orig(e0, e1, **kw)
    monkeypatch.setattr(TM, "compute_gap_bits", spy)
    assert tmain(["merge", "--device", "cpu", "-fo", tout, a, b, b, a]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read()
    if fused_max == "none":
        assert seen == [(torch.int64, False, False)] * 3
    else:
        assert seen == [(torch.int64, True, True),
                        (torch.int64, False, True),
                        (torch.int64, False, True)]


def test_cli_build_append_unfused(pair, tmp_path, monkeypatch):
    """`build -i` of b's reads onto a in the int64 domain with no fused
    rows: fermi_tpu's `build -i` bytes and `build` of all the reads."""
    fa = str(tmp_path / "r1.fa")
    write_fasta(fa, pair["r1"])
    jout, tout = str(tmp_path / "ja.fmd"), str(tmp_path / "ta.fmd")
    assert jmain(["build", "-fo", jout, "-i", pair["paths"][0], fa]) == 0
    _unfused_int64(monkeypatch, 0)
    seen = []
    orig = TM.compute_gap_bits

    def spy(e0, e1, **kw):
        seen.append((e0.idtype, e0.fused, e1.fused))
        return orig(e0, e1, **kw)
    monkeypatch.setattr(TM, "compute_gap_bits", spy)
    assert tmain(["build", "--device", "cpu", "-fo", tout, "-i",
                  pair["paths"][0], fa]) == 0
    assert seen == [(torch.int64, None, None)]
    assert open(tout, "rb").read() == open(jout, "rb").read() == \
        open(pair["paths"][2], "rb").read()


def _held_to_its_blocks(pair, ea, eb, m, against_fermi_tpu=True):
    """The SA interval of every query by multi_backward_search over ea
    and eb (no gap bits on that path) equals backward_search's over m (the
    index of both blocks, int64 without fused rows) and, where asked,
    fermi_tpu's multi_backward_search's (a minute of JAX dispatch); ids
    n_a + y of m unpack to b's read y, ids x < n_a to a's read x."""
    from fermi_tpu.search import extend as jex
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.search import extend as se

    assert m.fused is None and m.idtype == torch.int64
    rng = np.random.default_rng(55)
    qs = []
    for reads in (pair["r0"], pair["r1"]):
        for r in rng.choice(len(reads), 25):
            s = dna.encode(reads[r])
            ln = int(rng.integers(8, len(s) + 1))
            at = int(rng.integers(0, len(s) - ln + 1))
            qs.append(s[at: at + ln])
    qs += [rng.integers(1, 5, int(rng.integers(8, 40))).astype(np.uint8)
           for _ in range(25)]
    width = max(len(q) for q in qs)
    buf = np.zeros((len(qs), width), np.uint8)
    for i, q in enumerate(qs):
        buf[i, :len(q)] = q
    k, l, c = se.backward_search(m, torch.from_numpy(buf),
                                 torch.tensor([len(q) for q in qs]), width)
    got = [(x, y, n) if n else (0, -1, 0)
           for x, y, n in zip(k.tolist(), l.tolist(), c.tolist())]
    ja, jb = JIndex.from_bwt(pair["b0"]), JIndex.from_bwt(pair["b1"])
    for q, g in zip(qs, got):
        assert se.multi_backward_search([ea, eb], q) == g
        if against_fermi_tpu:
            assert tuple(map(int, jex.multi_backward_search([ja, jb],
                                                            q))) == g
    assert sum(n > 0 for _, _, n in got) >= 50

    want_a, _ = se.retrieve_strings(ea, np.arange(ea.n_seqs))
    want_b, _ = se.retrieve_strings(eb, np.arange(eb.n_seqs))
    ids = np.arange(m.n_seqs)
    seqs, _ = se.retrieve_strings(m, ids)
    assert m.n_seqs == ea.n_seqs + eb.n_seqs
    assert all(np.array_equal(s, w) for s, w in zip(seqs, want_a + want_b))
    assert [dna.decode(seqs[ea.n_seqs + 2 * y]) for y in range(5)] == \
        pair["r1"][:5]


def test_two_indexes_merged_oracles(pair, tmp_path, monkeypatch):
    """The smoke test's gates on its index past 2^32, in small, over
    `merge a b` (_held_to_its_blocks)."""
    a, b, _ = pair["paths"]
    merged = str(tmp_path / "m.fmd")
    _unfused_int64(monkeypatch, 0)
    assert tmain(["merge", "--device", "cpu", "-fo", merged, a, b]) == 0
    ea, eb, m = (FMDIndex.restore(p, "cpu") for p in (a, b, merged))
    _held_to_its_blocks(pair, ea, eb, m)


# -- build -i's two routes -------------------------------------------------

APPEND_DOMAINS = ["default", "unfused_int64"]


def _append_domain(monkeypatch, domain):
    if domain == "unfused_int64":
        _unfused_int64(monkeypatch, 0)


def _append_inputs(pair, tmp_path):
    """A copy of a's index (its .fmd.blk not yet built) and b's reads as
    FASTA; b's symbols."""
    old = str(tmp_path / "old.fmd")
    shutil.copyfile(pair["paths"][0], old)
    fa = str(tmp_path / "r1.fa")
    write_fasta(fa, pair["r1"])
    return old, fa, pair["b1"].size


def _force_route(monkeypatch, pair, route):
    """The free-byte figure one below the card route's reckoned peak for
    appending b to a (the streaming route), or equal to it (the card
    route)."""
    need = TM.card_append_bytes(pair["b0"].size, pair["b1"].size)
    free = need - 1 if route == "stream" else need
    monkeypatch.setattr(TM, "free_bytes", lambda dev: free)
    return need, free


@pytest.mark.parametrize("domain", APPEND_DOMAINS)
def test_cli_build_append_streams_past_free_memory(pair, tmp_path,
                                                    monkeypatch, capsys,
                                                    domain):
    """`build -i` onto an index whose card route would not fit the free
    device memory takes fermi_tpu's streaming route (no gap walk on the
    device; the old index's .fmd.blk built beside it), printed on stderr;
    with the free bytes at the reckoned peak it takes the card route.
    Both give fermi_tpu's `build -i` bytes and `build` of all the reads."""
    old, fa, n1 = _append_inputs(pair, tmp_path)
    jout = str(tmp_path / "j.fmd")
    assert jmain(["build", "-fo", jout, "-i", pair["paths"][0], fa]) == 0
    _append_domain(monkeypatch, domain)
    walks = []
    orig = TM.compute_gap_bits

    def spy(e0, e1, **kw):
        walks.append((e0.idtype, e0.fused is None))
        return orig(e0, e1, **kw)
    monkeypatch.setattr(TM, "compute_gap_bits", spy)
    outs = {}
    for route in ("stream", "card"):
        need, free = _force_route(monkeypatch, pair, route)
        outs[route] = str(tmp_path / f"{route}.fmd")
        capsys.readouterr()
        assert tmain(["build", "--device", "cpu", "-fo", outs[route], "-i",
                      old, fa]) == 0
        err = capsys.readouterr().err
        assert f"[M::build] append {n1} symbols to {pair['b0'].size} " \
            f"({tfmd.FMDIndex.restore(old, 'cpu').n_seqs} sequences) by " \
            f"the {route} route: reckoned device peak {need} bytes, free " \
            f"{free}\n" in err
        if route == "stream":
            assert walks == [] and os.path.exists(old + ".blk")
            assert TM.APPEND_STATS["route"] == "stream"
    unfused = domain == "unfused_int64"
    assert walks == [(torch.int64 if unfused else torch.int32, unfused)]
    data = [open(p, "rb").read() for p in (outs["stream"], outs["card"],
                                          jout, pair["paths"][2])]
    assert data[0] == data[1] == data[2] == data[3]


def test_append_route_decision(monkeypatch):
    """The route by the free bytes: the card route at the reckoned peak
    and off CUDA, the streaming route one byte below; fermi_tpu's layouts
    by size (2.5 B a symbol int32 with fused rows, 2.75 int64 with them,
    2.0 past FUSED_MAX); on an 80 GB card's free memory a 9.05 Gsym index
    takes the card route and a 2^35-symbol one the streaming route."""
    n1 = 80_800_000
    need = TM.card_append_bytes(1 << 30, n1)
    for free, route in ((need, "card"), (need - 1, "stream"),
                        (None, "card")):
        monkeypatch.setattr(TM, "free_bytes", lambda dev: free)
        assert TM.append_route(1 << 30, n1, "cpu") == (route, need, free)
    for n, rate in ((1 << 30, 2.5), (1 << 31, 2.75), (1 << 33, 2.0)):
        assert TM.index_layout_bytes(n) == (n // 128 + 1) * 128 * rate
    monkeypatch.setattr(TM, "free_bytes", lambda dev: 79 * 10**9)
    assert TM.append_route(9_049_600_000, n1, "cuda")[0] == "card"
    assert TM.append_route(2**35, n1, "cuda")[0] == "stream"


@pytest.mark.parametrize("domain", APPEND_DOMAINS)
def test_append_reckons_the_restored_layouts(pair, monkeypatch, domain):
    """card_append_bytes is the old index's arrays as a restore lays them
    out and the new block's as from_bwt does (fused rows or not, int32 or
    int64), 2 B a merged symbol, and the chunk temporaries: a restore
    slice of the larger index's rows (fewer than a RESTORE_CHUNK here)
    and an interleave chunk of the merged symbols (fewer than a
    MERGE_CHUNK)."""
    _append_domain(monkeypatch, domain)
    e0 = FMDIndex.restore(pair["paths"][0], "cpu")
    e1 = FMDIndex.from_bwt(pair["b1"], "cpu")
    assert (e0.fused is None) == (domain == "unfused_int64")

    def layout(e):
        return sum(a.numel() * a.element_size() for a in (
            e.bwt_blocks, e.occ, e.bwt_packed, e.fused) if a is not None)
    n0, n1 = e0.total, e1.total
    assert TM.index_layout_bytes(n0) == layout(e0)
    assert TM.index_layout_bytes(n1) == layout(e1)
    rows = max(e0.bwt_blocks.shape[0], e1.bwt_blocks.shape[0])
    assert rows * 128 < tfmd.RESTORE_CHUNK and n0 + n1 < TM.MERGE_CHUNK
    temps = (TM.RESTORE_SLICE_BYTES_PER_SYMBOL * rows * 128
             + TM.MERGE_CHUNK_BYTES_PER_SYMBOL * (n0 + n1))
    assert TM.card_append_bytes(n0, n1) == \
        layout(e0) + layout(e1) + 2 * (n0 + n1) + temps


@pytest.mark.parametrize("which", [0, 1, 2])
def test_fmd_counts_from_the_header(pair, tmp_path, which):
    """The header's symbols and sequences, with no run decoded: those of
    rld.read_fmd; a file that is no RLD\\2 index raises."""
    from fermi_tpu_torch import rld

    path = pair["paths"][which]
    runs = rld.read_fmd(path)
    assert TM.fmd_counts(path) == (runs.total, runs.n_seqs)
    bad = tmp_path / "bad.fmd"
    bad.write_bytes(open(path, "rb").read()[:36])
    with pytest.raises(ValueError, match="truncated"):
        TM.fmd_counts(str(bad))
    bad.write_bytes(b"RLE" + open(path, "rb").read()[3:])
    with pytest.raises(ValueError, match="not an RLD"):
        TM.fmd_counts(str(bad))


@pytest.mark.parametrize("route", ["card", "stream"])
def test_cli_build_append_to_stdout(pair, tmp_path, monkeypatch,
                                    capfdbinary, route):
    """`build -i -o -` on either route writes fermi_tpu's `build -i -o -`
    bytes to file descriptor 1, the [M::build] line to 2."""
    old, fa, _ = _append_inputs(pair, tmp_path)
    jold = str(tmp_path / "jold.fmd")
    shutil.copyfile(old, jold)
    assert jmain(["build", "-i", jold, fa]) == 0
    want = capfdbinary.readouterr().out
    _force_route(monkeypatch, pair, route)
    assert tmain(["build", "--device", "cpu", "-i", old, fa]) == 0
    got = capfdbinary.readouterr()
    assert got.out == want == open(pair["paths"][2], "rb").read()
    assert f"by the {route} route".encode() in got.err


@pytest.mark.parametrize("route", ["card", "stream"])
def test_appended_index_oracles(pair, tmp_path, monkeypatch, route):
    """The smoke test's gates on its appended index, in small, in the
    unfused int64 domain: `build -i` of b's reads onto a by either route
    held to a's and b's own indexes (_held_to_its_blocks; the port's
    multi_backward_search is held to fermi_tpu's over the same two
    indexes in test_two_indexes_merged_oracles)."""
    old, fa, _ = _append_inputs(pair, tmp_path)
    _unfused_int64(monkeypatch, 0)
    _force_route(monkeypatch, pair, route)
    app = str(tmp_path / "app.fmd")
    assert tmain(["build", "--device", "cpu", "-fo", app, "-i", old,
                  fa]) == 0
    assert TM.APPEND_STATS["route"] == route
    ea, m = (FMDIndex.restore(p, "cpu") for p in (old, app))
    eb = FMDIndex.from_bwt(pair["b1"], "cpu")
    _held_to_its_blocks(pair, ea, eb, m, against_fermi_tpu=False)


# -- build in spans ---------------------------------------------------------


@pytest.fixture(scope="module")
def all_reads(pair, tmp_path_factory):
    """a's and b's reads as one FASTA, the port's text of them and
    fermi_tpu's `build` of them."""
    from fermi_tpu_torch.construct import suffix as tsuffix
    from fermi_tpu_torch.core import dna

    d = tmp_path_factory.mktemp("spans")
    reads = pair["r0"] + pair["r1"]
    fa, jout = str(d / "all.fa"), str(d / "j.fmd")
    write_fasta(fa, reads)
    assert jmain(["build", "-fo", jout, fa]) == 0
    text = tsuffix.build_text([dna.encode(r) for r in reads])
    return dict(fa=fa, text=text, want=open(jout, "rb").read())


def _span_lines(text, free):
    """The route lines `build` of `text` prints at `free` bytes: the
    route, then each fold's `build -i` line."""
    seqs = np.cumsum(text == 0)
    n_seqs = int(seqs[-1])
    need = TM.build_bytes(text.size, n_seqs)
    head = f"[M::build] {text.size} symbols ({n_seqs} sequences) "
    if need <= free:
        return [head + f"by the card route: reckoned device peak {need} "
                f"bytes, free {free}"]
    cuts = TM.span_cuts(text, free)
    lines = [head + f"in {len(cuts)} spans: reckoned device peak {need} "
             f"bytes, free {free}"]
    for lo, hi in cuts[1:]:
        fold = TM.card_append_bytes(lo, hi - lo)
        route = "card" if fold <= free else "stream"
        lines.append(f"[M::build] append {hi - lo} symbols to {lo} "
                     f"({int(seqs[lo - 1])} sequences) by the {route} "
                     f"route: reckoned device peak {fold} bytes, free {free}")
    return lines


def _span_figure(text, figure):
    """The free-byte figure of a case: the one-piece build's reckoned
    peak ("card"), or the largest whole percent of it below whose spans
    all fold by the card route ("spans_card") or at least one by the
    streaming route ("spans_stream")."""
    need = TM.build_bytes(text.size, int(np.count_nonzero(text == 0)))
    if figure == "card":
        return need
    for pct in range(99, 0, -1):
        free = need * pct // 100
        routes = [line.split(" by the ")[1].split()[0]
                  for line in _span_lines(text, free)[1:]]
        if routes and (figure == "spans_card") == ("stream" not in routes):
            return free
    raise AssertionError(f"no figure gives {figure}")


def _route_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith("[M::build]")]


@pytest.mark.parametrize("figure", ["card", "spans_card", "spans_stream"])
@pytest.mark.parametrize("domain", APPEND_DOMAINS)
def test_cli_build_in_spans(all_reads, tmp_path, monkeypatch, capsys,
                            domain, figure):
    """`build` with the free bytes at the one-piece build's reckoned peak
    takes the card route; below it the text is cut into the largest spans
    that fit and folded by `build -i`'s routes (all by the card route, or
    at least one by the streaming route), each fold's line on stderr.
    fermi_tpu's `build` bytes and the port's one-piece build's, and no
    temporary or .fmd.blk left beside the output."""
    _append_domain(monkeypatch, domain)
    text = all_reads["text"]
    one = str(tmp_path / "one.fmd")
    assert tmain(["build", "--device", "cpu", "-fo", one,
                  all_reads["fa"]]) == 0
    free = _span_figure(text, figure)
    monkeypatch.setattr(TM, "free_bytes", lambda dev: free)
    out = str(tmp_path / "out.fmd")
    capsys.readouterr()
    assert tmain(["build", "--device", "cpu", "-fo", out,
                  all_reads["fa"]]) == 0
    lines = _route_lines(capsys.readouterr().err)
    assert lines == _span_lines(text, free)
    assert (len(lines) == 1) == (figure == "card")
    assert ("stream route" in "".join(lines)) == (figure == "spans_stream")
    assert TM.BUILD_STATS["route"] == ("card" if figure == "card"
                                       else "spans")
    assert open(out, "rb").read() == open(one, "rb").read() == \
        all_reads["want"]
    assert sorted(os.listdir(tmp_path)) == ["one.fmd", "out.fmd"]


@pytest.mark.parametrize("figure", ["spans_card", "spans_stream"])
@pytest.mark.parametrize("domain", APPEND_DOMAINS)
def test_cli_build_in_spans_to_stdout(all_reads, tmp_path, monkeypatch,
                                      capfdbinary, domain, figure):
    """`build -o -` in spans writes fermi_tpu's bytes to file descriptor
    1; its temporaries, in the temporary directory, are removed."""
    import tempfile

    _append_domain(monkeypatch, domain)
    free = _span_figure(all_reads["text"], figure)
    monkeypatch.setattr(TM, "free_bytes", lambda dev: free)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    assert tmain(["build", "--device", "cpu", all_reads["fa"]]) == 0
    got = capfdbinary.readouterr()
    assert got.out == all_reads["want"]
    assert _route_lines(got.err.decode()) == \
        _span_lines(all_reads["text"], free)
    assert os.listdir(tmp) == []


@pytest.mark.parametrize("domain", APPEND_DOMAINS)
def test_build_reckons_the_fold_layouts(pair, all_reads, monkeypatch,
                                        domain):
    """The layout terms of blocked_bytes' folds are the arrays a blocked
    build allocates: each fold's accumulated and block indexes
    (index_layout_bytes of their symbols), its gap bits and merged BWT (1
    B a merged symbol each); every fold's reckoning holds them."""
    from fermi_tpu_torch.construct import blocked

    _append_domain(monkeypatch, domain)
    text = all_reads["text"]
    blk = text.size // 4
    folds = []
    walk, interleave = TM.compute_gap_bits, TM.merge_bwts

    def layout(e):
        return sum(a.numel() * a.element_size() for a in (
            e.bwt_blocks, e.occ, e.bwt_packed, e.fused) if a is not None)

    def spy_walk(e0, e1, **kw):
        bits = walk(e0, e1, **kw)
        folds.append(dict(m=e0.total, b=e1.total, acc=layout(e0),
                          blk=layout(e1), bits=bits.numel(),
                          fused=e0.fused is not None))
        return bits

    def spy_interleave(b0, b1, bits, **kw):
        out = interleave(b0, b1, bits, **kw)
        folds[-1]["merged"] = out.numel() * out.element_size()
        return out
    monkeypatch.setattr(TM, "compute_gap_bits", spy_walk)
    monkeypatch.setattr(TM, "merge_bwts", spy_interleave)
    got = blocked.device_build_text(text, block_symbols=blk, device="cpu")
    assert np.array_equal(got, _bwt(pair["paths"][2]))
    assert len(folds) >= 3
    for f in folds:
        t = f["m"] + f["b"]
        assert f["acc"] == TM.index_layout_bytes(f["m"])
        assert f["blk"] == TM.index_layout_bytes(f["b"])
        assert f["bits"] == f["merged"] == t
        assert f["fused"] == (domain == "default")
        assert TM._fold_bytes(text.size, f["m"], f["b"]) >= \
            text.size + t + f["acc"] + f["blk"] + f["bits"]


@pytest.mark.parametrize("pct", [60, 30, 10])
def test_span_cuts_keep_reads_whole(pair, pct):
    """span_cuts cuts a text into contiguous spans, each the largest that
    fits the free bytes (or a single read): in `build`'s text only after a
    read's reverse complement, so every span holds an even number of
    sequences, a palindrome trimmed by 1 bp included; in a text of
    strands, after any sentinel."""
    from fermi_tpu_torch.construct import suffix as tsuffix
    from fermi_tpu_torch.core import dna

    reads = pair["r0"] + ["ACGTACGT", "GGATCC"] + pair["r1"]
    text = tsuffix.build_text([dna.encode(r) for r in reads])
    assert text.size == sum(2 * len(r) + 2 for r in reads) - 4
    before = np.concatenate([[0], np.cumsum(text == 0)])
    free = TM.build_bytes(text.size, int(before[-1])) * pct // 100
    for unit in (2, 1):
        cuts = TM.span_cuts(text, free, paired=unit == 2)
        assert cuts[0][0] == 0 and cuts[-1][1] == text.size
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        ends = np.flatnonzero(text == 0)[unit - 1::unit] + 1
        for lo, hi in cuts:
            seqs = int(before[hi] - before[lo])
            assert text[hi - 1] == 0 and before[hi] % unit == 0
            assert TM.build_bytes(hi - lo, seqs) <= free or seqs == unit
            if hi < text.size:
                nxt = int(ends[np.searchsorted(ends, hi) + 1])
                assert TM.build_bytes(nxt - lo, seqs + unit) > free
        assert len(cuts) > 1


def test_build_route_decision(monkeypatch):
    """`build`'s route by the free bytes: the card route at the reckoned
    peak and off CUDA, spans one byte below.  Prefix doubling's 49.5 B a
    symbol up to MAX_TEXT, then the blocked builder's far smaller peak;
    past FUSED_MAX its last fold onto fused rows sets it, until the last
    fold onto unfused rows is larger.  On an 80 GB card's free memory the
    one piece takes 1.5 Gsym, not 2.0 (in spans), 2^31 and 15 Gsym, not
    2^35."""
    from fermi_tpu_torch.construct import blocked, suffix_device

    n, seqs = 63_176_712, 625_512
    need = TM.build_bytes(n, seqs)
    assert need == TM.doubling_bytes(n) == int(49.5 * n)
    for free, route in ((need, "card"), (need - 1, "spans"),
                        (None, "card")):
        monkeypatch.setattr(TM, "free_bytes", lambda dev: free)
        assert TM.build_route(n, "cpu", seqs) == (route, need, free)
    top = suffix_device.MAX_TEXT
    assert TM.build_bytes(top - 1) == TM.doubling_bytes(top - 1) > 10**11
    assert TM.build_bytes(top, top // 101) < 16 * 10**9
    b = blocked.BLOCK_SYMBOLS
    for n, m in ((4_524_800_000, tfmd.FUSED_MAX - 1),
                 (20_000_000_000, 20_000_000_000 - 1)):
        assert TM.blocked_bytes(n, n // 101) == TM._fold_bytes(n, m, b)
    monkeypatch.setattr(TM, "free_bytes", lambda dev: 79 * 10**9)
    for n, route in ((1_500_000_000, "card"), (2_000_000_000, "spans"),
                     (2**31, "card"), (15_000_000_000, "card"),
                     (2**35, "spans")):
        assert TM.build_route(n, "cuda", n // 101)[0] == route


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
