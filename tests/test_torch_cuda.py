"""The port on the card against the port on the CPU (its plain versions).

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from fermi_tpu_torch.core import dna
from fermi_tpu_torch.ops import rank_cuda
from fermi_tpu_torch.search import extend, smem

from util import random_reads, write_fasta, write_fastq

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    nib = rng.integers(0, 7, (n, 16, 8)).astype(np.uint32)
    words = np.zeros((n, 16), np.uint32)
    for s in range(8):
        words |= nib[:, :, s] << (4 * s)
    return (torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(np.arange(n, dtype=np.int32) % 129))


def test_k1_entry_points(card):
    w, off = _rows(129 * 64, seed=6)
    before = dict(rank_cuda.LAUNCHES)
    got = rank_cuda.rank_block_counts(w.to(card), off.to(card)).cpu()
    assert torch.equal(got, rank_cuda.rank_block_counts_plain(w, off))
    fused = torch.zeros((w.shape[0], 24), dtype=torch.int32)
    fused[:, :16] = w
    g = torch.Generator().manual_seed(7)
    fused[:, 16:22] = torch.randint(-2**31, 2**31 - 1, (w.shape[0], 6),
                                    generator=g, dtype=torch.int32)
    for dt in (torch.int64, torch.int32):
        k = torch.arange(w.shape[0] * 128, dtype=dt)
        got = rank_cuda.rank6_fused(fused.to(card), k.to(card)).cpu()
        assert got.dtype == dt
        assert torch.equal(got, rank_cuda.rank6_fused_plain(fused, k))
    assert rank_cuda.LAUNCHES["rank6_fused"] == before["rank6_fused"] + 2
    with pytest.raises(TypeError):
        rank_cuda.rank6_fused(fused.to(card), k.to(card).to(torch.int16))
    with pytest.raises(ValueError):
        rank_cuda.rank6_fused(fused.to(card), k.to(card)[::2])


@pytest.mark.parametrize("dt", [torch.int32, torch.int64])
def test_k1_sector_offsets_and_dead_keys(card, dt):
    """rank6_fused at the offsets where the sectors it loads change (0, 1,
    63, 64, 65, 127 and 128, the next row's 0), occ patterns >= 2^31, and a
    batch whose keys are mostly 0 (the dead slots of an SMEM step)."""
    w, _ = _rows(64, seed=8)
    fused = torch.zeros((65, 24), dtype=torch.int32)
    fused[:64, :16] = w
    g = torch.Generator().manual_seed(9)
    fused[:, 16:22] = torch.randint(-2**31, 2**31 - 1, (65, 6), generator=g,
                                    dtype=torch.int32)
    offs = torch.tensor([0, 1, 63, 64, 65, 127, 128])
    k = (torch.arange(64)[:, None] * 128 + offs).reshape(-1)
    mostly0 = torch.where(torch.rand(4096, generator=g) < 0.9, 0,
                          torch.randint(0, 64 * 128 + 1, (4096,),
                                        generator=g))
    for keys in (k, mostly0):
        keys = keys.to(dt)
        got = rank_cuda.rank6_fused(fused.to(card), keys.to(card)).cpu()
        assert torch.equal(got, rank_cuda.rank6_fused_plain(fused, keys))


def _sw_edges(rng, rows):
    """Queries at every group size and at the edges of a lane and of a
    chunk (R = rows a lane holds; up to 6 chunks, more than a block's warps)
    against targets at and around 256 columns and of ~6,000, half holding a
    mutated copy of the query, in random order."""
    qlens = (1, rows, rows + 1, 4 * rows + 1, 8 * rows + 1, 16 * rows + 1,
             32 * rows, 32 * rows + 1, 96 * rows + 5, 160 * rows + 3)
    tlens = (1, 255, 256, 257, int(rng.integers(5900, 6100)))
    qs, ts = [], []
    for ql in qlens:
        for tl in tlens:
            q = rng.integers(0, 4, ql).astype(np.int8)
            t = rng.integers(0, 4, tl).astype(np.int8)
            if rng.random() < 0.5:
                at = int(rng.integers(0, tl))
                t = np.concatenate([t[:at], q[:tl // 2], t[at:]])[:tl]
            qs.append(q)
            ts.append(t)
    order = rng.permutation(len(qs))
    return [qs[i] for i in order], [ts[i] for i in order]


@pytest.mark.parametrize("scores", [{}, dict(match=2, mismatch=-3, gapo=3,
                                              gape=1)])
def test_k2_layout_edges(card, scores):
    """K2 against its plain version at every group size, query lengths at
    the edges of a lane and of a chunk (one to six chunks), targets at and
    around 256 columns and of ~6,000, alone and in one mixed batch with
    random pairs."""
    from fermi_tpu_torch.ops import sw_cuda

    def plain(qs, ts):
        (qc, qo), (tc, to) = sw_cuda.pack(qs), sw_cuda.pack(ts)
        return sw_cuda.sw_score_batch_plain(
            *(torch.from_numpy(a).to(card) for a in (qc, qo, tc, to)),
            **scores).cpu().numpy()

    rng = np.random.default_rng(17)
    qs, ts = _sw_edges(rng, sw_cuda.ROWS)
    for q in range(3):
        got = sw_cuda.sw_score_batch(qs[q::3], ts[q::3], device=card,
                                     **scores)
        assert np.array_equal(got, plain(qs[q::3], ts[q::3]))
    mixed = list(zip(qs, ts)) + [
        (rng.integers(0, 4, int(rng.integers(1, 300))).astype(np.int8),
         rng.integers(0, 4, int(rng.integers(1, 600))).astype(np.int8))
        for _ in range(300)]
    mixed = [mixed[i] for i in rng.permutation(len(mixed))]
    mq, mt = [m[0] for m in mixed], [m[1] for m in mixed]
    got = sw_cuda.sw_score_batch(mq, mt, device=card, **scores)
    assert np.array_equal(got, plain(mq, mt))
    with pytest.raises(ValueError, match="gapo"):
        sw_cuda.sw_score_batch(mq, mt, device=card, gapo=-1)


@pytest.fixture(scope="module")
def pair(card):
    from fermi_tpu_torch.api import build_index
    reads = random_reads(150, seed=5, with_genome=True, genome_len=4000)
    return reads, build_index(reads, card), build_index(reads, "cpu")


def test_index_and_rank(pair):
    _, gidx, cidx = pair
    for f in ("bwt_blocks", "occ", "cnt", "mcnt", "bwt_packed", "fused"):
        assert torch.equal(getattr(gidx, f).cpu(), getattr(cidx, f)), f
    ks = torch.arange(cidx.total + 1)
    assert torch.equal(gidx.rank6(ks.to(gidx.device)).cpu(), cidx.rank6(ks))


def test_walks(pair):
    _, gidx, cidx = pair
    ids = torch.arange(cidx.n_seqs)
    for a, b in zip(extend.retrieve2(gidx, ids.to(gidx.device), 128),
                    extend.retrieve2(cidx, ids, 128)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(extend.seqrank_walk(gidx, ids.to(gidx.device), 64),
                    extend.seqrank_walk(cidx, ids, 64)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("maxi,self_match", [(None, False), (None, True),
                                             (4, False)])
def test_smem(pair, maxi, self_match):
    reads, gidx, cidx = pair
    qry = [dna.encode(s) for s in
           random_reads(80, seed=6, with_genome=True, genome_len=4000)]
    kw = dict(self_match=self_match)
    if maxi:
        kw.update(maxi=maxi, maxm=8)
    before = rank_cuda.LAUNCHES["rank6_fused"]
    got = smem.smem_all(gidx, qry, **kw)
    assert rank_cuda.LAUNCHES["rank6_fused"] > before
    assert got == smem.smem_all(cidx, qry, **kw)


def test_cli_exact(card, tmp_path):
    from fermi_tpu_torch.cli.main import main

    fa, qfa = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    write_fasta(fa, random_reads(100, seed=8, with_genome=True,
                                 genome_len=3000))
    write_fasta(qfa, random_reads(40, seed=9, with_genome=True,
                                  genome_len=3000))
    outs = []
    for dev in ("cuda", "cpu"):
        fmd = str(tmp_path / f"{dev}.fmd")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["build", "--device", dev, "-fo", fmd, fa]) == 0
            assert main(["unpack", "--device", dev, fmd]) == 0
            assert main(["exact", "--device", dev, fmd, qfa]) == 0
        outs.append((open(fmd, "rb").read(), buf.getvalue()))
    assert outs[0] == outs[1]


def test_k2_against_plain(card):
    """K2 on the card against its plain version: random pairs, targets of
    up to ~5,300 columns, length-1 and empty sequences."""
    from fermi_tpu_torch.ops import sw_cuda

    rng = np.random.default_rng(11)
    qs, ts = [], []
    for i in range(600):
        q = rng.integers(0, 4, int(rng.integers(1, 300))).astype(np.int8)
        tl = int(rng.integers(1, 5000 if i % 50 == 0 else 600))
        t = rng.integers(0, 4, tl).astype(np.int8)
        if i % 2:
            at = int(rng.integers(0, tl))
            t = np.concatenate([t[:at], q, t[at:]])
        qs.append(q)
        ts.append(t)
    qs += [np.array([1], np.int8), np.zeros(0, np.int8), np.array([2], np.int8)]
    ts += [np.array([1], np.int8), np.array([3], np.int8), np.zeros(0, np.int8)]
    before = sw_cuda.LAUNCHES["sw_score_batch"]
    got = sw_cuda.sw_score_batch(qs, ts, device=card)
    assert sw_cuda.LAUNCHES["sw_score_batch"] == before + 1
    assert np.array_equal(got, sw_cuda.sw_score_batch(qs, ts, device="cpu"))
    assert got[-3] == 5 and got[-2] == 0 and got[-1] == 0
    # a plan of some of the pairs runs those; sequences that end before the
    # plan's offsets are refused
    (qc, qo), (tc, to) = sw_cuda.pack(qs), sw_cuda.pack(ts)
    q, t = torch.from_numpy(qc).to(card), torch.from_numpy(tc).to(card)
    part = sw_cuda.sw_plan(qo[100:201], to[100:201], card)
    assert np.array_equal(sw_cuda.sw_scores(q, t, part).cpu().numpy(),
                          got[100:200])
    with pytest.raises(ValueError, match="reach"):
        sw_cuda.sw_scores(q[:-1], t, sw_cuda.sw_plan(qo, to, card))


@pytest.fixture(scope="module")
def ec_files(card, tmp_path_factory):
    """A 4 kbp genome at 20x with 1% substitutions at quality 14, as FASTQ,
    and its index built on the card."""
    from fermi_tpu_torch.cli.main import main

    d = tmp_path_factory.mktemp("ec")
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 4000)
    asc = np.frombuffer(b"ACGT", np.uint8)
    fq = str(d / "r.fq")
    with open(fq, "w") as f:
        for i in range(800):
            p = int(rng.integers(0, 3900))
            r = genome[p:p + 100].copy()
            q = np.full(100, 38 + 33, np.uint8)
            e = rng.random(100) < 0.01
            r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
            q[e] = 14 + 33
            if i % 2:
                r, q = 3 - r[::-1], q[::-1]
            s = asc[r].tobytes().decode()
            if i % 29 == 0:
                s = s[:40] + "N" + s[41:]
            f.write(f"@r{i}\n{s}\n+\n{q.tobytes().decode()}\n")
    fmd = str(d / "i.fmd")
    assert main(["build", "--device", "cuda", "-fo", fmd, fq]) == 0
    return fq, fmd


@pytest.mark.parametrize("device_fix", ["0", "1"])
def test_correct_card_vs_cpu(ec_files, monkeypatch, device_fix):
    from fermi_tpu_torch.algos import correct as ec
    from fermi_tpu_torch.index.fmd import FMDIndex

    fq, fmd = ec_files
    monkeypatch.setenv("FERMI_TPU_DEVICE_FIX", device_fix)
    outs = []
    for dev in ("cuda", "cpu"):
        idx = FMDIndex.restore(fmd, dev)
        assert idx.device.type == dev
        got = ec.collect_solid_kmers(idx, 19, 3)
        buf = io.StringIO()
        before = rank_cuda.LAUNCHES["rank6_fused"]
        ec.ec_correct(idx, fq, buf, n_threads=2, verbose=False)
        if dev == "cuda":
            assert rank_cuda.LAUNCHES["rank6_fused"] > before
        outs.append((sorted(zip(*(a.tolist() for a in got[:3]))), got[3],
                     buf.getvalue()))
    assert outs[0] == outs[1] and outs[0][2].count("\n+\n") > 700


def test_seqsort_card_vs_cpu(ec_files):
    from fermi_tpu_torch.algos.seqsort import seqsort
    from fermi_tpu_torch.index.fmd import FMDIndex

    _, fmd = ec_files
    got = seqsort(FMDIndex.restore(fmd, "cuda"), batch=300, verbose=False)
    assert np.array_equal(got, seqsort(FMDIndex.restore(fmd, "cpu"),
                                       verbose=False))
    assert np.array_equal(np.sort(got >> np.uint64(2)),
                          np.arange(len(got), dtype=np.uint64))



def test_unitig_card_vs_cpu(card, tmp_path):
    """Link records (tight primary budgets, so the ladder runs) and the MAG
    text of `unitig`, with and without a .rank array, on the card equal the
    CPU's."""
    from fermi_tpu_torch.algos.seqsort import seqsort
    from fermi_tpu_torch.algos.unitig_bulk import stitch_native
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import unitig_links as ul

    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 3000)
    reads = []
    for _ in range(1500):
        p = int(rng.integers(0, 2900))
        r = genome[p:p + 100].copy()
        e = rng.random(100) < 0.004
        r[e] = (r[e] + 1) % 4
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads.append("".join("ACGT"[c] for c in r))
    fa, fmd = str(tmp_path / "r.fa"), str(tmp_path / "i.fmd")
    rank = str(tmp_path / "i.rank")
    write_fasta(fa, reads)
    assert main(["build", "--device", "cuda", "-fo", fmd, fa]) == 0
    seqsort(FMDIndex.restore(fmd, card), verbose=False).tofile(rank)
    stores = []
    for dev in ("cuda", "cpu"):
        idx = FMDIndex.restore(fmd, dev)
        seqs, ks = extend.retrieve_strings(idx, np.arange(idx.n_seqs),
                                           bound=1024)
        before = rank_cuda.LAUNCHES["rank6_fused"]
        stores.append(ul.compute_links_device(idx, seqs, 30, batch=700,
                                              ladder_batch=50,
                                              jmax_primary=8, device=dev))
        if dev == "cuda":
            assert rank_cuda.LAUNCHES["rank6_fused"] > before
            assert ul.STATS["ladder_rows"] > 0
    for name, a in vars(stores[0]).items():
        b = getattr(stores[1], name)
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y), name
    assert (stitch_native(idx, stores[0], seqs, ks, 30)
            == stitch_native(idx, stores[1], seqs, ks, 30))
    outs = {}
    for dev in ("cuda", "cpu"):
        for r in ([], ["-r", rank]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(["unitig", "--device", dev, "-l", "50", *r,
                             fmd]) == 0
            outs[dev, bool(r)] = buf.getvalue()
    assert outs["cuda", False] == outs["cpu", False]
    assert outs["cuda", True] == outs["cpu", True]
    assert outs["cuda", False].count("\n+\n") > 3


@pytest.fixture(scope="module")
def two_samples(card, tmp_path_factory):
    """Two read sets sharing a 6 kbp genome, each with a 1 kbp private
    region, built on the card, with their .rank arrays."""
    from fermi_tpu_torch.algos.seqsort import seqsort
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.index.fmd import FMDIndex

    d = tmp_path_factory.mktemp("setops")
    rng = np.random.default_rng(31)
    shared = "".join("ACGT"[c] for c in rng.integers(0, 4, 6000))
    out = []
    for tag, step in (("a", 7), ("b", 9)):
        g = shared + "".join("ACGT"[c] for c in rng.integers(0, 4, 1000))
        fa, fmd = str(d / f"{tag}.fa"), str(d / f"{tag}.fmd")
        write_fasta(fa, [g[p:p + 100] for p in range(0, len(g) - 100, step)])
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["build", "--device", "cuda", "-fo", fmd, fa]) == 0
        rank = str(d / f"{tag}.rank")
        seqsort(FMDIndex.restore(fmd, card), verbose=False).tofile(rank)
        out.append((fa, fmd, rank))
    return d, out


def test_setops_card_vs_cpu(two_samples):
    """Gap bits (two batch sizes), sub bits and contrast bits on the card
    equal the CPU's, and each path launched K1."""
    from fermi_tpu_torch.algos import contrast, merge, sub
    from fermi_tpu_torch.index.fmd import FMDIndex

    _, ((_, f0, _), (_, f1, _)) = two_samples
    res = {}
    for dev in ("cuda", "cpu"):
        e0, e1 = FMDIndex.restore(f0, dev), FMDIndex.restore(f1, dev)
        before = rank_cuda.LAUNCHES["rank6_fused"]
        r = [merge.compute_gap_bits(e0, e1, batch=b).cpu().numpy()
             for b in (1 << 20, 100)]
        ids = np.flatnonzero(np.random.default_rng(2).random(e0.n_seqs)
                             < 0.4)
        r.append(sub.mark_read_positions(e0, ids, e0.total).cpu().numpy())
        r += list(contrast.fm6_contrast(e0, e1, 31, 3))
        if dev == "cuda":
            assert rank_cuda.LAUNCHES["rank6_fused"] > before
        res[dev] = r
    assert np.array_equal(res["cuda"][0], res["cuda"][1])
    for a, b in zip(res["cuda"], res["cpu"]):
        assert np.array_equal(a, b)
    assert res["cuda"][3].sum() > 0 and res["cuda"][4].sum() > 0


def test_setops_cli_card_vs_cpu(two_samples, capfdbinary):
    """merge, build -i, sub and contrast through the CLI on the card and
    on the CPU: equal bytes."""
    from fermi_tpu_torch.algos.sub import pack_bitfile
    from fermi_tpu_torch.cli.main import main

    d, ((fa0, f0, r0), (fa1, f1, r1)) = two_samples
    bits = str(d / "sel.bits")
    pack_bitfile(bits, np.repeat(np.random.default_rng(3).random(
        np.fromfile(r0, np.uint64).size // 2) < 0.4, 2))
    outs = {}
    for dev in ("cuda", "cpu"):
        dv = ["--device", dev]
        m, a = str(d / f"m_{dev}.fmd"), str(d / f"a_{dev}.fmd")
        subs = [str(d / f"{dev}{i}.sub") for i in (0, 1)]
        assert main(["merge", *dv, "-fo", m, f0, f1, f0]) == 0
        assert main(["build", *dv, "-fo", a, "-i", f0, fa1]) == 0
        assert main(["sub", *dv, "-c", f0, bits]) == 0
        out = capfdbinary.readouterr().out
        assert main(["contrast", *dv, f0, r0, subs[0], f1, r1, subs[1]]) == 0
        outs[dev] = [open(p, "rb").read() for p in (m, a, *subs)] + [out]
    assert outs["cuda"] == outs["cpu"]


def test_builders_card_vs_cpu(card):
    """wsort, the blocked builder (several blocks) and BCR on the card
    equal the CPU's and the whole-text build."""
    from fermi_tpu_torch.construct import bcr_device, blocked, suffix, wsort
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device

    reads = random_reads(400, seed=14, with_genome=True, genome_len=5000)
    seqs = [dna.encode(s) for s in reads]
    text = suffix.build_text(seqs)
    want = multistring_bwt_device(text, "cpu")
    for dev in ("cuda", "cpu"):
        assert np.array_equal(wsort.wsort_bwt(text, device=dev), want)
        got = blocked.device_build_text(text, block_symbols=9000, device=dev)
        assert blocked.STATS["blocks"] > 3 and np.array_equal(got, want)
    one = [dna.encode(s) for s in reads]
    assert np.array_equal(bcr_device.bcr_bwt_device(one, device="cuda"),
                          bcr_device.bcr_bwt_device(one, device="cpu"))


def test_run_card_vs_cpu(card, tmp_path):
    """`run` (the unpaired pipeline) on the card writes the CPU's
    artifacts, compared decompressed, and launches K1."""
    import gzip

    from fermi_tpu_torch.cli.main import main

    rng = np.random.default_rng(31)
    genome = rng.integers(0, 4, 4000)
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(1600):
            p = int(rng.integers(0, 3930))
            r = genome[p:p + 70].copy()
            e = rng.random(70) < 0.005
            r[e] = (r[e] + 1) % 4
            if rng.random() < 0.5:
                r = 3 - r[::-1]
            f.write(f"@r{i}\n{''.join('ACGT'[c] for c in r)}\n+\n"
                    f"{'I' * 70}\n")
    before = rank_cuda.LAUNCHES["rank6_fused"]
    for dev in ("cuda", "cpu"):
        assert main(["run", "--device", dev, "-t", "2", "-k", "40", "-p",
                     str(tmp_path / dev), str(fq)]) == 0
        if dev == "cuda":
            assert rank_cuda.LAUNCHES["rank6_fused"] > before
    for sfx in ("raw.fmd", "ec.fq.gz", "ec.fmd", "p0.mag.gz", "p1.mag.gz",
                "p2.mag.gz"):
        read = gzip.open if sfx.endswith(".gz") else open
        with read(tmp_path / f"cuda.{sfx}", "rb") as a, \
                read(tmp_path / f"cpu.{sfx}", "rb") as b:
            assert a.read() == b.read(), sfx


def test_chkbwt_rank_check(card, tmp_path, monkeypatch):
    """`chkbwt -r` on the card checks K1 at every position (in several
    chunks) and passes; the CPU prints the same lines."""
    from fermi_tpu_torch.cli import main as cli

    reads = random_reads(300, seed=41, with_genome=True, genome_len=5000)
    fa, fmd = str(tmp_path / "r.fa"), str(tmp_path / "i.fmd")
    write_fasta(fa, reads)
    assert cli.main(["build", "--device", "cuda", "-fo", fmd, fa]) == 0
    monkeypatch.setattr(cli, "CHKBWT_CHUNK", 4099)
    outs = []
    for dev in ("cuda", "cpu"):
        before = rank_cuda.LAUNCHES["rank6_fused"]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli.main(["chkbwt", "--device", dev, "-r", fmd]) == 0
        if dev == "cuda":
            assert rank_cuda.LAUNCHES["rank6_fused"] - before > 3
        outs.append([ln for ln in err.getvalue().splitlines()
                     if "::chkbwt]" in ln])
    assert outs[0] == outs[1] and "rank check passed" in outs[0][-1]


def test_run_paired_card_vs_cpu(card, tmp_path, monkeypatch):
    """`run -P` (the paired chain to p5) on the card writes the CPU's
    artifacts, compared decompressed; scaf walks its mates through K1 and
    sorts its local assemblies on the card.  The genome is two copies of a
    160 bp repeat around unique sequence, with a dead zone where no read
    starts, so p4 holds joined scaftigs."""
    import gzip

    from fermi_tpu_torch.algos import scaf
    from fermi_tpu_torch.cli.main import main

    rng = np.random.default_rng(1)
    rep = rng.integers(0, 4, 160)
    segs = [rng.integers(0, 4, n) for n in (2200, 1400, 2000, 1500)]
    genome = np.concatenate([segs[0], rep, segs[1], segs[2], rep, segs[3]])
    jn = 2200 + 160 + 1400
    fq = tmp_path / "pe.fq"
    with open(fq, "w") as f:
        for i in range(4000):
            ins = int(np.clip(rng.normal(240, 22), 80, 450))
            pos = int(rng.integers(0, len(genome) - ins))
            r0 = pos + ins - 70
            if jn - 38 < pos < jn + 10 or jn - 38 < r0 < jn + 10:
                continue
            for r in (genome[pos:pos + 70], 3 - genome[r0:r0 + 70][::-1]):
                f.write(f"@p{i}\n{''.join('ACGT'[c] for c in r)}\n+\n"
                        f"{'I' * 70}\n")
    calls = []
    walk = scaf.retrieve_mates

    def spy(index, ids):
        before = rank_cuda.LAUNCHES["rank6_fused"]
        out = walk(index, ids)
        calls.append((index.device.type,
                      rank_cuda.LAUNCHES["rank6_fused"] - before))
        return out

    monkeypatch.setattr(scaf, "retrieve_mates", spy)
    for dev in ("cuda", "cpu"):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main(["run", "--device", dev, "-P", "-t", "2", "-k", "40",
                         "-p", str(tmp_path / dev), str(fq)]) == 0
        assert "stage final_remap" in err.getvalue()
        if dev == "cuda":
            assert scaf.STATS["gaps"] >= 1 and scaf.STATS["mini_bwts"] >= 1
    assert [c[0] for c in calls] == ["cuda", "cpu"]
    assert calls[0][1] > 0 and calls[1][1] == 0
    for sfx in ("raw.fmd", "ec.fq.gz", "ec.fmd", "ec.rank", "p0.mag.gz",
                "p1.mag.gz", "p2.mag.gz", "p3.mag.gz", "p4.fa.gz",
                "p5.fq.gz"):
        read = gzip.open if sfx.endswith(".gz") else open
        with read(tmp_path / f"cuda.{sfx}", "rb") as a, \
                read(tmp_path / f"cpu.{sfx}", "rb") as b:
            assert a.read() == b.read(), sfx
    with gzip.open(tmp_path / "cuda.p4.fa.gz", "rb") as f:
        assert f.read().count(b">") >= 1


def _smem_rank(rank, world, init_method, device, tp, bwt, queries):
    """One rank of the sharded SMEM card tests: its backend, the SMEMs and
    the K1 launches of its shard."""
    from fermi_tpu_torch.dist import sharded as sh
    from fermi_tpu_torch.index.fmd import FMDIndex

    dev = sh.init_ranks(rank, world, init_method, device, timeout_s=120)
    mesh = sh.make_mesh(tp=tp, device=dev)
    eng = sh.ShardedSMEM(FMDIndex.from_bwt(bwt, "cpu"), mesh)
    before = rank_cuda.LAUNCHES["rank6_fused"]
    got = eng.smem_all(queries)
    out = dict(backend=mesh.backend, smem=got,
               k1=rank_cuda.LAUNCHES["rank6_fused"] - before,
               all_reduce=sh.STATS["all_reduce"])
    if mesh.backend == "gloo":
        out["collectives"] = _gloo_cuda_collectives(dev, world, rank)
    return out


def _gloo_cuda_collectives(dev, world, rank):
    """The collectives gloo runs on CUDA tensors, each checked: all_reduce,
    broadcast and all_gather in four dtypes, all_gather_into_tensor,
    all_to_all_single and reduce_scatter_tensor."""
    import torch.distributed as dist

    ok = []
    for dt in (torch.int64, torch.int32, torch.uint8, torch.bool):
        x = torch.full((8,), rank + 1, device=dev).to(dt)
        y = x.clone()
        dist.all_reduce(y)
        b = x.clone()
        dist.broadcast(b, 1)
        g = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(g, x)
        want = torch.full((8,), world * (world + 1) // 2).to(dt)
        ok.append(torch.equal(y.cpu(), want.to(dt))
                  and torch.equal(b.cpu(), torch.full((8,), 2).to(dt))
                  and [int(t[0]) for t in g] == [
                      int(torch.tensor(r + 1).to(dt)) for r in range(world)])
    x = torch.arange(4 * world, device=dev) + 100 * rank
    g = torch.empty(4 * world * world, dtype=x.dtype, device=dev)
    dist.all_gather_into_tensor(g, x)
    a = torch.empty_like(x)
    dist.all_to_all_single(a, x)
    r = torch.empty(4, dtype=x.dtype, device=dev)
    dist.reduce_scatter_tensor(r, x)
    torch.cuda.synchronize(dev)
    ok.append(g.cpu().tolist() == [v + 100 * q for q in range(world)
                                   for v in range(4 * world)])
    ok.append(a.cpu().tolist() == [4 * rank + v + 100 * q
                                   for q in range(world) for v in range(4)])
    ok.append(r.cpu().tolist() == [sum(4 * rank + v + 100 * q
                                       for q in range(world))
                                   for v in range(4)])
    return ok


@pytest.mark.parametrize("world,device,backend", [(2, "cuda:0", "gloo"),
                                                  (1, "cuda", "nccl")])
def test_sharded_smem_ranks_on_card(pair, world, device, backend):
    """Two ranks sharing card 0 over gloo (tp=2), and a world of one over
    NCCL: the sharded SMEMs equal the single-process port's, and K1 ran on
    every rank's shard.  The gloo ranks also check the collectives gloo
    runs on CUDA tensors."""
    from fermi_tpu_torch.dist.launch import spawn_ranks

    _, gidx, _ = pair
    qry = [dna.encode(s) for s in
           random_reads(80, seed=6, with_genome=True, genome_len=4000)]
    bwt = gidx.bwt().cpu().numpy()
    res = spawn_ranks(_smem_rank, world, (device, world, bwt, qry), 300)
    want = smem.smem_all(gidx, qry)
    for r in res:
        assert r["backend"] == backend
        assert r["smem"] == want
        assert r["k1"] > 0
        assert (r["all_reduce"] > 0) == (world > 1)
        if backend == "gloo":
            assert all(r["collectives"]), r["collectives"]


def test_ropebwt_card_vs_cpu(card, tmp_path):
    from fermi_tpu_torch.cli.main import main

    reads = random_reads(300, seed=4, with_genome=True, genome_len=3000)
    fa = tmp_path / "r.fa"
    write_fasta(str(fa), reads)
    outs = {}
    for algo in ("bpr", "bcr", "sais"):
        for dev in ("cuda", "cpu"):
            for b in ([], ["-b"]):
                o = tmp_path / f"{algo}{dev}{len(b)}"
                assert main(["ropebwt", "-a", algo, "--device", dev, *b,
                             "-o", str(o), str(fa)]) == 0
                outs[algo, dev, len(b)] = o.read_bytes()
    for b in (0, 1):
        assert len({outs[a, d, b] for a in ("bpr", "bcr", "sais")
                    for d in ("cuda", "cpu")}) == 1


def test_wide_chain_card_vs_cpu(card, tmp_path, monkeypatch):
    """The wide tier's chain in small, forced into the int64 domain and
    through the blocked builder: the driver's raw_fmd on the card writes
    the CPU's bytes and launches K1 (the folds' gap walks); over the index
    restored on each device, check_ranks (`chkbwt -r`) passes and `exact`
    and `unpack` print the same bytes."""
    from fermi_tpu_torch.cli import main as cli
    from fermi_tpu_torch.construct import blocked, suffix_device
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.pipeline.driver import Pipeline

    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    monkeypatch.setattr(suffix_device, "MAX_TEXT", 2000)
    orig = blocked.device_build_text
    monkeypatch.setattr(
        blocked, "device_build_text",
        lambda text, device=None: orig(text, block_symbols=1500,
                                       device=device))
    monkeypatch.setattr(cli, "CHKBWT_CHUNK", 997)
    reads = random_reads(120, min_len=60, max_len=80, seed=51,
                         with_genome=True, genome_len=2000)
    fq, qfa = str(tmp_path / "r.fq"), str(tmp_path / "q.fa")
    write_fastq(fq, reads)
    write_fasta(qfa, reads[::4])
    fmd = {}
    for dev in ("cuda", "cpu"):
        before = rank_cuda.LAUNCHES["rank6_fused"]
        pl = Pipeline(str(tmp_path / dev), n_threads=2, device=dev)
        with contextlib.redirect_stderr(io.StringIO()):
            pl.stage_raw_fmd([fq])
        fmd[dev] = pl._p("raw.fmd")
        assert blocked.STATS["blocks"] > 3
        if dev == "cuda":
            assert rank_cuda.LAUNCHES["rank6_fused"] > before
    assert open(fmd["cuda"], "rb").read() == open(fmd["cpu"], "rb").read()
    outs = {}
    for dev in ("cuda", "cpu"):
        idx = FMDIndex.restore(fmd["cuda"], dev)
        assert idx.idtype == torch.int64 and idx.fused is not None
        with contextlib.redirect_stderr(io.StringIO()):
            assert cli.check_ranks(idx, idx.mcnt.cpu().numpy()) == 0
        outs[dev] = []
        for argv in (["exact", fmd["cuda"], qfa], ["unpack", fmd["cuda"]]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main([argv[0], "--device", dev, *argv[1:]]) == 0
            outs[dev].append(buf.getvalue())
    assert outs["cuda"] == outs["cpu"]
    assert outs["cpu"][0].count("SQ\t") == 30
    assert len(outs["cpu"][1].splitlines()) == 240


def _long_reads(seed, glen, n, lo, hi):
    """n reads of lo-hi bp from a random genome of glen bp, 0.2%
    substitutions, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen)
    reads = []
    for _ in range(n):
        m = int(rng.integers(lo, hi + 1))
        p = int(rng.integers(0, glen - m))
        r = genome[p:p + m].copy()
        e = rng.random(m) < 0.002
        r[e] = (r[e] + 1) % 4
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads.append("".join("ACGT"[c] for c in r))
    return reads


def test_seqsort_long_reads_card(card, tmp_path):
    """seqsort of reads past 4,096 bp (one of 5,000 bp among them) on the
    card: every walk runs to its sentinel, the host engine's array."""
    from fermi_tpu_torch.algos.seqsort import seqsort, seqsort_native
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.index.fmd import FMDIndex

    reads = _long_reads(31, 12000, 30, 300, 4500) + \
        [_long_reads(32, 6000, 1, 5000, 5000)[0]]
    fa, fmd = str(tmp_path / "r.fa"), str(tmp_path / "i.fmd")
    write_fasta(fa, reads)
    assert main(["build", "--device", "cuda", "-fo", fmd, fa]) == 0
    idx = FMDIndex.restore(fmd, card)
    before = rank_cuda.LAUNCHES["rank6_fused"]
    got = seqsort(idx, batch=16, verbose=False)
    assert rank_cuda.LAUNCHES["rank6_fused"] > before
    assert np.array_equal(got, seqsort_native(idx, verbose=False))


def test_unitig_long_reads_card(card, tmp_path):
    """`unitig -l 100` of 1,500 bp reads on the card, with and without a
    .rank array: the native host walk's bytes (`unitig -t 1`)."""
    from fermi_tpu_torch.algos.seqsort import seqsort_native
    from fermi_tpu_torch.algos.unitig import fm6_unitig_native
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import unitig_links as ul

    reads = _long_reads(33, 15000, 150, 1500, 1500)
    fa, fmd = str(tmp_path / "r.fa"), str(tmp_path / "i.fmd")
    rank = str(tmp_path / "i.rank")
    write_fasta(fa, reads)
    assert main(["build", "--device", "cuda", "-fo", fmd, fa]) == 0
    host = FMDIndex.restore(fmd, "cpu")
    srt = seqsort_native(host, verbose=False)
    srt.tofile(rank)
    for r, arr in (([], None), (["-r", rank], srt)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["unitig", "--device", "cuda", "-l", "100", *r,
                         fmd]) == 0
        assert ul.STATS["k1_launches"] > 0
        want = fm6_unitig_native(host, 100, arr, 1)
        assert buf.getvalue() == want and want.count("\n+\n") >= 1


def test_retrieve_mates_long_card(card, tmp_path):
    """Mate walks past their first bound of 1,024 on the card (the bound
    doubles): the CPU's reads."""
    from fermi_tpu_torch.algos.scaf import retrieve_mates
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.index.fmd import FMDIndex

    reads = _long_reads(34, 10000, 40, 1025, 2000)
    fa, fmd = str(tmp_path / "r.fa"), str(tmp_path / "i.fmd")
    write_fasta(fa, reads)
    assert main(["build", "--device", "cuda", "-fo", fmd, fa]) == 0
    ids = list(range(1, 80, 3))
    got = retrieve_mates(FMDIndex.restore(fmd, card), ids)
    want = retrieve_mates(FMDIndex.restore(fmd, "cpu"), ids)
    assert got == want and min(len(s) for s in got.values()) > 1024


def test_unfused_rows_card(pair):
    """The int64 layout without fused rows on the card (rank6 through K1's
    `rank_block_counts`): rank6 at every k and the SMEMs of the fused
    index."""
    import dataclasses

    reads, gidx, cidx = pair
    wide = dataclasses.replace(
        gidx, occ=gidx.occ.long(), cnt=gidx.cnt.long(),
        mcnt=gidx.mcnt.long(), fused=None)
    ks = torch.arange(cidx.total + 1)
    before = rank_cuda.LAUNCHES["rank_block_counts"]
    assert torch.equal(wide.rank6(ks.to(gidx.device)).cpu(),
                       cidx.rank6(ks).long())
    qry = [dna.encode(s) for s in reads[::5]]
    assert smem.smem_all(wide, qry) == smem.smem_all(cidx, qry)
    assert rank_cuda.LAUNCHES["rank_block_counts"] > before + 1


def test_merge_with_self_unfused_card(card, tmp_path, monkeypatch):
    """`merge x.fmd x.fmd` on the card (the shape of the smoke test's
    index past 2^32): the CPU's bytes.  The merged index restored without
    fused rows (FUSED_MAX lowered: the layout past 2^32 - 128 symbols) on
    the card: K1's `rank_block_counts` equal to its plain version on the
    gathered rows, rank6 at every k equal to the CPU's, and `exact`'s
    SMEMs equal to the native engine's and to x's with every interval
    doubled, through `rank_block_counts` alone."""
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.index import fmd as tfmd

    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    reads = random_reads(150, seed=5, with_genome=True, genome_len=4000)
    fa, x = str(tmp_path / "r.fa"), str(tmp_path / "x.fmd")
    write_fasta(fa, reads)
    before = rank_cuda.LAUNCHES["rank6_fused"]
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(["build", "--device", "cpu", "-fo", x, fa]) == 0
        for dev in ("cuda", "cpu"):
            assert main(["merge", "--device", dev, "-fo",
                         str(tmp_path / f"{dev}.fmd"), x, x]) == 0
    # the card's gap walk, over two indexes with fused rows
    assert rank_cuda.LAUNCHES["rank6_fused"] > before
    merged = str(tmp_path / "cuda.fmd")
    assert open(merged, "rb").read() == \
        open(str(tmp_path / "cpu.fmd"), "rb").read()
    one = tfmd.FMDIndex.restore(x, "cpu")
    monkeypatch.setattr(tfmd, "FUSED_MAX", 0)
    idx = tfmd.FMDIndex.restore(merged, card)
    cidx = tfmd.FMDIndex.restore(merged, "cpu")
    assert idx.fused is None and idx.idtype == torch.int64
    assert idx.total == 2 * one.total
    ks = torch.arange(idx.total + 1)
    rows = idx.bwt_packed[(ks >> 7).to(card)]
    off = (ks & 127).to(torch.int32)
    assert torch.equal(
        rank_cuda.rank_block_counts(rows, off.to(card)).cpu(),
        rank_cuda.rank_block_counts_plain(rows.cpu(), off))
    before = dict(rank_cuda.LAUNCHES)
    assert torch.equal(idx.rank6(ks.to(card)).cpu(), cidx.rank6(ks))
    rng = np.random.default_rng(8)
    qry = []
    for s in reads[::5]:
        b = dna.encode(s)
        b[rng.integers(0, len(b), 2)] = rng.integers(1, 5, 2)
        qry.append(b)
    got = smem.smem_all(idx, qry)
    assert got == smem.smem_all_native(idx, qry)
    assert got == [[(s, e, 2 * n, c, 2 * kf) for s, e, n, c, kf in m]
                   for m in smem.smem_all(one, qry)]
    assert sum(map(len, got)) > len(qry)
    assert rank_cuda.LAUNCHES["rank_block_counts"] > \
        before["rank_block_counts"] + 1
    assert rank_cuda.LAUNCHES["rank6_fused"] == before["rank6_fused"]


def test_merge_part_peaks_never_reset(two_samples, tmp_path):
    """merge_files' part timer leaves torch's peak counter alone: each
    part reads the device's peak so far, so the readings never fall, and
    after the merge the process's peak is at least the largest of them
    (the whole merge's, which a benchmark run reads)."""
    from fermi_tpu_torch.algos import merge as mg

    _, ((_, f0, _), (_, f1, _)) = two_samples
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stderr(io.StringIO()):
        mg.merge_files([f0, f1], str(tmp_path / "m.fmd"),
                       torch.device("cuda"))
    peaks = mg.FILE_STATS["device_peak"]
    assert list(peaks) == ["restore", "gap_walk", "interleave", "download",
                           "rle", "dump"]
    assert list(peaks.values()) == sorted(peaks.values())
    assert torch.cuda.max_memory_allocated() >= max(peaks.values()) > 0


def test_build_append_routes_card(card, tmp_path, monkeypatch):
    """`build -i` on the card by both routes: with the free-byte figure
    below the card route's reckoned peak it streams (the block sorted on
    the card, no K1 launch), as is it takes the card route, whose gap walk
    launches rank_block_counts on the old index (FUSED_MAX lowered to its
    size: the layout past 2^32 - 128 symbols) beside rank6_fused on the
    new block.  The same bytes, those of `build` of all the reads."""
    from fermi_tpu_torch.algos import merge as mg
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.index import fmd as tfmd

    monkeypatch.setenv("FERMI_TPU_IDX_DTYPE", "int64")
    r0 = random_reads(300, seed=71, with_genome=True, genome_len=4000)
    r1 = random_reads(100, seed=72, with_genome=True, genome_len=4000)
    fa0, fa1, fa = (str(tmp_path / f"{n}.fa") for n in ("r0", "r1", "all"))
    write_fasta(fa0, r0)
    write_fasta(fa1, r1)
    write_fasta(fa, r0 + r1)
    old, want = str(tmp_path / "old.fmd"), str(tmp_path / "all.fmd")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(["build", "--device", "cpu", "-fo", old, fa0]) == 0
        assert main(["build", "--device", "cpu", "-fo", want, fa]) == 0
    monkeypatch.setattr(tfmd, "FUSED_MAX", mg.fmd_counts(old)[0])
    got = {}
    for route, free in (("stream", lambda dev: 0), ("card", mg.free_bytes)):
        monkeypatch.setattr(mg, "free_bytes", free)
        got[route] = str(tmp_path / f"{route}.fmd")
        before = dict(rank_cuda.LAUNCHES)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main(["build", "--device", "cuda", "-fo", got[route],
                         "-i", old, fa1]) == 0
        assert f"by the {route} route" in err.getvalue()
        assert mg.APPEND_STATS["route"] == route
        after = rank_cuda.LAUNCHES
        if route == "stream":
            assert after == before
        else:
            assert after["rank_block_counts"] > before["rank_block_counts"]
            assert after["rank6_fused"] > before["rank6_fused"]
    data = [open(p, "rb").read() for p in (got["stream"], got["card"], want)]
    assert data[0] == data[1] == data[2]


def test_blocked_past_fused_max_card(card, monkeypatch):
    """The blocked builder on the card with FUSED_MAX lowered below the
    text, so its last folds walk an accumulated index without fused rows
    (rank_block_counts) beside each block's fused int32 rows
    (rank6_fused), the shape of a build past 2^32 - 128 symbols: the
    CPU's bytes and prefix doubling's, both K1 entries launched."""
    from fermi_tpu_torch.construct import blocked, suffix, suffix_device
    from fermi_tpu_torch.index import fmd as tfmd

    reads = random_reads(300, seed=61, with_genome=True, genome_len=3000)
    text = suffix.build_text([dna.encode(r) for r in reads])
    blk = text.size // 8
    monkeypatch.setattr(tfmd, "_pick_idtype", lambda n: torch.int64
                        if n > blk else torch.int32)
    monkeypatch.setattr(tfmd, "FUSED_MAX", text.size * 3 // 4)
    got = {}
    for dev in ("cuda", "cpu"):
        before = dict(rank_cuda.LAUNCHES)
        got[dev] = blocked.device_build_text(text, block_symbols=blk,
                                             device=dev)
        assert blocked.STATS["blocks"] >= 8
        after = rank_cuda.LAUNCHES
        if dev == "cuda":
            assert after["rank_block_counts"] > before["rank_block_counts"]
            assert after["rank6_fused"] > before["rank6_fused"]
        else:
            assert after == before
    assert np.array_equal(got["cuda"], got["cpu"])
    assert np.array_equal(got["cpu"], suffix_device.multistring_bwt_device(
        text, "cpu"))


# A restore slice's temporaries (its bytes, their int64 words, a slice's
# runs of 16 symbols on average) stay under 4 bytes a slice symbol.
SLICE_BYTES_PER_SYMBOL = 4


def test_sliced_restore_footprint(card, tmp_path):
    """A synthetic .fmd of more than 2^30 symbols restored on the card a
    RESTORE_CHUNK at a time: the device peak above what was resident is
    at most the layout's bytes plus two slices' temporaries; blocks, occ,
    packed words and fused rows equal a numpy construction from the runs;
    rank6 at 300 positions equals a count over the host blocks."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.index import fmd as tfmd

    rng = np.random.default_rng(30)
    m = (1 << 30) // 16 + 12_345
    lens = rng.integers(1, 32, m).astype(np.int64)
    syms = (np.cumsum(rng.integers(1, 6, m)) % 6).astype(np.uint8)
    n = int(lens.sum())
    assert n >= 1 << 30 and n % 128
    mcnt = np.zeros(7, np.uint64)
    mcnt[0] = n
    mcnt[1:] = np.bincount(syms, weights=lens, minlength=6).astype(np.uint64)
    path = str(tmp_path / "syn.fmd")
    rld.write_fmd(rld.Runs(lens, syms, mcnt), path)
    runs = rld.read_fmd(path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    idx = tfmd.FMDIndex.from_runs(runs, card)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    arrays = (idx.bwt_blocks, idx.occ, idx.bwt_packed, idx.fused)
    layout = sum(a.numel() * a.element_size() for a in arrays)
    assert idx.fused is not None and idx.idtype == torch.int32
    assert peak <= layout + 2 * tfmd.RESTORE_CHUNK * SLICE_BYTES_PER_SYMBOL

    rows = -(-n // 128) + 1
    flat = np.full(rows * 128, 6, np.uint8)
    flat[:n] = np.repeat(syms, lens)
    blocks = flat.reshape(rows, 128)
    assert np.array_equal(idx.bwt_blocks.cpu().numpy(), blocks)
    occ = np.zeros((rows, 8), np.int64)
    for c in range(6):
        np.cumsum((blocks[:-1] == c).sum(1), out=occ[1:, c])
    assert np.array_equal(idx.occ.cpu().numpy(), occ)
    assert idx.mcnt.cpu().tolist() == [n, *occ[-1, :6].tolist(), 0]
    step = 1 << 20
    for a in range(0, rows, step):
        w = blocks[a: a + step].reshape(-1, 16, 8).astype(np.uint32)
        words = np.zeros(w.shape[:2], np.uint32)
        for s in range(8):
            words |= w[:, :, s] << (4 * s)
        got = idx.fused[a: a + step].cpu().numpy()
        assert np.array_equal(idx.bwt_packed[a: a + step].cpu().numpy(),
                              words.view(np.int32))
        assert np.array_equal(got[:, :16], words.view(np.int32))
        assert np.array_equal(got[:, 16:22], occ[a: a + step, :6])
    ks = np.sort(rng.integers(0, n + 1, 300))
    want = occ[ks >> 7, :6] + np.stack(
        [(blocks[k >> 7, : k & 127][None] == np.arange(6)[:, None]).sum(1)
         for k in ks])
    assert np.array_equal(idx.rank6(torch.from_numpy(ks).to(card)).cpu()
                          .numpy(), want)


def test_build_in_spans_card(card, tmp_path):
    """`build` on the card with a ballast tensor holding all but a third
    of the text's reckoned one-piece peak: the card's own free memory
    (merge.free_bytes) sends the build down the span route, its folds by
    `build -i`'s routes, and the bytes are the one-piece build's."""
    from fermi_tpu_torch.algos import merge as mg
    from fermi_tpu_torch.cli.main import main

    reads = random_reads(20_000, min_len=90, max_len=101, seed=81,
                         with_genome=True, genome_len=200_000)
    fa = str(tmp_path / "r.fa")
    write_fasta(fa, reads)
    one, spans = str(tmp_path / "one.fmd"), str(tmp_path / "spans.fmd")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(["build", "-fo", one, fa]) == 0
    assert "by the card route" in err.getvalue()
    torch.cuda.empty_cache()
    goal = mg.BUILD_STATS["need"] // 3
    ballast = torch.empty(mg.free_bytes(card) - goal, dtype=torch.uint8,
                          device=card)
    before = dict(rank_cuda.LAUNCHES)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(["build", "-fo", spans, fa]) == 0
    del ballast
    torch.cuda.empty_cache()
    st = mg.BUILD_STATS
    assert st["route"] == "spans" and len(st["spans"]) >= 3
    assert st["free"] < st["need"]
    assert f"in {len(st['spans'])} spans" in err.getvalue()
    assert err.getvalue().count("[M::build] append") == len(st["spans"]) - 1
    if any(f["route"] == "card" for f in st["folds"]):
        assert rank_cuda.LAUNCHES["rank6_fused"] > before["rank6_fused"]
    assert open(spans, "rb").read() == open(one, "rb").read()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["one.fmd", "r.fa", "spans.fmd"]


def test_spans_share_the_device_clock(card, tmp_path):
    """Under the profiler, a build_index of about 20 Msym: each sort of
    the doubling rounds runs inside its `bwt/round` span, the text's copy
    inside `bwt/upload` and the BWT's inside `bwt/download`, within 1 ms
    on the device records' clock.  The device builder and the run-length
    encoder synchronize only where the recorder allows it."""
    import inspect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fermi_tpu_torch import rld, spans
    from fermi_tpu_torch.construct import suffix_device
    from fermi_tpu_torch.pipeline import driver

    src = inspect.getsource(suffix_device).splitlines()
    at = [i for i, ln in enumerate(src) if "torch.cuda.synchronize" in ln]
    assert len(at) == 1
    after = [ln for ln in src[at[0] + 1:] if ln.strip()][:2]
    assert "bwt/download" in after[0] and ".cpu()" in after[1]
    assert "torch.cuda.synchronize" not in inspect.getsource(rld)

    reads = random_reads(100_000, min_len=100, max_len=101, seed=97)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    out = str(tmp_path / "o.fmd")
    p = driver.Pipeline(str(tmp_path / "x"), device=card)
    with contextlib.redirect_stderr(io.StringIO()):
        p.build_index(iter(()), out, paths=[fq])    # builds and warms up
        spans.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            p.build_index(iter(()), out, paths=[fq])
    assert driver.BUILD_STATS["symbols"] > 20_000_000
    recs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    rows = spans.rows()
    ms = 1_000_000

    def inside(rec, sp):
        return sp.start_ns - ms <= rec[1] and rec[2] <= sp.end_ns + ms

    rounds = [r for r in rows if r.name == "bwt/round"]
    sorts = [r for r in recs if "RadixSort" in r[0]]
    assert len(rounds) >= 5 and sorts
    def overlap(rec, sp):
        return min(rec[2], sp.end_ns) - max(rec[1], sp.start_ns)

    owners = set()
    for rec in sorts:
        own = max(rounds, key=lambda r: overlap(rec, r))
        assert inside(rec, own), (rec, own)
        owners.add(own.index)
    assert owners == {r.index for r in rounds}
    for name, kind in (("bwt/upload", "HtoD"), ("bwt/download", "DtoH")):
        sp, = [r for r in rows if r.name == name]
        big = max((r for r in recs if kind in r[0]),
                  key=lambda r: r[2] - r[1])
        assert inside(big, sp), (name, big, sp)
