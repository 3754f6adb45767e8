"""The out-of-core `-M` path of the port (index/mmapfmd.MmapIndex,
index/blkidx, the native engines over the mapped .fmd.blk record cache, the
threaded unitig walk, algos/merge.fm_append_streaming and the CLI's `-M`)
against fermi_tpu on the CPU.  Every output is bytes or integers: tolerance
zero.  Fixtures follow tests/test_mmap.py and tests/test_blkidx.py."""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fermi_tpu import rld as jrld
from fermi_tpu.algos import correct as jec
from fermi_tpu.algos import merge as jmerge
from fermi_tpu.algos import seqsort as jss
from fermi_tpu.algos import unitig as jut
from fermi_tpu.cli.main import main as jmain
from fermi_tpu.construct import suffix as jsuffix
from fermi_tpu.core import dna as jdna
from fermi_tpu.index import blkidx as jblk
from fermi_tpu.index.mmapfmd import MmapIndex as JMmap
from fermi_tpu.search import smem as jsm
from fermi_tpu_torch import native
from fermi_tpu_torch import rld
from fermi_tpu_torch.algos import correct as tec
from fermi_tpu_torch.algos import mag
from fermi_tpu_torch.algos import merge as tmerge
from fermi_tpu_torch.algos import seqsort as tss
from fermi_tpu_torch.algos import unitig as tut
from fermi_tpu_torch.cli.main import main as tmain
from fermi_tpu_torch.construct import suffix
from fermi_tpu_torch.core import dna
from fermi_tpu_torch.index import blkidx as tblk
from fermi_tpu_torch.index.fmd import FMDIndex
from fermi_tpu_torch.index.mmapfmd import MmapIndex
from fermi_tpu_torch.search import smem as tsm

from native_lock import load_fermi_tpu_native
from util import build_my_fmd, random_reads, write_fasta, write_fastq

torch.set_num_threads(1)
load_fermi_tpu_native()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _copies(src, d):
    """The same .fmd in a directory for each package, so each builds its
    own .fmd.blk beside it."""
    out = []
    for who in ("j", "t"):
        os.makedirs(os.path.join(d, who), exist_ok=True)
        dst = os.path.join(d, who, os.path.basename(src))
        shutil.copy(src, dst)
        out.append(dst)
    return out


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """Genome reads (containment, duplicates) as the index; 40 of them as
    FASTQ queries; the unitigs of the index as remap's contigs."""
    d = str(tmp_path_factory.mktemp("ooc"))
    reads = random_reads(500, seed=5, with_genome=True, genome_len=5000,
                         min_len=60, max_len=100)
    reads += reads[:12] + [r[5:55] for r in reads[12:20]]
    fmd = os.path.join(d, "i.fmd")
    build_my_fmd(reads, fmd)
    jfmd, tfmd = _copies(fmd, d)
    fq = os.path.join(d, "q.fq")
    write_fastq(fq, reads[:40])
    rank = os.path.join(d, "i.rank")
    want = jss.seqsort_native(jblk.ensure_blk(jfmd), verbose=False)
    want.tofile(rank)
    contigs = os.path.join(d, "p0.mag")
    with open(contigs, "w") as f:
        f.write(jut.fm6_unitig_native(jblk.ensure_blk(jfmd), 40, want))
    return dict(d=d, reads=reads, jfmd=jfmd, tfmd=tfmd, fq=fq, rank=rank,
                sorted=want, contigs=contigs,
                bwt=rld.read_fmd(tfmd).expand())


@pytest.fixture(scope="module")
def long_runs(tmp_path_factory):
    """Runs long enough that a block's symbol counts pass 0x8000: the
    32-bit block headers of the RLD format (tests/test_mmap.py)."""
    d = str(tmp_path_factory.mktemp("long"))
    lens = [50000, 1, 70000, 2, 100000, 1, 40000]
    syms = [1, 0, 2, 3, 4, 0, 1]
    bwt = np.repeat(np.array(syms, np.uint8), np.array(lens, np.int64))
    path = os.path.join(d, "long.fmd")
    rld.write_fmd(rld.Runs.from_bwt(bwt), path)
    jfmd, tfmd = _copies(path, d)
    return dict(jfmd=jfmd, tfmd=tfmd, bwt=bwt)


def _dense_rank6(bwt, ks):
    occ = np.zeros((bwt.size + 1, 6), np.int64)
    np.cumsum(bwt[:, None] == np.arange(6, dtype=np.uint8), axis=0,
              out=occ[1:])
    return occ[ks]


@pytest.mark.parametrize("which", ["fx", "long_runs"])
def test_mmap_rank6_every_position(request, which):
    """rank6 at every position 0..n: fermi_tpu's MmapIndex, the port's
    MmapIndex, the port's FMDIndex and a running count agree, on 16-bit
    and 32-bit block headers."""
    f = request.getfixturevalue(which)
    m, jm = MmapIndex(f["tfmd"]), JMmap(f["jfmd"])
    n = f["bwt"].size
    assert m.total == jm.total == n and m.n_seqs == jm.n_seqs
    assert np.array_equal(m.cnt, jm.cnt) and np.array_equal(m.mcnt, jm.mcnt)
    ks = np.arange(n + 1, dtype=np.int64)
    got = m.rank6(ks)
    assert np.array_equal(got, jm.rank6(ks))
    assert np.array_equal(got, _dense_rank6(f["bwt"], ks))
    idx = FMDIndex.restore(f["tfmd"], "cpu")
    assert np.array_equal(got, idx.rank6(torch.from_numpy(ks)).numpy())
    m.close()
    m.close()                                  # a second close is a no-op
    jm.close()


def test_mmap_extend_search_retrieve(fx):
    m, jm = MmapIndex(fx["tfmd"]), JMmap(fx["jfmd"])
    idx = FMDIndex.restore(fx["tfmd"], "cpu")
    rng = np.random.default_rng(2)
    n = m.total
    kb = rng.integers(0, n // 2, 200)
    kf = rng.integers(0, n // 2, 200)
    sz = rng.integers(0, n // 2, 200)
    for is_back in (True, False):
        got = m.extend6(kb, kf, sz, is_back)
        want = jm.extend6(kb, kf, sz, is_back)
        dev = idx.extend6(*(torch.from_numpy(a) for a in (kb, kf, sz)),
                          is_back)
        for a, b, c in zip(got, want, dev):
            assert np.array_equal(a, b) and np.array_equal(a, c.numpy())
    pats = [dna.encode(r) for r in fx["reads"][:30]] + \
        [dna.encode("ACGTTTTTGGGGCCCCAAAAT" * 3)]
    got = m.backward_search(pats)
    assert got == jm.backward_search(pats)
    assert all(s >= 1 for _, s in got[:30]) and got[-1][1] == 0
    ids = np.arange(0, m.n_seqs, 7)
    seqs, ranks = m.retrieve(ids, return_ranks=True)
    jseqs, jranks = jm.retrieve(ids, return_ranks=True)
    assert np.array_equal(ranks, jranks)
    assert all(np.array_equal(a, b) for a, b in zip(seqs, jseqs))
    reads = fx["reads"]
    for x, s in zip(ids.tolist(), seqs):
        r = reads[x // 2] if x % 2 == 0 else \
            dna.decode(dna.revcomp(dna.encode(reads[x // 2])))
        assert dna.decode(s) == r


def test_mmap_open_fails_on_a_non_index(tmp_path):
    bad = tmp_path / "x.fmd"
    bad.write_bytes(b"RLE\0" + bytes(100))
    with pytest.raises(OSError, match="cannot mmap-open"):
        MmapIndex(str(bad))
    with pytest.raises(OSError, match="not a .fmd.blk"):
        tblk.BlkIndex(str(bad))


def test_positions_and_rank_arrays_are_checked(fx):
    """Inputs the native code would read past are refused in Python."""
    m = MmapIndex(fx["tfmd"])
    with pytest.raises(ValueError, match="outside"):
        m.rank6([0, m.total + 1])
    with pytest.raises(ValueError, match="outside"):
        m.rank6([-1])
    blk = tblk.ensure_blk(fx["tfmd"])
    with pytest.raises(ValueError, match=".rank array"):
        tut.fm6_unitig_native(blk, 40, fx["sorted"][:-2])


@pytest.mark.parametrize("which", ["fx", "long_runs"])
def test_blk_bytes_equal_fermi_tpu(request, which):
    """The port's .fmd.blk is fermi_tpu's, byte for byte, and its header
    describes the index."""
    f = request.getfixturevalue(which)
    t, j = tblk.ensure_blk(f["tfmd"]), jblk.ensure_blk(f["jfmd"])
    assert t.path == f["tfmd"] + ".blk"
    assert open(t.path, "rb").read() == open(j.path, "rb").read()
    n = f["bwt"].size
    assert (t.total, t.n_rows, t.n_seqs, t.wide) == \
        (n, (n + 127) // 128 + 1, j.n_seqs, False)
    assert np.array_equal(t.cnt, j.cnt)


def test_ensure_blk_rebuilds_a_stale_cache(fx, tmp_path):
    """A cache older than its .fmd is rebuilt; a fresh one is kept."""
    fmd = str(tmp_path / "a.fmd")
    shutil.copy(fx["tfmd"], fmd)
    tblk.ensure_blk(fmd)
    blk = fmd + ".blk"
    before = open(blk, "rb").read()
    os.utime(blk, (1, 1))                      # older than the .fmd
    build_my_fmd(fx["reads"][:100], fmd)
    b = tblk.ensure_blk(fmd)
    assert b.total == rld.read_fmd(fmd).total
    assert open(blk, "rb").read() != before
    mtime = os.path.getmtime(blk)
    tblk.ensure_blk(fmd)
    assert os.path.getmtime(blk) == mtime


def _wide_copy(narrow_path, wide_path):
    """The records of a narrow cache rewritten in the wide layout (u64 occ,
    stride 256), which fermi_tpu's builder writes only past 2^32 symbols:
    it puts the engines' wide reading path under test at a small size."""
    raw = np.fromfile(narrow_path, np.uint8)
    hdr = raw[:4096].copy()
    rows = raw[4096:].reshape(-1, 192)
    wide = np.zeros((rows.shape[0], 256), np.uint8)
    wide[:, :128] = rows[:, :128]
    occ = rows[:, 128:152].copy().view(np.uint32).astype(np.uint64)
    wide[:, 128:176] = occ.view(np.uint8).reshape(-1, 48)
    wide[:, 176:194] = rows[:, 152:170]
    h = hdr[:8 + 8 * 13].view(np.int64)      # magic, rstride, ..., wide
    h[1] = 256
    h[13] = 1
    with open(wide_path, "wb") as f:
        f.write(hdr.tobytes())
        f.write(wide.tobytes())
    return tblk.BlkIndex(wide_path)


def _triples(r):
    return sorted(zip(r[0].tolist(), r[1].tolist(), r[2].tolist()))


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_engines_on_blk_equal_fermi_tpu(fx, tmp_path, layout):
    """fsmem_all_blk, fec_collect_blk, fseqsort_blk and funitig_run_blk
    (-t 1, with and without a .rank) equal fermi_tpu's engines on the same
    cache, and the port's in-RAM engines on the index's host arrays."""
    j = jblk.ensure_blk(fx["jfmd"])
    t = tblk.ensure_blk(fx["tfmd"])
    if layout == "wide":
        t = _wide_copy(t.path, str(tmp_path / "w.blk"))
        assert t.wide
    idx = FMDIndex.restore(fx["tfmd"], "cpu")
    qs = [dna.encode(r) for r in fx["reads"][:60]]
    for self_match in (False, True):
        want = jsm.smem_all_native(j, qs, self_match=self_match)
        assert tsm.smem_all_native(t, qs, self_match) == want
        assert tsm.smem_all(t, qs, self_match) == want
        assert tsm.smem_all_native(idx, qs, self_match) == want
    want = jec.collect_solid_kmers_native(j, 17, 3)
    for got in (tec.collect_solid_kmers_native(t, 17, 3, 2),
                tec.collect_solid_kmers_native(idx, 17, 3, 1)):
        assert got[3] == want[3] and _triples(got) == _triples(want)
    assert np.array_equal(tss.seqsort_native(t, 3, False), fx["sorted"])
    assert np.array_equal(tss.seqsort_native(idx, 1, False), fx["sorted"])
    for srt in (None, fx["sorted"]):
        want = jut.fm6_unitig_native(j, 40, srt)
        assert want.count("\n+\n") > 3
        assert tut.fm6_unitig_native(t, 40, srt) == want
        assert tut.fm6_unitig_native(idx, 40, srt, 1) == want


def test_collect_native_equals_device_collect(fx):
    """The native collect over the mapped cache gives the set and counts of
    the port's device collect (its plain version here), at another k and
    min_occ.  (Its level walk, taken from 48 Msym up, runs in the chip
    smoke's `correct -M` of a 281 Msym index.)"""
    idx = FMDIndex.restore(fx["tfmd"], "cpu")
    want = tec.collect_solid_kmers(idx, 19, 2)
    got = tec.collect_solid_kmers_native(tblk.ensure_blk(fx["tfmd"]), 19, 2)
    assert got[3] == want[3] and _triples(got) == _triples(want)


def _mass_and_ids(text, path):
    with open(path, "w") as f:
        f.write(text)
    g = mag.mag_read(path, dict(mag.DEFAULT_OPT))
    return sum(v.len for v in g.v), [k for v in g.v for k in v.k]


@pytest.mark.parametrize("srt", [False, True])
def test_unitig_threaded_contract(fx, tmp_path, srt):
    """`-t 3` over the mapped cache holds fermi_tpu's threaded contract
    (tests/test_unitig.py:100-130): unique read ids at the unitig ends, and
    the assembled mass within 2% of `-t 1`'s."""
    t = tblk.ensure_blk(fx["tfmd"])
    s = fx["sorted"] if srt else None
    one = tut.fm6_unitig_native(t, 40, s, 1)
    three = tut.fm6_unitig_native(t, 40, s, 3)
    m1, _ = _mass_and_ids(one, str(tmp_path / "1.mag"))
    m3, ids = _mass_and_ids(three, str(tmp_path / "3.mag"))
    assert len(ids) == len(set(ids))
    assert abs(m3 - m1) <= 0.02 * m1


def _cli(main, argv):
    """(exit code, stdout bytes, the command's messages on stderr) of one
    CLI call; stdout has a binary buffer (seqsort writes to it)."""
    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="latin1", newline="")
    err = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        with contextlib.redirect_stderr(err):
            rc = main(argv)
        out.flush()
    finally:
        sys.stdout = old
    return rc, raw.getvalue(), [ln for ln in err.getvalue().splitlines()
                                if ln.startswith(("[M::chkbwt]",
                                                  "[E::chkbwt]"))]


# each -M command, its arguments after the index (fermi_tpu's CLI -M)
_M_CMDS = {
    "unpack": lambda f: (["-i", "0", "-i", "7", "-i", "201", "-i", "99999"],
                         []),
    "unpack_all": lambda f: ([], []),
    "exact": lambda f: ([], [f["fq"]]),
    "exact_self": lambda f: (["-s"], [f["fq"]]),
    "seqsort": lambda f: (["-t", "3"], []),
    "seqrank": lambda f: ([], []),
    "unitig": lambda f: (["-l", "40"], []),
    "unitig_rank": lambda f: (["-l", "40", "-r", f["rank"]], []),
    "correct": lambda f: (["-t", "2", "-k", "17"], [f["fq"]]),
    "remap": lambda f: (["-r", f["rank"]], [f["contigs"]]),
    "remap_break": lambda f: (["-r", f["rank"], "-c", "2", "-D", "400"],
                              [f["contigs"]]),
    "chkbwt_rp": lambda f: (["-r", "-p"], []),
}


@pytest.mark.parametrize("name", list(_M_CMDS))
def test_cli_dash_M_equals_fermi_tpu(fx, name):
    """Each command with -M prints fermi_tpu's `-M` bytes (and chkbwt its
    messages), and the port's own card path (`--device cpu`) agrees."""
    cmd = name.split("_")[0]
    pre, post = _M_CMDS[name](fx)
    want = _cli(jmain, [cmd, "-M", *pre, fx["jfmd"], *post])
    got = _cli(tmain, [cmd, "-M", *pre, fx["tfmd"], *post])
    assert want[0] == 0 and len(want[1]) > 100
    assert got == want
    dv = [] if cmd == "remap" else ["--device", "cpu"]
    assert _cli(tmain, [cmd, *dv, *pre, fx["tfmd"], *post])[1] == got[1]


def _corrupt(fmd, path, same_length):
    """A copy of fmd with one byte of its run data changed so that the
    decoded BWT differs, its length kept or not (the header's counts stay);
    tests/test_torch_cli.py's recipe."""
    raw = open(fmd, "rb").read()
    want = rld.read_fmd(fmd).expand()
    for at in range(len(raw) // 2, len(raw)):
        b = bytearray(raw)
        b[at] ^= 0x10
        with open(path, "wb") as f:
            f.write(b)
        got = rld.read_fmd(path).expand()
        if (got.size == want.size) == same_length and \
                not np.array_equal(got, want):
            return path
    raise AssertionError("no byte of the runs changes the BWT")


@pytest.fixture(scope="module")
def cli_fmd(tmp_path_factory):
    """tests/test_torch_cli.py's index (reads of a 3 kbp genome, a
    palindrome, N bases), built by the port."""
    d = tmp_path_factory.mktemp("chk")
    reads = random_reads(120, seed=21, with_genome=True, genome_len=3000)
    fa = str(d / "reads.fa")
    write_fasta(fa, reads + ["ACGTACGT", "NNACGTNN"])
    fmd = str(d / "t.fmd")
    assert tmain(["build", "--device", "cpu", "-fo", fmd, fa]) == 0
    return fmd


@pytest.mark.parametrize("same_length", [True, False])
@pytest.mark.parametrize("flags", [[], ["-r"], ["-p"], ["-r", "-p"]])
def test_cli_chkbwt_dash_M_corrupted(cli_fmd, tmp_path, flags, same_length):
    """chkbwt -M on tests/test_torch_cli.py's corrupted copies.  The copy
    whose BWT keeps its length fails the rank check (an occ row of the
    record cache disagrees), with fermi_tpu's exit code, stdout and
    messages.  The copy whose runs hold one symbol more than the header
    gets no record cache in the port, which exits 1 with every flag, as
    `chkbwt -r` without -M does; fermi_tpu caches the header's first n
    symbols and passes (fault F4, repaired in the port only)."""
    paths = []
    for who in ("j", "t"):
        os.makedirs(tmp_path / who)
        paths.append(_corrupt(cli_fmd, str(tmp_path / who / "bad.fmd"),
                              same_length))
    want = _cli(jmain, ["chkbwt", "-M", *flags, paths[0]])
    got = _cli(tmain, ["chkbwt", "-M", *flags, paths[1]])
    if same_length:
        assert got == want
        assert got[0] == (1 if "-r" in flags else 0)
    else:
        assert want[0] == 0 and got[0] == 1
        assert got[2][0] == want[2][0] and "[E::chkbwt]" in got[2][-1]
        assert not os.path.exists(paths[1] + ".blk")
    assert ("-p" in flags and got[0] == 0) == bool(got[1])
    if "-r" in flags:
        assert _cli(tmain, ["chkbwt", "--device", "cpu", "-r",
                            paths[1]])[0] == 1


def test_cli_unitig_dash_M_threads(fx, tmp_path):
    """unitig -M -t 3 holds the threaded contract through the CLI; -t 1
    equals fermi_tpu's `unitig -M` and the card path's bytes."""
    rc, one, _ = _cli(tmain, ["unitig", "-M", "-l", "40", fx["tfmd"]])
    assert rc == 0
    assert one == _cli(jmain, ["unitig", "-M", "-l", "40", fx["jfmd"]])[1]
    assert one == _cli(tmain, ["unitig", "--device", "cpu", "-l", "40",
                               fx["tfmd"]])[1]
    rc, three, _ = _cli(tmain, ["unitig", "-M", "-t", "3", "-l", "40",
                                fx["tfmd"]])
    assert rc == 0
    m1, _ = _mass_and_ids(one.decode(), str(tmp_path / "1.mag"))
    m3, ids = _mass_and_ids(three.decode(), str(tmp_path / "3.mag"))
    assert len(ids) == len(set(ids)) and abs(m3 - m1) <= 0.02 * m1


@pytest.mark.parametrize("cmd", ["unpack", "exact", "chkbwt", "correct",
                                 "seqsort", "seqrank", "unitig"])
def test_cli_dash_M_refuses_device(fx, cmd, capsys):
    """-M runs on the host: with --device as well the command exits 1
    naming the conflict and prints nothing."""
    post = [fx["fq"]] if cmd in ("exact", "correct") else []
    assert tmain([cmd, "-M", "--device", "cpu", fx["tfmd"], *post]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert f"[E::{cmd}] -M runs out of core on the host" in out.err
    assert "--device cpu" in out.err


def test_fm_append_streaming_equals_fermi_tpu_and_build_i(fx, tmp_path):
    """fm_append_streaming (the old index never expanded: ranks off its
    .fmd.blk, runs streamed into the encoder) writes fermi_tpu's bytes and
    `build -i --device cpu`'s, which equal `build` of all the reads."""
    reads = fx["reads"]
    old_reads, new_reads = reads[:300], reads[300:]
    old = str(tmp_path / "old.fmd")
    build_my_fmd(old_reads, old)
    jold, told = _copies(old, str(tmp_path))
    new_fa = str(tmp_path / "new.fa")
    write_fasta(new_fa, new_reads)
    text = suffix.build_text([dna.encode(r) for r in new_reads])
    jtext = jsuffix.build_text([jdna.encode(r) for r in new_reads])
    assert np.array_equal(text, jtext)
    outs = [str(tmp_path / f"{n}.fmd") for n in ("j", "t", "cli", "all")]
    jmerge.fm_append_streaming(jold, jtext, outs[0], n_threads=2)
    tmerge.fm_append_streaming(told, text, outs[1], n_threads=3,
                               device="cpu")
    assert tmain(["build", "--device", "cpu", "-fo", outs[2], "-i", told,
                  new_fa]) == 0
    build_my_fmd(reads, outs[3])
    data = [open(p, "rb").read() for p in outs]
    assert data[0] == data[1] == data[2] == data[3]
    assert os.path.exists(told + ".blk")       # ranks came off the cache


def test_fm_append_streaming_needs_a_device_or_cuda(fx, tmp_path,
                                                    monkeypatch):
    """The new block's BWT is sorted on the device the caller names: with
    none named and no CUDA it raises, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.fmd"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmerge.fm_append_streaming(fx["tfmd"], np.array([1, 2, 0], np.uint8),
                                   str(out))
    assert not out.exists()


_CAPPED = """
import resource, sys
from fermi_tpu_torch import native
from fermi_tpu_torch.cli.main import main
native.get_lib(); native.get_smem_lib()
vm = 0
for line in open("/proc/self/status"):
    if line.startswith("VmData"):
        vm = int(line.split()[1]) << 10
cap = vm + (100 << 20)
resource.setrlimit(resource.RLIMIT_DATA, (cap, cap))
flags = ["-M"] if sys.argv[1] == "M" else ["--device", "cpu"]
sys.exit(main(["exact", *flags, sys.argv[2], sys.argv[3]]))
"""


def test_dash_M_runs_under_a_memory_cap_the_dense_path_exceeds(tmp_path):
    """The `-M` memory model (tests/test_blkidx.py:188 at a tier-1 size): a
    63 Msym index, stream-encoded and never held in RAM, is searched by
    `exact -M` under an anonymous-memory cap (RLIMIT_DATA) of 100 MB over
    the interpreter's own: the records are a read-only file mapping.  The
    dense path (`exact --device cpu`, which decodes the runs and builds the
    index in RAM) fails under the same cap."""
    lib = native.get_lib()
    h = lib.frld_enc_open(6, 3)
    assert h
    rng = np.random.default_rng(7)
    total = 0
    while total < 60_000_000:
        n = 1 << 20
        lens = rng.geometric(0.25, n).astype(np.int64)
        syms = rng.integers(0, 6, n).astype(np.uint8)
        assert lib.frld_enc_put(h, lens.ctypes.data, syms.ctypes.data,
                                n) == 0
        total += int(lens.sum())
    path = str(tmp_path / "big.fmd")
    assert lib.frld_enc_finish(h, path.encode()) == 0
    assert tblk.ensure_blk(path).total == total
    qfa = str(tmp_path / "q.fa")
    write_fasta(qfa, ["".join("ACGT"[c] for c in
                              np.random.default_rng(3).integers(0, 4, 24))
                      for _ in range(64)])
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = [sys.executable, "-c", _CAPPED]
    ok = subprocess.run([*run, "M", path, qfa], capture_output=True,
                        text=True, env=env)
    assert ok.returncode == 0, ok.stderr[-800:]
    assert ok.stdout.count("SQ\t") == 64 and ok.stdout.count("EM\t") >= 64
    dense = subprocess.run([*run, "dense", path, qfa], capture_output=True,
                           text=True, env=env)
    assert dense.returncode != 0 and dense.stdout == ""
    assert "failed: -9" in dense.stderr          # out of memory, reported


def _streamed_digest(path, chunk=1 << 24):
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest(), os.path.getsize(path)


@pytest.mark.slow
def test_wide_blk_writer_equals_fermi_tpu(tmp_path):
    """The wide `.fmd.blk` layout (256 B records, taken past 2^32 symbols)
    of the port's fmblk_build against fermi_tpu's writer, on a synthetic
    .fmd of just over 2^32 symbols made of random runs (many short, many
    thousands of symbols long) from a seed: each cache (about 8.6 GB) is
    hashed as it streams and deleted before the next is built.  The .fmd
    bytes of both packages' encoders are compared too."""
    rng = np.random.default_rng(2026)
    total = 2**32 + 1000
    n = 8_000_000
    lengths = np.where(rng.random(n) < 0.5, rng.integers(1, 64, n),
                       rng.integers(64, 2600, n))
    cut = int(np.searchsorted(np.cumsum(lengths), total))
    lengths = lengths[: cut + 1]
    lengths[-1] -= int(lengths.sum()) - total
    assert lengths[-1] > 0 and int(lengths.sum()) == total
    step = rng.integers(1, 6, len(lengths))
    symbols = (np.cumsum(step) % 6).astype(np.uint8)
    mcnt = np.zeros(7, np.uint64)
    mcnt[0] = total
    mcnt[1:] = np.bincount(symbols, weights=lengths, minlength=6)
    runs = rld.Runs(lengths.astype(np.int64), symbols, mcnt)
    fmd = str(tmp_path / "wide.fmd")
    rld.write_fmd(runs, fmd)
    jfmd = str(tmp_path / "jwide.fmd")
    jrld.write_fmd(jrld.Runs(runs.lengths, runs.symbols, mcnt), jfmd)
    assert open(fmd, "rb").read() == open(jfmd, "rb").read()
    assert os.path.getsize(fmd) < 64 << 20
    digests = []
    for ensure in (jblk.ensure_blk, tblk.ensure_blk):
        blk = ensure(fmd, str(tmp_path / "c.blk"), n_threads=4)
        assert blk.wide and blk.total == total
        assert blk.n_rows == -(-total // 128) + 1
        digests.append(_streamed_digest(blk.path))
        os.remove(blk.path)
    assert digests[0] == digests[1]
    assert digests[1][1] >= 256 * (total // 128)
