"""The port's device BWT builders (fermi_tpu_torch.construct.wsort,
blocked, bcr_device) against fermi_tpu on the CPU: the same BWT as the
host SA rule (fermi_tpu's construct.suffix) and as fermi_tpu's wsort_bwt,
device_build_text and bcr_bwt_device, on the cases of
tests/test_build_device.py and reads straddling wsort's window boundaries.
Bytes: tolerance zero."""

import numpy as np
import pytest
import torch

from fermi_tpu.construct import suffix
from fermi_tpu.construct.bcr_jax import bcr_bwt_device as j_bcr
from fermi_tpu.construct.blocked import device_build_text as j_blocked
from fermi_tpu.construct.wsort import wsort_bwt as j_wsort
from fermi_tpu.core import dna
from fermi_tpu_torch.construct import bcr_device, blocked, wsort

from native_lock import load_fermi_tpu_native
from util import random_reads, write_fasta

torch.set_num_threads(1)
load_fermi_tpu_native()


def _cases():
    """tests/test_build_device.py's eight cases, then 20 reads each of 9,
    10, 11, 19, 20 and 21 bp (one short of, at and one past one and two
    10-symbol windows)."""
    rng = np.random.default_rng(11)
    cases = [["A"], ["AT", "CG"], ["ACGTACGT", "ACGTACGT", "TTTT"],
             ["ACGT" * 10] * 5, ["ANNGT", "CCNCC"]]
    for seed in (0, 1):
        cases.append(random_reads(60, seed=seed, with_genome=(seed == 0),
                                  genome_len=1200))
    cases.append(["".join(rng.choice(list("ACGT"),
                                     size=rng.integers(1, 90)))
                  for _ in range(40)])
    for L in (9, 10, 11, 19, 20, 21):
        cases.append(["".join(np.random.default_rng(L).choice(list("ACGT"),
                                                              size=L))
                      for _ in range(20)])
    return cases


CASES = _cases()


def _seqs(case):
    return [dna.encode(s) for s in CASES[case]]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_wsort(case):
    text = suffix.build_text(_seqs(case))
    got = wsort.wsort_bwt(text, device="cpu")
    assert np.array_equal(got, suffix.multistring_bwt(text))
    assert np.array_equal(got, j_wsort(text))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_bcr_device(case):
    seqs = _seqs(case)
    want = suffix.multistring_bwt(
        suffix.build_text(seqs, both_strands=False, trim_palindrome=False))
    got = bcr_device.bcr_bwt_device(seqs, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, j_bcr(seqs))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_blocked_cases(case):
    """Each case with blocks of about a third of its text (one block for
    the smallest)."""
    text = suffix.build_text(_seqs(case))
    blk = max(text.size // 3, 1)
    got = blocked.device_build_text(text, block_symbols=blk, device="cpu")
    assert np.array_equal(got, suffix.multistring_bwt(text))
    assert np.array_equal(got, j_blocked(text, block_symbols=blk))


@pytest.fixture(scope="module")
def genome_text():
    reads = random_reads(80, seed=7, with_genome=True, genome_len=1500)
    text = suffix.build_text([dna.encode(s) for s in reads])
    return text, suffix.multistring_bwt(text)


@pytest.mark.parametrize("blk", [1 << 30, 4000, 700])
def test_blocked_block_sizes(genome_text, blk):
    """One, two and many blocks (test_build_device.py:161-178)."""
    text, want = genome_text
    got = blocked.device_build_text(text, block_symbols=blk, device="cpu")
    assert blocked.STATS["blocks"] == len(blocked._block_slices(
        np.diff(np.flatnonzero(text == 0), prepend=-1) - 1, blk))
    assert (blocked.STATS["blocks"] == 1) == (blk == 1 << 30)
    assert np.array_equal(got, want)
    assert np.array_equal(got, j_blocked(text, block_symbols=blk))


def test_blocked_sliced_restore(genome_text, monkeypatch):
    """Each fold's indexes built a few blocks at a time (RESTORE_CHUNK
    lowered): the same folds and bytes."""
    from fermi_tpu_torch.index import fmd as tfmd

    text, want = genome_text
    monkeypatch.setattr(tfmd, "RESTORE_CHUNK", 256)
    got = blocked.device_build_text(text, block_symbols=4000, device="cpu")
    assert blocked.STATS["blocks"] > 2 and text.size > 8 * 256
    assert np.array_equal(got, want)


@pytest.mark.parametrize("share", [0.3, 0.75])
def test_blocked_past_fused_max(genome_text, monkeypatch, share):
    """A build that crosses FUSED_MAX part way (lowered to `share` of the
    text; the accumulated index int64 past one block, each block int32):
    the folds before it walk an accumulated index with fused rows, those
    after it one without, beside each block's fused rows, as a read set
    past 2^32 - 128 symbols builds; fermi_tpu's bytes and the host SA
    rule's."""
    from fermi_tpu_torch.algos import merge as tmerge
    from fermi_tpu_torch.index import fmd as tfmd

    text, want = genome_text
    blk = 700
    monkeypatch.setattr(tfmd, "_pick_idtype", lambda n: torch.int64
                        if n > blk else torch.int32)
    monkeypatch.setattr(tfmd, "FUSED_MAX", int(text.size * share))
    seen = []
    orig = tmerge.compute_gap_bits

    def spy(e0, e1, **kw):
        seen.append((e0.total, e0.fused is not None, e1.fused is not None,
                     e1.idtype))
        return orig(e0, e1, **kw)
    monkeypatch.setattr(tmerge, "compute_gap_bits", spy)
    got = blocked.device_build_text(text, block_symbols=blk, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, j_blocked(text, block_symbols=blk))
    assert len(seen) == blocked.STATS["blocks"] - 1
    fused = [f for _, f, _, _ in seen]
    assert True in fused and False in fused
    assert fused == [t < tfmd.FUSED_MAX for t, _, _, _ in seen]
    assert all(f1 and dt == torch.int32 for _, _, f1, dt in seen)


def test_blocked_read_list(genome_text):
    """device_build_bwt takes the strands as a list; an empty read
    raises."""
    text, want = genome_text
    ends = np.flatnonzero(text == 0)
    starts = np.concatenate([[0], ends[:-1] + 1])
    strands = [text[s:e] for s, e in zip(starts, ends)]
    assert np.array_equal(
        blocked.device_build_bwt(strands, block_symbols=2500, device="cpu"),
        want)
    with pytest.raises(ValueError, match="empty"):
        blocked.device_build_bwt(strands[:3] + [strands[0][:0]],
                                 device="cpu")


def test_block_slices():
    """Greedy partition in read order; an oversized read gets its own
    block (the loop of fermi_tpu's _block_slices)."""
    from fermi_tpu.construct.blocked import _block_slices as j_slices

    rng = np.random.default_rng(3)
    for blk in (1, 5, 50, 101, 1000):
        lens = rng.integers(1, 120, 300)
        assert blocked._block_slices(lens, blk) == j_slices(lens, blk)


def test_build_over_max_text(tmp_path, monkeypatch):
    """`build` of a text at or over prefix doubling's limit (patched low)
    goes through the blocked builder and gives the host build's bytes."""
    import contextlib
    import io

    from fermi_tpu.cli.main import main as jmain
    from fermi_tpu_torch.cli.main import main as tmain
    from fermi_tpu_torch.construct import suffix_device

    reads = random_reads(150, seed=12, with_genome=True, genome_len=3000)
    fa = str(tmp_path / "r.fa")
    write_fasta(fa, reads)
    monkeypatch.setattr(suffix_device, "MAX_TEXT", 2000)
    calls = []
    orig = blocked.device_build_text

    def small_blocks(text, device=None):
        calls.append(text.size)
        return orig(text, block_symbols=5000, device=device)
    monkeypatch.setattr(blocked, "device_build_text", small_blocks)
    jfmd, tfmd = str(tmp_path / "j.fmd"), str(tmp_path / "t.fmd")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jmain(["build", "-fo", jfmd, fa]) == 0
        assert tmain(["build", "--device", "cpu", "-fo", tfmd, fa]) == 0
    assert calls and calls[0] > 2000 and blocked.STATS["blocks"] > 3
    assert open(tfmd, "rb").read() == open(jfmd, "rb").read()
    with pytest.raises(NotImplementedError, match="blocked"):
        suffix_device.multistring_bwt_device(np.zeros(2000, np.uint8), "cpu")
