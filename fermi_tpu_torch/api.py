"""Embedding API of the port: the index-level primitives of fermi_tpu/api.py.

    from fermi_tpu_torch import api
    idx = api.build_index(["ACGT...", ...])         # FMD-index of reads+rc
    api.save_index(seqs, "out.fmd")                 # byte-exact .fmd
    idx = api.load_index("out.fmd")
    for (start, end, size, closed, kf) in api.smem(idx, "ACGT..."):
        ...
    seqs, quals = api.correct(["ACGT...", ...])     # k-mer error correction

Every function runs on CUDA unless `device` names another device.
"""


def _text(seqs):
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.construct import suffix

    return suffix.build_text([dna.encode(s) for s in seqs],
                             trim_palindrome=False)


def build_index(seqs, device=None):
    """FMD-index over the reads and their reverse complements
    (fm6_build2, build.c:52-70), built and kept on `device`."""
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device
    from fermi_tpu_torch.index.fmd import FMDIndex

    bwt = multistring_bwt_device(_text(seqs), device)
    return FMDIndex.from_bwt(bwt, device)


def save_index(seqs, path: str, device=None):
    """Build and write a byte-exact .fmd file for a read set
    (fm_build + rld_dump; rld.c:242-263); the BWT is sorted on `device`."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device

    runs = rld.Runs.from_bwt(multistring_bwt_device(_text(seqs), device))
    rld.write_fmd(runs, path)


def load_index(path: str, device=None):
    """Load a .fmd file into an FMDIndex on `device` (rld_restore,
    rld.c:288-325)."""
    from fermi_tpu_torch.index.fmd import FMDIndex

    return FMDIndex.restore(path, device)


def smem(index, seq: str, self_match: bool = False):
    """Supermaximal exact matches of `seq` against the index (fm6_smem,
    smem.c:13-80), on the index's device. Returns a list of (start, end,
    size, left_closed, kf) tuples in query coordinates, in the order the
    reference emits them."""
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.search import smem as S

    return S.smem_all(index, [dna.encode(seq)], self_match=self_match)[0]


DEFAULT_QUAL = 20      # reference fermi.h:10


def correct(seqs, quals=None, k: int = -1, min_occ: int = 3,
            n_threads: int = 4, device=None):
    """Single-shot k-mer error correction (fm6_api_correct, correct.c:
    464-511, the defaults of fermi_tpu's api.correct: w=19 when k<0,
    min_occ=3, keep_bad, max_corr=0.3): build an FMD-index over the reads
    on `device`, collect solid k-mers there, fix every read on the host
    engine.  Returns (seqs, quals) lists of corrected strings."""
    from fermi_tpu_torch.algos import correct as ec

    w = k if k > 0 else 19
    if quals is None:
        quals = [chr(DEFAULT_QUAL + 33) * len(s) for s in seqs]
    idx = build_index(seqs, device)
    cls, key, val, _ = ec.collect_solid_kmers(idx, w, min_occ)
    table = ec.SolidTable(w, cls, key, val)
    opt = dict(w=w, min_occ=min_occ, keep_bad=1, is_paired=0, max_corr=0.3,
               trim_l=0, step=5)
    out_s, out_q, _, _ = ec.fix_reads(
        table, opt, [s.encode() for s in seqs],
        [q.encode() for q in quals], n_threads=n_threads)
    return ([s.decode("latin1") for s in out_s],
            [q.decode("latin1") for q in out_q])


__all__ = ["build_index", "save_index", "load_index", "smem", "correct"]
