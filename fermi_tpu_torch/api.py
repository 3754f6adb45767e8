"""Embedding API of the port: fermi_tpu/api.py's functions, with the
reference's high-level API (fermi.h:119-123: fm6_api_readseq/writeseq/
seqlen/correct/unitig) in Python shape: reads travel as lists of str, the
assembly graph as an `algos.mag.Mag`.

    from fermi_tpu_torch import api
    seqs, quals = api.read_seqs("reads.fq.gz")
    seqs, quals = api.correct(seqs, quals)          # k-mer error correction
    g = api.unitig(seqs)                            # overlap assembly
    g = api.clean(g, aggressive=True)               # graph cleaning
    api.write_mag(g, sys.stdout)

    idx = api.build_index(["ACGT...", ...])         # FMD-index of reads+rc
    api.save_index(seqs, "out.fmd")                 # byte-exact .fmd
    idx = api.load_index("out.fmd")
    for (start, end, size, closed, kf) in api.smem(idx, "ACGT..."):
        ...

Every function that builds or queries an index runs on CUDA unless
`device` names another device; I/O and graph cleaning are host code.
"""

import sys

import numpy as np

DEFAULT_QUAL = 20      # reference fermi.h:10


def read_seqs(path: str):
    """Read FASTA/FASTQ (optionally gzipped; "-" = stdin) into parallel
    lists of sequence and quality strings (fm6_api_readseq, seq.c:385-408).
    Missing qualities are filled with Q20+33 like the reference."""
    from fermi_tpu_torch.core import fastx

    seqs, quals = [], []
    for r in fastx.read_fastx(path):
        seqs.append(r.seq)
        quals.append(r.qual if r.qual else chr(DEFAULT_QUAL + 33) * len(r.seq))
    return seqs, quals


def write_seqs(seqs, quals=None, out=None):
    """Write reads as FASTQ with positional names, matching
    fm6_api_writeseq's `@<offset>` naming (seq.c:410-430)."""
    out = out or sys.stdout
    pos = 0
    for i, s in enumerate(seqs):
        pos += len(s) + 1
        q = quals[i] if quals else chr(DEFAULT_QUAL + 33) * len(s)
        out.write(f"@{pos - 1}\n{s.upper()}\n+\n{q}\n")


def seq_len_quantile(seqs, quantile: float = 0.25) -> int:
    """Length quantile over the read set (fm6_api_seqlen, seq.c:432-444;
    the reference's ks_ksmall picks the floor(n*q)-th smallest)."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    return int(np.partition(lens, int(len(lens) * quantile))
               [int(len(lens) * quantile)])


def _text(seqs):
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.construct import suffix

    return suffix.build_text([dna.encode(s) for s in seqs],
                             trim_palindrome=False)


def build_index(seqs, device=None):
    """FMD-index over the reads and their reverse complements
    (fm6_build2, build.c:52-70), built and kept on `device`; a text of
    2^31 - 8 symbols or more is sorted by the blocked builder."""
    from fermi_tpu_torch.construct import blocked
    from fermi_tpu_torch.index.fmd import FMDIndex

    return FMDIndex.from_bwt(blocked.device_bwt(_text(seqs), device), device)


def save_index(seqs, path: str, device=None):
    """Build and write a byte-exact .fmd file for a read set
    (fm_build + rld_dump; rld.c:242-263); the BWT is sorted on `device`,
    in blocks when the text is too long for prefix doubling."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.construct import blocked

    runs = rld.Runs.from_bwt(blocked.device_bwt(_text(seqs), device))
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


def unitig(seqs, min_match: int = -1, device=None):
    """In-process overlap assembly of a read set (fm6_api_unitig,
    unitig.c:413-434): its BWT sorted on `device`, the unitig walk on the
    host.  min_match < 0 auto-sizes to 0.33 * the 25% length quantile like
    the reference.  Returns an `algos.mag.Mag` graph."""
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.algos.scaf import fm6_api_unitig
    from fermi_tpu_torch.core import dna

    device = resolve_device(device)
    if min_match < 0:
        min_match = int(seq_len_quantile(seqs, 0.25) * 0.33 + 0.499)
    blob = b"\x00".join(dna.encode(s).tobytes() for s in seqs) + b"\x00"
    return fm6_api_unitig(min_match, blob, device)


def clean(g, aggressive: bool = False, **overrides):
    """Clean an assembly graph in place and return it (mag_g_clean,
    mag.c:615-673). `aggressive` enables bubble popping / tip trimming the
    way `fermi clean -CA` does; keyword overrides patch individual fields
    of the option struct (mag_init_opt defaults, mag.c:592-613)."""
    from fermi_tpu_torch.algos import mag as M

    opt = dict(M.DEFAULT_OPT)
    opt["flag_clean"] = True
    if aggressive:
        opt["flag_aggressive"] = True
    opt.update(overrides)
    M.g_clean(g, opt)
    return g


def write_mag(g, out=None):
    """Serialize a Mag graph in the reference's MAG text format
    (mag_v_write, mag.c:149-174)."""
    from fermi_tpu_torch.algos import mag as M

    M.mag_print(g, out or sys.stdout)


__all__ = [
    "read_seqs", "write_seqs", "seq_len_quantile", "correct", "unitig",
    "clean", "write_mag", "build_index", "save_index", "load_index", "smem",
]
