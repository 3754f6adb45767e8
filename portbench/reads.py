"""The benchmark's data, drawn from the seed: a genome, Illumina-style read
pairs as two FASTQ files, and query reads.

Rewritten from the chip smoke test's generators (genome_p's repeat
families, paired_reads, wide_genome and wide_reads): a uniform random
genome with families of exact repeats written over it, pairs at a normal
insert clipped to a range, the second mate reverse-complemented, and
substitutions at a per-base rate with their own quality.  Every size
comes from the configuration's file, so two seeds draw the same amount of
work.  Codes are nt4 (0-3 for ACGT).
"""

import numpy as np

ASCII = np.frombuffer(b"ACGT", np.uint8)
CHUNK = 1 << 18                 # pairs drawn and laid out at a time


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's data (0 genome and reads,
    1 traffic, 2 the checked sample): the seed taken modulo 2^64."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def genome(rng, cfg) -> np.ndarray:
    """cfg['genome_len'] uniform random bases, with each repeat family
    [length, copies] of cfg['repeat_families'] written over it at random
    places that do not overlap."""
    n = int(cfg["genome_len"])
    g = rng.integers(0, 4, n, dtype=np.int8)
    fams = cfg.get("repeat_families") or []
    if not fams:
        return g
    lens = np.array([bp for bp, k in fams for _ in range(k)])
    seqs = [rng.integers(0, 4, bp, dtype=np.int8) for bp, _ in fams]
    fam_of = np.repeat(np.arange(len(fams)), [k for _, k in fams])
    order = rng.permutation(lens.size)
    lens, fam_of = lens[order], fam_of[order]
    gaps = np.sort(rng.integers(0, n - lens.sum() + 1, lens.size))
    starts = gaps + np.concatenate([[0], np.cumsum(lens)[:-1]])
    for st, f in zip(starts, fam_of):
        g[st: st + len(seqs[f])] = seqs[f]
    return g


def _substitute(rng, reads, rate):
    """Substitute each base with probability `rate`; the mask of those
    substituted."""
    err = rng.random(reads.shape, dtype=np.float32) < rate
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()),
                                            dtype=np.uint8)) % 4
    return err


def _fastq(ids, mate, reads, err, qual, sub_qual):
    """4-line FASTQ records of fixed width as one byte array."""
    m, L = reads.shape
    rec = np.empty((m, 14 + 2 * L + 4), np.uint8)
    rec[:, :2] = np.frombuffer(b"@p", np.uint8)
    tens = 10 ** np.arange(8, -1, -1, dtype=np.int64)
    rec[:, 2:11] = 48 + ids[:, None] // tens % 10
    rec[:, 11:14] = np.frombuffer(b"/%d\n" % mate, np.uint8)
    rec[:, 14: 14 + L] = ASCII[reads]
    rec[:, 14 + L: 17 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 17 + L: 17 + 2 * L] = np.where(err, 33 + sub_qual, 33 + qual)
    rec[:, -1] = 10
    return rec


def pairs(rng, g, cfg, paths=None):
    """cfg['n_pairs'] pairs of cfg['read_len'] bp from genome g: (first
    mates, second mates) as nt4 [n_pairs, read_len] each.  With `paths`
    (two file names) they are also written as FASTQ, mate 1 to the first
    file and mate 2 to the second, pair i named @p<i>/1 and @p<i>/2."""
    n, L = int(cfg["n_pairs"]), int(cfg["read_len"])
    lo_ins, hi_ins = int(cfg["insert_min"]), int(cfg["insert_max"])
    r1 = np.empty((n, L), np.uint8)
    r2 = np.empty((n, L), np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(
        g.view(np.uint8), L)
    files = [open(p, "wb") for p in paths] if paths else []
    try:
        for lo in range(0, n, CHUNK):
            m = min(CHUNK, n - lo)
            ins = np.clip(np.rint(rng.normal(cfg["insert_mean"],
                                             cfg["insert_sd"], m)),
                          lo_ins, hi_ins).astype(np.int64)
            pos = rng.integers(0, g.size - ins + 1)
            a, b = r1[lo: lo + m], r2[lo: lo + m]
            a[:] = windows[pos]
            b[:] = 3 - windows[pos + ins - L][:, ::-1]
            ea = _substitute(rng, a, cfg["sub_rate"])
            eb = _substitute(rng, b, cfg["sub_rate"])
            if files:
                ids = np.arange(lo, lo + m, dtype=np.int64)
                for f, mate, rd, e in ((files[0], 1, a, ea),
                                       (files[1], 2, b, eb)):
                    _fastq(ids, mate, rd, e, cfg["qual"],
                           cfg["sub_qual"]).tofile(f)
    finally:
        for f in files:
            f.close()
    return r1, r2


def queries(rng, g, n, length, sub_rate) -> np.ndarray:
    """n reads of `length` bp from random places of genome g, half of them
    reverse-complemented, with fresh substitutions at `sub_rate`: nt6
    codes (1-4) [n, length]."""
    pos = rng.integers(0, g.size - length + 1, n)
    q = g.view(np.uint8)[pos[:, None] + np.arange(length)]
    flip = rng.random(n) < 0.5
    q[flip] = 3 - q[flip, ::-1]
    _substitute(rng, q, sub_rate)
    return q + 1
