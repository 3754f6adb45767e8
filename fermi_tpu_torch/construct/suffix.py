"""Multi-string text layout and the BWT-from-SA rule.

The reference builds its FMD-index over a text where every sentinel (0) is a
distinct symbol ordered by its position (reference ksa.c:53-54).  build_text
lays reads out that way; construct/suffix_device.py sorts its suffixes on
the device.
"""

import numpy as np


def build_text(seqs: list[np.ndarray], both_strands: bool = True,
               trim_palindrome: bool = True) -> np.ndarray:
    """Concatenate reads (optionally + their reverse complements, fermi-style)
    into a sentinel-terminated nt6 text: fwd0 0 rc0 0 fwd1 0 rc1 0 ...

    trim_palindrome mirrors reference cmd.c:458-462 / ropebwt.c:25-29: an
    even-length read equal to its own reverse complement loses its last base so
    fwd and rc differ.
    """
    if not seqs:
        return np.zeros(0, np.uint8)
    F = np.concatenate([np.asarray(s, np.uint8) for s in seqs])
    lens = np.array([len(s) for s in seqs], np.int64)
    sf = np.concatenate([[0], np.cumsum(lens)])[:-1]
    if trim_palindrome and both_strands:
        # vectorized is_revcomp_palindrome over all reads at once
        ar = np.arange(F.size)
        mirror = np.repeat(2 * sf + lens - 1, lens) - ar
        ok = (F.astype(np.int16) + F[mirror]) == 5
        cs = np.concatenate([[0], np.cumsum(ok)])
        all_ok = (cs[sf + lens] - cs[sf]) == lens
        pal = (lens % 2 == 0) & (lens > 0) & all_ok
        if pal.any():
            keep = np.ones(F.size, bool)
            keep[sf[pal] + lens[pal] - 1] = False
            F = F[keep]
            lens = lens - pal
            sf = np.concatenate([[0], np.cumsum(lens)])[:-1]
    if not both_strands:
        o = np.concatenate([[0], np.cumsum(lens + 1)])[:-1]
        out = np.zeros(int((lens + 1).sum()), np.uint8)
        out[np.arange(F.size) + np.repeat(o - sf, lens)] = F
        return out
    # per read: fwd, 0, revcomp, 0 — both scatters in one vector pass
    o = np.concatenate([[0], np.cumsum(2 * lens + 2)])[:-1]
    out = np.zeros(int((2 * lens + 2).sum()), np.uint8)
    ar = np.arange(F.size)
    out[ar + np.repeat(o - sf, lens)] = F
    comp = np.where((F >= 1) & (F <= 4), 5 - F, F).astype(np.uint8)
    out[np.repeat(o + 2 * lens + sf, lens) - ar] = comp
    return out


def build_text_packed(F: np.ndarray, offsets: np.ndarray,
                      both_strands: bool = True,
                      trim_palindrome: bool = True) -> np.ndarray:
    """build_text over reads already packed as (concatenated nt6, offsets),
    in one native pass (native/frags.cpp fbuild_text)."""
    from fermi_tpu_torch import native

    n_reads = len(offsets) - 1
    if n_reads <= 0:
        return np.zeros(0, np.uint8)
    F = np.ascontiguousarray(F, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty(int(2 * F.size + 2 * n_reads), np.uint8)
    n = native.get_frags_lib().fbuild_text(
        F.ctypes.data, offsets.ctypes.data, n_reads, int(both_strands),
        int(trim_palindrome), out.ctypes.data)
    return out[:n]


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT[i] = text[SA[i]-1], with 0 where SA[i]==0 (reference ksa_bwt rule)."""
    t = np.asarray(text, dtype=np.uint8)
    sa = np.asarray(sa)
    out = np.where(sa > 0, t[sa - 1], 0).astype(np.uint8)
    return out
