"""Sequence utility commands (reference seq.c:58-373, cmd.c:13-45):
splitfa, fltuniq, trimseq, pe2cofq, cg2cofq, cnt2qual.

The port of fermi_tpu/cli/sequtils.py; host stream tools, with fermi_tpu's
output bytes.  fltuniq, the read filter of the assembly pipeline
(seq.c:149-199), drops every read that holds a k-mer occurring once in the
whole file (and its mate, when consecutive records share a name): plain
4-line FASTQ is scanned as spans over the raw bytes and decided by the
native filter (native/sequtil.cpp fflt_keep); any other input (FASTA,
multi-line records) goes record by record through the same filter.
`_flt_keep_numpy` is the filter's plain version, which the tests hold the
native one against.  pe2cofq collates two mate files into the interleaved
FASTQ that `run -P` reads.
"""

import gzip
import math
import os
import sys

import numpy as np

from fermi_tpu_torch import native
from fermi_tpu_torch.core import dna, fastx


def _threads(cap):
    return min(os.cpu_count() or 1, cap)


def write_seq(rec) -> str:
    tag = "@" if rec.qual else ">"
    comment = f" {rec.comment}" if rec.comment else ""
    s = f"{tag}{rec.name}{comment}\n{rec.seq}\n"
    if rec.qual:
        s += f"+\n{rec.qual}\n"
    return s


def splitfa(in_path, prefix, n_files=8):
    outs = [gzip.open(f"{prefix}.{i:04d}.fq.gz", "wt", compresslevel=1)
            for i in range(n_files)]
    n_seqs = 0
    for rec in fastx.read_fastx(in_path):
        outs[(n_seqs >> 1) % n_files].write(write_seq(rec))
        n_seqs += 1
    for f in outs:
        f.close()


def _kmer_codes(seq: str, k: int):
    """All k-mer 2-bit codes over ACGT-only windows, and the per-base
    validity mask."""
    code = dna.NT6_TABLE[np.frombuffer(seq.encode(), np.uint8)].astype(
        np.int64) - 1
    valid = (code >= 0) & (code < 4)
    n = len(code)
    if n < k:
        return np.zeros(0, np.int64), valid
    codes = np.zeros(n - k + 1, np.int64)
    ok = np.ones(n - k + 1, bool)
    for j in range(k):
        codes = (codes << 2) | np.where(valid[j: j + n - k + 1],
                                        code[j: j + n - k + 1], 0)
        ok &= valid[j: j + n - k + 1]
    return codes[ok], valid


def fltuniq(in_path, out_fp, k=0, verbose=True):
    """Drop reads containing any unique k-mer (reference seq.c:149-199):
    a k-mer is kept when it occurs at least twice over the whole file
    (break-resetting windows, as the reference's rolling scan)."""
    if k == 0:
        k = fltuniq_auto_k(in_path)
        sys.stderr.write(f"[M::fltuniq] set the k-mer size as {k}\n")
    if _fltuniq_bytes(in_path, out_fp, k, verbose):
        return
    recs = list(fastx.read_fastx(in_path))
    if verbose:
        sys.stderr.write("[M::fltuniq] building the hash table...\n")
    keep_flags = _flt_keep_native(recs, k)
    if verbose:
        sys.stderr.write("[M::fltuniq] filtering the reads...\n")
    out = []
    prev_name = None
    for rec, keep in zip(recs, keep_flags):
        is_paired = prev_name is not None and prev_name == rec.name
        if is_paired:
            if not out:
                prev_name = rec.name
                continue
        else:
            if out:
                out_fp.write("".join(out))
            out = []
        if keep:
            out.append(write_seq(rec))
        elif is_paired:
            out = []
        prev_name = rec.name
    if out:
        out_fp.write("".join(out))


def _ranges_gather(arr, starts, lens):
    """arr bytes for the concatenated [starts[i], starts[i]+lens[i]) spans,
    one fancy index (for small span sets; _mask_extract for large ones)."""
    total = int(lens.sum())
    out_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(out_off, lens)
    return arr[np.repeat(starts, lens) + within]


def _mask_extract(arr, starts, lens):
    """Concatenated span bytes, a threaded memcpy per span
    (native/sequtil.cpp fspans_extract)."""
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out = np.empty(int(lens.sum()), np.uint8)
    native.get_sequtil_lib().fspans_extract(
        arr.ctypes.data, starts.ctypes.data, lens.ctypes.data, len(starts),
        out.ctypes.data, _threads(8))
    return out


def _fltuniq_scan(in_path, k, verbose):
    """The span scan of a plain 4-line FASTQ file: record bookkeeping is
    span arithmetic over the raw bytes, no per-record objects.  Returns
    (arr, ls, le, s1, lens, final_keep), or None when the input is not
    plain 4-line FASTQ (the record path handles it)."""
    opener = gzip.open if in_path.endswith(".gz") else open
    with opener(in_path, "rb") as f:
        data = f.read()
    if not data:
        return None
    if data[-1:] != b"\n":
        data += b"\n"
    data += b"+\n"  # literal '+' line all emitted records share (spans)
    arr = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(arr[:-2] == 10)
    if nl.size % 4:
        return None
    ls = np.concatenate([[0], nl[:-1] + 1])   # line starts
    le = nl                                   # line ends (at the \n)
    if not (arr[ls[0::4]] == ord("@")).all() or \
       not (arr[ls[2::4]] == ord("+")).all():
        return None
    if verbose:
        sys.stderr.write("[M::fltuniq] building the hash table...\n")
    s1, e1 = ls[1::4], le[1::4]
    n = len(s1)
    lens = e1 - s1
    offsets = np.concatenate([[0], np.cumsum(lens)])
    blob = np.ascontiguousarray(_mask_extract(arr, s1, lens))
    keep = _flt_keep(blob, offsets, k)
    if verbose:
        sys.stderr.write("[M::fltuniq] filtering the reads...\n")
    # pairing: consecutive records with the same name token form a group;
    # the reference keeps a group only if every member passes
    h_s, h_e = ls[0::4], le[0::4]
    ws = np.flatnonzero((arr == 32) | (arr == 9))
    if ws.size:
        wi = np.minimum(np.searchsorted(ws, h_s), ws.size - 1)
        tok_e = np.where(ws[wi] < h_e, ws[wi], h_e)
    else:
        tok_e = h_e
    tok_s = h_s + 1
    tok_len = tok_e - tok_s
    same = np.zeros(n, bool)
    if n > 1:
        eq_len = tok_len[1:] == tok_len[:-1]
        idx = np.flatnonzero(eq_len)
        if idx.size:
            a = _ranges_gather(arr, tok_s[idx + 1], tok_len[idx + 1])
            b = _ranges_gather(arr, tok_s[idx], tok_len[idx])
            seg = np.concatenate([[0], np.cumsum(tok_len[idx + 1])])
            mism = np.flatnonzero(a != b)
            bad = np.zeros(idx.size, bool)
            if mism.size:
                bad[np.searchsorted(seg, mism, side="right") - 1] = True
            same[idx + 1] = ~bad
    gid = np.cumsum(~same) - 1
    gkeep = np.ones(int(gid[-1]) + 1 if n else 0, bool)
    np.minimum.at(gkeep, gid, keep)
    return arr, ls, le, s1, lens, gkeep[gid]


def fltuniq_auto_k(in_path):
    """The reference's file-size k heuristic (seq.c:149-156)."""
    size = os.path.getsize(in_path)
    k = int(math.log(size) / math.log(4) + 1.499)
    return min(max(k, 15), 18)


def fltuniq_kept_seq_spans(in_path, k=0, verbose=True):
    """fltuniq for the pipeline: the kept records' sequence spans, without
    writing the filtered FASTQ.  Returns (arr, starts, lens) over the raw
    decompressed bytes, or None when the input is not plain 4-line FASTQ
    (the caller takes the record path)."""
    if k == 0:
        k = fltuniq_auto_k(in_path)
        if verbose:
            sys.stderr.write(f"[M::fltuniq] set the k-mer size as {k}\n")
    scan = _fltuniq_scan(in_path, k, verbose)
    if scan is None:
        return None
    arr, ls, le, s1, lens, final = scan
    sel = np.flatnonzero(final)
    return arr, s1[sel], lens[sel]


def _fltuniq_bytes(in_path, out_fp, k, verbose):
    """fltuniq's output over the span scan; False when the input is not
    plain 4-line FASTQ."""
    scan = _fltuniq_scan(in_path, k, verbose)
    if scan is None:
        return False
    arr, ls, le, s1, lens, final = scan
    h_s, h_e = ls[0::4], le[0::4]
    sel = np.flatnonzero(final)
    # emit @head\nseq\n+\nqual\n per kept record.  When every '+' line is
    # bare, a kept record is one contiguous span of the input
    if bool(((le[2::4] - ls[2::4]) == 1).all()):
        starts = ls[0::4][sel]
        lens4 = le[3::4][sel] + 1 - starts
        out = _mask_extract(arr, starts, lens4)
    else:
        plus_s = np.int64(arr.size - 2)
        starts = np.stack([ls[0::4][sel], s1[sel],
                           np.full(sel.size, plus_s),
                           ls[3::4][sel]], axis=1).reshape(-1)
        lens4 = np.stack([h_e[sel] - h_s[sel] + 1, lens[sel] + 1,
                          np.full(sel.size, 2, np.int64),
                          le[3::4][sel] - ls[3::4][sel] + 1],
                         axis=1).reshape(-1)
        out = _ranges_gather(arr, starts, lens4)
    out_fp.write(out.tobytes().decode("latin1"))
    return True


def _flt_keep(blob, offsets, k):
    """Keep flags of the reads blob[offsets[i]:offsets[i+1]] (ASCII), from
    the native filter (native/sequtil.cpp fflt_keep)."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    keep = np.zeros(n, np.uint8)
    r = native.get_sequtil_lib().fflt_keep(
        blob.ctypes.data, offsets.ctypes.data, n, k, keep.ctypes.data,
        _threads(16))
    if r != 0:
        raise RuntimeError(f"fflt_keep failed: {r}")
    return keep.astype(bool)


def _flt_keep_native(recs, k):
    blob = b"".join(r.seq.encode() for r in recs)
    barr = np.ascontiguousarray(np.frombuffer(blob, np.uint8))
    lens = np.array([len(r.seq) for r in recs], np.int64)
    return _flt_keep(barr, np.concatenate([[0], np.cumsum(lens)]), k)


def _flt_keep_numpy(recs, k):
    """The plain version of the filter: one blob, reads separated by k
    non-ACGT bytes so no window spans two; a read is kept iff it has no
    non-ACGT base and every window's code occurs at least twice."""
    sep = b"\xff" * k
    blob = sep.join(r.seq.encode() for r in recs) + sep
    barr = np.frombuffer(blob, np.uint8)
    dt = np.uint32 if k <= 15 else np.int64
    code = (dna.NT6_TABLE.astype(dt) - 1)[barr]  # invalid wraps, masked below
    valid = ((dna.NT6_TABLE >= 1) & (dna.NT6_TABLE <= 4))[barr]
    code = code * valid  # zero out invalid so Horner packs cleanly
    n = code.size
    nw = n - k + 1
    cs_inval = np.concatenate([[0], np.cumsum(~valid, dtype=np.int64)])
    win_ok = (cs_inval[k:] - cs_inval[:-k]) == 0
    codes = code[:nw].copy()
    for j in range(1, k):
        codes <<= dt(2)
        codes |= code[j: j + nw]
    vc = codes[win_ok]
    order = np.argsort(vc, kind="stable")
    sv = vc[order]
    b = np.empty(sv.size, bool)
    if sv.size:
        b[0] = True
        b[1:] = sv[1:] != sv[:-1]
    single = b & np.concatenate([b[1:], [True]])
    dup_sel = np.empty(sv.size, bool)
    dup_sel[order] = ~single
    dup = np.zeros(nw, bool)
    dup[win_ok] = dup_sel
    # per read: any invalid base -> drop; any in-read window not dup -> drop
    lens = np.array([len(r.seq) for r in recs], np.int64)
    starts = np.zeros(len(recs), np.int64)
    if len(recs) > 1:
        starts[1:] = np.cumsum(lens[:-1] + k)
    no_inval = (cs_inval[starts + lens] - cs_inval[starts]) == 0
    cs_bad = np.concatenate([[0], np.cumsum(~dup)])
    win_end = np.maximum(starts + lens - k + 1, starts)
    n_bad = cs_bad[win_end] - cs_bad[starts]
    return no_inval & ((lens < k) | (n_bad == 0))


def trimseq(in_path, out_fp, min_l=20, min_q=3, drop_ambi=True):
    out = []
    prev_name = None
    for rec in fastx.read_fastx(in_path):
        is_paired = False
        if prev_name is not None and len(rec.name) == len(prev_name) \
           and len(prev_name):
            if rec.name[:-1] == prev_name[:-1]:
                c1, c2 = prev_name[-1], rec.name[-1]
                if c1 == c2:
                    is_paired = True
                elif len(prev_name) >= 2 and prev_name[-2] == "/" \
                        and c1.isdigit() and c2.isdigit():
                    is_paired = True
        if is_paired:
            if not out:
                prev_name = rec.name
                continue
        else:
            if out:
                out_fp.write("".join(out))
            out = []
        left, right = 0, len(rec.seq)
        drop = False
        if min_q > 0 and rec.qual:
            q = np.frombuffer(rec.qual.encode(), np.uint8).astype(np.int32) - 33
            s = mx = 0
            max_i = right
            for i in range(right - 1, left - 1, -1):
                s += min_q - q[i]
                if s < 0:
                    break
                if mx < s:
                    mx, max_i = s, i
            right = max_i
            s = mx = 0
            max_i = -1
            for i in range(0, right):
                s += min_q - q[i]
                if s < 0:
                    break
                if mx < s:
                    mx, max_i = s, i
            left = max_i + 1
            if right - left < min_l:
                drop = True
        if not drop and drop_ambi:
            sub = dna.encode(rec.seq[left:right])
            if (sub >= 5).any():
                drop = True
        if not drop:
            r2 = fastx.SeqRecord(rec.name, rec.seq[left:right],
                                 rec.qual[left:right] if rec.qual else None,
                                 rec.comment)
            out.append(write_seq(r2))
        elif is_paired:
            out = []
        prev_name = rec.name
    if out:
        out_fp.write("".join(out))


def pe2cofq(in1, in2, out_fp):
    it1 = fastx.read_fastx(in1)
    it2 = fastx.read_fastx(in2)
    for r1 in it1:
        try:
            r2 = next(it2)
        except StopIteration:
            break
        name = r1.name
        if len(name) > 2 and name[-2] == "/" and name[-1].isdigit():
            name = name[:-2]
        r1 = fastx.SeqRecord(name, r1.seq, r1.qual, r1.comment)
        r2 = fastx.SeqRecord(name, r2.seq, r2.qual, r2.comment)
        out_fp.write(write_seq(r1))
        out_fp.write(write_seq(r2))


def cg2cofq(in_path, out_fp):
    for rec in fastx.read_fastx(in_path):
        i = 0
        while i < len(rec.seq) and rec.seq[i].isalpha():
            i += 1
        tag = "@" if rec.qual else ">"
        out_fp.write(f"{tag}{rec.name}\n{rec.seq[:i]}\n")
        if rec.qual:
            out_fp.write(f"+\n{rec.qual[:i]}\n")
        j = i
        while j < len(rec.seq) and not rec.seq[j].isalpha():
            j += 1
        if j != len(rec.seq):
            out_fp.write(f"{tag}{rec.name}\n{rec.seq[j:]}\n")
            if rec.qual:
                out_fp.write(f"+\n{rec.qual[j:]}\n")


def cnt2qual(in_path, out_fp, q=17):
    for rec in fastx.read_fastx(in_path):
        qual = rec.qual
        if qual:
            arr = np.frombuffer(qual.encode(), np.uint8).astype(np.int32)
            arr = np.minimum(q * (arr - 33) + 33, 126)
            qual = arr.astype(np.uint8).tobytes().decode("latin1")
        out_fp.write(f"@{rec.name}")
        if rec.comment:
            out_fp.write(f"\t{rec.comment}\n")
        else:
            out_fp.write("\n")
        out_fp.write(rec.seq + "\n")
        if qual:
            out_fp.write(f"+\n{qual}\n")
