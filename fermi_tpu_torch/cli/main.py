"""fermi-compatible command line of the port: build (and build -i),
unpack, exact, chkbwt, correct, seqsort/seqrank, unitig, clean, merge, sub,
contrast, bitand, recode, remap, scaf, example, the sequence tools
(splitfa, fltuniq, trimseq, pe2cofq, cg2cofq, cnt2qual), run (the
pipeline, unpaired or paired with -P) and ropebwt.

The same arguments and output bytes as fermi_tpu's CLI (cli/main.py), which
mirrors reference main.c.  Each subcommand that queries or builds an index
runs on CUDA unless `--device cpu` (or another device) is given; `clean`,
`bitand`, `recode`, `remap`, the sequence tools and `ropebwt -a bpr` are
host code, as in fermi_tpu.  `-M` (unpack, exact, chkbwt, correct,
seqsort/seqrank, unitig, remap) runs the command out of core on the host,
as fermi_tpu does: off the mmapped .fmd or its .fmd.blk record cache, with
no device, so it refuses `--device`.
"""

import argparse
import sys
import time

import numpy as np

_T0 = time.monotonic()


def _mmap_device_conflict(cmd, args):
    """-M runs on the host and touches no device: with --device as well,
    exit 1 naming the conflict (nothing would run on that device)."""
    if args.mmap and args.device is not None:
        sys.stderr.write(f"[E::{cmd}] -M runs out of core on the host and "
                         f"touches no device; drop --device {args.device} "
                         "or -M\n")
        return True
    return False


def _mmap_arg(p):
    p.add_argument("-M", dest="mmap", action="store_true",
                   help="out of core on the host: query the index off disk "
                        "(mmap), no device")


def _device_arg(p):
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")


def _add_build(sub):
    p = sub.add_parser("build", help="generate FMD-index from FASTA/FASTQ")
    p.add_argument("-b", dest="sbits", type=int, default=3,
                   help="small block marker per 2^(INT+3) bytes")
    p.add_argument("-f", dest="force", action="store_true",
                   help="overwrite output")
    p.add_argument("-o", dest="out", default="-", help="output file")
    p.add_argument("-i", dest="append_to", default=None,
                   help="append to the existing index FILE")
    p.add_argument("-s", dest="block_size", type=int, default=250000000)
    p.add_argument("-l", dest="max_len", type=int, default=0,
                   help="trim reads to INT bp (0: no trim)")
    p.add_argument("-O", dest="no_trim_pal", action="store_true",
                   help="do not 1bp-trim reads equal to own revcomp")
    _device_arg(p)
    p.add_argument("fastx")
    p.set_defaults(func=cmd_build)


def cmd_build(args):
    """The index of the reads, sorted on the device; with -i, the index
    of an existing index's reads followed by these (the reference's
    fm_append, merge.c:139-209).  -i takes the card route (the old index
    restored and merged on the device) when its device peak, reckoned from
    the old .fmd's header before anything is allocated, fits the device's
    free memory, else fermi_tpu's streaming route (the old index read off
    its .fmd.blk and its runs, never expanded); both give the same
    bytes.  Without -i the index is built in one piece when its reckoned
    device peak fits the free memory, else in the largest spans that fit,
    folded by -i's routes; the same bytes."""
    import os
    from fermi_tpu_torch import resolve_device, rld
    from fermi_tpu_torch.algos import merge as mg
    from fermi_tpu_torch.core import dna, fastx
    from fermi_tpu_torch.construct import blocked, suffix

    device = resolve_device(args.device)
    if args.out != "-" and not args.force and os.path.exists(args.out):
        sys.stderr.write(f"[E::build] File `{args.out}' exists. Use -f to overwrite.\n")
        return 1
    t0 = time.perf_counter()
    seqs = []
    for rec in fastx.read_fastx(args.fastx):
        s = dna.encode(rec.seq)
        if args.max_len and len(s) > args.max_len:
            s = s[: args.max_len]
        seqs.append(s)
    text = suffix.build_text(seqs, trim_palindrome=not args.no_trim_pal)
    t_text = time.perf_counter() - t0
    if args.append_to:
        mg.append_fmd(args.append_to, text, args.out, args.sbits, device)
        mg.APPEND_STATS["seconds"]["encode_text"] = t_text
        return 0
    cuts = _build_route("build", text, 2 * len(seqs), True, device)
    if cuts is not None:
        mg.fold_spans(text, cuts, args.out, args.sbits, device)
        return 0
    bwt = blocked.device_bwt(text, device)
    rld.write_fmd(rld.Runs.from_bwt(bwt), args.out, sbits=args.sbits)
    return 0


def _build_route(tag, text, n_seqs, paired, device):
    """The route of a build of `text`, n_seqs sequences (merge.build_route),
    printed on stderr before anything is allocated on the device: None for
    the one-piece build, else the spans to fold (merge.span_cuts; `paired`:
    the text holds each read's two strands side by side)."""
    from fermi_tpu_torch.algos import merge as mg

    route, need, free = mg.build_route(text.size, device, n_seqs)
    cuts = None if route == "card" else mg.span_cuts(text, free, paired)
    how = "by the card route" if cuts is None else f"in {len(cuts)} spans"
    sys.stderr.write(
        f"[M::{tag}] {text.size} symbols ({n_seqs} sequences) {how}: "
        f"reckoned device peak {need} bytes, free "
        f"{'-' if free is None else free}\n")
    return cuts


def _add_unpack(sub):
    p = sub.add_parser("unpack", help="retrieve DNA sequences from an index")
    p.add_argument("-i", dest="ids", type=int, action="append", default=[])
    _mmap_arg(p)
    _device_arg(p)
    p.add_argument("fmd")
    p.set_defaults(func=cmd_unpack)


def cmd_unpack(args):
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import extend as se

    if _mmap_device_conflict("unpack", args):
        return 1
    if args.mmap:
        # LF walks in the compressed domain of the mmapped .fmd
        # (rld.c:327-346)
        from fermi_tpu_torch.index.mmapfmd import MmapIndex

        idx = MmapIndex(args.fmd)

        def walk(chunk):
            return idx.retrieve(chunk, return_ranks=True)
    else:
        idx = FMDIndex.restore(args.fmd, resolve_device(args.device))

        def walk(chunk):
            # to the sentinel, whatever the length (fermi_tpu stops at
            # 2^16 symbols)
            return se.retrieve_strings(idx, chunk)
    n = idx.n_seqs
    ids = [i for i in args.ids if i < n] if args.ids else range(n)
    ids = np.fromiter(ids, dtype=np.int64)
    for lo in range(0, len(ids), 4096):
        seqs, ranks = walk(ids[lo: lo + 4096])
        for s, k in zip(seqs, ranks):
            sys.stdout.write(f"{dna.decode(s)}\t{int(k)}\n")
    return 0


def _add_exact(sub):
    p = sub.add_parser("exact", help="find exact (supermaximal) matches")
    _mmap_arg(p)
    p.add_argument("-s", dest="self_match", action="store_true")
    _device_arg(p)
    p.add_argument("fmd")
    p.add_argument("fastx")
    p.set_defaults(func=cmd_exact)


def cmd_exact(args):
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.core import dna, fastx
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import smem as sm

    if _mmap_device_conflict("exact", args):
        return 1
    if args.mmap:  # the native engine off the mapped record cache
        from fermi_tpu_torch.index.blkidx import ensure_blk

        idx = ensure_blk(args.fmd)
    else:
        idx = FMDIndex.restore(args.fmd, resolve_device(args.device))
    recs = list(fastx.read_fastx(args.fastx))
    seqs = [dna.encode(r.seq) for r in recs]
    batch = 4096
    for lo in range(0, len(recs), batch):
        chunk = seqs[lo: lo + batch]
        write_exact(idx, [r.name for r in recs[lo: lo + batch]], chunk,
                    sm.smem_all(idx, chunk, self_match=args.self_match),
                    sys.stdout)
    return 0


def write_exact(idx, names, seqs, matches, out):
    """`exact`'s records of the queries `names`/`seqs` and their SMEMs
    (smem_all's tuples) on `out`."""
    from fermi_tpu_torch.search import smem as sm

    for name, s, mems in zip(names, seqs, matches):
        out.write(f"SQ\t{name}\t{len(s)}\t{len(mems)}\n")
        for m in mems:
            out.write("EM\t" + sm.format_smem(idx, m) + "\n")
        out.write("//\n")


CHKBWT_CHUNK = 1 << 22     # positions a rank-check step compares


def _add_chkbwt(sub):
    p = sub.add_parser("chkbwt", help="validate the FMD-index")
    _mmap_arg(p)
    p.add_argument("-r", dest="check_rank", action="store_true",
                   help="check rank() at every position against a running "
                        "count (kernel K1 on the card)")
    p.add_argument("-p", dest="plain", action="store_true",
                   help="print the BWT")
    _device_arg(p)
    p.add_argument("fmd")
    p.set_defaults(func=cmd_chkbwt)


def cmd_chkbwt(args):
    """The marginal counts; with -r, check_ranks; with -p, the BWT as
    text."""
    from fermi_tpu_torch import resolve_device, rld
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.index.fmd import FMDIndex

    if _mmap_device_conflict("chkbwt", args):
        return 1
    if args.mmap:
        return _chkbwt_mmap(args)
    device = resolve_device(args.device)
    runs = rld.read_fmd(args.fmd)
    mc = ", ".join(str(int(x)) for x in runs.mcnt)
    sys.stderr.write(f"[M::chkbwt] marginal counts: ({mc})\n")
    idx = FMDIndex.from_runs(runs, device)
    if args.check_rank and check_ranks(idx, runs.mcnt):
        return 1
    if args.plain:
        sys.stdout.write(dna.decode(idx.bwt().cpu().numpy()))
        sys.stdout.write("\n")
    return 0


def check_ranks(idx, mcnt) -> int:
    """`chkbwt -r` of a restored index: rank6 at every position against a
    running count of the BWT, a chunk at a time on the index's device (the
    memory beyond the index is one chunk's), then the final counts against
    the header's marginal counts `mcnt`.  Returns the exit code; the
    messages go to stderr."""
    import torch

    bwt = idx.bwt()
    device = idx.device
    syms = torch.arange(6, dtype=torch.uint8, device=device)[:, None]
    carry = torch.zeros((6, 1), dtype=torch.int64, device=device)
    for lo in range(0, idx.total, CHKBWT_CHUNK):
        hi = min(lo + CHKBWT_CHUNK, idx.total)
        # counts of each symbol in BWT[0..k] for k in [lo, hi), as
        # [6, hi - lo]: one scan over the six rows laid end to end, less
        # the counts before each row (a scan along the rows' own dimension
        # runs in a single thread block on CUDA)
        expect = torch.cumsum((bwt[lo:hi] == syms).view(-1), 0).view(6, -1)
        ends = expect[:, -1].clone()
        expect[1:] -= ends[:-1, None]
        expect += carry
        ks = torch.arange(lo + 1, hi + 1, device=device)
        bad = (idx.rank6(ks).T != expect).T.nonzero()
        if bad.numel():
            pos, c = bad[0].tolist()
            sys.stderr.write(f"[E::chkbwt] rank({c},{lo + pos}) mismatch\n")
            return 1
        carry = expect[:, -1:]
    want = np.asarray(mcnt[1:7], dtype=np.int64)
    if not np.array_equal(carry[:, 0].cpu().numpy(), want):
        sys.stderr.write("[E::chkbwt] marginal count mismatch\n")
        return 1
    sys.stderr.write("[M::chkbwt] rank check passed\n")
    return 0


def _chkbwt_mmap(args):
    """chkbwt on the host without expanding the BWT in RAM: the record
    cache checked against itself (each block's occ row against the running
    counts of the blocks before it) and, once a chunk of rows, against a
    rank query in the compressed domain of the mapped .fmd (fermi_tpu's
    `chkbwt -M`).  A .fmd whose runs hold another number of symbols than
    its header gets no cache and exits 1, where fermi_tpu caches the
    header's first n symbols and passes (fault F4)."""
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.index.blkidx import ensure_blk
    from fermi_tpu_torch.index.mmapfmd import MmapIndex

    m = MmapIndex(args.fmd)
    mc = ", ".join(str(int(x)) for x in m.mcnt)
    sys.stderr.write(f"[M::chkbwt] marginal counts: ({mc})\n")
    try:
        blk = ensure_blk(args.fmd)
    except OSError as e:           # no record cache of a damaged index
        sys.stderr.write(f"[E::chkbwt] {e}\n")
        return 1
    rstride = 256 if blk.wide else 192
    odt = np.uint64 if blk.wide else np.uint32
    raw = np.memmap(blk.path, np.uint8, "r", offset=4096)
    raw = raw.reshape(blk.n_rows, rstride)
    run_cnt = np.zeros(6, np.int64)
    chunk = 1 << 16
    rng = np.random.default_rng(0)
    for lo in range(0, blk.n_rows, chunk):
        rows = np.asarray(raw[lo: lo + chunk])
        occ = rows[:, 128:128 + (48 if blk.wide else 24)].copy()
        occ = occ.view(odt).reshape(-1, 6).astype(np.int64)
        if args.check_rank:
            hist = np.zeros((len(rows), 6), np.int64)
            for c in range(6):
                hist[:, c] = (rows[:, :128] == c).sum(axis=1)
            expect = run_cnt + np.vstack(
                [np.zeros(6, np.int64), np.cumsum(hist[:-1], axis=0)])
            if not np.array_equal(occ, expect):
                bad = int(np.argwhere((occ != expect).any(axis=1))[0][0])
                sys.stderr.write(
                    f"[E::chkbwt] occ row {lo + bad} mismatch\n")
                return 1
            run_cnt = expect[-1] + hist[-1]
            # tie the cache to the compressed index: one rank6 a chunk
            pos = int(rng.integers(lo, min(lo + chunk, blk.n_rows))) << 7
            pos = min(pos, blk.total)
            got = m.rank6(np.array([pos]))[0]
            want = occ[min((pos >> 7) - lo, len(occ) - 1)]
            if (pos & 127) == 0 and pos < blk.total and \
                    not np.array_equal(got, want):
                sys.stderr.write(f"[E::chkbwt] fmd/blk rank({pos})\n")
                return 1
        if args.plain:
            flat = rows[:, :128].reshape(-1)
            end = min(blk.total - (lo << 7), flat.size)
            sys.stdout.write(dna.decode(flat[:end]))
    if args.check_rank:
        if not np.array_equal(run_cnt, m.mcnt[1:7].astype(np.int64)):
            sys.stderr.write("[E::chkbwt] marginal count mismatch\n")
            return 1
        sys.stderr.write("[M::chkbwt] rank check passed\n")
    if args.plain:
        sys.stdout.write("\n")
    return 0


def _add_correct(sub):
    p = sub.add_parser("correct", help="error-correct reads against an index")
    _mmap_arg(p)
    p.add_argument("-K", dest="keep_bad", action="store_true")
    p.add_argument("-t", dest="n_threads", type=int, default=1)
    p.add_argument("-k", dest="w", type=int, default=-1)
    p.add_argument("-v", dest="verbose", type=int, default=4)
    p.add_argument("-O", dest="min_occ", type=int, default=3)
    p.add_argument("-p", dest="is_paired", action="store_true")
    p.add_argument("-C", dest="max_corr", type=float, default=0.3)
    p.add_argument("-l", dest="trim_l", type=int, default=0)
    p.add_argument("-s", dest="step", type=int, default=5)
    _device_arg(p)
    p.add_argument("fmd")
    p.add_argument("fastx")
    p.set_defaults(func=cmd_correct)


def cmd_correct(args):
    """Collect on the device, fix on the host engine (or on the device with
    FERMI_TPU_DEVICE_FIX=1); with -M both on the host, collect off the
    mapped record cache.  The corrected FASTQ goes to stdout."""
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.algos import correct as ec
    from fermi_tpu_torch.index.fmd import FMDIndex

    if _mmap_device_conflict("correct", args):
        return 1
    if args.mmap:
        from fermi_tpu_torch.index.blkidx import ensure_blk

        idx = ensure_blk(args.fmd)
    else:
        idx = FMDIndex.restore(args.fmd, resolve_device(args.device))
    ec.ec_correct(idx, args.fastx, sys.stdout, w=args.w,
                  min_occ=args.min_occ, keep_bad=args.keep_bad,
                  is_paired=args.is_paired, max_corr=args.max_corr,
                  trim_l=args.trim_l, step=args.step,
                  n_threads=args.n_threads)
    return 0


def _add_seqsort(sub):
    for name in ("seqsort", "seqrank"):
        p = sub.add_parser(name, help="compute the rank of sequences")
        _mmap_arg(p)
        p.add_argument("-t", dest="n_threads", type=int, default=1,
                       help="threads of the host walks of -M; without -M "
                            "the walks run on the device and -t is ignored")
        _device_arg(p)
        p.add_argument("fmd")
        p.set_defaults(func=cmd_seqsort)


def cmd_seqsort(args):
    """The .rank array (uint64 per sequence) as raw bytes on stdout."""
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.algos.seqsort import seqsort, seqsort_native
    from fermi_tpu_torch.index.fmd import FMDIndex

    if _mmap_device_conflict(args.cmd, args):
        return 1
    if args.mmap:  # the host walks off the mapped record cache
        from fermi_tpu_torch.index.blkidx import ensure_blk

        arr = seqsort_native(ensure_blk(args.fmd),
                             n_threads=max(args.n_threads, 1))
    else:
        arr = seqsort(FMDIndex.restore(args.fmd,
                                       resolve_device(args.device)))
    sys.stdout.flush()
    sys.stdout.buffer.write(arr.tobytes())
    sys.stdout.buffer.flush()
    return 0


def _add_unitig(sub):
    p = sub.add_parser("unitig", help="construct unitigs")
    _mmap_arg(p)
    p.add_argument("-l", dest="min_match", type=int, default=30)
    p.add_argument("-t", dest="n_threads", type=int, default=1,
                   help="threads of the host walk of -M (more than one: the "
                        "reference's -t N, whose boundary reads depend on "
                        "timing); without -M the links are computed on the "
                        "device, -t is ignored and the output is -t 1's")
    p.add_argument("-r", dest="rank_file", default=None)
    _device_arg(p)
    p.add_argument("fmd")
    p.set_defaults(func=cmd_unitig)


def cmd_unitig(args):
    """Link records on the device, the native stitch on the host: the MAG
    text of `unitig -t 1` on stdout, whatever -t is.  With -M, the native
    host walk off the mapped record cache, in -t threads."""
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.algos.unitig_bulk import fm6_unitig_device
    from fermi_tpu_torch.index.fmd import FMDIndex

    if _mmap_device_conflict("unitig", args):
        return 1
    if args.mmap:
        from fermi_tpu_torch.index.blkidx import ensure_blk

        idx = ensure_blk(args.fmd)
    else:
        idx = FMDIndex.restore(args.fmd, resolve_device(args.device))
    sorted_arr = None
    if args.rank_file:
        sorted_arr = np.fromfile(args.rank_file, np.uint64, idx.n_seqs)
    if args.mmap:
        from fermi_tpu_torch.algos.unitig import fm6_unitig_native

        sys.stdout.write(fm6_unitig_native(idx, args.min_match, sorted_arr,
                                           args.n_threads))
    else:
        fm6_unitig_device(idx, args.min_match, sys.stdout, sorted_arr)
    return 0


def _add_clean(sub):
    p = sub.add_parser("clean", help="clean the assembly graph")
    p.add_argument("-F", dest="no_amend", action="store_true")
    p.add_argument("-C", dest="clean", action="store_true")
    p.add_argument("-A", dest="aggressive", action="store_true")
    p.add_argument("-O", dest="read_ori", action="store_true")
    p.add_argument("-S", dest="no_simpl", action="store_true")
    p.add_argument("-d", dest="min_dratio0", type=float, default=0.7)
    p.add_argument("-N", dest="max_arc", type=int, default=512)
    p.add_argument("-l", dest="min_elen", type=int, default=300)
    p.add_argument("-e", dest="min_ensr", type=int, default=4)
    p.add_argument("-i", dest="min_insr", type=int, default=3)
    p.add_argument("-o", dest="min_ovlp", type=int, default=60)
    p.add_argument("-n", dest="n_iter", type=int, default=3)
    p.add_argument("-R", dest="min_dratio1", type=float, default=0.8)
    p.add_argument("-w", dest="max_bcov", type=float, default=10.0)
    p.add_argument("-r", dest="max_bfrac", type=float, default=0.15)
    p.add_argument("mag")
    p.set_defaults(func=cmd_clean)


def cmd_clean(args):
    """The cleaned MAG graph on stdout (host code)."""
    from fermi_tpu_torch.algos import mag as M

    opt = dict(M.DEFAULT_OPT)
    opt.update(flag_no_amend=args.no_amend, flag_clean=args.clean,
               flag_aggressive=args.aggressive, flag_read_ori=args.read_ori,
               flag_no_simpl=args.no_simpl, min_dratio0=args.min_dratio0,
               max_arc=args.max_arc, min_elen=args.min_elen,
               min_ensr=args.min_ensr, min_insr=args.min_insr,
               min_ovlp=args.min_ovlp, n_iter=args.n_iter,
               min_dratio1=args.min_dratio1, max_bcov=args.max_bcov,
               max_bfrac=args.max_bfrac)
    g = M.mag_read(args.mag, opt)
    M.g_clean(g, opt)
    M.mag_print(g, sys.stdout)
    return 0


def _add_merge(sub):
    p = sub.add_parser("merge", help="merge multiple FMD-indexes")
    p.add_argument("-f", dest="force", action="store_true")
    p.add_argument("-t", dest="n_threads", type=int, default=1,
                   help="accepted for compatibility; the walks run on "
                        "the device")
    p.add_argument("-o", dest="out", default="-")
    _device_arg(p)
    p.add_argument("fmds", nargs="+")
    p.set_defaults(func=cmd_merge)


def cmd_merge(args):
    """The indexes folded left to right, each merge on the device."""
    import os
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.algos import merge as mg

    device = resolve_device(args.device)
    if args.out != "-" and not args.force and os.path.exists(args.out):
        sys.stderr.write(f"[E::merge] File `{args.out}' exists. Use -f.\n")
        return 1
    mg.merge_files(args.fmds, args.out, device)
    return 0


def _add_sub(sub):
    p = sub.add_parser("sub", help="extract sub-index with a bit array")
    p.add_argument("-c", dest="is_comp", action="store_true")
    p.add_argument("-t", dest="n_threads", type=int, default=1,
                   help="accepted for compatibility; the walks run on "
                        "the device")
    _device_arg(p)
    p.add_argument("fmd")
    p.add_argument("bits")
    p.set_defaults(func=cmd_sub)


def cmd_sub(args):
    """The sub-index of the reads whose bit is set (-c: not set) as .fmd
    bytes on stdout."""
    from fermi_tpu_torch import resolve_device, rld
    from fermi_tpu_torch.algos.sub import fm_sub, unpack_bitfile
    from fermi_tpu_torch.index.fmd import FMDIndex

    device = resolve_device(args.device)
    runs = rld.read_fmd(args.fmd)
    bits = unpack_bitfile(args.bits)
    if len(bits) != runs.n_seqs:
        sys.stderr.write("[E::sub] unmatched index and the bit array\n")
        return 1
    bwt = runs.expand()
    out = fm_sub(FMDIndex.from_runs(runs, device), bwt, bits, args.is_comp)
    rld.write_fmd(rld.Runs.from_bwt(out), "-")
    return 0


def _add_contrast(sub):
    p = sub.add_parser("contrast", help="compare two FMD-indexes")
    p.add_argument("-k", dest="kmer", type=int, default=55)
    p.add_argument("-o", dest="min_occ", type=int, default=3)
    p.add_argument("-t", dest="n_threads", type=int, default=1,
                   help="accepted for compatibility; the BFS runs on "
                        "the device")
    _device_arg(p)
    p.add_argument("args", nargs=6,
                   metavar="idx1.fmd idx1.rank 1-2.sub idx2.fmd idx2.rank 2-1.sub")
    p.set_defaults(func=cmd_contrast)


def cmd_contrast(args):
    """The reads of each index that carry a k-mer absent from the other,
    as a bit file per index (read-id space, through its .rank array)."""
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.algos.contrast import fm6_contrast, sub_conv
    from fermi_tpu_torch.algos.sub import pack_bitfile
    from fermi_tpu_torch.index.fmd import FMDIndex

    device = resolve_device(args.device)
    f0, r0, o0, f1, r1, o1 = args.args
    sub0, sub1 = fm6_contrast(FMDIndex.restore(f0, device),
                              FMDIndex.restore(f1, device), args.kmer,
                              args.min_occ)
    for fmd, rank_fn, out_fn, s in ((f0, r0, o0, sub0), (f1, r1, o1, sub1)):
        sel = sub_conv(s, np.fromfile(rank_fn, np.uint64, len(s)))
        sys.stderr.write(
            f"[M::contrast] {int(sel.sum())} reads selected from {fmd}\n")
        with open(out_fn, "wb") as fp:
            pack_bitfile(fp, sel)
    return 0


def _add_bitand(sub):
    p = sub.add_parser("bitand", help="intersect bit arrays")
    p.add_argument("bits", nargs="+")
    p.set_defaults(func=cmd_bitand)


def cmd_bitand(args):
    """The intersection of bit files on stdout (host code)."""
    from fermi_tpu_torch.algos.sub import pack_bitfile, unpack_bitfile

    acc = unpack_bitfile(args.bits[0])
    sys.stderr.write(f"[M::bitand] loaded `{args.bits[0]}' containing "
                     f"{int(acc.sum())} bits\n")
    for fn in args.bits[1:]:
        b = unpack_bitfile(fn)
        sys.stderr.write(f"[M::bitand] loaded `{fn}' containing "
                         f"{int(b.sum())} bits\n")
        if len(b) != len(acc):
            sys.stderr.write("[E::bitand] unequal array length\n")
            return 1
        acc &= b
    sys.stderr.write(f"[M::bitand] the output contains {int(acc.sum())} bits\n")
    sys.stdout.flush()
    pack_bitfile(sys.stdout.buffer, acc)
    sys.stdout.buffer.flush()
    return 0


def _add_recode(sub):
    p = sub.add_parser("recode", help="recode FM-index")
    p.add_argument("fmd")
    p.set_defaults(func=cmd_recode)


def cmd_recode(args):
    """The index re-encoded, .fmd bytes on stdout (host code)."""
    from fermi_tpu_torch import rld

    rld.write_fmd(rld.read_fmd(args.fmd), "-")
    return 0


def _add_remap(sub):
    p = sub.add_parser(
        "remap", help="compute coverage and PE coverage (host code: the "
                      "index is restored on the CPU, the contigs' SMEMs "
                      "come from the native engine)")
    _mmap_arg(p)
    p.add_argument("-l", dest="skip", type=int, default=50)
    p.add_argument("-c", dest="min_pcv", type=int, default=0)
    p.add_argument("-D", dest="max_dist", type=int, default=1000)
    p.add_argument("-r", dest="rank_file", default=None)
    p.add_argument("-t", dest="n_threads", type=int, default=1,
                   help="accepted for compatibility; the native engine "
                        "uses every core")
    p.add_argument("fmd")
    p.add_argument("contigs")
    p.set_defaults(func=cmd_remap)


def cmd_remap(args):
    """Contigs annotated with coverage (and, with -r, read-pair links) on
    stdout, the insert-size line on stderr."""
    from fermi_tpu_torch.algos.remap import remap
    from fermi_tpu_torch.index.fmd import FMDIndex

    if args.mmap:  # the contigs' SMEMs off the mapped record cache
        from fermi_tpu_torch.index.blkidx import ensure_blk

        idx = ensure_blk(args.fmd)
    else:
        idx = FMDIndex.restore(args.fmd, "cpu")
    sorted_arr = None
    if args.rank_file:
        sorted_arr = np.fromfile(args.rank_file, np.uint64)
    remap(idx, args.contigs, sys.stdout, sorted_arr, args.skip, args.min_pcv,
          args.max_dist)
    return 0


def _add_scaf(sub):
    p = sub.add_parser("scaf", help="generate scaftigs")
    p.add_argument("-t", dest="n_threads", type=int, default=1,
                   help="accepted for compatibility and ignored, as in "
                        "fermi_tpu")
    p.add_argument("-m", dest="min_supp", type=int, default=5)
    p.add_argument("-P", dest="pr_links", action="store_true")
    p.add_argument("-a", dest="a_thres", type=float, default=20.0)
    p.add_argument("-p", dest="p_thres", type=float, default=1e-20)
    _device_arg(p)
    p.add_argument("fmd")
    p.add_argument("mag")
    p.add_argument("avg", type=float)
    p.add_argument("std", type=float)
    p.set_defaults(func=cmd_scaf)


def cmd_scaf(args):
    """Scaftigs (FASTA) on stdout: mate reads retrieved on the device,
    local assemblies sorted there and walked on the host."""
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.algos.scaf import scaf_core
    from fermi_tpu_torch.index.fmd import FMDIndex

    device = resolve_device(args.device)
    scaf_core(FMDIndex.restore(args.fmd, device), args.mag, args.avg,
              args.std, min_supp=args.min_supp, a_thres=args.a_thres,
              p_thres=args.p_thres, pr_links=args.pr_links, out_fp=sys.stdout)
    return 0


def _add_sequtils(sub):
    p = sub.add_parser("splitfa", help="split a FASTA/Q file")
    p.add_argument("fastx")
    p.add_argument("prefix")
    p.add_argument("n_files", nargs="?", type=int, default=8)
    p.set_defaults(func=lambda a: _sequtil("splitfa", a))

    p = sub.add_parser("fltuniq", help="filter reads containing unique mers")
    p.add_argument("-k", dest="k", type=int, default=0)
    p.add_argument("fastx")
    p.set_defaults(func=lambda a: _sequtil("fltuniq", a))

    p = sub.add_parser("trimseq", help="trim a FASTA/Q file")
    p.add_argument("-q", dest="min_q", type=int, default=3)
    p.add_argument("-l", dest="min_l", type=int, default=20)
    p.add_argument("-N", dest="keep_ambi", action="store_true")
    p.add_argument("fastx")
    p.set_defaults(func=lambda a: _sequtil("trimseq", a))

    p = sub.add_parser("pe2cofq", help="convert split pefq to collated fastq")
    p.add_argument("fq1")
    p.add_argument("fq2")
    p.set_defaults(func=lambda a: _sequtil("pe2cofq", a))

    p = sub.add_parser("cg2cofq", help="convert cgfq to collated fastq")
    p.add_argument("fastx")
    p.set_defaults(func=lambda a: _sequtil("cg2cofq", a))

    p = sub.add_parser("cnt2qual", help="scale count-style qualities")
    p.add_argument("fastx")
    p.add_argument("q", nargs="?", type=int, default=17)
    p.set_defaults(func=lambda a: _sequtil("cnt2qual", a))


def _sequtil(which, args):
    """The sequence tools (host code); output on stdout, splitfa's in its
    files."""
    from fermi_tpu_torch.cli import sequtils as su

    if which == "splitfa":
        su.splitfa(args.fastx, args.prefix, args.n_files)
    elif which == "fltuniq":
        su.fltuniq(args.fastx, sys.stdout, k=args.k)
    elif which == "trimseq":
        su.trimseq(args.fastx, sys.stdout, min_l=args.min_l, min_q=args.min_q,
                   drop_ambi=not args.keep_ambi)
    elif which == "pe2cofq":
        su.pe2cofq(args.fq1, args.fq2, sys.stdout)
    elif which == "cg2cofq":
        su.cg2cofq(args.fastx, sys.stdout)
    elif which == "cnt2qual":
        su.cnt2qual(args.fastx, sys.stdout, q=args.q)
    return 0


def _add_example(sub):
    p = sub.add_parser("example", help="light-weight assembly via the API")
    p.add_argument("-e", dest="do_ec", action="store_true")
    p.add_argument("-U", dest="skip_unitig", action="store_true")
    p.add_argument("-c", dest="do_clean", action="store_true")
    p.add_argument("-k", dest="ec_k", type=int, default=-1)
    p.add_argument("-l", dest="unitig_k", type=int, default=-1)
    _device_arg(p)
    p.add_argument("fastx")
    p.set_defaults(func=cmd_example)


def cmd_example(args):
    """The reference's API walk-through (example.c) over api.py: -e
    corrects the reads (device collect, host fix), -U writes them and
    stops; else their unitigs (BWT sorted on the device, the walk on the
    host), cleaned with -c, as MAG on stdout."""
    from fermi_tpu_torch import api, resolve_device

    device = resolve_device(args.device)
    seqs, quals = api.read_seqs(args.fastx)
    if args.do_ec:
        seqs, quals = api.correct(seqs, quals, k=args.ec_k, device=device)
    if args.skip_unitig:
        api.write_seqs(seqs, quals, sys.stdout)
        return 0
    if args.unitig_k > 0:
        mm = args.unitig_k
    else:
        mm = int(api.seq_len_quantile(seqs, 0.25) * 0.33 + 0.499)
        sys.stderr.write(f"[M::example] choose k-mer size as {mm}\n")
    g = api.unitig(seqs, mm, device)
    if args.do_clean:
        api.clean(g, aggressive=True)
    api.write_mag(g, sys.stdout)
    return 0


def _add_run(sub):
    p = sub.add_parser(
        "run", help="full assembly pipeline (run-fermi.pl): raw.fmd, "
                    "ec.fq.gz, ec.fmd, p0-p2.mag.gz; with -P also ec.rank, "
                    "p3.mag.gz, p4.fa.gz (scaftigs) and p5.fq.gz; unitig "
                    "gives `unitig -t 1`'s bytes whatever -t is")
    p.add_argument("-P", dest="paired", action="store_true",
                   help="input is collated/interleaved paired FASTQ")
    p.add_argument("-C", dest="skip_ec", action="store_true")
    p.add_argument("-t", dest="n_threads", type=int, default=2)
    p.add_argument("-p", dest="prefix", default="fmdef")
    p.add_argument("-l", dest="trim_l", type=int, default=0)
    p.add_argument("-k", dest="unitig_k", type=int, default=50)
    _device_arg(p)
    p.add_argument("fastx", nargs="+")
    p.set_defaults(func=cmd_run)


def cmd_run(args):
    from fermi_tpu_torch.pipeline.driver import Pipeline

    Pipeline(args.prefix, n_threads=args.n_threads, unitig_k=args.unitig_k,
             paired=args.paired, trim_l=args.trim_l, skip_ec=args.skip_ec,
             device=args.device).run(args.fastx)
    return 0


def _add_ropebwt(sub):
    p = sub.add_parser("ropebwt", help="alternative FM-index construction")
    p.add_argument("-a", dest="algo", default="bpr",
                   choices=["bpr", "bcr", "sais"])
    p.add_argument("-b", dest="binary", action="store_true",
                   help="binary RLE6 output")
    p.add_argument("-N", dest="cut_n", action="store_true")
    p.add_argument("-O", dest="no_trim_pal", action="store_true")
    p.add_argument("-F", dest="no_fwd", action="store_true")
    p.add_argument("-R", dest="no_rev", action="store_true")
    # accepted for the reference's command lines; nothing to tune here
    p.add_argument("-t", dest="threaded", action="store_true")
    p.add_argument("-o", dest="out", default="-")
    p.add_argument("-f", dest="tmpfn", default=None)
    p.add_argument("-v", dest="verbose", type=int, default=1)
    p.add_argument("-r", dest="max_runs", type=int, default=512)
    p.add_argument("-n", dest="max_nodes", type=int, default=64)
    _device_arg(p)
    p.add_argument("fastx")
    p.set_defaults(func=cmd_ropebwt)


def _ropebwt_frags(path, cut_n=False, trim_pal=True, fwd=True, rev=True):
    """The strands `ropebwt` indexes, in order: each read (split at N with
    cut_n), its palindromes 1 bp trimmed when both strands go in, forward
    then reverse complement."""
    from fermi_tpu_torch.core import dna, fastx

    frags = []
    for rec in fastx.read_fastx(path):
        s = dna.encode(rec.seq)
        if cut_n:
            parts = [p[p != 5] for p in np.split(s, np.flatnonzero(s == 5))]
            parts = [p for p in parts if len(p)]
        else:
            # the reference's BCR randomizes ambiguous bases; N is kept
            parts = [s]
        for part in parts:
            if trim_pal and rev and fwd and dna.is_revcomp_palindrome(part):
                part = part[:-1]
            if fwd:
                frags.append(part)
            if rev:
                frags.append(dna.revcomp(part))
    return frags


def _rle6_bytes(runs) -> bytes:
    """`ropebwt -b`'s stream: "RLE\x06", then a byte (len << 3 | sym) per
    run of at most 31 symbols, longer runs cut into 31s first."""
    ln = np.asarray(runs.lengths, np.int64)
    sy = np.asarray(runs.symbols, np.int64)
    full = (ln - 1) // 31
    body = np.repeat(31 << 3 | sy, full + 1)
    ends = np.cumsum(full + 1) - 1
    body[ends] = (ln - 31 * full) << 3 | sy
    return b"RLE\x06" + body.astype(np.uint8).tobytes()


def _sais_runs(frags, device):
    """`ropebwt -a sais`: the runs of the strands' BWT, sorted on the
    device in one piece, or in spans cut at any sentinel and folded as
    `build` folds them (the text holds the strands one after another)
    when the one piece does not fit."""
    import os
    import tempfile
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.algos import merge as mg
    from fermi_tpu_torch.construct import blocked, suffix

    text = suffix.build_text(frags, both_strands=False,
                             trim_palindrome=False)
    cuts = _build_route("ropebwt", text, len(frags), False, device)
    if cuts is None:
        return rld.Runs.from_bwt(blocked.device_bwt(text, device))
    with tempfile.TemporaryDirectory() as tmp:
        fmd = os.path.join(tmp, "sais.fmd")
        mg.fold_spans(text, cuts, fmd, device=device, tag="ropebwt")
        return rld.read_fmd(fmd)


def cmd_ropebwt(args):
    """The multi-string BWT of the reads' strands by one of three
    interchangeable builders, which must agree bit for bit
    (fermi.1:581-628): the host rope (bpr), BCR on the device (bcr) and
    prefix doubling on the device (sais)."""
    from fermi_tpu_torch import resolve_device, rld
    from fermi_tpu_torch.core import dna

    device = None if args.algo == "bpr" else resolve_device(args.device)
    frags = _ropebwt_frags(args.fastx, args.cut_n, not args.no_trim_pal,
                          not args.no_fwd, not args.no_rev)
    if args.algo == "bpr":
        from fermi_tpu_torch.construct.bprope import bpr_bwt
        runs = rld.Runs.from_bwt(bpr_bwt(frags))
    elif args.algo == "bcr":
        from fermi_tpu_torch.construct.bcr_device import bcr_bwt_device
        runs = rld.Runs.from_bwt(bcr_bwt_device(frags, device))
    else:
        runs = _sais_runs(frags, device)
    if args.binary:
        data = _rle6_bytes(runs)
        if args.out == "-":
            sys.stdout.buffer.write(data)
            sys.stdout.buffer.flush()
        else:
            with open(args.out, "wb") as f:
                f.write(data)
    else:
        txt = dna.decode(runs.expand()) + "\n"
        if args.out == "-":
            sys.stdout.write(txt)
        else:
            with open(args.out, "w") as f:
                f.write(txt)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="fermi-tpu-torch",
        description="FMD-index build, search, error correction and "
                    "assembly on CUDA (fermi-compatible CLI)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for add in (_add_build, _add_unpack, _add_exact, _add_chkbwt,
                _add_correct, _add_seqsort, _add_unitig, _add_clean,
                _add_merge, _add_sub, _add_contrast, _add_bitand, _add_recode,
                _add_remap, _add_scaf, _add_sequtils, _add_example,
                _add_run, _add_ropebwt):
        add(sub)
    args = ap.parse_args(argv)
    ret = args.func(args)
    _telemetry_endline(argv)
    return ret


def _telemetry_endline(argv):
    """End-of-run telemetry on stderr, mirroring reference main.c:130-136:
    `[M::main] Version / CMD / Real time / CPU / RSS`."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    cpu = ru.ru_utime + ru.ru_stime
    rss_gb = ru.ru_maxrss / 1024.0 / 1024.0  # Linux: KB -> GB
    cmdline = " ".join(argv if argv is not None else sys.argv[1:])
    sys.stderr.write("[M::main] Version: fermi-tpu-torch\n")
    sys.stderr.write(f"[M::main] CMD: fermi-tpu-torch {cmdline}\n")
    sys.stderr.write(
        f"[M::main] Real time: {time.monotonic() - _T0:.3f} sec; "
        f"CPU: {cpu:.3f} sec; RSS: {rss_gb:.3f} GB\n")


if __name__ == "__main__":
    sys.exit(main())
