"""fermi-compatible command line of the port: build, unpack, exact.

The same arguments and output bytes as fermi_tpu's CLI (cli/main.py), which
mirrors reference main.c.  Each subcommand runs on CUDA unless
`--device cpu` (or another device) is given.
"""

import argparse
import sys
import time

import numpy as np

_T0 = time.monotonic()


def _not_ported(cmd, flag, item):
    sys.stderr.write(f"[E::{cmd}] {flag} is not ported to fermi_tpu_torch "
                     f"yet (ROADMAP queue 1, {item})\n")
    return 1


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
    import os
    from fermi_tpu_torch import resolve_device, rld
    from fermi_tpu_torch.core import dna, fastx
    from fermi_tpu_torch.construct import suffix
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device

    device = resolve_device(args.device)
    if args.append_to:
        return _not_ported("build", "-i (append)", "item 9, merge")
    if args.out != "-" and not args.force and os.path.exists(args.out):
        sys.stderr.write(f"[E::build] File `{args.out}' exists. Use -f to overwrite.\n")
        return 1
    seqs = []
    for rec in fastx.read_fastx(args.fastx):
        s = dna.encode(rec.seq)
        if args.max_len and len(s) > args.max_len:
            s = s[: args.max_len]
        seqs.append(s)
    text = suffix.build_text(seqs, trim_palindrome=not args.no_trim_pal)
    runs = rld.Runs.from_bwt(multistring_bwt_device(text, device))
    rld.write_fmd(runs, args.out, sbits=args.sbits)
    return 0


def _add_unpack(sub):
    p = sub.add_parser("unpack", help="retrieve DNA sequences from an index")
    p.add_argument("-i", dest="ids", type=int, action="append", default=[])
    p.add_argument("-M", dest="mmap", action="store_true",
                   help="query the compressed index via mmap (bounded RSS)")
    _device_arg(p)
    p.add_argument("fmd")
    p.set_defaults(func=cmd_unpack)


def cmd_unpack(args):
    from fermi_tpu_torch import resolve_device
    from fermi_tpu_torch.core import dna
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.search import extend as se

    device = resolve_device(args.device)
    if args.mmap:
        return _not_ported("unpack", "-M (mmap index)", "item 3c")
    idx = FMDIndex.restore(args.fmd, device)
    n = idx.n_seqs
    ids = [i for i in args.ids if i < n] if args.ids else range(n)
    ids = np.fromiter(ids, dtype=np.int64)
    for lo in range(0, len(ids), 4096):
        chunk = ids[lo: lo + 4096]
        seqs, ranks = se.retrieve_strings(idx, chunk, max_len=1 << 16)
        for s, k in zip(seqs, ranks):
            sys.stdout.write(f"{dna.decode(s)}\t{int(k)}\n")
    return 0


def _add_exact(sub):
    p = sub.add_parser("exact", help="find exact (supermaximal) matches")
    p.add_argument("-M", dest="mmap", action="store_true")
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

    device = resolve_device(args.device)
    if args.mmap:
        return _not_ported("exact", "-M (mmap index)", "item 3c")
    idx = FMDIndex.restore(args.fmd, device)
    recs = list(fastx.read_fastx(args.fastx))
    seqs = [dna.encode(r.seq) for r in recs]
    batch = 4096
    out = sys.stdout
    for lo in range(0, len(recs), batch):
        chunk = seqs[lo: lo + batch]
        matches = sm.smem_all(idx, chunk, self_match=args.self_match)
        for rec, s, mems in zip(recs[lo: lo + batch], chunk, matches):
            out.write(f"SQ\t{rec.name}\t{len(s)}\t{len(mems)}\n")
            for m in mems:
                out.write("EM\t" + sm.format_smem(idx, m) + "\n")
            out.write("//\n")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="fermi-tpu-torch",
        description="FMD-index build and search on CUDA (fermi-compatible CLI)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for add in (_add_build, _add_unpack, _add_exact):
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
