"""Assembly evaluation tools (the reference's misc/*.d rdmd scripts):

  sam2iden  — per-alignment identity table (misc/sam2iden.d)
  sam2break — misassembly break-point + N50 stats (misc/sam2break.d)
  asqg2mag  — SGA ASQG graph -> MAG converter (misc/asqg2mag.d)

The port's copy of fermi_tpu/misc/evaltools.py (host text code, the same
output bytes).  All read plain or gzipped files, `-` for standard input.
Run as `python -m fermi_tpu_torch.misc.evaltools <tool> [options] <file>`.
"""

import contextlib
import gzip
import io
import re
import sys


@contextlib.contextmanager
def _open(path):
    """Text lines of a plain or gzipped file (`-`: standard input)."""
    if path == "-":
        yield sys.stdin
        return
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
        f.seek(0)
        yield io.TextIOWrapper(gzip.GzipFile(fileobj=f) if gz else f)


_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar):
    """Returns dict(n_M, n_I, n_D, n_N, clip=[left, right])."""
    c = dict(n_M=0, n_I=0, n_D=0, n_N=0, clip=[0, 0])
    first = True
    for m in _CIG_RE.finditer(cigar):
        n, op = int(m.group(1)), m.group(2)
        if op in "SH":
            c["clip"][0 if first else 1] = n
        elif op == "M":
            c["n_M"] += n
        elif op == "I":
            c["n_I"] += n
        elif op == "D":
            c["n_D"] += n
        elif op == "N":
            c["n_N"] += n
        first = False
    return c


def sam2iden(path, out=None):
    """Per-alignment BLAST/BLAT identity (misc/sam2iden.d)."""
    out = out or sys.stdout
    with _open(path) as fp:
        for line in fp:
            if line.startswith("@"):
                continue
            t = line.rstrip("\n").split("\t")
            flag = int(t[1])
            if flag & 4:
                continue
            cs = parse_cigar(t[5])
            ndiff = 0
            for f in t[11:]:
                if f.startswith("NM:i:"):
                    ndiff = int(f[5:])
            qlen = cs["n_M"] + cs["clip"][0] + cs["clip"][1] + cs["n_I"]
            pos = int(t[3]) - 1
            if flag & 16:
                head = f"{cs['clip'][1]}\t{qlen - cs['clip'][0]}\t-"
            else:
                head = f"{cs['clip'][0]}\t{qlen - cs['clip'][1]}\t+"
            alen = qlen - cs["clip"][0] - cs["clip"][1]
            blast = (alen + cs["n_D"] - ndiff) / (alen + cs["n_D"])
            blat = ((alen - cs["n_I"] - (ndiff - cs["n_I"] - cs["n_D"]))
                    / (alen - cs["n_I"]))
            out.write(f"{t[0]}\t{head}\t{t[2]}\t{pos}\t"
                      f"{pos + cs['n_M'] + cs['n_D']}\t{t[4]}\t{blast}\t"
                      f"{blat}\n")


class _Aln:
    __slots__ = ("sam", "chr", "pos", "len", "qlen", "rlen", "flag", "mapq",
                 "qbeg", "clip")


def _parse_aln(line, t):
    p = _Aln()
    p.sam = line
    p.chr = t[2]
    p.pos = int(t[3]) - 1
    p.mapq = int(t[4])
    p.flag = int(t[1])
    if (p.flag & 4) == 0:
        cs = parse_cigar(t[5])
        p.qlen = cs["n_M"] + cs["n_I"]
        p.rlen = cs["n_M"] + cs["n_D"] + cs["n_N"]
        p.clip = list(cs["clip"])
        p.qbeg = p.clip[1 if (p.flag & 16) else 0]
        p.len = p.clip[0] + p.clip[1] + p.qlen
    else:
        p.clip = [0, 0]
        p.qbeg = 0
        p.qlen = p.rlen = 0
        p.len = len(line.split("\t")[9])
    return p


def sam2break(path, min_len=150, max_gap=500, min_q=10, mask_level=0.5,
              is_print=False, out=None):
    """Assembly break-point / N50 statistics (misc/sam2break.d)."""
    out = out or sys.stdout
    stats = dict(n_un=0, l_un=0, n_dropped=0, n_b=[0] * 5, n_bg=[0] * 5,
                 len=[])

    def count_break(c, a):
        b = [len(a), 0, 0, 0, 0]
        for p in a:
            if p.mapq < min_q:
                continue
            b[1] += 1
            if p.qlen >= 100:
                b[2] += 1
                if p.qlen >= 200:
                    b[3] += 1
                    if p.qlen >= 500:
                        b[4] += 1
        for i in range(5):
            if b[i]:
                c[i] += b[i] - 1

    def analyze(a):
        if len(a) == 1 and (a[0].flag & 4):
            stats["n_un"] += 1
            stats["l_un"] += a[0].len
            if is_print:
                out.write(a[0].sam)
            return
        if len(a) > 1:
            tmp = []
            for p in a:
                dropped = False
                for q in tmp:
                    beg = max(p.qbeg, q.qbeg)
                    end = min(p.qbeg + p.qlen, q.qbeg + q.qlen)
                    if beg < end and (end - beg) > p.qlen * mask_level:
                        dropped = True
                        break
                if not dropped:
                    tmp.append(p)
                else:
                    stats["n_dropped"] += 1
            a = tmp
            count_break(stats["n_b"], a)
        for p in a:
            stats["len"].append(p.qlen)
        if is_print:
            for p in a:
                out.write(p.sam)
        if len(a) > 1:
            a.sort(key=lambda x: (x.chr, x.pos))
            for i in range(1, len(a)):
                p, q = a[i], a[i - 1]
                if p.chr == q.chr and (p.flag & 16) == (q.flag & 16):
                    gapr = abs(p.pos - (q.pos + q.rlen))
                    gapq = abs(p.clip[0] - (q.clip[0] + q.qlen))
                    if gapr < max_gap and gapq < max_gap:
                        p.qlen = p.clip[0] + p.qlen - q.clip[0]
                        p.clip[0] = q.clip[0]
                        p.rlen = p.pos + p.rlen - q.pos
                        p.pos = q.pos
                        q.flag |= 4
            a = [p for p in a if (p.flag & 4) == 0]
            count_break(stats["n_bg"], a)

    last = None
    a = []
    with _open(path) as fp:
        for line in fp:
            if line.startswith("@"):
                if is_print:
                    out.write(line)
                continue
            t = line.rstrip("\n").split("\t")
            if t[0] != last:
                analyze(a)
                a = []
                last = t[0]
            p = _parse_aln(line, t)
            if p.len >= min_len:
                a.append(p)
    analyze(a)
    if not is_print:
        lens = sorted(stats["len"], reverse=True)
        L = sum(lens)
        n50 = 0
        acc = 0
        for x in lens:
            acc += x
            if acc >= L // 2:
                n50 = x
                break
        s = stats
        out.write(f"Number of unmapped contigs: {s['n_un']}\n")
        out.write(f"Total length of unmapped contigs: {s['l_un']}\n")
        out.write(f"Number of alignments dropped due to excessive overlaps: "
                  f"{s['n_dropped']}\n")
        out.write(f"Mapped contig bases: {L}\n")
        out.write(f"Mapped N50: {n50}\n")
        out.write(f"Number of break points: {s['n_b'][0]}\n")
        out.write(f"Number of Q{min_q} break points longer than "
                  f"(0,100,200,500)bp: ({s['n_b'][1]},{s['n_b'][2]},"
                  f"{s['n_b'][3]},{s['n_b'][4]})\n")
        out.write(f"Number of break points after patching gaps short than "
                  f"{max_gap}bp: {s['n_bg'][0]}\n")
        out.write(f"Number of Q{min_q} break points longer than "
                  f"(0,100,200,500)bp after gap patching: ({s['n_bg'][1]},"
                  f"{s['n_bg'][2]},{s['n_bg'][3]},{s['n_bg'][4]})\n")


def asqg2mag(path, out=None):
    """SGA ASQG graph -> MAG (misc/asqg2mag.d).  Raises ValueError on an
    overlap the MAG format cannot hold (gapped, or not end to end)."""
    out = out or sys.stdout
    v = {}
    seqs = []
    nei = []
    with _open(path) as fp:
        for line in fp:
            t = line.rstrip("\n").split()
            if not t:
                continue
            if t[0] == "VT":
                v[t[1]] = len(seqs)
                seqs.append(t[2])
                nei.append([[], []])
            elif t[0] == "ED":
                x = [int(t[i]) for i in range(3, 9)]
                x[1] += 1
                x[4] += 1
                o = x[1] - x[0]
                if o != x[4] - x[3]:
                    raise ValueError("gapped overlap not supported")
                id1, id2 = v[t[1]], v[t[2]]
                y1 = 0 if x[0] == 0 else (1 if x[2] - x[1] == 0 else -1)
                y2 = 0 if x[3] == 0 else (1 if x[5] - x[4] == 0 else -1)
                if y1 == -1 or y2 == -1:
                    raise ValueError("only end-to-end overlaps supported")
                nei[id1][y1].append((id2 << 1 | y2, o))
                nei[id2][y2].append((id1 << 1 | y1, o))
    for i, s in enumerate(seqs):
        fields = []
        for j in range(2):
            p = nei[i][j]
            fields.append("".join(f"{idd},{o};" for idd, o in p) if p
                          else ".")
        out.write(f">{i << 1}:{i << 1 | 1}\t1\t{fields[0]}\t{fields[1]}\n")
        out.write(s + "\n")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="fermi-tpu-torch-eval")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sam2iden")
    p.add_argument("sam")
    p = sub.add_parser("sam2break")
    p.add_argument("-l", dest="min_len", type=int, default=150)
    p.add_argument("-q", dest="min_q", type=int, default=10)
    p.add_argument("-m", dest="mask_level", type=float, default=0.5)
    p.add_argument("-g", dest="max_gap", type=int, default=500)
    p.add_argument("-p", dest="is_print", action="store_true")
    p.add_argument("sam")
    p = sub.add_parser("asqg2mag")
    p.add_argument("asqg")
    args = ap.parse_args(argv)
    if args.cmd == "sam2iden":
        sam2iden(args.sam)
    elif args.cmd == "sam2break":
        sam2break(args.sam, args.min_len, args.max_gap, args.min_q,
                  args.mask_level, args.is_print)
    elif args.cmd == "asqg2mag":
        asqg2mag(args.asqg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
