"""MAG assembly graph: I/O, simplification, bubble popping (`clean`).

The port's copy of fermi_tpu/algos/mag.py, host code as there (reference
mag.c + bubble.c semantics).  Vertices live in a flat list (deleted ones
keep their slot with length<0) so output order matches the reference
exactly. Edge x==-2 or y==0 means deleted.

SW scoring for bubble popping is the host `sw_score` (algos/ksw.py), as in
fermi_tpu; the output bytes equal fermi_tpu's `clean`.
"""

import sys
from dataclasses import dataclass, field

import numpy as np

from fermi_tpu_torch.algos.ksw import sw_score
from fermi_tpu_torch.core import dna

DEFAULT_OPT = dict(
    flag_read_ori=False, flag_clean=False, flag_aggressive=False,
    flag_no_amend=False, flag_no_simpl=False, flag_read_n_merge=True,
    max_arc=512, min_dratio0=0.7, n_iter=3, min_elen=300, min_ovlp=60,
    min_ensr=4, min_insr=3, min_dratio1=0.8, max_bcov=10.0, max_bfrac=0.15,
    max_bvtx=64, max_bdist=512,
)


def edge_is_del(a):
    return a[0] == -2 or a[1] == 0


def edge_mark_del(a):
    a[0] = -2
    a[1] = 0


def v128_clean(r):
    r[:] = [a for a in r if not edge_is_del(a)]


def v128_rmdup(r):
    if len(r) > 1:
        # ku128_xlt: x asc, then y desc (mag.c:21)
        r.sort(key=lambda a: (a[0] if a[0] >= 0 else 2**64 + a[0], -a[1]))
    cnt = 0
    l = 0
    while l < len(r) and edge_is_del(r[l]):
        cnt += 1
        l += 1
    if l == len(r):
        r.clear()
        return
    x = r[l][0]
    l += 1
    while l < len(r):
        if edge_is_del(r[l]) or r[l][0] == x:
            edge_mark_del(r[l])
            cnt += 1
        else:
            x = r[l][0]
        l += 1
    if cnt:
        v128_clean(r)


def v128_cap(r, max_arc):
    if len(r) <= max_arc:
        return
    r.sort(key=lambda a: -a[1])  # ku128_ylt: descending y
    thres = r[max_arc][1]
    for i, a in enumerate(r):
        if a[1] == thres:
            del r[i:]
            return


@dataclass
class MagVertex:
    len: int = -1
    nsr: int = 0
    k: list = field(default_factory=lambda: [0, 0])
    nei: list = field(default_factory=lambda: [[], []])
    seq: bytearray = field(default_factory=bytearray)  # nt6
    cov: bytearray = field(default_factory=bytearray)  # ASCII
    ptr: object = None


class Mag:
    def __init__(self):
        self.v: list[MagVertex] = []
        self.h: dict[int, int] = {}
        self.rdist = -1.0
        self.min_ovlp = 0

    # -- hash / id mapping ------------------------------------------------

    def build_hash(self):
        self.h = {}
        for i, p in enumerate(self.v):
            for j in range(2):
                if p.k[j] in self.h:
                    sys.stderr.write(
                        f"[W::mag] terminal {p.k[j]} is duplicated.\n")
                    self.h[p.k[j]] = -1
                else:
                    self.h[p.k[j]] = i << 1 | j

    def tid2idd(self, tid):
        return self.h[tid]

    # -- edge helpers -------------------------------------------------------

    def eh_add(self, u, v, ovlp):
        if u < 0:
            return
        idd = self.tid2idd(u)
        r = self.v[idd >> 1].nei[idd & 1]
        for a in r:
            if a[0] == v:
                return
        r.append([v, ovlp])

    def eh_markdel(self, u, v):
        if u < 0:
            return
        idd = self.tid2idd(u)
        for a in self.v[idd >> 1].nei[idd & 1]:
            if a[0] == v:
                edge_mark_del(a)

    def v_del(self, p: MagVertex):
        if p.len < 0:
            return
        for i in range(2):
            for a in p.nei[i]:
                if not edge_is_del(a) and a[0] != p.k[0] and a[0] != p.k[1]:
                    self.eh_markdel(a[0], p.k[i])
        for i in range(2):
            self.h.pop(p.k[i], None)
        p.len = -1
        p.nei = [[], []]
        p.seq = bytearray()
        p.cov = bytearray()

    def v_transdel(self, p: MagVertex, min_ovlp):
        if p.nei[0] and p.nei[1]:
            for a in p.nei[0]:
                if edge_is_del(a) or a[0] == p.k[0] or a[0] == p.k[1]:
                    continue
                for b in p.nei[1]:
                    if edge_is_del(b) or b[0] == p.k[0] or b[0] == p.k[1]:
                        continue
                    ovlp = int(a[1] + b[1]) - p.len
                    if ovlp >= min_ovlp:
                        self.eh_add(a[0], b[0], ovlp)
                        self.eh_add(b[0], a[0], ovlp)
        self.v_del(p)

    def v_flip(self, p: MagVertex):
        p.seq.reverse()
        p.seq = p.seq.translate(_NT6_COMP)
        p.cov.reverse()
        p.k[0], p.k[1] = p.k[1], p.k[0]
        p.nei[0], p.nei[1] = p.nei[1], p.nei[0]
        self.h[p.k[0]] ^= 1
        self.h[p.k[1]] ^= 1

    # -- unambiguous merge (mag.c:405-476) -----------------------------------

    def vh_merge_try(self, p: MagVertex) -> int:
        if len(p.nei[1]) != 1:
            return -1
        if p.nei[1][0][0] < 0:
            return -2
        kq = self.tid2idd(p.nei[1][0][0])
        q = self.v[kq >> 1]
        if p is q:
            return -3
        if len(q.nei[kq & 1]) != 1:
            return -4
        if kq & 1:
            self.v_flip(q)
        del self.h[p.k[1]]
        del self.h[q.k[0]]
        assert p.k[1] == q.nei[0][0][0] and q.k[0] == p.nei[1][0][0]
        assert p.nei[1][0][1] == q.nei[0][0][1]
        ov = p.nei[1][0][1]
        assert p.len >= ov and q.len >= ov
        p.nsr += q.nsr
        new_l = p.len + q.len - ov
        if ov:
            # bulk cov merge over the overlap (mag.c:431-436 per-byte loop)
            a = np.frombuffer(bytes(p.cov[p.len - ov:p.len]), np.uint8)
            b = np.frombuffer(bytes(q.cov[:ov]), np.uint8)
            merged = np.minimum(a.astype(np.int16) + b - 33, 126)
            p.cov[p.len - ov:p.len] = merged.astype(np.uint8).tobytes()
        p.seq += q.seq[ov:]
        p.cov += q.cov[ov:]
        p.len = new_l
        p.nei[1] = q.nei[1]
        p.k[1] = q.k[1]
        self.h[p.k[1]] = self._idx(p) << 1 | 1
        q.len = -1
        q.nei = [[], []]
        q.seq = bytearray()
        q.cov = bytearray()
        return 0

    def _idx(self, p):
        # vertex index: maintained via an id map to avoid O(n) list.index
        return self._index_of[id(p)]

    def _build_index_map(self):
        self._index_of = {id(p): i for i, p in enumerate(self.v)}

    def g_merge(self, rmdup):
        self._build_index_map()
        for p in self.v:
            if rmdup:
                v128_rmdup(p.nei[0])
                v128_rmdup(p.nei[1])
            else:
                v128_clean(p.nei[0])
                v128_clean(p.nei[1])
        for p in self.v:
            if p.len < 0:
                continue
            while self.vh_merge_try(p) == 0:
                pass
            self.v_flip(p)
            while self.vh_merge_try(p) == 0:
                pass

    # -- simple simplification (mag.c:484-535) --------------------------------

    def g_rm_vext(self, min_len, min_nsr):
        for p in self.v:
            if p.len >= 0 and (not p.nei[0] or not p.nei[1]) \
               and p.len < min_len and p.nsr < min_nsr:
                self.v_del(p)

    def g_rm_vint(self, min_len, min_nsr, min_ovlp):
        for p in self.v:
            if p.len >= 0 and p.len < min_len and p.nsr < min_nsr:
                self.v_transdel(p, min_ovlp)

    def g_rm_edge(self, min_ovlp, min_ratio, min_len, min_nsr):
        for p in self.v:
            if p.len >= 0 and (not p.nei[0] or not p.nei[1]) \
               and p.len < min_len and p.nsr < min_nsr:
                continue  # skip tips
            if p.len < 0:
                continue
            for j in range(2):
                r = p.nei[j]
                if not r:
                    continue
                max_ovlp, max_k = min_ovlp, -1
                for k, a in enumerate(r):
                    if max_ovlp < a[1]:
                        max_ovlp, max_k = a[1], k
                if max_k >= 0:
                    x = self.tid2idd(r[max_k][0])
                    q = self.v[x >> 1]
                    if q.len >= 0 and (not q.nei[0] or not q.nei[1]) \
                       and q.len < min_len and q.nsr < min_nsr:
                        max_ovlp = min_ovlp
                for a in r:
                    if edge_is_del(a):
                        continue
                    # mag.c divides as doubles: an overlap over a maximum
                    # of 0 (a tip's, reset to min_ovlp 0) is inf, never
                    # below min_ratio (fermi_tpu raises ZeroDivisionError)
                    if a[1] < min_ovlp or (max_ovlp != 0 and
                                           a[1] / max_ovlp < min_ratio):
                        self.eh_markdel(a[0], p.k[j])
                        edge_mark_del(a)

    # -- A-statistic (mag.c:544-586) ------------------------------------------

    def cal_rdist(self):
        n = len(self.v)
        srt = sorted(range(n), key=lambda i: (self.v[i].nsr << 32 | i))
        sum_n_all = sum(p.nsr for p in self.v)
        rdist = -1.0
        for _ in range(2):
            sum_n = sum_l = 0
            for i in range(n - 1, -1, -1):
                p = self.v[srt[i]]
                tmp1 = tmp2 = 0
                if p.nei[0]:
                    tmp1 += 1
                    tmp2 += p.nei[0][0][1]
                if p.nei[1]:
                    tmp1 += 1
                    tmp2 += p.nei[1][0][1]
                if tmp1:
                    tmp2 //= tmp1
                if rdist > 0.0:
                    A = (p.len - tmp1) / rdist - p.nsr * np.log(2)
                    if A < 20.0:
                        continue
                sum_n += p.nsr
                sum_l += p.len - tmp1
                if sum_n >= sum_n_all * 0.5:
                    break
            if sum_n:
                rdist = sum_l / sum_n
            elif sum_l == 0:
                rdist = float("nan")
            else:
                rdist = float("inf") if sum_l > 0 else float("-inf")
        self.rdist = rdist
        return rdist


# ---------------------------------------------------------------------------
# I/O
# ---------------------------------------------------------------------------

def _iter_mag_records(path):
    """4-line MAG records as (header_str, seq_bytes, cov_bytes).

    Bytes-mode reader: assembly-scale MAG files hold megabase seq/cov
    lines, and routing them through a utf-8 TextIOWrapper was most of
    the clean stage's parse time (BENCH_NOTES round 5).  Only the small
    header line is decoded."""
    import shutil
    import subprocess

    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    proc = None
    if magic == b"\x1f\x8b":
        if shutil.which("gzip"):
            f.close()
            proc = subprocess.Popen(["gzip", "-dc", "--", path],
                                    stdout=subprocess.PIPE, bufsize=1 << 22)
            f = proc.stdout
        else:
            import gzip as _g
            f = _g.GzipFile(fileobj=f)
    try:
        while True:
            hdr = f.readline()
            if not hdr:
                break
            if hdr[:1] != b"@":
                continue
            seq = f.readline().rstrip(b"\n")
            f.readline()                      # '+'
            cov = f.readline().rstrip(b"\n")
            yield hdr[1:].rstrip(b"\n").decode(), seq, cov
    finally:
        f.close()
        if proc is not None:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            elif proc.wait() != 0:
                raise OSError(f"gzip -dc exited with {proc.returncode}")


def mag_read(path, opt) -> Mag:
    """Parse a MAG file applying read-time filters (mag.c:190-285)."""
    g = Mag()
    is_mod = False
    for header, seq_b, cov_b in _iter_mag_records(path):
        p = MagVertex()
        name, *fields = header.split("\t")
        k0, k1 = name.split(":")
        p.k = [int(k0), int(k1)]
        p.nsr = int(fields[0])
        q_fields = fields[1:3]
        for j in range(2):
            nei = []
            mx = mx2 = 0
            if q_fields[j] != ".":
                for part in q_fields[j].split(";"):
                    if not part:
                        continue
                    xs, ys = part.split(",")
                    x, y = int(xs), int(ys)
                    if g.min_ovlp > y:
                        g.min_ovlp = y
                    if mx < y:
                        mx = y          # (mx2 never promoted: bug-compatible
                    elif mx2 < y:       #  with mag.c:232 `max = max2, max = r->y`)
                        mx2 = y
                    nei.append([x, y])
            if not opt["flag_read_ori"]:
                thres = int(mx2 * opt["min_dratio0"] + 0.499)
                for a in nei:
                    if a[1] < thres:
                        is_mod = True
                        a[1] = 0
                v128_rmdup(nei)
                if len(nei) > opt["max_arc"]:
                    is_mod = True
                    v128_cap(nei, opt["max_arc"])
            p.nei[j] = nei
        p.len = len(seq_b)
        if not opt["flag_read_ori"] and (not p.nei[0] or not p.nei[1]) \
           and p.len < opt["min_elen"] and p.nsr == 1:
            is_mod = True
            continue
        p.seq = bytearray(seq_b.translate(dna.NT6_BYTES))
        p.cov = bytearray(cov_b if cov_b else b'"' * p.len)
        g.v.append(p)
    g.build_hash()
    if is_mod or not opt["flag_no_amend"]:
        mag_amend(g)
    g.cal_rdist()
    if opt["flag_read_n_merge"]:
        g.g_merge(True)
    return g


def mag_amend(g: Mag):
    """Drop arcs without a reciprocal edge (mag.c:119-143)."""
    for p in g.v:
        for j in range(2):
            for a in p.nei[j]:
                x = a[0]
                idd = g.h.get(x)
                if idd is None:
                    edge_mark_del(a)
                    continue
                r = g.v[idd >> 1].nei[idd & 1]
                if not any(b[0] == p.k[j] for b in r):
                    edge_mark_del(a)
            v128_rmdup(p.nei[j])


def mag_print(g: Mag, out):
    for p in g.v:
        if p.len < 0:
            continue
        out.write(mag_v_text(p))


# nt6 -> printable base, bulk-translated (mag.c:149-174 prints "$ACGTN"[c])
_NT6_PRINT = bytes.maketrans(bytes(range(6)), b"$ACGTN")
# nt6 complement (fermi.h:52: fm6_comp is 5-c for A..T, fixed points 0/5)
_NT6_COMP = bytes.maketrans(bytes(range(6)), bytes([0, 4, 3, 2, 1, 5]))


def mag_v_text(p: MagVertex) -> str:
    if p.len <= 0:
        return ""
    parts = [f"@{p.k[0]}:{p.k[1]}\t{p.nsr}"]
    for j in range(2):
        field_txt = "".join(
            f"{a[0]},{np.int32(a[1] & 0xffffffff)};" for a in p.nei[j]
            if not edge_is_del(a))
        parts.append(field_txt if p.nei[j] else ".")
    head = "\t".join(parts)
    seq = p.seq.translate(_NT6_PRINT).decode("latin1")
    cov = p.cov.decode("latin1")
    return f"{head}\n{seq}\n+\n{cov}\n"


# ---------------------------------------------------------------------------
# Bubbles (bubble.c)
# ---------------------------------------------------------------------------

MAX_N_DIFF = 2.01
MAX_R_DIFF = 0.1
L_DIFF_COEF = 0.2
INT_MIN = -(2 ** 31)


class _TriInfo:
    __slots__ = ("id", "cnt", "n", "d", "v")

    def __init__(self, vid):
        self.id = vid
        self.cnt = [0, 0]
        self.n = [[INT_MIN, INT_MIN], [INT_MIN, INT_MIN]]
        self.d = [[INT_MIN, INT_MIN], [INT_MIN, INT_MIN]]
        self.v = [[-1, -1], [-1, -1]]


def _backtrace(g, end, start, marked):
    while (end >> 32) != start:
        marked.add(end >> 33)
        p = g.v[end >> 33]
        end = p.ptr.v[((end >> 32) ^ 1) & 1][end & 1]


def vh_simplify_bubble(g: Mag, idd, max_vtx, max_dist):
    p = g.v[idd >> 1]
    if p.len < 0 or len(p.nei[idd & 1]) < 2:
        return
    pool = []
    stack = []
    marked = set()
    n_pending = 0
    p.ptr = _TriInfo(idd >> 1)
    pool.append(p.ptr)
    p.ptr.d[(idd & 1) ^ 1][0] = -p.len
    p.ptr.n[(idd & 1) ^ 1][0] = -p.nsr
    stack.append(idd ^ 1)
    while stack:
        if len(stack) == 1 and stack[0] != (idd ^ 1) and n_pending == 0:
            break
        x = stack.pop()
        p2 = g.v[x >> 1]
        r = p2.nei[(x & 1) ^ 1]
        if len(pool) > max_vtx or p2.ptr.d[x & 1][0] > max_dist \
           or p2.ptr.d[x & 1][1] > max_dist or not r:
            break
        for i, a in enumerate(r):
            if a[0] < 0:
                continue
            y = g.tid2idd(a[0])
            if y == (idd ^ 1):
                stack.clear()
                break
            q = g.v[y >> 1]
            if q.ptr is None:
                q.ptr = _TriInfo(y >> 1)
                pool.append(q.ptr)
                n_pending += 1
                v128_clean(q.nei[y & 1])
            nsr = p2.ptr.n[x & 1][0] + p2.nsr
            which = 0
            dist = p2.ptr.d[x & 1][0] + p2.len - a[1]
            tq = q.ptr
            if nsr > tq.n[y & 1][0]:
                tq.n[y & 1][1] = tq.n[y & 1][0]
                tq.n[y & 1][0] = nsr
                tq.v[y & 1][1] = tq.v[y & 1][0]
                tq.v[y & 1][0] = (x ^ 1) << 32 | i << 1 | which
                tq.d[y & 1][1] = tq.d[y & 1][0]
                tq.d[y & 1][0] = dist
                nsr = p2.ptr.n[x & 1][1] + p2.nsr
                which = 1
                dist = p2.ptr.d[x & 1][1] + p2.len - a[1]
            if nsr > tq.n[y & 1][1]:
                tq.n[y & 1][1] = nsr
                tq.v[y & 1][1] = (x ^ 1) << 32 | i << 1 | which
                tq.d[y & 1][1] = dist
            tq.cnt[y & 1] += 1
            if tq.cnt[y & 1] == len(q.nei[y & 1]):
                stack.append(y)
                n_pending -= 1
    if n_pending == 0 and len(stack) == 1:
        x = stack[0]
        p2 = g.v[x >> 1]
        _backtrace(g, p2.ptr.v[x & 1][0], idd, marked)
        _backtrace(g, p2.ptr.v[x & 1][1], idd, marked)
    for t in pool:
        g.v[t.id].ptr = None
    if marked:
        for t in pool[1:]:
            if t.id != (stack[0] >> 1 if stack else -1) and t.id not in marked:
                g.v_del(g.v[t.id])


def g_simplify_bubble(g: Mag, max_vtx, max_dist):
    for i in range(len(g.v)):
        vh_simplify_bubble(g, i << 1 | 0, max_vtx, max_dist)
        vh_simplify_bubble(g, i << 1 | 1, max_vtx, max_dist)
    g.g_merge(False)


def vh_pop_simple(g: Mag, idd, max_cov, max_frac, aggressive):
    p = g.v[idd >> 1]
    if p.len < 0 or len(p.nei[idd & 1]) != 2:
        return
    r = p.nei[idd & 1]
    q = [None, None]
    direc = [0, 0]
    l = [0, 0]
    max_n_diff = MAX_N_DIFF * 2.0 if aggressive else MAX_N_DIFF
    for j in range(2):
        if r[j][0] < 0:
            return
        x = g.tid2idd(r[j][0])
        direc[j] = x & 1
        q[j] = g.v[x >> 1]
        if len(q[j].nei[0]) != 1 or len(q[j].nei[1]) != 1:
            return
        l[j] = q[j].len - int(q[j].nei[0][0][1] + q[j].nei[1][0][1])
    if q[0].nei[direc[0] ^ 1][0][0] != q[1].nei[direc[1] ^ 1][0][0]:
        return
    seq = [None, None]
    avg = [0.0, 0.0]
    for j in range(2):
        if l[j] > 0:
            o = q[j].nei[0][0][1]
            sj = np.frombuffer(bytes(q[j].seq[o:o + l[j]]), np.uint8).copy()
            cj = np.frombuffer(bytes(q[j].cov[o:o + l[j]]), np.uint8).copy()
            if direc[j]:
                sj = dna.revcomp(sj)
                cj = cj[::-1].copy()
            seq[j] = sj - 1  # DNA6 -> DNA4
            avg[j] = float((cj - 33).sum()) / l[j]
        else:
            beg = q[j].nei[0][0][1]
            end = q[j].len - q[j].nei[1][0][1]
            if beg > end:
                beg, end = end, beg
            if beg < end:
                cj = np.frombuffer(bytes(q[j].cov[beg:end]), np.uint8)
                avg[j] = float((cj - 33).sum()) / (end - beg)
            else:
                avg[j] = q[j].cov[beg] - 33
    if l[0] > 0 and l[1] > 0:
        score = sw_score(seq[0], seq[1])
        n_diff = (min(l[0], l[1]) * 5.0 - score) / (5.0 + 4.0)
        r_diff = n_diff / ((l[0] + l[1]) / 2.0)
    else:
        n_diff = abs(l[0] - l[1]) * L_DIFF_COEF
        r_diff = 1.0
    if n_diff < max_n_diff or r_diff < MAX_R_DIFF:
        j = 0 if avg[0] < avg[1] else 1
        if aggressive or (avg[j] < max_cov
                          and avg[j] / (avg[j ^ 1] + avg[j]) < max_frac):
            g.v_del(q[j])


def g_pop_simple(g: Mag, max_cov, max_frac, aggressive):
    for i in range(len(g.v)):
        vh_pop_simple(g, i << 1 | 0, max_cov, max_frac, aggressive)
        vh_pop_simple(g, i << 1 | 1, max_cov, max_frac, aggressive)
    g.g_merge(False)


def v_pop_open(g: Mag, p: MagVertex, min_elen):
    if p.len < 0 or p.len >= min_elen:
        return
    if len(p.nei[0]) + len(p.nei[1]) != 1:
        return
    direc = 0 if p.nei[0] else 1
    s = p.nei[direc]
    for lidx in range(len(s)):
        a = s[lidx]
        if a[0] < 0:
            continue
        v = g.tid2idd(a[0])
        q = g.v[v >> 1]
        if q is p or len(q.nei[v & 1]) == 1:
            continue
        max_l = (p.len - a[1]) * 2
        pseq = np.frombuffer(bytes(p.seq), np.uint8)
        if direc == 0:
            qry = pseq[a[1]:].astype(np.int8) - 1
        else:
            qry = (4 - pseq[: p.len - a[1]][::-1]).astype(np.int8)
        l_qry = len(qry)
        r = q.nei[v & 1]
        hit = False
        for b in r:
            if b[0] == p.k[direc] or b[0] < 0:
                continue
            w = g.tid2idd(b[0])
            t = g.v[w >> 1]
            tseq = np.frombuffer(bytes(t.seq), np.uint8)
            if w & 1:
                tgt = (4 - tseq[: t.len - b[1]][::-1][:max_l]).astype(np.int8)
            else:
                tgt = (tseq[b[1]:][:max_l]).astype(np.int8) - 1
            score = sw_score(qry, tgt)
            if score >= l_qry * 5 // 2:
                n_diff = (l_qry * 5.0 - score) / (5.0 + 4.0)
                r_diff = n_diff / l_qry
                if n_diff < MAX_N_DIFF or r_diff < MAX_R_DIFF:
                    hit = True
                    break
        if hit:
            edge_mark_del(a)
            for b in r:
                if b[0] == p.k[direc]:
                    edge_mark_del(b)
    if all(edge_is_del(a) for a in s):
        g.v_del(p)


def g_pop_open(g: Mag, min_elen):
    for p in g.v:
        v_pop_open(g, p, min_elen)
    g.g_merge(False)


# ---------------------------------------------------------------------------
# Clean driver (mag.c:615-673)
# ---------------------------------------------------------------------------

def g_clean(g: Mag, opt):
    if not opt["flag_clean"]:
        return
    if g.min_ovlp < opt["min_ovlp"]:
        g.min_ovlp = opt["min_ovlp"]
    g.g_rm_vext(opt["min_elen"], min(opt["min_ensr"], 3))
    for j in range(opt["n_iter"]):
        r = 1.0 if opt["n_iter"] == 1 else 0.5 + 0.5 * j / (opt["n_iter"] - 1)
        g.g_rm_edge(int(opt["min_ovlp"] * r), opt["min_dratio1"] * r,
                    opt["min_elen"], opt["min_ensr"])
        # bug-compatible with mag.c:634: the ternary's true-branch is the
        # comparison itself, so min_nsr is 1 when min_ensr*r > 2, else 2
        g.g_rm_vext(int(opt["min_elen"] * r),
                    1 if opt["min_ensr"] * r > 2.0 else 2)
        g.g_merge(True)
    for j in range(opt["n_iter"]):
        g.g_rm_vext(opt["min_elen"], opt["min_ensr"])
        g.g_merge(False)
    if opt["flag_aggressive"]:
        g_pop_open(g, opt["min_elen"])
    if not opt["flag_no_simpl"]:
        g_simplify_bubble(g, opt["max_bvtx"], opt["max_bdist"])
    g_pop_simple(g, opt["max_bcov"], opt["max_bfrac"], opt["flag_aggressive"])
    if opt["min_insr"] >= 2:
        g.g_rm_vint(opt["min_elen"], opt["min_insr"], g.min_ovlp)
        g.g_rm_edge(opt["min_ovlp"], opt["min_dratio1"], opt["min_elen"],
                    opt["min_ensr"])
        g.g_rm_vext(opt["min_elen"], opt["min_ensr"])
        g.g_merge(True)
    if opt["flag_aggressive"]:
        g_pop_open(g, opt["min_elen"])
    else:
        g.g_rm_vext(opt["min_elen"], opt["min_ensr"])
        g.g_merge(False)
