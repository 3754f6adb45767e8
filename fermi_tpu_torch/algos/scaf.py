"""Paired-end scaffolding (reference scaf.c): reciprocal-best mate links
between unitigs, gap patching by in-process mini-assembly of mate reads, and
scaftig emission.

The port of fermi_tpu/algos/scaf.py, with its output bytes and its `SW`
stderr lines.  The link-collection hash `t` must be pykhash (bucket
iteration order decides ties between equal link weights); local assemblies
reuse the unitig + mag machinery (fm6_api_unitig); the SW fallback uses
algos.ksw.ksw_align with reference-exact coordinates.

Two places differ in design from fermi_tpu, not in bytes:

- The mates come from the device index.  `patch_gap`'s conditions read only
  the links, which are fixed once `collect_nei` and `resolve_contained`
  have run, so every mate read a gap can ask for is known before the gap
  loop: `scaf_core` retrieves them all in batches through
  search/extend.retrieve (LF walks, kernel K1 on the card).  fermi_tpu walks
  them one read at a time on a host mirror of the whole index.
- A local assembly's BWT is sorted on the index's device
  (construct/suffix_device.py), then wrapped in a HostIndex for the host
  unitig walk.

STATS holds the last `scaf_core` call's counts and seconds by part.
"""

import math
import sys
import time

import numpy as np
import torch

from fermi_tpu_torch.algos import mag as M
from fermi_tpu_torch.algos.hostindex import HostIndex
from fermi_tpu_torch.algos.ksw import ksw_align
from fermi_tpu_torch.algos.pykhash import KHash64
from fermi_tpu_torch.algos.unitig import UnitigBuilder
from fermi_tpu_torch.construct import suffix
from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device
from fermi_tpu_torch.core import dna
from fermi_tpu_torch.search import extend

# a mate walk's first bound (a longer read walks on, the bound doubling)
MATE_BOUND = 1024
MATE_CHUNK = 1 << 16    # mate reads retrieved in one batch of walks, at most

STATS = {}

A_THRES = 20.0
M_LN2 = math.log(2.0)

def _cdiv(a, b):
    """C double division semantics: x/0 -> ±inf, 0/0 -> nan (the reference
    hits these in degenerate A-stat passes and keeps going)."""
    if b:
        return a / b
    if a == 0:
        return float("nan")
    return float("inf") if a > 0 else float("-inf")


class Utig:
    __slots__ = ("k", "ext", "A", "len", "nsr", "maxo", "deleted", "excluded",
                 "seq", "reads", "dist", "dist2", "nei", "nei2")

    def __init__(self):
        self.k = [0, 0]
        self.ext = [None, None]   # ext entries: dict(l, patched, t, s)
        self.A = 0.0
        self.len = 0
        self.nsr = 0
        self.maxo = 0
        self.deleted = False
        self.excluded = False
        self.seq = b""            # nt6 bytes
        self.reads = []           # (x, y) with y = b<<32|e
        self.dist = [0, 0]
        self.dist2 = [0, 0]
        self.nei = [-1, -1]
        self.nei2 = [-1, -1]


def read_utig(path):
    from fermi_tpu_torch.core import fastx

    v = []
    for rec in fastx.read_fastx(path):
        if not rec.comment or "UR:Z:" not in rec.comment:
            continue
        ur = rec.comment.split("UR:Z:", 1)[1]
        nsr = int(rec.comment.split("\t", 1)[0])
        p = Utig()
        k0, k1 = rec.name.split(":")
        p.k = [int(k0), int(k1)]
        p.nsr = nsr
        beg, end = 0, len(rec.seq)
        if rec.qual:
            ql = len(rec.qual)
            i = 0
            while i < ql and rec.qual[i] == '"':
                i += 1
            beg = i
            i = ql - 1
            while i >= 0 and rec.qual[i] == '"':
                i -= 1
            end = i + 1
            if beg >= end:
                beg, end = 0, len(rec.seq)
        p.len = end - beg
        p.seq = dna.encode(rec.seq[beg:end]).tobytes()
        # maxo via the reference's pointer walk (scaf.c:89-99): the j=0 pass
        # consumes only the tab after nsr, so in practice only the nei0 field
        # is ever parsed — bug-compatible
        c = rec.comment
        qq = 0
        while qq < len(c) and (c[qq].isdigit() or c[qq] == "-"):
            qq += 1  # skip the nsr integer (strtol end position)
        for _ in range(2):
            if qq < len(c) and c[qq] != ".":
                while qq < len(c) and (c[qq].isdigit() or c[qq] == "-"):
                    while qq < len(c) and (c[qq].isdigit() or c[qq] == "-"):
                        qq += 1  # x
                    qq += 1      # ','
                    o_start = qq
                    while qq < len(c) and (c[qq].isdigit() or c[qq] == "-"):
                        qq += 1  # o
                    o = int(c[o_start:qq] or 0)
                    qq += 1      # ';'
                    p.maxo = max(p.maxo, o)
                qq += 1
            else:
                qq += 2
        # parse UR read mappings
        for part in ur.split(";"):
            if not part or not part[0].isdigit():
                break
            x_s, b_s, e_s = part.split(",")
            x, b, e = int(x_s), int(b_s), int(e_s)
            y = (b - beg if b > beg else 0) << 32 | (
                e - beg if e - beg < p.len else p.len)
            p.reads.append((x, y))
        v.append(p)
    return v


def cal_rdist(v):
    srt = sorted(range(len(v)), key=lambda i: (v[i].nsr << 32 | i))
    sum_n_all = sum(p.nsr for p in v)
    rdist = -1.0
    for _ in range(2):
        sum_n = sum_l = 0
        for i in range(len(v) - 1, -1, -1):
            p = v[srt[i]]
            if rdist > 0.0 and (p.len - p.maxo) / rdist - p.nsr * M_LN2 < A_THRES:
                continue
            sum_n += p.nsr
            sum_l += p.len - p.maxo
            if sum_n >= sum_n_all * 0.5:
                break
        rdist = _cdiv(sum_l, sum_n)
    sum_ovlp = n_ovlp = 0
    for p in v:
        if p.maxo:
            n_ovlp += 1
            sum_ovlp += p.maxo
    # bug-compatible with scaf.c:181: n_ovlp==0 gives (int)(nan+.499), which
    # on x86 is INT_MIN, and (len - INT_MIN) then wraps as int32
    avg_ovlp = int(sum_ovlp / n_ovlp + 0.499) if n_ovlp else -(2 ** 31)
    for p in v:
        eff = p.maxo if p.maxo else avg_ovlp
        diff = int(np.int32(np.int64(p.len - eff) & 0xFFFFFFFF))
        p.A = _cdiv(diff, rdist) if rdist == 0 else diff / rdist
        p.A -= p.nsr * M_LN2
    return rdist


def collect_nei(v, max_dist):
    h = {}
    order = []  # preserve insertion only for determinism of nothing; dict ok
    for i, p in enumerate(v):
        if p.excluded:
            continue
        for (x, y) in p.reads:
            idd = i << 1 | ((x & 1) ^ 1)
            if x & 1:
                dist = y & 0xFFFFFFFF
            else:
                dist = p.len - (y >> 32)
            if dist > max_dist:
                continue
            key = x >> 1
            if key in h:
                h[key] = 0  # mark delete
            else:
                h[key] = idd << 32 | dist
    for key in [k for k, val in h.items() if val == 0]:
        del h[key]

    t = KHash64()
    for i, p in enumerate(v):
        for a in range(2):
            if t.n_buckets >= 32:
                t = KHash64()
            else:
                t.clear()
            for (x, y) in p.reads:
                val = h.get(x >> 1)
                if val is None or (val >> 32 & 1) != a:
                    continue
                dist = val & 0xFFFFFFFF
                val2 = h.get((x >> 1) ^ 1)
                if val2 is None:
                    continue
                q = v[val2 >> 33]
                if p is q:
                    continue
                dist += val2 & 0xFFFFFFFF
                kk, absent = t.put(val2 >> 32)
                if absent:
                    t.vals[kk] = (1 << 40) | dist
                else:
                    t.vals[kk] += (1 << 40) | dist
            for key, val in t.items_in_bucket_order():
                if val >> 40 < 1:
                    continue
                if val >= p.dist[a]:
                    p.dist2[a], p.nei2[a] = p.dist[a], p.nei[a]
                    p.dist[a], p.nei[a] = val, key
                elif val >= p.dist2[a]:
                    p.dist2[a], p.nei2[a] = val, key
    for p in v:
        for a in range(2):
            if p.dist[a]:
                cnt = p.dist[a] >> 40
                s = p.dist[a] & ((1 << 40) - 1)
                p.dist[a] = cnt << 40 | int(s / cnt + 0.499)
            if p.dist2[a]:
                cnt = p.dist2[a] >> 40
                s = p.dist2[a] & ((1 << 40) - 1)
                p.dist2[a] = cnt << 40 | int(s / cnt + 0.499)
    return h


def resolve_contained(v, i, avg, std, pr_links):
    p = v[i]
    if p.excluded or p.nei[0] < 0 or p.nei[1] < 0 or p.nei2[0] >= 0 \
       or p.nei2[1] >= 0:
        return
    q = [v[p.nei[0] >> 1], v[p.nei[1] >> 1]]
    if q[0].nei2[p.nei[0] & 1] < 0 or q[1].nei2[p.nei[1] & 1] < 0:
        return
    if q[1].nei[p.nei[1] & 1] != p.nei[0] \
       and q[1].nei2[p.nei[1] & 1] != p.nei[0]:
        return
    if q[0].nei[p.nei[0] & 1] == p.nei[1]:
        d_long = int(avg - (q[0].dist[p.nei[0] & 1] & ((1 << 40) - 1)) + 0.499)
    elif q[0].nei2[p.nei[0] & 1] == p.nei[1]:
        d_long = int(avg - (q[0].dist2[p.nei[0] & 1] & ((1 << 40) - 1)) + 0.499)
    else:
        return
    d_short = int(2 * avg - (p.dist[0] & ((1 << 40) - 1))
                  - (p.dist[1] & ((1 << 40) - 1)) + p.len + 0.499)
    if abs(d_long - d_short) < std and pr_links:
        sys.stderr.write(f"CT\t{p.k[0]}:{p.k[1]}\t{d_long}\t{d_short}\n")
        for a in range(2):
            qa = q[a]
            if qa.nei[p.nei[a] & 1] == p.nei[a ^ 1]:
                qa.nei[p.nei[a] & 1] = qa.nei2[p.nei[a] & 1]
                qa.dist[p.nei[a] & 1] = qa.dist2[p.nei[a] & 1]
            qa.nei2[p.nei[a] & 1] = -4
            qa.dist2[p.nei[a] & 1] = 0


# ---------------------------------------------------------------------------
# Incomplete beta (reference scaf.c:290-335)
# ---------------------------------------------------------------------------

def kf_lgamma(z):
    x = 0.0
    x += 0.1659470187408462e-06 / (z + 7)
    x += 0.9934937113930748e-05 / (z + 6)
    x -= 0.1385710331296526 / (z + 5)
    x += 12.50734324009056 / (z + 4)
    x -= 176.6150291498386 / (z + 3)
    x += 771.3234287757674 / (z + 2)
    x -= 1259.139216722289 / (z + 1)
    x += 676.5203681218835 / z
    x += 0.9999999999995183
    return math.log(x) - 5.58106146679532777 - z + (z - 0.5) * math.log(z + 6.5)


def _kf_betai_aux(a, b, x):
    if x == 0.0:
        return 0.0
    if x == 1.0:
        return 1.0
    f = 1.0
    C = f
    D = 0.0
    TINY = 1e-290
    for j in range(1, 200):
        m = j >> 1
        if j & 1:
            aa = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
        else:
            aa = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        D = 1.0 + aa * D
        if D < TINY:
            D = TINY
        C = 1.0 + aa / C
        if C < TINY:
            C = TINY
        D = 1.0 / D
        d = C * D
        f *= d
        if abs(d - 1.0) < 1e-14:
            break
    return math.exp(kf_lgamma(a + b) - kf_lgamma(a) - kf_lgamma(b)
                    + a * math.log(x) + b * math.log(1.0 - x)) / a / f


def kf_betai(a, b, x):
    return _kf_betai_aux(a, b, x) if x < (a + 1.0) / (a + b + 2.0) \
        else 1.0 - _kf_betai_aux(b, a, 1.0 - x)


# ---------------------------------------------------------------------------
# Gap closure
# ---------------------------------------------------------------------------

def end_seq(p: Utig, is3, is_2nd, max_dist):
    if p.len > max_dist:
        s = p.seq[p.len - max_dist:] if is3 else p.seq[:max_dist]
    else:
        s = p.seq
    arr = np.frombuffer(s, np.uint8)
    if (not is3) ^ (bool(is_2nd)):
        arr = dna.revcomp(arr)
    return arr.tobytes()


def add_seq(mates, h, p: Utig, idd_self, idd_mate):
    """Mate sequences of reads supporting the link, in p.reads order (blob
    order decides read ids in the local index, and read ids break ties);
    returns (blob, max_len) where blob is the concatenation of
    0-terminated forward sequences.  mates maps a read's sentinel rank to
    its sequence (retrieve_mates)."""
    out = []
    max_len = 0
    for (x, y) in p.reads:
        val = h.get(x >> 1)
        if val is None or val >> 32 != idd_self:
            continue
        if idd_mate >= 0:
            val2 = h.get((x >> 1) ^ 1)
            if val2 is None or val2 >> 32 != idd_mate:
                continue
        seq = mates[x ^ 3]
        if len(seq) > max_len:
            max_len = len(seq)
        out.append(seq)
        out.append(b"\x00")
    return b"".join(out), max_len


def correct_mean(l, mu, sigma):
    x = (l - mu) / sigma
    y = math.sqrt(2.0) / (2.0 / math.sqrt(math.pi)) * math.erfc(x / math.sqrt(2.0))
    z = math.exp(-0.5 * x * x)
    return mu + sigma * y / (z - x * y)


def compute_t(h, v, idd, l, mu, sigma, max_len):
    p = v[idd >> 1]
    if p.nei[idd & 1] < 0:
        return 0.0
    s = s2 = n = 0
    mu_ = correct_mean(2 * max_len + l, mu, sigma)
    for (x, y) in p.reads:
        val = h.get(x >> 1)
        if val is None:
            continue
        dist = val & 0xFFFFFFFF
        val2 = h.get((x >> 1) ^ 1)
        if val2 is None or val2 >> 32 != p.nei[idd & 1]:
            continue
        dist += val2 & 0xFFFFFFFF
        dist += l
        n += 1
        s += dist
        s2 += dist * dist
    assert n >= 2
    avg = s / n
    t = math.sqrt((s2 / n - avg * avg) / (n - 1))
    t = (avg - mu_) / t
    n -= 1
    if n > 50:
        n = 50
    return kf_betai(0.5 * n, 0.5, n / (n + t * t))


def fm6_api_unitig(min_match, blob: bytes, device):
    """In-process mini assembly (reference unitig.c:413-434 + fm6_build2):
    blob = concatenated 0-terminated nt6 reads; returns a Mag graph.  The
    BWT is sorted on `device`; the unitig walk runs on the host."""
    seqs = [np.frombuffer(s, np.uint8) for s in blob.split(b"\x00") if s]
    text = suffix.build_text(seqs, trim_palindrome=False)
    t0 = time.perf_counter()
    bwt = multistring_bwt_device(text, device)
    STATS["mini_bwt_s"] = STATS.get("mini_bwt_s", 0.0) + (
        time.perf_counter() - t0)
    STATS["mini_bwts"] = STATS.get("mini_bwts", 0) + 1
    e = HostIndex(bwt)
    ub = UnitigBuilder(e, min_match, None)
    # every seed's read up front in one vectorized walk (the reads never
    # change, so the seed order and the results are those of one walk each)
    ub.prefetch_retrieves()
    g = M.Mag()
    n1 = e.n_seqs
    for j in range(0, (n1 >> 2) + 1):
        for i in range(j << 2 | 1, min((j << 2) + 4, n1), 2):
            z = ub.unitig1(i)
            if z is None:
                continue
            k0, k1 = z["k"]
            if ub.visited[k0] or ub.visited[k1]:
                continue
            ub.visited[k0] = ub.visited[k1] = True
            p = M.MagVertex()
            p.len = len(z["seq"])
            p.nsr = z["nsr"]
            p.k = [k0, k1]
            p.nei = [[[x, y] for x, y in z["nei"][0]],
                     [[x, y] for x, y in z["nei"][1]]]
            p.seq = bytearray(bytes(z["seq"]))
            p.cov = bytearray(bytes(z["cov"]))
            g.v.append(p)
    g.build_hash()
    return g


def assemble(blob: bytes, max_len, t0: bytes, t1: bytes, device):
    """Reference assemble() (scaf.c:408-454): mini assembly + cleanup, then
    locate the two flanks in the longest contig."""
    ext = dict(l=0, patched=0, t=0.0, s=b"")
    g = fm6_api_unitig(int(min(max_len / 3.0, 17)), blob, device)
    M.Mag.g_merge(g, True)
    g.g_rm_vext(int(max_len * 1.1), 4)
    M.g_simplify_bubble(g, 25, max_len * 2)
    M.g_pop_simple(g, 10.0, 0.15, True)
    g.g_rm_edge(0, 0.8, int(max_len * 1.1), 5)
    g.g_merge(True)
    g.g_rm_vext(int(max_len * 1.1), 100)
    g.g_merge(False)
    M.g_simplify_bubble(g, 25, max_len * 2)
    M.g_pop_simple(g, 10.0, 0.15, True)
    best_len, best = 0, None
    for p in g.v:
        if p.len > best_len:
            best_len, best = p.len, p
    if best is not None:
        seq = bytes(best.seq)
        qpos = seq.find(t0)
        if qpos < 0:
            seq = dna.revcomp(np.frombuffer(seq, np.uint8)).tobytes()
            qpos = seq.find(t0)
        if qpos >= 0:
            rpos = seq.find(t1)
            if rpos > qpos:
                tmp = len(t0)
                ext["patched"] = 1
                ext["l"] = rpos - (qpos + tmp)
                if ext["l"] > 0:
                    ext["s"] = seq[qpos + tmp: qpos + tmp + ext["l"]]
    return ext


MAX_DROP = 7
SCORE_THRES = 13


def gap_mate(v, iddp, min_supp):
    """The end iddq that end iddp's gap joins, or -1 when patch_gap leaves
    iddp alone (scaf.c:464-475).  It reads only the links, which no gap
    changes."""
    p = v[iddp >> 1]
    if p.nei[iddp & 1] < 0 or p.dist[iddp & 1] >> 40 < min_supp:
        return -1
    iddq = p.nei[iddp & 1]
    if iddp >= iddq:
        return -1
    q = v[iddq >> 1]
    if q.nei[iddq & 1] != iddp:
        return -1
    dist1 = p.dist[iddp & 1] >> 40
    dist2 = 0
    if p.nei2[iddp & 1] >= 0:
        dist2 = p.dist2[iddp & 1] >> 40
    if q.nei2[iddq & 1] >= 0:
        dist2 = max(dist2, q.dist2[iddq & 1] >> 40)
    if dist2 >= min_supp or dist2 / dist1 >= 1.0 / min_supp:
        return -1
    return iddq


def mate_ids(h, v, gaps):
    """Sentinel ranks of every mate read add_seq can ask for in the gaps
    (pairs of ends), sorted: the reads of each end whose link is that end's,
    mate filter off (a superset of the first pass's)."""
    ids = set()
    for iddp, iddq in gaps:
        for idd in (iddp, iddq):
            for (x, _) in v[idd >> 1].reads:
                val = h.get(x >> 1)
                if val is not None and val >> 32 == idd:
                    ids.add(x ^ 3)
    return sorted(ids)


def retrieve_mates(index, ids, bound=MATE_BOUND, chunk=MATE_CHUNK):
    """{sentinel rank: forward nt6 bytes} of reads `ids` of the device
    index, by batched LF walks to their sentinels (search/extend.
    retrieve_strings, kernel K1 on the card), at most `chunk` reads at a time
    and fewer as the bound doubles past `bound`, so that a batch's
    sequence buffer stays under extend.WALK_BUFFER_BYTES."""
    seqs, _ = extend.retrieve_strings(index, ids, bound, chunk)
    return {r: s.tobytes() for r, s in zip(ids, seqs)}


def patch_gap(mates, h, v, iddp, iddq, max_dist, avg, std, device):
    """Close the gap between ends iddp and iddq (gap_mate's pair): a local
    assembly of the mates, then an SW join of the two ends."""
    p, q = v[iddp >> 1], v[iddq >> 1]
    ext = dict(l=0, patched=0, t=0.0, s=b"")
    t0 = t1 = b""
    max_len = 0
    for i in range(2):
        sp = end_seq(p, iddp & 1, 0, max_dist)
        sq = end_seq(q, iddq & 1, 1, max_dist)
        t0, t1 = sp, sq
        # reference scaf.c:485-486: max_len comes from p's mates only
        blob_p, max_len = add_seq(mates, h, p, iddp, iddq if i == 0 else -1)
        blob_q, _ = add_seq(mates, h, q, iddq, iddp if i == 0 else -1)
        blob = sp + b"\x00" + sq + b"\x00" + blob_p + blob_q
        ext = assemble(blob, max_len, t0, t1, device)
        if ext["patched"] and ext["l"] + p.len > 0 and ext["l"] + q.len > 0:
            ext["t"] = compute_t(h, v, iddp, ext["l"], avg, std, max_len)
            if i == 0 and ext["t"] > 1e-5:
                p.ext[iddp & 1] = q.ext[iddq & 1] = ext
                STATS["assembled"] += 1
                break
            elif i == 1 and ext["t"] > 1e-10:
                p.ext[iddp & 1] = q.ext[iddq & 1] = ext
                STATS["assembled"] += 1
    if ext["patched"] == 0 and (p.dist[iddp & 1] & ((1 << 40) - 1)) > avg:
        # SW overlap of the two ends (negative gap)
        mat = [1 if i == j else -3 for i in range(5) for j in range(5)]
        qry = np.frombuffer(t1, np.uint8)
        tgt = np.frombuffer(t0, np.uint8)
        score, qb, qe, tb, te = ksw_align(qry, tgt, 5, mat, 5, 2, xstart=True)
        drop0 = qb
        drop1 = (len(tgt)) - (te + 1)
        max_drop = max(drop0, drop1)
        min_drop = min(drop0, drop1)
        if min_drop == 0 and max_drop < MAX_DROP and score >= SCORE_THRES + max_drop:
            lp = te + 1 - tb + drop0 + drop1
            lq = qe + 1 + drop0 + drop1
            if lp < p.len and lq < q.len:
                extp = dict(l=-lp, patched=1, t=0.0, s=b"")
                extq = dict(l=-lq, patched=1, t=0.0, s=b"")
                tval = compute_t(h, v, iddp, -lp, avg, std, max_len)
                extp["t"] = extq["t"] = tval
                p.ext[iddp & 1] = extp
                q.ext[iddq & 1] = extq
                STATS["sw_joined"] += 1
        if not (p.ext[iddp & 1] and p.ext[iddp & 1]["patched"]):
            STATS["sw_failed"] += 1
            sys.stderr.write(
                f"SW\t{p.k[iddp & 1]}\t{q.k[iddq & 1]}\t{drop0}\t{drop1}\t{score}\n")


def find_path1(v, path, a_thres, p_thres):
    if not path:
        return
    while True:
        idd = path[-1]
        p = v[idd >> 1]
        if p.nei[idd & 1] < 0 or p.ext[idd & 1] is None \
           or p.ext[idd & 1]["patched"] == 0 or p.ext[idd & 1]["t"] < p_thres:
            break
        iddq = p.nei[idd & 1]
        q = v[iddq >> 1]
        if q.deleted or q.A < a_thres:
            break
        path.append(iddq)
        path.append(iddq ^ 1)
        q.deleted = True


def find_path(v, i, a_thres, p_thres):
    p = v[i]
    if p.deleted:
        return []
    path = [i << 1 | 0, i << 1 | 1]
    p.deleted = True
    if p.A >= a_thres:
        find_path1(v, path, a_thres, p_thres)
        path.reverse()
        find_path1(v, path, a_thres, p_thres)
    return path


def make_scaftigs(v, a_thres, p_thres, out_fp):
    for i in range(len(v)):
        path = find_path(v, i, a_thres, p_thres)
        if not path:
            continue
        nsr = 0
        ctg = bytearray()
        assert len(path) % 2 == 0
        for j in range(0, len(path), 2):
            idd = path[j]
            ndir = (idd & 1) ^ 1
            ori_l = len(ctg)
            p = v[idd >> 1]
            nsr += p.nsr
            ctg.extend(p.seq)
            if idd & 1:
                part = dna.revcomp(np.frombuffer(bytes(ctg[ori_l:]), np.uint8))
                ctg[ori_l:] = part.tobytes()
            if j == len(path) - 2:
                break
            ext = p.ext[ndir]
            assert ext and ext["patched"]
            if ext["l"] > 0:
                ori_l = len(ctg)
                ctg.extend(ext["s"][: ext["l"]])
                if path[j + 2] < path[j]:
                    part = dna.revcomp(
                        np.frombuffer(bytes(ctg[ori_l:]), np.uint8))
                    ctg[ori_l:] = part.tobytes()
            else:
                del ctg[len(ctg) + ext["l"]:]
        txt = dna.decode(np.frombuffer(bytes(ctg), np.uint8))
        beg = v[path[0] >> 1]
        end = v[path[-1] >> 1]
        a_val = 100.0 if len(path) > 2 else beg.A
        out_fp.write(f">{beg.k[path[0] & 1]}:{end.k[path[-1] & 1]}\t"
                     f"{len(path) // 2}\t{nsr}\t{a_val:.2f}\n")
        out_fp.write(txt + "\n")


def debug_utig(v, idd, fp=None):
    """Reference debug_utig (scaf.c:129-146): LK link-state dump."""
    fp = fp or sys.stderr
    a = idd & 1
    p = v[idd >> 1]
    fp.write(f"LK\t{idd >> 1}:{idd & 1}\t{p.k[a]}\t{p.len}\t{p.nsr}\t{p.A:.2f}")
    if p.nei[a] >= 0:
        q = v[p.nei[a] >> 1]
        b = p.nei[a] & 1
        fp.write(f"\t{q.k[b]}\t{p.dist[a] >> 40}:{p.dist[a] & ((1 << 40) - 1)}")
        ext = p.ext[a] or dict(patched=0, l=0, t=0.0)
        fp.write(f"\t{ext['patched']}:{ext['l']}:{ext['t']:.1e}")
    if p.nei2[a] >= 0:
        q = v[p.nei2[a] >> 1]
        b = p.nei2[a] & 1
        fp.write(f"\t{q.k[b]}\t{p.dist2[a] >> 40}:{p.dist2[a] & ((1 << 40) - 1)}")
    fp.write("\n")


def scaf_core(index, mag_path, avg, std, min_supp=5, a_thres=20.0,
              p_thres=1e-20, pr_links=False, out_fp=None, verbose=True):
    """Scaftigs of the remapped unitigs at mag_path (FASTA on out_fp,
    stdout by default).  index: the reads' FMDIndex, on the device the
    mate walks and the local assemblies' sorts run on."""
    out_fp = out_fp or sys.stdout
    STATS.clear()
    STATS.update(gaps=0, assembled=0, sw_joined=0, sw_failed=0, mates=0,
                 mate_s=0.0, mini_bwts=0, mini_bwt_s=0.0, gap_loop_s=0.0)
    max_dist = int(avg + 2.0 * std + 0.499)
    v = read_utig(mag_path)
    rdist = cal_rdist(v)
    for p in v:
        if p.A < a_thres:
            p.excluded = True
    if verbose:
        sys.stderr.write(f"[M::scaf] rdist = {rdist:.3f}\n")
    h = collect_nei(v, max_dist)
    for i in range(len(v)):
        resolve_contained(v, i, avg, std, pr_links)
    gaps = [(iddp, iddq) for iddp in range(2 * len(v))
            for iddq in (gap_mate(v, iddp, min_supp),) if iddq >= 0]
    t0 = time.perf_counter()
    ids = mate_ids(h, v, gaps)
    mates = retrieve_mates(index, ids)
    STATS.update(mates=len(ids), mate_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for iddp, iddq in gaps:
        patch_gap(mates, h, v, iddp, iddq, max_dist, avg, std, index.device)
    STATS.update(gaps=len(gaps), gap_loop_s=time.perf_counter() - t0)
    if pr_links:
        for i in range(len(v)):
            debug_utig(v, i << 1 | 0)
            debug_utig(v, i << 1 | 1)
    make_scaftigs(v, a_thres, p_thres, out_fp)
