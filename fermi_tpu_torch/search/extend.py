"""Batched FM-index primitives: backward search and sequence retrieval.

The port of fermi_tpu/search/extend.py.  Each function processes a whole
batch of queries as tensor lanes; per-lane early termination is a mask.
JAX's while/fori loops become Python loops over torch ops.  Their bodies
leave finished lanes unchanged, so the loops test "every lane finished"
(a device-to-host sync) only every SYNC_EVERY steps: the extra steps change
nothing.  Semantics follow reference exact.c (fm_backward_search:7-23,
fm_retrieve:59-70).
"""

import numpy as np
import torch

from fermi_tpu_torch.index.fmd import FMDIndex

SYNC_EVERY = 4
# The [rows, bound] uint8 sequence buffer of one batch of retrieve_strings'
# walks stays under this many bytes: the batch takes fewer rows as its
# bound grows.
WALK_BUFFER_BYTES = 1 << 26


def multi_backward_search(indexes, q):
    """Backward search across several indexes at once (reference
    exact.c:25-57 fm_multi_backward_search — present but with a disabled
    harness there). Tracks one (k, l) per index; an emptied index keeps
    LF-advancing its insert point so the final sums are the interval the
    MERGED index would report. Returns (sa_beg, sa_end, size) in merged
    coordinates, size 0 when no index matches.

    indexes: FMDIndex objects. q: nt6 symbol sequence, searched right to
    left like the reference.
    """
    q = np.asarray(q)
    n = len(indexes)
    if n == 0 or q.size == 0:
        return 0, -1, 0

    def rank_c(e, k, c):
        return int(e.rank6(torch.tensor([k], device=e.device))[0, c])

    c = int(q[-1])
    ks = [int(e.cnt[c]) for e in indexes]
    ls = [int(e.cnt[c + 1]) for e in indexes]
    done = [False] * n
    finished = 0
    for i in range(q.size - 2, -1, -1):
        c = int(q[i])
        for j, e in enumerate(indexes):
            cnt_c = int(e.cnt[c])
            ok = rank_c(e, ks[j], c)
            if not done[j]:
                ol = rank_c(e, ls[j], c)
                ks[j] = cnt_c + ok
                ls[j] = cnt_c + ol
                if ks[j] == ls[j]:
                    done[j] = True
                    finished += 1
            else:
                ks[j] = ls[j] = cnt_c + ok
        if finished == n:
            break
    if finished == n:
        return 0, -1, 0
    sa_beg = sum(ks)
    sa_end = sum(ls) - 1
    return sa_beg, sa_end, sa_end - sa_beg + 1


def _pick(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x[b, c[b]] for x [B, 6] and c long [B]."""
    return x.gather(1, c[:, None])[:, 0]


def backward_search(index: FMDIndex, queries: torch.Tensor,
                    lengths: torch.Tensor, max_len: int):
    """Exact-match interval for each query string.

    queries: uint8 [B, max_len], strings left-aligned, processed from their
    last base; pad the tail with zeros and give true lengths.
    Returns (sa_beg, sa_end, count): int [B]; count==0 means no match.
    """
    dev = index.device
    queries = queries.to(dev)
    li = lengths.to(dev).long()
    # an empty query reads column -1, which JAX normalizes to the last one
    last = queries.gather(1, ((li - 1) % max_len)[:, None])[:, 0].long()
    k = index.cnt[last]
    l = index.cnt[last + 1] - 1
    alive = li > 0
    for i in range(max_len - 1):
        # process position lengths-2-i (from the right)
        pos = li - 2 - i
        active = alive & (pos >= 0)
        # a lane once inactive stays so: stop when none is left
        if i % SYNC_EVERY == 0 and not bool(active.any()):
            break
        c = queries.gather(1, pos.clamp(min=0)[:, None])[:, 0].long()
        ok = index.rank6(k)          # rank over [0..k-1]
        ol = index.rank6(l + 1)      # rank over [0..l]
        cc = index.cnt[c]
        nk = cc + _pick(ok, c)
        nl = cc + _pick(ol, c) - 1
        k = torch.where(active, nk, k)
        l = torch.where(active, nl, l)
        alive = alive & (~active | (nk <= nl))
    ok = alive & (k <= l)
    cnt = torch.where(ok, l - k + 1, 0)
    return k, l, cnt


def retrieve(index: FMDIndex, x: torch.Tensor, max_len: int):
    """Retrieve the x-th sequence by LF-walking from sentinel rank x
    (reference fm_retrieve). Returns (seq, length, prev_rank):
    seq uint8 [B, max_len] — the sequence REVERSED (as the walk emits it);
    prev_rank — the sentinel rank reached at the walk's end (the return value
    of fm_retrieve, used by seqsort).
    """
    dev = index.device
    B = x.shape[0]
    k = x.to(dev).to(index.idtype)
    out = torch.zeros((B, max_len), dtype=torch.uint8, device=dev)
    length = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(max_len):
        if i % SYNC_EVERY == 0 and bool(done.all()):
            break
        # index.lf gives k' = cnt[c] + rank6(k)[c], which equals the
        # reference's cnt[c] + rank_inclusive(k)[c] - 1 (exact.c:66)
        c, kp = index.lf(k)
        hit_end = c == 0
        emit = ~done & ~hit_end
        out[:, i] = torch.where(emit, c, 0)
        length += emit.to(torch.int32)
        k = torch.where(done, k, kp)
        done = done | hit_end
    return out, length, k


def _contained(index, k, kb, kf, sz):
    """Final sentinel extensions of a retrieve2/seqrank walk: the read's
    bi-interval bounded by sentinels, and its containment flags (bit 0:
    left-contained, bit 1: right-contained)."""
    KB, KF, SZ = index.extend6(kb, kf, sz, is_back=True)
    left = (SZ[:, 0] != sz) & (sz != 1)
    one = sz == 1
    kb2 = torch.where(one, k, KB[:, 0])
    kf2 = torch.where(one, kf, KF[:, 0])
    sz2 = torch.where(one, sz, SZ[:, 0])
    KB, KF, SZ = index.extend6(kb2, kf2, sz2, is_back=False)
    right = SZ[:, 0] != sz2
    contained = left.to(torch.int32) | (right.to(torch.int32) << 1)
    return KB[:, 0], KF[:, 0], SZ[:, 0], contained


def retrieve2(index: FMDIndex, x: torch.Tensor, max_len: int):
    """Batched fm6_retrieve (exact.c:100-127): LF-walk from sentinel rank x
    while tracking the bi-interval of the read-so-far; ends with sentinel
    extensions that detect containment.

    Returns (seq_rev, length, k, kb, kf, sz, contained):
    k — the read's own sentinel rank; (kb, kf, sz) — bi-interval of the full
    read bounded by sentinels; contained — bit1: left-, bit2: right-contained.
    """
    dev = index.device
    idt = index.idtype
    B = x.shape[0]
    k = x.to(dev).to(idt)
    out = torch.zeros((B, max_len), dtype=torch.uint8, device=dev)
    length = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    kb = torch.zeros(B, dtype=idt, device=dev)
    kf = torch.zeros_like(kb)
    sz = torch.zeros_like(kb)
    for i in range(max_len):
        if i % SYNC_EVERY == 0 and bool(done.all()):
            break
        c, kp = index.lf(k)
        ci = c.long()
        hit_end = c == 0
        emit = ~done & ~hit_end
        out[:, i] = torch.where(emit, c, 0)
        length += emit.to(torch.int32)
        # interval update for emitting lanes
        first = length == 1  # this step emitted the first symbol
        skb, skf, ssz = index.set_intv(ci)
        KB, KF, SZ = index.extend6(kb, kf, sz, is_back=True)
        one = sz == 1
        nkb = torch.where(first, skb, torch.where(one, kp, _pick(KB, ci)))
        nkf = torch.where(first, skf, torch.where(one, kf, _pick(KF, ci)))
        nsz = torch.where(first, ssz, torch.where(one, sz, _pick(SZ, ci)))
        kb = torch.where(emit, nkb, kb)
        kf = torch.where(emit, nkf, kf)
        sz = torch.where(emit, nsz, sz)
        k = torch.where(done, k, kp)
        done = done | hit_end
    return (out, length, k) + _contained(index, k, kb, kf, sz)


def seqrank_walk(index: FMDIndex, x: torch.Tensor,
                 max_iters: int | None = None, unroll: int = 4):
    """retrieve2 minus the sequence buffer: LF-walk from sentinel rank x
    tracking only the full-read bi-interval — all seqsort needs
    (reference seqsort.c:12-35 calls fm6_retrieve but uses only the
    interval and flags).  The three per-step rank queries (LF symbol,
    interval start, interval end) go to the device as one rank6 call.

    With max_iters None every lane walks to its sentinel, however long its
    read; no read is longer than the index, so a lane still live after
    that many steps means a damaged index and raises.  With max_iters the
    walk stops there, finished or not, as fermi_tpu's does.  The loop
    condition is tested once per `unroll` steps, as in the JAX version, so
    a lane may walk up to unroll-1 steps past max_iters; a finished lane
    does not change.

    Returns (k, kb, kf, sz, contained) with retrieve2 semantics.
    """
    dev = index.device
    idt = index.idtype
    B = x.shape[0]
    cnt = index.cnt
    k = x.to(dev).to(idt)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    started = torch.zeros_like(done)
    kb = torch.zeros(B, dtype=idt, device=dev)
    kf = torch.zeros_like(kb)
    sz = torch.zeros_like(kb)
    i = 0
    cap = index.total + 1 if max_iters is None else max_iters
    while i < cap and not bool(done.all()):
        for _ in range(max(1, unroll)):
            c = index.sym_at(k)
            ci = c.long()
            r = index.rank6(torch.stack([k, kb, kb + sz], 0))   # [3, B, 6]
            kp = cnt[ci] + _pick(r[0], ci)
            hit_end = c == 0
            emit = ~done & ~hit_end
            first = emit & ~started
            # backward extend6 of (kb, kf, sz) by symbol c, from the
            # stacked ranks
            tk = r[1]
            osz = r[2] - tk
            ekb = cnt[ci] + _pick(tk, ci)
            esz = _pick(osz, ci)
            # forward-strand start via the complement-ordering identity
            # (0,4,3,2,1,5)
            o4 = osz[:, 0]
            o3 = o4 + osz[:, 4]
            o2 = o3 + osz[:, 3]
            o1 = o2 + osz[:, 2]
            o5 = o1 + osz[:, 1]
            off = torch.stack([torch.zeros_like(o4), o1, o2, o3, o4, o5], -1)
            ekf = kf + _pick(off, ci)
            skb, skf, ssz = index.set_intv(ci)
            one = sz == 1
            nkb = torch.where(first, skb, torch.where(one, kp, ekb))
            nkf = torch.where(first, skf, torch.where(one, kf, ekf))
            nsz = torch.where(first, ssz, torch.where(one, sz, esz))
            kb = torch.where(emit, nkb, kb)
            kf = torch.where(emit, nkf, kf)
            sz = torch.where(emit, nsz, sz)
            started = started | emit
            k = torch.where(done, k, kp)
            done = done | hit_end
            i += 1
    if max_iters is None and not bool(done.all()):
        raise RuntimeError(f"seqrank_walk: a walk passed {cap} steps, the "
                           "index's length, without reaching a sentinel")
    return (k,) + _contained(index, k, kb, kf, sz)


def retrieve_strings(index: FMDIndex, ids, bound: int = 1 << 10,
                     rows: int = 1 << 16):
    """Host convenience: reads `ids` as forward nt6 numpy arrays, each
    walked to its sentinel whatever its length, and the sentinel ranks the
    walks end at.  Every walk takes `bound` steps at first; the lanes still
    live then go on from where they stopped for as many steps as they have
    walked, so the bound doubles until every walk has ended (fermi_tpu's
    retrieve_strings stops at its max_len).  A batch holds at most `rows`
    lanes and WALK_BUFFER_BYTES of sequence buffer."""
    ids = np.asarray(ids, dtype=np.int64)
    seqs = [None] * len(ids)
    parts = {}                                # live walks' pieces, reversed
    at = ids.copy()                           # where a live walk resumes
    todo = np.arange(len(ids))
    step = walked = bound
    while len(todo):
        batch = max(1, min(rows, WALK_BUFFER_BYTES // step))
        live = []
        for lo in range(0, len(todo), batch):
            sel = todo[lo: lo + batch]
            seq_rev, length, k = (a.cpu().numpy() for a in retrieve(
                index, torch.from_numpy(at[sel]).to(index.device), step))
            at[sel] = k
            for j, (i, n) in enumerate(zip(sel.tolist(), length.tolist())):
                # a lane that emitted at every step has not met its sentinel
                if n == step or i in parts:
                    parts.setdefault(i, []).append(seq_rev[j, :n].copy())
                else:
                    seqs[i] = seq_rev[j, :n][::-1].copy()
            live.append(sel[length == step])
        todo = np.concatenate(live)
        for i in parts.keys() - set(todo.tolist()):
            seqs[i] = np.concatenate(parts.pop(i))[::-1].copy()
        # the live lanes walk as far again: the bound doubles
        step, walked = walked, 2 * walked
    return seqs, at
