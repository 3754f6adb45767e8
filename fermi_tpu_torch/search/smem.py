"""Batched supermaximal-exact-match (SMEM) search.

The port of fermi_tpu/search/smem.py's unified path: the bidirectional
SMEM algorithm of reference smem.c:13-80 (fm6_smem1_core) and its
whole-read routine fm6_smem (smem.c:397-411) as one loop over a per-lane
state machine (mode ∈ {forward sweep, backward sweep}, segment restarts
inline), one read per lane.  Every loop step advances every lane by one
bidirectional-extension step; its rank queries (both ends of every live
interval) go to kernel K1 in one call.

Pool mode (`lanes > 0`): a lane that finishes its read pulls the next
unassigned read, so the step count tracks the mean per-read work instead
of the slowest read of a batch.  The variable-length interval lists are
masked fixed-width buffers; a read that overflows one is re-run with
wider buffers (the redo ladder), keeping results exact for any input.

Output fields per match mirror fm6_write_smem (smem.c:412-419): [start, end)
on the read, interval size, left-closed flag, and forward-strand start (for
the 'T'/'O' full-length flag).

Not ported here: the TPU's phase-split schedule (pass A / pass B; its results
equal this path's; ROADMAP queue 1, item 3a), and queries longer than
LONG_QUERY_LEN, which fermi_tpu sends to its native engine (item 3b).
"""

import numpy as np
import torch

from fermi_tpu_torch.index.fmd import FMDIndex
from fermi_tpu_torch.search.extend import SYNC_EVERY

LONG_QUERY_LEN = 512
POOL_MAX = 8192          # reads per pool-mode call
LANES = 2048             # device lanes of a pool-mode call
DEFAULT_MAXI = 32        # per-segment interval-list width before learning

# Per-call counters for measurement (the chip smoke test reads them):
# reads searched, reads that rode the redo ladder, and the learned width.
STATS = {"reads": 0, "redo": 0, "maxi": None}

# Opposite-strand starts follow the complement-ordering chain
# o0=base, o4=o0+s0, o3=o4+s4, o2=o3+s3, o1=o2+s2, o5=o1+s1 (rld.h fm6_set
# intervals); _MC[c, d] = 1 iff osz_d is part of o_c's partial sum.
_MC = np.zeros((6, 6), np.int64)
for _c, _ds in ((4, (0,)), (3, (0, 4)), (2, (0, 4, 3)),
                (1, (0, 4, 3, 2)), (5, (0, 4, 3, 2, 1))):
    _MC[_c, list(_ds)] = 1


def _comp6(c):
    return torch.where((c >= 1) & (c <= 4), 5 - c, c)


def _dead_spread(n, n_total, idt, salt, device):
    """Gather positions for DEAD interval slots: a loop-invariant
    pseudo-random spread over [0, n_total), as in fermi_tpu (there it keeps
    dead lanes' gathers off each other's memory banks; here it keeps the
    same positions so both versions issue the same rank queries).

    Trouble spot: fermi_tpu multiplies in uint32 with wraparound.  This is
    the same arithmetic in int64 with a 32-bit mask; the result stays in
    [0, n_total), a valid rank position."""
    v = ((torch.arange(n, dtype=torch.int64, device=device) + salt * 40503)
         * 2654435761) & 0xFFFFFFFF
    nm = max(n_total & 0xFFFFFFFF, 1)
    return (v % nm).to(idt)


def _excl_cumsum(m, dim=-1):
    s = torch.cumsum(m.to(torch.int32), dim, dtype=torch.int32)
    return s - m.to(torch.int32), s


def _smem_batch(index: FMDIndex, q: torch.Tensor, l: torch.Tensor,
                self_match: bool, max_len: int, maxi: int, maxm: int,
                lanes: int = 0, emax: int = 8, compact: int = 0):
    """SMEMs of every read in the batch, one state-machine loop.

    q: uint8 [B, max_len]; l: int32 [B], on the index's device.
    Returns (mem fields [B, maxm, 3], mem_n [B], ret [B], ovf [B]).

    lanes>0 selects POOL mode: q/l hold a whole read pool [NP, max_len] and
    only `lanes` lanes run; a lane that finishes a read pulls the next one.
    Outputs are per read: ([NP, maxm, 3], mem_n [NP], ret, ovf [NP]).  With
    `compact`, the valid match rows of every read are packed back to back:
    (cvals [compact, 3], info [NP], ret, total).

    The match buffers and the finished-read info are updated in place; a
    scatter whose target is out of range (JAX's mode="drop") writes one
    spare slot past the end instead.
    """
    dev = index.device
    idt = index.idtype
    i32 = torch.int32
    W, M = maxi, maxm
    pool = lanes > 0
    NP = q.shape[0]
    B = lanes if pool else NP
    n_seqs = index.n_seqs
    cnt = index.cnt
    cnt6 = cnt[:6]
    MC = torch.as_tensor(_MC, device=dev).to(idt)
    l = l.to(i32)
    jW = torch.arange(W, dtype=i32, device=dev)
    jB = torch.arange(B, dtype=i32, device=dev)
    jE = torch.arange(min(emax, W), dtype=i32, device=dev)
    qflat = q.reshape(-1)

    def qat(pos, rid):
        """q[rid[b], pos[b]], the position clamped into the read (callers
        mask what lies outside; JAX gathers clamp, torch's raise)."""
        return qflat[rid.long() * max_len + pos.clamp(0, max_len - 1).long()]

    def set_intv(c):
        ci = c.long()
        return cnt[ci], cnt[_comp6(ci)], cnt[ci + 1] - cnt[ci]

    def shr(a, k, fill):
        """Shift right by k along the slot axis."""
        return torch.cat([torch.full((B, k), fill, dtype=a.dtype, device=dev),
                          a[:, :-k]], 1)

    # ---- initial per-lane state -----------------------------------------
    x = torch.zeros(B, dtype=i32, device=dev)
    rid = jB.clamp(max=NP - 1)
    ll = l[rid]                          # per-lane read length
    done = (x >= ll) | (jB >= NP)
    kb, kf, sz = set_intv(qat(x, rid))
    deadA = _dead_spread(B * W, index.total, idt, 1, dev).view(B, W)
    deadB = _dead_spread(B * W, index.total, idt, 2, dev).view(B, W)
    NO = NP if pool else B               # output rows (per read)
    nxt = torch.tensor(B, dtype=i32, device=dev)
    out_info = torch.zeros(NO + 1, dtype=i32, device=dev)
    bwd = torch.zeros(B, dtype=torch.bool, device=dev)
    nseg = torch.zeros(B, dtype=i32, device=dev)
    i = x + 1
    Lkb = torch.zeros((B, W), dtype=idt, device=dev)
    Lkf = torch.zeros_like(Lkb)
    Lsz = torch.zeros_like(Lkb)
    Lnfo = torch.zeros((B, W), dtype=i32, device=dev)
    Lal = torch.zeros((B, W), dtype=torch.bool, device=dev)
    n = torch.zeros(B, dtype=i32, device=dev)
    seg_base = torch.zeros_like(n)
    last_ms = torch.zeros_like(n)
    xret = x.clone()
    ovf = torch.zeros_like(bwd)
    gkf = torch.zeros(NO * M + 1, dtype=idt, device=dev)
    gsz = torch.zeros_like(gkf)
    gmt = torch.zeros(NO * M + 1, dtype=i32, device=dev)
    gmn = torch.zeros(B, dtype=i32, device=dev)
    slot0 = (jW == 0)[None, :]
    no_lane = torch.zeros(B, dtype=torch.bool, device=dev)

    def lpush(Lkb, Lkf, Lsz, Lnfo, Lal, n, ovf, m, vkb, vkf, vsz, vnfo):
        at = n.clamp(max=W - 1)
        sel = m[:, None] & (jW[None, :] == at[:, None])
        Lkb = torch.where(sel, vkb[:, None], Lkb)
        Lkf = torch.where(sel, vkf[:, None], Lkf)
        Lsz = torch.where(sel, vsz[:, None], Lsz)
        Lnfo = torch.where(sel, vnfo[:, None], Lnfo)
        return (Lkb, Lkf, Lsz, Lnfo, Lal | sel, n + m.to(i32),
                ovf | (m & (n >= W)))

    step = 0
    while True:
        # Trouble spot: loop overhead.  A step is ~150 small torch launches
        # plus one K1 launch, so the loop is bound by host launch time
        # (PERF.md).  The step leaves finished lanes unchanged, so the
        # "all done" test, a device-to-host sync, runs every SYNC_EVERY
        # steps and the host can queue steps ahead of the card.
        if step % SYNC_EVERY == 0 and bool(done.all()):
            break
        step += 1
        fw = ~done & ~bwd
        bw = ~done & bwd
        at_end = i >= ll
        bwdW = bwd[:, None]

        # ---- one shared bidirectional extension for every lane ----------
        # fwd lanes use slot 0 only (their current scalar interval); bwd
        # lanes extend their whole interval list.  is_back varies per lane:
        # primary strand and output mapping are selected per lane, the two
        # rank6 queries are shared (exact.c:72-88 semantics both ways).
        Ekb = torch.where(bwdW, Lkb, torch.where(slot0, kb[:, None], 0))
        Ekf = torch.where(bwdW, Lkf, torch.where(slot0, kf[:, None], 0))
        Esz = torch.where(bwdW, Lsz, torch.where(slot0, sz[:, None], 0))
        # fwd lanes keep slot 0 live even at i==l: the end-of-read pushes
        # need the $-column of the final interval's extension (the
        # reference's fresh post-loop fm6_extend)
        live = ~done[:, None] & torch.where(bwdW, Lal, slot0)
        # extension symbol: fwd = complement of next char; bwd = prev char
        # ($=0 at i==-1, smem.c:44)
        c_f = _comp6(qat(torch.minimum(i, ll - 1), rid).to(i32))
        c_b = torch.where(i < 0, 0, qat(i, rid).to(i32))
        cl = torch.where(bwd, c_b, c_f).long()

        primary = torch.where(live, torch.where(bwdW, Ekb, Ekf), deadA)
        hi = torch.where(live, primary + Esz, deadB)
        tkl = index.rank6(torch.cat([primary, hi], 1))     # [B, 2W, 6]
        tk, tl = tkl[:, :W], tkl[:, W:]
        osz = tl - tk
        other_base = torch.where(bwdW, Ekf, Ekb)

        # Only the class-c (and class-0) columns are consumed downstream:
        # select class c directly, and collapse the opposite-strand
        # complement-ordering chain into one masked row-sum with the
        # constant prefix matrix MC[c, d] = "osz_d contributes to o_c".
        cW = cl[:, None, None].expand(B, W, 1)
        tk_c = tk.gather(2, cW)[:, :, 0]
        okc_sz = osz.gather(2, cW)[:, :, 0]
        ok0_sz = osz[:, :, 0]
        primary_c = cnt6[cl][:, None] + tk_c
        other_c = other_base + (osz * MC[cl][:, None, :]).sum(-1, dtype=idt)
        okc_kb = torch.where(bwdW, primary_c, other_c)     # [B, W]
        okc_kf = torch.where(bwdW, other_c, primary_c)

        # ================= forward-sweep branch ==========================
        # (f_* values are consumed only under fw masks, where bwd is False:
        # KB collapses to the `other` chain and KF to the primary column)
        f_okc_sz = okc_sz[:, 0]
        f_ok0_sz = ok0_sz[:, 0]
        f_kb0 = other_base[:, 0]
        f_kf0 = cnt6[0] + tk[:, 0, 0]

        stepm = fw & ~at_end
        size_changed = f_okc_sz != sz
        push1 = stepm & size_changed & (sz != f_ok0_sz)
        pushF1 = fw & at_end
        if self_match:
            push2 = pushF2 = no_lane
            dead = stepm & (f_okc_sz < 2)
        else:
            push2 = stepm & size_changed & (f_ok0_sz != 0)
            # end-of-read pushes (reference post-loop: last interval + its
            # $-extension variant), only for lanes arriving alive at i==l
            pushF2 = pushF1 & (f_ok0_sz != 0)
            dead = stepm & (f_okc_sz == 0)

        L = (Lkb, Lkf, Lsz, Lnfo, Lal, n, ovf)
        L = lpush(*L, push1, kb, kf, sz, i)
        L = lpush(*L, push2, f_kb0, f_kf0, f_ok0_sz, i)
        L = lpush(*L, pushF1, kb, kf, sz, ll)
        Lkb, Lkf, Lsz, Lnfo, Lal, n2, ovf = lpush(*L, pushF2, f_kb0, f_kf0,
                                                  f_ok0_sz, ll)

        adv = stepm & ~dead
        kb = torch.where(adv, okc_kb[:, 0], kb)
        kf = torch.where(adv, okc_kf[:, 0], kf)
        sz = torch.where(adv, f_okc_sz, sz)

        # fwd -> bwd transition: the collected list stays in push order
        # (end-ascending); the backward sweep walks it right-to-left via
        # flips.  Compute the next-segment start (smem.c: the last recorded
        # shrink point) and enter backward mode at i = x-1.
        trans = fw & (dead | at_end)
        last_nfo = Lnfo.gather(1, (n2 - 1).clamp(0, W - 1).long()[:, None])[:, 0]
        ret_seg = torch.where(n2 > 0, last_nfo, x + 1)

        n = torch.where(fw, n2, n)
        bwd = bwd | trans
        i = torch.where(fw, torch.where(trans, x - 1, i + 1), i)
        xret_f = torch.where(trans, ret_seg, xret)
        seg_base = torch.where(trans, gmn, seg_base)
        last_ms = torch.where(trans, 0, last_ms)

        # ================= backward-sweep branch =========================
        # The reference walks the interval list sequentially (smem.c:44-66)
        # carrying four scalars; here the whole pass is vector ops over the
        # width axis — the sequential recurrences collapse exactly:
        #  * current-set dedup "size != last KEPT size" equals
        #    unique-consecutive over candidates;
        #  * mem emission admits every full-length hit plus at most the
        #    first other keeper, and only when the step-entry state allowed.
        # The walk order is push-order-DESCENDING: all directional scans run
        # in flip space.
        valid = Lal & bw[:, None]
        fl = (ok0_sz != 0) & (Ekf < n_seqs)
        contv = okc_sz > 1 if self_match else okc_sz != 0
        keep = (~contv) | fl | (i == -1)[:, None]
        cand = contv & valid

        candF = cand.flip(1)
        szF = okc_sz.flip(1)
        # previous candidate's size in walk order: log-step inclusive
        # forward-fill of (cand, sz), then shift for the exclusive view
        hasF = candF
        valF = torch.where(candF, szF, 0)
        k = 1
        while k < W:
            hasF_s = shr(hasF, k, False)
            valF_s = shr(valF, k, 0)
            valF = torch.where(hasF, valF, valF_s)
            hasF = hasF | hasF_s
            k *= 2
        prevF_has = shr(hasF, 1, False)
        prevF_s = shr(valF, 1, 0)
        do_currF = candF & ((Ekf < n_seqs).flip(1) | ~prevF_has
                            | (szF != prevF_s))
        do_curr = do_currF.flip(1)
        cnn = do_curr.sum(1, dtype=i32)

        cnF_before, _ = _excl_cumsum(do_currF, 1)
        flF = fl.flip(1)
        do_keepF = (keep & valid).flip(1) & ((cnF_before == 0) | flF)
        base_ok = ((gmn - seg_base) == 0) | ((i + 1) < last_ms)
        abF_before, _ = _excl_cumsum(do_keepF, 1)
        do_memF = do_keepF & (flF | (base_ok[:, None] & (abF_before == 0)))
        dmF_before, dmF_inc = _excl_cumsum(do_memF, 1)
        do_mem = do_memF.flip(1)
        ordn = dmF_before.flip(1)
        ovf = ovf | (do_mem & (gmn[:, None] + ordn >= M)).any(1)
        meta = ((nseg[:, None] << 21) | (Lnfo << 11)
                | ((i + 1)[:, None] << 1) | (ok0_sz != 0).to(i32))
        # Compact this step's emissions to E ordinals per lane before the
        # scatter into the per-read match buffers; more than E emissions in
        # one step flag ovf and ride the redo ladder like any overflow.
        E = jE.shape[0]
        ovf = ovf | (do_mem & (ordn >= E)).any(1)
        # emitting slots carry distinct ordinals, so the compaction is a
        # scatter into E columns (column E takes every non-emitting slot)
        ecol = torch.where(do_mem & (ordn < E), ordn, E).long()

        def pick(v):
            out = torch.zeros((B, E + 1), dtype=v.dtype, device=dev)
            return out.scatter_(1, ecol, v)[:, :E]

        e_has = torch.zeros((B, E + 1), dtype=torch.bool, device=dev) \
            .scatter_(1, ecol, True)[:, :E]                    # [B, E]
        row = rid if pool else jB
        e_at = gmn[:, None] + jE
        tgt = torch.where(e_has & (e_at < M),
                          (row * M)[:, None] + e_at.clamp(max=M - 1),
                          NO * M).reshape(-1).long()
        gkf[tgt] = pick(Ekf).reshape(-1)
        gsz[tgt] = pick(Esz).reshape(-1)
        gmt[tgt] = pick(meta).reshape(-1)
        n_mem = dmF_inc[:, -1]
        last_ms = torch.where(bw & (n_mem > 0), i + 1, last_ms)
        gmn = torch.where(bw, (gmn + n_mem).clamp(max=M), gmn)

        # surviving (deduped, continuing) entries keep their slots with the
        # extended intervals; everything else just goes dead in the mask
        upd = bw[:, None] & do_curr
        Lkb = torch.where(upd, okc_kb, Lkb)
        Lkf = torch.where(upd, okc_kf, Lkf)
        Lsz = torch.where(upd, okc_sz, Lsz)
        Lal = torch.where(bw[:, None], do_curr, Lal)
        n = torch.where(bw, cnn, n)
        i_b = i - 1
        i = torch.where(bw, i_b, i)

        # bwd termination: segment complete — either restart (next segment,
        # inline) or finish the lane
        term = bw & ((i_b < -1) | (cnn == 0))
        nseg = nseg + term.to(i32)
        x_new = torch.maximum(xret_f, x + 1)      # guarantee progress
        xret = torch.where(term, x_new, xret_f)
        fin = x_new >= ll
        restart = term & ~fin
        finl = term & fin
        if pool:
            # write the finished read's outputs, then pull the next read
            out_info[torch.where(finl, rid, NO).long()] = \
                gmn | (ovf.to(i32) << 30)
            rank, inc = _excl_cumsum(finl)
            rid_new = nxt + rank
            have = rid_new < NP
            take = finl & have
            done = done | (finl & ~have)
            nxt = nxt + inc[-1]
            rid_c = rid_new.clamp(max=NP - 1)
            rid = torch.where(take, rid_c, rid)
            ll = torch.where(take, l[rid_c.long()], ll)
            # a fresh read re-enters like a segment restart from x=0
            restart = restart | take
            x_new = torch.where(take, 0, x_new)
            nseg = torch.where(take, 0, nseg)
            gmn = torch.where(take, 0, gmn)
            seg_base = torch.where(take, 0, seg_base)
            ovf = ovf & ~take
            xret = torch.where(take, 0, xret)
        else:
            done = done | finl
        # inline segment restart (fm6_smem do-while, smem.c:400-408)
        xr = torch.where(restart, x_new, x)
        rkb, rkf, rsz = set_intv(qat(xr, rid))
        kb = torch.where(restart, rkb, kb)
        kf = torch.where(restart, rkf, kf)
        sz = torch.where(restart, rsz, sz)
        x = xr
        i = torch.where(restart, x_new + 1, i)
        n = torch.where(restart, 0, n)
        Lal = Lal & ~restart[:, None]
        last_ms = torch.where(restart, 0, last_ms)
        bwd = bwd & ~restart

    gkf, gsz, gmt = gkf[:NO * M], gsz[:NO * M], gmt[:NO * M]
    if pool and compact:
        # output compaction: the per-read [NO, M] buffers are mostly
        # padding; pack the valid rows in read order (positions preserved,
        # so the host decode is unchanged)
        info = out_info[:NO]
        mn = (info & ((1 << 30) - 1)).clamp(max=M)
        valid = (torch.arange(M, dtype=i32, device=dev)[None, :]
                 < mn[:, None]).reshape(-1)
        pos, inc = _excl_cumsum(valid)
        tot = inc[-1]
        tgt = torch.where(valid & (pos < compact), pos, compact).long()
        cvals = torch.zeros((compact + 1, 3), dtype=idt, device=dev)
        cvals[tgt] = torch.stack([gkf, gsz, gmt.to(idt)], -1)
        return cvals[:compact], info, xret, tot
    g3 = torch.stack([gkf, gsz, gmt.to(idt)], -1).reshape(NO, M, 3)
    if pool:
        info = out_info[:NO]
        return g3, info & ((1 << 30) - 1), xret, info >> 30
    return g3, gmn, xret, ovf


def smem_all(index: FMDIndex, seqs: list[np.ndarray], self_match=False,
             maxi: int | None = None, maxm: int = 64):
    """All SMEMs for a list of nt6 reads.

    Returns per read a list of (start, end, size, left_closed, kf) tuples, in
    the same order the reference fm6_smem emits them, computed on the
    index's device.

    The per-segment interval-list width (maxi) is COVERAGE-ADAPTIVE when
    not given: interval counts scale with index coverage, so the pool loop
    records the observed overflow fraction and widens the learned width
    (sticky on the index object) whenever >5% of a call rides the redo
    ladder.  A first call of more than 4096 reads learns it on a 1024-read
    probe first.
    """
    B = len(seqs)
    if B == 0:
        return []
    max_len = max(len(s) for s in seqs)
    if max_len > LONG_QUERY_LEN:
        raise NotImplementedError(
            f"query of {max_len} bp: queries longer than {LONG_QUERY_LEN} bp "
            "need a port of the native sequential SMEM engine "
            "(native/smem.cpp), ROADMAP queue 1, item 3b")
    if maxi is None:
        maxi = getattr(index, "_smem_maxi", None)
        if maxi is None and B > 4096:
            # cold-start probe: learn the coverage-adaptive width on a
            # small slice first — a dense (25x) index otherwise rides the
            # redo ladder for the WHOLE first call
            head = smem_all(index, seqs[:1024], self_match, None, maxm)
            if getattr(index, "_smem_maxi", None) is None:
                # probe saw <5% overflow: the default is the right width —
                # pin it so the recursion doesn't re-probe every 1024 reads
                index._smem_maxi = DEFAULT_MAXI
            return head + smem_all(index, seqs[1024:], self_match, None,
                                   maxm)
        maxi = maxi or DEFAULT_MAXI
    return _smem_all_pool(index, seqs, self_match, maxi, maxm, LANES,
                          max_len)


def _learn_maxi(index, n_redo, n_total, maxi):
    """Coverage adaptation: when >5% of a call overflows the per-segment
    interval list, widen the width future smem_all calls start from
    (sticky on the index object, capped at 256); a majority-overflow call
    (dense 25x-style index) jumps 4x instead of 2x."""
    if n_total and n_redo > 0.05 * n_total:
        factor = 4 if n_redo > 0.5 * n_total else 2
        index._smem_maxi = min(256, factor * max(
            maxi, getattr(index, "_smem_maxi", None) or 0))


def _pack_queries(seqs, ids, rows, max_len, pad_len):
    q = np.zeros((rows, max_len), np.uint8)
    lens = np.full(rows, pad_len, np.int32)
    for t, si in enumerate(ids):
        s = seqs[si]
        q[t, : len(s)] = s
        lens[t] = len(s)
    return q, lens


def _redo_ladder(index, seqs, redo, results, self_match, max_len, maxi,
                 maxm):
    """Re-run overflowed reads with wider buffers (fixed-batch mode): 2x,
    8x, then the guaranteed size.  Every tier is chunked to bound device
    memory."""
    dev = index.device
    tiers = ((2 * maxi, 4 * maxm, 4096),
             (8 * maxi, 16 * maxm, 1024),
             (2 * max_len + 4, 4 * max_len + 8, 512))
    for wi, wm, chunk in tiers:
        if not redo:
            break
        still = []
        for c0 in range(0, len(redo), chunk):
            part = redo[c0: c0 + chunk]
            q, lens = _pack_queries(seqs, part, len(part), max_len, 0)
            big = _smem_batch(index, torch.from_numpy(q).to(dev),
                              torch.from_numpy(lens).to(dev), self_match,
                              max_len, wi, wm, emax=wi)
            bg3, bmn, _, bovf = (t.cpu().numpy() for t in big)
            dec = _decode_batch(bg3, bmn)
            for t, si in enumerate(part):
                if bovf[t]:
                    still.append(si)
                else:
                    results[si] = dec[t]
        redo = still
    if redo:
        raise RuntimeError("SMEM overflow at guaranteed buffer size")


def _smem_all_pool(index, seqs, self_match, maxi, maxm, lanes, max_len):
    """Pool mode: one call per POOL_MAX reads, lane refill inside the
    loop; the rare buffer-overflow reads re-run through the fixed-batch
    redo ladder."""
    dev = index.device
    Bn = len(seqs)
    results = [None] * Bn
    ids_all = []
    for i, s in enumerate(seqs):
        if len(s) == 0:
            results[i] = []     # reference emits nothing for empty queries
        else:
            ids_all.append(i)
    if not ids_all:
        return results
    # pool size: a power of two of at least 16 (as in fermi_tpu, whose
    # compiled shapes it kept few); pads are length-1 reads
    NPc = 16
    while NPc < min(len(ids_all), POOL_MAX):
        NPc *= 2
    lanes = min(lanes, NPc)
    redo = []
    CAP = NPc * 16          # compacted-output budget (mean ~12 matches/read)
    for lo in range(0, len(ids_all), NPc):
        ids = ids_all[lo: lo + NPc]
        q, lens = _pack_queries(seqs, ids, NPc, max_len, 1)
        qd, ld = torch.from_numpy(q).to(dev), torch.from_numpy(lens).to(dev)
        out = _smem_batch(index, qd, ld, self_match, max_len, maxi, maxm,
                          lanes=lanes, compact=CAP)
        tot = int(out[3])
        if tot > CAP:
            # rare: pool denser than the budget — uncompacted rerun
            out = _smem_batch(index, qd, ld, self_match, max_len, maxi,
                              maxm, lanes=lanes)
            g3, mn, _, ovf = (t.cpu().numpy() for t in out)
            dec = _decode_batch(g3, mn)
        else:
            cvals = out[0][:tot].cpu().numpy()
            info = out[1].cpu().numpy()
            mn = np.minimum(info & ((1 << 30) - 1), maxm)
            ovf = info >> 30
            dec = _decode_compact(cvals, mn)
        for t, si in enumerate(ids):
            if ovf[t]:
                redo.append(si)
            else:
                results[si] = dec[t]
    _learn_maxi(index, len(redo), len(seqs), maxi)
    STATS["reads"] += len(ids_all)
    STATS["redo"] += len(redo)
    STATS["maxi"] = getattr(index, "_smem_maxi", None)
    _redo_ladder(index, seqs, redo, results, self_match, max_len, maxi,
                 maxm)
    return results


def _decode_compact(cvals, mn):
    """Decode the compacted output: cvals [tot, 3] holds the valid
    (kf, sz, meta) rows of every read back to back in read order; mn gives
    per-read counts.  Same emission-order lexsort as _decode_batch, with the
    flat position standing in for the per-read column."""
    NPn = mn.shape[0]
    tot = int(mn.sum())
    rows = np.repeat(np.arange(NPn), mn)
    meta = cvals[:tot, 2].astype(np.int64)
    order = np.lexsort((-np.arange(tot), meta >> 21, rows))
    m2 = meta[order]
    tup = list(zip(((m2 >> 1) & 1023).tolist(),
                   ((m2 >> 11) & 1023).tolist(),
                   cvals[:tot, 1][order].tolist(),
                   (m2 & 1).astype(bool).tolist(),
                   cvals[:tot, 0][order].tolist()))
    off = np.concatenate([[0], np.cumsum(mn)])
    # rows are mostly empty: share ONE empty list (callers only read) and
    # slice just the nonzero rows
    empty = []
    res = [empty] * NPn
    for r in np.flatnonzero(mn):
        res[r] = tup[off[r]: off[r + 1]]
    return res


def _decode_batch(g3, mn):
    """Unpack the per-read match buffers into the reference's emission
    order, for a whole batch at once (one lexsort).

    meta packs (seg << 21 | end << 11 | start << 1 | closed); matches were
    appended start-DESCENDING within each segment (the backward walk), and
    fm6_smem emits them start-ascending — the lexsort reverses each
    segment's slice."""
    mkf, msz, mmeta = g3[..., 0], g3[..., 1], g3[..., 2].astype(np.int64)
    NP, M = mmeta.shape
    mn = np.minimum(np.asarray(mn), M)
    cols = np.arange(M)
    rows, cc = np.nonzero(cols[None, :] < mn[:, None])
    meta = mmeta[rows, cc]
    order = np.lexsort((-cc, meta >> 21, rows))
    m2 = meta[order]
    tup = list(zip(((m2 >> 1) & 1023).tolist(),
                   ((m2 >> 11) & 1023).tolist(),
                   msz[rows, cc][order].tolist(),
                   (m2 & 1).astype(bool).tolist(),
                   mkf[rows, cc][order].tolist()))
    off = np.concatenate([[0], np.cumsum(mn)])
    empty = []
    res = [empty] * NP
    for r in np.flatnonzero(mn):
        res[r] = tup[off[r]: off[r + 1]]
    return res


def format_smem(index: FMDIndex, match) -> str:
    """fm6_write_smem text line: start, end, size (u32-clamped), flags."""
    start, end, size, closed, kf = match
    size = min(size, 0xFFFFFFFF)
    return (f"{start}\t{end}\t{size}\t{'OT'[int(closed)]}"
            f"{'OT'[int(kf < index.n_seqs)]}")
