"""Device error-correction fix: bounded-beam search.

The port of fermi_tpu/search/ecfix_device.py.  The reference ec_fix1
(correct.c:121-220) is a best-first search with a 256-capped heap per read;
here every read of a wave is a row of K beam lanes, and each round expands
every live lane once:

- the sequential search pops states in ascending (score, insertion order,
  position); the first two TERMINALS it pops are the two globally-minimal
  score terminals, and `score_diff` equals min(s2 - s1, kMaxScDiff)
  whether or not its early break at s1 + kMaxScDiff fires;
- so a round-synchronous flood that expands every live state once per
  round, retires terminals and keeps the two best terminal scores computes
  the same result, PROVIDED no state the sequential search would explore is
  dropped and no score tie makes the winner order-dependent.

Every condition that could break that proviso flags the read for an exact
redo on the host engine (native/ec.cpp): beam overflow (> K live lanes
needed), a total push count near the reference's 256-entry heap cap, a tie
for the best terminal score, or a round-budget overrun.

Differences from fermi_tpu's version, each bringing it to the host engine's
result (ROADMAP §3):

- A miss at an N emits base 0 (A), as save_state's `c >= 4 -> 0` does
  (ec.cpp:114); fermi_tpu emits 4, keeping the N and extending the k-mer
  with a T.
- The wave returns the no-hit flag in bit 17 (ec.cpp:225) and no-hit reads
  are not redone.  That is exact: a read with no hash hit is a search in
  which every state has one child, a single chain from the seed to the
  terminal, and the sequential search and the beam both walk all of it.
  fermi_tpu never sets the bit and redoes such reads.
- The skip-mode occurrence ratio is tested as (double)occ / occ_last >= 0.8,
  as the host engine does (ec.cpp:194); fermi_tpu compares occ >=
  0.8 * occ_last in float32 (the two agree for all counts below 400, and
  occ is at most 7 * 32).
- A read whose first strand is too short (ret 0xffff) keeps its bases: the
  host engine does not run the second strand for it (ec.cpp:259), and
  neither does this port's result (fermi_tpu takes the second strand's).

JAX's while_loop becomes a host loop whose condition ("a lane is live and
the round budget is not spent") is read from the device every round.

Per round, per live lane: one hash lookup (a statically bounded
open-addressing probe over a device-resident table), child generation and
the beam prune; the skip fast-forward of correct.c:176-199 runs as a lane
mode advancing at one lookup per round.
"""

import time

import numpy as np
import torch

from fermi_tpu_torch import native, resolve_device

# reference constants (correct.c / native/ec.cpp)
RATIO_FACTOR = 10
DIFF_FACTOR = 13
MAX_HEAP = 256
MAX_SC_DIFF = 60
MAX_QUAL = 40
MISS_PENALTY = 10
MIN_OCC = 5
MIN_OCC_RATIO = 0.8
BIG = 1 << 30
HASH_MULT = 0x9E3779B97F4A7C15

# Counters of the device fix since the last reset, for measurement (the
# chip smoke test reads them): waves, rounds, host seconds in the round
# loops, reads, reads redone on the host engine.
STATS = {"waves": 0, "rounds": 0, "round_s": 0.0, "n": 0, "n_redo": 0}


def _signed64(u: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    return u - (1 << 64) if u >= 1 << 63 else u


def build_device_table(cls, key, val, w, max_probe=8, device=None):
    """Open-addressing table over (cls, key, val) for device lookups.

    Identity of an entry is the full w-mer packed exactly as the search
    state x: id = (key>>2) << 2*suf_len | cls.  Linear probing from the home
    slot (id * mult mod 2^64) >> (64 - logt), entries inserted in input
    order; the multiplier and size are chosen so the longest probe sequence
    is < max_probe, making the device probe loop statically bounded.  The
    same table as fermi_tpu's build_device_table, filled by native code
    (native/ec.cpp fec_device_table) instead of a Python loop."""
    dev = resolve_device(device)
    suf_len = w - 15 if w > 15 else 1
    n = len(key)
    ids = np.ascontiguousarray(
        ((key.astype(np.int64) >> 2) << (2 * suf_len)) | cls.astype(np.int64))
    vals = np.ascontiguousarray(
        (val.astype(np.int32) << 2) | (key.astype(np.int64) & 3).astype(np.int32))
    logt = max(int(np.ceil(np.log2(max(n, 1) * 2.5))), 10)
    lib = native.get_ec_lib()
    for salt in range(32):
        mult = HASH_MULT + 2 * salt
        slots = np.full(1 << logt, -1, np.int64)
        svals = np.zeros(1 << logt, np.int32)
        if lib.fec_device_table(ids.ctypes.data, vals.ctypes.data, n, logt,
                                mult, max_probe, slots.ctypes.data,
                                svals.ctypes.data) == 0:
            return dict(slots=torch.from_numpy(slots).to(dev),
                        vals=torch.from_numpy(svals).to(dev), logt=logt,
                        mult=_signed64(mult), probes=max_probe,
                        suf_len=suf_len, w=w)
        logt += 1
    raise RuntimeError("ec device table: probe bound not met")


def table_hash(x: torch.Tensor, logt: int, mult: int) -> torch.Tensor:
    """Home slot of ids x: (x * mult mod 2^64) >> (64 - logt), as numpy's
    uint64 computes it.  Trouble spot: torch has no uint64.  The product
    is taken in int64, which wraps to the same 64-bit pattern; the shift is
    arithmetic, so the mask keeps only the logt bits the logical shift
    would leave."""
    return ((x * mult) >> (64 - logt)) & ((1 << logt) - 1)


def _lookup(slots, vals, logt, mult, probes, x):
    """Batch lookup: x int64 [...] -> (hit bool, best int32, v int32).

    Entries are unique, so probing a fixed `probes` steps and matching by
    id is exact (an existing id lies within the build-time probe bound)."""
    mask = (1 << logt) - 1
    h = table_hash(x, logt, mult)
    found = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    res = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for d in range(probes):
        p = (h + d) & mask
        hit = ~found & (slots[p] == x)
        res = torch.where(hit, vals[p], res)
        found = found | hit
    return found, res & 3, res >> 2


def ratio_ok(occ: torch.Tensor, occ_last: torch.Tensor) -> torch.Tensor:
    """The skip-mode occurrence test of the host engine, (double)occ /
    occ_last >= 0.8 (ec.cpp:194), with its IEEE division (x/0 = inf,
    0/0 = nan)."""
    return occ.to(torch.float64) / occ_last.to(torch.float64) >= MIN_OCC_RATIO


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[b, idx[b, k]] for a [B, N] and idx [B, K]."""
    return torch.gather(a, 1, idx)


def _fix_wave(table, S: torch.Tensor, Q: torch.Tensor, K: int, step: int):
    """One ec_fix1 strand for B reads in lockstep.

    S: uint8 [B, L] nt6 (1..4, 5=N, 0 pad); Q: uint8 [B, L] ASCII quals,
    both on the table's device.  Returns (ret int32 [B], S', Q', redo bool
    [B], rounds)."""
    slots, tvals = table["slots"], table["vals"]
    logt, mult, probes, w = (table["logt"], table["mult"], table["probes"],
                             table["w"])
    B, L = S.shape
    dev = S.device
    shift = (w - 1) << 1
    rows = torch.arange(B, device=dev)
    Si = S.to(torch.int64)
    Qi = Q.to(torch.int32)
    lens = (S > 0).sum(1).to(torch.int32)

    def lk(x):
        return _lookup(slots, tvals, logt, mult, probes, x)

    # seed state (correct.c:134-143): trailing w-mer, N resets the run
    x0 = torch.zeros(B, dtype=torch.int64, device=dev)
    i0 = lens - 1
    l0 = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(L):
        if t % 8 == 0 and bool(done.all()):
            break
        j = lens - 1 - t
        act = ~done & (j > 0)
        c = Si[rows, j.clamp_min(0)]
        isn = c == 5
        x0 = torch.where(act, torch.where(isn, 0, (c - 1) << shift | (x0 >> 2)),
                         x0)
        l0 = torch.where(act, torch.where(isn, 0, l0 + 1), l0)
        i0 = torch.where(act, j - 1, i0)
        done = done | (l0 >= w) | ~act
    valid = (lens > w) & (i0 > 0) & (l0 >= w)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    z = full((B, K), 0, torch.int64)
    z[:, 0] = x0
    pos = full((B, K), -1, torch.int32)
    pos[:, 0] = torch.where(valid, i0 + 1, -1)
    score = full((B, K), BIG, torch.int32)
    score[:, 0] = torch.where(valid, 0, BIG)
    mode = full((B, K), 0, torch.int32)         # 1 = skip fast-forward
    skx = full((B, K), 0, torch.int64)          # committed z0.x
    skp = full((B, K), 0, torch.int32)          # committed z0 pos
    skocc = full((B, K), 0, torch.int32)        # occ_last
    path = full((B, K, L), 0, torch.uint8)      # c<<2 | has_match<<1 | 1
    s1 = full((B,), BIG, torch.int32)
    s2 = full((B,), BIG, torch.int32)
    best_path = full((B, L), 0, torch.uint8)
    redo = full((B,), False, torch.bool)
    hit_any = full((B,), False, torch.bool)
    pushes = full((B,), 1, torch.int32)
    col = torch.arange(L, dtype=torch.int32, device=dev)
    W = 2 * K

    r = 0
    while r < 4 * L + 16 and bool((pos > 0).any()):
        alive = pos > 0
        i = (pos - 1).clamp_min(0).to(torch.int64)
        sq = _take(Si, i).to(torch.int32)
        q = (_take(Qi, i) - 33).clamp(3, MAX_QUAL)
        normal = alive & (mode == 0)
        skipm = alive & (mode == 1)

        # --- skip mode: roll up to `step` bases, then one lookup and a
        # commit-or-break decision (correct.c:176-199)
        rx, rp, stop = z, pos, ~skipm
        for _ in range(step):
            j = rp - 1
            can = ~stop & (j >= 1)
            c = _take(Si, j.clamp_min(0).to(torch.int64))
            bad = c >= 5
            mv = can & ~bad
            rx = torch.where(mv, (c - 1) << shift | (rx >> 2), rx)
            rp = torch.where(mv, rp - 1, rp)
            stop = stop | bad | (j <= 1)
        rnext = _take(Si, (rp - 1).clamp_min(0).to(torch.int64)).to(torch.int32)
        sk_hit, sk_best, sk_v = lk(rx)
        occ = torch.where((sk_v & 7) > 0, (sk_v & 7) * ((sk_v >> 3) + 1),
                          sk_v >> 3)
        good = (skipm & (rnext != 5) & sk_hit & (rnext == sk_best + 1)
                & ((sk_v & 7) <= 1) & (occ >= MIN_OCC) & ratio_ok(occ, skocc))
        new_skx = torch.where(good, rx, skx)
        new_skp = torch.where(good, rp, skp)
        new_skocc = torch.where(good, occ, skocc)
        sk_cont = skipm & good & (new_skp > 1)
        sk_end = skipm & ~sk_cont
        sk_c = (_take(Si, (new_skp - 1).clamp_min(0).to(torch.int64))
                .to(torch.int32) - 1).clamp_min(0)

        # --- normal-mode expansion (correct.c:151-207)
        hit, best, v = lk(z)
        hit = hit & normal
        hit_any = hit_any | hit.any(1)
        match = hit & (sq == best + 1)
        mism = hit & ~match
        miss = normal & ~hit
        v7, v3 = v & 7, v >> 3
        mx = torch.where(v7 > 0, v7 * v3, v3)
        pen = torch.where(mx - v7 < 1, 1, (mx - v7) * DIFF_FACTOR)
        pen = torch.minimum(pen, torch.where(v7 > 0, v3 * RATIO_FACTOR, 10000))
        pen = torch.minimum(pen, (7 - v7) * DIFF_FACTOR).clamp_min(1)
        isn5 = sq == 5
        occ_last0 = torch.where(v7 > 0, v7 * (v3 + 1), v3)
        enter_skip = match & (v7 <= 0) & (step > 1) & (pos > 1)
        match_emit = match & ~enter_skip
        ms_sc = MISS_PENALTY + (MAX_QUAL - q)

        # --- child slots [B, K, 2]
        # slot0: single-emit (match/miss/sk_end) | mism keep-own | carry
        # slot1: mism take-best
        single = match_emit | miss | sk_end
        carry = sk_cont | enter_skip
        s0_valid = single | (mism & ~isn5) | carry
        s0_c = torch.where(sk_end, sk_c, (sq - 1).clamp_min(0))
        # save_state emits c >= 4 (an N kept on a miss) as base 0
        s0_c = torch.where(s0_c >= 4, 0, s0_c)
        s0_sc = torch.where(miss, ms_sc, torch.where(mism, pen, 0))
        s0_hm = torch.where(miss, 0, 1).to(torch.int32)
        # parent x/pos of the emitted child (sk_end emits from the
        # committed z0); carried lanes reuse these as their next state
        s0_bx = torch.where(skipm, new_skx, z)
        s0_bp = torch.where(skipm, new_skp, pos)
        # carried skip registers: fresh entry commits the current state
        s0_skx = torch.where(enter_skip, z, new_skx)
        s0_skp = torch.where(enter_skip, pos, new_skp)
        s0_skocc = torch.where(enter_skip, occ_last0, new_skocc)
        ch_valid = torch.stack([s0_valid, mism], 2)
        ch_carry = torch.stack([carry, torch.zeros_like(carry)], 2)
        ch_c = torch.stack([s0_c, best], 2)
        ch_sc = score[:, :, None] + torch.stack([s0_sc, q], 2)
        ch_hm = torch.stack([s0_hm, torch.ones_like(s0_hm)], 2)
        ch_bx = torch.stack([s0_bx, z], 2)
        ch_bp = torch.stack([s0_bp, pos], 2)
        c_skx = torch.stack([s0_skx, z], 2)
        c_skp = torch.stack([s0_skp, pos], 2)
        c_skocc = torch.stack([s0_skocc, occ_last0], 2)
        cx = torch.where(ch_carry, ch_bx,
                         (ch_c.to(torch.int64) << shift) | (ch_bx >> 2))
        cpos = torch.where(ch_carry, ch_bp, ch_bp - 1)

        # cap check vs the reference's 256-entry heap
        nchild = (alive[:, :, None] & ch_valid & ~ch_carry).sum((1, 2))
        pushes = pushes + nchild.to(torch.int32)
        redo = redo | (pushes > MAX_HEAP - 8)

        # prune to K (stable by score; ties among kept lanes are fine,
        # drops are not -- redo on overflow)
        ckey = torch.where(ch_valid, ch_sc, BIG).reshape(B, W)
        corder = torch.argsort(ckey, dim=1, stable=True)[:, :K]
        csel = _take(ckey, corder)
        redo = redo | (ch_valid.reshape(B, W).sum(1) > K)
        nvalid = csel < BIG

        def pick(a):
            return _take(a.reshape(B, W), corder)

        nx = pick(cx)
        npos = pick(cpos)
        ncarry = pick(ch_carry) & nvalid
        nskx = pick(c_skx)
        nskp = pick(c_skp)
        nskocc = pick(c_skocc)
        ei = (pick(ch_bp) - 1).clamp_min(0)
        entry = (pick(ch_c) << 2 | pick(ch_hm) << 1 | 1).to(torch.uint8)
        par_idx = (corder // 2)[:, :, None].expand(B, K, L)
        ppath = torch.gather(path, 1, par_idx)
        oh = col[None, None, :] == ei[:, :, None]
        npath = torch.where(oh & (nvalid & ~ncarry)[:, :, None],
                            entry[:, :, None], ppath)

        # terminals: emitted children that reached pos 0
        term = nvalid & ~ncarry & (npos == 0)
        tsc = torch.where(term, csel, BIG)
        t_arg = torch.argmin(tsc, 1)             # first minimum
        t_min = tsc[rows, t_arg]
        tsc2 = tsc.clone()
        tsc2[rows, t_arg] = BIG
        t_min2 = tsc2.min(1).values
        better = t_min < s1
        s2 = torch.where(better, torch.minimum(s1, t_min2),
                         torch.minimum(s2, t_min))
        best_path = torch.where(better[:, None], npath[rows, t_arg], best_path)
        s1 = torch.where(better, t_min, s1)
        redo = redo | ((s2 == s1) & (s1 < BIG))

        live = nvalid & ~term
        z = nx
        score = torch.where(live, csel, BIG)
        pos = torch.where(live, npos, -1)
        mode = ncarry.to(torch.int32)
        skx, skp, skocc = nskx, nskp, nskocc
        path = npath
        r += 1

    redo = redo | (pos > 0).any(1)
    # decode (correct.c:209-225)
    found = valid & (s1 < BIG)
    sdiff = torch.where(s2 >= BIG, MAX_SC_DIFF,
                        (s2 - s1).clamp_max(MAX_SC_DIFF))
    present = (best_path & 1) > 0
    pc = (best_path >> 2).to(torch.int32)
    hm = (best_path >> 1) & 1
    act = (found & (s1 > 0))[:, None]
    corr = present & (pc + 1 != S.to(torch.int32)) & act
    S2 = torch.where(corr, (pc + 1).to(S.dtype), S)
    qsum = torch.where(corr, Qi - 33, 0).sum(1).to(torch.int32)
    bump = present & (hm > 0) & ~corr & (Q < 37) & act
    Q2 = torch.where(bump, torch.full_like(Q, 37), Q)
    no_hits = (~hit_any).to(torch.int32) << 17
    ret = torch.where(~valid, 0xffff,
                      torch.where(s1 >= BIG, MAX_SC_DIFF << 18,
                                  torch.where(s1 == 0, sdiff << 18,
                                              qsum | (sdiff << 18) | no_hits)))
    return ret.to(torch.int32), S2, Q2, redo & valid, r


_COMP6 = np.array([0, 4, 3, 2, 1, 5, 6, 7], np.uint8)


def _pack(seqs, quals, L):
    """Reads as nt6 and ASCII-quality rows [B, L] (0-padded), and lengths."""
    from fermi_tpu_torch.core.dna import NT6_TABLE

    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    inside = np.arange(L)[None, :] < lens[:, None]
    S = np.zeros((len(seqs), L), np.uint8)
    Q = np.zeros((len(seqs), L), np.uint8)
    S[inside] = NT6_TABLE[np.frombuffer(b"".join(seqs), np.uint8)]
    Q[inside] = np.frombuffer(b"".join(quals), np.uint8)
    return S, Q, lens


def _flip(S, lens, comp):
    """Each row reversed within its own length (complemented when comp is
    a table), pads left 0."""
    L = S.shape[1]
    col = torch.arange(L, device=S.device)
    src = (lens[:, None] - 1 - col).clamp_min(0)
    out = torch.gather(S, 1, src)
    if comp is not None:
        out = comp[out.long()]
    return torch.where(col < lens[:, None], out, 0)


def fix_reads_device(table_dev, opt, seqs, quals, native_table=None,
                     n_threads=4, wave=16384):
    """Device ec_fix over a batch of reads: both strands (RC first, then
    forward over the mutated bases — reference correct.c:229-243), exact
    host-engine redo for flagged reads, ASCII casing.

    Batches larger than `wave` go in waves of `wave` reads (the last one
    as it is), so lane state stays a few hundred MB.

    Returns (seqs, quals, info, stats) matching algos.correct.fix_reads."""
    from fermi_tpu_torch.algos.correct import fix_reads

    n = len(seqs)
    if n > wave:
        out_s, out_q = [], []
        info = np.zeros(n, np.int32)
        n_redo = 0
        for lo in range(0, n, wave):
            s_, q_, i_, st = fix_reads_device(
                table_dev, opt, seqs[lo: lo + wave], quals[lo: lo + wave],
                native_table=native_table, n_threads=n_threads, wave=wave)
            out_s.extend(s_)
            out_q.extend(q_)
            info[lo: lo + len(s_)] = i_
            n_redo += st["n_redo"]
        return out_s, out_q, info, dict(n_redo=n_redo, n=n)
    dev = table_dev["slots"].device
    L = max((len(s) for s in seqs), default=1)
    L = -(-max(L, 8) // 32) * 32
    S_h, Q_h, lens_h = _pack(seqs, quals, L)
    S = torch.from_numpy(S_h).to(dev)
    Q = torch.from_numpy(Q_h).to(dev)
    lens = torch.from_numpy(lens_h).to(dev)
    comp6 = torch.from_numpy(_COMP6).to(dev)
    step = opt.get("step", 5)
    K = 16
    t0 = time.perf_counter()
    # strand 1: reverse complement
    r0, S1, Q1, redo0, n0 = _fix_wave(table_dev, _flip(S, lens, comp6),
                                      _flip(Q, lens, None), K, step)
    S1, Q1 = _flip(S1, lens, comp6), _flip(Q1, lens, None)
    # strand 2 over the mutated bases; not run for 0xffff reads
    # (reference correct.c:258): they keep strand 1's bases
    r1, S2, Q2, redo1, n1 = _fix_wave(table_dev, S1, Q1, K, step)
    short = r0 == 0xffff
    S2 = torch.where(short[:, None], S1, S2)
    Q2 = torch.where(short[:, None], Q1, Q2)
    redo = (redo0 | redo1).cpu().numpy()
    r0, r1 = r0.cpu().numpy(), r1.cpu().numpy()
    fin, qf = S2.cpu().numpy(), Q2.cpu().numpy()
    STATS["waves"] += 2
    STATS["rounds"] += n0 + n1
    STATS["round_s"] += time.perf_counter() - t0

    info = np.zeros(n, np.int32)
    short = r0 == 0xffff
    info[short] = 0xffff
    ok = ~short
    sd = np.minimum(r0 >> 18, r1 >> 18)
    info[ok] = ((r0[ok] & 0xffff) + (r1[ok] & 0xffff)) | (sd[ok] << 18)
    both_nohit = ((r0 >> 17) & 1) & ((r1 >> 17) & 1)
    info[ok & (both_nohit > 0)] |= 1 << 16
    # ASCII casing (reference correct.c:245-254 / ec.cpp fix_read tail):
    # unchanged bases upper-cased, changed ones as lower-case acgtn with
    # quality 36
    inside = np.arange(L)[None, :] < lens_h[:, None]
    asc = np.zeros((n, L), np.uint8)
    asc[inside] = np.frombuffer(b"".join(seqs), np.uint8)
    eq = S_h == fin
    upper = np.where((asc >= 97) & (asc <= 122), asc - 32, asc)
    low6 = np.frombuffer(b"$acgtn", np.uint8)
    res = np.where(eq, upper, low6[np.minimum(fin, 5)])
    lower = ~eq & inside
    qf = np.where(lower, 36, qf).astype(np.uint8)
    n_lower = lower.sum(1)
    # (double)n_lower / len > max_corr, max_corr a C float (ec.cpp:272)
    max_corr = float(np.float32(opt.get("max_corr", 0.3)))
    info[n_lower / np.maximum(lens_h, 1) > max_corr] |= 1 << 16
    info[info >> 18 <= 10] |= 1 << 16
    out_s = [res[r, :lens_h[r]].tobytes() for r in range(n)]
    out_q = [qf[r, :lens_h[r]].tobytes() for r in range(n)]
    # exact host-engine redo for flagged reads
    n_redo = int(redo.sum())
    STATS["n"] += n
    STATS["n_redo"] += n_redo
    if n_redo and native_table is not None:
        idxs = np.flatnonzero(redo)
        fs, fq, fi, _ = fix_reads(native_table, opt, [seqs[i] for i in idxs],
                                  [quals[i] for i in idxs], n_threads)
        for j, i in enumerate(idxs):
            out_s[i] = fs[j]
            out_q[i] = fq[j]
            info[i] = fi[j]
    return out_s, out_q, info, dict(n_redo=n_redo, n=n)
