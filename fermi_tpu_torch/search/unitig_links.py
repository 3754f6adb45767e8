"""Bulk computation of unitig link records on the index's device.

The port of fermi_tpu/search/unitig_links.py, pass 1 of the bulk-link
unitig (algos/unitig_bulk.py): for B stored sequences at a time, the
overlap walk + containment bi-interval (reference unitig.c:38-91) and the
full fm6_get_nei round loop (unitig.c:93-179) as two phases of batched
extend6 calls, so every extension is kernel K1 on the card:

  walk -- [B] lanes, one bi-interval each, backward over the read; per
    round one batched extend6; records the overlap list into [B, Lmax]
    buffers; finishes with the two containment extensions.

  get_nei -- [B, Jmax] interval lanes seeded from the overlap lists; per
    round one forward extend6 over all lanes + one backward sentinel test
    over the packed candidate columns, then the category logic (full-match
    detection, segmented group kill, neighbor/used-bit recording, child
    compaction + sort, category renumbering) as tensor ops per row.

Category semantics (unitig.c:137-153): lanes are kept sorted by (category,
next-base, overlap-offset); a full sentinel match kills the rest of its
category; children regroup by (old category, base).  The "first full lane
of each group kills lanes at >= its index" rule is a segmented forward
cummin over the fixed-width row.

Overflow of any fixed buffer (Jmax lanes, NMAX neighbors, SBMAX
used-intervals, round budget) sets a per-row redo flag; rows still flagged
after the wide ladder pass are recomputed exactly by the host stitch.  The
records equal fermi_tpu's array for array (tests/test_torch_unitig.py).
fermi_tpu packs a child lane's sort key in int32 with a 10-bit overlap
offset and refuses reads of 1,024 bp or more; here the key is int64 with a
32-bit offset, so reads of any length get their records (the MAG of long
reads is fermi_tpu's host walk's, tests/test_torch_unitig.py).

JAX's fori/while loops become Python loops over torch ops.  The walk runs
exactly its batch's longest read; where fermi_tpu leaves the stale keys of
rows past their read's start in the batched extension, their keys go to 0
(the results are discarded either way, and row 0 stays in cache).  The
get_nei loop reads the number of rows with a live lane once a round; it
extends only the live lanes and slots (fermi_tpu extends every one, the
dead ones at size 0, whose results no record reads), and once half its
rows have no live lane left it drops them from the working set, since
their state no longer changes.
"""

import sys
import time

import numpy as np
import torch

from fermi_tpu_torch import resolve_device
from fermi_tpu_torch.algos.unitig_bulk import Link
from fermi_tpu_torch.ops import rank_cuda

NMAX = 16     # neighbor records per sequence
SBMAX = 24    # used-bit interval records per sequence
_I32MAX = 2 ** 31 - 1
# A child lane's sort key packs (category, base, overlap offset) into int64:
# the offset in the low OFF_BITS bits, so a read of any length fits.
OFF_BITS = 32
_KEYMAX = 2 ** 63 - 1
# The walk's [B, Lmax + 1] overlap buffers of one batch hold at most this
# many cells (16 B each in the int32 domain): a batch of long reads takes
# fewer rows.
WALK_CELLS = 1 << 28

# Counters of the last unitig run, for measurement (the chip smoke test
# reads them): seconds by part, unique sequences, rounds of the walk and
# get_nei loops, ladder rows, rows left to the host stitch, K1 launches,
# and the batch sizes used.
_STATS0 = dict(retrieve_s=0.0, walk_s=0.0, getnei_s=0.0, ladder_s=0.0,
               stitch_s=0.0, unique=0, walk_rounds=0, getnei_rounds=0,
               ladder_rows=0, redo_left=0, k1_launches=0, batch=0,
               ladder_batch=0, stitch_recoveries=0)
STATS = dict(_STATS0)


def _walk_phase(index, R, lens, mm):
    """Overlap walk + containment (unitig.c:38-91) for [B, Lmax] reads
    (R uint8, lens int32, on the index's device).

    Returns per-row: ovlp buffers (kb, kf, sz idtype; off int32) in walk
    order (increasing depth, decreasing offset), ovn, ret, intv0."""
    B, Lmax = R.shape
    dev, idt = index.device, index.idtype
    rows = torch.arange(B, device=dev)
    lastc = R[rows, (lens - 1).long()]
    kb, kf, sz = index.set_intv(lastc)
    sz = torch.where(lens > mm, sz, 0)
    ov_kb = torch.zeros((B, Lmax + 1), dtype=idt, device=dev)
    ov_kf = torch.zeros_like(ov_kb)
    ov_sz = torch.zeros_like(ov_kb)
    ov_off = torch.zeros((B, Lmax + 1), dtype=torch.int32, device=dev)
    ovn = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(Lmax - 1):
        j = lens - 2 - t
        act = (j >= 0) & (sz > 0)
        c = R[rows, j.clamp(min=0).long()].long()[:, None]
        # rows past their read's start extend key 0: results discarded
        KB, KF, SZ = index.extend6(torch.where(act, kb, 0),
                                   torch.where(act, kf, 0),
                                   torch.where(act, sz, 0), True)
        csel = SZ.gather(1, c)[:, 0]
        step = act & (csel > 0)
        if t + 1 >= mm:
            # record the pre-extension interval when the sentinel branch
            # is live and the walk does not die here
            rec = step & (SZ[:, 0] > 0)
            slot = torch.where(rec, ovn, Lmax).long()
            ov_kb[rows, slot] = kb
            ov_kf[rows, slot] = kf
            ov_sz[rows, slot] = sz
            ov_off[rows, slot] = j + 1
            ovn += rec.to(torch.int32)
        kb = torch.where(step, KB.gather(1, c)[:, 0], kb)
        kf = torch.where(step, KF.gather(1, c)[:, 0], kf)
        sz = torch.where(step, csel, torch.where(act, 0, sz))
    # containment tail (unitig.c:82-90)
    KB, KF, SZ = index.extend6(kb, kf, sz, True)
    ret = torch.where(sz != SZ[:, 0], -1, 0)
    KB2, KF2, SZ2 = index.extend6(KB[:, 0], KF[:, 0], SZ[:, 0], False)
    ret = torch.where(SZ[:, 0] != SZ2[:, 0], -1, ret)
    intv0 = (KB2[:, 0], KF2[:, 0], SZ2[:, 0])
    return (ov_kb[:, :Lmax], ov_kf[:, :Lmax], ov_sz[:, :Lmax],
            ov_off[:, :Lmax], ovn, ret, intv0)


def _seg_cummin(v, b):
    """Per-row segmented forward cummin of v (int32, >= 0), reset where b
    is true.  The segment index is folded into an int64 key, each later
    segment 2^32 lower, so a plain cummin along the row never reaches
    past a boundary."""
    seg = torch.cumsum(b, 1, dtype=torch.int64) << 32
    return (torch.cummin(v.to(torch.int64) - seg, 1).values + seg).to(v.dtype)


def _land(bufs, vals, mask, cnt, width):
    """Append the values of the masked lanes of each row to its buffers at
    cnt + (exclusive prefix count of the mask); positions >= width are
    dropped (the row's count still grows, so the caller flags redo).  The
    buffers are [B, width + 1]: unmasked lanes write the spare column."""
    m = mask.to(torch.int32)
    pos = cnt[:, None] + torch.cumsum(m, 1, dtype=torch.int32) - m
    col = torch.where(mask & (pos < width), pos, width).long()
    for buf, v in zip(bufs, vals):
        buf.scatter_(1, col, v.to(buf.dtype).expand_as(col))
    return cnt + m.sum(1, dtype=torch.int32)


def _extend_live(index, kb, kf, sz, live, is_back, col=None):
    """extend6 of the lanes where `live` only (column `col` of each result,
    or all six); every other lane gets 0.  A lane that is not live is one
    fermi_tpu extends with size 0, whose result no record reads."""
    idx = live.reshape(-1).nonzero()[:, 0]
    res = index.extend6(kb.reshape(-1)[idx], kf.reshape(-1)[idx],
                        sz.reshape(-1)[idx], is_back)
    out = []
    for r in res:
        if col is not None:
            r = r[:, col]
        full = r.new_zeros((live.numel(), *r.shape[1:]))
        full[idx] = r
        out.append(full.view(*live.shape, *r.shape[1:]))
    return out


# the get_nei state that is output (the rest lives only inside the loop)
_OUTS = ("nei0", "nei1", "nei2", "nei3", "nei4", "sb0", "sb1", "sb2",
         "nein", "sbn", "forked", "redo")


def _getnei_round(index, st, lane, ncand):
    """One fm6_get_nei round (unitig.c:109-155) over the rows of `st`, in
    place."""
    B, jmax = st["alive"].shape
    alive, kb, kf, sz, off, cat = (st[k] for k in ("alive", "kb", "kf", "sz",
                                                   "off", "cat"))
    first = torch.ones((B, 1), dtype=torch.bool, device=alive.device)
    KB, KF, SZ = _extend_live(index, kb, kf, sz, alive, False)
    # pack the first `ncand` live candidate bases (ascending c) of each
    # lane; redo rows where a processed lane has more
    cn = SZ[:, :, 1:5] > 0                                   # [B, J, 4]
    order = torch.sort((~cn).to(torch.int32), dim=2, stable=True).indices
    order = order[:, :, :ncand]
    cKB = KB[:, :, 1:5].gather(2, order)
    cKF = KF[:, :, 1:5].gather(2, order)
    cSZ = SZ[:, :, 1:5].gather(2, order)
    cval = cSZ > 0
    cc = (order + 1).to(torch.int32)                         # the bases
    # backward sentinel test of the sentinel column (live lanes past round
    # 0 with a live sentinel branch) and the packed candidates (a live
    # base): the slots of positive size
    ok0 = SZ[:, :, 0]
    ok0_live = alive & (st["appended"] > 0)[:, None] & (ok0 > 0)
    bkb = torch.cat([KB[:, :, :1], cKB], 2)
    bkf = torch.cat([KF[:, :, :1], cKF], 2)
    bsz = torch.cat([torch.where(ok0_live, ok0, 0)[:, :, None], cSZ], 2)
    BKB0, BKF0, BSZ0 = _extend_live(index, bkb, bkf, bsz, bsz > 0, True,
                                    col=0)
    sbkb, sbkf, sbsz = BKB0[:, :, 0], BKF0[:, :, 0], BSZ0[:, :, 0]
    sent = ok0_live & (sbsz > 0)
    full = sent & (ok0 == sz) & (sz == sbsz)
    # first full lane per category group kills lanes at >= its index
    bnd = torch.cat([first, cat[:, 1:] != cat[:, :-1]], 1)
    ff = _seg_cummin(torch.where(full, lane, _I32MAX), bnd)
    process = alive & (lane < ff)
    append = full & (lane == ff)
    partial_sb = process & sent & ~full
    redo = st["redo"] | (process & (cn.sum(2) > ncand)).any(1)

    # neighbor / used-bit records: a scatter at each row's count plus the
    # lane's exclusive prefix count
    st["nein"] = _land([st[f"nei{i}"] for i in range(5)],
                       (sbkb, sbkf, sbsz, st["lens"][:, None] - off,
                        st["appended"][:, None]), append, st["nein"], NMAX)
    st["sbn"] = _land([st[f"sb{i}"] for i in range(3)], (sbkb, sbkf, sbsz),
                      partial_sb, st["sbn"], SBMAX)
    redo |= (st["nein"] > NMAX) | (st["sbn"] > SBMAX)

    # children: (j major, c minor -- packing keeps ascending c), key =
    # (cat, c, off), unique among valid children
    cmask = process[:, :, None] & cval & (BSZ0[:, :, 1:] > 0)
    ckey = ((cat.to(torch.int64)[:, :, None] << (OFF_BITS + 3))
            | (cc.to(torch.int64) << OFF_BITS) | off[:, :, None])
    W = jmax * ncand
    ckey = torch.where(cmask, ckey, _KEYMAX).reshape(B, W)
    skey, sidx = torch.sort(ckey, dim=1)
    skey, sidx = skey[:, :jmax], sidx[:, :jmax]
    nvalid = skey != _KEYMAX
    st["redo"] = redo | (cmask.reshape(B, W).sum(1) > jmax)
    st["kb"] = cKB.reshape(B, W).gather(1, sidx)
    st["kf"] = cKF.reshape(B, W).gather(1, sidx)
    st["sz"] = cSZ.reshape(B, W).gather(1, sidx)
    st["off"] = (skey & ((1 << OFF_BITS) - 1)).to(torch.int32)
    # category renumber: group = runs of equal (cat, c) = key >> OFF_BITS
    khi = skey >> OFF_BITS
    nb = torch.cat([first, khi[:, 1:] != khi[:, :-1]], 1)
    ncat = torch.cummax(torch.where(nb, lane, 0), 1).values
    st["cat"] = torch.where(nvalid, ncat, 0)
    st["forked"] = st["forked"] | (nb[:, 1:] & nvalid[:, 1:]).any(1)
    st["appended"] = st["appended"] + nvalid.any(1).to(torch.int32)
    st["alive"] = nvalid


def _getnei_phase(index, ov_kb, ov_kf, ov_sz, ov_off, ovn, lens,
                  jmax, maxr, ncand):
    """fm6_get_nei rounds (unitig.c:109-155) for B rows at once.

    `ncand` is the number of packed candidate slots per lane for the
    backward sentinel test (the reference tests all four bases plus the
    sentinel).  Rows that exceed any budget (jmax lanes, ncand candidates,
    NMAX/SBMAX records, maxr rounds) are redo-flagged.  A row whose lanes
    are all dead no longer changes: once half the rows are, they leave the
    working set.  Returns the record buffers, forked, redo and the rounds
    run."""
    B = ov_kb.shape[0]
    dev, idt = index.device, index.idtype
    lane = torch.arange(jmax, dtype=torch.int32, device=dev)
    # seed lanes from the reversed overlap list (deepest last)
    src = ovn[:, None] - 1 - lane[None, :]
    valid = src >= 0
    srcc = src.clamp(min=0).long()
    st = {k: torch.where(valid, a.gather(1, srcc), 0) for k, a in
          (("kb", ov_kb), ("kf", ov_kf), ("sz", ov_sz), ("off", ov_off))}
    st.update(cat=torch.zeros((B, jmax), dtype=torch.int32, device=dev),
              alive=valid, lens=lens,
              **{k: torch.zeros(B, dtype=torch.int32, device=dev)
                 for k in ("nein", "sbn", "appended")},
              forked=torch.zeros(B, dtype=torch.bool, device=dev),
              redo=ovn > jmax)
    for i, dt in enumerate((idt, idt, idt, torch.int32, torch.int32)):
        st[f"nei{i}"] = torch.zeros((B, NMAX + 1), dtype=dt, device=dev)
    for i in range(3):
        st[f"sb{i}"] = torch.zeros((B, SBMAX + 1), dtype=idt, device=dev)
    out = dict(st)
    rid = torch.arange(B, device=dev)     # working rows' rows in `out`

    def write_back():
        for k in _OUTS:
            if st[k] is not out[k]:
                out[k][rid] = st[k]
    rounds = 0
    while rounds < maxr:
        live = st["alive"].any(1)
        n_live = int(live.sum())
        if n_live == 0:
            break
        if n_live <= live.numel() // 2:
            write_back()
            keep = live.nonzero()[:, 0]
            st = {k: v[keep] for k, v in st.items()}
            rid = rid[keep]
        _getnei_round(index, st, lane, ncand)
        rounds += 1
    st["redo"] = st["redo"] | st["alive"].any(1)
    write_back()
    return ([out[f"nei{i}"][:, :NMAX] for i in range(5)], out["nein"],
            [out[f"sb{i}"][:, :SBMAX] for i in range(3)], out["sbn"],
            out["forked"], out["redo"], rounds)


class LinkStore:
    """SoA link records for n stored sequences (host arrays); indexable
    like the list compute_links_host returns."""

    def __init__(self, n, idt=np.int64):
        self.n = n
        self.valid = np.zeros(n, bool)
        self.ret = np.zeros(n, np.int8)
        self.intv0 = np.zeros((n, 3), np.int64)
        self.has_ovlp = np.zeros(n, bool)
        self.nei_buf = tuple(
            np.zeros((n, NMAX), idt if i < 3 else np.int32)
            for i in range(5))     # (kb, kf, sz, ov, ext)
        self.nein = np.zeros(n, np.int32)
        self.sb_buf = tuple(np.zeros((n, SBMAX), idt) for _ in range(3))
        self.sbn = np.zeros(n, np.int32)
        self.forked = np.zeros(n, bool)
        self.redo = np.zeros(n, bool)
        self._overlay = {}

    def __getitem__(self, x):
        if x in self._overlay:
            return self._overlay[x]
        lk = Link()
        lk.ok = bool(self.valid[x])
        if not lk.ok:
            return lk
        lk.redo = bool(self.redo[x])
        lk.ret = int(self.ret[x])
        lk.intv0 = tuple(int(v) for v in self.intv0[x])
        lk.has_ovlp = bool(self.has_ovlp[x])
        lk.forked = bool(self.forked[x])
        nkb, nkf, nsz, nov, nex = self.nei_buf
        m = int(self.nein[x])
        lk.nei = [(int(nkb[x, i]), int(nkf[x, i]), int(nsz[x, i]),
                   int(nov[x, i]), int(nex[x, i])) for i in range(m)]
        skb, skf, ssz = self.sb_buf
        m = int(self.sbn[x])
        lk.sbits = [(int(skb[x, i]), int(skf[x, i]), int(ssz[x, i]))
                    for i in range(m)]
        return lk

    def __setitem__(self, x, lk):
        self._overlay[x] = lk

    def __len__(self):
        return self.n

    def harvest_walk(self, idxs, lens, min_match, ovn, ret, intv0):
        """Rows idxs' walk results (device tensors of the batch)."""
        self.valid[idxs] = lens > min_match
        self.ret[idxs] = ret.cpu().numpy()
        for d in range(3):
            self.intv0[idxs, d] = intv0[d].cpu().numpy()
        self.has_ovlp[idxs] = (ovn > 0).cpu().numpy()

    def harvest_getnei(self, idxs, nei, nein, sb, sbn, forked, redo):
        """Rows idxs' get_nei results (device tensors); returns redo as a
        host array."""
        redo = redo.cpu().numpy()
        self.nein[idxs] = nein.cpu().numpy()
        self.sbn[idxs] = sbn.cpu().numpy()
        self.forked[idxs] = forked.cpu().numpy()
        self.redo[idxs] = redo
        for buf, a in zip(self.nei_buf + self.sb_buf, nei + sb):
            buf[idxs] = a.cpu().numpy()
        return redo


def _pack_rows(seqs, idxs, lens):
    """[B, max(lens)] uint8 matrix of the selected reads, without a
    per-read Python loop over bases."""
    R = np.zeros((len(idxs), int(lens.max())), np.uint8)
    flat = np.concatenate([seqs[i] for i in idxs])
    rows = np.repeat(np.arange(len(idxs)), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(len(flat)) - np.repeat(offs, lens)
    R[rows, cols] = flat
    return R


def compute_links_device(index, seqs, min_match, batch=1 << 16,
                         ladder_batch=1 << 12, verbose=False,
                         jmax_primary=32, ncand_primary=2, maxr_primary=22,
                         device=None):
    """Link records of every sequence of `seqs` (list of nt6 arrays) on
    `device` (CUDA unless named), where `index` lives.  Returns a LinkStore;
    rows whose buffers overflowed even in the wide ladder pass stay .redo
    for exact host recomputation by the stitch.

    Cascade: dedup identical sequences -> length-sorted batches of `batch`
    rows: walk phase -> primary get_nei (tight budgets: jmax_primary lanes,
    ncand_primary candidate slots, maxr_primary rounds) -> ladder rerun of
    the overflowed rows, `ladder_batch` at a time (times the longest read's
    kbp past 1 kbp), with full budgets (128 lanes, 4 candidates, the
    longest read + 2 rounds).  A walk batch holds at most WALK_CELLS
    overlap cells.  The records do not depend on `batch` or
    `ladder_batch`."""
    dev = resolve_device(device)
    if index.device.type != dev.type:
        raise ValueError(f"compute_links_device: the index is on "
                         f"{index.device}, not on {dev}")
    STATS.update(_STATS0, batch=batch, ladder_batch=ladder_batch)
    k1_before = rank_cuda.LAUNCHES["rank6_fused"]
    n = len(seqs)
    idt_np = np.int32 if index.idtype == torch.int32 else np.int64
    store = LinkStore(n, idt_np)
    if n == 0:
        return store
    # dedup: identical sequences share identical records
    first = {}
    rep = np.arange(n)
    for i, s in enumerate(seqs):
        rep[i] = first.setdefault(s.tobytes(), i)
    reps = np.flatnonzero(rep == np.arange(n))
    lens_r = np.array([len(seqs[i]) for i in reps], np.int32)
    order = reps[np.argsort(lens_r, kind="stable")]
    lmax_g = int(lens_r.max())
    STATS["unique"] = len(reps)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ladder = []   # (idxs, ov rows, ovn, lens) of rows flagged redo
    lens_o = np.sort(lens_r)
    b0 = n_batches = 0
    while b0 < len(order):
        # `batch` rows, fewer where their longest read would take the
        # walk's buffers past WALK_CELLS (lengths ascend along `order`)
        m = min(batch, len(order) - b0)
        while m > 1 and m * (int(lens_o[b0 + m - 1]) + 1) > WALK_CELLS:
            m = max(1, min(m - 1, WALK_CELLS // (int(lens_o[b0 + m - 1]) + 1)))
        idxs = order[b0:b0 + m]
        b0 += m
        lens = lens_o[b0 - m: b0]
        t0 = time.perf_counter()
        R = torch.from_numpy(_pack_rows(seqs, idxs, lens)).to(dev)
        ld = torch.from_numpy(lens).to(dev)
        ovkb, ovkf, ovsz, ovoff, ovn, ret, intv0 = _walk_phase(
            index, R, ld, min_match)
        store.harvest_walk(idxs, lens, min_match, ovn, ret, intv0)
        STATS["walk_rounds"] += R.shape[1] - 1
        t1 = time.perf_counter()
        *outs, rounds = _getnei_phase(index, ovkb, ovkf, ovsz, ovoff, ovn,
                                      ld, jmax_primary, maxr_primary,
                                      ncand_primary)
        redo = store.harvest_getnei(idxs, *outs)
        STATS["getnei_rounds"] += rounds
        if redo.any():
            w = torch.from_numpy(np.flatnonzero(redo)).to(dev)
            ladder.append((idxs[redo], [a[w] for a in (ovkb, ovkf, ovsz, ovoff)],
                           ovn[w], ld[w]))
        STATS["walk_s"] += t1 - t0
        STATS["getnei_s"] += time.perf_counter() - t1
        if verbose and n_batches % 32 == 0:
            sys.stderr.write(f"[unitig_links] {b0}/{len(order)} "
                             f"uniq (+ladder "
                             f"{sum(len(t[0]) for t in ladder)})\n")
        n_batches += 1

    # ladder: rerun overflowed rows with full budgets
    t0 = time.perf_counter()
    if ladder:
        l_idx = np.concatenate([t[0] for t in ladder])
        lW = max(t[1][0].shape[1] for t in ladder)
        ovs = [torch.cat([torch.nn.functional.pad(t[1][d],
                                                  (0, lW - t[1][d].shape[1]))
                          for t in ladder]) for d in range(4)]
        ovn_l = torch.cat([t[2] for t in ladder])
        lens_l = torch.cat([t[3] for t in ladder])
        # a ladder batch runs up to the longest read's rounds: past 1 kbp
        # it takes proportionally more rows, so there are fewer batches
        lb = ladder_batch * max(1, lmax_g >> 10)
        STATS.update(ladder_rows=len(l_idx), ladder_batch=lb)
        if verbose:
            sys.stderr.write(f"[unitig_links] ladder: {len(l_idx)} rows\n")
        for b0 in range(0, len(l_idx), lb):
            sl = slice(b0, b0 + lb)
            *outs, rounds = _getnei_phase(
                index, *(a[sl] for a in ovs), ovn_l[sl], lens_l[sl],
                128, lmax_g + 2, 4)
            store.harvest_getnei(l_idx[sl], *outs)
            STATS["getnei_rounds"] += rounds
    sync()
    STATS["ladder_s"] = time.perf_counter() - t0

    # duplicates copy their representative's record
    dups = np.flatnonzero(rep != np.arange(n))
    if len(dups):
        r = rep[dups]
        for f in ("valid", "ret", "has_ovlp", "nein", "sbn",
                  "forked", "redo"):
            getattr(store, f)[dups] = getattr(store, f)[r]
        store.intv0[dups] = store.intv0[r]
        for buf in store.nei_buf + store.sb_buf:
            buf[dups] = buf[r]
    STATS["redo_left"] = int(store.redo.sum())
    STATS["k1_launches"] = rank_cuda.LAUNCHES["rank6_fused"] - k1_before
    return store


def save_store(store: LinkStore, path: str):
    """Persist a LinkStore (checkpoint for long runs)."""
    np.savez_compressed(
        path, valid=store.valid, ret=store.ret, intv0=store.intv0,
        has_ovlp=store.has_ovlp, nein=store.nein, sbn=store.sbn,
        forked=store.forked, redo=store.redo,
        nb0=store.nei_buf[0], nb1=store.nei_buf[1], nb2=store.nei_buf[2],
        nb3=store.nei_buf[3], nb4=store.nei_buf[4],
        sb0=store.sb_buf[0], sb1=store.sb_buf[1], sb2=store.sb_buf[2])


def load_store(path: str) -> LinkStore:
    z = np.load(path)
    st = LinkStore(len(z["valid"]), z["nb0"].dtype)
    st.valid = z["valid"]
    st.ret = z["ret"]
    st.intv0 = z["intv0"]
    st.has_ovlp = z["has_ovlp"]
    st.nein = z["nein"]
    st.sbn = z["sbn"]
    st.forked = z["forked"]
    st.redo = z["redo"]
    st.nei_buf = tuple(z[f"nb{i}"] for i in range(5))
    st.sb_buf = tuple(z[f"sb{i}"] for i in range(3))
    return st
