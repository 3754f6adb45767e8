"""dp×tp sharding of the FMD-index and its query loops over torch.distributed.

The port of fermi_tpu/dist/sharded.py.  Parallel axes:
  dp — reads/queries split across ranks (data parallel)
  tp — the rank rows (fused rows, or packed words + occ) split by block
       range; a rank query is answered by the shard that owns the key,
       through kernel K1 on that rank's device, and the partials are summed
       by an all-reduce over the tp group

fermi_tpu runs the mesh under shard_map in one process.  Here every rank
is a process of one torch.distributed group; world rank r sits at
(dp, tp) = (r // tp, r % tp), as fermi_tpu reshapes its devices.  The
tp-sharded view (TpIndexView) duck-types FMDIndex, so the port's own SMEM
loop (search/smem.py) and gap walk (algos/merge.py) run on it unchanged.

Backends follow the layout (init_ranks): NCCL when every rank has a card
of its own, gloo on the CPU and when ranks share a card (NCCL refuses two
ranks on one device).  gloo runs every collective used here on CUDA
tensors (it stages them through host memory itself), so no collective
needs a host copy of its own.

Every tp peer holds the same queries or lanes and gets the same all-reduced
answers, so all of them take the same branch at every step (the SMEM redo
ladder, the learned interval width, the merge's "all done" test): a peer
that skipped a collective would hang its group, and the group's timeout
(init_ranks) turns such a hang into an error.
"""

import datetime
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from fermi_tpu_torch import resolve_device
from fermi_tpu_torch.algos import merge as mg
from fermi_tpu_torch.index.fmd import BLOCK, BLOCK_BITS, FMDIndex
from fermi_tpu_torch.ops import rank_cuda
from fermi_tpu_torch.search import smem as sm

# Per-process counters for measurement (the chip smoke test reads them):
# all-reduces of rank partials over tp and the host seconds spent in them.
# On gloo a CUDA all-reduce waits for the tensor's producers and copies
# through host memory, so the card is synchronised before the clock starts
# and the seconds are the collective's own; NCCL's are the enqueue only.
STATS = {"all_reduce": 0, "all_reduce_s": 0.0}


def init_ranks(rank: int, world: int, init_method: str, device=None,
               timeout_s: float = 300.0) -> torch.device:
    """Join a process group of `world` ranks as `rank` and return the
    rank's device.  The backend follows the layout and is printed: NCCL
    when every rank has a CUDA card of its own (device "cuda" with at
    least `world` cards: rank r takes card r), gloo on the CPU and when
    ranks share a card.  `timeout_s` bounds every collective, so a rank
    that hangs fails the group instead of waiting forever."""
    dev = resolve_device(device)
    own = False
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if dev.index is None:
            dev = torch.device("cuda", rank % n)
            own = world <= n
        else:
            own = world == 1
        torch.cuda.set_device(dev)
    backend = "nccl" if own else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    shared = " (ranks share the card)" if dev.type == "cuda" and not own \
        and world > 1 else ""
    sys.stderr.write(f"[dist] rank {rank} of {world}: backend {backend} on "
                     f"{dev}{shared}\n")
    return dev


@dataclass
class Mesh:
    """One rank's place in a dp×tp mesh of the process group.

    group spans the mesh's dp·tp ranks (the world when they are all of
    it), tp_group the ranks that share this rank's dp index (they hold the
    index's shards), dp_group those that share its tp index (they split
    the queries)."""
    dp: int
    tp: int
    rank: int
    device: torch.device
    backend: str
    group: object
    tp_group: object
    dp_group: object

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def make_mesh(dp=None, tp=None, device=None):
    """dp×tp mesh over the caller's process group (already initialised,
    e.g. by init_ranks).  Pass dp and/or tp; the missing factor is derived
    from the world size (default tp=1: replicate the index, split the
    queries).  Every rank must call it, in the same order as its other
    group calls: each subgroup is made by every rank.  Returns None on a
    rank outside the mesh (world > dp·tp); raises ValueError when dp·tp
    exceeds the world."""
    n = dist.get_world_size()
    if dp is None and tp is None:
        tp = 1
    if tp is None:
        tp = n // dp
    if dp is None:
        dp = n // tp
    if dp * tp > n or dp < 1 or tp < 1:
        raise ValueError(f"mesh dp={dp} x tp={tp} needs {dp * tp} ranks, "
                         f"have {n}")
    rank = dist.get_rank()
    ranks = list(range(dp * tp))
    group = dist.group.WORLD if dp * tp == n else dist.new_group(ranks)
    tp_group = dp_group = None
    for d in range(dp):
        g = dist.new_group(ranks[d * tp:(d + 1) * tp])
        if rank // tp == d:
            tp_group = g
    for t in range(tp):
        g = dist.new_group(ranks[t::tp])
        if rank % tp == t:
            dp_group = g
    if rank >= dp * tp:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dp, tp, rank, dev, dist.get_backend(), group, tp_group,
                dp_group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t over the group in place, counted and timed in STATS."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    STATS["all_reduce_s"] += time.perf_counter() - t0
    STATS["all_reduce"] += 1
    return t


def _all_gather(t: torch.Tensor, group, size: int) -> list:
    """Every group member's tensor of t's shape, in group rank order."""
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t, group=group)
    return out


def pad_index_for_tp(blocks: torch.Tensor, occ, tp: int):
    """Pad the row count to a multiple of tp so rows shard evenly.  The
    index's last row is all pad symbols (6, never counted) with the full
    totals as its occ, so the pad rows repeat it: uint8 symbol rows, packed
    words and fused rank rows alike.  occ may be None."""
    pad = (-blocks.shape[0]) % tp
    if pad:
        blocks = torch.cat([blocks, blocks[-1:].expand(pad, -1)])
        if occ is not None:
            occ = torch.cat([occ, occ[-1:].expand(pad, -1)])
    return blocks, occ


def _shard_rows(x: torch.Tensor, tp: int, t: int, device) -> torch.Tensor:
    """Rows [t·L, (t+1)·L) of x, L = ceil(rows / tp), padded as
    pad_index_for_tp pads, on `device` (no copy of the others' rows)."""
    L = -(-x.shape[0] // tp)
    part = x[t * L:(t + 1) * L]
    if part.shape[0] < L:
        part = torch.cat([part, x[-1:].expand(L - part.shape[0], -1)])
    return part.to(device).contiguous()


def shard_index(index: FMDIndex, mesh: Mesh):
    """This rank's tp shard of the index on mesh.device: (fused rows or
    None, packed words, occ or None, cnt, mcnt).  With fused rows (every
    occ count fits 32 bits) the shard is their slice and K1 reads it;
    otherwise the packed words and the occ rows are sliced.  cnt and mcnt
    are copied whole."""
    dev, tp, t = mesh.device, mesh.tp, mesh.tp_rank
    if index.fused is not None:
        fused = _shard_rows(index.fused, tp, t, dev)
        packed, occ = fused[:, :16], None
    else:
        fused = None
        packed = _shard_rows(index.bwt_packed, tp, t, dev)
        occ = _shard_rows(index.occ, tp, t, dev)
    return fused, packed, occ, index.cnt.to(dev), index.mcnt.to(dev)


def _local_keys(k: torch.Tensor, idtype, key_lo: int, key_span: int):
    """(local keys, owned mask) of the keys k for a shard whose rows start
    at key key_lo and cover key_span keys; unowned keys read local row 0."""
    kl = k.to(idtype).reshape(-1) - key_lo
    owned = (kl >= 0) & (kl < key_span)
    return torch.where(owned, kl, 0), owned


def _rank_partial(fused, packed, occ, kl, owned) -> torch.Tensor:
    """rank6 of the owned local keys on one shard through K1, zeros for the
    others: fused rows hold the global occ counts, so the answer is
    global."""
    if fused is not None:
        r = rank_cuda.rank6_fused(fused, kl.contiguous())
    else:
        blk = (kl >> BLOCK_BITS).long()
        cnts = rank_cuda.rank_block_counts(
            packed[blk], (kl & (BLOCK - 1)).to(torch.int32).contiguous())
        r = occ[blk][:, :6] + cnts[:, :6].to(kl.dtype)
    return torch.where(owned[:, None], r, 0)


class TpIndexView:
    """One rank's view of a tp-sharded FMD-index, duck-typing what the
    query loops read of FMDIndex (rank6, sym_at, lf, extend6, set_intv,
    cnt, mcnt, total, n_seqs, idtype, device).  A rank answers the keys in
    its own rows with K1, zeros for the others, and the all-reduce over
    the tp group gives every peer FMDIndex.rank6's answer.  Keys keep the
    index's integer domain; K1 is handed k − lo·128 on the local rows."""

    def __init__(self, index: FMDIndex, mesh: Mesh):
        self.mesh = mesh
        (self.fused_l, self.packed_l, self.occ_l, self.cnt,
         self.mcnt) = shard_index(index, mesh)
        self.total, self.n_seqs = index.total, index.n_seqs
        self.idtype, self.device = index.idtype, mesh.device
        rows = self.packed_l.shape[0]
        self.key_lo = mesh.tp_rank * rows * BLOCK
        self.key_span = rows * BLOCK

    def _local(self, k: torch.Tensor):
        return _local_keys(k, self.idtype, self.key_lo, self.key_span)

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        # every tp peer holds the same keys, so all skip or none does
        if self.mesh.tp == 1 or t.numel() == 0:
            return t
        return _all_reduce(t.contiguous(), self.mesh.tp_group)

    def _rank_owned(self, kl, owned):
        return _rank_partial(self.fused_l, self.packed_l, self.occ_l, kl,
                             owned)

    def _sym_owned(self, kl, owned):
        blk = (kl >> BLOCK_BITS).long()
        off = (kl & (BLOCK - 1)).to(torch.int32)
        w = self.packed_l[blk, (off >> 3).long()]
        return torch.where(owned, (w >> (4 * (off & 7))) & 15, 0)

    def rank6(self, k: torch.Tensor) -> torch.Tensor:
        """Counts of symbols 0..5 in BWT[0..k-1]: [..., 6], k's shape."""
        kl, owned = self._local(k)
        return self._sum(self._rank_owned(kl, owned)).reshape(*k.shape, 6)

    def sym_at(self, k: torch.Tensor) -> torch.Tensor:
        """BWT[k] (uint8), k's shape."""
        kl, owned = self._local(k)
        return self._sum(self._sym_owned(kl, owned)).to(
            torch.uint8).reshape(k.shape)

    def lf(self, k: torch.Tensor):
        """(symbol at k, LF(k)) with one all-reduce for rank and symbol
        (sharded.py:124-140)."""
        kl, owned = self._local(k)
        payload = torch.cat([self._rank_owned(kl, owned),
                             self._sym_owned(kl, owned).to(
                                 self.idtype)[:, None]], 1)
        payload = self._sum(payload)
        c = payload[:, 6].to(torch.uint8).reshape(k.shape)
        ci = c.long()
        r = payload[:, :6].reshape(*k.shape, 6)
        return c, self.cnt[ci] + r.gather(-1, ci[..., None])[..., 0]

    def extend6(self, kb, kf, sz, is_back: bool):
        """FMDIndex.extend6 with both ends' rank6 in one all-reduce."""
        idt = self.idtype
        kb, kf, sz = kb.to(idt), kf.to(idt), sz.to(idt)
        primary = kb if is_back else kf
        tkl = self.rank6(torch.stack([primary, primary + sz]))
        tk, tl = tkl[0], tkl[1]
        osz = tl - tk
        out_primary = self.cnt[:6] + tk
        o0 = kf if is_back else kb
        o4 = o0 + osz[..., 0]
        o3 = o4 + osz[..., 4]
        o2 = o3 + osz[..., 3]
        o1 = o2 + osz[..., 2]
        o5 = o1 + osz[..., 1]
        other = torch.stack([o0, o1, o2, o3, o4, o5], -1)
        if is_back:
            return out_primary, other, osz
        return other, out_primary, osz

    def set_intv(self, c: torch.Tensor):
        return FMDIndex.set_intv(self, c)


# ---------------------------------------------------------------------------
# sharded SMEM: the port's SMEM loop on the tp view, queries split over dp
# ---------------------------------------------------------------------------

class ShardedSMEM:
    """smem_all over a dp×tp mesh: each dp group searches a contiguous
    share of the queries with the port's SMEM loop (redo ladder included)
    on its tp view, and the per-query lists are gathered so that every
    rank returns what search.smem.smem_all returns.  A batch holding a
    query over LONG_QUERY_LEN goes whole to the native engine on the
    host, on the index given here (sharded.py:200-201): pass the whole
    index restored on the host; only its shard goes to the device."""

    def __init__(self, index: FMDIndex, mesh: Mesh):
        self.index = index
        self.mesh = mesh
        self.view = TpIndexView(index, mesh)

    def smem_all(self, seqs, self_match=False, maxi=None, maxm=64):
        B = len(seqs)
        if B == 0:
            return []
        if max(len(s) for s in seqs) > sm.LONG_QUERY_LEN:
            return sm.smem_all_native(self.index, seqs, self_match)
        dp = self.mesh.dp
        per = -(-B // dp)
        lo = self.mesh.dp_rank * per
        res = sm.smem_all(self.view, seqs[lo:lo + per], self_match, maxi,
                          maxm)
        if dp == 1:
            return res
        parts = [None] * dp
        dist.all_gather_object(parts, res, group=self.mesh.dp_group)
        return [r for p in parts for r in p]


# ---------------------------------------------------------------------------
# distributed merge (reference merge.c as collectives)
# ---------------------------------------------------------------------------

def compute_gap_bits_sharded(e0: FMDIndex, e1: FMDIndex, mesh: Mesh,
                             batch: int = 1 << 20, chunk_steps: int = 8):
    """The gap bits of merging e1 after e0 (merge.c:21-66), split over dp:
    each round takes `batch` of e1's reads, each dp rank walks its
    contiguous share through both tp views (algos/merge._gap_walk_chunk),
    the emitted positions are exchanged over dp and each rank sets those
    in its own range [r·L, (r+1)·L), L = ceil((n0 + n1) / dp).  Returns
    (bool [L] on mesh.device, n0 + n1); tp peers hold equal bits."""
    v0, v1 = TpIndexView(e0, mesh), TpIndexView(e1, mesh)
    dev, dp, d = mesh.device, mesh.dp, mesh.dp_rank
    n = e0.total + e1.total
    L = -(-n // dp)
    lo_bit = d * L
    bits = torch.zeros(L + 1, dtype=torch.bool, device=dev)

    def mark(pos):
        pos = pos.reshape(-1)
        if dp > 1:
            pos = pos[pos >= 0]
            m = torch.tensor([pos.numel()], dtype=torch.int64, device=dev)
            sizes = [int(s) for s in _all_gather(m, mesh.dp_group, dp)]
            buf = torch.full((max(sizes),), -1, dtype=torch.int64,
                             device=dev)
            buf[:pos.numel()] = pos
            pos = torch.cat(_all_gather(buf, mesh.dp_group, dp))
        loc = pos - lo_bit
        ok = (pos >= 0) & (loc >= 0) & (loc < L)
        bits[torch.where(ok, loc, L)] = True

    for lo in range(0, e1.n_seqs, batch):
        hi = min(lo + batch, e1.n_seqs)
        per = -(-(hi - lo) // dp)
        a = min(lo + d * per, hi)
        k = torch.arange(a, min(a + per, hi), dtype=e1.idtype, device=dev)
        i = torch.full_like(k, e0.n_seqs - 1, dtype=e0.idtype)
        done = torch.zeros(k.numel(), dtype=torch.bool, device=dev)
        mark(k.long() + i.long() + 1)       # the first mark (merge.c:42)
        while True:
            if k.numel():
                k, i, done, pos = mg._gap_walk_chunk(v1, v0, k, i, done,
                                                     chunk_steps)
            else:
                pos = torch.empty(0, dtype=torch.int64, device=dev)
            mark(pos)
            live = ~done
            k, i, done = k[live], i[live], done[live]
            left = torch.tensor([k.numel()], dtype=torch.int64, device=dev)
            dist.all_reduce(left, group=mesh.group)
            if int(left) == 0:
                break
    return bits[:L], n


def interleave_device(mesh: Mesh, bwt0, bwt1, bits, n=None) -> np.ndarray:
    """The merge interleave (merge.c:100-137), split over dp.  bits is a
    rank's own range of the gap bits (compute_gap_bits_sharded) or the
    whole bool vector on the host.  Output ranks are monotone, so each dp
    rank needs only contiguous slices of bwt0 and bwt1, found from the
    all-gathered popcounts of the ranges (sharded.py:343-368); it
    interleaves them on its device and the slices are gathered, so every
    rank returns the whole merged BWT (uint8, host)."""
    dev, dp, d = mesh.device, mesh.dp, mesh.dp_rank
    bwt0 = np.asarray(bwt0, np.uint8)
    bwt1 = np.asarray(bwt1, np.uint8)
    n = len(bwt0) + len(bwt1) if n is None else n
    L = -(-n // dp)
    lo = d * L
    if isinstance(bits, np.ndarray):
        b = np.zeros(L, bool)
        part = np.asarray(bits, bool)[lo:lo + L]
        b[:len(part)] = part
        bits = torch.from_numpy(b).to(dev)
    pop = bits.sum(dtype=torch.int64).reshape(1)
    pops = ([int(p) for p in _all_gather(pop, mesh.dp_group, dp)]
            if dp > 1 else [int(pop)])
    base1 = np.concatenate([[0], np.cumsum(pops)])
    m = max(0, min(L, n - lo))          # this rank's share of the output
    s1 = bwt1[base1[d]:base1[d + 1]]
    s0 = bwt0[lo - base1[d]: lo + m - base1[d + 1]]
    out = torch.zeros(L, dtype=torch.uint8, device=dev)
    out[:m] = mg.merge_bwts(torch.from_numpy(np.ascontiguousarray(s0)).to(dev),
                            torch.from_numpy(np.ascontiguousarray(s1)).to(dev),
                            bits[:m])
    if dp > 1:
        out = torch.cat(_all_gather(out, mesh.dp_group, dp))
    return out[:n].cpu().numpy()


def fm_merge_sharded(e0: FMDIndex, bwt0, e1: FMDIndex, bwt1, mesh: Mesh,
                     batch: int = 1 << 20) -> np.ndarray:
    """fm_merge over the mesh: the dp-split gap walk through tp views,
    then the dp-split interleave.  Byte-equal to algos.merge.fm_merge."""
    bits, n = compute_gap_bits_sharded(e0, e1, mesh, batch=batch)
    return interleave_device(mesh, bwt0, bwt1, bits, n=n)


def _broadcast_bwt(bwt, src: int, mesh: Mesh):
    """The BWT rank `src` holds (None: the shard is absent), on every rank
    of the mesh, as a host array."""
    n = torch.tensor([-1 if bwt is None else len(bwt)], dtype=torch.int64,
                     device=mesh.device)
    dist.broadcast(n, src, group=mesh.group)
    if int(n) < 0:
        return None
    if mesh.rank == src:
        t = torch.from_numpy(np.ascontiguousarray(bwt)).to(mesh.device)
    else:
        t = torch.empty(int(n), dtype=torch.uint8, device=mesh.device)
    dist.broadcast(t, src, group=mesh.group)
    return t.cpu().numpy()


def build_fmd_distributed(shards, mesh: Mesh, builder=None) -> np.ndarray:
    """Index construction over the mesh (the reference's splitfa -> build
    -> merge fan-out, run-fermi.pl:108-121): shard j is built by rank
    j mod (dp·tp), from its entry of `shards` (a multi-string text: nt6,
    sentinel-terminated; the other ranks' entries are not read), each BWT
    is broadcast from its owner, and the BWTs are merged pairwise over the
    mesh in the order (0,1)(2,3)..., which keeps the global sequence
    order: the result equals the BWT of the shards' concatenation.

    A shard that is None (or empty) on its owner is absent, on either side
    of a pair: the other side goes on alone.  `builder` (text -> BWT)
    defaults to the port's device builder on the rank's device,
    construct/blocked.device_bwt.  Returns the merged BWT (uint8) on every
    rank."""
    if builder is None:
        from fermi_tpu_torch.construct import blocked

        def builder(t):
            return blocked.device_bwt(t, mesh.device)
    size = mesh.dp * mesh.tp
    mine = {}
    for j, t in enumerate(shards):
        if j % size == mesh.rank and t is not None and len(t):
            mine[j] = builder(np.asarray(t, np.uint8))
    bwts = [_broadcast_bwt(mine.get(j), j % size, mesh)
            for j in range(len(shards))]
    while len(bwts) > 1:
        nxt = []
        for a in range(0, len(bwts), 2):
            pair = [b for b in bwts[a:a + 2] if b is not None]
            if len(pair) < 2:
                nxt.append(pair[0] if pair else None)
                continue
            e0 = FMDIndex.from_bwt(pair[0], mesh.device)
            e1 = FMDIndex.from_bwt(pair[1], mesh.device)
            nxt.append(fm_merge_sharded(e0, pair[0], e1, pair[1], mesh))
            del e0, e1
        bwts = nxt
    if not bwts or bwts[0] is None:
        raise ValueError("build_fmd_distributed: no shard holds a text")
    return bwts[0]


# ---------------------------------------------------------------------------
# single backward-search step (the compile-check entry of fermi_tpu)
# ---------------------------------------------------------------------------

def _pack_words(blocks: torch.Tensor) -> torch.Tensor:
    """uint8 symbol rows [R, 128] -> nibble-packed int32 words [R, 16]."""
    w = blocks.reshape(blocks.shape[0], 16, 8).to(torch.int32)
    packed = w[:, :, 0].clone()
    for s in range(1, 8):
        packed |= w[:, :, s] << (4 * s)
    return packed


def sharded_rank6(mesh: Mesh):
    """rank6(blocks_l, occ_l, k): blocks_l (uint8 symbol rows) and occ_l
    are this rank's tp shard of pad_index_for_tp's rows, k this rank's dp
    share of the keys; the owning shard answers through K1, the all-reduce
    over tp combines.  Returns [len(k), 6] in occ's dtype."""

    def rank6(blocks_l, occ_l, k):
        span = blocks_l.shape[0] * BLOCK
        kl, owned = _local_keys(k, occ_l.dtype, mesh.tp_rank * span, span)
        r = _rank_partial(None, _pack_words(blocks_l), occ_l, kl, owned)
        return r if mesh.tp == 1 else _all_reduce(r, mesh.tp_group)

    return rank6


def sharded_backward_search_step(mesh: Mesh):
    """One backward-search step over (k, l) intervals: dp-split queries,
    tp-sharded index.  Returns step(blocks_l, occ_l, cnt, k, l, c) ->
    (k, l, alive)."""
    rank6 = sharded_rank6(mesh)

    def step(blocks, occ, cnt, k, l, c):
        ok = rank6(blocks, occ, k)
        ol = rank6(blocks, occ, l + 1)
        ci = c.long()
        nk = cnt[ci] + ok.gather(1, ci[:, None])[:, 0]
        nl = cnt[ci] + ol.gather(1, ci[:, None])[:, 0] - 1
        alive = nk <= nl
        return torch.where(alive, nk, k), torch.where(alive, nl, l), alive

    return step
