"""Device-resident FMD-index: dense blocked-occ layout for batched rank queries.

The port of fermi_tpu/index/fmd.py.  The BWT lives on the device as dense
symbol blocks plus per-block exclusive cumulative counts, so rank(k) for
thousands of query positions is one row gather and a masked count: kernel
K1 (ops/rank_cuda.py, csrc/rank.cu) on the card, its plain version on the
CPU.  The compressed form exists only on disk (see fermi_tpu_torch.rld).

Conventions (the same as fermi_tpu's, differ deliberately from the
reference):
  rank6(k)[c]  = #occurrences of symbol c in BWT[0..k-1]   (exclusive)
  sym_at(k)    = BWT[k]
  BLOCK = 128 symbols per occ block; pad symbol 6 (never counted)
  occ [NB+1, 8], columns 6-7 zero; packed words: the symbol at block offset
  8j+s sits in nibble s of int32 word j
The reference's rld_rank1a(k) = (sym_at(k), rank6(k+1)); call sites adapt.

Index dtype: torch has no add, shift or compare for uint32, so index
arithmetic runs in int32 while n < 2^31 - 128 and in int64 above.  The
32-bit occ pattern survives inside the fused rank rows, which exist
whenever every occ count fits 32 bits (n < 2^32 - 128).
"""

import os
from dataclasses import dataclass

import numpy as np
import torch

from fermi_tpu_torch import resolve_device, spans
from fermi_tpu_torch.ops import rank_cuda

BLOCK_BITS = 7
BLOCK = 1 << BLOCK_BITS  # 128 symbols per occ block
# Fused rank rows are built below this many symbols, where every occ count
# fits 32 bits; a test lowers it to take the unfused layout on a small index.
FUSED_MAX = 2**32 - BLOCK
# Symbols a restore expands, counts and packs at a time (rounded up to a
# block): the device memory beyond the index's own arrays is about a
# slice's worth.  Tests lower it.
RESTORE_CHUNK = 1 << 28


def _pick_idtype(n: int) -> torch.dtype:
    """Index integer domain for a total length of n symbols: int32 while
    everything fits, int64 beyond.  FERMI_TPU_IDX_DTYPE forces a domain
    (int32 or int64), so a test can run the wide domain on a small index."""
    mode = os.environ.get("FERMI_TPU_IDX_DTYPE", "auto")
    if mode != "auto":
        if mode not in ("int32", "int64"):
            raise ValueError(f"FERMI_TPU_IDX_DTYPE={mode!r}: the port's index "
                             "domains are int32 and int64")
        return getattr(torch, mode)
    return torch.int32 if n < 2**31 - BLOCK else torch.int64


def _fuse_rows(packed: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """[NB+1, 24] int32 fused rank rows: the 16 packed words, the six occ
    counts as 32-bit patterns, two pad words.  One row is what a rank query
    gathers (96 bytes, six 16-byte vector loads in K1)."""
    fused = torch.zeros((packed.shape[0], 24), dtype=torch.int32,
                        device=packed.device)
    fused[:, :16] = packed
    occ6 = occ[:, :6].to(torch.int64)
    # counts in [2^31, 2^32) are stored as their (negative) int32 pattern
    fused[:, 16:22] = torch.where(occ6 >= 2**31, occ6 - 2**32,
                                  occ6).to(torch.int32)
    return fused


def _slice_rows() -> int:
    """Block rows of one restore slice: RESTORE_CHUNK rounded up to a
    block."""
    return max(1, -(-RESTORE_CHUNK // BLOCK))


def _slice_cuts(lens: np.ndarray, step: int):
    """The restore's slice bounds 0, step, 2 step, ..., n over runs of
    lengths `lens` (n their total) and, at each bound, the run that holds
    it and that run's symbols before it (the bound n falls at the start of
    a last, empty run).  Runs are summed a group at a time and only the
    group holding a bound is scanned, so the host memory beyond the runs
    is a group's (a cumulative sum of every run would write 8 B a run of
    fresh host memory, whose page faults outlast the expansion itself)."""
    group = 1 << 16
    heads = np.arange(0, lens.size, group)
    group_start = np.zeros(heads.size + 1, np.int64)
    if lens.size:
        np.cumsum(np.add.reduceat(lens, heads), out=group_start[1:])
    n = int(group_start[-1])
    bounds = list(range(0, n, step))
    cut, skip = [], []
    for b in bounds:
        g = int(np.searchsorted(group_start, b, "right")) - 1
        part = lens[heads[g]: heads[g] + group]
        starts = np.cumsum(part) - part + group_start[g]
        r = int(np.searchsorted(starts, b, "right")) - 1
        cut.append(int(heads[g]) + r)
        skip.append(b - int(starts[r]))
    return bounds + [n], cut + [lens.size], skip + [0]


def _pack_words(part: torch.Tensor) -> torch.Tensor:
    """int32 [rows, 16] packed words of uint8 [rows, BLOCK] blocks: each
    8-symbol group read as one little-endian int64 (symbol s in byte s),
    its nibbles gathered into the low 32 bits (symbol s in nibble s).
    Symbols are at most 6, so no shift crosses a sign bit."""
    x = part.view(torch.int64)
    for shift, mask in ((4, 0x00FF00FF00FF00FF), (8, 0x0000FFFF0000FFFF),
                        (16, 0xFFFFFFFF)):
        y = x >> shift          # in place: two int64 copies at most
        y |= x
        y &= mask
        x = y
    return x.to(torch.int32)


@dataclass
class FMDIndex:
    """Bidirectional FM-index over the nt6 alphabet, device tensors.

    bwt_blocks: uint8 [n_blocks+1, BLOCK], padded with 6 (never counted)
    occ:        idtype [n_blocks+1, 8] exclusive cumulative counts per block
                (cols 6,7 are padding)
    cnt:        idtype [8] C-array: cnt[c] = #symbols < c in the whole BWT
    mcnt:       idtype [8] mcnt[0]=total, mcnt[1+c]=count of symbol c
    bwt_packed: int32 [n_blocks+1, 16], 8 nibbles/word
    fused:      int32 [n_blocks+1, 24] rank rows (None when occ overflows
                32 bits)
    """

    bwt_blocks: torch.Tensor
    occ: torch.Tensor
    cnt: torch.Tensor
    mcnt: torch.Tensor
    bwt_packed: torch.Tensor
    fused: torch.Tensor | None

    def __post_init__(self):
        m = self.mcnt.cpu().tolist()
        self._total, self._n_seqs = int(m[0]), int(m[1])

    # -- construction ------------------------------------------------------

    @staticmethod
    def _from_symbols(bwt: torch.Tensor) -> "FMDIndex":
        """The index over a BWT on the device: a padded copy of it (the
        index's own blocks; `bwt` stays the caller's), then the layout a
        slice at a time (_from_blocks)."""
        n = bwt.numel()
        blocks = torch.empty(((n + BLOCK - 1) // BLOCK + 1, BLOCK),
                             dtype=torch.uint8, device=bwt.device)
        flat = blocks.view(-1)
        flat[:n] = bwt
        flat[n:] = 6
        return FMDIndex._from_blocks(blocks, n)

    @staticmethod
    def _from_blocks(blocks: torch.Tensor, n: int) -> "FMDIndex":
        """occ, packed words and fused rows over the padded blocks of an
        n-symbol BWT (every symbol past n is 6), RESTORE_CHUNK symbols of
        rows at a time: the memory beyond the index's own arrays is a
        slice's.  occ carries the running totals across slices."""
        dev = blocks.device
        rows = blocks.shape[0]
        step = _slice_rows()
        dtype = _pick_idtype(n)
        occ = torch.zeros((rows, 8), dtype=dtype, device=dev)
        packed = torch.empty((rows, 16), dtype=torch.int32, device=dev)
        fused = None
        if n < FUSED_MAX:
            fused = torch.empty((rows, 24), dtype=torch.int32, device=dev)
        run = torch.zeros((6, 1), dtype=torch.int64, device=dev)
        for r0 in range(0, rows, step):
            part = blocks[r0: r0 + step]
            # [6, rows]: each symbol's counts contiguous, so the running
            # sum is a scan along the innermost dimension (a scan along
            # the outer one runs one sequential thread per column on CUDA).
            # A row's count fits uint8; a wider sum would first cast the
            # whole compare to its type.
            hist = torch.stack([(part == c).view(torch.uint8).sum(
                1, dtype=torch.uint8) for c in range(6)], 0).long()
            excl = torch.cumsum(hist, 1) - hist + run
            run = excl[:, -1:] + hist[:, -1:]
            occ[r0: r0 + step, :6] = excl.T
            packed[r0: r0 + step] = _pack_words(part)
            if fused is not None:
                fused[r0: r0 + step] = _fuse_rows(packed[r0: r0 + step],
                                                  excl.T)
        # the final row is all pad, so the running totals are the counts
        mcnt = np.zeros(8, np.int64)
        mcnt[0] = n
        mcnt[1:7] = run[:, 0].cpu().numpy()
        cnt = np.zeros(8, np.int64)
        cnt[1:7] = np.cumsum(mcnt[1:7])
        cnt[7] = cnt[6]
        return FMDIndex(bwt_blocks=blocks, occ=occ,
                        cnt=torch.as_tensor(cnt, device=dev).to(dtype),
                        mcnt=torch.as_tensor(mcnt, device=dev).to(dtype),
                        bwt_packed=packed, fused=fused)

    @staticmethod
    def from_bwt(bwt: np.ndarray, device=None) -> "FMDIndex":
        dev = resolve_device(device)
        bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        return FMDIndex._from_symbols(torch.from_numpy(bwt).to(dev))

    @staticmethod
    def from_runs(runs, device=None) -> "FMDIndex":
        """Device index straight from RLE runs (positive lengths, as the
        decoder and Runs.from_bwt give), expanded into the padded blocks
        RESTORE_CHUNK symbols at a time: only a slice's runs go to the
        device, each run's start gets its symbol's difference from the
        previous run's, and a uint8 running sum (mod 256) of those writes
        the slice's symbols.  Its length is the runs' (a damaged file's
        header may claim another, which chkbwt reports)."""
        dev = resolve_device(device)
        lens = np.ascontiguousarray(runs.lengths, dtype=np.int64)
        syms = np.ascontiguousarray(runs.symbols, dtype=np.uint8)
        bounds, cut, skip = _slice_cuts(lens, _slice_rows() * BLOCK)
        n = int(bounds[-1])
        blocks = torch.empty(((n + BLOCK - 1) // BLOCK + 1, BLOCK),
                             dtype=torch.uint8, device=dev)
        flat = blocks.view(-1)
        flat[n:] = 6
        for lo, hi, i, j, head, tail in zip(
                bounds[:-1], bounds[1:], cut[:-1], cut[1:], skip[:-1],
                skip[1:]):
            if tail:                        # run j holds the slice's end
                j += 1
            ln = torch.from_numpy(lens[i:j]).to(dev, copy=True)
            if tail:
                ln[-1] = tail
            ln[0] -= head
            sym = torch.from_numpy(syms[i:j]).to(dev)
            delta = sym.clone()
            delta[1:] -= sym[:-1]
            starts = torch.cumsum(ln, 0)
            starts -= ln
            buf = torch.zeros(hi - lo, dtype=torch.uint8, device=dev)
            buf[starts] = delta
            del ln, sym, delta, starts
            torch.cumsum(buf, 0, dtype=torch.uint8, out=flat[lo:hi])
            del buf
        return FMDIndex._from_blocks(blocks, n)

    @staticmethod
    def from_arrays(bwt_blocks, occ, cnt, mcnt, bwt_packed, fused=None,
                    device=None) -> "FMDIndex":
        """The port's index from another FMDIndex's arrays as numpy (e.g.
        fermi_tpu's, via np.asarray(field)), without a rebuild.  The index
        dtype is chosen anew from the total length; fused rows are derived
        when absent and occ fits 32 bits."""
        dev = resolve_device(device)
        mcnt = np.asarray(mcnt).astype(np.int64)
        n = int(mcnt[0])

        def t(a, dtype):
            # a copy: the source arrays may be read-only views
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        dtype = _pick_idtype(n)
        occ, packed = t(occ, np.int64), t(bwt_packed, np.int32)
        if fused is not None:
            fused = t(fused, np.int32)
        elif n < FUSED_MAX:
            fused = _fuse_rows(packed, occ)
        return FMDIndex(
            bwt_blocks=t(bwt_blocks, np.uint8), occ=occ.to(dtype),
            cnt=torch.as_tensor(np.asarray(cnt).astype(np.int64),
                                device=dev).to(dtype),
            mcnt=torch.as_tensor(mcnt, device=dev).to(dtype),
            bwt_packed=packed, fused=fused)

    @staticmethod
    def restore(path: str, device=None) -> "FMDIndex":
        """The index of a .fmd file on `device`: the native decoder's runs
        (span `restore/decode`), then their layout (`restore/layout`)."""
        from fermi_tpu_torch import rld
        dev = resolve_device(device)
        with spans.span("restore/decode"):
            runs = rld.read_fmd(path)
        with spans.span("restore/layout"):
            return FMDIndex.from_runs(runs, dev)

    # -- properties --------------------------------------------------------

    @property
    def total(self) -> int:
        return self._total

    @property
    def n_seqs(self) -> int:
        return self._n_seqs

    @property
    def idtype(self) -> torch.dtype:
        return self.occ.dtype

    @property
    def device(self) -> torch.device:
        return self.occ.device

    def bwt(self) -> torch.Tensor:
        """The BWT's symbols, uint8 [total] (a view of the blocks)."""
        return self.bwt_blocks.view(-1)[: self.total]

    # -- core queries (all batched over leading axes) ----------------------

    def rank6(self, k: torch.Tensor) -> torch.Tensor:
        """Counts of symbols 0..5 in BWT[0..k-1]. k: int [...] -> [..., 6],
        through kernel K1 on the card (its plain version on the CPU)."""
        shape = k.shape
        k = k.to(self.idtype).reshape(-1).contiguous()
        if self.fused is not None:
            r = rank_cuda.rank6_fused(self.fused, k)
        else:
            blk = (k >> BLOCK_BITS).long()
            off = (k & (BLOCK - 1)).to(torch.int32)
            cnts = rank_cuda.rank_block_counts(self.bwt_packed[blk], off)
            r = self.occ[blk][:, :6] + cnts[:, :6].to(self.idtype)
        return r.reshape(*shape, 6)

    def rank6_dense(self, k: torch.Tensor) -> torch.Tensor:
        """One-hot count over the uint8 blocks (the oracle path)."""
        k = k.to(self.idtype)
        blk = (k >> BLOCK_BITS).long()
        off = k & (BLOCK - 1)
        rows = self.bwt_blocks[blk]                              # [..., BLOCK]
        base = self.occ[blk][..., :6]
        pos_ok = (torch.arange(BLOCK, device=k.device)
                  < off[..., None, None])                        # [..., 1, BLOCK]
        eq = rows[..., None, :] == torch.arange(
            6, dtype=torch.uint8, device=k.device)[:, None]      # [..., 6, BLOCK]
        return base + (eq & pos_ok).sum(-1, dtype=self.idtype)

    def sym_at(self, k: torch.Tensor) -> torch.Tensor:
        """BWT[k] (uint8). k: int [...] -> [...]."""
        return self.bwt_blocks.view(-1)[k.long()]

    def rank1_sym(self, k: torch.Tensor):
        """(BWT[k], rank6(k)) — the pair used by LF walks."""
        return self.sym_at(k), self.rank6(k)

    def lf(self, k: torch.Tensor):
        """One LF-mapping step: (symbol at k, predecessor position).

        Matches reference fm_retrieve's inner step (exact.c:59-70):
        k' = cnt[c] + rank_c([0..k]) - 1 = cnt[c] + rank6(k)[c] for c=BWT[k].
        """
        c, r = self.rank1_sym(k)
        ci = c.long()
        kp = self.cnt[ci] + r.gather(-1, ci[..., None])[..., 0]
        return c, kp

    def extend6(self, kb, kf, sz, is_back: bool):
        """Batched fm6_extend (exact.c:72-88): extend bi-intervals by every
        symbol at once.

        kb, kf, sz: int [B] — interval start (backward strand), start (forward
        strand), size. Returns (KB, KF, SZ): each [B, 6], one column per symbol.
        """
        idt = self.idtype
        kb, kf, sz = kb.to(idt), kf.to(idt), sz.to(idt)
        primary = kb if is_back else kf
        tk = self.rank6(primary)                # [B, 6]
        tl = self.rank6(primary + sz)
        osz = tl - tk
        out_primary = self.cnt[:6] + tk
        # opposite-strand starts via the complement-ordering identity:
        # symbols on the other strand appear in the order 0,4,3,2,1,5
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
        """Initial bi-interval of a single symbol c (fm6_set_intv)."""
        ci = c.long()
        comp = torch.where((ci >= 1) & (ci <= 4), 5 - ci, ci)
        kb = self.cnt[ci]
        sz = self.cnt[ci + 1] - self.cnt[ci]
        kf = self.cnt[comp]
        return kb, kf, sz
