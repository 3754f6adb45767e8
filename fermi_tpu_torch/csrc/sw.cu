// Kernel K2 for Hopper (sm_90a): batched Smith-Waterman local-alignment
// score (affine gaps, score only).
//
// Replaces the Pallas TPU kernel fermi_tpu/ops/sw_pallas.py `_sw_kernel`
// (called through `_sw_call` / `sw_score_batch`).  It computes the same row
// recurrence, row i of the query against every target column j:
//
//   E2[j]    = max(E[j] - gape, H[j] - (gapo + gape))      (previous row)
//   H_pre[j] = max(H[j-1] + s(q[i], t[j]), E2[j], 0)        (H[-1] = 0)
//   M[j]     = max over j' <= j of H_pre[j'] + gape*j'      (prefix max)
//   F[j]     = M[j-1] - gapo - gape*j                       (M[-1] = NEG)
//   H[j]     = max(H_pre[j], F[j], 0);  best = max(best, H[j]), j < tlen
//
// F is the exact lazy-F closed form of sw_pallas.py:84-86.  Nothing flows
// from a column to the columns on its left, and rows past qlen change
// nothing, so a pair's work stops at its own qlen rows and tlen columns;
// the TPU's padding of the target to 128 lanes and of the query to the
// batch's longest does not exist here.
//
// Layout: one warp per pair, the target across the lanes.  A warp pass
// covers kTile = 32 x kCols consecutive columns; each lane holds kCols of
// them (target symbol, H and E of the previous row) in registers.  Per row:
// the query symbol comes by shuffle from a register that holds 32 rows of
// the query, the left neighbour's previous-row H by one shuffle, the prefix
// max is sequential within a lane and a 5-step __shfl_up_sync scan across
// lanes.  Targets longer than kTile are strip-mined: strip by strip, all
// rows each, carrying each row's boundary H and running prefix max to the
// next strip through a per-pair buffer in device memory (double-buffered,
// so a strip never reads a slot the same strip writes).
//
// Bound on this card: operations.  The function needs 8 32-bit integer
// operations a cell (the Gotoh recurrence, 6 of them on the integer pipe
// with Hopper's DPX add-max and 3-way max; chip_smoke.py prices them) and a
// few bytes per column and row, so the integer pipe, not memory, is the
// limit.  This kernel's two-pass prefix-max form does more per cell and
// uses no DPX.  No tensor cores: this is max-plus arithmetic, not a product.
//
// Trouble spots: NEG = -10^6 enters F only at column 0 (NEG - gapo), far
// from int32 overflow; E and H are >= -(gapo + gape) after the first row.
// Padding: target columns past tlen read as -2 and never enter `best`;
// they can only influence columns to their right.
//
// Entry point (plain C interface for ctypes), returns the cudaError_t of
// the launch (0 = launched):
//   k2_sw_score(q, qoff, t, toff, n, match, mismatch, gapo, gape,
//               carry, coff, out, stream)
//   q, t: int8 concatenated sequences; qoff, toff: int64 [n+1] offsets;
//   carry: int32 scratch, coff: int64 [n] offsets into it (4 * qlen
//   entries for each pair whose target is longer than k2_tile()); out:
//   int32 [n].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -1000000;           // sw_pallas.py NEG
constexpr int kWarp = 32;
constexpr int kCols = 8;                 // target columns per lane
constexpr int kTile = kWarp * kCols;     // columns per warp pass
constexpr int kThreads = 256;            // 8 warps: 8 pairs per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
sw_score_kernel(const int8_t* __restrict__ q, const int64_t* __restrict__ qoff,
                const int8_t* __restrict__ t, const int64_t* __restrict__ toff,
                int64_t n, int match, int mismatch, int gapo, int gape,
                int32_t* __restrict__ carry, const int64_t* __restrict__ coff,
                int32_t* __restrict__ out) {
  const int64_t pair = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  if (pair >= n) return;                 // the whole warp leaves together
  const int8_t* qs = q + qoff[pair];
  const int qlen = int(qoff[pair + 1] - qoff[pair]);
  const int8_t* ts = t + toff[pair];
  const int tlen = int(toff[pair + 1] - toff[pair]);
  // two halves of [qlen][2] (boundary H, running prefix max): strip s
  // reads half s & 1 and writes half (s + 1) & 1
  int32_t* cb = carry + (tlen > kTile ? coff[pair] : 0);
  const int go_e = gapo + gape;
  int best = 0;
  for (int j0 = 0, strip = 0; j0 < tlen; j0 += kTile, ++strip) {
    const bool from_left = j0 > 0;
    const bool to_right = j0 + kTile < tlen;
    const int32_t* rd = cb + (strip & 1) * 2 * qlen;
    int32_t* wr = cb + ((strip + 1) & 1) * 2 * qlen;
    const int jb = j0 + lane * kCols;    // this lane's first column
    int tc[kCols], H[kCols], E[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      tc[c] = jb + c < tlen ? int(ts[jb + c]) : -2;
      H[c] = 0;
      E[c] = kNeg;
    }
    int h_diag = 0;   // lane 0: previous row's H at column j0 - 1
    int qreg = -1;
    for (int i = 0; i < qlen; ++i) {
      if ((i & (kWarp - 1)) == 0) qreg = i + lane < qlen ? int(qs[i + lane]) : -1;
      const int qc = __shfl_sync(kFull, qreg, i & (kWarp - 1));
      // this row's boundary at column j0 - 1, from the previous strip
      int h_left = 0, m_left = kNeg;
      if (from_left && lane == 0) {
        h_left = rd[2 * i];
        m_left = rd[2 * i + 1];
      }
      int hm1 = __shfl_up_sync(kFull, H[kCols - 1], 1);
      if (lane == 0) {
        hm1 = h_diag;
        h_diag = h_left;
      }
      // pass 1: E, H_pre, and the lane's max of H_pre + gape*j (lane 0
      // starts from the prefix max carried in from the left)
      int lane_m = lane == 0 ? m_left : kNeg;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int s = tc[c] == qc ? match : mismatch;
        const int e2 = max(E[c] - gape, H[c] - go_e);
        const int hp = max(max(hm1 + s, e2), 0);
        hm1 = H[c];
        E[c] = e2;
        H[c] = hp;
        lane_m = max(lane_m, hp + gape * (jb + c));
      }
      // inclusive max-scan of the lane maxima across the warp
      int incl = lane_m;
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = max(incl, o);
      }
      int run = __shfl_up_sync(kFull, incl, 1);   // M at the column left
      if (lane == 0) run = m_left;                 // of this lane's first
      // pass 2: F from the running prefix max, then H and best
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int gj = gape * (jb + c);
        const int f = run - gapo - gj;
        run = max(run, H[c] + gj);
        H[c] = max(max(H[c], f), 0);
        if (jb + c < tlen) best = max(best, H[c]);
      }
      if (to_right && lane == kWarp - 1) {
        wr[2 * i] = H[kCols - 1];
        wr[2 * i + 1] = incl;
      }
    }
    __syncwarp();   // the next strip's lane 0 reads what lane 31 wrote
  }
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, d));
  if (lane == 0) out[pair] = best;
}

}  // namespace

extern "C" {

int k2_tile() { return kTile; }

int k2_sw_score(const void* q, const void* qoff, const void* t,
                const void* toff, int64_t n, int match, int mismatch,
                int gapo, int gape, void* carry, const void* coff, void* out,
                void* stream) {
  if (n <= 0) return 0;
  const int pairs_per_block = kThreads / kWarp;
  const unsigned blocks = unsigned((n + pairs_per_block - 1) / pairs_per_block);
  sw_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int64_t*>(qoff),
      static_cast<const int8_t*>(t), static_cast<const int64_t*>(toff), n,
      match, mismatch, gapo, gape, static_cast<int32_t*>(carry),
      static_cast<const int64_t*>(coff), static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
