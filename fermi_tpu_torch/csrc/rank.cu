// Kernel K1 for Hopper (sm_90a): the FMD-index rank count.
//
// Replaces the Pallas TPU kernel fermi_tpu/ops/rank_pallas.py `_rank_kernel`
// (called through `rank_block_counts`, and by fermi_tpu/index/fmd.py
// FMDIndex.rank6).  On the TPU, XLA gathered the nibble-packed block rows and
// the Pallas kernel only counted; here one thread per query gathers the
// fused rank row, counts and adds the block's occ in the same pass.
//
// Layout (index/fmd.py): the BWT is cut into 128-symbol blocks; a block's 16
// int32 words hold 8 symbols each (symbol at offset 8j+s in nibble s of word
// j, pad symbol 6).  A fused row is 24 int32: the 16 words, then the six
// exclusive occ counts of the block as 32-bit patterns, then 2 pad words.
// rank6(k)[c] = occ[k >> 7][c] + count of c among the first (k & 127)
// symbols of block k >> 7.
//
// Bound on this card: memory.  A query reads one 96-byte fused row (three
// 32-byte sectors, rows are random) plus its key and writes six counts, and
// does ~1e3 32-bit ALU operations, so at 3.35 TB/s and the ALU rate the
// gather dominates.  Design: one thread per query, the row as six 16-byte
// vector loads through the read-only path, counts kept in registers.  No
// shared-memory staging: rows are not reused across the threads of a block.
//
// Two entry points, both a plain C interface for ctypes:
//   k1_rank_block_counts: the TPU kernel's exact counterpart (words, off) ->
//     int32 [N, 8], columns 6-7 zero; used for parity and by rank6 on
//     indexes too large for fused rows.
//   k1_rank6_fused: what FMDIndex.rank6 launches: (fused rows, keys) ->
//     [N, 6] counts in the key's integer type (int32 or int64).
// Each returns the cudaError_t of its launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kNib1 = 0x11111111u;  // bit 0 of every nibble
constexpr int kThreads = 256;

// Mask of the nibbles of word j that lie below prefix length `off`:
// t = clamp(off - 8j, 0, 8) low nibbles, bit 0 of each.
__device__ __forceinline__ uint32_t allowed_mask(int off, int j) {
  int t = off - 8 * j;
  t = t < 0 ? 0 : (t > 8 ? 8 : t);
  return t >= 8 ? kNib1 : (((1u << (4 * t)) - 1u) & kNib1);
}

// Adds to cnt[c] the number of allowed nibbles of w equal to c.
// Trouble spot: the TPU version sums zero-nibble marks as
// ((zeros * 0x11111111) >> 28) & 15 in int32, where the multiply wraps.
// Everything here is uint32_t; `zeros` holds at most bit 0 of each of the
// 8 nibbles, so its popcount is that same sum, with no multiply at all.
// Nibble values are <= 6 and c <= 5, so x's nibbles are <= 7 and the
// shifts never carry a bit across nibbles.
__device__ __forceinline__ void count_word(uint32_t w, uint32_t allowed,
                                           int cnt[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    uint32_t x = w ^ (uint32_t(c) * kNib1);
    uint32_t nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & kNib1;
    cnt[c] += __popc(~nz & allowed);
  }
}

__device__ __forceinline__ void count_quad(int4 v, int off, int j0,
                                           int cnt[6]) {
  count_word(uint32_t(v.x), allowed_mask(off, j0 + 0), cnt);
  count_word(uint32_t(v.y), allowed_mask(off, j0 + 1), cnt);
  count_word(uint32_t(v.z), allowed_mask(off, j0 + 2), cnt);
  count_word(uint32_t(v.w), allowed_mask(off, j0 + 3), cnt);
}

__global__ void __launch_bounds__(kThreads)
rank_block_counts_kernel(const int4* __restrict__ words,
                         const int32_t* __restrict__ off,
                         int4* __restrict__ out, int64_t n) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int o = off[i];
  const int4* row = words + i * 4;
  int cnt[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q) count_quad(__ldg(row + q), o, 4 * q, cnt);
  out[i * 2] = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
  out[i * 2 + 1] = make_int4(cnt[4], cnt[5], 0, 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rank6_fused_kernel(const int4* __restrict__ fused, int64_t nrows,
                   const T* __restrict__ k, T* __restrict__ out, int64_t n) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T kk = k[i];
  // keys outside [0, 128 * nrows) read the nearest row, as the plain
  // version's clamp does; the index never issues them (k <= n reads at
  // most the all-pad row NB)
  int64_t blk = int64_t(kk) >> 7;
  blk = blk < 0 ? 0 : (blk >= nrows ? nrows - 1 : blk);
  const int o = int(kk & T(127));
  const int4* row = fused + blk * 6;
  int4 v[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) v[q] = __ldg(row + q);
  int cnt[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q) count_quad(v[q], o, 4 * q, cnt);
  // Trouble spot: occ counts of indexes with 2^31 <= n < 2^32 are stored
  // as negative int32 patterns; read them as uint32 before widening.
  const uint32_t occ[6] = {uint32_t(v[4].x), uint32_t(v[4].y),
                           uint32_t(v[4].z), uint32_t(v[4].w),
                           uint32_t(v[5].x), uint32_t(v[5].y)};
  T* o6 = out + i * 6;
#pragma unroll
  for (int c = 0; c < 6; ++c) o6[c] = T(occ[c]) + T(cnt[c]);
}

inline unsigned blocks_for(int64_t n) {
  return unsigned((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int k1_rank_block_counts(const void* words, const void* off, void* out,
                         int64_t n, void* stream) {
  if (n <= 0) return 0;
  rank_block_counts_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(words), static_cast<const int32_t*>(off),
      static_cast<int4*>(out), n);
  return int(cudaGetLastError());
}

int k1_rank6_fused(const void* fused, int64_t nrows, const void* k,
                   void* out, int64_t n, int wide, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    rank6_fused_kernel<int64_t><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int4*>(fused), nrows,
        static_cast<const int64_t*>(k), static_cast<int64_t*>(out), n);
  else
    rank6_fused_kernel<int32_t><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int4*>(fused), nrows,
        static_cast<const int32_t*>(k), static_cast<int32_t*>(out), n);
  return int(cudaGetLastError());
}

}  // extern "C"
