// Kernel K2 for Hopper (sm_90a): batched Smith-Waterman local-alignment
// score (affine gaps, score only).
//
// Replaces the Pallas TPU kernel fermi_tpu/ops/sw_pallas.py `_sw_kernel`
// (called through `_sw_call` / `sw_score_batch`).  The TPU kernel puts the
// target across the vector lanes and closes the horizontal gap F of each row
// with a lazy-F prefix max.  Here the query lies across the lanes and the
// target streams past them, so F is carried exactly along each row and there
// is no scan.  Per cell (i, j), with H = 0 above row 0 and left of column 0,
// and E = F = NEG there:
//
//   s = t[j] == q[i] ? match : mismatch                 compare, select
//   H = max(H[i-1][j-1] + s, E, F, 0)                   add, DPX 3-way max
//   o = H - (gapo + gape)                               add
//   E[i+1][j] = max(E - gape, o)                        DPX add-max
//   F[i][j+1] = max(F - gape, o)                        DPX add-max
//   best = max(best, H)                                 max
//
// 8 integer operations a cell, the count chip_smoke.py prices the bound
// with.  Carried F equals the TPU's closed form whenever gapo >= 0: a gap
// opened from a cell whose H came from F costs gapo more than extending the
// gap that cell came from, so it never wins; the wrapper refuses gapo < 0.
// Columns at or past tlen are never computed and rows at or past qlen never
// enter `best` (they lie below every real row, so nothing reads them).
//
// Layout: a group of G lanes (G = 4, 8, 16 or 32) holds one pair.  Lane g
// keeps kRows consecutive query rows in registers: their symbols, H of the
// previous column and F.  Step s of the warp is column s - g of lane g, an
// anti-diagonal wavefront: per step one width-G __shfl_up_sync each brings
// lane g-1's last-row H and the E below it, and the target symbol, all of
// column s - g, which lane g-1 computed the step before; the H received a
// step earlier is the diagonal of the lane's first row.  Lane 0 takes the
// target symbol from device memory and the row above from the boundary.
// E then runs down the lane's kRows rows in registers.  32 / G pairs of one
// size class share a warp.  A query longer than 32 * kRows rows runs in
// chunks of that many rows, G = 32, on all kWarpsPerBlock warps of one
// block at once: warp w takes chunks w, w + kWarpsPerBlock, ...  Chunk c
// hands each target column's last-row H and the E below it, 8 bytes, to
// chunk c + 1 through boundary c of a per-pair buffer in device memory:
// lane 31 writes column j at its step j + 31 and every 8 columns publishes
// the count written in shared memory (after a block-scope fence); lane 0 of
// the next chunk's warp waits for that count before it reads the column, so
// the chunks run as a pipeline some 40 steps apart instead of one after the
// other.  All warps of the block are resident together, and a chunk waits
// only on the chunk before it, so the wait always ends.  Targets of any
// length stream.
//
// Bound on this card: operations (8 a cell, 6 on the integer pipe; a few
// bytes per row and column).  What is lost: rows past qlen in the last lane
// of a group (G is a power of two), the G - 1 steps of the wavefront's fill
// and drain, groups of a warp whose targets are shorter than the longest,
// and per step 3 shuffles and the lane-0 loads.  The host puts the blocks
// of long queries first and orders the other warps by their step count,
// longest first, so a long pair starts at once and does not form the tail.
//
// Entry point (plain C interface for ctypes), returns the cudaError_t of the
// launch (0 = launched):
//   k2_sw_score(q, qoff, t, toff, tasks, ntasks, match, mismatch, gapo,
//               gape, carry, coff, out, stream)
//   q, t: int8 concatenated sequences; qoff, toff: int64 [n+1] offsets;
//   tasks: int32 [ntasks, kTask], one warp each: G (| kPipe), then
//   32 / G pair ids (-1 = none; 8 slots); the kWarpsPerBlock
//   tasks of a pair with more than one chunk fill one block, each kPipe
//   with that pair; carry: int2 scratch, coff: int64 [n] offsets into it
//   ((chunks - 1) * tlen entries for each pair of more than one chunk);
//   out: int32 [n], every pair named by exactly one task or one block.
// k2_rows() and k2_block_warps() return kRows and kWarpsPerBlock, from
// which the host sizes groups, chunks and blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -1000000;           // sw_pallas.py NEG
constexpr int kWarp = 32;
constexpr int kRows = 8;                 // query rows per lane
constexpr int kChunk = kWarp * kRows;    // query rows per chunk
constexpr int kTask = 9;                 // G (| flags), 8 pair slots
constexpr int kPipe = 512;               // task flag: a long pair's block
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int match, mismatch, go_e, ngape;
};

// One target column down a lane's kRows rows: t_in the column's symbol,
// diag the H above-left of the first row, e the E of the first row (on
// return, the E below the last).  The plain form takes 8 operations a
// cell, but each row's E waits for its H: three dependent operations a
// row.  kShort takes 10 and makes E the only chain, one operation a row:
// H - (gapo + gape) = max(diag + s, F, 0, E) - (gapo + gape), and the E
// term there is below E - gape when gapo >= 0, so the E below is
// max(E - gape, max(diag + s, F, 0) - (gapo + gape)), free of this H.
template <bool kShort>
__device__ __forceinline__ void column(int t_in, int diag, int& e,
                                       const int (&qv)[kRows],
                                       int (&H)[kRows], int (&F)[kRows],
                                       int (&bst)[kRows], const Scores& sc) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int a = diag + (t_in == qv[r] ? sc.match : sc.mismatch);
    int h;
    if (kShort) {
      const int x = __vimax_s32_relu(a, F[r]);
      h = max(x, e);
      e = __viaddmax_s32(e, sc.ngape, x - sc.go_e);
    } else {
      h = __vimax3_s32_relu(a, e, F[r]);
      e = __viaddmax_s32(e, sc.ngape, h - sc.go_e);
    }
    diag = H[r];
    H[r] = h;
    F[r] = __viaddmax_s32(F[r], sc.ngape, h - sc.go_e);
    bst[r] = max(bst[r], h);
  }
}

// Waits until the count published at *p reaches need (`seen`: the last
// count this lane read), then orders the reads after it behind the writes
// the count covers.  Counts wrap modulo 2^32 and are compared by their
// difference, which stays within one target length: a warp waits on a
// chunk only after reading the whole boundary its writer wrote before.
// A wait that could not end (a
// schedule that broke the kernel's contract) stops the launch with an
// error after some seconds instead of hanging the card.
__device__ __forceinline__ void wait_for(const volatile unsigned* p,
                                         unsigned need, unsigned& seen) {
  if (int(seen - need) >= 0) return;
  for (unsigned spins = 0; int((seen = *p) - need) < 0; ++spins) {
    if (spins > (1u << 26)) __trap();
    __nanosleep(64);
  }
  __threadfence_block();
}

// The pairs of one warp task over query chunks c0, c0 + cstep, ... below
// nchunk: returns this lane's best over its valid rows.  Chunk c reads
// boundary c - 1 of the carry and writes boundary c; prog[w] counts the
// boundary columns that the block's warp w has published, over all its
// chunks in order, so it only grows.
//
// kLong: the warps of a long query's block (kPipe).  Each chunk waits on
// the one before it, and a long target keeps the block running after the
// launch's other warps end, beside them until then: the latency of a step
// sets its pace, so it takes the short-chain form.  The other warps run
// one chunk, without the carry, in the plain form, which issues fewer
// operations; their pace is the issue rate of the SM they share.
template <bool kLong>
__device__ __forceinline__ int sweep(const int8_t* qs, int qlen,
                                     const int8_t* ts, int tlen, int2* cb,
                                     int c0, int cstep, int nchunk,
                                     volatile unsigned* prog, int G, int g,
                                     int e_top, const Scores& sc) {
  const int steps = __reduce_max_sync(kFull, tlen) + G - 1;
  int best = 0;
  for (int c = c0; c < nchunk; c += cstep) {
    const int row0 = c * G * kRows + g * kRows;
    int qv[kRows], H[kRows], F[kRows], bst[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      qv[r] = row0 + r < qlen ? int(qs[row0 + r]) : -1;
      H[r] = 0;
      F[r] = kNeg;
      bst[r] = 0;
    }
    const bool to_carry = kLong && g == G - 1 && c + 1 < nchunk;
    const bool from_carry = kLong && c > 0;
    const int2* rd = cb + int64_t(c - 1) * tlen;     // boundary c - 1
    int2* wr = cb + int64_t(c) * tlen;               // boundary c
    // column j of boundary c - 1 is there once its writer's count reaches
    // need0 + j; this chunk's column j counts pub0 + j
    const volatile unsigned* pin =
        prog + (c + kWarpsPerBlock - 1) % kWarpsPerBlock;
    volatile unsigned* pout = prog + c % kWarpsPerBlock;
    const unsigned need0 = unsigned((c - 1) / kWarpsPerBlock) * tlen + 1u;
    const unsigned pub0 = unsigned(c / kWarpsPerBlock) * tlen + 1u;
    unsigned seen = need0 - 1u;          // nothing of boundary c - 1 yet
    // what this lane hands to lane g + 1: last row's H, the E below it and
    // the target symbol of its previous step's column
    int h_out = 0, e_out = e_top, t_out = -2;
    int diag0 = 0;                       // H[row0 - 1][j - 1]
    // lane 0 reads one column ahead
    int t_nx = -2;
    int2 c_nx = make_int2(0, e_top);
    if (g == 0 && tlen > 0) {
      t_nx = ts[0];
      if (from_carry) {
        wait_for(pin, need0, seen);
        c_nx = rd[0];
      }
    }
    for (int s = 0; s < steps; ++s) {
      int h_in = __shfl_up_sync(kFull, h_out, 1, G);
      int e_in = __shfl_up_sync(kFull, e_out, 1, G);
      int t_in = __shfl_up_sync(kFull, t_out, 1, G);
      if (g == 0) {
        t_in = t_nx;
        h_in = c_nx.x;
        e_in = c_nx.y;
        if (s + 1 < tlen) {
          t_nx = ts[s + 1];
          if (from_carry) {
            wait_for(pin, need0 + s + 1, seen);
            c_nx = rd[s + 1];
          }
        }
      }
      const int j = s - g;
      if (j >= 0 && j < tlen) {
        int e = e_in;
        column<kLong>(t_in, diag0, e, qv, H, F, bst, sc);
        h_out = H[kRows - 1];
        e_out = e;
        t_out = t_in;
        diag0 = h_in;
        if (to_carry) {
          wr[j] = make_int2(h_out, e_out);
          if ((j & 7) == 7 || j == tlen - 1) {
            __threadfence_block();
            *pout = pub0 + j;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < qlen) best = max(best, bst[r]);
  }
  return best;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
sw_wavefront_kernel(const int8_t* __restrict__ q,
                    const int64_t* __restrict__ qoff,
                    const int8_t* __restrict__ t,
                    const int64_t* __restrict__ toff,
                    const int32_t* __restrict__ tasks, int64_t ntasks,
                    int match, int mismatch, int gapo, int gape,
                    int2* carry, const int64_t* __restrict__ coff,
                    int32_t* __restrict__ out) {
  __shared__ unsigned prog[kWarpsPerBlock];
  __shared__ int bests[kWarpsPerBlock];
  const int64_t w = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (w >= ntasks) return;               // the whole warp leaves together
  const int lane = threadIdx.x & (kWarp - 1);
  const int wb = threadIdx.x / kWarp;    // warp in the block
  const int32_t* task = tasks + w * kTask;
  // a block of kPipe tasks (one long pair) or none: the flag is the same
  // for every thread of the block, so its barriers are reached by all
  const bool pipe = task[0] & kPipe;
  const int G = task[0] & (kPipe - 1);
  const int g = lane & (G - 1);
  const int pair = task[1 + lane / G];
  int qlen = 0, tlen = 0;
  const int8_t* qs = q;
  const int8_t* ts = t;
  int2* cb = carry;
  if (pair >= 0) {
    qs = q + qoff[pair];
    qlen = int(qoff[pair + 1] - qoff[pair]);
    ts = t + toff[pair];
    tlen = int(toff[pair + 1] - toff[pair]);
  }
  if (pipe) {
    cb = carry + coff[pair];
    if (threadIdx.x < kWarpsPerBlock) prog[threadIdx.x] = 0;
    __syncthreads();
  }
  const Scores sc = {match, mismatch, gapo + gape, -gape};
  const int e_top = max(kNeg - gape, -(gapo + gape));  // E of row 0
  // only a block of kPipe warps runs more than one chunk: its warp wb
  // takes chunks wb, wb + kWarpsPerBlock, ...
  int best = pipe ? sweep<true>(qs, qlen, ts, tlen, cb, wb, kWarpsPerBlock,
                                (qlen + kChunk - 1) / kChunk, prog, G, g,
                                e_top, sc)
                  : sweep<false>(qs, qlen, ts, tlen, cb, 0, 1, 1, prog, G, g,
                                 e_top, sc);
  for (int d = G / 2; d > 0; d >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, d, G));
  if (!pipe) {
    if (g == 0 && pair >= 0) out[pair] = best;
    return;
  }
  if (lane == 0) bests[wb] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarpsPerBlock; ++i) best = max(best, bests[i]);
    out[pair] = best;
  }
}

}  // namespace

extern "C" {

int k2_rows() { return kRows; }

int k2_block_warps() { return kWarpsPerBlock; }

int k2_sw_score(const void* q, const void* qoff, const void* t,
                const void* toff, const void* tasks, int64_t ntasks,
                int match, int mismatch, int gapo, int gape, void* carry,
                const void* coff, void* out, void* stream) {
  if (ntasks <= 0) return 0;
  const unsigned blocks =
      unsigned((ntasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sw_wavefront_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int64_t*>(qoff),
      static_cast<const int8_t*>(t), static_cast<const int64_t*>(toff),
      static_cast<const int32_t*>(tasks), ntasks, match, mismatch, gapo, gape,
      static_cast<int2*>(carry), static_cast<const int64_t*>(coff),
      static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
