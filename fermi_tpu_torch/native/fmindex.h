// fmindex.h — blocked-occ FM-index view for the port's host engines.
//
// The port's own copy of fermi_tpu/native/fmindex.h without the mmapped
// record cache (the `-M` path, ROADMAP queue 1 item 3c).  Logical layout
// mirrors fermi_tpu_torch/index/fmd.py: dense nt6 BWT in [nb+1, 128] byte
// blocks plus exclusive cumulative occ at block starts.  rank6(k) counts
// symbols in BWT[0..k-1].
//
// Physical layout is interleaved for pointer-chasing walks: one record per
// block packing the 128 BWT bytes, the 6-symbol occ row (u32 when every
// count fits, u64 otherwise) and a 32-byte sub-block count table, so a rank
// query touches the scan line and one meta line of one page.  setup() builds
// the records, threaded, from the caller's blocks/occ arrays.

#ifndef FERMI_TPU_TORCH_FMINDEX_H_
#define FERMI_TPU_TORCH_FMINDEX_H_

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <sys/mman.h>
#endif

namespace fermi_native {

constexpr int kBlockBits = 7;
constexpr int kBlock = 1 << kBlockBits;

// 2 MB-aligned buffer advised to transparent huge pages: the record array
// is gigabytes accessed at random, so 4K pages make every rank query a TLB
// miss and a page walk on top of the data miss
struct HugeBuf {
  uint8_t* p = nullptr;
  size_t cap = 0;

  void alloc(size_t size) {
    release();
    constexpr size_t kHuge = 2 << 20;
    cap = (size + kHuge - 1) & ~(kHuge - 1);
    p = (uint8_t*)std::aligned_alloc(kHuge, cap);
#if defined(__linux__) && defined(MADV_HUGEPAGE)
    if (p) madvise(p, cap, MADV_HUGEPAGE);
#endif
  }
  void release() {
    std::free(p);
    p = nullptr;
    cap = 0;
  }
  ~HugeBuf() { release(); }
  HugeBuf() = default;
  HugeBuf(const HugeBuf&) = delete;
  HugeBuf& operator=(const HugeBuf&) = delete;
};

struct Index {
  // record: [0,128) bwt | occ 6x(u32|u64) | 18B sub | pad
  //   narrow (u32): meta bytes [128,170), stride 192 — one meta line
  //   wide   (u64): meta bytes [128,194), stride 256 — two meta lines
  HugeBuf rec;
  size_t rstride = 0;
  bool wide = false;
  int64_t cnt[8] = {0};
  int64_t n_seqs = 0;

  void setup(const uint8_t* blocks_, const int64_t* occ_, int64_t n_rows,
             const int64_t* cnt_, int64_t n_seqs_) {
    for (int i = 0; i < 8; ++i) cnt[i] = cnt_[i];
    n_seqs = n_seqs_;
    wide = cnt[6] > (int64_t)UINT32_MAX;
    rstride = wide ? 256 : 192;
    rec.alloc(rstride * (size_t)n_rows);
    int T = (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if (T > 8) T = 8;
    std::vector<std::thread> th;
    int64_t chunk = (n_rows + T - 1) / T;
    for (int t = 0; t < T; ++t)
      th.emplace_back([&, t] {
        int64_t b0 = t * chunk;
        int64_t b1 = b0 + chunk < n_rows ? b0 + chunk : n_rows;
        for (int64_t b = b0; b < b1; ++b) {
          const uint8_t* row = blocks_ + b * kBlock;
          uint8_t* R = rec.p + rstride * (size_t)b;
          memcpy(R, row, kBlock);
          const int64_t* ob = occ_ + b * 8;
          if (wide) {
            uint64_t* o = (uint64_t*)(R + kBlock);
            for (int j = 0; j < 6; ++j) o[j] = (uint64_t)ob[j];
          } else {
            uint32_t* o = (uint32_t*)(R + kBlock);
            for (int j = 0; j < 6; ++j) o[j] = (uint32_t)ob[j];
          }
          uint8_t* dst = R + kBlock + (wide ? 48 : 24);
          uint8_t c[8] = {0};  // 8: rows are padded with symbol 6
          for (int s = 0; s < 3; ++s) {
            for (int i = s * 32; i < (s + 1) * 32; ++i) ++c[row[i]];
            for (int j = 0; j < 6; ++j) dst[s * 6 + j] = c[j];
          }
        }
      });
    for (auto& x : th) x.join();
  }

  inline const uint8_t* record(int64_t blk) const {
    return rec.p + rstride * (size_t)blk;
  }

  void rank6(int64_t k, int64_t out[6]) const {
    int64_t blk = k >> kBlockBits;
    int off = (int)(k & (kBlock - 1));
    const uint8_t* R = record(blk);
    int s = off >> 5;
    int64_t c[6] = {0, 0, 0, 0, 0, 0};
    const uint8_t* meta = R + kBlock;
    const uint8_t* subt = meta + (wide ? 48 : 24);
    if (s) {
      const uint8_t* q = subt + (s - 1) * 6;
      for (int j = 0; j < 6; ++j) c[j] = q[j];
    }
    for (int i = s << 5; i < off; ++i) ++c[R[i]];
    if (wide) {
      const uint64_t* o = (const uint64_t*)meta;
      for (int j = 0; j < 6; ++j) out[j] = (int64_t)o[j] + c[j];
    } else {
      const uint32_t* o = (const uint32_t*)meta;
      for (int j = 0; j < 6; ++j) out[j] = (int64_t)o[j] + c[j];
    }
  }

  // counts at both k and k2 (k <= k2); one sub-table hit + two short scans,
  // sharing the scan when both land in the same block
  void rank6_pair(int64_t k, int64_t k2, int64_t lo[6], int64_t hi[6]) const {
    rank6(k, lo);
    int64_t blk = k >> kBlockBits, blk2 = k2 >> kBlockBits;
    if (blk2 != blk) {
      rank6(k2, hi);
      return;
    }
    int off = (int)(k & (kBlock - 1)), off2 = (int)(k2 & (kBlock - 1));
    const uint8_t* R = record(blk);
    for (int j = 0; j < 6; ++j) hi[j] = lo[j];
    for (int i = off; i < off2; ++i) ++hi[R[i]];
  }

  // hint the lines a future rank6(k) will touch
  void prefetch(int64_t k) const {
    const uint8_t* R = record(k >> kBlockBits);
    int off = (int)(k & (kBlock - 1));
    __builtin_prefetch(R + (off & 64), 0, 1);  // the scan window's line
    __builtin_prefetch(R + kBlock, 0, 1);      // occ + sub
    if (wide) __builtin_prefetch(R + 192, 0, 1);
  }
};

inline int comp6(int c) { return (c >= 1 && c <= 4) ? 5 - c : c; }

}  // namespace fermi_native

#endif  // FERMI_TPU_TORCH_FMINDEX_H_
