// fmindex.h — blocked-occ FM-index view for the port's host engines.
//
// The port's own copy of fermi_tpu/native/fmindex.h.  Logical layout
// mirrors fermi_tpu_torch/index/fmd.py: dense nt6 BWT in [nb+1, 128] byte
// blocks plus exclusive cumulative occ at block starts.  rank6(k) counts
// symbols in BWT[0..k-1].
//
// Physical layout is interleaved for pointer-chasing walks: one record per
// block packing the 128 BWT bytes, the 6-symbol occ row (u32 when every
// count fits, u64 otherwise) and a 32-byte sub-block count table, so a rank
// query touches the scan line and one meta line of one page.  setup() builds
// the records, threaded, from the caller's blocks/occ arrays; setup_blk()
// maps them read-only from a .fmd.blk record cache (the out-of-core `-M`
// form, written by fmblk_build in rld_codec.cpp).  Both return 0, or a
// negative code the caller passes on.

#ifndef FERMI_TPU_TORCH_FMINDEX_H_
#define FERMI_TPU_TORCH_FMINDEX_H_

#include <fcntl.h>
#include <unistd.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <sys/mman.h>

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
#if defined(MADV_HUGEPAGE)
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

// on-disk header of the blocked record cache (.fmd.blk): one 4 KB page,
// then the records verbatim, byte-for-byte fermi_tpu's layout.  Engines
// mmap it read-only (MADV_RANDOM), so an index bigger than RAM runs with
// RSS bounded by the touched pages: the reference's `-M` (rld.c:327-346).
struct BlkHeader {
  char magic[8];  // "FMBLK\1\0\0"
  int64_t rstride;
  int64_t n_rows;
  int64_t total;
  int64_t n_seqs;
  int64_t cnt[8];  // cumulative counts, cnt[7] = cnt[6]
  int64_t wide;
};
constexpr char kBlkMagic[8] = {'F', 'M', 'B', 'L', 'K', 1, 0, 0};
constexpr size_t kBlkHeaderBytes = 4096;

struct Index {
  // record: [0,128) bwt | occ 6x(u32|u64) | 18B sub | pad
  //   narrow (u32): meta bytes [128,170), stride 192 — one meta line
  //   wide   (u64): meta bytes [128,194), stride 256 — two meta lines
  HugeBuf rec;
  size_t rstride = 0;
  bool wide = false;
  int64_t cnt[8] = {0};
  int64_t n_seqs = 0;
  void* map_base = nullptr;  // set when the records are a file mapping
  size_t map_len = 0;

  Index() = default;
  Index(const Index&) = delete;
  Index& operator=(const Index&) = delete;
  ~Index() {
    if (map_base) {
      rec.p = nullptr;  // borrowed from the mapping, not malloc'd
      munmap(map_base, map_len);
    }
  }

  // map a .fmd.blk record cache: 0, or -1 (open), -2 (short), -3 (mmap),
  // -4 (not a record cache)
  int setup_blk(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    off_t len = lseek(fd, 0, SEEK_END);
    if (len < (off_t)kBlkHeaderBytes) {
      close(fd);
      return -2;
    }
    void* base = mmap(nullptr, (size_t)len, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (base == MAP_FAILED) return -3;
    const BlkHeader* h = (const BlkHeader*)base;
    if (memcmp(h->magic, kBlkMagic, 8) != 0 ||
        (size_t)len != kBlkHeaderBytes + (size_t)h->rstride * h->n_rows) {
      munmap(base, (size_t)len);
      return -4;
    }
    madvise(base, (size_t)len, MADV_RANDOM);
    map_base = base;
    map_len = (size_t)len;
    rstride = (size_t)h->rstride;
    wide = h->wide != 0;
    for (int i = 0; i < 8; ++i) cnt[i] = h->cnt[i];
    n_seqs = h->n_seqs;
    rec.p = (uint8_t*)base + kBlkHeaderBytes;
    return 0;
  }

  // build the records from resident arrays: 0, or -1 when the allocation
  // fails
  int setup(const uint8_t* blocks_, const int64_t* occ_, int64_t n_rows,
            const int64_t* cnt_, int64_t n_seqs_) {
    for (int i = 0; i < 8; ++i) cnt[i] = cnt_[i];
    n_seqs = n_seqs_;
    wide = cnt[6] > (int64_t)UINT32_MAX;
    rstride = wide ? 256 : 192;
    rec.alloc(rstride * (size_t)n_rows);
    if (!rec.p) return -1;
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
    return 0;
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

  uint8_t sym_at(int64_t k) const {
    return record(k >> kBlockBits)[k & (kBlock - 1)];
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
