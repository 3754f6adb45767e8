// seqsort / seqrank host engine: the rank -> read-id permutation
// (reference seqsort.c:12-35 semantics; same walk as the device
// search/extend.seqrank_walk).  For every forward-strand sequence id
// (even), LF-walk from sentinel rank id while tracking the full-read
// bi-interval, then containment-check with sentinel extensions and record
//   sorted[k]      = id<<2 | contained<<1 | dup
//   sorted[mirror] = (id|1)<<2 | ...
// Striped thread pool over ids (reference P3 pattern).
//
// The port's copy of fermi_tpu/native/seqsort.cpp: over resident arrays
// (fseqsort) or a mmapped .fmd.blk record cache (fseqsort_blk, the `-M`
// path).  Both return 0, or a negative code the caller raises on.

#include <cstdint>
#include <thread>
#include <vector>

#include "fmindex.h"

namespace {

using fermi_native::Index;
using fermi_native::comp6;

struct WalkOut {
  int64_t k, kb, kf, sz;
  int contained;
};

inline void extend_back(const Index& I, int64_t kb, int64_t kf, int64_t sz,
                        int c, int64_t* ekb, int64_t* ekf, int64_t* esz,
                        int64_t tk[6], int64_t osz[6]) {
  int64_t tl[6];
  I.rank6_pair(kb, kb + sz, tk, tl);
  for (int j = 0; j < 6; ++j) osz[j] = tl[j] - tk[j];
  *ekb = I.cnt[c] + tk[c];
  *esz = osz[c];
  int64_t off;
  switch (c) {  // complement ordering 0,4,3,2,1,5
    case 0: off = 0; break;
    case 4: off = osz[0]; break;
    case 3: off = osz[0] + osz[4]; break;
    case 2: off = osz[0] + osz[4] + osz[3]; break;
    case 1: off = osz[0] + osz[4] + osz[3] + osz[2]; break;
    default: off = osz[0] + osz[4] + osz[3] + osz[2] + osz[1]; break;
  }
  *ekf = kf + off;
}

WalkOut seqrank_walk1(const Index& I, int64_t x) {
  int64_t k = x, kb = 0, kf = 0, sz = 0;
  bool started = false;
  while (true) {
    int c = I.sym_at(k);
    int64_t r[6];
    I.rank6(k, r);
    int64_t kp = I.cnt[c] + r[c];
    if (c == 0) {
      k = kp;
      break;
    }
    if (!started) {
      kb = I.cnt[c];
      sz = I.cnt[c + 1] - I.cnt[c];
      kf = I.cnt[comp6(c)];
      started = true;
    } else if (sz == 1) {
      kb = kp;
    } else {
      int64_t tk[6], osz[6], ekb, ekf, esz;
      extend_back(I, kb, kf, sz, c, &ekb, &ekf, &esz, tk, osz);
      kb = ekb;
      kf = ekf;
      sz = esz;
    }
    k = kp;
  }
  // left containment: backward extension by the sentinel
  int contained = 0;
  int64_t tk[6], tl[6];
  I.rank6_pair(kb, kb + sz, tk, tl);
  int64_t sz0 = tl[0] - tk[0];
  int64_t kb2, kf2, sz2;
  if (sz == 1) {
    kb2 = k;
    kf2 = kf;
    sz2 = sz;
  } else {
    if (sz0 != sz) contained |= 1;
    kb2 = I.cnt[0] + tk[0];
    kf2 = kf;  // sentinel's forward offset is 0
    sz2 = sz0;
  }
  // right containment: forward extension by the sentinel
  I.rank6_pair(kf2, kf2 + sz2, tk, tl);
  int64_t fsz0 = tl[0] - tk[0];
  if (fsz0 != sz2) contained |= 2;
  return {k, kb2, I.cnt[0] + tk[0], fsz0, contained};
}

}  // namespace

extern "C" {

static void fseqsort_impl(const Index& I, int64_t n_seqs, uint64_t* sorted,
                          int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> th;
  for (int t = 0; t < n_threads; ++t)
    th.emplace_back([&, t] {
      for (int64_t i = 2 * t; i < n_seqs; i += 2 * n_threads) {
        WalkOut w = seqrank_walk1(I, i);
        uint64_t flag = (w.contained ? 2u : 0u) |
                        ((w.sz > 1 && w.k != w.kb) ? 1u : 0u);
        sorted[w.k] = ((uint64_t)i << 2) | flag;
        int64_t l = w.k - w.kb;
        int64_t mirror = (w.kb != w.kf) ? w.kf + l : w.k + 1;
        sorted[mirror] = (((uint64_t)i | 1) << 2) | flag;
      }
    });
  for (auto& x : th) x.join();
}

// -1 when the records cannot be allocated
int fseqsort(const uint8_t* blocks, const int64_t* occ, int64_t n_rows,
             const int64_t* cnt, int64_t n_seqs, uint64_t* sorted,
             int n_threads) {
  Index I;
  if (I.setup(blocks, occ, n_rows, cnt, n_seqs)) return -1;
  fseqsort_impl(I, n_seqs, sorted, n_threads);
  return 0;
}

// out-of-core variant over an mmapped .fmd.blk cache (`-M`); -1 when the
// cache cannot be mapped
int fseqsort_blk(const char* blk_path, uint64_t* sorted, int n_threads) {
  Index I;
  if (I.setup_blk(blk_path)) return -1;
  fseqsort_impl(I, I.n_seqs, sorted, n_threads);
  return 0;
}

}  // extern "C"
