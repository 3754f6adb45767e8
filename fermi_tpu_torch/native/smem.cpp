// smem.cpp — native SMEM engine for long queries (contigs).
//
// Sequential fm6_smem1_core / fm6_smem (reference smem.c:13-80, 397-411;
// same semantics as the batched device loop in search/smem.py). The device
// loop pads per-read interval sets to a fixed width, which is ruinous for
// contig-scale queries whose sets reach hundreds; this engine pays only the
// true set sizes. Shares the blocked-occ index layout with unitig.cpp.
//
// The port's copy of the first half of fermi_tpu/native/smem.cpp: without
// the mmapped-index variant (`-M`) and the collect DFS (queue 1 item 3c),
// and without oom.h (a failed allocation returns null, which the caller
// raises on).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "fmindex.h"

namespace {

using fermi_native::comp6;
using fermi_native::Index;

struct Intv {
  int64_t kb, kf, sz;
  uint64_t info;
};

static void extend6(const Index& e, const Intv& ik, bool is_back, Intv ok[6]) {
  int64_t primary = is_back ? ik.kb : ik.kf;
  int64_t tk[6], tl[6];
  e.rank6_pair(primary, primary + ik.sz, tk, tl);
  int64_t osz[6], outp[6], other[6];
  for (int c = 0; c < 6; ++c) osz[c] = tl[c] - tk[c];
  for (int c = 0; c < 6; ++c) outp[c] = e.cnt[c] + tk[c];
  int64_t base = is_back ? ik.kf : ik.kb;
  other[0] = base;
  other[4] = other[0] + osz[0];
  other[3] = other[4] + osz[4];
  other[2] = other[3] + osz[3];
  other[1] = other[2] + osz[2];
  other[5] = other[1] + osz[1];
  for (int c = 0; c < 6; ++c) {
    ok[c].sz = osz[c];
    ok[c].info = 0;
    if (is_back) {
      ok[c].kb = outp[c];
      ok[c].kf = other[c];
    } else {
      ok[c].kb = other[c];
      ok[c].kf = outp[c];
    }
  }
}

struct Mem {
  int32_t start, end;
  int64_t sz, kf;
  uint8_t closed;
};

// reference fm6_smem1_core (smem.c:13-80); returns the next start
static int smem1_core(const Index& e, int len, const uint8_t* q, int x,
                      std::vector<Mem>& mems, bool self_match,
                      std::vector<Intv>& prev, std::vector<Intv>& curr) {
  Intv ik, ok[6];
  int c = q[x];
  ik = {e.cnt[c], e.cnt[comp6(c)], e.cnt[c + 1] - e.cnt[c], (uint64_t)(x + 1)};
  curr.clear();
  int i;
  for (i = x + 1; i < len; ++i) {  // forward search
    c = comp6(q[i]);
    extend6(e, ik, false, ok);
    if (ok[c].sz != ik.sz) {
      if (ik.sz != ok[0].sz) curr.push_back(ik);
      if (!self_match && ok[0].sz) {
        ok[0].info = (uint64_t)i;
        curr.push_back(ok[0]);
      }
    }
    if ((!self_match && ok[c].sz == 0) || (self_match && ok[c].sz < 2)) break;
    ik = ok[c];
    ik.info = (uint64_t)(i + 1);
  }
  if (i == len) {
    curr.push_back(ik);
    if (!self_match) {
      extend6(e, ik, false, ok);
      if (ok[0].sz) {
        ok[0].info = (uint64_t)len;
        curr.push_back(ok[0]);
      }
    }
  }
  std::reverse(curr.begin(), curr.end());
  int ret = curr.empty() ? (i >= len ? len : i) : (int)curr[0].info;
  std::swap(curr, prev);

  size_t mem_start = mems.size();
  for (i = x - 1; i >= -1; --i) {  // backward search for MEMs
    c = i < 0 ? 0 : q[i];
    curr.clear();
    for (size_t j = 0; j < prev.size(); ++j) {
      if (j + 1 < prev.size()) e.prefetch(prev[j + 1].kb);
      Intv& p = prev[j];
      extend6(e, p, true, ok);
      bool fl_match = ok[0].sz && p.kf < e.n_seqs;
      bool cont = self_match ? (ok[c].sz > 1) : (ok[c].sz != 0);
      if (!cont || fl_match || i == -1) {
        if (curr.empty() || fl_match) {
          bool not_contained =
              fl_match || mems.size() == mem_start ||
              (uint64_t)(i + 1) < (uint64_t)mems.back().start;
          if (not_contained) {
            Mem m;
            m.start = i + 1;
            m.end = (int32_t)(uint32_t)p.info;
            m.sz = p.sz;
            m.kf = p.kf;
            m.closed = ok[0].sz != 0;
            mems.push_back(m);
          }
        }
      }
      if (cont && (p.kf < e.n_seqs || curr.empty() ||
                   ok[c].sz != curr.back().sz)) {
        ok[c].info = p.info;
        curr.push_back(ok[c]);
      }
    }
    if (curr.empty()) break;
    std::swap(curr, prev);
  }
  std::reverse(mems.begin() + mem_start, mems.end());
  return ret;
}

}  // namespace

extern "C" {

// All SMEMs of many queries. Queries are concatenated nt6 bytes with
// int64 offsets[n+1]. Output: per-query match counts (int64[n]) written to
// counts_out; match fields returned via a single malloc'd int64 buffer
// [total, 5] (start, end, size, closed, kf), caller frees with fsmem_free.
static int64_t* fsmem_all_impl(const Index& e, const uint8_t* queries,
                               const int64_t* offsets, int64_t n_queries,
                               int self_match, int64_t* counts_out,
                               int64_t* total_out) {
  // queries are independent: dynamic work-stealing over threads (contigs
  // vary wildly in length), results stitched back in query order
  unsigned hw = std::thread::hardware_concurrency();
  int T = (int)std::min<int64_t>(hw ? hw : 1, (n_queries + 7) / 8);
  if (T < 1) T = 1;
  std::vector<std::vector<Mem>> per_q((size_t)n_queries);
  std::atomic<int64_t> next{0};
  auto work = [&] {
    std::vector<Intv> prev, curr;
    std::vector<Mem> mems;
    while (true) {
      int64_t qi = next.fetch_add(1, std::memory_order_relaxed);
      if (qi >= n_queries) break;
      const uint8_t* q = queries + offsets[qi];
      int len = (int)(offsets[qi + 1] - offsets[qi]);
      mems.clear();
      int x = 0;
      while (x < len) {
        prev.clear();
        curr.clear();
        int nx = smem1_core(e, len, q, x, mems, self_match != 0, prev, curr);
        x = nx > x ? nx : x + 1;
      }
      counts_out[qi] = (int64_t)mems.size();
      per_q[qi] = mems;
    }
  };
  if (T == 1) {
    work();
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(work);
    for (auto& x : th) x.join();
  }
  int64_t total = 0;
  for (auto& v : per_q) total += (int64_t)v.size();
  *total_out = total;
  int64_t* out = (int64_t*)malloc(sizeof(int64_t) * 5 * (total + 1));
  if (!out) return nullptr;
  size_t i = 0;
  for (auto& v : per_q)
    for (auto& m : v) {
      out[i * 5 + 0] = m.start;
      out[i * 5 + 1] = m.end;
      out[i * 5 + 2] = m.sz;
      out[i * 5 + 3] = m.closed;
      out[i * 5 + 4] = m.kf;
      ++i;
    }
  return out;
}

int64_t* fsmem_all(const uint8_t* blocks, const int64_t* occ, int64_t n_rows,
                   const int64_t* cnt, int64_t n_seqs, const uint8_t* queries,
                   const int64_t* offsets, int64_t n_queries, int self_match,
                   int64_t* counts_out, int64_t* total_out) {
  Index e;
  e.setup(blocks, occ, n_rows, cnt, n_seqs);
  return fsmem_all_impl(e, queries, offsets, n_queries, self_match,
                        counts_out, total_out);
}

void fsmem_free(void* p) { free(p); }

}  // extern "C"
