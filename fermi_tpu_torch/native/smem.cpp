// smem.cpp — native SMEM engine for long queries (contigs).
//
// Sequential fm6_smem1_core / fm6_smem (reference smem.c:13-80, 397-411;
// same semantics as the batched device loop in search/smem.py). The device
// loop pads per-read interval sets to a fixed width, which is ruinous for
// contig-scale queries whose sets reach hundreds; this engine pays only the
// true set sizes. Shares the blocked-occ index layout with unitig.cpp.
//
// The port's copy of fermi_tpu/native/smem.cpp: the SMEM engine over
// resident arrays (fsmem_all) or a mmapped .fmd.blk record cache
// (fsmem_all_blk, the `-M` path), and the error-correction collect walk
// (fec_collect, fec_collect_blk).  Without oom.h: a failed allocation or
// open returns null, which the caller raises on.

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

// Null when memory runs out (total_out >= 0) or, for the _blk form, the
// record cache cannot be mapped (total_out = -1).
int64_t* fsmem_all(const uint8_t* blocks, const int64_t* occ, int64_t n_rows,
                   const int64_t* cnt, int64_t n_seqs, const uint8_t* queries,
                   const int64_t* offsets, int64_t n_queries, int self_match,
                   int64_t* counts_out, int64_t* total_out) {
  Index e;
  *total_out = 0;
  if (e.setup(blocks, occ, n_rows, cnt, n_seqs)) return nullptr;
  return fsmem_all_impl(e, queries, offsets, n_queries, self_match,
                        counts_out, total_out);
}

// out-of-core variant over an mmapped .fmd.blk cache (`-M`)
int64_t* fsmem_all_blk(const char* blk_path, const uint8_t* queries,
                       const int64_t* offsets, int64_t n_queries,
                       int self_match, int64_t* counts_out,
                       int64_t* total_out) {
  Index e;
  if (e.setup_blk(blk_path)) {
    *total_out = -1;
    return nullptr;
  }
  return fsmem_all_impl(e, queries, offsets, n_queries, self_match,
                        counts_out, total_out);
}

void fsmem_free(void* p) { free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// ec_collect: solid-kmer collection (reference correct.c:35-87) walked on
// the host directly over the blocked-occ records, for an index that is not
// on a device (the `-M` path).
// ---------------------------------------------------------------------------

namespace {

// BFS node: a d-mer's bi-interval plus its accumulated class/key bits
struct CNode {
  int64_t kb, kf, sz;
  int64_t cls;
  uint32_t key;
};

struct CollectNode {
  Intv ik;
  int depth;
  uint32_t key;
};

struct SufNode {
  Intv ik;
  int depth;
  int64_t cls;
};

// phase 2 DFS from one suffix class; appends triples to out
static void collect_class(const Index& e, const SufNode& n, int suf_len, int w,
                          int min_occ, std::vector<int64_t>& out,
                          int64_t& cnt_total, int64_t& cnt_info,
                          std::vector<CollectNode>& stack) {
  Intv ok[6];
  stack.clear();
  stack.push_back({n.ik, suf_len, 0});
  while (!stack.empty()) {
    CollectNode t = stack.back();
    stack.pop_back();
    extend6(e, t.ik, true, ok);
    if (t.depth == w) {
      int64_t mx = 0;
      int max_c = 6;
      for (int c = 1; c <= 4; ++c)
        if (ok[c].sz > mx) {
          mx = ok[c].sz;
          max_c = c;
        }
      if (mx < min_occ) continue;
      ++cnt_total;
      int64_t rest = t.ik.sz - mx - ok[0].sz - ok[5].sz;
      double r = rest == 0 ? (double)mx : (double)mx / (double)rest;
      if (r > 31.0) r = 31.0;
      if (rest <= 7 && r >= (double)min_occ) ++cnt_info;
      uint32_t key = t.key << 2 | (uint32_t)(max_c - 1);
      uint8_t val = (uint8_t)(((int)(r + .499)) << 3 |
                              (rest < 7 ? (int)rest : 7));
      out.push_back(n.cls);
      out.push_back((int64_t)key);
      out.push_back((int64_t)val);
    } else {
      for (int c = 1; c <= 4; ++c) {
        if (ok[c].sz >= min_occ) {
          uint32_t key =
              t.key | ((uint32_t)(c - 1) << (2 * (t.depth - suf_len)));
          e.prefetch(ok[c].kb);  // lines are warm by LIFO pop time
          stack.push_back({ok[c], t.depth + 1, key});
        }
      }
    }
  }
}


// small-index collect: per-suffix-class DFS across threads (lower constant
// factors than the level BFS when the whole index sits in cache)
static int64_t* fec_collect_dfs(const Index& e, int w, int min_occ,
                                int n_threads, int64_t* counts_out) {
  int suf_len = w > 15 ? w - 15 : 1;
  std::vector<SufNode> classes;
  std::vector<SufNode> sstack;
  sstack.push_back({{0, 0, e.cnt[6], 0}, 0, 0});
  Intv ok[6];
  while (!sstack.empty()) {
    SufNode n = sstack.back();
    sstack.pop_back();
    if (n.depth == suf_len) {
      classes.push_back(n);
      continue;
    }
    extend6(e, n.ik, true, ok);
    for (int c = 1; c <= 4; ++c) {
      if (ok[c].sz) {
        int64_t cls = n.cls | ((int64_t)(c - 1) << (2 * n.depth));
        sstack.push_back({ok[c], n.depth + 1, cls});
      }
    }
  }
  std::vector<std::vector<int64_t>> outs(n_threads);
  std::vector<int64_t> totals(n_threads, 0), infos(n_threads, 0);
  std::atomic<size_t> next(0);
  std::atomic<bool> oom(false);
  auto work = [&](int tid) {
    std::vector<CollectNode> stack;
    try {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= classes.size()) break;
        collect_class(e, classes[i], suf_len, w, min_occ, outs[tid],
                      totals[tid], infos[tid], stack);
      }
    } catch (const std::bad_alloc&) {
      oom = true;
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < n_threads; ++t) th.emplace_back(work, t);
    for (auto& t : th) t.join();
  }
  if (oom) return nullptr;
  size_t n_words = 0;
  int64_t cnt_total = 0, cnt_info = 0;
  for (int t = 0; t < n_threads; ++t) {
    n_words += outs[t].size();
    cnt_total += totals[t];
    cnt_info += infos[t];
  }
  counts_out[0] = (int64_t)(n_words / 3);
  counts_out[1] = cnt_total;
  counts_out[2] = cnt_info;
  int64_t* p = (int64_t*)malloc(sizeof(int64_t) * (n_words + 1));
  if (!p) return nullptr;
  size_t at = 0;
  for (int t = 0; t < n_threads; ++t) {
    memcpy(p + at, outs[t].data(), sizeof(int64_t) * outs[t].size());
    at += outs[t].size();
  }
  return p;
}

}  // namespace

extern "C" {

// Emits (cls:int64, key:uint32, val:uint8) triples for all solid (k+1)-mers
// (reference correct.c:35-87 semantics). Returns a malloc'd buffer of n_out
// records laid out as int64[3] each (cls, key, val); counts_out[0]=n_out,
// counts_out[1]=cnt_total, counts_out[2]=cnt_informative.
//
// The reference DFSes per suffix class across pthreads; here the trie is
// walked level-synchronously with the frontier kept sorted by kb, so the
// rank queries of a whole level stream through the index in ascending
// position order (children of in-order parents are emitted per-symbol and
// concatenated in symbol order, which preserves kb order because symbol c
// children live in the disjoint range [cnt[c], cnt[c+1])). Cache locality,
// not parallelism, is what this buys — each level is also split across
// n_threads. Triple order is unspecified; consumers treat it as a set.
static int64_t* fec_collect_impl(const Index& e, int w, int min_occ,
                                 int n_threads, int64_t* counts_out) {
  if (n_threads < 1) n_threads = 1;
  // small indexes fit in cache: the per-class DFS has lower constant
  // factors there; the kb-sorted level BFS wins once rank queries miss DRAM
  if (e.cnt[6] < (int64_t)48 * 1000 * 1000)
    return fec_collect_dfs(e, w, min_occ, n_threads, counts_out);
  int suf_len = w > 15 ? w - 15 : 1;
  const int T = n_threads;

  std::vector<CNode> frontier;
  frontier.push_back({0, 0, e.cnt[6], 0, 0});
  std::vector<std::vector<CNode>> child_lists(T * 4);
  std::vector<std::vector<int64_t>> outs(T);
  std::vector<int64_t> totals(T, 0), infos(T, 0);

  std::atomic<bool> oom(false);
  for (int depth = 0; depth <= w && !frontier.empty(); ++depth) {
    const bool at_w = depth == w;
    const int64_t m = (int64_t)frontier.size();
    std::vector<int64_t> split(T + 1);
    for (int t = 0; t <= T; ++t) split[t] = m * t / T;
    auto body = [&](int t) {
      Intv ok[6];
      std::vector<CNode>* mine = &child_lists[t * 4];
      for (int c = 0; c < 4; ++c) mine[c].clear();
      for (int64_t i = split[t]; i < split[t + 1]; ++i) {
        if (i + 8 < split[t + 1]) {
          // rank positions ascend within the frontier, but each block row
          // is still a fresh DRAM line at large index sizes — prefetch a
          // few nodes ahead (block row, occ row, and the interval end)
          const CNode& f = frontier[i + 8];
          e.prefetch(f.kb);
          e.prefetch(f.kb + f.sz);
        }
        const CNode& nd = frontier[i];
        Intv ik{nd.kb, nd.kf, nd.sz, 0};
        extend6(e, ik, true, ok);
        if (at_w) {
          int64_t mx = 0;
          int max_c = 6;
          for (int c = 1; c <= 4; ++c)
            if (ok[c].sz > mx) {
              mx = ok[c].sz;
              max_c = c;
            }
          if (mx < min_occ) continue;
          ++totals[t];
          int64_t rest = nd.sz - mx - ok[0].sz - ok[5].sz;
          double r = rest == 0 ? (double)mx : (double)mx / (double)rest;
          if (r > 31.0) r = 31.0;
          if (rest <= 7 && r >= (double)min_occ) ++infos[t];
          uint32_t key = nd.key << 2 | (uint32_t)(max_c - 1);
          uint8_t val = (uint8_t)(((int)(r + .499)) << 3 |
                                  (rest < 7 ? (int)rest : 7));
          outs[t].push_back(nd.cls);
          outs[t].push_back((int64_t)key);
          outs[t].push_back((int64_t)val);
          continue;
        }
        for (int c = 1; c <= 4; ++c) {
          if (depth < suf_len ? (ok[c].sz > 0) : (ok[c].sz >= min_occ)) {
            int64_t cls = nd.cls;
            uint32_t key = nd.key;
            if (depth < suf_len)
              cls |= (int64_t)(c - 1) << (2 * depth);
            else
              key |= (uint32_t)(c - 1) << (2 * (depth - suf_len));
            mine[c - 1].push_back({ok[c].kb, ok[c].kf, ok[c].sz, cls, key});
          }
        }
      }
    };
    auto work = [&](int t) {
      try {
        body(t);
      } catch (const std::bad_alloc&) {
        oom = true;
      }
    };
    if (T == 1) {
      work(0);
    } else {
      std::vector<std::thread> th;
      for (int t = 0; t < T; ++t) th.emplace_back(work, t);
      for (auto& t : th) t.join();
    }
    if (oom) return nullptr;
    if (at_w) break;
    // concat in (symbol, thread) order -> next frontier sorted by kb
    size_t total = 0;
    for (int c = 0; c < 4; ++c)
      for (int t = 0; t < T; ++t) total += child_lists[t * 4 + c].size();
    frontier.clear();
    frontier.reserve(total);
    for (int c = 0; c < 4; ++c)
      for (int t = 0; t < T; ++t) {
        auto& v = child_lists[t * 4 + c];
        frontier.insert(frontier.end(), v.begin(), v.end());
      }
  }

  size_t n_words = 0;
  int64_t cnt_total = 0, cnt_info = 0;
  for (int t = 0; t < T; ++t) {
    n_words += outs[t].size();
    cnt_total += totals[t];
    cnt_info += infos[t];
  }
  counts_out[0] = (int64_t)(n_words / 3);
  counts_out[1] = cnt_total;
  counts_out[2] = cnt_info;
  int64_t* p = (int64_t*)malloc(sizeof(int64_t) * (n_words + 1));
  if (!p) return nullptr;
  size_t at = 0;
  for (int t = 0; t < T; ++t) {
    memcpy(p + at, outs[t].data(), sizeof(int64_t) * outs[t].size());
    at += outs[t].size();
  }
  return p;
}

// Null when memory runs out (counts_out[0] = -2) or, for the _blk form, the
// record cache cannot be mapped (counts_out[0] = -1).
static int64_t* fec_collect_checked(const Index& e, int w, int min_occ,
                                    int n_threads, int64_t* counts_out) {
  int64_t* p = nullptr;
  try {
    p = fec_collect_impl(e, w, min_occ, n_threads, counts_out);
  } catch (const std::bad_alloc&) {
  }
  if (!p) counts_out[0] = -2;
  return p;
}

int64_t* fec_collect(const uint8_t* blocks, const int64_t* occ, int64_t n_rows,
                     const int64_t* cnt, int64_t n_seqs, int w, int min_occ,
                     int n_threads, int64_t* counts_out) {
  Index e;
  if (e.setup(blocks, occ, n_rows, cnt, n_seqs)) {
    counts_out[0] = -2;
    return nullptr;
  }
  return fec_collect_checked(e, w, min_occ, n_threads, counts_out);
}

// out-of-core variant over an mmapped .fmd.blk cache (`-M`)
int64_t* fec_collect_blk(const char* blk_path, int w, int min_occ,
                         int n_threads, int64_t* counts_out) {
  Index e;
  if (e.setup_blk(blk_path)) {
    counts_out[0] = -1;
    return nullptr;
  }
  return fec_collect_checked(e, w, min_occ, n_threads, counts_out);
}

}  // extern "C"
