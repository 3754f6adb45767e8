// unitig.cpp — native unitig construction: the host walk and the stitch of
// the bulk-link path.
//
// The port's own copy of fermi_tpu/native/unitig.cpp: standard library and
// this package's fmindex.h only; it builds with `g++ -O2 -shared -fPIC`
// (see native/__init__.py).  A failed allocation or an index that cannot be
// mapped returns null, which the caller raises on.
//
// funitig_run / funitig_run_blk: the whole walk on the host, over resident
// arrays or a mmapped .fmd.blk record cache (the `-M` path), with the same
// control flow as reference unitig.c (fm6_get_nei:93-179,
// unitig_unidir:227-262, unitig1:274-317).  One thread gives the MAG text
// of `fermi unitig -t 1`; N threads the reference's `-t N` semantics
// (stride workers over shared atomic bitmaps, unitig.c:378-407).
//
// funitig_stitch: pass 2 of the bulk-link reformulation
// (algos/unitig_bulk.py) replays unitig1 / unitig_unidir in exact t=1 seed
// order over per-sequence link records computed on the device
// (search/unitig_links.py).  Index queries remain only for check_left
// verification, redo-flagged rows (device buffer overflow) and the rare
// member-miss fallback, all served by the Builder's exact get_nei, so those
// paths are byte-exact by construction.  The MAG text equals
// `fermi unitig -t 1`.

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include "fmindex.h"

namespace {

using fermi_native::comp6;
using fermi_native::Index;
using fermi_native::kBlockBits;

struct Intv {
  int64_t kb, kf, sz;
  uint64_t info;
};

// fm6_extend over one interval, all 6 symbols
static void extend6(const Index& e, int64_t kb, int64_t kf, int64_t sz,
                    bool is_back, int64_t KB[6], int64_t KF[6],
                    int64_t SZ[6]) {
  int64_t primary = is_back ? kb : kf;
  int64_t tk[6], tl[6];
  e.rank6_pair(primary, primary + sz, tk, tl);
  int64_t osz[6];
  for (int c = 0; c < 6; ++c) {
    osz[c] = tl[c] - tk[c];
  }
  int64_t outp[6];
  for (int c = 0; c < 6; ++c) outp[c] = e.cnt[c] + tk[c];
  int64_t other[6];
  int64_t base = is_back ? kf : kb;
  other[0] = base;
  other[4] = other[0] + osz[0];
  other[3] = other[4] + osz[4];
  other[2] = other[3] + osz[3];
  other[1] = other[2] + osz[2];
  other[5] = other[1] + osz[1];
  for (int c = 0; c < 6; ++c) {
    SZ[c] = osz[c];
    if (is_back) {
      KB[c] = outp[c];
      KF[c] = other[c];
    } else {
      KB[c] = other[c];
      KF[c] = outp[c];
    }
  }
}

struct Ext6 {
  int64_t KB[6], KF[6], SZ[6];
};

// used/bend/visited bitmap policies: one byte per stored sequence.  The
// sequential walk and the stitch own plain byte arrays; the workers of the
// threaded walk share one set of relaxed-atomic arrays.
struct PlainBits {
  std::vector<uint8_t> used_, bend_, visited_;
  void init(int64_t n) {
    used_.assign(n, 0);
    bend_.assign(n, 0);
    visited_.assign(n, 0);
  }
  inline bool used_at(int64_t i) const { return used_[i]; }
  inline void set_used(int64_t i) { used_[i] = 1; }
  inline bool bend_at(int64_t i) const { return bend_[i]; }
  inline void set_bend(int64_t i) { bend_[i] = 1; }
  inline bool visited_at(int64_t i) const { return visited_[i]; }
  inline void set_visited(int64_t i) { visited_[i] = 1; }
  inline bool test_and_set_visited(int64_t i) {
    bool o = visited_[i];
    visited_[i] = 1;
    return o;
  }
};

struct SharedAtomicBits {
  std::atomic<uint8_t>* used_ = nullptr;  // non-owning, shared by helpers
  std::atomic<uint8_t>* bend_ = nullptr;
  std::atomic<uint8_t>* visited_ = nullptr;
  void init(int64_t) {}
  inline bool used_at(int64_t i) const {
    return used_[i].load(std::memory_order_relaxed);
  }
  inline void set_used(int64_t i) {
    used_[i].store(1, std::memory_order_relaxed);
  }
  inline bool bend_at(int64_t i) const {
    return bend_[i].load(std::memory_order_relaxed);
  }
  inline void set_bend(int64_t i) {
    bend_[i].store(1, std::memory_order_relaxed);
  }
  inline bool visited_at(int64_t i) const {
    return visited_[i].load(std::memory_order_relaxed);
  }
  inline void set_visited(int64_t i) {
    visited_[i].store(1, std::memory_order_relaxed);
  }
  // atomic test-and-set for the threaded walk's dedupe (the reference's
  // __sync_fetch_and_or on `visited`, unitig.c:336-339)
  inline bool test_and_set_visited(int64_t i) {
    return visited_[i].exchange(1, std::memory_order_relaxed);
  }
};

template <class Bits>
struct Builder {
  const Index& e;
  int min_match;
  const uint64_t* sorted;  // may be null
  Bits bits;
  std::string out;
  // per-round scratch of get_nei (reused to avoid alloc churn)
  std::vector<Ext6> exA, exB;
  std::vector<uint8_t> hasA, hasB;
  std::vector<int64_t> cs0;  // [j*4 + (c-1)]: sentinel count after bwd ext

  Builder(const Index& idx, int mm, const uint64_t* srt, Bits b = Bits())
      : e(idx), min_match(mm), sorted(srt), bits(b) {
    bits.init(e.n_seqs);
  }

  // hint the lines extend6(kb_or_kf, sz) will touch (both rank positions)
  inline void pf2(int64_t a, int64_t sz) const {
    e.prefetch(a);
    int64_t b = a + sz;
    if ((b >> kBlockBits) != (a >> kBlockBits)) e.prefetch(b);
  }

  void set_bits(int64_t kb, int64_t kf, int64_t sz) {
    if (sorted) {
      for (int64_t i = 0; i < sz; ++i) {
        bits.set_used(sorted[kb + i] >> 2);
        bits.set_used(sorted[kf + i] >> 2);
      }
    } else {
      for (int64_t i = 0; i < sz; ++i) {
        bits.set_used(kb + i);
        bits.set_used(kf + i);
      }
    }
  }

  // overlap_intv (unitig.c:38-64)
  Intv overlap_intv(const std::vector<uint8_t>& seq, int j, bool at5,
                    bool inc_sentinel, std::vector<Intv>& out_list) {
    out_list.clear();
    int l = (int)seq.size();
    int dlt = at5 ? 1 : -1;
    int end = at5 ? l : -1;
    int c = seq[j];
    Intv ik{e.cnt[c], e.cnt[comp6(c)], e.cnt[c + 1] - e.cnt[c], 0};
    int depth = 1;
    j += dlt;
    while (j != end) {
      c = at5 ? comp6(seq[j]) : seq[j];
      int64_t KB[6], KF[6], SZ[6];
      extend6(e, ik.kb, ik.kf, ik.sz, !at5, KB, KF, SZ);
      if (SZ[c] == 0) break;
      if (depth >= min_match && SZ[0]) {
        if (inc_sentinel)
          out_list.push_back({KB[0], KF[0], SZ[0], (uint64_t)(j - dlt)});
        else
          out_list.push_back({ik.kb, ik.kf, ik.sz, (uint64_t)(j - dlt)});
      }
      ik = {KB[c], KF[c], SZ[c], 0};
      j += dlt;
      ++depth;
    }
    std::reverse(out_list.begin(), out_list.end());
    return ik;
  }

  // fm6_is_contained (unitig.c:77-91)
  int is_contained(const std::vector<uint8_t>& s, Intv* intv0,
                   std::vector<Intv>& ovlp) {
    assert((int)s.size() > min_match);
    Intv ik = overlap_intv(s, (int)s.size() - 1, false, false, ovlp);
    int ret = 0;
    int64_t KB[6], KF[6], SZ[6];
    extend6(e, ik.kb, ik.kf, ik.sz, true, KB, KF, SZ);
    assert(SZ[0]);
    if (ik.sz != SZ[0]) ret = -1;
    Intv ik2{KB[0], KF[0], SZ[0], 0};
    extend6(e, ik2.kb, ik2.kf, ik2.sz, false, KB, KF, SZ);
    assert(SZ[0]);
    if (ik2.sz != SZ[0]) ret = -1;
    *intv0 = {KB[0], KF[0], SZ[0], 0};
    return ret;
  }

  // fm6_get_nei (unitig.c:93-179); s may grow
  int get_nei(int beg, std::vector<uint8_t>& s, std::vector<Intv>& nei,
              std::vector<Intv>& prev) {
    int ori_l = (int)s.size();
    nei.clear();
    bool is_forked = false;
    if (prev.empty()) {
      std::vector<uint8_t> sub(s.begin() + beg, s.end());
      overlap_intv(sub, (int)sub.size() - 1, false, false, prev);
      if (prev.empty()) return -1;
      for (auto& p : prev) p.info += beg;
    }
    std::vector<int> cat(prev.size(), 0);
    std::vector<Intv> curr;
    while (!prev.empty()) {
      curr.clear();
      size_t J = prev.size();
      // The extend6 calls of one lockstep round are pure and independent
      // within the round: batch them in chunked prefetch->compute passes
      // (A: the forward extends; B/C: the backward sentinel tests they
      // feed), then replay the reference's control flow over the
      // precomputed values.  Entries whose category is eliminated
      // mid-round compute a few extends for nothing.
      constexpr size_t CH = 24;
      exA.resize(J);
      exB.resize(J);
      hasA.assign(J, 0);
      hasB.assign(J, 0);
      cs0.assign(J * 4, 0);
      const bool grew = ori_l != (int)s.size();
      for (size_t j0 = 0; j0 < J; j0 += CH) {
        size_t j1 = j0 + CH < J ? j0 + CH : J;
        for (size_t j = j0; j < j1; ++j)
          if (cat[j] >= 0) pf2(prev[j].kf, prev[j].sz);
        for (size_t j = j0; j < j1; ++j) {
          if (cat[j] < 0) continue;
          extend6(e, prev[j].kb, prev[j].kf, prev[j].sz, false,
                  exA[j].KB, exA[j].KF, exA[j].SZ);
          hasA[j] = 1;
        }
      }
      for (size_t j0 = 0; j0 < J; j0 += CH) {
        size_t j1 = j0 + CH < J ? j0 + CH : J;
        for (size_t j = j0; j < j1; ++j) {
          if (!hasA[j]) continue;
          const Ext6& a = exA[j];
          if (a.SZ[0] && grew) pf2(a.KB[0], a.SZ[0]);
          for (int c = 1; c < 5; ++c)
            if (a.SZ[c]) pf2(a.KB[c], a.SZ[c]);
        }
        for (size_t j = j0; j < j1; ++j) {
          if (!hasA[j]) continue;
          const Ext6& a = exA[j];
          if (a.SZ[0] && grew) {
            extend6(e, a.KB[0], a.KF[0], a.SZ[0], true, exB[j].KB,
                    exB[j].KF, exB[j].SZ);
            hasB[j] = 1;
          }
          for (int c = 1; c < 5; ++c) {
            if (a.SZ[c]) {
              int64_t BK[6], BF[6], BS[6];
              extend6(e, a.KB[c], a.KF[c], a.SZ[c], true, BK, BF, BS);
              cs0[j * 4 + (c - 1)] = BS[0];
            }
          }
        }
      }
      // consume pass: the reference control flow (unitig.c:110-155)
      for (size_t j = 0; j < J; ++j) {
        if (cat[j] < 0) continue;
        Intv& p = prev[j];
        const int64_t* KB = exA[j].KB;
        const int64_t* KF = exA[j].KF;
        const int64_t* SZ = exA[j].SZ;
        if (SZ[0] && grew) {
          const int64_t* BK = exB[j].KB;
          const int64_t* BF = exB[j].KF;
          const int64_t* BS = exB[j].SZ;
          if (BS[0]) {
            if (SZ[0] == p.sz && p.sz == BS[0]) {
              int cat0 = cat[j];
              uint64_t info = (uint64_t)(ori_l - (int64_t)(p.info & 0xffffffffULL));
              size_t i = j;
              while (i < J && cat[i] == cat0) {
                cat[i] = -1;
                ++i;
              }
              nei.push_back({BK[0], BF[0], BS[0], info});
              continue;
            } else {
              set_bits(BK[0], BF[0], BS[0]);
            }
          }
        }
        if (cat[j] < 0) continue;
        for (int c = 1; c < 5; ++c) {
          if (SZ[c]) {
            if (cs0[j * 4 + (c - 1)]) {
              uint64_t info =
                  (p.info & 0xFFFFFFF0FFFFFFFFULL) | ((uint64_t)c << 32);
              curr.push_back({KB[c], KF[c], SZ[c], info});
            }
          }
        }
      }
      if (!curr.empty()) {
        int c = (int)(curr[0].info >> 32 & 0xf);
        s.push_back((uint8_t)comp6(c));
        std::stable_sort(curr.begin(), curr.end(),
                         [](const Intv& a, const Intv& b) {
                           return a.info < b.info;
                         });
        uint64_t last = curr[0].info >> 32;
        cat.assign(curr.size(), 0);
        curr[0].info &= 0xffffffffULL;
        int cat0 = 0;
        for (size_t j = 1; j < curr.size(); ++j) {
          if (curr[j].info >> 32 != last) {
            last = curr[j].info >> 32;
            cat0 = (int)j;
          }
          cat[j] = cat0;
          curr[j].info = (curr[j].info & 0xffffffffULL) | ((uint64_t)cat0 << 36);
        }
        if (cat0 != 0) is_forked = true;
      }
      prev = curr;
    }
    if (nei.empty()) return -1;
    int rbeg = ori_l - (int)(uint32_t)nei[0].info;
    if (nei.size() == 1 && is_forked) {
      // contained-read artifact fixup (unitig.c:158-176);
      // fm6_set_intv(e, 0): x[0]=cnt[0], x[1]=cnt[comp(0)=0], sz=cnt[1]-cnt[0]
      Intv ok0{e.cnt[0], e.cnt[comp6(0)], e.cnt[1] - e.cnt[0], 0};
      for (int i = rbeg; i < ori_l; ++i) {
        int64_t KB[6], KF[6], SZ[6];
        extend6(e, ok0.kb, ok0.kf, ok0.sz, false, KB, KF, SZ);
        int c = comp6(s[i]);
        ok0 = {KB[c], KF[c], SZ[c], 0};
      }
      size_t i = ori_l;
      while (i < s.size()) {
        int64_t KB[6], KF[6], SZ[6];
        extend6(e, ok0.kb, ok0.kf, ok0.sz, false, KB, KF, SZ);
        int c0 = -1, nhit = 0;
        for (int c = 1; c < 5; ++c) {
          if (SZ[c] && KB[c] <= nei[0].kb &&
              KB[c] + SZ[c] >= nei[0].kb + nei[0].sz) {
            ++nhit;
            c0 = c;
          }
        }
        if (nhit == 0 && SZ[0]) break;
        assert(nhit == 1);
        s[i] = (uint8_t)comp6(c0);
        ok0 = {KB[c0], KF[c0], SZ[c0], 0};
        ++i;
      }
      s.resize(i);
    }
    if (nei.size() > 1) s.resize(ori_l);
    return rbeg;
  }

  // check_left_simple (unitig.c:186-204); the per-step extends are
  // independent: prefetch the whole round before computing it
  int check_left_simple(int beg, int rbeg, const std::vector<uint8_t>& s) {
    std::vector<Intv> prev, curr;
    overlap_intv(s, rbeg, true, true, prev);
    for (int i = rbeg - 1; i >= beg; --i) {
      if (prev.empty()) break;
      curr.clear();
      for (auto& p : prev) pf2(p.kb, p.sz);
      for (auto& p : prev) {
        int64_t KB[6], KF[6], SZ[6];
        extend6(e, p.kb, p.kf, p.sz, true, KB, KF, SZ);
        if (SZ[0]) set_bits(KB[0], KF[0], SZ[0]);
        if (SZ[0] + SZ[s[i]] != p.sz) return -1;
        curr.push_back({KB[s[i]], KF[s[i]], SZ[s[i]], p.info});
      }
      prev = curr;
    }
    return 0;
  }

  int check_left(int beg, int rbeg, const std::vector<uint8_t>& s,
                 const std::vector<Intv>& nei) {
    assert(nei.size() == 1);
    if (check_left_simple(beg, rbeg, s) == 0) return 0;
    std::vector<uint8_t> rc;
    for (int i = (int)s.size() - 1; i >= rbeg; --i)
      rc.push_back((uint8_t)comp6(s[i]));
    std::vector<Intv> nei2, prev;
    get_nei(0, rc, nei2, prev);
    assert(nei2.size() >= 1);
    return nei2.size() > 1 ? -1 : 0;
  }

  // unitig_unidir (unitig.c:227-262)
  int unidir(std::vector<uint8_t>& s, std::vector<uint8_t>& cov, int beg0,
             int64_t k0, int64_t* end, bool* is_loop, std::vector<Intv>& nei,
             std::vector<Intv> prev) {
    int beg = beg0, ori_l = (int)s.size(), n_reads = 0;
    *is_loop = false;
    nei.clear();
    while (true) {
      int rbeg = get_nei(beg, s, nei, prev);
      prev.clear();
      if (rbeg < 0) break;
      if (nei.size() > 1) {
        bits.set_bend(*end);
        break;
      }
      int64_t k = nei[0].kb;
      if (k == *end) break;
      if (bits.bend_at(k) || check_left(beg, rbeg, s, nei) < 0) {
        bits.set_bend(k);
        break;
      }
      if (k == k0) {
        *is_loop = true;
        break;
      }
      if (nei[0].kf == *end) {
        nei.clear();
        break;
      }
      *end = nei[0].kf;
      set_bits(nei[0].kb, nei[0].kf, nei[0].sz);
      ++n_reads;
      while (cov.size() < s.size()) cov.push_back('"');
      cov.resize(s.size());
      for (int i = rbeg; i < ori_l; ++i)
        if (cov[i] != '~') ++cov[i];
      for (size_t i = ori_l; i < s.size(); ++i) cov[i] = '"';
      beg = rbeg;
      ori_l = (int)s.size();
    }
    s.resize(ori_l);
    cov.resize(ori_l);
    return n_reads;
  }

  void retrieve(int64_t x, std::vector<uint8_t>* s, int64_t* final_k) {
    int64_t k = x;
    s->clear();
    while (true) {
      int64_t r[6];
      e.rank6(k, r);
      int c = e.sym_at(k);
      k = e.cnt[c] + r[c];
      if (c == 0) break;
      s->push_back((uint8_t)c);
    }
    std::reverse(s->begin(), s->end());
    *final_k = k;
  }

  // unitig1 (unitig.c:274-317); returns false on skip
  bool unitig1(int64_t seed, std::vector<uint8_t>& s, std::vector<uint8_t>& cov,
               int64_t k_out[2], std::vector<Intv> nei_out[2], int* nsr) {
    if (sorted && bits.used_at(seed)) return false;
    int64_t k;
    retrieve(seed, &s, &k);
    int seed_len = (int)s.size();
    if ((int)s.size() <= min_match) return false;
    if (!sorted && bits.used_at(k)) return false;
    Intv intv0;
    std::vector<Intv> ovlp;
    int ret = is_contained(s, &intv0, ovlp);
    set_bits(intv0.kb, intv0.kf, intv0.sz);
    if (ret < 0) return false;
    *nsr = 1;
    cov.assign(s.size(), '"');
    k_out[0] = intv0.kf;
    k_out[1] = intv0.kb;
    nei_out[0].clear();
    nei_out[1].clear();
    std::vector<Intv> nei;
    if (!ovlp.empty()) {
      bool is_loop;
      int nr = unidir(s, cov, 0, intv0.kb, &k_out[0], &is_loop, nei, ovlp);
      *nsr += nr;
      nei_out[0] = nei;
      if (is_loop) {
        nei_out[1].clear();
        nei_out[1].push_back({k_out[0], 0, 0, nei[0].info});
        return true;
      }
    }
    // reverse complement for the other direction
    std::reverse(s.begin(), s.end());
    for (auto& c : s) c = (uint8_t)comp6(c);
    std::reverse(cov.begin(), cov.end());
    bool is_loop;
    int nr = unidir(s, cov, (int)s.size() - seed_len, intv0.kf, &k_out[1],
                    &is_loop, nei, {});
    *nsr += nr;
    nei_out[1] = nei;
    return true;
  }

  // one MAG record (reference mag.c:149-174)
  void write_mag(const std::vector<uint8_t>& s, const std::vector<uint8_t>& cov,
                 const int64_t k_out[2], const std::vector<Intv> nei_out[2],
                 int nsr) {
    if (s.empty()) return;
    char buf[64];
    out += "@";
    snprintf(buf, sizeof(buf), "%lld:%lld\t%d", (long long)k_out[0],
             (long long)k_out[1], nsr);
    out += buf;
    for (int j = 0; j < 2; ++j) {
      out += "\t";
      if (nei_out[j].empty()) {
        out += ".";
      } else {
        for (auto& p : nei_out[j]) {
          snprintf(buf, sizeof(buf), "%lld,%d;", (long long)p.kb,
                   (int)(int32_t)(p.info & 0xffffffffULL));
          out += buf;
        }
      }
    }
    out += "\n";
    static const char* b6 = "?ACGT?";
    for (auto c : s) out += b6[c];
    out += "\n+\n";
    for (auto c : cov) out += (char)c;
    out += "\n";
  }

  // the reference's t=1 seed order (unitig.c:332-346)
  void run() {
    int64_t n1 = e.n_seqs;
    std::vector<uint8_t> s, cov;
    for (int64_t j = 0; j <= (n1 >> 2); ++j) {
      for (int64_t i = (j << 2) | 1; i < (j << 2) + 4 && i < n1; i += 2) {
        int64_t k_out[2];
        std::vector<Intv> nei_out[2];
        int nsr = 0;
        if (!unitig1(i, s, cov, k_out, nei_out, &nsr)) continue;
        if (bits.visited_at(k_out[0]) || bits.visited_at(k_out[1])) continue;
        bits.set_visited(k_out[0]);
        bits.set_visited(k_out[1]);
        write_mag(s, cov, k_out, nei_out, nsr);
      }
    }
  }

  // stride worker for the threaded mode (reference unitig_core seed order,
  // unitig.c:332-346); records the output length after every j block so
  // the caller can gather blocks in global j order.
  void run_strided(int64_t start, int64_t step, std::vector<size_t>* marks) {
    int64_t n1 = e.n_seqs;
    std::vector<uint8_t> s, cov;
    for (int64_t j = start; j <= (n1 >> 2); j += step) {
      for (int64_t i = (j << 2) | 1; i < (j << 2) + 4 && i < n1; i += 2) {
        int64_t k_out[2];
        std::vector<Intv> nei_out[2];
        int nsr = 0;
        if (!unitig1(i, s, cov, k_out, nei_out, &nsr)) continue;
        // the reference's fetch_or order (unitig.c:336-339)
        if (bits.test_and_set_visited(k_out[0])) continue;
        if (bits.test_and_set_visited(k_out[1])) continue;
        write_mag(s, cov, k_out, nei_out, nsr);
      }
      marks->push_back(out.size());
    }
  }
};

// Threaded walk matching the reference's `unitig -t N` semantics
// (unitig.c:378-407): stride workers share relaxed-atomic used/bend/visited
// bitmaps, so which unitig claims a boundary read under contention is
// timing-dependent, the same nondeterminism the reference accepts with
// threads.  Unlike the reference (workers fputs-interleave stdout), output
// blocks are gathered in deterministic global j order.  Null when memory
// runs out.
static char* unitig_threaded(const Index& idx, int min_match,
                             const uint64_t* sorted, int T,
                             int64_t* out_len) {
  int64_t n_seqs = idx.n_seqs;
  std::unique_ptr<std::atomic<uint8_t>[]> au(
      new (std::nothrow) std::atomic<uint8_t>[n_seqs]);
  std::unique_ptr<std::atomic<uint8_t>[]> ab(
      new (std::nothrow) std::atomic<uint8_t>[n_seqs]);
  std::unique_ptr<std::atomic<uint8_t>[]> av(
      new (std::nothrow) std::atomic<uint8_t>[n_seqs]);
  if (!au || !ab || !av) return nullptr;
  for (int64_t i = 0; i < n_seqs; ++i) {
    au[i].store(0, std::memory_order_relaxed);
    ab[i].store(0, std::memory_order_relaxed);
    av[i].store(0, std::memory_order_relaxed);
  }
  SharedAtomicBits sb{au.get(), ab.get(), av.get()};
  std::vector<std::unique_ptr<Builder<SharedAtomicBits>>> bs;
  for (int t = 0; t < T; ++t)
    bs.emplace_back(new Builder<SharedAtomicBits>(idx, min_match, sorted, sb));
  std::vector<std::vector<size_t>> marks(T);
  std::atomic<bool> oom(false);
  std::vector<std::thread> th;
  for (int t = 0; t < T; ++t)
    th.emplace_back([&, t] {
      try {
        bs[t]->run_strided(t, T, &marks[t]);
      } catch (const std::bad_alloc&) {
        oom = true;
      }
    });
  for (auto& x : th) x.join();
  if (oom) return nullptr;
  size_t total = 0;
  for (int t = 0; t < T; ++t) total += bs[t]->out.size();
  char* p = (char*)malloc(total + 1);
  if (!p) return nullptr;
  size_t at = 0;
  std::vector<size_t> seg(T, 0), from(T, 0);
  for (int64_t blk = 0;; ++blk) {
    int t = (int)(blk % T);
    size_t si = seg[t];
    if (si >= marks[t].size()) break;
    size_t end = marks[t][si];
    memcpy(p + at, bs[t]->out.data() + from[t], end - from[t]);
    at += end - from[t];
    from[t] = end;
    ++seg[t];
  }
  p[at] = 0;
  *out_len = (int64_t)at;
  return p;
}

// the exact sequential walk; null when memory runs out
static char* unitig_sequential(const Index& idx, int min_match,
                               const uint64_t* sorted, int64_t* out_len) {
  Builder<PlainBits> b(idx, min_match, sorted);
  b.run();
  char* p = (char*)malloc(b.out.size() + 1);
  if (!p) return nullptr;
  memcpy(p, b.out.data(), b.out.size());
  p[b.out.size()] = 0;
  *out_len = (int64_t)b.out.size();
  return p;
}

static char* unitig_walk(const Index& idx, int min_match,
                         const uint64_t* sorted, int n_threads,
                         int64_t* out_len) {
  try {
    if (n_threads > 1)
      return unitig_threaded(idx, min_match, sorted, n_threads, out_len);
    return unitig_sequential(idx, min_match, sorted, out_len);
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

// Link records of the stored sequences, as search/unitig_links.py's
// LinkStore holds them (structure of arrays).
struct LinkArrays {
  const uint8_t* valid;
  const int8_t* ret;
  const int64_t* intv0;     // [n*3] kb,kf,sz
  const uint8_t* has_ovlp;
  const void* nkb;          // [n*nmax] idtype
  const void* nkf;
  const void* nsz;
  const int32_t* nov;       // [n*nmax]
  const int32_t* nex;
  const int32_t* nein;
  const void* skb;          // [n*sbmax] idtype
  const void* skf;
  const void* ssz;
  const int32_t* sbn;
  const uint8_t* redo;
  int nmax, sbmax;
  int idt64;                // nonzero: buffers are int64, else int32
  inline int64_t rd(const void* p, int64_t x, int w, int i) const {
    return idt64 ? ((const int64_t*)p)[x * w + i]
                 : (int64_t)((const int32_t*)p)[x * w + i];
  }
};

struct Stitcher {
  Builder<PlainBits> b;
  const LinkArrays& la;
  const uint8_t* seq_flat;
  const int64_t* seq_offs;   // [n+1]
  const int64_t* own_ks;     // [n]
  std::vector<int64_t> inv;  // preceding-sentinel rank -> sequence index
  int64_t n_recover = 0;     // member-miss fallbacks (expected ~0)

  Stitcher(const Index& idx, int mm, const uint64_t* srt,
           const LinkArrays& links, const uint8_t* flat, const int64_t* offs,
           const int64_t* ks)
      : b(idx, mm, srt), la(links), seq_flat(flat), seq_offs(offs),
        own_ks(ks) {
    inv.resize(idx.n_seqs);
    for (int64_t x = 0; x < idx.n_seqs; ++x) inv[own_ks[x]] = x;
  }

  inline const uint8_t* seq(int64_t x, int64_t* len) const {
    *len = seq_offs[x + 1] - seq_offs[x];
    return seq_flat + seq_offs[x];
  }

  void apply_sbits(int64_t x) {
    int m = la.sbn[x];
    for (int i = 0; i < m; ++i)
      b.set_bits(la.rd(la.skb, x, la.sbmax, i), la.rd(la.skf, x, la.sbmax, i),
                 la.rd(la.ssz, x, la.sbmax, i));
  }

  void load_nei(int64_t x, std::vector<Intv>& nei) {
    nei.clear();
    int m = la.nein[x];
    for (int i = 0; i < m; ++i)
      nei.push_back({la.rd(la.nkb, x, la.nmax, i),
                     la.rd(la.nkf, x, la.nmax, i),
                     la.rd(la.nsz, x, la.nmax, i),
                     (uint64_t)la.nov[x * la.nmax + i]});
  }

  // the consumed read: the neighbor-interval member equal to the tip
  int64_t find_member(const Intv& n0, int ext, const std::vector<uint8_t>& s,
                      int rbeg) {
    int64_t want = (int64_t)(n0.info & 0xffffffffULL) + ext;
    int64_t tip = (int64_t)s.size() - rbeg;
    for (int64_t i = 0; i < n0.sz; ++i) {
      int64_t y = inv[n0.kb + i];
      int64_t ly;
      const uint8_t* sy = seq(y, &ly);
      if (ly != want) continue;
      bool eq = true;
      for (int64_t t = 0; t < tip; ++t)
        if (sy[t] != s[rbeg + t]) { eq = false; break; }
      if (eq) return y;
    }
    return -1;
  }

  // unitig_unidir over link records; cur_x < 0 means "no precomputed
  // record: run the Builder's exact get_nei for this tip"
  int unidir(std::vector<uint8_t>& s, std::vector<uint8_t>& cov, int beg0,
             int64_t k0, int64_t* end, bool* is_loop, std::vector<Intv>& nei,
             int64_t cur_x) {
    int beg = beg0, ori_l = (int)s.size(), n_reads = 0;
    *is_loop = false;
    nei.clear();
    std::vector<Intv> empty_prev;
    while (true) {
      int rbeg;
      int64_t next_x = -1;
      bool synth = cur_x < 0 || la.redo[cur_x];
      if (synth) {
        // exact on-demand get_nei (applies its own used bits)
        empty_prev.clear();
        rbeg = b.get_nei(beg, s, nei, empty_prev);
        if (rbeg < 0) break;
        if (nei.size() == 1) {
          int ext = (int)s.size() - ori_l;
          next_x = find_member(nei[0], ext, s, rbeg);
        }
      } else {
        apply_sbits(cur_x);
        load_nei(cur_x, nei);
        if (nei.empty()) break;
        rbeg = ori_l - (int)(nei[0].info & 0xffffffffULL);
        if (nei.size() == 1) {
          int ext = la.nex[cur_x * la.nmax];
          next_x = find_member(nei[0], ext, s, rbeg);
          if (next_x >= 0) {
            // reference get_nei grows s to the consumed read's end
            // before the caller's checks (unitig.c:155)
            int64_t ly;
            const uint8_t* sy = seq(next_x, &ly);
            for (int64_t t = ori_l - rbeg; t < ly; ++t)
              s.push_back(sy[t]);
          } else {
            // no member equals the tip: recover exactly (rare; the
            // device sbits for this call are already applied, and the
            // Builder re-applies the same bits -- idempotent)
            ++n_recover;
            std::vector<Intv> nei2;
            empty_prev.clear();
            b.get_nei(beg, s, nei2, empty_prev);
            nei = nei2;
            if (nei.size() == 1) {
              int ext = (int)s.size() - ori_l;
              next_x = find_member(nei[0], ext, s, rbeg);
            }
          }
        }
      }
      if (nei.size() > 1) {
        b.bits.set_bend(*end);
        break;
      }
      int64_t k = nei[0].kb;
      if (k == *end) break;
      if (b.bits.bend_at(k) || b.check_left(beg, rbeg, s, nei) < 0) {
        b.bits.set_bend(k);
        break;
      }
      if (k == k0) {
        *is_loop = true;
        break;
      }
      if (nei[0].kf == *end) {
        nei.clear();
        break;
      }
      *end = nei[0].kf;
      b.set_bits(nei[0].kb, nei[0].kf, nei[0].sz);
      ++n_reads;
      while (cov.size() < s.size()) cov.push_back('"');
      cov.resize(s.size());
      for (int i = rbeg; i < ori_l; ++i)
        if (cov[i] != '~') ++cov[i];
      for (size_t i = ori_l; i < s.size(); ++i) cov[i] = '"';
      beg = rbeg;
      ori_l = (int)s.size();
      cur_x = next_x;
    }
    s.resize(ori_l);
    cov.resize(ori_l);
    return n_reads;
  }

  // the direction-1 tip: any member of the RC side of intv0 storing
  // exactly RC(seed)
  int64_t rc_rank(const int64_t* iv, const std::vector<uint8_t>& rc) {
    for (int64_t i = 0; i < iv[2]; ++i) {
      int64_t y = inv[iv[1] + i];
      int64_t ly;
      const uint8_t* sy = seq(y, &ly);
      if (ly != (int64_t)rc.size()) continue;
      bool eq = true;
      for (size_t t = 0; t < rc.size(); ++t)
        if (sy[t] != rc[t]) { eq = false; break; }
      if (eq) return y;
    }
    return -1;
  }

  bool unitig1(int64_t seed, std::vector<uint8_t>& s, std::vector<uint8_t>& cov,
               int64_t k_out[2], std::vector<Intv> nei_out[2], int* nsr) {
    if (b.sorted && b.bits.used_at(seed)) return false;
    int64_t slen;
    const uint8_t* sp = seq(seed, &slen);
    if (slen <= b.min_match) return false;
    if (!b.sorted && b.bits.used_at(own_ks[seed])) return false;
    const int64_t* iv = la.intv0 + seed * 3;
    b.set_bits(iv[0], iv[1], iv[2]);
    if (la.ret[seed] < 0) return false;
    *nsr = 1;
    s.assign(sp, sp + slen);
    int seed_len = (int)slen;
    cov.assign(slen, '"');
    k_out[0] = iv[1];
    k_out[1] = iv[0];
    nei_out[0].clear();
    nei_out[1].clear();
    std::vector<Intv> nei;
    if (la.has_ovlp[seed]) {
      bool is_loop;
      int nr = unidir(s, cov, 0, iv[0], &k_out[0], &is_loop, nei, seed);
      *nsr += nr;
      nei_out[0] = nei;
      if (is_loop) {
        nei_out[1].clear();
        nei_out[1].push_back({k_out[0], 0, 0, nei[0].info});
        return true;
      }
    }
    std::reverse(s.begin(), s.end());
    for (auto& c : s) c = (uint8_t)comp6(c);
    std::reverse(cov.begin(), cov.end());
    std::vector<uint8_t> rc(s.end() - seed_len, s.end());
    int64_t rx = rc_rank(iv, rc);
    bool is_loop;
    int nr = unidir(s, cov, (int)s.size() - seed_len, iv[1], &k_out[1],
                    &is_loop, nei, rx);
    *nsr += nr;
    nei_out[1] = nei;
    return true;
  }

  void run() {
    int64_t n1 = b.e.n_seqs;
    std::vector<uint8_t> s, cov;
    for (int64_t j = 0; j <= (n1 >> 2); ++j) {
      for (int64_t i = (j << 2) | 1; i < (j << 2) + 4 && i < n1; i += 2) {
        int64_t k_out[2];
        std::vector<Intv> nei_out[2];
        int nsr = 0;
        if (!unitig1(i, s, cov, k_out, nei_out, &nsr)) continue;
        if (b.bits.visited_at(k_out[0]) || b.bits.visited_at(k_out[1]))
          continue;
        b.bits.set_visited(k_out[0]);
        b.bits.set_visited(k_out[1]);
        b.write_mag(s, cov, k_out, nei_out, nsr);
      }
    }
  }
};

}  // namespace

extern "C" {

// The unitigs of an index as MAG text, malloc'd (free it with
// funitig_free), its length via out_len; null when memory runs out.
// n_threads == 1: the exact sequential walk (the bytes of the reference's
// `unitig -t 1`); n_threads > 1: the reference's `-t N` semantics (shared
// atomic bitmaps, unitig.c:378-407): output ORDER deterministic, boundary
// decisions timing-dependent like the reference's.
char* funitig_run(const uint8_t* blocks, const int64_t* occ, int64_t n_rows,
                  const int64_t* cnt, int64_t n_seqs, int min_match,
                  const uint64_t* sorted, int n_threads, int64_t* out_len) {
  Index idx;
  *out_len = 0;
  if (idx.setup(blocks, occ, n_rows, cnt, n_seqs)) return nullptr;
  return unitig_walk(idx, min_match, sorted, n_threads, out_len);
}

// Same walk over an mmapped .fmd.blk record cache (out-of-core `-M` path):
// RSS stays bounded by the pages the walk touches.  out_len = -1 when the
// cache cannot be mapped.
char* funitig_run_blk(const char* blk_path, int min_match,
                      const uint64_t* sorted, int n_threads,
                      int64_t* out_len) {
  Index idx;
  if (idx.setup_blk(blk_path)) {
    *out_len = -1;
    return nullptr;
  }
  *out_len = 0;
  return unitig_walk(idx, min_match, sorted, n_threads, out_len);
}

// Bulk-link stitch over device-computed link records (see Stitcher).
// seqs are passed as a flat uint8 buffer + [n+1] offsets; link buffers
// may be int32 or int64 (idt64 flag).  Returns the MAG text, malloc'd
// (free it with funitig_free), and its length via out_len; null when
// memory runs out.
char* funitig_stitch(const uint8_t* blocks, const int64_t* occ,
                     int64_t n_rows, const int64_t* cnt, int64_t n_seqs,
                     int min_match, const uint64_t* sorted,
                     const uint8_t* seq_flat, const int64_t* seq_offs,
                     const int64_t* own_ks, const uint8_t* valid,
                     const int8_t* ret, const int64_t* intv0,
                     const uint8_t* has_ovlp, const void* nkb,
                     const void* nkf, const void* nsz, const int32_t* nov,
                     const int32_t* nex, const int32_t* nein, int nmax,
                     const void* skb, const void* skf, const void* ssz,
                     const int32_t* sbn, int sbmax, const uint8_t* redo,
                     int idt64, int64_t* out_len, int64_t* n_recover) {
  Index idx;
  *out_len = 0;
  if (idx.setup(blocks, occ, n_rows, cnt, n_seqs)) return nullptr;
  LinkArrays la{valid, ret, intv0, has_ovlp, nkb, nkf, nsz, nov, nex,
                nein, skb, skf, ssz, sbn, redo, nmax, sbmax, idt64};
  try {
    Stitcher st(idx, min_match, sorted, la, seq_flat, seq_offs, own_ks);
    st.run();
    if (n_recover) *n_recover = st.n_recover;
    size_t len = st.b.out.size();
    char* p = (char*)malloc(len + 1);
    if (!p) return nullptr;
    memcpy(p, st.b.out.data(), len);
    p[len] = 0;
    *out_len = (int64_t)len;
    return p;
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

void funitig_free(void* p) { free(p); }

}  // extern "C"
