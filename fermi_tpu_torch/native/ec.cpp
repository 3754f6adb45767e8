// ec.cpp — error-correction "fix" engine (host side).
//
// The port's own copy of fermi_tpu/native/ec.cpp: standard library only, no
// header of that package; it builds alone with `g++ -O2 -shared -fPIC` (see
// native/__init__.py).  The k-mer collection phase runs on the device as a
// batched backward BFS over the FMD-index (algos/correct.py); this file
// consumes its (key,value) table and corrects reads with the best-first
// search of reference correct.c:89-256 (same scoring/heap semantics, so the
// corrected FASTQ is byte-identical). The search state y-packing makes every
// heap key unique, so pop order == ascending signed y — a std::priority_queue
// reproduces the reference's custom heap exactly.
//
// Embarrassingly parallel across reads via std::thread.
//
// Added in the port: fec_device_table, the open-addressing table of the
// device fix (search/ecfix_device.py), filled here in input order instead of
// by a Python loop over millions of entries.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr int kRatioFactor = 10;
constexpr int kDiffFactor = 13;
constexpr int kMaxHeap = 256;
constexpr int kMaxScDiff = 60;
constexpr int kMaxQual = 40;
constexpr int kMissPenalty = 10;
constexpr int kMinOcc = 5;
constexpr double kMinOccRatio = 0.8;

// nt6 codec (alphabet of reference seq.c:12-21)
uint8_t nt6_tab[256];
struct Nt6Init {
  Nt6Init() {
    for (int i = 0; i < 256; ++i) nt6_tab[i] = 5;
    nt6_tab[0] = 0;
    const char* b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      nt6_tab[(int)b[i]] = i + 1;
      nt6_tab[(int)tolower(b[i])] = i + 1;
    }
  }
} nt6_init;

// Flat open-addressing hash per suffix class: key identity is key>>2 (the
// low 2 bits carry the best base, returned by lookup).
class SolidHash {
 public:
  void build(const uint32_t* keys, const uint8_t* vals, int64_t n) {
    int64_t cap = 8;
    while (cap < n * 3 / 2 + 1) cap <<= 1;
    mask_ = cap - 1;
    slots_.assign(cap, kEmpty);
    val_.assign(cap, 0);
    for (int64_t i = 0; i < n; ++i) {
      uint64_t h = hash(keys[i] >> 2);
      while (slots_[h & mask_] != kEmpty) ++h;
      slots_[h & mask_] = keys[i];
      val_[h & mask_] = vals[i];
    }
  }
  // returns -1 if absent, else (val<<8 | stored_key_low2)
  inline int get(uint32_t key) const {
    if (slots_.empty()) return -1;
    uint64_t h = hash(key >> 2);
    while (true) {
      uint32_t s = slots_[h & mask_];
      if (s == kEmpty) return -1;
      if ((s >> 2) == (key >> 2)) return (int)val_[h & mask_] << 8 | (s & 3);
      ++h;
    }
  }

 private:
  static constexpr uint32_t kEmpty = 0xffffffffu;
  static inline uint64_t hash(uint32_t x) {
    return x * 2654435761u;
  }
  std::vector<uint32_t> slots_;
  std::vector<uint8_t> val_;
  uint64_t mask_ = 0;
};

struct Ctx {
  int w = 0, suf_len = 0, suf_num = 0;
  std::vector<SolidHash> classes;
};

struct State {
  uint64_t x, y;
};
struct StateCmp {  // min-heap on signed y (reference ku128_ylt, mag.c:22)
  bool operator()(const State& a, const State& b) const {
    return (int64_t)a.y > (int64_t)b.y;
  }
};

struct Opt {
  int w, min_occ, keep_bad, is_paired, trim_l, step;
  float max_corr;
};

struct FixAux {
  std::priority_queue<State, std::vector<State>, StateCmp> heap;
  std::vector<uint64_t> stack;
  uint64_t n_query = 0;
};

inline void save_state(FixAux* fa, const State& p, int c, int score, int shift,
                       int has_match) {
  State w;
  if (score < 0) score = 0;
  if (c >= 4) c = 0;
  w.x = (uint64_t)c << shift | p.x >> 2;
  w.y = (uint64_t)((p.y >> 48) + score) << 48 | (uint64_t)fa->stack.size() << 16 |
        ((p.y & 0xffff) - 1);
  fa->stack.push_back(((p.y & 0xffff) - 1) << 32 | (uint32_t)c << 29 |
                      (uint32_t)has_match << 28 | (uint32_t)(p.y >> 16));
  fa->heap.push(w);
}

// One strand of one read. s: nt6 (mutated by backtrack), qual: ASCII
// (mutated). Returns the packed info of reference ec_fix1.
int ec_fix1(const Ctx& ctx, const Opt& opt, uint8_t* s, int sl, uint8_t* qual,
            FixAux* fa) {
  const int shift = (opt.w - 1) << 1;
  const uint32_t suf_mask = ctx.suf_num - 1;
  int i, q, l, n_rst = 0, no_hits = 1, score_diff;
  State z, rst[2] = {{0, 0}, {0, 0}};

  if (sl <= opt.w) return 0xffff;
  while (!fa->heap.empty()) fa->heap.pop();
  fa->stack.clear();
  z.x = z.y = 0;
  for (i = sl - 1, l = 0; i > 0 && l < opt.w; --i) {
    if (s[i] == 5) z.x = 0, l = 0;
    else z.x = (uint64_t)(s[i] - 1) << shift | z.x >> 2, ++l;
  }
  if (i == 0) return 0xffff;
  fa->stack.push_back(0);
  z.y = i + 1;
  fa->heap.push(z);

  while (!fa->heap.empty()) {
    z = fa->heap.top();
    fa->heap.pop();
    if ((z.y & 0xffff) == 0) {
      rst[n_rst++] = z;
      if (n_rst == 2) break;
      continue;
    }
    if (n_rst && (int)(z.y >> 48) > (int)(rst[0].y >> 48) + kMaxScDiff) break;
    i = (int)(z.y & 0xffff) - 1;
    q = qual[i] - 33 < kMaxQual ? qual[i] - 33 : kMaxQual;
    if (q < 3) q = 3;
    const SolidHash& h = ctx.classes[z.x & suf_mask];
    int hit = h.get((uint32_t)(z.x >> (ctx.suf_len << 1) << 2));
    ++fa->n_query;
    if (hit >= 0) {
      no_hits = 0;
      int best = hit & 3, v = hit >> 8;
      if (s[i] != best + 1) {
        int tmp, penalty, max = (v & 7) ? (v & 7) * (v >> 3) : v >> 3;
        penalty = (max - (v & 7)) * kDiffFactor;
        if (max - (v & 7) < 1) penalty = 1;
        tmp = (v & 7) ? (v >> 3) * kRatioFactor : 10000;
        if (tmp < penalty) penalty = tmp;
        tmp = (7 - (v & 7)) * kDiffFactor;
        if (tmp < penalty) penalty = tmp;
        if (penalty < 1) penalty = 1;
        int heap_n = (int)fa->heap.size();
        if (s[i] != 5 && (heap_n + 2 <= kMaxHeap || penalty < q))
          save_state(fa, z, s[i] - 1, penalty, shift, 1);
        if (s[i] == 5 || heap_n + 2 <= kMaxHeap || penalty > q)
          save_state(fa, z, best, q, shift, 1);
      } else {
        State z0 = z;
        int i0 = i;
        int occ_last = (v & 7) ? (v & 7) * ((v >> 3) + 1) : v >> 3;
        if ((v & 7) <= 0 && opt.step > 1) {
          while (i0 > 0) {
            for (i = (int)(z.y & 0xffff) - 1, l = 0;
                 i >= 1 && l < opt.step && s[i] < 5; --i, ++l)
              z.x = (uint64_t)(s[i] - 1) << shift | z.x >> 2;
            if (s[i] == 5) break;
            const SolidHash& h2 = ctx.classes[z.x & suf_mask];
            int hit2 = h2.get((uint32_t)(z.x >> (ctx.suf_len << 1) << 2));
            ++fa->n_query;
            if (hit2 >= 0 && s[i] == (hit2 & 3) + 1) {
              int v2 = hit2 >> 8;
              int occ = (v2 & 7) ? (v2 & 7) * ((v2 >> 3) + 1) : v2 >> 3;
              if ((v2 & 7) <= 1 && occ >= kMinOcc &&
                  (double)occ / occ_last >= kMinOccRatio) {
                z.y = z.y >> 16 << 16 | (uint64_t)(i + 1);
                z0 = z;
                i0 = i;
                occ_last = occ;
              } else break;
            } else break;
          }
        }
        save_state(fa, z0, s[i0] - 1, 0, shift, 1);
      }
    } else {
      save_state(fa, z, s[i] - 1, kMissPenalty + (kMaxQual - q), shift, 0);
    }
  }
  // n_rst is 1 or 2 here (as asserted by the reference)
  score_diff = n_rst == 1 ? kMaxScDiff
                          : (int)(rst[1].y >> 48) - (int)(rst[0].y >> 48);
  if (score_diff >= kMaxScDiff) score_diff = kMaxScDiff;
  if (rst[0].y >> 48 == 0) return score_diff << 18;
  int qsum = 0;
  uint32_t sp = (uint32_t)(rst[0].y >> 16);
  while (sp) {
    uint64_t el = fa->stack[sp];
    i = (int)(el >> 32);
    if ((uint32_t)(s[i] - 1) != ((uint32_t)el >> 29)) {
      s[i] = (uint8_t)(((uint32_t)el >> 29) + 1);
      qsum += qual[i] - 33;
    } else if (((uint32_t)el >> 28 & 1) && qual[i] < 37) qual[i] = 37;
    sp = (uint32_t)el << 4 >> 4;
  }
  return qsum | score_diff << 18 | no_hits << 17;
}

void revcomp6(uint8_t* s, int l) {
  for (int i = 0; i < l >> 1; ++i) {
    int t = s[l - 1 - i];
    t = (t >= 1 && t <= 4) ? 5 - t : t;
    s[l - 1 - i] = (s[i] >= 1 && s[i] <= 4) ? 5 - s[i] : s[i];
    s[i] = (uint8_t)t;
  }
  if (l & 1) {
    int m = l >> 1;
    s[m] = (s[m] >= 1 && s[m] <= 4) ? 5 - s[m] : s[m];
  }
}

void reverse_bytes(uint8_t* s, int l) {
  for (int i = 0; i < l >> 1; ++i) {
    uint8_t t = s[l - 1 - i];
    s[l - 1 - i] = s[i];
    s[i] = t;
  }
}

// reference ec_fix (correct.c:222-256) for one read
uint64_t fix_read(const Ctx& ctx, const Opt& opt, uint8_t* seq_ascii, int sl,
                  uint8_t* qual, int32_t* info, FixAux* fa) {
  std::vector<uint8_t> str(sl);
  for (int j = 0; j < sl; ++j) str[j] = nt6_tab[seq_ascii[j]];
  revcomp6(str.data(), sl);
  reverse_bytes(qual, sl);
  int ret0 = ec_fix1(ctx, opt, str.data(), sl, qual, fa);
  reverse_bytes(qual, sl);
  revcomp6(str.data(), sl);
  if (ret0 != 0xffff) {
    int ret1 = ec_fix1(ctx, opt, str.data(), sl, qual, fa);
    *info = ((ret0 & 0xffff) + (ret1 & 0xffff)) |
            (ret0 >> 18 < ret1 >> 18 ? ret0 >> 18 : ret1 >> 18) << 18;
    if ((ret0 >> 17 & 1) && (ret1 >> 17 & 1)) *info |= 1 << 16;
  } else *info = ret0;
  int n_lower = 0;
  static const char low6[] = "$acgtn";
  for (int j = 0; j < sl; ++j) {
    seq_ascii[j] = nt6_tab[seq_ascii[j]] == str[j] ? (uint8_t)toupper(seq_ascii[j])
                                                   : (uint8_t)low6[str[j]];
    if (islower(seq_ascii[j])) { ++n_lower; qual[j] = 36; }
  }
  if ((double)n_lower / sl > opt.max_corr) *info |= 1 << 16;
  if (*info >> 18 <= 10) *info |= 1 << 16;
  return fa->n_query;
}

}  // namespace

extern "C" {

void* fec_create(int w, int suf_len, const uint32_t* keys, const uint8_t* vals,
                 const int64_t* class_offsets) {
  Ctx* ctx = new Ctx;
  ctx->w = w;
  ctx->suf_len = suf_len;
  ctx->suf_num = 1 << (suf_len << 1);
  ctx->classes.resize(ctx->suf_num);
  for (int i = 0; i < ctx->suf_num; ++i)
    ctx->classes[i].build(keys + class_offsets[i], vals + class_offsets[i],
                          class_offsets[i + 1] - class_offsets[i]);
  return ctx;
}

void fec_destroy(void* p) { delete (Ctx*)p; }

// Correct a batch of reads in place.
// seqs/quals: concatenated ASCII, offsets int64[n+1]; info: int32[n] out.
// Returns total hash queries (for the reference's lookups-per-read log line).
uint64_t fec_fix(void* pctx, const Opt* opt, int64_t n_seqs, uint8_t* seqs,
                 uint8_t* quals, const int64_t* offsets, int32_t* info,
                 int n_threads) {
  Ctx* ctx = (Ctx*)pctx;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  std::vector<uint64_t> nq(n_threads, 0);
  auto work = [&](int t) {
    FixAux fa;
    for (int64_t i = t; i < n_seqs; i += n_threads) {
      int sl = (int)(offsets[i + 1] - offsets[i]);
      fix_read(*ctx, *opt, seqs + offsets[i], sl, quals + offsets[i],
               info + i, &fa);
    }
    nq[t] = fa.n_query;
  };
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  uint64_t total = 0;
  for (int t = 0; t < n_threads; ++t) { threads[t].join(); total += nq[t]; }
  return total;
}

// Fill the device fix's open-addressing table: entry j (identity ids[j],
// value vals[j]) goes to the first empty slot from its home
// (ids[j] * mult mod 2^64) >> (64 - logt), probing linearly, in input
// order.  slots (int64 [2^logt], filled with -1 by the caller) and
// svals (int32 [2^logt]) receive the table.  Returns 0, or 1 when an entry
// would land max_probe or more slots past its home (the caller retries with
// another multiplier or a larger table).
int fec_device_table(const int64_t* ids, const int32_t* vals, int64_t n,
                     int logt, uint64_t mult, int max_probe, int64_t* slots,
                     int32_t* svals) {
  const uint64_t mask = (uint64_t(1) << logt) - 1;
  for (int64_t j = 0; j < n; ++j) {
    uint64_t p = ((uint64_t)ids[j] * mult) >> (64 - logt) & mask;
    for (int d = 0; slots[p] != -1; ++d) {
      if (d + 1 >= max_probe) return 1;
      p = (p + 1) & mask;
    }
    slots[p] = ids[j];
    svals[p] = vals[j];
  }
  return 0;
}

}  // extern "C"
