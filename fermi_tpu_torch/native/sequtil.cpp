// sequtil.cpp — native kernels for the host stream utilities.
//
// The port's copy of fermi_tpu/native/sequtil.cpp.
//
// fflt_keep: the fltuniq filter decision (reference seq.c:149-199). A read
// is kept iff it has no non-ACGT base and every k-mer window (rolling,
// break-resetting scan) occurs >= 2 times across the whole file. The
// reference's two-plane presence bitmap is equivalent to a global
// occurrence-count test, computed here with one parallel bucket sort of
// (code, window) pairs instead of a 4^k-bit table. Scratch lives in a
// grow-only arena: fresh pages fault at ~0.5 GB/s on VM hosts, so the
// ~24 bytes/window is recycled across calls.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct FltArena {
  void* p = nullptr;
  size_t cap = 0;
  void* get(size_t bytes) {
    if (bytes > cap) {
      free(p);
      p = malloc(bytes);
      cap = bytes;
    }
    return p;
  }
};
std::mutex g_flt_mu;
FltArena g_flt_codes, g_flt_pairs;

constexpr uint64_t kInvalid = ~0ULL;
constexpr uint64_t kDupBit = 1ULL << 62;

struct CW {
  uint64_t code;
  int64_t win;
};

// nt6-ish code per byte: A/C/G/T (upper or lower) -> 0..3, else -1
inline void build_code_table(int8_t* tbl) {
  for (int i = 0; i < 256; ++i) tbl[i] = -1;
  const char* u = "ACGT";
  const char* l = "acgt";
  for (int i = 0; i < 4; ++i) {
    tbl[(uint8_t)u[i]] = (int8_t)i;
    tbl[(uint8_t)l[i]] = (int8_t)i;
  }
}

}  // namespace

extern "C" {

// Concatenate byte spans [starts[i], starts[i]+lens[i]) of src into dst
// (caller sizes dst = sum(lens)).  Threaded memcpy; replaces numpy
// delta/cumsum/boolean-mask extraction (three O(file) passes).
void fspans_extract(const uint8_t* src, const int64_t* starts,
                    const int64_t* lens, int64_t n, uint8_t* dst,
                    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  const int T = n_threads;
  std::vector<int64_t> out_off(T + 1);
  std::vector<int64_t> split(T + 1);
  for (int t = 0; t <= T; ++t) split[t] = n * t / T;
  {
    int64_t at = 0;
    int64_t t = 0;
    for (int64_t i = 0; i <= n; ++i) {
      while (t <= T && split[t] == i) out_off[t++] = at;
      if (i < n) at += lens[i];
    }
  }
  auto work = [&](int t) {
    int64_t at = out_off[t];
    for (int64_t i = split[t]; i < split[t + 1]; ++i) {
      memcpy(dst + at, src + starts[i], lens[i]);
      at += lens[i];
    }
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(work, t);
    for (auto& t : th) t.join();
  }
}

// seqs: concatenated read bytes (ASCII); offsets[n+1]; keep_out uint8[n].
// Returns 0 on success.
int fflt_keep(const uint8_t* seqs, const int64_t* offsets, int64_t n_reads,
              int k, uint8_t* keep_out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  const int T = n_threads;
  int8_t tbl[256];
  build_code_table(tbl);
  const uint64_t mask = (k >= 31) ? ((1ULL << 62) - 1) : ((1ULL << (2 * k)) - 1);

  std::vector<int64_t> rsplit0(T + 1);
  for (int t = 0; t <= T; ++t) rsplit0[t] = n_reads * t / T;

  if (2 * k <= 32) {
    // Two-plane presence bitmap (the reference's own structure,
    // seq.c:149-199): A = k-mer seen, B = seen >= twice.  4^k entries x
    // 2 bits (k=15 -> 2x128 MB); replaces the (code, window) sort with two
    // rolling scans + atomic bit ops — no O(windows) scratch at all.
    std::lock_guard<std::mutex> lock(g_flt_mu);
    const size_t nbits = (size_t)1 << (2 * k);
    const size_t words = nbits / 64 + 1;
    uint64_t* A = (uint64_t*)g_flt_codes.get(words * 8);
    uint64_t* B = (uint64_t*)g_flt_pairs.get(words * 8);
    auto clear_par = [&](int t) {
      size_t w0 = words * t / T, w1 = words * (t + 1) / T;
      memset(A + w0, 0, (w1 - w0) * 8);
      memset(B + w0, 0, (w1 - w0) * 8);
    };
    auto mark = [&](int t) {
      for (int64_t r = rsplit0[t]; r < rsplit0[t + 1]; ++r) {
        const uint8_t* s = seqs + offsets[r];
        int64_t l = offsets[r + 1] - offsets[r];
        uint64_t z = 0;
        int run = 0;
        for (int64_t i = 0; i < l; ++i) {
          int8_t c = tbl[s[i]];
          if (c < 0) {
            run = 0;
            z = 0;
            continue;
          }
          z = ((z << 2) | (uint64_t)c) & mask;
          if (++run >= k) {
            uint64_t bit = 1ULL << (z & 63);
            // exactly one concurrent marker observes "already set"
            uint64_t old = __atomic_fetch_or(&A[z >> 6], bit,
                                             __ATOMIC_RELAXED);
            if (old & bit)
              __atomic_fetch_or(&B[z >> 6], bit, __ATOMIC_RELAXED);
          }
        }
      }
    };
    auto decide = [&](int t) {
      for (int64_t r = rsplit0[t]; r < rsplit0[t + 1]; ++r) {
        const uint8_t* s = seqs + offsets[r];
        int64_t l = offsets[r + 1] - offsets[r];
        uint64_t z = 0;
        int run = 0;
        bool ok = true;
        for (int64_t i = 0; i < l && ok; ++i) {
          int8_t c = tbl[s[i]];
          if (c < 0) {
            ok = false;  // invalid base: dropped (matches the sort path)
            break;
          }
          z = ((z << 2) | (uint64_t)c) & mask;
          if (++run >= k && !(B[z >> 6] >> (z & 63) & 1)) ok = false;
        }
        keep_out[r] = ok ? 1 : 0;
      }
    };
    auto run_par0 = [&](auto&& fn) {
      if (T == 1) {
        fn(0);
        return;
      }
      std::vector<std::thread> th;
      for (int t = 0; t < T; ++t) th.emplace_back(fn, t);
      for (auto& t : th) t.join();
    };
    run_par0(clear_par);
    run_par0(mark);
    run_par0(decide);
    return 0;
  }

  std::vector<int64_t> win_base(n_reads + 1);
  int64_t total_wins = 0;
  for (int64_t r = 0; r < n_reads; ++r) {
    win_base[r] = total_wins;
    int64_t l = offsets[r + 1] - offsets[r];
    if (l >= k) total_wins += l - k + 1;
  }
  win_base[n_reads] = total_wins;

  std::lock_guard<std::mutex> lock(g_flt_mu);
  // codes[w]: packed k-mer, kInvalid for broken windows; the dup flag is
  // written back into bit 62 after the global count
  uint64_t* codes = (uint64_t*)g_flt_codes.get(total_wins * 8 + 8);
  CW* pairs = (CW*)g_flt_pairs.get(total_wins * sizeof(CW) + 8);

  // read ranges per thread
  std::vector<int64_t> rsplit(T + 1);
  for (int t = 0; t <= T; ++t) rsplit[t] = n_reads * t / T;

  constexpr int kBits = 16;
  constexpr int64_t kBuckets = (int64_t)1 << kBits;
  const int shift = 2 * k > kBits ? 2 * k - kBits : 0;
  std::vector<std::vector<int64_t>> hist(T);
  std::vector<uint8_t> has_inval(n_reads, 0);

  auto pass1 = [&](int t) {
    hist[t].assign(kBuckets, 0);
    auto& h = hist[t];
    for (int64_t r = rsplit[t]; r < rsplit[t + 1]; ++r) {
      const uint8_t* s = seqs + offsets[r];
      int64_t l = offsets[r + 1] - offsets[r];
      uint64_t z = 0;
      int run = 0;
      bool inval = false;
      int64_t wb = win_base[r];
      for (int64_t i = 0; i < l; ++i) {
        int8_t c = tbl[s[i]];
        if (c < 0) {
          inval = true;
          run = 0;
          z = 0;
        } else {
          z = ((z << 2) | (uint64_t)c) & mask;
          ++run;
        }
        if (i >= k - 1) {
          int64_t w = wb + (i - k + 1);
          if (run >= k) {
            codes[w] = z;
            ++h[z >> shift];
          } else {
            codes[w] = kInvalid;
          }
        }
      }
      has_inval[r] = inval;
    }
  };

  auto run_par = [&](auto&& fn) {
    if (T == 1) {
      fn(0);
      return;
    }
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(fn, t);
    for (auto& t : th) t.join();
  };
  run_par(pass1);

  std::vector<int64_t> off(kBuckets + 1);
  std::vector<std::vector<int64_t>> toff(T);
  {
    int64_t at = 0;
    for (int64_t b = 0; b < kBuckets; ++b) {
      off[b] = at;
      for (int t = 0; t < T; ++t) at += hist[t][b];
    }
    off[kBuckets] = at;
    for (int t = 0; t < T; ++t) toff[t].resize(kBuckets);
    for (int64_t b = 0; b < kBuckets; ++b) {
      int64_t at2 = off[b];
      for (int t = 0; t < T; ++t) {
        toff[t][b] = at2;
        at2 += hist[t][b];
      }
    }
  }
  auto pass2 = [&](int t) {  // scatter valid windows into bucket order
    auto& cur = toff[t];
    for (int64_t r = rsplit[t]; r < rsplit[t + 1]; ++r) {
      for (int64_t w = win_base[r]; w < win_base[r + 1]; ++w) {
        uint64_t z = codes[w];
        if (z != kInvalid) pairs[cur[z >> shift]++] = {z, w};
      }
    }
  };
  run_par(pass2);

  std::atomic<int64_t> next_b(0);
  auto pass3 = [&]() {  // per-bucket: sort by code, mark dup groups
    for (;;) {
      int64_t b0 = next_b.fetch_add(64);
      if (b0 >= kBuckets) break;
      int64_t b1 = std::min(b0 + 64, kBuckets);
      for (int64_t b = b0; b < b1; ++b) {
        CW* v = pairs + off[b];
        int64_t m = off[b + 1] - off[b];
        if (m < 2) continue;
        std::sort(v, v + m,
                  [](const CW& a, const CW& c) { return a.code < c.code; });
        int64_t i = 0;
        while (i < m) {
          int64_t j = i + 1;
          while (j < m && v[j].code == v[i].code) ++j;
          if (j - i >= 2)
            for (int64_t x = i; x < j; ++x) codes[v[x].win] |= kDupBit;
          i = j;
        }
      }
    }
  };
  {
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(pass3);
    for (auto& t : th) t.join();
  }

  auto pass4 = [&](int t) {  // keep = no invalid base and every window dup
    for (int64_t r = rsplit[t]; r < rsplit[t + 1]; ++r) {
      if (has_inval[r]) {
        keep_out[r] = 0;
        continue;
      }
      bool ok = true;
      for (int64_t w = win_base[r]; w < win_base[r + 1]; ++w)
        if (!(codes[w] & kDupBit)) {
          ok = false;
          break;
        }
      keep_out[r] = ok ? 1 : 0;
    }
  };
  run_par(pass4);
  return 0;
}

}  // extern "C"
