// Native paircov engine for remap (reference smem.c:140-204).
//
// The port's copy of fermi_tpu/native/remap.cpp.
//
// remap's hot host loop walked every full-length read hit in Python with a
// bucket-faithful khash (algos/pykhash.py) — ~7 s of hash ops plus ~12 s of
// tuple marshaling per 1M-read remap stage.  This ports the SAME sequential
// semantics (one hash across contigs, fresh hash when it has grown to >=256
// buckets, unpaired entries drained in bucket-scan order — the UR:Z: lists
// feed the scaffolder in that order) so the Python layer keeps only the
// masking/emission logic.
//
// KH64 replicates khash.h exactly as pykhash.py does: 32-bit hash of the
// 64-bit key, double-hash probing, 0.77 upper bound, kick-out rehash,
// tombstone deletion.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t EMPTY = 2, DELETED = 1, USED = 0;

inline uint32_t hash64(uint64_t key) {
  return (uint32_t)((key >> 33) ^ key ^ (key << 11));
}

inline uint32_t kroundup32(uint32_t x) {
  --x;
  x |= x >> 1; x |= x >> 2; x |= x >> 4; x |= x >> 8; x |= x >> 16;
  return x + 1;
}

struct KH64 {
  uint32_t n_buckets = 0, size = 0, n_occupied = 0, upper_bound = 0;
  std::vector<uint32_t> flags;
  std::vector<uint64_t> keys;
  std::vector<uint64_t> vals;

  void clear() {
    if (!flags.empty()) {
      std::fill(flags.begin(), flags.end(), EMPTY);
      size = n_occupied = 0;
    }
  }

  uint32_t get(uint64_t key) const {
    if (!n_buckets) return 0;
    uint32_t mask = n_buckets - 1;
    uint32_t k = hash64(key);
    uint32_t i = k & mask;
    uint32_t inc = (((k >> 3) ^ (k << 3)) | 1) & mask;
    uint32_t last = i;
    while (flags[i] != EMPTY && (flags[i] == DELETED || keys[i] != key)) {
      i = (i + inc) & mask;
      if (i == last) return n_buckets;
    }
    return flags[i] != USED ? n_buckets : i;
  }

  void resize(uint32_t req) {
    uint32_t nb = kroundup32(req);
    if (nb < 4) nb = 4;
    if (size >= (uint32_t)(nb * 0.77 + 0.5)) return;
    std::vector<uint32_t> new_flags(nb, EMPTY);
    if (n_buckets < nb) {
      keys.resize(nb, 0);
      vals.resize(nb, 0);
    }
    uint32_t new_mask = nb - 1;
    for (uint32_t j = 0; j < n_buckets; ++j) {
      if (flags[j] != USED) continue;
      uint64_t key = keys[j], val = vals[j];
      flags[j] = DELETED;
      while (true) {  // kick-out
        uint32_t k = hash64(key);
        uint32_t i = k & new_mask;
        uint32_t inc = (((k >> 3) ^ (k << 3)) | 1) & new_mask;
        while (new_flags[i] != EMPTY) i = (i + inc) & new_mask;
        new_flags[i] = USED;
        if (i < n_buckets && flags[i] == USED) {
          std::swap(keys[i], key);
          std::swap(vals[i], val);
          flags[i] = DELETED;
        } else {
          keys[i] = key;
          vals[i] = val;
          break;
        }
      }
    }
    if (n_buckets > nb) {
      keys.resize(nb);
      vals.resize(nb);
    }
    flags.swap(new_flags);
    n_buckets = nb;
    n_occupied = size;
    upper_bound = (uint32_t)(nb * 0.77 + 0.5);
  }

  // returns bucket; ret 1/2 = newly placed, 0 = already present
  uint32_t put(uint64_t key, int* ret) {
    if (n_occupied >= upper_bound) {
      if (n_buckets > (size << 1))
        resize(n_buckets - 1);
      else
        resize(n_buckets + 1);
    }
    uint32_t mask = n_buckets - 1;
    uint32_t x = n_buckets, site = n_buckets;
    uint32_t k = hash64(key);
    uint32_t i = k & mask;
    if (flags[i] == EMPTY) {
      x = i;
    } else {
      uint32_t inc = (((k >> 3) ^ (k << 3)) | 1) & mask;
      uint32_t last = i;
      while (flags[i] != EMPTY && (flags[i] == DELETED || keys[i] != key)) {
        if (flags[i] == DELETED) site = i;
        i = (i + inc) & mask;
        if (i == last) {
          x = site;
          break;
        }
      }
      if (x == n_buckets) {
        if (flags[i] == EMPTY && site != n_buckets)
          x = site;
        else
          x = i;
      }
    }
    if (flags[x] == EMPTY) {
      keys[x] = key;
      flags[x] = USED;
      ++size;
      ++n_occupied;
      *ret = 1;
    } else if (flags[x] == DELETED) {
      keys[x] = key;
      flags[x] = USED;
      ++size;
      *ret = 2;
    } else {
      *ret = 0;
    }
    return x;
  }

  void del(uint32_t x) {
    if (x != n_buckets && flags[x] == USED) {
      flags[x] = DELETED;
      --size;
    }
  }
};

struct PaircovState {
  KH64* h;
  int64_t skip, max_dist;
  int64_t rec[3];  // n, sum, sumsq of observed insert sizes
};

}  // namespace

extern "C" {

void* fpaircov_create(int64_t skip, int64_t max_dist) {
  PaircovState* st = new PaircovState();
  st->h = new KH64();
  st->skip = skip;
  st->max_dist = max_dist;
  st->rec[0] = st->rec[1] = st->rec[2] = 0;
  return st;
}

void fpaircov_stats(void* hd, int64_t* rec_out) {
  PaircovState* st = (PaircovState*)hd;
  for (int i = 0; i < 3; ++i) rec_out[i] = st->rec[i];
}

void fpaircov_destroy(void* hd) {
  PaircovState* st = (PaircovState*)hd;
  delete st->h;
  delete st;
}

// One batch of contigs.  mems: [total, 5] rows (start, end, size, closed,
// kf) in per-contig emission order; mem_counts / contig_lens per contig.
// cov/pcv outputs are concatenated per-contig byte arrays (offsets =
// cumsum(contig_lens)); n_supp per contig.  Unpaired entries (key ^ final
// flag, start<<32|end) are appended to unp_k/unp_v with per-contig counts
// in unp_counts; returns total unpaired written (caller sizes the buffers
// as total full-length members + hash drain upper bound).
int64_t fpaircov_batch(void* hd, const int64_t* mems, const int64_t* counts,
                       const int64_t* lens, int64_t n_contigs,
                       const uint64_t* sorted_arr, int64_t e_n_seqs,
                       uint8_t* cov_out, uint8_t* pcv_out, int64_t* n_supp,
                       int64_t* unp_k, int64_t* unp_v, int64_t* unp_counts) {
  PaircovState* st = (PaircovState*)hd;
  int64_t at = 0, cov_at = 0, unp_at = 0;
  std::vector<int32_t> cov, pcv;
  for (int64_t ci = 0; ci < n_contigs; ++ci) {
    int64_t l = lens[ci];
    cov.assign(l + 1, 0);
    pcv.assign(l + 1, 0);
    if (st->h->n_buckets >= 256) {  // remap.py: fresh hash when grown
      delete st->h;
      st->h = new KH64();
    }
    KH64* h = st->h;
    int64_t supp = 0;
    int64_t unp0 = unp_at;
    for (int64_t mi = 0; mi < counts[ci]; ++mi) {
      const int64_t* mm = mems + (at + mi) * 5;
      int64_t start = mm[0], end = mm[1], size = mm[2], closed = mm[3],
              kf = mm[4];
      if (!(closed && kf < e_n_seqs)) continue;
      for (int64_t p = start; p < end && p <= l; ++p) ++cov[p];
      ++supp;
      if (st->skip <= 0 || !sorted_arr) continue;
      for (int64_t u = 0; u < size; ++u) {
        int64_t k = (int64_t)(sorted_arr[kf + u] >> 2);
        if ((k & 1) == 0) {
          int to_add = 0;
          uint32_t kk = h->get((uint64_t)k);
          int64_t beg = 0;
          if (kk != h->n_buckets) {
            beg = (int64_t)(h->vals[kk] >> 32);
            int64_t e_ = end;
            if (e_ - beg < st->max_dist) {
              st->rec[0] += 1;
              st->rec[1] += e_ - beg;
              st->rec[2] += (e_ - beg) * (e_ - beg);
            } else {
              to_add = 1;
            }
            if (!to_add) {
              beg += st->skip;
              e_ -= st->skip;
              if (beg > e_) std::swap(beg, e_);
              if (beg < 0) beg = 0;
              if (e_ > l) e_ = l;
              for (int64_t p = beg; p < e_; ++p) ++pcv[p];
              h->del(kk);
              continue;
            }
          } else {
            to_add = 1;
          }
          if (to_add) {
            unp_k[unp_at] = k ^ 1;
            unp_v[unp_at] = (start << 32) | end;
            ++unp_at;
          }
        } else {
          int ret;
          uint32_t kk = h->put((uint64_t)(k ^ 3), &ret);
          h->vals[kk] = (uint64_t)((start << 32) | end);
        }
      }
    }
    for (uint32_t b = 0; b < h->n_buckets; ++b) {
      if (h->flags[b] == USED) {
        unp_k[unp_at] = (int64_t)(h->keys[b] ^ 2);
        unp_v[unp_at] = (int64_t)h->vals[b];
        ++unp_at;
      }
    }
    h->clear();
    unp_counts[ci] = unp_at - unp0;
    n_supp[ci] = supp;
    for (int64_t p = 0; p < l; ++p) {
      cov_out[cov_at + p] = (uint8_t)(cov[p] < 255 ? cov[p] : 255);
      pcv_out[cov_at + p] = (uint8_t)(pcv[p] < 255 ? pcv[p] : 255);
    }
    cov_at += l;
    at += counts[ci];
  }
  return unp_at;
}

}  // extern "C"
