// frags.cpp — the read encoders of the port's index builds.
//
// The port's copy of fermi_tpu/native/construct.cpp's text and fragment
// encoders (fbuild_text, fencode_frags, ffastq_frags), without its threaded
// suffix-array engine (the port sorts on the device) and without oom.h:
// an allocation that fails returns an error code the caller raises on.
//
// A fragment is a maximal run of A/C/G/T (either case) in a read; any other
// byte splits the read there and is dropped, as the reference pipeline's
// `ropebwt -N` does.  Fragments are nt6 (A=1 .. T=4), forward strand only.

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Assemble the sentinel-terminated fermi text (fwd 0 [rc 0] per read,
// reference cmd.c:458-462 palindrome trim) from concatenated nt6 reads.
// out must hold 2*total+2*n_reads bytes; returns the text length.
int64_t fbuild_text(const uint8_t* seqs, const int64_t* offsets,
                    int64_t n_reads, int both_strands, int trim_palindrome,
                    uint8_t* out) {
  int64_t at = 0;
  for (int64_t r = 0; r < n_reads; ++r) {
    const uint8_t* s = seqs + offsets[r];
    int64_t l = offsets[r + 1] - offsets[r];
    if (both_strands && trim_palindrome && l > 0 && l % 2 == 0) {
      bool pal = true;
      for (int64_t i = 0; i < l; ++i)
        if ((int)s[i] + (int)s[l - 1 - i] != 5) {
          pal = false;
          break;
        }
      if (pal) --l;
    }
    memcpy(out + at, s, l);
    at += l;
    out[at++] = 0;
    if (both_strands) {
      for (int64_t i = 0; i < l; ++i) {
        uint8_t c = s[l - 1 - i];
        out[at + i] = (c >= 1 && c <= 4) ? (uint8_t)(5 - c) : c;
      }
      at += l;
      out[at++] = 0;
    }
  }
  return at;
}

// ASCII read spans -> forward-only nt6 fragments (maximal ACGT runs):
// malloc'd F (concatenated, no sentinels) + offs[nfrag+1], both freed with
// ffrags_free.  Returns nfrag, or -1 when out of memory.
int64_t fencode_frags(const uint8_t* data, const int64_t* starts,
                      const int64_t* lens, int64_t n_reads, int n_threads,
                      uint8_t** F_out, int64_t** offs_out) {
  if (n_threads < 1) n_threads = 1;
  const int T = n_threads;
  int8_t tbl[256];
  for (int i = 0; i < 256; ++i) tbl[i] = 0;
  const char* u = "ACGT";
  const char* lo = "acgt";
  for (int i = 0; i < 4; ++i) {
    tbl[(uint8_t)u[i]] = (int8_t)(i + 1);
    tbl[(uint8_t)lo[i]] = (int8_t)(i + 1);
  }
  std::vector<int64_t> split(T + 1);
  for (int t = 0; t <= T; ++t) split[t] = n_reads * t / T;
  std::vector<std::vector<uint8_t>> tF(T);
  std::vector<std::vector<int64_t>> tfl(T);
  auto scan = [&](int t) {
    auto& F = tF[t];
    auto& fl = tfl[t];
    int64_t bytes = 0;
    for (int64_t r = split[t]; r < split[t + 1]; ++r) bytes += lens[r];
    F.reserve(bytes);
    for (int64_t r = split[t]; r < split[t + 1]; ++r) {
      const uint8_t* s = data + starts[r];
      int64_t L = lens[r];
      int64_t fstart = -1;
      for (int64_t i = 0; i <= L; ++i) {
        int8_t c = i < L ? tbl[s[i]] : 0;
        if (c) {
          if (fstart < 0) fstart = (int64_t)F.size();
          F.push_back((uint8_t)c);
        } else if (fstart >= 0) {
          fl.push_back((int64_t)F.size() - fstart);
          fstart = -1;
        }
      }
    }
  };
  {
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(scan, t);
    for (auto& x : th) x.join();
  }
  int64_t total = 0, nfrag = 0;
  for (int t = 0; t < T; ++t) {
    total += (int64_t)tF[t].size();
    nfrag += (int64_t)tfl[t].size();
  }
  uint8_t* F = (uint8_t*)malloc(total + 1);
  int64_t* offs = (int64_t*)malloc((nfrag + 1) * sizeof(int64_t));
  if (!F || !offs) {
    free(F);
    free(offs);
    return -1;
  }
  int64_t fat = 0, oat = 0, acc = 0;
  for (int t = 0; t < T; ++t) {
    memcpy(F + fat, tF[t].data(), tF[t].size());
    fat += (int64_t)tF[t].size();
    for (int64_t x : tfl[t]) {
      offs[oat++] = acc;
      acc += x;
    }
  }
  offs[oat] = acc;
  *F_out = F;
  *offs_out = offs;
  return nfrag;
}

// Plain 4-line FASTQ file -> forward nt6 fragments in ONE pass: mmap the
// file, threaded newline scan + '@'/'+' shape validation + table encode +
// maximal-ACGT-run split, per-thread buffers gathered into two malloc'd
// arrays (F bytes, offs int64[nfrag+1]).  Collapses the python chain
// (f.read -> fastq_seq_spans -> fencode_frags: 4+ full passes over the
// bytes plus a 1 GB copy) into two streaming passes.  Returns len(F), or
// a negative error: -1 IO, -2/-3 not 4-line FASTQ, -4 out of memory.
int64_t ffastq_frags(const char* path, int n_threads, uint8_t** F_out,
                     int64_t** offs_out, int64_t* nfrag_out) {
  if (n_threads < 1) n_threads = 1;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  off_t flen = lseek(fd, 0, SEEK_END);
  if (flen <= 0) { close(fd); return -1; }
  const uint8_t* data = (const uint8_t*)mmap(nullptr, (size_t)flen,
                                             PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (data == MAP_FAILED) return -1;
  madvise((void*)data, (size_t)flen, MADV_SEQUENTIAL);
  const int64_t n = (int64_t)flen;
  const int T = n_threads;

  // phase A: newline count per chunk
  std::vector<int64_t> cstart(T + 1), nlcnt(T, 0);
  for (int t = 0; t <= T; ++t) cstart[t] = n * t / T;
  {
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t)
      th.emplace_back([&, t] {
        int64_t c = 0;
        const uint8_t* p = data + cstart[t];
        const uint8_t* e = data + cstart[t + 1];
        while (p < e) {
          const uint8_t* q = (const uint8_t*)memchr(p, '\n', e - p);
          if (!q) break;
          ++c;
          p = q + 1;
        }
        nlcnt[t] = c;
      });
    for (auto& x : th) x.join();
  }
  std::vector<int64_t> line_at(T + 1, 0);  // line index at chunk starts
  for (int t = 0; t < T; ++t) line_at[t + 1] = line_at[t] + nlcnt[t];
  int64_t n_lines = line_at[T];
  bool final_nl = data[n - 1] == '\n';
  if (!final_nl) ++n_lines;
  if (n_lines % 4) { munmap((void*)data, (size_t)flen); return -2; }
  const int64_t n_reads = n_lines / 4;

  int8_t tbl[256];
  memset(tbl, 0, sizeof tbl);
  const char* u = "ACGT";
  const char* lo = "acgt";
  for (int i = 0; i < 4; ++i) {
    tbl[(uint8_t)u[i]] = (int8_t)(i + 1);
    tbl[(uint8_t)lo[i]] = (int8_t)(i + 1);
  }

  // phase B: records split across threads; locate each range's byte start
  // by scanning forward from the nearest chunk boundary
  std::vector<std::vector<uint8_t>> tF(T);
  std::vector<std::vector<int64_t>> tfl(T);
  std::vector<int> bad(T, 0);
  auto work = [&](int t) {
    int64_t r0 = n_reads * t / T, r1 = n_reads * (t + 1) / T;
    if (r0 >= r1) return;
    int64_t want_line = 4 * r0;
    // chunk whose starting line index <= want_line
    int c = 0;
    while (c + 1 <= T - 1 && line_at[c + 1] <= want_line) ++c;
    const uint8_t* p = data + cstart[c];
    const uint8_t* end = data + n;
    for (int64_t skip = want_line - line_at[c]; skip > 0; --skip) {
      const uint8_t* q = (const uint8_t*)memchr(p, '\n', end - p);
      if (!q) { bad[t] = 1; return; }
      p = q + 1;
    }
    auto& F = tF[t];
    auto& fl = tfl[t];
    F.reserve((size_t)((r1 - r0) * 110));
    for (int64_t r = r0; r < r1; ++r) {
      // line 0: @name
      if (p >= end || *p != '@') { bad[t] = 1; return; }
      p = (const uint8_t*)memchr(p, '\n', end - p);
      if (!p) { bad[t] = 1; return; }
      ++p;
      // line 1: sequence
      const uint8_t* q = (const uint8_t*)memchr(p, '\n', end - p);
      if (!q) q = end;
      int64_t fstart = -1;
      for (const uint8_t* s = p; s <= q; ++s) {
        int8_t cc = s < q ? tbl[*s] : 0;
        if (cc) {
          if (fstart < 0) fstart = (int64_t)F.size();
          F.push_back((uint8_t)cc);
        } else if (fstart >= 0) {
          fl.push_back((int64_t)F.size() - fstart);
          fstart = -1;
        }
      }
      p = q < end ? q + 1 : end;
      // line 2: +
      if (p >= end || *p != '+') { bad[t] = 1; return; }
      p = (const uint8_t*)memchr(p, '\n', end - p);
      if (!p) { bad[t] = 1; return; }
      ++p;
      // line 3: qualities
      q = (const uint8_t*)memchr(p, '\n', end - p);
      p = q ? q + 1 : end;
    }
  };
  {
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(work, t);
    for (auto& x : th) x.join();
  }
  munmap((void*)data, (size_t)flen);
  for (int t = 0; t < T; ++t)
    if (bad[t]) return -3;

  int64_t total = 0, nfrag = 0;
  std::vector<int64_t> fbase(T + 1, 0), obase(T + 1, 0);
  for (int t = 0; t < T; ++t) {
    fbase[t + 1] = fbase[t] + (int64_t)tF[t].size();
    obase[t + 1] = obase[t] + (int64_t)tfl[t].size();
  }
  total = fbase[T];
  nfrag = obase[T];
  uint8_t* F = (uint8_t*)malloc((size_t)total + 1);
  int64_t* offs = (int64_t*)malloc(((size_t)nfrag + 1) * sizeof(int64_t));
  if (!F || !offs) { free(F); free(offs); return -4; }
  {
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t)
      th.emplace_back([&, t] {
        memcpy(F + fbase[t], tF[t].data(), tF[t].size());
        int64_t acc = fbase[t], oat = obase[t];
        for (int64_t x : tfl[t]) {
          offs[oat++] = acc;
          acc += x;
        }
      });
    for (auto& x : th) x.join();
  }
  offs[nfrag] = total;
  *F_out = F;
  *offs_out = offs;
  *nfrag_out = nfrag;
  return total;
}

// Frees a buffer returned by fencode_frags or ffastq_frags.
void ffrags_free(void* p) { free(p); }

}  // extern "C"
