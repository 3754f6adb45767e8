// B+-rope incremental multi-string BWT builder.
//
// Fourth independent construction path (QA cross-check, SURVEY §4.5): the
// reference keeps interchangeable builders (SAIS / SAIS-merge / BCR / BPR)
// that must agree bit-for-bit.  Insertion semantics follow reference
// bprope6.c:189-230 (symbols of each read inserted back to front, sentinel
// last, so sentinels rank in insertion order); the structure is a fresh
// design: a counted B+-tree with preemptive top-down splits, 16-wide
// internal nodes carrying (length, per-symbol counts) per child, and leaves
// of 13-bit-length uint16 runs (the reference uses bottom-up split-on-
// overflow nodes and 5-bit byte runs).
//
// Exposed as fbpr_build() — builds the whole BWT in one call.  The port's
// copy of fermi_tpu/native/bprope.cpp; a failed allocation returns -1
// instead of ending the process.

#include <cstdint>
#include <cstring>
#include <deque>
#include <new>
#include <vector>

namespace {

constexpr int FAN = 16;         // children per internal node
constexpr int LEAF_RUNS = 512;  // uint16 runs per leaf
constexpr int64_t MAXRUN = (1 << 13) - 1;

struct Leaf {
  int32_t n = 0;
  uint16_t runs[LEAF_RUNS];  // sym = r & 7, len = r >> 3
};

struct Node;

struct Child {
  void* ptr = nullptr;  // Node* (internal) or Leaf* (bottom)
  int64_t len = 0;
  int64_t c[6] = {0, 0, 0, 0, 0, 0};
};

struct Node {
  int n = 0;
  bool bottom = false;
  Child ch[FAN];
};

struct Rope {
  std::deque<Node> nodes;
  std::deque<Leaf> leaves;
  Node* root;
  int64_t c[6] = {0, 0, 0, 0, 0, 0};

  Rope() {
    root = new_node();
    root->bottom = true;
    root->n = 1;
    root->ch[0].ptr = new_leaf();
  }
  Node* new_node() {
    nodes.emplace_back();
    return &nodes.back();
  }
  Leaf* new_leaf() {
    leaves.emplace_back();
    return &leaves.back();
  }
};

// rank of symbol a within the first off symbols of the leaf, and the run
// index/offset where position off falls
inline int64_t leaf_insert(Rope& R, Leaf* lf, int a, int64_t off) {
  int64_t t = 0, r = 0;
  int j = 0;
  int sym = -1;
  int64_t l = 0;
  for (; j < lf->n; ++j) {
    sym = lf->runs[j] & 7;
    l = lf->runs[j] >> 3;
    if (t + l >= off) break;
    t += l;
    if (sym == a) r += l;
  }
  if (j == lf->n) {  // insertion at the very end (off == leaf length)
    if (lf->n && (lf->runs[lf->n - 1] & 7) == a &&
        (int64_t)(lf->runs[lf->n - 1] >> 3) < MAXRUN) {
      lf->runs[lf->n - 1] += 1 << 3;
    } else {
      lf->runs[lf->n++] = (uint16_t)((1 << 3) | a);
    }
    return r;
  }
  int64_t inner = off - t;
  if (sym == a) {  // inserting into/adjacent to a run of the same symbol
    r += inner;
    if (l < MAXRUN) {
      lf->runs[j] += 1 << 3;
    } else {  // run at capacity: split into two
      memmove(lf->runs + j + 1, lf->runs + j,
              (lf->n - j) * sizeof(uint16_t));
      lf->runs[j] = (uint16_t)((1 << 3) | a);
      ++lf->n;
    }
    return r;
  }
  if (inner == 0) {
    // boundary: extend the previous run if it matches, else a new run
    if (j > 0 && (lf->runs[j - 1] & 7) == a &&
        (int64_t)(lf->runs[j - 1] >> 3) < MAXRUN) {
      lf->runs[j - 1] += 1 << 3;
    } else {
      memmove(lf->runs + j + 1, lf->runs + j,
              (lf->n - j) * sizeof(uint16_t));
      lf->runs[j] = (uint16_t)((1 << 3) | a);
      ++lf->n;
    }
    return r;
  }
  if (inner == l) {
    // boundary after run j: try run j+1
    if (j + 1 < lf->n && (lf->runs[j + 1] & 7) == a &&
        (int64_t)(lf->runs[j + 1] >> 3) < MAXRUN) {
      lf->runs[j + 1] += 1 << 3;
    } else {
      memmove(lf->runs + j + 2, lf->runs + j + 1,
              (lf->n - j - 1) * sizeof(uint16_t));
      lf->runs[j + 1] = (uint16_t)((1 << 3) | a);
      ++lf->n;
    }
    return r;
  }
  // strictly inside a foreign run: split into (sym,inner)(a,1)(sym,l-inner)
  memmove(lf->runs + j + 3, lf->runs + j + 1,
          (lf->n - j - 1) * sizeof(uint16_t));
  lf->runs[j] = (uint16_t)((inner << 3) | sym);
  lf->runs[j + 1] = (uint16_t)((1 << 3) | a);
  lf->runs[j + 2] = (uint16_t)(((l - inner) << 3) | sym);
  lf->n += 2;
  return r;
}

inline void summarize_node(Node* q, Child* out) {
  out->ptr = q;
  out->len = 0;
  for (int s = 0; s < 6; ++s) out->c[s] = 0;
  for (int i = 0; i < q->n; ++i) {
    out->len += q->ch[i].len;
    for (int s = 0; s < 6; ++s) out->c[s] += q->ch[i].c[s];
  }
}

// split full internal child p->ch[i] (a Node with n == FAN) in place
inline void split_internal(Rope& R, Node* p, int i) {
  Node* q = (Node*)p->ch[i].ptr;
  Node* q2 = R.new_node();
  q2->bottom = q->bottom;
  int half = FAN / 2;
  memcpy(q2->ch, q->ch + half, (FAN - half) * sizeof(Child));
  q2->n = FAN - half;
  q->n = half;
  memmove(p->ch + i + 2, p->ch + i + 1, (p->n - i - 1) * sizeof(Child));
  summarize_node(q, &p->ch[i]);
  summarize_node(q2, &p->ch[i + 1]);
  ++p->n;
}

// split full leaf child p->ch[i] in place
inline void split_leaf(Rope& R, Node* p, int i) {
  Leaf* lf = (Leaf*)p->ch[i].ptr;
  Leaf* lf2 = R.new_leaf();
  int half = lf->n / 2;
  memcpy(lf2->runs, lf->runs + half, (lf->n - half) * sizeof(uint16_t));
  lf2->n = lf->n - half;
  lf->n = half;
  memmove(p->ch + i + 2, p->ch + i + 1, (p->n - i - 1) * sizeof(Child));
  for (Leaf* L : {lf, lf2}) {
    Child* ch = (L == lf) ? &p->ch[i] : &p->ch[i + 1];
    ch->ptr = L;
    ch->len = 0;
    for (int s = 0; s < 6; ++s) ch->c[s] = 0;
    for (int k = 0; k < L->n; ++k) {
      ch->len += L->runs[k] >> 3;
      ch->c[L->runs[k] & 7] += L->runs[k] >> 3;
    }
  }
  ++p->n;
}

// insert symbol a after x existing symbols; returns the next insertion
// position C[<a] + rank_a(x) + 1 (reference bpr_insert_symbol contract)
int64_t insert_symbol(Rope& R, int a, int64_t x) {
  int64_t z = 0;
  for (int i = 0; i < a; ++i) z += R.c[i];
  if (R.root->n == FAN) {  // grow: new root over the old
    Node* nr = R.new_node();
    nr->bottom = false;
    nr->n = 1;
    summarize_node(R.root, &nr->ch[0]);
    R.root = nr;
  }
  Node* p = R.root;
  while (true) {
    int i = 0;
    int64_t y = 0;
    while (y + p->ch[i].len < x) {
      y += p->ch[i].len;
      z += p->ch[i].c[a];
      ++i;
    }
    if (p->bottom) {
      Leaf* lf = (Leaf*)p->ch[i].ptr;
      if (lf->n + 2 > LEAF_RUNS) {  // may grow by 2 runs per insert
        split_leaf(R, p, i);
        if (y + p->ch[i].len < x) {  // target fell into the right half
          y += p->ch[i].len;
          z += p->ch[i].c[a];
          ++i;
        }
        lf = (Leaf*)p->ch[i].ptr;
      }
      z += leaf_insert(R, lf, a, x - y);
      p->ch[i].len++;
      p->ch[i].c[a]++;
      ++R.c[a];
      return z + 1;
    }
    Node* q = (Node*)p->ch[i].ptr;
    if (q->n == FAN) {  // preemptive split keeps room one level down
      split_internal(R, p, i);
      if (y + p->ch[i].len < x) {
        y += p->ch[i].len;
        z += p->ch[i].c[a];
        ++i;
      }
      q = (Node*)p->ch[i].ptr;
    }
    p->ch[i].len++;
    p->ch[i].c[a]++;
    p = q;
    x -= y;
    // z keeps global skipped counts; x becomes subtree-relative
  }
}

void insert_string(Rope& R, const uint8_t* s, int64_t l) {
  int64_t x = R.c[0];
  for (int64_t u = l - 1; u >= 0; --u) x = insert_symbol(R, s[u], x);
  insert_symbol(R, 0, x);
}

void emit(const Rope& R, uint8_t* out) {
  // leaves left to right
  std::vector<const Node*> stk;
  std::vector<int> idx;
  stk.push_back(R.root);
  idx.push_back(0);
  int64_t at = 0;
  while (!stk.empty()) {
    const Node* p = stk.back();
    int& i = idx.back();
    if (i == p->n) {
      stk.pop_back();
      idx.pop_back();
      if (!idx.empty()) ++idx.back();
      continue;
    }
    if (p->bottom) {
      const Leaf* lf = (const Leaf*)p->ch[i].ptr;
      for (int k = 0; k < lf->n; ++k) {
        memset(out + at, lf->runs[k] & 7, lf->runs[k] >> 3);
        at += lf->runs[k] >> 3;
      }
      ++i;
    } else {
      stk.push_back((const Node*)p->ch[i].ptr);
      idx.push_back(0);
    }
  }
}

}  // namespace

extern "C" {

// Multi-string BWT via incremental B+-rope insertion.  seqs: concatenated
// nt6 reads without sentinels; offsets[n_reads+1]; reads inserted in order
// (sentinel ranks == insertion order).  out must hold total_len + n_reads
// bytes.  Returns the BWT length written, or -1 when memory ran out.
int64_t fbpr_build(const uint8_t* seqs, const int64_t* offsets,
                   int64_t n_reads, uint8_t* out) {
  try {
    Rope R;
    for (int64_t r = 0; r < n_reads; ++r)
      insert_string(R, seqs + offsets[r], offsets[r + 1] - offsets[r]);
    emit(R, out);
    int64_t total = 0;
    for (int s = 0; s < 6; ++s) total += R.c[s];
    return total;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // extern "C"
