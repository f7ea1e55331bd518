// The remote-hop holder pick, the routed-walk step and the nearest_copy_dp
// gate walk shared by the walk kernels (routed_walk.cu, prune_walk.cu,
// scored_walk.cu, provision_update.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// The longest rank vector (floats, one per server) a walk kernel stages in
// shared memory: 48 KiB, what a launch gets without opting in.  Past it
// the kernels read the rank from device memory.
constexpr int kMaxStagedRank = 12288;

// One object's W holder words in device memory.  CG loads them with
// __ldcg (L2 only, coherent with stores made earlier in the same kernel);
// otherwise a plain load, for words no thread of the kernel writes.
template <bool CG>
struct PtrRow {
  const uint32_t* p;
  int W;
  __device__ __forceinline__ uint32_t operator[](int w) const {
    return CG ? __ldcg(p + w) : p[w];
  }
  __device__ __forceinline__ int width() const { return W; }
};

// One object's single holder word (W == 1) staged in a register.
struct RegRow {
  uint32_t w;
  __device__ __forceinline__ uint32_t operator[](int) const { return w; }
  __device__ __forceinline__ int width() const { return 1; }
};

// Lowest-rank holder among the set bits of row[w] (& mask[w] when MASKED);
// home wins a tie with the minimum, then the lowest id.  `rank[s]` is
// indexed by server id: a shared load vector, one path's score row, or a
// functor that computes the score (DpScore).  -1 when no bit is set.  The
// set bits are walked in ascending order with __ffs and only a strictly
// lower rank replaces the best, so the lowest id among the minima is kept,
// as the TPU kernel's argmax over `lv <= min` is.
template <bool MASKED, class Row, class Rank>
__device__ __forceinline__ int pick_rows(const Row& row, const Row& mask, int home,
                                         const Rank& rank) {
  const int W = row.width();
  int best_id = -1;
  float best = 0.0f;
  for (int w = 0; w < W; ++w) {
    uint32_t bits = row[w] & (MASKED ? mask[w] : 0xFFFFFFFFu);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const int s = (w << 5) + b;
      const float l = rank[s];
      if (best_id < 0 || l < best) {
        best = l;
        best_id = s;
      }
    }
  }
  if (best_id >= 0 && home >= 0 && home < (W << 5)) {
    const uint32_t hw = row[home >> 5] & (MASKED ? mask[home >> 5] : 0xFFFFFFFFu);
    if (((hw >> (home & 31)) & 1u) && rank[home] <= best) return home;
  }
  return best_id;
}

// pick_rows over words in device memory; `mask` may be null.
__device__ __forceinline__ int pick_holder(const uint32_t* row, const uint32_t* mask, int W,
                                           int home, const float* rank) {
  const PtrRow<false> r{row, W};
  return mask ? pick_rows<true>(r, PtrRow<false>{mask, W}, home, rank)
              : pick_rows<false>(r, r, home, rank);
}

// One step of the policy-routed walk at a valid position i >= 1: the hop
// is local when server >= 0 and the server's bit of object i is set (a -1
// server is never local); otherwise the target is `home` (HOME_FIRST) or
// the holder pick, trying the holders of both object i and object i + 1
// first under LOOKAHEAD when `has_next` (i + 1 < len).  `row` holds object
// i's words, `nrow` object i + 1's (read only when has_next), `home` object
// i's home.  Returns the server after the step and sets `local`.
template <bool HOME_FIRST, bool LOOKAHEAD, class Row>
__device__ __forceinline__ int routed_step(int server, const Row& row, const Row& nrow,
                                           bool has_next, int home, const float* rank,
                                           bool& local) {
  if (server >= 0 && ((row[server >> 5] >> (server & 31)) & 1u)) {
    local = true;
    return server;
  }
  local = false;
  if (HOME_FIRST) return home;
  int tgt = -1;
  if (LOOKAHEAD && has_next) tgt = pick_rows<true>(row, nrow, home, rank);
  if (tgt < 0) tgt = pick_rows<false>(row, row, home, rank);
  return tgt;
}

// Walks positions 1 .. n - 1 of one path (`obj`, L entries; its length
// len <= n <= L) from `server`, calling visit(i, server, local) after each
// step; a position at or past len keeps the server and is not local.
// Stops when visit returns false.  Each step's inputs (the words of
// objects i and i + 1 and home[i]) do not depend on the server, so they are
// loaded before the server-dependent chain: with LR > 0 (L <= LR, W == 1)
// the whole path's object ids (all L of them, without waiting for len),
// then its homes and words are staged in registers first; with LR == 0
// each step loads its inputs before its local test.  CG: the words are
// written by the kernel itself (see PtrRow).
template <bool HOME_FIRST, bool LOOKAHEAD, int LR, bool CG, class Visit>
__device__ __forceinline__ void walk_path(const int32_t* obj, int L, int len, int n,
                                          const uint32_t* words, int W,
                                          const int32_t* __restrict__ home, int server,
                                          const float* rank, Visit&& visit) {
  if constexpr (LR > 0) {
    int o[LR];
    int hm[LR];
    RegRow rows[LR];
#pragma unroll
    for (int i = 1; i < LR; ++i) o[i] = i < L ? max(obj[i], 0) : 0;
#pragma unroll
    for (int i = 1; i < LR; ++i) {
      const bool ok = i < len;
      hm[i] = ok ? home[o[i]] : -1;
      const uint32_t* p = words + o[i];
      rows[i].w = ok ? (CG ? __ldcg(p) : *p) : 0u;
    }
#pragma unroll
    for (int i = 1; i < LR; ++i) {
      if (i >= n) return;
      bool loc = false;
      if (i < len)
        server = routed_step<HOME_FIRST, LOOKAHEAD>(server, rows[i], rows[i + 1 < LR ? i + 1 : i],
                                                    i + 1 < len, hm[i], rank, loc);
      if (!visit(i, server, loc)) return;
    }
  } else {
    for (int i = 1; i < n; ++i) {
      bool loc = false;
      if (i < len) {
        const int v = max(obj[i], 0);
        const bool has_next = i + 1 < len;
        const int nv = has_next ? max(obj[i + 1], 0) : v;
        const int h = home[v];
        const PtrRow<CG> row{words + static_cast<int64_t>(v) * W, W};
        const PtrRow<CG> nrow{words + static_cast<int64_t>(nv) * W, W};
        server = routed_step<HOME_FIRST, LOOKAHEAD>(server, row, nrow, has_next, h, rank, loc);
      }
      if (!visit(i, server, loc)) return;
    }
  }
}

// ---------------------------------------------------------------------------
// The nearest_copy_dp gate walk, its scores rebuilt from the words.
//
// E[p, i, s] (backends._dp_score_tables) depends only on the words of path
// p's own objects, so no [L, W*32] score plane is needed.  With the window
// (i, e] of walk position i (e = len - 1 for the full suffix, min(i + k,
// len - 1) at depth k), a server's score at i is the hop value G[j] at the
// first position j in (i, e] whose object it does not hold, or 0 when it
// holds them all; G[j] is 1 + the least score at j among the holders of
// object j (their first miss in (j, e]), or 1 + G[j + 1] (0 past e) when
// object j has no holder: the dead state of the DP's D plane.  G depends
// only on e, so a walk rebuilds it only when e moves (once for the full
// suffix).  The AND-chains of the holder words give each holder's first
// miss a word at a time.
// ---------------------------------------------------------------------------

// The words of one path's objects by position: rows(j, w) is word w of
// object obj[j] (CG: read with __ldcg, see PtrRow).
template <bool CG>
struct PathWords {
  const int32_t* obj;
  const uint32_t* words;
  int W;
  __device__ __forceinline__ uint32_t operator()(int j, int w) const {
    const uint32_t* p = words + static_cast<int64_t>(max(obj[j], 0)) * W + w;
    return CG ? __ldcg(p) : *p;
  }
  __device__ __forceinline__ int width() const { return W; }
};

// W == 1: the single word of each of the first N positions, staged per
// thread (positions at or past len hold 0 and are never read).
template <int N>
struct StagedWords {
  uint32_t r[N];
  template <bool CG>
  __device__ __forceinline__ void stage(const int32_t* obj, const uint32_t* words, int L,
                                        int len) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint32_t* p = words + (j < L ? max(obj[j], 0) : 0);
      r[j] = j < len ? (CG ? __ldcg(p) : *p) : 0u;
    }
  }
  __device__ __forceinline__ uint32_t operator()(int j, int) const { return r[j]; }
  __device__ __forceinline__ int width() const { return 1; }
};

// Position i of a PathWords / StagedWords as a Row for pick_rows.
template <class Rows>
struct PosRow {
  const Rows& rows;
  int i;
  __device__ __forceinline__ uint32_t operator[](int w) const { return rows(i, w); }
  __device__ __forceinline__ int width() const { return rows.width(); }
};

// G[j] for j = e down to lo + 1 (see above).
template <class Rows>
__device__ __forceinline__ void dp_hops(const Rows& rows, int lo, int e, int* G) {
  const int W = rows.width();
  for (int j = e; j > lo; --j) {
    int best = -1;  // the least score among the holders of object j
    for (int w = 0; w < W && best != 0; ++w) {
      uint32_t a = rows(j, w);
      if (!a) continue;
      for (int k = j + 1; k <= e && a; ++k) {
        const uint32_t r = rows(k, w);
        if ((a & ~r) && (best < 0 || G[k] < best)) best = G[k];
        a &= r;
      }
      if (a) best = 0;  // a holder of every later object in the window
    }
    G[j] = 1 + (best >= 0 ? best : (j < e ? G[j + 1] : 0));
  }
}

// The score of server s at walk position i over the window (i, e].
template <class Rows>
struct DpScore {
  const Rows& rows;
  const int* G;
  int i, e;
  __device__ __forceinline__ float operator[](int s) const {
    const int w = s >> 5;
    const uint32_t b = 1u << (s & 31);
    for (int k = i + 1; k <= e; ++k)
      if (!(rows(k, w) & b)) return static_cast<float>(G[k]);
    return 0.0f;
  }
};

// The gate count of one path under nearest_copy_dp (depth < 0: the full
// suffix): the non-local positions 1 .. len - 1 of the scored walk from
// `server` (home[objects[p, 0]]), stopping once the count passes t.  A hop
// picks the holder with the lowest score, home (`home[obj[i]]`) winning
// ties, then the lowest id, -1 with no holder; a -1 server is never local.
// G holds at least len ints.
template <class Rows>
__device__ __forceinline__ int dp_gate(const Rows& rows, const int32_t* obj, int len,
                                       int depth, const int32_t* __restrict__ home,
                                       int server, int t, int* G) {
  int h = 0;
  int have = -1;  // the window end G was built for
  for (int i = 1; i < len; ++i) {
    const PosRow<Rows> row{rows, i};
    if (server >= 0 && ((row[server >> 5] >> (server & 31)) & 1u)) continue;
    const int e = depth < 0 ? len - 1 : min(i + depth, len - 1);
    if (e != have) {
      dp_hops(rows, i, e, G);
      have = e;
    }
    server = pick_rows<false>(row, row, home[max(obj[i], 0)], DpScore<Rows>{rows, G, i, e});
    if (++h > t) break;
  }
  return h;
}
