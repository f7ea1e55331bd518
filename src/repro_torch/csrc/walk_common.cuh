// The remote-hop holder pick and the routed-walk step shared by the walk
// kernels (routed_walk.cu, prune_walk.cu, scored_walk.cu,
// provision_update.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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
// home wins a tie with the minimum, then the lowest id.  `rank` is indexed
// by server id: a shared load vector or one path's score row.  -1 when no
// bit is set.  The set bits are walked in ascending order with __ffs and
// only a strictly lower rank replaces the best, so the lowest id among the
// minima is kept, as the TPU kernel's argmax over `lv <= min` is.
template <bool MASKED, class Row>
__device__ __forceinline__ int pick_rows(const Row& row, const Row& mask, int home,
                                         const float* rank) {
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
