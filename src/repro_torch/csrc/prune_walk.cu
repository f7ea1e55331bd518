// The serial prune sweep of the policy-routed walk, every candidate in one
// launch.
//
// Replaces, for the prune (`prune_scheme_replicas`), the per-candidate
// launches of the TPU kernels `routed_walk_pallas` and, under
// nearest_copy_dp, `scored_walk_pallas` (src/repro/kernels/routed_walk.py)
// that the JAX package makes through `routed_counts`: for each candidate
// replica (v, s) in prune order, clear its bit, re-walk every path that
// contains v under the policy, and restore the bit when one of them exceeds
// its budget.  The routed walk is routed_walk.cu's (`walk_path`,
// walk_common.cuh); the scored instance (`prune_walk_scored_launch`) walks
// with nearest_copy_dp's scored pick instead (`dp_gate`, walk_common.cuh),
// rebuilding each path's DP hop values from the current words inside the
// walk.  Both start at home[objects[p, 0]] and count the non-local
// positions 1 .. len - 1, as `gate_counts` does.  keep[c] = 1 when the
// removal stays.  Any L and W: the routed instance stages its rank vector
// in shared memory up to kMaxStagedRank servers and reads it from device
// memory past that, as routed_walk.cu does.
//
// Design: one block of 1024 threads runs the whole chain of dependent
// decisions (`prune_loop`), so the words stay coherent without a grid-wide
// barrier and no host round trip separates two candidates.  Per candidate:
// thread 0 clears the bit, a barrier publishes it, the threads stride over
// the candidate's CSR rows (duplicates are harmless to a violation test)
// and walk each path, stopping once its count passes its budget;
// __syncthreads_or gives the verdict, and thread 0 restores the bit on a
// violation.  Only thread 0 writes the words, so it keeps the value of the
// word it edits in a register and loads the next candidate's word during
// the walk; every thread loads the next candidate's object, server and CSR
// range during the walk too.  The prune's working set (the words, the CSR
// index and the paths: ~14 MB at SNB scale 10) sits in the 50 MB L2.  The
// bound is neither bytes nor operations but latency: each decision's
// dependent reads (row, objects, homes and words), the single-thread walk
// of each of its paths, and two barriers across the block's 32 warps.
//
// The scored walk's scores are per path: a holder's score at position i is
// a hop value at its first miss in the window after i (walk_common.cuh), so
// one thread keeps the path's hop values G (at most L ints, rebuilt when the
// window end moves: once per path for the full suffix) and evaluates only
// the holders its picks meet, from AND-chains of the path's words; the
// TPU kernel's f32 [P, L, W*32] score plane is never built.  Its cost per
// path is O(len^2 * W) word operations (O(len * k^2 * W) at depth k).  For
// L <= 8 and W == 1 each position's word is staged per thread first; else
// the words are re-read with __ldcg.  G is a per-thread array of kDpMaxL
// ints for L <= kDpMaxL; a longer path keeps it in its thread's slice of
// a [1024, L] device scratch (`gscratch`, from the wrapper).  Its bound
// is latency too: the
// bytes it must move (the routed sweep's, less the rank vector; counted by
// chip_smoke.py's `prune_bytes`) take microseconds at the memory rate, far
// below the chain of dependent decisions.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

constexpr int kThreads = 1024;
// the scored instance's longest path with its hop values in a per-thread
// array (longer paths keep them in the device scratch)
constexpr int kDpMaxL = 64;

// `words` is written by this kernel (thread 0 clears and restores bits),
// so it is neither const nor __restrict__ and every read of it is an
// __ldcg: the non-coherent read-only path (ld.global.nc, which const
// __restrict__ would allow the compiler to use) may return a value cached
// before the last store, while an L2 read after the barrier sees it.
//
// The candidate loop shared by both instances: `violates(p)` walks path p
// against the current words and says whether it exceeds its budget.
template <class Violates>
__device__ __forceinline__ void prune_loop(const int32_t* __restrict__ cand_v,
                                           const int32_t* __restrict__ cand_s, int C,
                                           const int32_t* __restrict__ starts,
                                           const int32_t* __restrict__ rows,
                                           uint32_t* words, int W,
                                           uint8_t* __restrict__ keep, Violates&& violates) {
  const int tid = threadIdx.x;
  // the candidate in hand and its CSR row range
  int v = cand_v[0], s = cand_s[0];
  int b = starts[v], e = starts[v + 1];
  // thread 0: the value of the candidate's word before its clear
  uint32_t cell = tid == 0 ? __ldcg(words + static_cast<int64_t>(v) * W + (s >> 5)) : 0u;
  for (int c = 0; c < C; ++c) {
    uint32_t* const wp = words + static_cast<int64_t>(v) * W + (s >> 5);
    const uint32_t bit = 1u << (s & 31);
    if (tid == 0) *wp = cell & ~bit;
    __syncthreads();  // the clear (and, at c = 0, any staged ranks) before any walk
    int nv = v, ns = s, nb = 0, ne = 0;
    uint32_t ncell = 0;
    if (c + 1 < C) {
      nv = cand_v[c + 1];
      ns = cand_s[c + 1];
      nb = starts[nv];
      ne = starts[nv + 1];
      if (tid == 0) ncell = __ldcg(words + static_cast<int64_t>(nv) * W + (ns >> 5));
    }
    int bad = 0;
    for (int k = b + tid; k < e && !bad; k += blockDim.x) bad = violates(rows[k]);
    bad = __syncthreads_or(bad);
    if (tid == 0) {
      const uint32_t cur = bad ? (cell | bit) : (cell & ~bit);
      if (bad) *wp = cur;
      keep[c] = bad ? 0 : 1;
      // the next word is this one when both candidates share it: its load
      // may predate the restore
      cell = (nv == v && (ns >> 5) == (s >> 5)) ? cur : ncell;
    }
    v = nv;
    s = ns;
    b = nb;
    e = ne;
  }
}

template <bool HOME_FIRST, bool LOOKAHEAD, int LR>
__global__ void __launch_bounds__(kThreads, 1)
prune_walk_kernel(const int32_t* __restrict__ cand_v, const int32_t* __restrict__ cand_s,
                  int C, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ rows, const int32_t* __restrict__ objects,
                  const int32_t* __restrict__ lengths, const int32_t* __restrict__ t_path,
                  uint32_t* words, const int32_t* __restrict__ home,
                  const float* __restrict__ rank, int L, int W,
                  uint8_t* __restrict__ keep) {
  extern __shared__ float s_rank[];
  // the loop's first barrier publishes the staged ranks
  const bool staged = !HOME_FIRST && (W << 5) <= kMaxStagedRank;
  if (staged)
    for (int s = threadIdx.x; s < (W << 5); s += blockDim.x) s_rank[s] = rank[s];
  const float* rk = staged ? s_rank : rank;
  prune_loop(cand_v, cand_s, C, starts, rows, words, W, keep, [&](int p) {
    const int len = min(lengths[p], L);
    const int t = t_path[p];
    const int32_t* obj = objects + static_cast<int64_t>(p) * L;
    int h = 0;
    walk_path<HOME_FIRST, LOOKAHEAD, LR, true>(
        obj, L, len, len, words, W, home, home[max(obj[0], 0)], rk,
        [&](int, int, bool loc) {
          h += loc ? 0 : 1;
          return h <= t;
        });
    return h > t ? 1 : 0;
  });
}

// the scored instance: G holds GN ints (GN >= L), or, with GN == 0, L ints
// of `gscratch` per thread; LR > 0 stages the W == 1 words of the first LR
// positions (L <= LR)
template <int GN, int LR>
__global__ void __launch_bounds__(kThreads, 1)
prune_walk_scored_kernel(const int32_t* __restrict__ cand_v,
                         const int32_t* __restrict__ cand_s, int C,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ rows,
                         const int32_t* __restrict__ objects,
                         const int32_t* __restrict__ lengths,
                         const int32_t* __restrict__ t_path, uint32_t* words,
                         const int32_t* __restrict__ home, int L, int W, int depth,
                         int* __restrict__ gscratch, uint8_t* __restrict__ keep) {
  prune_loop(cand_v, cand_s, C, starts, rows, words, W, keep, [&](int p) {
    const int len = min(lengths[p], L);
    const int t = t_path[p];
    const int32_t* obj = objects + static_cast<int64_t>(p) * L;
    const int start = home[max(obj[0], 0)];
    int h;
    if constexpr (LR > 0) {
      int G[GN];
      StagedWords<LR> st;
      st.template stage<true>(obj, words, L, len);
      h = dp_gate(st, obj, len, depth, home, start, t, G);
    } else if constexpr (GN > 0) {
      int G[GN];
      h = dp_gate(PathWords<true>{obj, words, W}, obj, len, depth, home, start, t, G);
    } else {
      h = dp_gate(PathWords<true>{obj, words, W}, obj, len, depth, home, start, t,
                  gscratch + static_cast<int64_t>(threadIdx.x) * L);
    }
    return h > t ? 1 : 0;
  });
}

template <bool HOME_FIRST, bool LOOKAHEAD>
void launch(const void* cand_v, const void* cand_s, int C, const void* starts,
            const void* rows, const void* objects, const void* lengths,
            const void* t_path, void* words, const void* home, const void* rank, int L,
            int W, void* keep, cudaStream_t stream) {
  const size_t smem =
      HOME_FIRST || (W << 5) > kMaxStagedRank ? 0 : sizeof(float) * (W << 5);
  const auto* cv = static_cast<const int32_t*>(cand_v);
  const auto* cs = static_cast<const int32_t*>(cand_s);
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* rw = static_cast<const int32_t*>(rows);
  const auto* ob = static_cast<const int32_t*>(objects);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* tp = static_cast<const int32_t*>(t_path);
  auto* wd = static_cast<uint32_t*>(words);
  const auto* hm = static_cast<const int32_t*>(home);
  const auto* rk = static_cast<const float*>(rank);
  auto* kp = static_cast<uint8_t*>(keep);
  // the register bucket stages one word per object (W == 1) for L <= 8
  if (L <= 8 && W == 1) {
    prune_walk_kernel<HOME_FIRST, LOOKAHEAD, 8><<<1, kThreads, smem, stream>>>(
        cv, cs, C, st, rw, ob, ln, tp, wd, hm, rk, L, W, kp);
  } else {
    prune_walk_kernel<HOME_FIRST, LOOKAHEAD, 0><<<1, kThreads, smem, stream>>>(
        cv, cs, C, st, rw, ob, ln, tp, wd, hm, rk, L, W, kp);
  }
}

}  // namespace

extern "C" int prune_walk_launch(const void* cand_v, const void* cand_s, int C,
                                 const void* starts, const void* rows, const void* objects,
                                 const void* lengths, const void* t_path, void* words,
                                 const void* home, const void* rank, int L, int W,
                                 int home_first, int lookahead, void* keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (home_first) {
    launch<true, false>(cand_v, cand_s, C, starts, rows, objects, lengths, t_path, words,
                        home, rank, L, W, keep, s);
  } else if (lookahead) {
    launch<false, true>(cand_v, cand_s, C, starts, rows, objects, lengths, t_path, words,
                        home, rank, L, W, keep, s);
  } else {
    launch<false, false>(cand_v, cand_s, C, starts, rows, objects, lengths, t_path, words,
                         home, rank, L, W, keep, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int prune_walk_scored_launch(const void* cand_v, const void* cand_s, int C,
                                        const void* starts, const void* rows,
                                        const void* objects, const void* lengths,
                                        const void* t_path, void* words, const void* home,
                                        int L, int W, int depth, void* gscratch,
                                        void* keep, void* stream) {
  // a path past kDpMaxL positions keeps its hop values in gscratch
  // (kThreads * L ints)
  if (L > kDpMaxL && gscratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cv = static_cast<const int32_t*>(cand_v);
  const auto* cs = static_cast<const int32_t*>(cand_s);
  const auto* sp = static_cast<const int32_t*>(starts);
  const auto* rw = static_cast<const int32_t*>(rows);
  const auto* ob = static_cast<const int32_t*>(objects);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* tp = static_cast<const int32_t*>(t_path);
  auto* wd = static_cast<uint32_t*>(words);
  const auto* hm = static_cast<const int32_t*>(home);
  auto* kp = static_cast<uint8_t*>(keep);
  auto* gs = static_cast<int*>(gscratch);
  if (L <= 8 && W == 1) {
    prune_walk_scored_kernel<8, 8><<<1, kThreads, 0, st>>>(cv, cs, C, sp, rw, ob, ln, tp, wd,
                                                          hm, L, W, depth, gs, kp);
  } else if (L <= kDpMaxL) {
    prune_walk_scored_kernel<kDpMaxL, 0><<<1, kThreads, 0, st>>>(
        cv, cs, C, sp, rw, ob, ln, tp, wd, hm, L, W, depth, gs, kp);
  } else {
    prune_walk_scored_kernel<0, 0><<<1, kThreads, 0, st>>>(cv, cs, C, sp, rw, ob, ln, tp, wd,
                                                          hm, L, W, depth, gs, kp);
  }
  return static_cast<int>(cudaGetLastError());
}
