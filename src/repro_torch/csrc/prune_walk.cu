// The serial prune sweep of the policy-routed walk, every candidate in one
// launch.
//
// Replaces, for the prune (`prune_scheme_replicas`, fused=False), the
// per-candidate launches of the TPU kernel `routed_walk_pallas`
// (src/repro/kernels/routed_walk.py) that the JAX package makes through
// `routed_counts`: for each candidate replica (v, s) in prune order, clear
// its bit, re-walk every path that contains v under the policy, and
// restore the bit when one of them exceeds its budget.  The walk is
// routed_walk.cu's (`walk_path`, walk_common.cuh), started at
// home[objects[p, 0]] and counting the non-local positions 1 .. len - 1,
// as `gate_counts` does.  keep[c] = 1 when the removal stays.
//
// Design: one block of 1024 threads runs the whole chain of dependent
// decisions, so the words stay coherent without a grid-wide barrier and no
// host round trip separates two candidates.  Per candidate: thread 0
// clears the bit, a barrier publishes it, the threads stride over the
// candidate's CSR rows (duplicates are harmless to a violation test) and
// walk each path, stopping once its count passes its budget;
// __syncthreads_or gives the verdict, and thread 0 restores the bit on a
// violation.  Only thread 0 writes the words, so it keeps the value of the
// word it edits in a register and loads the next candidate's word during
// the walk; every thread loads the next candidate's object, server and CSR
// range during the walk too.  The prune's working set (the words, the CSR
// index and the paths: ~14 MB at SNB scale 10) sits in the 50 MB L2.  The
// bound is neither bytes nor operations but latency: each decision's
// dependent reads (row, objects, homes and words), the single-thread walk
// of each of its paths, and two barriers across the block's 32 warps.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

constexpr int kThreads = 1024;

// `words` is written by this kernel (thread 0 clears and restores bits),
// so it is neither const nor __restrict__ and every read of it is an
// __ldcg: the non-coherent read-only path (ld.global.nc, which const
// __restrict__ would allow the compiler to use) may return a value cached
// before the last store, while an L2 read after the barrier sees it.
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
  const int tid = threadIdx.x;
  if (!HOME_FIRST)
    for (int s = tid; s < (W << 5); s += blockDim.x) s_rank[s] = rank[s];
  // the candidate in hand and its CSR row range
  int v = cand_v[0], s = cand_s[0];
  int b = starts[v], e = starts[v + 1];
  // thread 0: the value of the candidate's word before its clear
  uint32_t cell = tid == 0 ? __ldcg(words + static_cast<int64_t>(v) * W + (s >> 5)) : 0u;
  for (int c = 0; c < C; ++c) {
    uint32_t* const wp = words + static_cast<int64_t>(v) * W + (s >> 5);
    const uint32_t bit = 1u << (s & 31);
    if (tid == 0) *wp = cell & ~bit;
    __syncthreads();  // the clear (and, at c = 0, the staged ranks) before any walk
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
    for (int k = b + tid; k < e && !bad; k += blockDim.x) {
      const int p = rows[k];
      const int len = min(lengths[p], L);
      const int t = t_path[p];
      const int32_t* obj = objects + static_cast<int64_t>(p) * L;
      int h = 0;
      walk_path<HOME_FIRST, LOOKAHEAD, LR, true>(
          obj, L, len, len, words, W, home, home[max(obj[0], 0)], s_rank,
          [&](int, int, bool loc) {
            h += loc ? 0 : 1;
            return h <= t;
          });
      bad = h > t;
    }
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

template <bool HOME_FIRST, bool LOOKAHEAD>
void launch(const void* cand_v, const void* cand_s, int C, const void* starts,
            const void* rows, const void* objects, const void* lengths,
            const void* t_path, void* words, const void* home, const void* rank, int L,
            int W, void* keep, cudaStream_t stream) {
  const size_t smem = HOME_FIRST ? 0 : sizeof(float) * (W << 5);
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
