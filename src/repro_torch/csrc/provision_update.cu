// One fused greedy UPDATE round (paper Alg 2 hot loop) over a batch of paths.
//
// Replaces the TPU kernel `fused_update_pallas`
// (src/repro/kernels/provision_update.py, `_make_kernel`).  Per path, against
// one snapshot of the packed words:
//   1. the policy-routed gate walk h(p, r, rho; policy) (GATE_ROUTED: the
//      routed_walk.cu pick over a shared rank vector, optional lookahead;
//      GATE_SCORED: the scored_walk.cu pick over the path's DP score rows);
//   2. the server-local subpath structure under d (Def 5.1): seg per
//      position, h, and the server srv[k] of each subpath;
//   3. needed(x, k): object x has no copy at srv[k] yet;
//   4. every C(h, t) candidate's additions (x -> k for j(seg_x) <= k < seg_x)
//      and their float32 cost, with a strict argmin (ties -> lowest index).
// Integer semantics follow the TPU kernel exactly (srv[k] from positions
// with seg == k, h clipped to Hp1 - 1, n_cand = counts[h] or 0 beyond Hc).
//
// Cost order: each candidate sums f over its additions x-major over
// [L, Hp1] with __fadd_rn (no FMA contraction), the order the plain torch
// version (`fused_update_plain`) uses, so kernel and plain agree exactly.
//
// Design for Hopper: one warp per path.  The TPU kernel keeps a
// [L, Hp1, 128] plane per candidate in VMEM; here the per-path state lives
// in a small per-warp scratch in shared memory (homes, segments, sizes, one
// 64-bit `needed` mask per position), lanes stride over the candidates,
// each lane keeps its best (cost, index) and a shuffle reduction takes the
// strict argmin.  Only the winner's additions are rebuilt and written as
// `chosen`.  The gate walk is sequential (one lane).  The additions are
// then applied by a second, tiny kernel on the same stream with atomicOr:
// every path priced against the same snapshot first (the lock-free
// batch semantics), then the bits flip; OR is idempotent, so duplicate
// pairs give the same words as the plain version's scatter-OR.
//
// Bound on the card: mostly bytes (objects, the touched words, homes and
// sizes, the chosen plane); the candidate loop does sum_b n_cand(h_b) * L
// integer mask operations, which stays far below the card's integer rate
// at the C(h, t) sizes the greedy vectorises (C <= 2048).
//
// Limits: L <= 64 and Hp1 <= 64 (one 64-bit mask per position), W <= 64
// (the rank vector in shared memory); the wrapper checks L and W and cuts
// wider tables to Hp1 <= L (h <= L - 1, so later columns are never read).

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

constexpr int kMaxL = 64;
constexpr int kMaxH = 64;
constexpr int kWarps = 4;  // paths per block
constexpr float kInf = 1e30f;

enum Gate { GATE_NONE = 0, GATE_ROUTED = 1, GATE_SCORED = 2 };

struct WarpScratch {
  int obj[kMaxL];               // max(object, 0)
  int home[kMaxL];              // shard[obj] at valid positions, else -1
  int seg[kMaxL];               // subpath index (valid) or -1
  float fpos[kMaxL];            // f[obj] at valid positions, else 0
  unsigned long long need[kMaxL];  // bit k: needed(x, k); reused for add
  int srv[kMaxH];               // server of subpath k, -1 when absent
  int h, gate_ok, skipped;
};

__device__ __forceinline__ unsigned long long low_mask(int n) {
  return n >= 64 ? ~0ull : ((1ull << n) - 1ull);
}

__device__ __forceinline__ bool has_bit(const uint32_t* row, int s) {
  return (row[s >> 5] >> (s & 31)) & 1u;
}

// Selection mask of candidate c for h_cl: bit k set iff tables[h_cl, c, k].
__device__ __forceinline__ unsigned long long sel_mask(const uint8_t* tables,
                                                       int h_cl, int c, int C,
                                                       int Hp1) {
  const uint8_t* tab = tables + (static_cast<int64_t>(h_cl) * C + c) * Hp1;
  unsigned long long sel = 0;
  for (int k = 0; k < Hp1; ++k)
    if (tab[k]) sel |= 1ull << k;
  return sel;
}

// Additions of position x under selection `sel`: k in [max(j, 0), seg_cl)
// where j is the largest selected subpath index <= seg_cl (-1 if none).
__device__ __forceinline__ unsigned long long add_mask(unsigned long long sel,
                                                       int seg_cl,
                                                       unsigned long long need) {
  const unsigned long long low = sel & low_mask(seg_cl + 1);
  const int lo = low ? 63 - __clzll(static_cast<long long>(low)) : 0;
  return low_mask(seg_cl) & ~low_mask(lo) & need;
}

template <int GATE, bool LOOKAHEAD>
__global__ void __launch_bounds__(kWarps * 32)
fused_update_kernel(const int32_t* __restrict__ objects,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ shard,
                    const float* __restrict__ f,
                    const uint8_t* __restrict__ tables,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ t,
                    const float* __restrict__ rank,
                    const uint32_t* __restrict__ words, int B, int L, int W,
                    int Hc, int C, int Hp1, uint8_t* __restrict__ chosen,
                    int32_t* __restrict__ srv_out, float* __restrict__ cost_out,
                    uint8_t* __restrict__ nosol_out,
                    uint8_t* __restrict__ skip_out) {
  __shared__ WarpScratch scratch[kWarps];
  extern __shared__ float s_rank[];
  const int Sp = W << 5;
  if (GATE == GATE_ROUTED) {
    for (int s = threadIdx.x; s < Sp; s += blockDim.x) s_rank[s] = rank[s];
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  WarpScratch& sh = scratch[warp];
  const int64_t base = static_cast<int64_t>(b) * L;
  const int len = lengths[b];

  // ---- per-position gathers ----
  for (int x = lane; x < L; x += 32) {
    const int v = max(objects[base + x], 0);
    const bool valid = x < len;
    sh.obj[x] = v;
    sh.home[x] = valid ? shard[v] : -1;
    sh.fpos[x] = __fmul_rn(f[v], valid ? 1.0f : 0.0f);
  }
  __syncwarp();

  // ---- subpaths (Def 5.1) and the gate walk: one lane ----
  if (lane == 0) {
    int cnt = 0;
    int prev = -2;
    for (int x = 0; x < L; ++x) {
      const bool valid = x < len;
      if (valid && x > 0 && sh.home[x] != prev) ++cnt;
      sh.seg[x] = valid ? cnt : -1;
      prev = sh.home[x];
    }
    const int h = len > 0 ? sh.seg[len - 1] : 0;
    for (int k = 0; k < Hp1; ++k) sh.srv[k] = -1;
    for (int x = 0; x < len; ++x) {
      const int k = sh.seg[x];
      if (k < Hp1) sh.srv[k] = max(sh.srv[k], sh.home[x]);
    }
    int h_routed = 0;
    if (GATE != GATE_NONE) {
      int server = len > 0 ? shard[max(objects[base], 0)] : 0;
      for (int i = 1; i < len; ++i) {
        const uint32_t* row = words + static_cast<int64_t>(sh.obj[i]) * W;
        if (server >= 0 && has_bit(row, server)) continue;
        ++h_routed;
        if (GATE == GATE_SCORED) {
          server = pick_holder(row, nullptr, W, sh.home[i],
                               rank + (base + i) * Sp);
        } else {
          int tgt = -1;
          if (LOOKAHEAD && i + 1 < len)
            tgt = pick_holder(row, words + static_cast<int64_t>(sh.obj[i + 1]) * W,
                              W, sh.home[i], s_rank);
          if (tgt < 0) tgt = pick_holder(row, nullptr, W, sh.home[i], s_rank);
          server = tgt;
        }
      }
    }
    const int tb = t[b];
    const bool over = h > tb;
    sh.h = h;
    sh.gate_ok = over && (GATE == GATE_NONE || h_routed > tb);
    sh.skipped = GATE != GATE_NONE && over && h_routed <= tb;
  }
  __syncwarp();

  // ---- needed(x, k): no copy of object x at srv[k] in the snapshot ----
  for (int x = lane; x < L; x += 32) {
    unsigned long long m = 0;
    if (x < len) {
      const uint32_t* row = words + static_cast<int64_t>(sh.obj[x]) * W;
      for (int k = 0; k < Hp1; ++k) {
        const int s = sh.srv[k];
        if (s >= 0 && !has_bit(row, s)) m |= 1ull << k;
      }
    }
    sh.need[x] = m;
  }
  __syncwarp();

  // ---- candidates: lanes stride, strict argmin, ties -> lowest index ----
  const int h_cl = min(max(sh.h, 0), Hp1 - 1);
  const int n_cand = h_cl < Hc ? min(counts[h_cl], C) : 0;
  float best = kInf;
  int best_c = C;
  if (!sh.gate_ok) {
    // empty windows: every candidate costs 0, the first one wins
    if (n_cand > 0) {
      best = 0.0f;
      best_c = 0;
    }
  } else {
    for (int c = lane; c < n_cand; c += 32) {
      const unsigned long long sel = sel_mask(tables, h_cl, c, C, Hp1);
      float cost = 0.0f;
      for (int x = 0; x < len; ++x) {
        const int seg_cl = min(sh.seg[x], Hp1 - 1);
        const int n = __popcll(add_mask(sel, seg_cl, sh.need[x]));
        for (int r = 0; r < n; ++r) cost = __fadd_rn(cost, sh.fpos[x]);
      }
      if (cost < best) {
        best = cost;
        best_c = c;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float oc = __shfl_down_sync(0xFFFFFFFFu, best, off);
      const int oi = __shfl_down_sync(0xFFFFFFFFu, best_c, off);
      if (oc < best || (oc == best && oi < best_c)) {
        best = oc;
        best_c = oi;
      }
    }
    best = __shfl_sync(0xFFFFFFFFu, best, 0);
    best_c = __shfl_sync(0xFFFFFFFFu, best_c, 0);
  }
  const bool no_sol = best >= kInf;

  // ---- the winner's additions -> chosen [L, Hp1] ----
  const unsigned long long sel =
      no_sol ? 0ull : sel_mask(tables, h_cl, best_c, C, Hp1);
  for (int x = lane; x < L; x += 32) {
    unsigned long long a = 0;
    if (!no_sol && sh.gate_ok && x < len)
      a = add_mask(sel, min(sh.seg[x], Hp1 - 1), sh.need[x]);
    sh.need[x] = a;
  }
  __syncwarp();
  uint8_t* ch = chosen + base * Hp1;
  for (int e = lane; e < L * Hp1; e += 32)
    ch[e] = (sh.need[e / Hp1] >> (e % Hp1)) & 1ull;
  for (int k = lane; k < Hp1; k += 32)
    srv_out[static_cast<int64_t>(b) * Hp1 + k] = sh.srv[k];
  if (lane == 0) {
    cost_out[b] = best;
    nosol_out[b] = no_sol;
    skip_out[b] = sh.skipped;
  }
}

// Apply the chosen additions: one thread per (path, position).
__global__ void apply_chosen_kernel(const int32_t* __restrict__ objects,
                                    const uint8_t* __restrict__ chosen,
                                    const int32_t* __restrict__ srv, int B,
                                    int L, int W, int Hp1,
                                    uint32_t* __restrict__ words) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(B) * L) return;
  const int64_t b = e / L;
  const uint8_t* ch = chosen + e * Hp1;
  const int v = max(objects[e], 0);
  for (int k = 0; k < Hp1; ++k) {
    if (!ch[k]) continue;
    const int s = srv[b * Hp1 + k];
    atomicOr(words + static_cast<int64_t>(v) * W + (s >> 5), 1u << (s & 31));
  }
}

template <int GATE, bool LOOKAHEAD>
void launch(const void* objects, const void* lengths, const void* shard,
            const void* f, const void* tables, const void* counts,
            const void* t, const void* rank, int B, int L, int W, int Hc,
            int C, int Hp1, const void* words, void* chosen, void* srv,
            void* cost, void* nosol, void* skipped, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  const size_t smem = GATE == GATE_ROUTED ? sizeof(float) * (W << 5) : 0;
  fused_update_kernel<GATE, LOOKAHEAD><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const int32_t*>(objects),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(shard), static_cast<const float*>(f),
      static_cast<const uint8_t*>(tables),
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(t),
      static_cast<const float*>(rank), static_cast<const uint32_t*>(words), B,
      L, W, Hc, C, Hp1, static_cast<uint8_t*>(chosen),
      static_cast<int32_t*>(srv), static_cast<float*>(cost),
      static_cast<uint8_t*>(nosol), static_cast<uint8_t*>(skipped));
}

}  // namespace

extern "C" int fused_update_launch(
    const void* objects, const void* lengths, const void* shard,
    const void* f, const void* tables, const void* counts, const void* t,
    const void* rank, int B, int L, int W, int Hc, int C, int Hp1,
    int gate_mode, int lookahead, void* words, void* chosen, void* srv,
    void* cost, void* nosol, void* skipped, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate_mode == GATE_SCORED) {
    launch<GATE_SCORED, false>(objects, lengths, shard, f, tables, counts, t,
                               rank, B, L, W, Hc, C, Hp1, words, chosen, srv,
                               cost, nosol, skipped, s);
  } else if (gate_mode == GATE_ROUTED && lookahead) {
    launch<GATE_ROUTED, true>(objects, lengths, shard, f, tables, counts, t,
                              rank, B, L, W, Hc, C, Hp1, words, chosen, srv,
                              cost, nosol, skipped, s);
  } else if (gate_mode == GATE_ROUTED) {
    launch<GATE_ROUTED, false>(objects, lengths, shard, f, tables, counts, t,
                               rank, B, L, W, Hc, C, Hp1, words, chosen, srv,
                               cost, nosol, skipped, s);
  } else {
    launch<GATE_NONE, false>(objects, lengths, shard, f, tables, counts, t,
                             rank, B, L, W, Hc, C, Hp1, words, chosen, srv,
                             cost, nosol, skipped, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(B) * L;
  const int threads = 256;
  apply_chosen_kernel<<<static_cast<int>((n + threads - 1) / threads), threads,
                        0, s>>>(static_cast<const int32_t*>(objects),
                                static_cast<const uint8_t*>(chosen),
                                static_cast<const int32_t*>(srv), B, L, W, Hp1,
                                static_cast<uint32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}
