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
// [L, Hp1, 128] plane per candidate in VMEM; here the per-path state
// (objects, homes, segments, sizes, the `needed` bits of each position
// over the subpaths, the subpath servers) lives in a small per-warp slot
// of shared memory, one 64-bit `needed` mask per position, when L <= 64
// (so Hp1 <= 64 after the wrapper's cut); a longer path keeps the same
// state in its slice of a device scratch from the wrapper, with
// ceil(Hp1 / 64) mask words per position, and reads each candidate's
// selection from its table row instead of one 64-bit mask.  Lanes stride
// over the candidates, each lane keeps its best (cost, index) and a
// shuffle reduction takes the strict argmin.  Only the winner's additions
// are rebuilt and written as `chosen`.  The gate walk is sequential (one
// lane).  The additions are
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
// Any L and W.  The routed gate's rank vector is staged in shared memory
// up to kStagedRank servers and read from device memory past that; the
// wrapper cuts wider tables to Hp1 <= L (h <= L - 1, so later columns are
// never read).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

constexpr int kSmallL = 64;  // the shared-memory tier: L, Hp1 <= 64
constexpr int kWarps = 4;    // paths per block
// the routed gate's rank vector staged in shared memory beside the slots
constexpr int kStagedRank = 8192;
constexpr float kInf = 1e30f;

enum Gate { GATE_NONE = 0, GATE_ROUTED = 1, GATE_SCORED = 2 };

typedef unsigned long long u64;

// One path's state: per position x its object (max(object, 0)), home
// (shard[obj] at valid positions, else -1), subpath index (valid) or -1 and
// size (f[obj] at valid positions, else 0); NW words of needed(x, k) bits
// (need[x * NW + (k >> 6)], bit k & 63); the server of subpath k (-1 when
// absent).
struct PathState {
  int* obj;
  int* home;
  int* seg;
  float* fpos;
  u64* need;
  int* srv;
};

// The shared tier's per-warp slot (NW = 1).
struct WarpSlot {
  int obj[kSmallL];
  int home[kSmallL];
  int seg[kSmallL];
  float fpos[kSmallL];
  u64 need[kSmallL];
  int srv[kSmallL];
  int h, gate_ok, skipped;
};
static_assert(sizeof(WarpSlot) * kWarps + sizeof(float) * kStagedRank <= 48 * 1024,
              "the slots and the staged ranks fit the 48 KiB of a launch");

__device__ __forceinline__ u64 low_mask(int n) {
  return n >= 64 ? ~0ull : ((1ull << n) - 1ull);
}

__device__ __forceinline__ bool has_bit(const uint32_t* row, int s) {
  return (row[s >> 5] >> (s & 31)) & 1u;
}

// A candidate's selection (its table row: bit k set iff subpath k is
// kept).  lo(k) is the largest selected index <= k, 0 when none: position
// x adds copies at subpaths [lo(seg_x), seg_x).
struct SelBits {  // Hp1 <= 64: the row as one mask
  u64 m;
  __device__ __forceinline__ SelBits(const uint8_t* tab, int Hp1) : m(0) {
    for (int k = 0; k < Hp1; ++k)
      if (tab[k]) m |= 1ull << k;
  }
  __device__ __forceinline__ int lo(int k) const {
    const u64 low = m & low_mask(k + 1);
    return low ? 63 - __clzll(static_cast<long long>(low)) : 0;
  }
};

struct SelRow {  // any Hp1: the row's bytes, scanned down from k
  const uint8_t* tab;
  __device__ __forceinline__ SelRow(const uint8_t* t, int) : tab(t) {}
  __device__ __forceinline__ int lo(int k) const {
    for (int j = k; j > 0; --j)
      if (tab[j]) return j;
    return 0;
  }
};

// The needed bits of one position in [lo, hi) (NWC: the word count when
// known at compile time, else 0).
template <int NWC>
__device__ __forceinline__ int count_needed(const u64* need, int lo, int hi) {
  if constexpr (NWC == 1) return __popcll(low_mask(hi) & ~low_mask(lo) & need[0]);
  int n = 0;
  for (int q = lo >> 6; (q << 6) < hi; ++q) {
    u64 m = need[q];
    if (q == (lo >> 6)) m &= ~low_mask(lo & 63);
    if (q == (hi >> 6)) m &= low_mask(hi & 63);
    n += __popcll(m);
  }
  return n;
}

// SHARED: the per-warp slot in shared memory (L, Hp1 <= kSmallL); else
// the path's slice of need_g [B, L, NW] and state_g [B, 4 L + Hp1].
template <int GATE, bool LOOKAHEAD, bool SHARED>
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
                    int Hc, int C, int Hp1, u64* __restrict__ need_g,
                    int32_t* __restrict__ state_g, uint8_t* __restrict__ chosen,
                    int32_t* __restrict__ srv_out, float* __restrict__ cost_out,
                    uint8_t* __restrict__ nosol_out,
                    uint8_t* __restrict__ skip_out) {
  using Sel = typename std::conditional<SHARED, SelBits, SelRow>::type;
  constexpr int NWC = SHARED ? 1 : 0;
  __shared__ WarpSlot slots[kWarps];
  extern __shared__ float s_rank[];
  const int Sp = W << 5;
  const bool staged = GATE == GATE_ROUTED && Sp <= kStagedRank;
  if (staged) {
    for (int s = threadIdx.x; s < Sp; s += blockDim.x) s_rank[s] = rank[s];
    __syncthreads();
  }
  const float* rk = staged ? s_rank : rank;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  WarpSlot& sh = slots[warp];
  const int NW = SHARED ? 1 : (Hp1 + 63) >> 6;
  PathState ps;
  if constexpr (SHARED) {
    ps = PathState{sh.obj, sh.home, sh.seg, sh.fpos, sh.need, sh.srv};
  } else {
    int32_t* st = state_g + static_cast<int64_t>(b) * (4 * L + Hp1);
    ps = PathState{st, st + L, st + 2 * L, reinterpret_cast<float*>(st + 3 * L),
                   need_g + static_cast<int64_t>(b) * L * NW, st + 4 * L};
  }
  const int64_t base = static_cast<int64_t>(b) * L;
  const int len = lengths[b];

  // ---- per-position gathers ----
  for (int x = lane; x < L; x += 32) {
    const int v = max(objects[base + x], 0);
    const bool valid = x < len;
    ps.obj[x] = v;
    ps.home[x] = valid ? shard[v] : -1;
    ps.fpos[x] = __fmul_rn(f[v], valid ? 1.0f : 0.0f);
  }
  __syncwarp();

  // ---- subpaths (Def 5.1) and the gate walk: one lane ----
  if (lane == 0) {
    int cnt = 0;
    int prev = -2;
    for (int x = 0; x < L; ++x) {
      const bool valid = x < len;
      if (valid && x > 0 && ps.home[x] != prev) ++cnt;
      ps.seg[x] = valid ? cnt : -1;
      prev = ps.home[x];
    }
    const int h = len > 0 ? ps.seg[len - 1] : 0;
    for (int k = 0; k < Hp1; ++k) ps.srv[k] = -1;
    for (int x = 0; x < len; ++x) {
      const int k = ps.seg[x];
      if (k < Hp1) ps.srv[k] = max(ps.srv[k], ps.home[x]);
    }
    int h_routed = 0;
    if (GATE != GATE_NONE) {
      int server = len > 0 ? shard[max(objects[base], 0)] : 0;
      for (int i = 1; i < len; ++i) {
        const uint32_t* row = words + static_cast<int64_t>(ps.obj[i]) * W;
        if (server >= 0 && has_bit(row, server)) continue;
        ++h_routed;
        if (GATE == GATE_SCORED) {
          server = pick_holder(row, nullptr, W, ps.home[i], rank + (base + i) * Sp);
        } else {
          int tgt = -1;
          if (LOOKAHEAD && i + 1 < len)
            tgt = pick_holder(row, words + static_cast<int64_t>(ps.obj[i + 1]) * W, W,
                              ps.home[i], rk);
          if (tgt < 0) tgt = pick_holder(row, nullptr, W, ps.home[i], rk);
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
    const uint32_t* row = words + static_cast<int64_t>(ps.obj[x]) * W;
    for (int q = 0; q < NW; ++q) {
      u64 m = 0;
      if (x < len) {
        for (int k = q << 6; k < min(Hp1, (q + 1) << 6); ++k) {
          const int s = ps.srv[k];
          if (s >= 0 && !has_bit(row, s)) m |= 1ull << (k & 63);
        }
      }
      ps.need[static_cast<int64_t>(x) * NW + q] = m;
    }
  }
  __syncwarp();

  // ---- candidates: lanes stride, strict argmin, ties -> lowest index ----
  const int h_cl = min(max(sh.h, 0), Hp1 - 1);
  const int n_cand = h_cl < Hc ? min(counts[h_cl], C) : 0;
  const uint8_t* tab0 = tables + static_cast<int64_t>(h_cl) * C * Hp1;
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
      const Sel sel(tab0 + static_cast<int64_t>(c) * Hp1, Hp1);
      float cost = 0.0f;
      for (int x = 0; x < len; ++x) {
        const int seg_cl = min(ps.seg[x], Hp1 - 1);
        const int n = count_needed<NWC>(ps.need + static_cast<int64_t>(x) * NW,
                                        sel.lo(seg_cl), seg_cl);
        for (int r = 0; r < n; ++r) cost = __fadd_rn(cost, ps.fpos[x]);
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

  // ---- the winner's additions -> chosen [L, Hp1]: x -> k for needed k
  // in [lo(seg_x), seg_x) ----
  const bool apply = !no_sol && sh.gate_ok;
  const Sel win(tab0 + static_cast<int64_t>(apply ? best_c : 0) * Hp1, apply ? Hp1 : 0);
  uint8_t* ch = chosen + base * Hp1;
  for (int e = lane; e < L * Hp1; e += 32) {
    const int x = e / Hp1;
    const int k = e % Hp1;
    uint8_t a = 0;
    if (apply && x < len) {
      const int seg_cl = min(ps.seg[x], Hp1 - 1);
      if (k < seg_cl && k >= win.lo(seg_cl))
        a = (ps.need[static_cast<int64_t>(x) * NW + (k >> 6)] >> (k & 63)) & 1ull;
    }
    ch[e] = a;
  }
  for (int k = lane; k < Hp1; k += 32)
    srv_out[static_cast<int64_t>(b) * Hp1 + k] = ps.srv[k];
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
            int C, int Hp1, const void* words, void* need_g, void* state_g,
            void* chosen, void* srv, void* cost, void* nosol, void* skipped,
            cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  const size_t smem =
      GATE == GATE_ROUTED && (W << 5) <= kStagedRank ? sizeof(float) * (W << 5) : 0;
  auto kernel = L <= kSmallL && Hp1 <= kSmallL ? fused_update_kernel<GATE, LOOKAHEAD, true>
                                               : fused_update_kernel<GATE, LOOKAHEAD, false>;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const int32_t*>(objects),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(shard), static_cast<const float*>(f),
      static_cast<const uint8_t*>(tables),
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(t),
      static_cast<const float*>(rank), static_cast<const uint32_t*>(words), B,
      L, W, Hc, C, Hp1, static_cast<u64*>(need_g), static_cast<int32_t*>(state_g),
      static_cast<uint8_t*>(chosen), static_cast<int32_t*>(srv),
      static_cast<float*>(cost), static_cast<uint8_t*>(nosol),
      static_cast<uint8_t*>(skipped));
}

}  // namespace

extern "C" int fused_update_launch(
    const void* objects, const void* lengths, const void* shard,
    const void* f, const void* tables, const void* counts, const void* t,
    const void* rank, int B, int L, int W, int Hc, int C, int Hp1,
    int gate_mode, int lookahead, void* words, void* need_g, void* state_g,
    void* chosen, void* srv, void* cost, void* nosol, void* skipped, void* stream) {
  // past the shared tier the state lives in need_g (u64 [B, L, ceil(Hp1 /
  // 64)]) and state_g (int32 [B, 4 L + Hp1])
  if ((L > kSmallL || Hp1 > kSmallL) && (need_g == nullptr || state_g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate_mode == GATE_SCORED) {
    launch<GATE_SCORED, false>(objects, lengths, shard, f, tables, counts, t, rank, B, L, W, Hc,
                               C, Hp1, words, need_g, state_g, chosen, srv, cost, nosol,
                               skipped, s);
  } else if (gate_mode == GATE_ROUTED && lookahead) {
    launch<GATE_ROUTED, true>(objects, lengths, shard, f, tables, counts, t, rank, B, L, W, Hc,
                              C, Hp1, words, need_g, state_g, chosen, srv, cost, nosol,
                              skipped, s);
  } else if (gate_mode == GATE_ROUTED) {
    launch<GATE_ROUTED, false>(objects, lengths, shard, f, tables, counts, t, rank, B, L, W, Hc,
                               C, Hp1, words, need_g, state_g, chosen, srv, cost, nosol,
                               skipped, s);
  } else {
    launch<GATE_NONE, false>(objects, lengths, shard, f, tables, counts, t, rank, B, L, W, Hc,
                             C, Hp1, words, need_g, state_g, chosen, srv, cost, nosol,
                             skipped, s);
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
