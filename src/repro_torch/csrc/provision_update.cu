// The fused greedy UPDATE (paper Alg 2 hot loop) of a whole budget class:
// N paths priced in snapshot batches, in one persistent launch.
//
// Replaces the TPU kernel `fused_update_pallas`
// (src/repro/kernels/provision_update.py, `_make_kernel`) and the host loop
// that launched it once per batch.  Per path, against the batch's snapshot
// of the packed words:
//   1. the policy-routed gate walk h(p, r, rho; policy) (GATE_ROUTED: the
//      routed-walk pick over a shared rank vector, optional lookahead;
//      GATE_SCORED: nearest_copy_dp's scored pick, its scores rebuilt from
//      the path's own words by `dp_gate`, walk_common.cuh);
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
// Snapshot batches (the greedy's lock-free semantics): batch k + 1 prices
// against the words after batch k's additions, and every row of a batch
// against the same words.  The launch is cooperative, with at most as many
// blocks as can be co-resident, and loops over the batches: price every row
// of the batch (warps stride over its rows), grid.sync(), OR the batch's
// chosen additions into the words with atomicOr (OR is idempotent, so
// duplicate pairs give the plain version's scatter-OR), grid.sync().  Block
// 0 meanwhile adds the batch's (cost, failed, skipped) in row order, and
// adds the class's sums into `acc` once at the end: deterministic.  The
// words are written inside the launch, so they are not const __restrict__
// and every read of them is an __ldcg (L2, coherent with the atomics made
// before the last barrier); a non-coherent or L1 read could return a word
// from before the last batch's additions.
//
// Design for Hopper: one warp per path.  The TPU kernel keeps a
// [L, Hp1, 128] plane per candidate in VMEM; here the per-path state
// (objects, homes, segments, sizes, the `needed` bits of each position
// over the subpaths, the subpath servers, the scored gate's hop values
// and, for W == 1, each position's word) lives in a small per-warp slot
// of shared memory, one 64-bit `needed` mask per position, when L <= 64
// (so Hp1 <= 64 after the wrapper's cut); a longer path keeps the same
// state in its row's slice of a device scratch sized for one batch and
// reused by every batch, with ceil(Hp1 / 64) mask words per position, and
// reads each candidate's selection from its table row instead of one
// 64-bit mask.  Lanes stride over the candidates, each lane keeps its best
// (cost, index) and a shuffle reduction takes the strict argmin.  Only the
// winner's additions are rebuilt and written as `chosen`.  The gate walk is
// sequential (one lane), and runs only for a path over its budget (for the
// others it decides nothing).  The rank vector is staged in shared memory
// once per block for the whole class.
//
// Bound on the card: mostly bytes (objects, the touched words, homes and
// sizes, the chosen plane); the candidate loop does sum_b n_cand(h_b) * L
// integer mask operations, which stays far below the card's integer rate
// at the C(h, t) sizes the greedy vectorises (C <= 2048).  At the greedy's
// 256-row batches the card is mostly waiting: one warp per row fills 64
// blocks, and each batch pays two grid barriers.
//
// Any L and W.  The routed gate's rank vector is staged in shared memory
// up to kStagedRank servers and read from device memory past that; the
// wrapper cuts wider tables to Hp1 <= L (h <= L - 1, so later columns are
// never read).

#include <cstdint>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSmallL = 64;  // the shared-memory tier: L, Hp1 <= 64
constexpr int kWarps = 4;    // paths in flight per block
// the routed gate's rank vector staged in shared memory beside the slots
constexpr int kStagedRank = 8192;
constexpr float kInf = 1e30f;
// 32-row chunks of a batch's statistics loaded at once (the greedy's
// 256-row batch in one go)
constexpr int kStatChunks = 8;

enum Gate { GATE_NONE = 0, GATE_ROUTED = 1, GATE_SCORED = 2 };

typedef unsigned long long u64;

// One path's state: per position x its object (max(object, 0)), home
// (shard[obj] at valid positions, else -1), subpath index (valid) or -1 and
// size (f[obj] at valid positions, else 0); NW words of needed(x, k) bits
// (need[x * NW + (k >> 6)], bit k & 63); the server of subpath k (-1 when
// absent); the scored gate's hop values (len ints).
struct PathState {
  int* obj;
  int* home;
  int* seg;
  float* fpos;
  u64* need;
  int* srv;
  int* G;
};

// The shared tier's per-warp slot (NW = 1); wrd: W == 1, each position's
// word in the batch's snapshot (0 past the path's length).
struct WarpSlot {
  int obj[kSmallL];
  int home[kSmallL];
  int seg[kSmallL];
  float fpos[kSmallL];
  u64 need[kSmallL];
  int srv[kSmallL];
  int G[kSmallL];
  uint32_t wrd[kSmallL];
  int h, gate_ok, skipped;
};
static_assert(sizeof(WarpSlot) * kWarps + sizeof(float) * kStagedRank <= 48 * 1024,
              "the slots and the staged ranks fit the 48 KiB of a launch");

// The staged words of a slot as the Rows of dp_gate (W == 1).
struct SlotWords {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t operator()(int j, int) const { return w[j]; }
  __device__ __forceinline__ int width() const { return 1; }
};

__device__ __forceinline__ u64 low_mask(int n) {
  return n >= 64 ? ~0ull : ((1ull << n) - 1ull);
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

struct Args {
  const int32_t* objects;  // [N, L]
  const int32_t* lengths;  // [N]
  const int32_t* shard;    // [n]
  const float* f;          // [n]
  const uint8_t* tables;   // [Hc, C, Hp1]
  const int32_t* counts;   // [Hc]
  const int32_t* t;        // [N]
  const float* rank;       // [W * 32] (GATE_ROUTED)
  uint32_t* words;         // [n + 1, W], written by the launch
  u64* need_g;             // [batch, L, ceil(Hp1 / 64)] past the shared tier
  int32_t* state_g;        // [batch, 5 L + Hp1] past the shared tier
  uint8_t* chosen;         // [N, L, Hp1]
  int32_t* srv;            // [N, Hp1]
  float* cost;             // [N] applied cost (0 without a solution)
  uint8_t* nosol;          // [N]
  uint8_t* skipped;        // [N]
  float* acc;              // [3] (cost, failed, skipped) += the class's; may be null
  int N, L, W, Hc, C, Hp1, batch, depth;
};

// Price row b (slot row r of its batch) against the current words: one
// warp; writes chosen, srv, cost, nosol and skipped of the row.
template <int GATE, bool LOOKAHEAD, bool SHARED>
__device__ __forceinline__ void price_row(const Args& a, int b, int r, WarpSlot& sh,
                                          const float* rk, int lane) {
  using Sel = typename std::conditional<SHARED, SelBits, SelRow>::type;
  constexpr int NWC = SHARED ? 1 : 0;
  const int L = a.L, W = a.W, Hp1 = a.Hp1, C = a.C;
  const int NW = SHARED ? 1 : (Hp1 + 63) >> 6;
  PathState ps;
  if constexpr (SHARED) {
    ps = PathState{sh.obj, sh.home, sh.seg, sh.fpos, sh.need, sh.srv, sh.G};
  } else {
    int32_t* st = a.state_g + static_cast<int64_t>(r) * (5 * L + Hp1);
    ps = PathState{st, st + L, st + 2 * L, reinterpret_cast<float*>(st + 3 * L),
                   a.need_g + static_cast<int64_t>(r) * L * NW, st + 5 * L, st + 4 * L};
  }
  const int64_t base = static_cast<int64_t>(b) * L;
  const int len = min(a.lengths[b], L);
  const bool staged_words = SHARED && W == 1;

  // ---- per-position gathers ----
  for (int x = lane; x < L; x += 32) {
    const int v = max(a.objects[base + x], 0);
    const bool valid = x < len;
    ps.obj[x] = v;
    ps.home[x] = valid ? a.shard[v] : -1;
    ps.fpos[x] = __fmul_rn(a.f[v], valid ? 1.0f : 0.0f);
    if constexpr (SHARED)
      if (staged_words) sh.wrd[x] = valid ? __ldcg(a.words + v) : 0u;
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
    const int tb = a.t[b];
    const bool over = h > tb;
    // the routed count, walked only for a path over its budget and only
    // until it passes the budget: nothing else reads it
    int h_routed = 0;
    if (GATE != GATE_NONE && over) {
      const int start = len > 0 ? ps.home[0] : 0;
      if constexpr (GATE == GATE_SCORED) {
        if constexpr (SHARED) {
          if (staged_words)
            h_routed = dp_gate(SlotWords{sh.wrd}, ps.obj, len, a.depth, a.shard, start, tb,
                               ps.G);
          else
            h_routed = dp_gate(PathWords<true>{ps.obj, a.words, W}, ps.obj, len, a.depth,
                               a.shard, start, tb, ps.G);
        } else {
          h_routed = dp_gate(PathWords<true>{ps.obj, a.words, W}, ps.obj, len, a.depth,
                             a.shard, start, tb, ps.G);
        }
      } else if constexpr (GATE == GATE_ROUTED) {
        walk_path<false, LOOKAHEAD, 0, true>(ps.obj, L, len, len, a.words, W, a.shard, start,
                                             rk, [&](int, int, bool loc) {
                                               h_routed += loc ? 0 : 1;
                                               return h_routed <= tb;
                                             });
      }
    }
    sh.h = h;
    sh.gate_ok = over && (GATE == GATE_NONE || h_routed > tb);
    sh.skipped = GATE != GATE_NONE && over && h_routed <= tb;
  }
  __syncwarp();

  // ---- needed(x, k): no copy of object x at srv[k] in the snapshot ----
  for (int x = lane; x < L; x += 32) {
    const uint32_t* row = a.words + static_cast<int64_t>(ps.obj[x]) * W;
    for (int q = 0; q < NW; ++q) {
      u64 m = 0;
      if (x < len) {
        for (int k = q << 6; k < min(Hp1, (q + 1) << 6); ++k) {
          const int s = ps.srv[k];
          if (s < 0) continue;
          uint32_t word;
          if constexpr (SHARED)
            word = staged_words ? sh.wrd[x] : __ldcg(row + (s >> 5));
          else
            word = __ldcg(row + (s >> 5));
          if (!((word >> (s & 31)) & 1u)) m |= 1ull << (k & 63);
        }
      }
      ps.need[static_cast<int64_t>(x) * NW + q] = m;
    }
  }
  __syncwarp();

  // ---- candidates: lanes stride, strict argmin, ties -> lowest index ----
  const int h_cl = min(max(sh.h, 0), Hp1 - 1);
  const int n_cand = h_cl < a.Hc ? min(a.counts[h_cl], C) : 0;
  const uint8_t* tab0 = a.tables + static_cast<int64_t>(h_cl) * C * Hp1;
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
        for (int i = 0; i < n; ++i) cost = __fadd_rn(cost, ps.fpos[x]);
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
  uint8_t* ch = a.chosen + base * Hp1;
  for (int e = lane; e < L * Hp1; e += 32) {
    const int x = e / Hp1;
    const int k = e % Hp1;
    uint8_t add = 0;
    if (apply && x < len) {
      const int seg_cl = min(ps.seg[x], Hp1 - 1);
      if (k < seg_cl && k >= win.lo(seg_cl))
        add = (ps.need[static_cast<int64_t>(x) * NW + (k >> 6)] >> (k & 63)) & 1ull;
    }
    ch[e] = add;
  }
  for (int k = lane; k < Hp1; k += 32)
    a.srv[static_cast<int64_t>(b) * Hp1 + k] = ps.srv[k];
  if (lane == 0) {
    a.cost[b] = no_sol ? 0.0f : best;
    a.nosol[b] = no_sol;
    a.skipped[b] = sh.skipped;
  }
  __syncwarp();  // the slot is read above before the warp's next row overwrites it
}

template <int GATE, bool LOOKAHEAD, bool SHARED>
__global__ void __launch_bounds__(kWarps * 32) fused_update_class_kernel(Args a) {
  __shared__ WarpSlot slots[kWarps];
  extern __shared__ float s_rank[];
  cg::grid_group grid = cg::this_grid();
  const int Sp = a.W << 5;
  const bool staged = GATE == GATE_ROUTED && Sp <= kStagedRank;
  if (staged)
    for (int s = threadIdx.x; s < Sp; s += blockDim.x) s_rank[s] = a.rank[s];
  __syncthreads();
  const float* rk = staged ? s_rank : a.rank;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const bool stats = a.acc != nullptr && blockIdx.x == 0 && warp == 0;
  float s_cost = 0.0f, s_fail = 0.0f, s_skip = 0.0f;  // the class's, in row order
  const int L = a.L, W = a.W, Hp1 = a.Hp1;

  for (int b0 = 0; b0 < a.N; b0 += a.batch) {
    const int nb = min(a.batch, a.N - b0);
    // ---- price the batch against the words as they are ----
    for (int r = gwarp; r < nb; r += nwarps)
      price_row<GATE, LOOKAHEAD, SHARED>(a, b0 + r, r, slots[warp], rk, lane);
    grid.sync();
    // ---- apply its additions: one thread per (row, position) ----
    for (int64_t e = gtid; e < static_cast<int64_t>(nb) * L; e += nthreads) {
      const int64_t row = b0 + e / L;
      const int64_t cell = row * L + e % L;
      const uint8_t* ch = a.chosen + cell * Hp1;
      const int v = max(a.objects[cell], 0);
      for (int k = 0; k < Hp1; ++k) {
        if (!__ldcg(ch + k)) continue;
        const int s = __ldcg(a.srv + row * Hp1 + k);
        atomicOr(a.words + static_cast<int64_t>(v) * W + (s >> 5), 1u << (s & 31));
      }
    }
    // ---- block 0, warp 0: the batch's statistics, in row order; the
    // rows of up to kStatChunks * 32 rows are loaded before any is added,
    // so the loads wait on memory once, not once per 32 rows ----
    if (stats) {
      for (int r0 = 0; r0 < nb; r0 += kStatChunks * 32) {
        float c[kStatChunks], fl[kStatChunks], sk[kStatChunks];
#pragma unroll
        for (int q = 0; q < kStatChunks; ++q) {
          const int r = r0 + q * 32 + lane;
          const bool in = r < nb;
          c[q] = in ? __ldcg(a.cost + b0 + r) : 0.0f;
          fl[q] = in ? static_cast<float>(__ldcg(a.nosol + b0 + r)) : 0.0f;
          sk[q] = in ? static_cast<float>(__ldcg(a.skipped + b0 + r)) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kStatChunks; ++q) {
          const int n = min(32, nb - (r0 + q * 32));
          for (int j = 0; j < n; ++j) {
            s_cost = __fadd_rn(s_cost, __shfl_sync(0xFFFFFFFFu, c[q], j));
            s_fail = __fadd_rn(s_fail, __shfl_sync(0xFFFFFFFFu, fl[q], j));
            s_skip = __fadd_rn(s_skip, __shfl_sync(0xFFFFFFFFu, sk[q], j));
          }
        }
      }
    }
    if (b0 + a.batch < a.N) grid.sync();  // the additions before the next batch prices
  }
  if (stats && lane == 0) {
    a.acc[0] = __fadd_rn(a.acc[0], s_cost);
    a.acc[1] = __fadd_rn(a.acc[1], s_fail);
    a.acc[2] = __fadd_rn(a.acc[2], s_skip);
  }
}

template <int GATE, bool LOOKAHEAD, bool SHARED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(
      &fused_update_class_kernel<GATE, LOOKAHEAD, SHARED>);
  const int threads = kWarps * 32;
  const size_t smem =
      GATE == GATE_ROUTED && (a.W << 5) <= kStagedRank ? sizeof(float) * (a.W << 5) : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // one warp per row of a batch, at most as many blocks as are co-resident
  const int rows = min(a.N, a.batch);
  const int blocks = max(1, min((rows + kWarps - 1) / kWarps, per_sm * sms));
  Args args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), params, smem, stream);
}

template <int GATE, bool LOOKAHEAD>
cudaError_t launch_tier(const Args& a, cudaStream_t stream) {
  return a.L <= kSmallL && a.Hp1 <= kSmallL ? launch<GATE, LOOKAHEAD, true>(a, stream)
                                            : launch<GATE, LOOKAHEAD, false>(a, stream);
}

}  // namespace

extern "C" int fused_update_class_launch(
    const void* objects, const void* lengths, const void* shard, const void* f,
    const void* tables, const void* counts, const void* t, const void* rank, int N, int L,
    int W, int Hc, int C, int Hp1, int batch, int gate_mode, int lookahead, int depth,
    void* words, void* need_g, void* state_g, void* chosen, void* srv, void* cost,
    void* nosol, void* skipped, void* acc, void* stream) {
  // past the shared tier the state lives in need_g (u64 [batch rows, L,
  // ceil(Hp1 / 64)]) and state_g (int32 [batch rows, 5 L + Hp1])
  if ((L > kSmallL || Hp1 > kSmallL) && (need_g == nullptr || state_g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int32_t*>(objects), static_cast<const int32_t*>(lengths),
               static_cast<const int32_t*>(shard),   static_cast<const float*>(f),
               static_cast<const uint8_t*>(tables),  static_cast<const int32_t*>(counts),
               static_cast<const int32_t*>(t),       static_cast<const float*>(rank),
               static_cast<uint32_t*>(words),        static_cast<u64*>(need_g),
               static_cast<int32_t*>(state_g),       static_cast<uint8_t*>(chosen),
               static_cast<int32_t*>(srv),           static_cast<float*>(cost),
               static_cast<uint8_t*>(nosol),         static_cast<uint8_t*>(skipped),
               static_cast<float*>(acc),             N, L, W, Hc, C, Hp1, batch, depth};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (gate_mode == GATE_SCORED)
    err = launch_tier<GATE_SCORED, false>(a, s);
  else if (gate_mode == GATE_ROUTED && lookahead)
    err = launch_tier<GATE_ROUTED, true>(a, s);
  else if (gate_mode == GATE_ROUTED)
    err = launch_tier<GATE_ROUTED, false>(a, s);
  else
    err = launch_tier<GATE_NONE, false>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
