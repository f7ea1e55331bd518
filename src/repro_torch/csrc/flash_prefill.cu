// Causal GQA flash attention for prefill, with an optional sliding window.
//
// Replaces the TPU kernel `flash_prefill_pallas` (src/repro/kernels/flash_prefill.py:69,
// body `_kernel`).  Same function: q [B, S, KV, G, hd], k/v [B, S, KV, hd]
// in f32 or bf16; query position i attends to keys j <= i (and i - j <
// window when window > 0); scores and the softmax are f32; the output
// [B, S, KV, G, hd] is written in q's dtype.  Query head h = kv * G + g.
//
// Bound on the card: operations.  The causal product is 4 * B * H * hd *
// S(S+1)/2 flops against (2 q + 2 kv) * S * hd element reads and writes, far
// above the ~295 flops per byte where bf16 tensor-core work stops being
// memory-bound.  So bf16 goes to the tensor cores, and two kernels live here:
//
// `flash_prefill_wgmma_launch` (bf16, hd a multiple of 8, hd <= 128): one
// block of two consumer warpgroups and one producer warp takes 128 query rows
// of one (b, kv head).  The rows are ordered position-major (row = pos * G +
// g), so a tile holds all G heads of a few positions, any G fits, and each
// K/V tile in shared memory serves all G heads (the GQA saving).  Rows cross
// position boundaries, so Q is loaded once with 16-byte loads into 128B-
// swizzled shared memory (zeros past hd and past the last row).  The
// producer warp streams 64-key K and V tiles through a 3-stage ring with TMA
// (a 4-D tensor map over [B, S, KV, hd], 64-column boxes, 128B swizzle, zero
// fill past hd and S) and `mbarrier`s, so the next tiles' loads overlap this
// tile's math.  Each warpgroup computes S = Q K^T for its 64 rows with
// `wgmma` (m64n64k16, both operands in shared memory) into f32 registers,
// runs the online softmax on the accumulator fragment (a quad shuffle per
// row per tile for the max; the row sums stay per thread until the end),
// masks only tiles that cross the diagonal or the window's start, converts P
// to bf16 in registers and feeds it as the register A operand of the PV
// `wgmma`, with V (MN-major) from shared memory.  hd is padded with zeros to
// a multiple of 16 for the depth of Q K^T and to 64 or 128 for the width of
// P V: three instances, hd <= 32 (Q K^T 32 deep), hd <= 64 and hd <= 128
// (120 runs as 128).  The P V product stays 64 columns wide at hd <= 32,
// since m64n64 is the one accumulator layout the softmax code reads.  Tiles wholly above the diagonal or before the window are
// never loaded; blocks run latest query tile first, so the longest rows start
// first.  Within a warpgroup each tile's S, softmax and P V run in turn; the
// two warpgroups of a block overlap one's softmax with the other's products.
// (Issuing S of the next tile before this tile's P V has landed made ptxas
// serialise the wgmmas, warning C7515, and ran slower.)
//
// `flash_prefill_launch` (the CUDA-core kernel; the wrapper sends f32 here,
// and bf16 only where hd is not a multiple of 8, which TMA's 16-byte row
// stride needs): f32 products cannot meet the f32 route's 2e-5 tolerance on
// bf16 or TF32 tensor cores.  One block per (b, kv head, tile of kRows
// position-major rows); each of the kWarps warps owns kR rows
// (attention_common.cuh: lanes over hd, a shuffle-reduced dot product, the
// online max, sum and accumulator in f32 registers), and the block loads
// each K and V tile into shared memory once for all its rows.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kR = 4;
constexpr int kRows = kWarps * kR;

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     int S, int KV, int G, int hd, int window) {
  __shared__ float ks[attn::kTile * 32 * D];
  __shared__ float vs[attn::kTile * 32 * D];
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rows = S * G;
  const int r0 = tile * kRows;

  attn::Rows<D, kR> rows;
  rows.reset();
  int64_t off[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = r0 + warp * kR + r;
    const int pos = row / G, g = row - pos * G;
    off[r] = (((static_cast<int64_t>(b) * S + pos) * KV + kv) * G + g) * hd;
    const bool live = row < n_rows;
    rows.lo[r] = live ? (window > 0 ? max(0, pos - window + 1) : 0) : 1;
    rows.hi[r] = live ? pos : 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int d = lane + 32 * i;
      rows.q[r][i] = (live && d < hd) ? attn::to_f32(q[off[r] + d]) : 0.0f;
    }
  }

  const int p_first = r0 / G;
  const int p_last = (min(r0 + kRows, n_rows) - 1) / G;
  const int k_first = window > 0 ? max(0, p_first - window + 1) : 0;
  const int64_t stride = static_cast<int64_t>(KV) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kv) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kv) * hd;
  const float sqrt_hd = sqrtf(static_cast<float>(hd));
  for (int k0 = (k_first / attn::kTile) * attn::kTile; k0 <= p_last; k0 += attn::kTile) {
    const int nk = min(attn::kTile, S - k0);
    __syncthreads();  // the previous tile is no longer read
    attn::load_tile<D>(ks, kb, stride, k0, nk, hd);
    attn::load_tile<D>(vs, vb, stride, k0, nk, hd);
    __syncthreads();
    rows.step(ks, vs, k0, nk, sqrt_hd, lane);
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r0 + warp * kR + r >= n_rows) continue;
    const float inv = 1.0f / fmaxf(rows.l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) attn::store(out + off[r] + d, rows.acc[r][i] * inv);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int KV, int G, int hd, int window, cudaStream_t stream) {
  const dim3 grid((S * G + kRows - 1) / kRows, KV, B);
  flash_prefill_kernel<D, T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, KV, G, hd, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B, int S,
                     int KV, int G, int hd, int window, cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch<1, T>(q, k, v, out, B, S, KV, G, hd, window, stream);
    case 2: return launch<2, T>(q, k, v, out, B, S, KV, G, hd, window, stream);
    case 3: return launch<3, T>(q, k, v, out, B, S, KV, G, hd, window, stream);
    case 4: return launch<4, T>(q, k, v, out, B, S, KV, G, hd, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd <= 128.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int KV, int G, int hd, int window,
                                    int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, out, B, S, KV, G, hd, window, st)
                 : dispatch<float>(q, k, v, out, B, S, KV, G, hd, window, st);
  return static_cast<int>(err);
}

// --- bf16 on the tensor cores: wgmma fed by a TMA ring ----------------------

namespace {

constexpr int kBM = 128;                  // query rows per block: two warpgroups of 64
constexpr int kBN = 64;                   // keys per K/V tile
constexpr int kStages = 3;                // K/V tiles in flight
constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kThreadsTC = kConsumers + 32;  // and one producer warp
constexpr int kHalfBytes = kBN * 128;     // one 64-column half of a K or V tile

// Byte offsets in dynamic shared memory from a 1024-aligned base (the 128B
// swizzle repeats every 1024 bytes).  NH = padded hd / 64.
template <int NH>
struct SmemTC {
  static constexpr int q = 0;                                   // NH x [128 rows][128 B]
  static constexpr int k = NH * kBM * 128;                      // kStages x NH x [64][128 B]
  static constexpr int v = k + kStages * NH * kHalfBytes;
  static constexpr int bars = v + kStages * NH * kHalfBytes;    // full[kStages], empty[kStages]
  static constexpr int bytes = bars + 2 * kStages * 8 + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Wait for the phase of `parity` to complete.  A phase that never completes
// (a lost TMA transaction) traps after ~2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand: start address,
// leading and stride byte offsets (the stride between 8-row groups is 1024 B
// here; the other offset is unused for a 64-wide tile but set the same).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t kOff = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | kOff << 16 | kOff << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The 32 f32 accumulator registers of one thread as asm operands %0 .. %31.
#define WGMMA_D(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),        \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),     \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator fragment of m64nN (f32): thread (warp w of the warpgroup,
// lane) holds d[i] at row 16 w + lane / 4 + 8 * ((i >> 1) & 1) and column
// 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).  NH = 64-column halves of the
// padded hd; DK = 16-deep k-steps of Q K^T (hd rounded up to 16, / 16).
template <int NH, int DK>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                           int S, int KV, int G, int hd, int window) {
  using L = SmemTC<NH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L::bars, empty0 = full0 + 8 * kStages;

  const int tile = gridDim.x - 1 - blockIdx.x;  // latest query tile first
  const int kv = blockIdx.y, b = blockIdx.z;
  const int n_rows = S * G, r0 = tile * kBM;
  const int p_first = r0 / G, p_last = (min(r0 + kBM, n_rows) - 1) / G;
  const int k_first = window > 0 ? max(0, p_first - window + 1) : 0;
  const int t_first = k_first / kBN, n_tiles = p_last / kBN - t_first + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues the TMA loads
    if (threadIdx.x == kConsumers) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(empty0 + 8 * st, ((it / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * NH * kHalfBytes);
        const int k0 = (t_first + it) * kBN;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          tma_load_4d(base + L::k + (st * NH + h) * kHalfBytes, &kmap, full, h * 64, kv, k0, b);
          tma_load_4d(base + L::v + (st * NH + h) * kHalfBytes, &vmap, full, h * 64, kv, k0, b);
        }
      }
    }
    return;
  }

  // consumers: Q once, 16 bytes a thread, into the 128B-swizzled layout
  const int64_t pos_stride = static_cast<int64_t>(KV) * G * hd;
  const int64_t bkv = (static_cast<int64_t>(b) * S * KV + kv) * G * hd;
  for (int idx = threadIdx.x; idx < kBM * NH * 8; idx += kConsumers) {
    const int r = idx / (NH * 8), c = idx - r * (NH * 8);
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows && c * 8 < hd) {
      const int pos = row / G, g = row - pos * G;
      val = *reinterpret_cast<const uint4*>(q + bkv + pos * pos_stride + g * hd + c * 8);
    }
    *reinterpret_cast<uint4*>(smem + L::q + (c >> 3) * kBM * 128 + r * 128 +
                              (((c & 7) ^ (r & 7)) << 4)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);  // this thread's first row in the tile
  int pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) pos[r] = (r0 + rl + 8 * r) / G;  // rows past n_rows are dropped
  const int w0 = r0 + wg * 64;
  const int wp_lo = w0 / G, wp_hi = (min(w0 + 63, n_rows - 1)) / G;
  const float sl2 = 1.4426950408889634f / sqrtf(static_cast<float>(hd));  // log2(e) / sqrt(hd)
  const uint32_t qa = base + L::q + wg * 64 * 128;

  float o[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = (t_first + it) * kBN;
    const uint32_t kb = base + L::k + st * NH * kHalfBytes;
    const uint32_t vb = base + L::v + st * NH * kHalfBytes;
    mbar_wait(full0 + 8 * st, (it / kStages) & 1);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 bf16 along hd inside a 128 B row
      wgmma_ss(s, sw128_desc(qa + (kk >> 2) * kBM * 128 + off),
               sw128_desc(kb + (kk >> 2) * kHalfBytes + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    // mask only tiles that cross a row's diagonal or its window's start
    if (k0 + kBN - 1 > wp_lo || (window > 0 && k0 < wp_hi - window + 1)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int p = pos[(i >> 1) & 1];
        if (key > p || (window > 0 && p - key >= window)) s[i] = -INFINITY;
      }
    }
    // online softmax on the fragment: rows r = 0 (i & 2 == 0) and 1
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float mb[2], alpha[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      mb[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * sl2;  // a row with no valid key yet stays 0
      alpha[r] = exp2f(m[r] * sl2 - mb[r]);              // m = -inf gives 0
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(fmaf(s[i], sl2, -mb[(i >> 1) & 1]));
      ls[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] *= alpha[(i >> 1) & 1];
    // P in bf16 as the A fragment: keys 16 kk .. 16 kk + 15 are s[8 kk .. 8 kk + 7]
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    wgmma_fence();
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[h], a[kk], sw128_desc(vb + h * kHalfBytes + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.0f / fmaxf(quad_sum(l[r]), 1e-30f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rl + 8 * r;
    if (row >= n_rows) continue;
    const int g = row - pos[r] * G;
    __nv_bfloat16* dst = out + bkv + pos[r] * pos_stride + g * hd;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = h * 64 + 8 * nb + 2 * (lane & 3);
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              o[h][4 * nb + 2 * r] * inv[r], o[h][4 * nb + 2 * r + 1] * inv[r]);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the already loaded libcuda (so the
// library links against the CUDA runtime only).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// [B, S, KV, hd] bf16 as a 4-D tensor map (innermost first) with 64 x 1 x
// kBN x 1 boxes: one 64-column half of one K or V tile, 128B-swizzled, zeros
// past hd and past S.
bool kv_map(CUtensorMap* map, const void* base, int B, int S, int KV, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(KV) * hd * 2,
                                 static_cast<cuuint64_t>(S) * KV * hd * 2};
  const cuuint32_t box[4] = {64, 1, kBN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NH, int DK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int KV, int G, int hd, int window, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!kv_map(&kmap, k, B, S, KV, hd) || !kv_map(&vmap, v, B, S, KV, hd))
    return cudaErrorInvalidValue;
  constexpr int bytes = SmemTC<NH>::bytes;
  static bool allowed[64] = {};  // the shared-memory limit is raised once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && !allowed[dev]) {
    err = cudaFuncSetAttribute(flash_prefill_wgmma_kernel<NH, DK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    allowed[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((S * G + kBM - 1) / kBM, KV, B);
  flash_prefill_wgmma_kernel<NH, DK><<<grid, kThreadsTC, bytes, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), S, KV,
      G, hd, window);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; hd a multiple of 8 and <= 128; q, k, v, out 16-byte aligned.
extern "C" int flash_prefill_wgmma_launch(const void* q, const void* k, const void* v, void* out,
                                          int B, int S, int KV, int G, int hd, int window,
                                          void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (hd % 8 != 0 || hd > 128) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      hd <= 32   ? launch_tc<1, 2>(q, k, v, out, B, S, KV, G, hd, window, st)
      : hd <= 64 ? launch_tc<1, 4>(q, k, v, out, B, S, KV, G, hd, window, st)
                 : launch_tc<2, 8>(q, k, v, out, B, S, KV, G, hd, window, st);
  return static_cast<int>(err);
}
