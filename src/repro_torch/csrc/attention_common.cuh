// The online-softmax attention step of flash_prefill.cu's CUDA-core kernel
// (the f32 route), and the conversion and warp-reduction helpers that
// decode_attention.cu shares with it.
//
// One warp owns R query rows of one (batch, kv head).  Lane `lane` holds
// dims lane + 32 * i (i < D, D = ceil(hd / 32)) of each row's query and
// f32 output accumulator in registers, so hd need not be a multiple of 32
// (dims >= hd are zero in the query and in the shared tiles).  Keys come in
// tiles of 32 (one per lane in the softmax) that every warp of the block
// reads from shared memory: the tile is loaded once for all the rows of the
// block, which is the GQA saving when the rows are the G query heads of one
// kv head.
//
// Each row's valid keys are one contiguous range [lo, hi] (causal with an
// optional window: [max(0, pos - window + 1), pos]; decode: [0, len - 1]).
// Masked keys get no weight.  The running max starts at -inf and a row whose
// keys are all masked in a tile is left as it was, so the kernel never forms
// (-inf) - (-inf); this is the same function as the TPU kernel's -1e30 fill,
// whose stale weights are wiped by exp(-1e30 - m) = 0 at the first valid
// key.  Scores are (q . k) / sqrt(hd) in f32; the output is acc / max(l,
// 1e-30), as in the TPU kernels.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int kTile = 32;  // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Copy keys [k0, k0 + nk) of one (batch, kv head) into a [kTile][32 * D]
// f32 tile, zero-filled past hd and past nk.  `src` points at key 0;
// consecutive keys are `stride` elements apart.  All threads of the block
// take part.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t stride, int k0, int nk, int hd) {
  constexpr int W = 32 * D;
  for (int idx = threadIdx.x; idx < kTile * W; idx += blockDim.x) {
    const int j = idx / W, d = idx - j * W;
    dst[idx] = (j < nk && d < hd) ? to_f32(src[(k0 + j) * stride + d]) : 0.0f;
  }
}

// The online-softmax state of the R rows of one warp.
template <int D, int R>
struct Rows {
  float q[R][D];
  float acc[R][D];
  float m[R];   // running max, -inf until a valid key is seen
  float l[R];   // running sum of exp(s - m), the same in every lane
  int lo[R];    // valid key range [lo, hi]; empty (lo > hi) for a padding row
  int hi[R];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[r][i] = 0.0f;
    }
  }

  // Fold the keys [k0, k0 + nk) of the shared tiles ks, vs into the rows.
  __device__ __forceinline__ void step(const float* ks, const float* vs, int k0, int nk,
                                       float sqrt_hd, int lane) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < R; ++r) any |= lo[r] <= hi[r] && lo[r] < k0 + nk && hi[r] >= k0;
    if (!any) return;  // warp-uniform: no row of this warp sees the tile
    // scores: lane j keeps s[r] for key k0 + j
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    for (int j = 0; j < kTile; ++j) {
      float kr[D];
#pragma unroll
      for (int i = 0; i < D; ++i) kr[i] = ks[j * 32 * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) part = fmaf(q[r][i], kr[i], part);
        part = warp_sum(part);
        if (lane == j) s[r] = part / sqrt_hd;
      }
    }
    const int kp = k0 + lane;
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool valid = lane < nk && kp >= lo[r] && kp <= hi[r];
      const float m_new = fmaxf(m[r], warp_max(valid ? s[r] : -INFINITY));
      if (m_new == -INFINITY) {  // no valid key yet: the row stays empty
        p[r] = 0.0f;
        continue;
      }
      const float alpha = expf(m[r] - m_new);  // m = -inf gives 0
      p[r] = valid ? expf(s[r] - m_new) : 0.0f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[r][i] *= alpha;
    }
    for (int j = 0; j < kTile; ++j) {
      float vr[D];
#pragma unroll
      for (int i = 0; i < D; ++i) vr[i] = vs[j * 32 * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int i = 0; i < D; ++i) acc[r][i] = fmaf(pj, vr[i], acc[r][i]);
      }
    }
  }
};

}  // namespace attn
