// Causal GQA flash attention for prefill, with an optional sliding window.
//
// Replaces the TPU kernel `flash_prefill_pallas` (src/repro/kernels/flash_prefill.py,
// body `_kernel`).  Same function: q [B, S, KV, G, hd], k/v [B, S, KV, hd]
// in f32 or bf16; query position i attends to keys j <= i (and i - j <
// window when window > 0); scores and the softmax are f32; the output
// [B, S, KV, G, hd] is written in q's dtype.  Query head h = kv * G + g.
//
// Design: one block per (b, kv head, tile of kRows query rows), where the
// rows of one (b, kv) are ordered position-major (row = pos * G + g), so a
// tile mixes the G heads of a few positions and any G fits.  Each of the
// kWarps warps owns kR rows (attention_common.cuh: lanes over hd, a
// shuffle-reduced dot product, the online max, sum and accumulator in f32
// registers).  The block walks the key tiles from the window start of its
// first row to its last row's position, loading each K and V tile into
// shared memory once for all its rows: tiles above the diagonal and before
// the window are never loaded.  Blocks are issued latest query tile first,
// so the longest rows start first.
//
// Bound on the card: operations.  The causal product is 4 * B * H * hd *
// S(S+1)/2 flops against (2 q + 2 kv) * S * hd element reads and writes, far
// above the ~295 flops per byte where bf16 tensor-core work stops being
// memory-bound.  This simple kernel runs on the f32 CUDA cores with one
// shuffle reduction per score; tensor cores (wgmma), TMA and pipelining are
// left for a later change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
