// GQA flash-decode: one query token per sequence over a KV cache.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py, body `_kernel`).  q [B, KV, G, hd],
// k/v [B, T, KV, hd] in f32 or bf16, lengths int32 [B]; row (b, kv, g)
// attends to cache positions t < lengths[b] with f32 scores and softmax, and
// the output [B, KV, G, hd] is written in q's dtype.  A length of 0 (or
// less) follows the oracle `decode_attention_ref` (src/repro/kernels/ref.py):
// every score is masked, so the softmax is uniform and the row is the mean
// of v over the T cache rows.  (The TPU kernel averages over its padded
// cache instead; it agrees with the oracle for every length in [1, T].)
//
// Design: one block per (b, kv head), one warp per query head g of the
// group (attention_common.cuh: lanes over hd, f32 online softmax in
// registers); the G rows share each K/V tile that the block stages in
// shared memory, so the cache of a kv head is read once for its G query
// heads.  Tiles past the sequence's length are never loaded; T need not be
// a multiple of the tile.
//
// Bound on the card: bytes.  Each cache element is read once and used for
// 2 * G flops per K and V element (G <= 16 here), far below the ~295 flops
// per byte of the tensor cores.  With one block per (b, kv) a small batch
// leaves most SMs idle; splitting T across blocks (flash-decoding) is left
// for a later change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int kMinWarps = 4;  // warps past G only help load the tiles

template <int D, typename T>
__global__ void decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const int32_t* __restrict__ lengths,
                                        T* __restrict__ out, int T_len, int KV, int G,
                                        int hd) {
  __shared__ float ks[attn::kTile * 32 * D];
  __shared__ float vs[attn::kTile * 32 * D];
  const int kv = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lengths[b];
  // length <= 0: all T rows with equal (zero) scores, as the oracle's
  // all-masked softmax gives
  const bool uniform = len <= 0;
  const int hi = uniform ? T_len - 1 : min(len, T_len) - 1;

  attn::Rows<D, 1> row;
  row.reset();
  const bool live = g < G;
  const int64_t off = ((static_cast<int64_t>(b) * KV + kv) * G + g) * hd;
  row.lo[0] = live ? 0 : 1;
  row.hi[0] = live ? hi : 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const int d = lane + 32 * i;
    row.q[0][i] = (live && !uniform && d < hd) ? attn::to_f32(q[off + d]) : 0.0f;
  }

  const int64_t stride = static_cast<int64_t>(KV) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * T_len * KV + kv) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * T_len * KV + kv) * hd;
  const float sqrt_hd = sqrtf(static_cast<float>(hd));
  for (int k0 = 0; k0 <= hi; k0 += attn::kTile) {
    const int nk = min(attn::kTile, T_len - k0);
    __syncthreads();
    attn::load_tile<D>(ks, kb, stride, k0, nk, hd);
    attn::load_tile<D>(vs, vb, stride, k0, nk, hd);
    __syncthreads();
    row.step(ks, vs, k0, nk, sqrt_hd, lane);
  }

  if (!live) return;
  const float inv = 1.0f / fmaxf(row.l[0], 1e-30f);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) attn::store(out + off + d, row.acc[0][i] * inv);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, int B, int T_len, int KV, int G, int hd, cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_attention_kernel<D, T><<<grid, max(G, kMinWarps) * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), T_len, KV, G, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* lengths,
                     void* out, int B, int T_len, int KV, int G, int hd, cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch<1, T>(q, k, v, lengths, out, B, T_len, KV, G, hd, stream);
    case 2: return launch<2, T>(q, k, v, lengths, out, B, T_len, KV, G, hd, stream);
    case 3: return launch<3, T>(q, k, v, lengths, out, B, T_len, KV, G, hd, stream);
    case 4: return launch<4, T>(q, k, v, lengths, out, B, T_len, KV, G, hd, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd <= 128, G <= 32, T >= 1.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int T_len,
                                       int KV, int G, int hd, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, lengths, out, B, T_len, KV, G, hd, st)
                 : dispatch<float>(q, k, v, lengths, out, B, T_len, KV, G, hd, st);
  return static_cast<int>(err);
}
