// EmbeddingBag: sum- or mean-pool the table rows each bag names.
//
// Replaces the TPU kernel `embedding_bag_pallas` (src/repro/kernels/embedding_bag.py,
// body `_kernel`).  Same function: table [N, d] in f32 or bf16, ids int32
// [B, L] with -1 as padding; out f32 [B, d] is the f32 sum of the bag's
// non-padding rows, taken in order l = 0 .. L-1, divided by max(count, 1)
// for the mean, so an all-padding bag gives 0.  An id >= N reads the last
// row, as the TPU kernel's clamped block index does; such ids are outside
// the contract, but no id reads outside the table.
//
// Design: one warp per bag, lanes over d (32 columns at a time).  The warp
// reads 32 of the bag's ids at once, one per lane, and broadcasts each with
// a shuffle, so every row is one coalesced read of d contiguous elements
// and the [B, L, d] gather is never materialised.
//
// Bound on the card: bytes.  Each non-padding row is read once (d elements)
// with one add per element; ids are read once and the [B, d] output written
// once.  Rows are scattered, so whole 32-byte sectors are fetched per row;
// at d = 64 f32 a row is 256 contiguous bytes and sector waste is nil.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                     float* __restrict__ out, int N, int d, int B, int L, bool mean) {
  const int bag = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (bag >= B) return;  // warp-uniform
  const int32_t* bag_ids = ids + static_cast<int64_t>(bag) * L;
  int count = 0;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const bool real = l0 + lane < L && bag_ids[l0 + lane] >= 0;
    count += __popc(__ballot_sync(0xffffffffu, real));
  }
  const float denom = static_cast<float>(max(count, 1));
  for (int c = 0; c < d; c += 32) {
    const int col = c + lane;
    float acc = 0.0f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int mine = l0 + lane < L ? bag_ids[l0 + lane] : -1;
      const int n = min(32, L - l0);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(0xffffffffu, mine, j);
        if (id >= 0 && col < d) {
          acc += to_f32(table[static_cast<int64_t>(min(id, N - 1)) * d + col]);
        }
      }
    }
    if (col < d) out[static_cast<int64_t>(bag) * d + col] = mean ? acc / denom : acc;
  }
}

template <typename T>
cudaError_t launch(const void* table, const void* ids, void* out, int N, int d, int B,
                   int L, int mean, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  embedding_bag_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), N, d, B, L, mean != 0);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  N >= 1, B >= 1.
extern "C" int embedding_bag_launch(const void* table, const void* ids, void* out, int N,
                                    int d, int B, int L, int mean, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(table, ids, out, N, d, B, L, mean, st)
      : launch<float>(table, ids, out, N, d, B, L, mean, st);
  return static_cast<int>(err);
}
