// Path latency h(p, r, rho) under home-first routing (paper Eqns 1-2).
//
// Replaces the TPU kernel `path_latency_pallas` (src/repro/kernels/path_latency.py,
// body `_kernel`).  Same integer semantics:
//   server0 = max(home[0], 0), where home[0] = -1 for an empty path;
//   position i (1 <= i < len) counts when the current server's bit of
//   object i is clear, and the walk then moves to max(home[i], 0).
//
// Design: one thread per path, looping over the L positions.  Each thread
// gathers its own shard[obj] and the one word words[obj, server / 32] it
// needs, so the [P, L, W] gather the TPU layout pre-materialises is never
// built.  The walk is bound by the bytes it reads (objects, lengths, one
// word and one shard entry per position): an integer walk, no tensor
// cores.  Neighbouring threads read objects with a stride of L; coalescing
// that (a transposed layout) is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void path_latency_kernel(const int32_t* __restrict__ objects,
                                    const int32_t* __restrict__ lengths,
                                    const uint32_t* __restrict__ words,
                                    const int32_t* __restrict__ shard,
                                    int P, int L, int W,
                                    int32_t* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int32_t* obj = objects + static_cast<int64_t>(p) * L;
  const int len = lengths[p];
  int server = 0;
  if (len > 0) server = max(shard[max(obj[0], 0)], 0);
  int cost = 0;
  const int stop = min(len, L);
  for (int i = 1; i < stop; ++i) {
    const int v = max(obj[i], 0);
    const uint32_t word = words[static_cast<int64_t>(v) * W + (server >> 5)];
    if (!((word >> (server & 31)) & 1u)) {
      server = max(shard[v], 0);
      ++cost;
    }
  }
  out[p] = cost;
}

}  // namespace

extern "C" int path_latency_launch(const void* objects, const void* lengths,
                                   const void* words, const void* shard,
                                   int P, int L, int W, void* out,
                                   void* stream) {
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  path_latency_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(objects),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(shard), P, L, W,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
