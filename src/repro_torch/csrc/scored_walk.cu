// Score-ranked access walk (Eqn 1 + nearest_copy_dp), full trace.
//
// Replaces the TPU kernel `scored_walk_pallas` (src/repro/kernels/routed_walk.py,
// `_make_scored_kernel`, `_pick`, `_unpack`).  The routed walk of
// routed_walk.cu without lookahead, except that a remote hop at position i
// ranks the holders of object i by the path's own score row
// scores[p, i, :] (the suffix-DP cost-to-go, precomputed in torch) instead
// of a shared load vector: the holder with the lowest score, home winning
// ties (when home >= 0), then the lowest id; -1 when the object has no
// holder.  server0 = len > 0 ? start : 0 and position 0 is local iff
// len > 0; a -1 server is never local.
//
// Design: one thread per path, as in routed_walk.cu.  The TPU kernel
// streams the whole [L, W*32, block] score plane through VMEM; here the
// pick (`pick_holder`, walk_common.cuh) walks the set bits of the object's
// words with __ffs and reads only the holders' scores, 4 bytes each, from
// device memory.  Bound on the card: bytes (the holder-score reads and the
// [P, L] trace writes); no tensor cores.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

__global__ void scored_walk_kernel(const int32_t* __restrict__ objects,
                                   const int32_t* __restrict__ lengths,
                                   const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ home,
                                   const int32_t* __restrict__ start,
                                   const float* __restrict__ scores, int P,
                                   int L, int W,
                                   int32_t* __restrict__ servers,
                                   uint8_t* __restrict__ local) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t base = static_cast<int64_t>(p) * L;
  const int32_t* obj = objects + base;
  const int Sp = W << 5;
  const int len = lengths[p];
  int server = len > 0 ? start[p] : 0;
  servers[base] = server;
  local[base] = len > 0 ? 1 : 0;
  for (int i = 1; i < L; ++i) {
    uint8_t loc = 0;
    if (i < len) {
      const int v = max(obj[i], 0);
      const uint32_t* row = words + static_cast<int64_t>(v) * W;
      if (server >= 0 && ((row[server >> 5] >> (server & 31)) & 1u)) {
        loc = 1;
      } else {
        server = pick_holder(row, nullptr, W, home[v],
                             scores + (base + i) * Sp);
      }
    }
    servers[base + i] = server;
    local[base + i] = loc;
  }
}

}  // namespace

extern "C" int scored_walk_launch(const void* objects, const void* lengths,
                                  const void* words, const void* home,
                                  const void* start, const void* scores,
                                  int P, int L, int W, void* servers,
                                  void* local, void* stream) {
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  scored_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(objects),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(home),
      static_cast<const int32_t*>(start), static_cast<const float*>(scores), P,
      L, W, static_cast<int32_t*>(servers), static_cast<uint8_t*>(local));
  return static_cast<int>(cudaGetLastError());
}
