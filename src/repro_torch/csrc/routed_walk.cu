// Policy-routed access walk (Eqn 1 + a routing policy), full trace.
//
// Replaces the TPU kernel `routed_walk_pallas` (src/repro/kernels/routed_walk.py,
// `_make_kernel`, `_pick`, `_unpack`).  Same integer semantics:
//   server0 = len > 0 ? start : 0, and position 0 is local iff len > 0;
//   at position i < len the hop is local when server >= 0 and the
//   server's bit of object i is set; a -1 server is never local;
//   otherwise the target is home[i] (HOME_FIRST) or the holder pick:
//   the holder with the lowest load, home winning ties (when home >= 0),
//   then the lowest id; -1 when the object has no holder.  With
//   LOOKAHEAD and i + 1 < len, holders of both object i and object i + 1
//   are tried first.
//
// Design: one thread per path.  The per-server load vector is staged in
// shared memory; a pick (`pick_holder`, walk_common.cuh) walks the set bits
// of the object's W words with __ffs instead of unpacking a [W*32] plane,
// so a thread touches only the words of its own objects.  Like the home-first walk it is bound by the
// bytes it reads and writes (the [P, L] trace dominates); no tensor cores.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

template <bool HOME_FIRST, bool LOOKAHEAD>
__global__ void routed_walk_kernel(const int32_t* __restrict__ objects,
                                   const int32_t* __restrict__ lengths,
                                   const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ home,
                                   const int32_t* __restrict__ start,
                                   const float* __restrict__ load,
                                   int P, int L, int W,
                                   int32_t* __restrict__ servers,
                                   uint8_t* __restrict__ local) {
  extern __shared__ float s_load[];
  if (!HOME_FIRST) {
    for (int s = threadIdx.x; s < (W << 5); s += blockDim.x) s_load[s] = load[s];
    __syncthreads();
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t base = static_cast<int64_t>(p) * L;
  const int32_t* obj = objects + base;
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
      } else if (HOME_FIRST) {
        server = home[v];
      } else {
        const int h = home[v];
        int tgt = -1;
        if (LOOKAHEAD && i + 1 < len) {
          const uint32_t* nrow =
              words + static_cast<int64_t>(max(obj[i + 1], 0)) * W;
          tgt = pick_holder(row, nrow, W, h, s_load);
        }
        if (tgt < 0) tgt = pick_holder(row, nullptr, W, h, s_load);
        server = tgt;
      }
    }
    servers[base + i] = server;
    local[base + i] = loc;
  }
}

template <bool HOME_FIRST, bool LOOKAHEAD>
void launch(const void* objects, const void* lengths, const void* words,
            const void* home, const void* start, const void* load, int P,
            int L, int W, void* servers, void* local, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  const size_t smem = HOME_FIRST ? 0 : sizeof(float) * (W << 5);
  routed_walk_kernel<HOME_FIRST, LOOKAHEAD><<<blocks, threads, smem, stream>>>(
      static_cast<const int32_t*>(objects),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(home),
      static_cast<const int32_t*>(start), static_cast<const float*>(load), P,
      L, W, static_cast<int32_t*>(servers), static_cast<uint8_t*>(local));
}

}  // namespace

extern "C" int routed_walk_launch(const void* objects, const void* lengths,
                                  const void* words, const void* home,
                                  const void* start, const void* load, int P,
                                  int L, int W, int home_first, int lookahead,
                                  void* servers, void* local, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (home_first) {
    launch<true, false>(objects, lengths, words, home, start, load, P, L, W,
                        servers, local, s);
  } else if (lookahead) {
    launch<false, true>(objects, lengths, words, home, start, load, P, L, W,
                        servers, local, s);
  } else {
    launch<false, false>(objects, lengths, words, home, start, load, P, L, W,
                         servers, local, s);
  }
  return static_cast<int>(cudaGetLastError());
}
