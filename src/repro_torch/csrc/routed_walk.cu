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
// shared memory (read from device memory instead when its W*32 floats
// exceed kMaxStagedRank, walk_common.cuh); a pick (`pick_rows`) walks the
// set bits of the object's W words with __ffs instead of unpacking a
// [W*32] plane, so a thread touches only the words of its own objects.
// The step (`walk_path`, shared with prune_walk.cu) loads a position's
// words and home before the server-dependent local test; for L <= 8 and
// W == 1 the whole path's words are staged in registers first (a template
// bucket), so a thread's loads are all in flight at once.  Like the
// home-first walk it is bound by the bytes it reads and writes (the
// [P, L] trace dominates); no tensor cores.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

template <bool HOME_FIRST, bool LOOKAHEAD, int LR>
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
  const bool staged = !HOME_FIRST && (W << 5) <= kMaxStagedRank;
  if (staged) {
    for (int s = threadIdx.x; s < (W << 5); s += blockDim.x) s_load[s] = load[s];
    __syncthreads();
  }
  const float* rank = staged ? s_load : load;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t base = static_cast<int64_t>(p) * L;
  const int len = min(lengths[p], L);
  const int server = len > 0 ? start[p] : 0;
  servers[base] = server;
  local[base] = len > 0 ? 1 : 0;
  walk_path<HOME_FIRST, LOOKAHEAD, LR, false>(
      objects + base, L, len, L, words, W, home, server, rank,
      [&](int i, int srv, bool loc) {
        servers[base + i] = srv;
        local[base + i] = loc ? 1 : 0;
        return true;
      });
}

template <bool HOME_FIRST, bool LOOKAHEAD, int LR>
void launch(const void* objects, const void* lengths, const void* words,
            const void* home, const void* start, const void* load, int P,
            int L, int W, void* servers, void* local, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  const size_t smem =
      HOME_FIRST || (W << 5) > kMaxStagedRank ? 0 : sizeof(float) * (W << 5);
  routed_walk_kernel<HOME_FIRST, LOOKAHEAD, LR><<<blocks, threads, smem, stream>>>(
      static_cast<const int32_t*>(objects),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(home),
      static_cast<const int32_t*>(start), static_cast<const float*>(load), P,
      L, W, static_cast<int32_t*>(servers), static_cast<uint8_t*>(local));
}

// The register bucket (L <= 8, W == 1), else the plain loop.
template <bool HOME_FIRST, bool LOOKAHEAD>
void launch_bucket(const void* objects, const void* lengths, const void* words,
                   const void* home, const void* start, const void* load, int P,
                   int L, int W, void* servers, void* local, cudaStream_t s) {
  if (L <= 8 && W == 1) {
    launch<HOME_FIRST, LOOKAHEAD, 8>(objects, lengths, words, home, start, load, P, L, W,
                                     servers, local, s);
  } else {
    launch<HOME_FIRST, LOOKAHEAD, 0>(objects, lengths, words, home, start, load, P, L, W,
                                     servers, local, s);
  }
}

}  // namespace

extern "C" int routed_walk_launch(const void* objects, const void* lengths,
                                  const void* words, const void* home,
                                  const void* start, const void* load, int P,
                                  int L, int W, int home_first, int lookahead,
                                  void* servers, void* local, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (home_first) {
    launch_bucket<true, false>(objects, lengths, words, home, start, load, P, L, W,
                               servers, local, s);
  } else if (lookahead) {
    launch_bucket<false, true>(objects, lengths, words, home, start, load, P, L, W,
                               servers, local, s);
  } else {
    launch_bucket<false, false>(objects, lengths, words, home, start, load, P, L, W,
                                servers, local, s);
  }
  return static_cast<int>(cudaGetLastError());
}
