// Path latency h(p, r, rho) under home-first routing (paper Eqns 1-2).
//
// Replaces the TPU kernel `path_latency_pallas`
// (src/repro/kernels/path_latency.py:93, body `_kernel` at :40).  Same
// integer semantics, equal to `path_latency_plain` bit for bit:
//   server0 = max(shard[max(obj[0], 0)], 0) when len > 0, else 0;
//   position i counts when 1 <= i < min(len, L) and the current server's
//   bit of object i is clear, and the walk then moves to max(shard[v], 0).
//
// Bound: bytes.  The walk reads each path's objects and length once, one
// home entry and one word per valid position, and writes one int32 per
// path, with a few integer operations per byte.  The gathers are random,
// so each moves at least one 32-byte sector, and the walk is a chain: the
// word a position tests depends on the server the previous one left.
//
// Design (one thread per path; a block takes `threads` consecutive rows, 64
// by the wrapper's `launch_plan`, so 8,192 rows reach 128 of 132 SMs):
//  1. Staging.  The block's rows of `objects` are one contiguous span of
//     rows * L int32.  The block copies it into shared memory with 16-byte
//     cp.async; the span is shifted there by its misalignment, so its
//     aligned middle lands aligned, and the unaligned head and tail are
//     plain loads.  Each thread then reads its own row from shared memory.
//     `lengths` is one entry per thread, neighbours on neighbouring
//     addresses.  A span past the 48 KB a block may take without opting in
//     is read in place instead (the wrapper's plan says which).
//  2. Independent gathers.  Only the bit test depends on the server: the
//     object ids, the home entries shard[v] and, for W <= 4 words (up to 128
//     servers), the object's whole word row (one 4-, 8- or 16-byte load;
//     W = 3 as three) are loaded ahead through the read-only path, and the
//     walk is a bit test and a select per position in registers.  For a
//     wider W only shard[v] is loaded ahead, and the one word at walk time.
//     Position 0 loads only its home: its word row is never tested.
//  3. A ring of kGroup slots.  Slot j holds position i's loads; once
//     position i is walked, the slot is refilled with position i + kGroup,
//     so the next kGroup positions' loads are in flight while the walk runs,
//     and any L goes through the same kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;  // positions whose loads are in flight (the wrapper's GROUP)
constexpr int kMaxThreads = 256;

// One position's loads.  WR = 1..4: the object's whole word row; WR = 0:
// the object id, for the one word loaded at walk time.
template <int WR>
struct Slot {
  int32_t home;
  int32_t v;
  uint32_t w[WR > 0 ? WR : 1];
};

__device__ __forceinline__ void cp_async16(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

template <int WR>
__device__ __forceinline__ void fill(Slot<WR>& s, int v, int i,
                                     const int32_t* __restrict__ shard,
                                     const uint32_t* __restrict__ words, bool vec) {
  s.home = __ldg(shard + v);
  if constexpr (WR == 0) {
    s.v = v;
  } else {
    if (i == 0) return;  // position 0 needs only its home
    const uint32_t* row = words + static_cast<int64_t>(v) * WR;
    if constexpr (WR == 4) {
      if (vec) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row));
        s.w[0] = x.x; s.w[1] = x.y; s.w[2] = x.z; s.w[3] = x.w;
        return;
      }
    } else if constexpr (WR == 2) {
      if (vec) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(row));
        s.w[0] = x.x; s.w[1] = x.y;
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < WR; ++k) s.w[k] = __ldg(row + k);
  }
}

// word k of the slot's row, by selects (a dynamic register index would
// put the row in local memory)
template <int WR>
__device__ __forceinline__ uint32_t pick(const Slot<WR>& s, int k) {
  uint32_t x = s.w[0];
#pragma unroll
  for (int j = 1; j < WR; ++j) x = (k == j) ? s.w[j] : x;
  return x;
}

template <int WR>
__global__ void __launch_bounds__(kMaxThreads)
path_latency_kernel(const int32_t* __restrict__ objects, const int32_t* __restrict__ lengths,
                    const uint32_t* __restrict__ words, const int32_t* __restrict__ shard,
                    int P, int L, int W, bool staged, bool vec, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t s_span[];
  const int row0 = blockIdx.x * blockDim.x;
  const int p = row0 + threadIdx.x;
  const int len = p < P ? __ldg(lengths + p) : 0;  // in flight during the staging
  int shift = 0;
  if (staged) {
    const int32_t* span = objects + static_cast<int64_t>(row0) * L;
    const int n = min(static_cast<int>(blockDim.x), P - row0) * L;
    shift = static_cast<int>((reinterpret_cast<uintptr_t>(span) >> 2) & 3);
    const int head = min((4 - shift) & 3, n);
    const int chunks = (n - head) >> 2;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x)
      cp_async16(s_span + shift + head + 4 * c, span + head + 4 * c);
    for (int k = threadIdx.x; k < head; k += blockDim.x) s_span[shift + k] = __ldg(span + k);
    for (int k = head + 4 * chunks + threadIdx.x; k < n; k += blockDim.x)
      s_span[shift + k] = __ldg(span + k);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  if (p >= P) return;
  const int stop = min(len, L);
  const int32_t* s_row = s_span + shift + threadIdx.x * L;
  const int32_t* g_row = objects + static_cast<int64_t>(p) * L;
  auto object = [&](int i) { return max(staged ? s_row[i] : __ldg(g_row + i), 0); };

  Slot<WR> ring[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    if (j < stop) fill(ring[j], object(j), j, shard, words, vec);
  int server = 0;
  int cost = 0;
  for (int base = 0; base < stop; base += kGroup) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int i = base + j;
      if (i < stop) {
        if (i == 0) {
          server = max(ring[j].home, 0);
        } else {
          uint32_t word;
          if constexpr (WR == 0)
            word = __ldg(words + static_cast<int64_t>(ring[j].v) * W + (server >> 5));
          else
            word = pick(ring[j], server >> 5);
          if (!((word >> (server & 31)) & 1u)) {
            server = max(ring[j].home, 0);
            ++cost;
          }
        }
        if (i + kGroup < stop)
          fill(ring[j], object(i + kGroup), i + kGroup, shard, words, vec);
      }
    }
  }
  out[p] = cost;
}

template <int WR>
cudaError_t launch(const void* objects, const void* lengths, const void* words,
                   const void* shard, int P, int L, int W, int threads, bool staged, bool vec,
                   void* out, cudaStream_t stream) {
  const int blocks = (P + threads - 1) / threads;
  const size_t smem = staged ? (static_cast<size_t>(threads) * L + 4) * sizeof(int32_t) : 0;
  path_latency_kernel<WR><<<blocks, threads, smem, stream>>>(
      static_cast<const int32_t*>(objects), static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(shard), P, L, W,
      staged, vec, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// `threads`, `prefetch_row` and `staged` are the wrapper's launch plan
// (`launch_plan`); a staged span past what the block may take fails at
// launch.
extern "C" int path_latency_launch(const void* objects, const void* lengths,
                                   const void* words, const void* shard,
                                   int P, int L, int W, int threads, int prefetch_row,
                                   int staged, void* out, void* stream) {
  if (P < 1 || L < 1 || W < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a row's vector load needs the row aligned to its size (W = 2 and 4)
  const bool vec = reinterpret_cast<uintptr_t>(words) % (4 * static_cast<uintptr_t>(W)) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (prefetch_row ? W : 0) {  // past W = 4: the wide instance
    case 1: err = launch<1>(objects, lengths, words, shard, P, L, W, threads, staged, vec, out, s); break;
    case 2: err = launch<2>(objects, lengths, words, shard, P, L, W, threads, staged, vec, out, s); break;
    case 3: err = launch<3>(objects, lengths, words, shard, P, L, W, threads, staged, vec, out, s); break;
    case 4: err = launch<4>(objects, lengths, words, shard, P, L, W, threads, staged, vec, out, s); break;
    default: err = launch<0>(objects, lengths, words, shard, P, L, W, threads, staged, vec, out, s);
  }
  return static_cast<int>(err);
}
