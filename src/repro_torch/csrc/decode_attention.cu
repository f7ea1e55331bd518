// GQA flash-decode: one query token per sequence over a KV cache.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py:64, body `_kernel`).  q [B, KV, G, hd],
// k/v [B, T, KV, hd] in f32 or bf16, lengths int32 [B]; row (b, kv, g)
// attends to cache positions t < lengths[b] with f32 scores and softmax, and
// the output [B, KV, G, hd] is written in q's dtype.  A length of 0 (or
// less) follows the oracle `decode_attention_ref` (src/repro/kernels/ref.py):
// every score is masked, so the softmax is uniform and the row is the mean
// of v over the T cache rows.  (The TPU kernel averages over its padded
// cache instead; it agrees with the oracle for every length in [1, T].)
//
// Bound on the card: bytes.  Each valid cache element is read once for
// 2 * G flops (G <= 32), far below the ~295 flops per byte of the tensor
// cores, so the design is about keeping every SM reading: the cache is split
// across blocks (flash-decoding).
//
// Design: two launches.  `decode_split_kernel` runs one block per (split,
// kv head, b); split s covers cache rows [s * chunk, (s + 1) * chunk), and the
// wrapper picks the split count so that B * KV * splits fills the card.  A
// block walks its chunk in 64-key tiles (double-buffered where the chunk
// spans more than one), staged with 16-byte `cp.async` loads into rows
// padded to an odd number of 16-byte words (so the
// lanes of a warp reading 32 rows hit distinct banks); rows past the
// sequence's length are zero-filled and never read from device memory, and a
// chunk wholly past it loads nothing and writes an empty partial.  Each K and
// V row is read once for all G query heads: for the scores, lanes run over
// keys (a thread takes one key and half of the G rows, reading the query
// rows as shared-memory broadcasts), so no dot product needs a shuffle
// chain; the online softmax is one warp per row per tile; for P V a thread
// owns one dim of all G rows.  The partial (m, l, acc[hd]) stays f32.
// The kernel is templated on G rounded up to a power of two, so its loops
// over rows have fixed trip counts (no branch breaks the FMA chains apart).
// `decode_combine_kernel` rescales the partials by exp(m_s - m), sums them
// and divides by the summed l; it is launched as a programmatic dependent of
// the split kernel, so its launch overlaps that kernel's tail.  Length <= 0 zeroes the query, so every split
// is uniform over its chunk of all T rows and the combined row is the mean of
// v over T.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKeys = 64;    // keys per shared-memory tile (two per lane in the softmax)
constexpr int kMaxG = 32;    // query heads per kv head

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The 16 bytes at p as f32 (4 f32 or 8 bf16).
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// row_bytes: a cache row in shared memory, hd rounded up to 16 bytes and then
// to an odd number of 16-byte words.  vec: 16-byte loads (hd * elt a multiple
// of 16 and q, k, v 16-byte aligned), else element loads.  nbuf: K/V tile
// buffers, 2 (double-buffered) where a chunk spans more than one tile, else 1
// (less shared memory, more blocks on an SM).  GP: G rounded up to a power of
// two, so every loop over rows has a fixed trip count and no branch; rows
// G .. GP - 1 have a zero query and are computed but never written.
template <typename T, int GP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int32_t* __restrict__ lengths, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int T_len, int KV, int G, int hd, int chunk,
                    int row_bytes, int vec, int nbuf) {
  constexpr int E = 16 / sizeof(T);        // elements per 16-byte word
  constexpr int RPT = (GP + 1) / 2;         // score rows per thread
  constexpr int RPW = (GP + 3) / 4;         // softmax rows per warp
  extern __shared__ __align__(16) uint8_t smem[];
  // the combine launch may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z, splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hdv = (hd + E - 1) / E * E;
  const int tile_bytes = kKeys * row_bytes;
  uint8_t* kbuf = smem;                     // [nbuf][kKeys][row_bytes]
  uint8_t* vbuf = smem + nbuf * tile_bytes;  // [nbuf][kKeys][row_bytes]
  float* qs = reinterpret_cast<float*>(smem + 2 * nbuf * tile_bytes);  // [GP][hdv]
  float* ss = qs + GP * hdv;                                            // [GP][kKeys]
  float* alpha = ss + GP * kKeys;                                       // [GP]

  const int len = lengths[b];
  const bool uniform = len <= 0;  // every row with equal (zero) scores
  const int hi = uniform ? T_len : min(len, T_len);
  const int c0 = split * chunk, c1 = min(min(c0 + chunk, T_len), hi);  // keys [c0, c1)
  const int64_t part = (static_cast<int64_t>(b) * KV + kv) * splits + split;
  float* pacc = part_acc + part * G * hd;
  float* pml = part_ml + part * G * 2;
  if (c0 >= c1) {  // the chunk lies past the sequence: an empty partial
    for (int i = tid; i < G * hd; i += kThreads) pacc[i] = 0.0f;
    for (int g = tid; g < G; g += kThreads) {
      pml[2 * g] = -INFINITY;
      pml[2 * g + 1] = 0.0f;
    }
    return;
  }

  const int64_t stride = static_cast<int64_t>(KV) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * T_len * KV + kv) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * T_len * KV + kv) * hd;
  const int n_tiles = (c1 - c0 + kKeys - 1) / kKeys;
  auto load = [&](int t) {
    const int t0 = c0 + t * kKeys, nk = min(kKeys, c1 - t0);
    uint8_t* kd = kbuf + (t & (nbuf - 1)) * tile_bytes;
    uint8_t* vd = vbuf + (t & (nbuf - 1)) * tile_bytes;
    if (vec) {
      const int words = hd / E;
      for (int i = tid; i < kKeys * words; i += kThreads) {
        const int j = i / words, c = i - j * words;
        const bool ok = j < nk;
        const int64_t off = (ok ? t0 + j : c0) * stride + c * E;
        cp_async16(kd + j * row_bytes + c * 16, kb + off, ok);
        cp_async16(vd + j * row_bytes + c * 16, vb + off, ok);
      }
    } else {
      for (int i = tid; i < kKeys * hdv; i += kThreads) {
        const int j = i / hdv, d = i - j * hdv;
        const bool ok = j < nk && d < hd;
        const int64_t off = (t0 + j) * stride + d;
        reinterpret_cast<T*>(kd + j * row_bytes)[d] = ok ? kb[off] : from_f32<T>(0.0f);
        reinterpret_cast<T*>(vd + j * row_bytes)[d] = ok ? vb[off] : from_f32<T>(0.0f);
      }
    }
    cp_async_commit();
  };

  load(0);
  const T* qb = q + (static_cast<int64_t>(b) * KV + kv) * G * hd;
  if (vec) {  // one independent 16-byte load per word of q
    const int words = hd / E;
#pragma unroll 4
    for (int i = tid; i < G * words; i += kThreads) {
      float x[8];
      load_chunk(qb + i * E, x);
      float* dst = qs + i * E;  // hdv == hd here
#pragma unroll
      for (int e = 0; e < E; ++e) dst[e] = uniform ? 0.0f : x[e];
    }
  } else {
    for (int i = tid; i < G * hdv; i += kThreads) {
      const int g = i / hdv, d = i - g * hdv;
      qs[i] = (!uniform && d < hd) ? attn::to_f32(qb[g * hd + d]) : 0.0f;
    }
  }
  for (int i = G * hdv + tid; i < GP * hdv; i += kThreads) qs[i] = 0.0f;  // padding rows
  const float inv_sqrt_hd = 1.0f / sqrtf(static_cast<float>(hd));

  float m_r[RPW], l_r[RPW];  // warp w owns rows g = w + 4 r
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.0f;
  }
  float acc[GP];  // thread d = tid owns dim d of every row
#pragma unroll
  for (int g = 0; g < GP; ++g) acc[g] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q) are in shared memory
    const int t0 = c0 + t * kKeys, nk = min(kKeys, c1 - t0);
    const uint8_t* kt = kbuf + (t & (nbuf - 1)) * tile_bytes;
    const uint8_t* vt = vbuf + (t & (nbuf - 1)) * tile_bytes;

    {  // scores: thread (key j, half) takes rows g = half, half + 2, ... (row 0 if GP = 1)
      const int j = tid & (kKeys - 1), half = tid / kKeys;
      float sc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sc[i] = 0.0f;
      const T* krow = reinterpret_cast<const T*>(kt + j * row_bytes);
#pragma unroll 2
      for (int c = 0; c < hdv; c += E) {
        float kf[8];
        load_chunk(krow + c, kf);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {  // the 16-byte q words, broadcast to the warp
          const float4* qg = reinterpret_cast<const float4*>(qs + ((half + 2 * i) % GP) * hdv + c);
#pragma unroll
          for (int w = 0; w < E / 4; ++w) {
            const float4 qq = qg[w];
            sc[i] = fmaf(qq.x, kf[4 * w], sc[i]);
            sc[i] = fmaf(qq.y, kf[4 * w + 1], sc[i]);
            sc[i] = fmaf(qq.z, kf[4 * w + 2], sc[i]);
            sc[i] = fmaf(qq.w, kf[4 * w + 3], sc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        ss[((half + 2 * i) % GP) * kKeys + j] = j < nk ? sc[i] * inv_sqrt_hd : -INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {  // the online softmax, one warp per row
      const int g = warp + 4 * r;
      if (g >= GP) continue;
      const float s0 = ss[g * kKeys + lane], s1 = ss[g * kKeys + lane + 32];
      const float m_new = fmaxf(m_r[r], attn::warp_max(fmaxf(s0, s1)));
      float a = 1.0f, p0 = 0.0f, p1 = 0.0f;
      if (m_new != -INFINITY) {
        a = expf(m_r[r] - m_new);  // m = -inf gives 0
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
      }
      l_r[r] = l_r[r] * a + attn::warp_sum(p0 + p1);
      m_r[r] = m_new;
      ss[g * kKeys + lane] = p0;
      ss[g * kKeys + lane + 32] = p1;
      if (lane == 0) alpha[g] = a;
    }
    __syncthreads();
    if (tid < hd) {  // acc[g] = acc[g] * alpha[g] + sum_j p[g][j] v[j][tid]
#pragma unroll
      for (int g = 0; g < GP; ++g) acc[g] *= alpha[g];
      const int jn = (nk + 3) & ~3;  // rows past nk are zero with p = 0
      for (int j = 0; j < jn; j += 4) {
        float vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[e] = attn::to_f32(reinterpret_cast<const T*>(vt + (j + e) * row_bytes)[tid]);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float4 p = *reinterpret_cast<const float4*>(ss + g * kKeys + j);
          acc[g] = fmaf(p.x, vv[0], fmaf(p.y, vv[1], fmaf(p.z, vv[2], fmaf(p.w, vv[3], acc[g]))));
        }
      }
    }
    __syncthreads();  // the next load may overwrite this tile's buffers
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int g = warp + 4 * r;
    if (g < G && lane == 0) {
      pml[2 * g] = m_r[r];
      pml[2 * g + 1] = l_r[r];
    }
  }
  if (tid < hd) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
      if (g < G) pacc[g * hd + tid] = acc[g];
  }
}

// One block per (g, kv, b), one thread per dim: out = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30) with w_s = exp(m_s - max_s m_s).  Launched as a
// programmatic dependent of the split kernel: its launch overlaps that
// kernel's tail, and it waits here until the partials are written.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml, T* __restrict__ out,
                                      int splits, int G, int hd) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int g = blockIdx.x, kv = blockIdx.y, b = blockIdx.z, KV = gridDim.y;
  const int64_t p0 = (static_cast<int64_t>(b) * KV + kv) * splits;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_ml[((p0 + s) * G + g) * 2]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.0f, acc = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const int64_t row = (p0 + s) * G + g;
      const float ms = part_ml[row * 2];
      const float w = ms == -INFINITY ? 0.0f : expf(ms - m);
      l = fmaf(w, part_ml[row * 2 + 1], l);
      acc = fmaf(w, part_acc[row * hd + d], acc);
    }
    attn::store(out + ((static_cast<int64_t>(b) * KV + kv) * G + g) * hd + d,
                acc / fmaxf(l, 1e-30f));
  }
}

// The most dynamic shared memory a split block takes: f32, hd 128, G 32.
constexpr int kMaxSmem = 4 * kKeys * 528 + (kMaxG * 128 + kMaxG * kKeys + kMaxG) * 4;

template <typename T, int GP>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* lengths,
                         float* part_acc, float* part_ml, int B, int T_len, int KV, int G,
                         int hd, int chunk, int splits, int row_bytes, bool vec, int nbuf,
                         cudaStream_t stream) {
  static bool allowed[64] = {};  // the shared-memory limit is raised once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && !allowed[dev]) {
    err = cudaFuncSetAttribute(decode_split_kernel<T, GP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    allowed[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  constexpr int E = 16 / sizeof(T);
  const int hdv = (hd + E - 1) / E * E;
  const int smem = 2 * nbuf * kKeys * row_bytes + (GP * hdv + GP * kKeys + GP) * 4;
  decode_split_kernel<T, GP><<<dim3(splits, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(lengths), part_acc, part_ml, T_len, KV, G, hd, chunk,
      row_bytes, vec ? 1 : 0, nbuf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   float* part_acc, float* part_ml, void* out, int B, int T_len, int KV, int G,
                   int hd, int chunk, int splits, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = (hd % E) == 0 && (reinterpret_cast<uintptr_t>(q) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(k) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) % 16) == 0;
  const int nbuf = chunk > kKeys ? 2 : 1;
  int row_bytes = (hd * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  if ((row_bytes / 16) % 2 == 0) row_bytes += 16;
  cudaError_t err;
#define DECODE_SPLIT(GP)                                                                       \
  launch_split<T, GP>(q, k, v, lengths, part_acc, part_ml, B, T_len, KV, G, hd, chunk, splits, \
                      row_bytes, vec, nbuf, stream)
  if (G <= 1) err = DECODE_SPLIT(1);
  else if (G <= 2) err = DECODE_SPLIT(2);
  else if (G <= 4) err = DECODE_SPLIT(4);
  else if (G <= 8) err = DECODE_SPLIT(8);
  else if (G <= 16) err = DECODE_SPLIT(16);
  else err = DECODE_SPLIT(32);
#undef DECODE_SPLIT
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, KV, B);
  cfg.blockDim = dim3((hd + 31) / 32 * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, static_cast<const float*>(part_acc),
                            static_cast<const float*>(part_ml), static_cast<T*>(out), splits, G,
                            hd);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd <= 128, G <= 32, T >= 1; part_acc
// f32 [B, KV, splits, G, hd] and part_ml f32 [B, KV, splits, G, 2] are
// scratch; splits = ceil(T / chunk).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* part_acc, void* part_ml,
                                       void* out, int B, int T_len, int KV, int G, int hd,
                                       int chunk, int splits, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (hd > 128 || G > kMaxG || chunk < 1 || splits * chunk < T_len)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  const cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(q, k, v, lengths, pa, pm, out, B, T_len, KV, G, hd,
                                         chunk, splits, st)
                 : launch<float>(q, k, v, lengths, pa, pm, out, B, T_len, KV, G, hd, chunk,
                                 splits, st);
  return static_cast<int>(err);
}
