// The remote-hop holder pick shared by the walk kernels (routed_walk.cu,
// scored_walk.cu, provision_update.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Lowest-rank holder among the set bits of row[w] & mask[w] (mask may be
// null); home wins a tie with the minimum, then the lowest id.  `rank` is
// indexed by server id: a shared load vector or one path's score row.
// -1 when no bit is set.  The set bits are walked in ascending order with
// __ffs and only a strictly lower rank replaces the best, so the lowest id
// among the minima is kept, as the TPU kernel's argmax over `lv <= min` is.
__device__ __forceinline__ int pick_holder(const uint32_t* row,
                                           const uint32_t* mask, int W,
                                           int home, const float* rank) {
  int best_id = -1;
  float best = 0.0f;
  for (int w = 0; w < W; ++w) {
    uint32_t bits = row[w] & (mask ? mask[w] : 0xFFFFFFFFu);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const int s = (w << 5) + b;
      const float l = rank[s];
      if (best_id < 0 || l < best) {
        best = l;
        best_id = s;
      }
    }
  }
  if (best_id >= 0 && home >= 0 && home < (W << 5)) {
    const uint32_t hw = row[home >> 5] & (mask ? mask[home >> 5] : 0xFFFFFFFFu);
    if (((hw >> (home & 31)) & 1u) && rank[home] <= best) return home;
  }
  return best_id;
}
