// Row top-2 bookkeeping shared by the matching kernels (match_topk2.cu,
// match_topk2_int8.cu).
//
// Each thread scans its columns of a row in increasing order and keeps
// (best, second, best column), seeded at (-2, -2, 0) as the reference's
// _make_topk2_kernel seeds its accumulator.  A similarity replaces the best
// only on a strict '>', so the first column reaching the max wins; the
// second is the max over every other column, so a tie with the best is also
// the second.  The states of the threads that share a row are then merged
// with the reference's rule
//   new_s = max(min(b_old, b_other), max(s_old, s_other)),
// the index taken from the larger best, the lower index on a tie.  Neither
// the scan nor the merge depends on the tiling or on the merge order, so
// any tiles give the reference's 512 x 512 answers.

#pragma once

#include <cuda_runtime.h>

namespace topk2 {

constexpr float kInvalid = -2.f;  // similarity of a masked column; the seed

__device__ __forceinline__ void push(float s, int col, float& rb, float& rs,
                                     int& ri) {
  if (s > rb) {
    rs = rb;
    rb = s;
    ri = col;
  } else if (s > rs) {
    rs = s;
  }
}

// push without branches, for similarities that are never -0 (an FMA chain
// from +0 gives +0 for an exact zero), so that max picks no zero's sign:
// the same state as push.
__device__ __forceinline__ void push_max(float s, int col, float& rb,
                                         float& rs, int& ri) {
  rs = fmaxf(rs, fminf(s, rb));
  ri = s > rb ? col : ri;
  rb = fmaxf(rb, s);
}

// Merge another state (ob, os, oi) of the same row into (rb, rs, ri).
__device__ __forceinline__ void merge(float& rb, float& rs, int& ri, float ob,
                                      float os, int oi) {
  const float ns = fmaxf(fminf(rb, ob), fmaxf(rs, os));
  if (ob > rb || (ob == rb && oi < ri)) ri = oi;
  rb = fmaxf(rb, ob);
  rs = ns;
}

// Merge the 16 per-thread states of each of a thread's 4 rows (rows
// r0 + 4 * ty + i, held by the 16 lanes of a half-warp) and store them;
// lane tx == 0 writes.
__device__ __forceinline__ void merge_store(float (&rb)[4], float (&rs)[4],
                                            int (&ri)[4], int r0, int ty,
                                            int tx, int n, float* best,
                                            float* second, int* best_idx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, rb[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, rs[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, ri[i], off);
      merge(rb[i], rs[i], ri[i], ob, os, oi);
    }
    const int row = r0 + 4 * ty + i;
    if (tx == 0 && row < n) {
      best[row] = rb[i];
      second[row] = rs[i];
      best_idx[row] = ri[i];
    }
  }
}

}  // namespace topk2
