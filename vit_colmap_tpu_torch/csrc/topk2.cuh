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

// The update of a state by the similarity s of column col, without
// branches: the same state as
//   if (s > rb) { rs = rb; rb = s; ri = col; } else if (s > rs) { rs = s; }
// for similarities that are never -0 (an FMA chain from +0 gives +0 for an
// exact zero), so that max picks no zero's sign.
__device__ __forceinline__ void push_max(float s, int col, float& rb,
                                         float& rs, int& ri) {
  rs = fmaxf(rs, fminf(s, rb));
  ri = s > rb ? col : ri;
  rb = fmaxf(rb, s);
}

// push_max that also skips a NaN: s = NaN (a masked column) leaves the
// state as it is, as s = -2 does, since fmaxf and fminf return their other
// operand for a NaN and NaN > rb is false.  For any other s (no -0, as for
// push_max) the state is push_max's: rs = min(rb, max(rs, s)) is the second
// of {rb, rs, s} whenever rs <= rb.
__device__ __forceinline__ void push_skip_nan(float s, int col, float& rb,
                                              float& rs, int& ri) {
  rs = fminf(rb, fmaxf(rs, s));
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

}  // namespace topk2
