// Fused row top-2 and column argmax over the descriptor similarity d1 . d2^T.
//
// Replaces the TPU kernel vit_colmap_tpu/ops/pallas/match_kernel.py:
// pallas_topk2_colmax (body _make_topk2_colmax_kernel).  One pass over the
// (N, M) similarity of each image pair gives
//   * per row: (best, second, best_idx) over valid columns, invalid columns
//     read as -2, the first column winning ties, state seeded at (-2, -2, 0)
//     and merged with the reference's rule
//       new_s = max(min(b_old, local_b), max(s_old, local_s)),
//       index replaced only on a strict '>';
//   * per (64-row tile, column): the column max over valid rows (invalid rows
//     read as -2) and the lowest row reaching it.  The caller merges these
//     partials over row tiles, first occurrence winning, as the reference
//     leaves that merge to XLA.
// Row and column results do not depend on the tiling, so this kernel's
// 64 x 64 tiles give the reference's 512 x 512 answers.
//
// Similarities are IEEE fp32 FMA chains in a fixed order: s = fma(a_d, b_d, s)
// for d = 0..D-1 from s = 0, never TF32.  The plain PyTorch version repeats
// that order, so kernel and plain version agree bit for bit and near-ties
// break the same way.
//
// What bounds it on an H100: 2 * N * M * D FLOP per pair (4.3 GFLOP at
// 4096 x 4096 x 128) against 4 MB of descriptors, so arithmetic bounds it;
// on the fp32 SIMT pipes (67 TFLOP/s) that is ~64 us per pair.  Each thread
// holds a 4x4 register tile of the similarity, the d1 row tile stays in
// shared memory while d2 column tiles stream, and both are stored transposed
// so every 16 FMAs cost two float4 shared loads.  The top-2 bookkeeping is a
// few compares per similarity element, kept in registers; only the column
// partials (N/64 x M per pair) reach device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;
constexpr int kTileN = 64;
constexpr int kTileM = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4x4 similarity tile
constexpr float kInvalid = -2.f;
constexpr int kSmemBytes =
    (kDim * kTileN + kDim * kTileM) * 4 + 2 * 16 * kTileM * 4;

__global__ void __launch_bounds__(kThreads)
match_topk2_colmax_kernel(const float* __restrict__ d1,
                          const float* __restrict__ d2,
                          const uint8_t* __restrict__ valid1,
                          const uint8_t* __restrict__ valid2,
                          float* __restrict__ best, float* __restrict__ second,
                          int* __restrict__ best_idx,
                          float* __restrict__ col_val,
                          int* __restrict__ col_row, int n, int m) {
  extern __shared__ float smem[];
  float* as = smem;                    // [d][row]  d1 tile, transposed
  float* bs = as + kDim * kTileN;      // [d][col]  d2 tile, transposed
  float* cv = bs + kDim * kTileM;      // [ty][col] column partial values
  int* ci = reinterpret_cast<int*>(cv + 16 * kTileM);  // [ty][col] rows

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns 4tx..4tx+3 of each tile
  const int ty = tid / 16;  // owns rows 4ty..4ty+3 of the row tile
  const int rt = blockIdx.x;
  const int p = blockIdx.y;
  const int r0 = rt * kTileN;
  const int num_row_tiles = gridDim.x;
  const float* A = d1 + (size_t)p * n * kDim;
  const float* B = d2 + (size_t)p * m * kDim;
  const uint8_t* v1 = valid1 + (size_t)p * n;
  const uint8_t* v2 = valid2 + (size_t)p * m;

  // Row tile of d1, loaded once.  A warp covers 32 consecutive rows of one
  // 4-column chunk, so the transposed shared stores are conflict-free.
  for (int e = tid; e < kTileN * (kDim / 4); e += kThreads) {
    const int r = e % kTileN;
    const int c4 = (e / kTileN) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      x = *reinterpret_cast<const float4*>(A + (size_t)(r0 + r) * kDim + c4);
    as[(c4 + 0) * kTileN + r] = x.x;
    as[(c4 + 1) * kTileN + r] = x.y;
    as[(c4 + 2) * kTileN + r] = x.z;
    as[(c4 + 3) * kTileN + r] = x.w;
  }

  bool row_ok[4];     // row exists (< n)
  bool row_valid[4];  // row exists and is a valid keypoint
  float rb[4], rs[4];
  int ri[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    row_ok[i] = row < n;
    row_valid[i] = row_ok[i] && v1[row] != 0;
    rb[i] = kInvalid;
    rs[i] = kInvalid;
    ri[i] = 0;
  }

  for (int c0 = 0; c0 < m; c0 += kTileM) {
    __syncthreads();  // previous tile's bs / cv / ci are no longer read
    for (int e = tid; e < kTileM * (kDim / 4); e += kThreads) {
      const int r = e % kTileM;
      const int c4 = (e / kTileM) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + r < m)
        x = *reinterpret_cast<const float4*>(B + (size_t)(c0 + r) * kDim + c4);
      bs[(c4 + 0) * kTileM + r] = x.x;
      bs[(c4 + 1) * kTileM + r] = x.y;
      bs[(c4 + 2) * kTileM + r] = x.z;
      bs[(c4 + 3) * kTileM + r] = x.w;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kDim; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(as + d * kTileN + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(bs + d * kTileM + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 4 * tx + j;
      const bool col_ok = col < m;
      const bool col_valid = col_ok && v2[col] != 0;
      float cbest = -INFINITY;
      int crow = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = col_valid ? acc[i][j] : kInvalid;
        if (col_ok) {
          // Columns reach a thread in increasing order: ties keep the first.
          if (s > rb[i]) {
            rs[i] = rb[i];
            rb[i] = s;
            ri[i] = col;
          } else if (s > rs[i]) {
            rs[i] = s;
          }
        }
        if (row_ok[i]) {
          const float sr = row_valid[i] ? s : kInvalid;
          if (sr > cbest) {
            cbest = sr;
            crow = r0 + 4 * ty + i;
          }
        }
      }
      cv[ty * kTileM + 4 * tx + j] = cbest;
      ci[ty * kTileM + 4 * tx + j] = crow;
    }
    __syncthreads();
    if (tid < kTileM && c0 + tid < m) {
      float vbest = cv[tid];
      int vrow = ci[tid];
      for (int t = 1; t < 16; ++t) {  // rows increase with t: strict '>'
        const float v = cv[t * kTileM + tid];
        if (v > vbest) {
          vbest = v;
          vrow = ci[t * kTileM + tid];
        }
      }
      const size_t o = ((size_t)p * num_row_tiles + rt) * m + c0 + tid;
      col_val[o] = vbest;
      col_row[o] = vrow;
    }
  }

  // Merge the 16 per-thread row states of each row (lanes of a half-warp).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, rb[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, rs[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, ri[i], off);
      const float ns = fmaxf(fminf(rb[i], ob), fmaxf(rs[i], os));
      if (ob > rb[i] || (ob == rb[i] && oi < ri[i])) ri[i] = oi;
      rb[i] = fmaxf(rb[i], ob);
      rs[i] = ns;
    }
    const int row = r0 + 4 * ty + i;
    if (tx == 0 && row < n) {
      best[(size_t)p * n + row] = rb[i];
      second[(size_t)p * n + row] = rs[i];
      best_idx[(size_t)p * n + row] = ri[i];
    }
  }
}

}  // namespace

extern "C" int match_topk2_colmax_launch(
    const void* d1, const void* d2, const void* valid1, const void* valid2,
    void* best, void* second, void* best_idx, void* col_val, void* col_row,
    int pairs, int n, int m, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      match_topk2_colmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTileN - 1) / kTileN, pairs);
  match_topk2_colmax_kernel<<<grid, kThreads, kSmemBytes,
                              (cudaStream_t)stream>>>(
      static_cast<const float*>(d1), static_cast<const float*>(d2),
      static_cast<const uint8_t*>(valid1), static_cast<const uint8_t*>(valid2),
      static_cast<float*>(best), static_cast<float*>(second),
      static_cast<int*>(best_idx), static_cast<float*>(col_val),
      static_cast<int*>(col_row), n, m);
  return (int)cudaGetLastError();
}
