// Row top-2 of the descriptor similarity d1 . d2^T, with or without the
// column argmax of the fused cross-check.
//
// Replaces two TPU kernels of vit_colmap_tpu/ops/pallas/match_kernel.py
// with one templated body:
//   * pallas_topk2 (body _make_topk2_kernel), kColmax = false: per row,
//     (best, second, best_idx) over valid columns, invalid columns reading
//     -2 (rules in topk2.cuh);
//   * pallas_topk2_colmax (body _make_topk2_colmax_kernel), kColmax = true:
//     the same rows, and per (64-row tile, column) the column max over valid
//     rows (invalid rows read as -2) and the lowest row reaching it.  The
//     caller merges these partials over row tiles, first occurrence
//     winning, as the reference leaves that merge to XLA.
// Results do not depend on the tiling, so 64 x 64 tiles give the
// reference's 512 x 512 answers.
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
// few compares per similarity element, kept in registers; only the results
// (and, with kColmax, the column partials, N/64 x M per pair) reach device
// memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk2.cuh"

namespace {

using topk2::kInvalid;

constexpr int kDim = 128;
constexpr int kTileN = 64;
constexpr int kTileM = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4x4 similarity tile

template <bool kColmax>
constexpr int smem_bytes() {
  return (kDim * kTileN + kDim * kTileM) * 4 + (kColmax ? 2 * 16 * kTileM * 4 : 0);
}

template <bool kColmax>
__global__ void __launch_bounds__(kThreads)
match_topk2_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                   const uint8_t* __restrict__ valid1,
                   const uint8_t* __restrict__ valid2,
                   float* __restrict__ best, float* __restrict__ second,
                   int* __restrict__ best_idx, float* __restrict__ col_val,
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
  bool row_valid[4];  // row exists and is a valid keypoint (kColmax only)
  float rb[4], rs[4];
  int ri[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    row_ok[i] = row < n;
    row_valid[i] = kColmax && row_ok[i] && valid1[(size_t)p * n + row] != 0;
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
        // Columns reach a thread in increasing order: ties keep the first.
        if (col_ok) topk2::push(s, col, rb[i], rs[i], ri[i]);
        if (kColmax && row_ok[i]) {
          const float sr = row_valid[i] ? s : kInvalid;
          if (sr > cbest) {
            cbest = sr;
            crow = r0 + 4 * ty + i;
          }
        }
      }
      if (kColmax) {
        cv[ty * kTileM + 4 * tx + j] = cbest;
        ci[ty * kTileM + 4 * tx + j] = crow;
      }
    }
    if (kColmax) {
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
  }

  const size_t out0 = (size_t)p * n;
  topk2::merge_store(rb, rs, ri, r0, ty, tx, n, best + out0, second + out0,
                     best_idx + out0);
}

template <bool kColmax>
int launch(const void* d1, const void* d2, const void* valid1,
           const void* valid2, void* best, void* second, void* best_idx,
           void* col_val, void* col_row, int pairs, int n, int m,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      match_topk2_kernel<kColmax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<kColmax>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTileN - 1) / kTileN, pairs);
  match_topk2_kernel<kColmax>
      <<<grid, kThreads, smem_bytes<kColmax>(), (cudaStream_t)stream>>>(
          static_cast<const float*>(d1), static_cast<const float*>(d2),
          static_cast<const uint8_t*>(valid1),
          static_cast<const uint8_t*>(valid2), static_cast<float*>(best),
          static_cast<float*>(second), static_cast<int*>(best_idx),
          static_cast<float*>(col_val), static_cast<int*>(col_row), n, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int match_topk2_colmax_launch(
    const void* d1, const void* d2, const void* valid1, const void* valid2,
    void* best, void* second, void* best_idx, void* col_val, void* col_row,
    int pairs, int n, int m, void* stream) {
  return launch<true>(d1, d2, valid1, valid2, best, second, best_idx, col_val,
                      col_row, pairs, n, m, stream);
}

extern "C" int match_topk2_launch(const void* d1, const void* d2,
                                  const void* valid2, void* best, void* second,
                                  void* best_idx, int pairs, int n, int m,
                                  void* stream) {
  return launch<false>(d1, d2, nullptr, valid2, best, second, best_idx,
                       nullptr, nullptr, pairs, n, m, stream);
}
