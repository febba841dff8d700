// Row top-2 of the exact cosine of uint8 descriptors, from int8 dot products.
//
// Replaces the TPU kernel vit_colmap_tpu/ops/pallas/match_kernel.py:
// pallas_topk2_int8 (body _make_topk2_int8_kernel).  For uint8 descriptors
// q with an affine decode and a = q - 128 (int8), the caller precomputes row
// sums s and inverse norms inv (0 marks an invalid row) and the affine
// coefficients (alpha, beta, gamma); then
//   acc = a1 . a2                     exact int32
//   sim = ((alpha * acc + beta * (s1 + s2)) + gamma) * inv1 * inv2
// with every float operation rounded on its own (__fmul_rn / __fadd_rn, so
// nvcc contracts nothing into an FMA), in the reference's order, and
// sim = -2 where inv2 == 0.  The row top-2 rules are those of topk2.cuh.
//
// What bounds it on an H100: 2 * N * M * D int8 operations per pair against
// 1 MB of descriptors; at the s8 tensor-core rate (1,979 TOPS dense) that is
// ~2 us per 4096 x 4096 x 128 pair.  This first version computes acc with
// __dp4a on the integer SIMT pipes (four products per instruction over the
// D / 4 packed words of a row and a column), in 64 x 64 tiles: each
// thread holds a 4x4 register tile of acc, both operand tiles sit in shared
// memory as transposed 32-bit words, so every 16 dp4a cost two int4 shared
// loads.  D is any multiple of 128; acc stays exact in f32, since
// |a1 . a2| <= 128^2 D <= 2^24 up to D = 1,024.  The s8 tensor-core MMA is
// the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk2.cuh"

namespace {

using topk2::kInvalid;

constexpr int kTileN = 64;
constexpr int kTileM = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4x4 tile

// Both operand tiles, (dim / 4) packed 32-bit words per descriptor.
int smem_bytes(int dim) { return (dim / 4) * (kTileN + kTileM) * 4; }

// One tile of descriptors into shared memory as [word][row], 16 bytes
// (4 words) per thread and step; a warp covers 32 consecutive rows of one
// 16-byte chunk, so the transposed stores are conflict-free.
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ src,
                                          int first, int count, int dim,
                                          int* dst, int tid) {
  for (int e = tid; e < kTileN * (dim / 16); e += kThreads) {
    const int r = e % kTileN;
    const int w4 = (e / kTileN) * 4;
    int4 x = make_int4(0, 0, 0, 0);
    if (first + r < count)
      x = *reinterpret_cast<const int4*>(src + (size_t)(first + r) * dim + 4 * w4);
    dst[(w4 + 0) * kTileN + r] = x.x;
    dst[(w4 + 1) * kTileN + r] = x.y;
    dst[(w4 + 2) * kTileN + r] = x.z;
    dst[(w4 + 3) * kTileN + r] = x.w;
  }
}

// kDim: the descriptor width fixed at compile time (128, the main path's,
// which the variants script measured 1-4% faster than the same width taken
// at run time), or 0 to take dim at run time (every other multiple of 128).
template <int kDim>
__global__ void __launch_bounds__(kThreads)
match_topk2_int8_kernel(const int8_t* __restrict__ a1,
                        const int8_t* __restrict__ a2,
                        const float* __restrict__ s1,
                        const float* __restrict__ s2,
                        const float* __restrict__ inv1,
                        const float* __restrict__ inv2,
                        const float* __restrict__ coef,
                        float* __restrict__ best, float* __restrict__ second,
                        int* __restrict__ best_idx, int n, int m,
                        int dim_) {
  extern __shared__ int smem_i[];
  const int dim = kDim ? kDim : dim_;
  const int words = dim / 4;       // packed 32-bit words per descriptor
  int* as = smem_i;                // [word][row]  a1 tile, transposed
  int* bs = as + words * kTileN;   // [word][col]  a2 tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns 4tx..4tx+3 of each tile
  const int ty = tid / 16;  // owns rows 4ty..4ty+3 of the row tile
  const int p = blockIdx.y;
  const int r0 = blockIdx.x * kTileN;
  const float alpha = coef[0], beta = coef[1], gamma = coef[2];
  const float* S2 = s2 + (size_t)p * m;
  const float* I2 = inv2 + (size_t)p * m;

  load_tile(a1 + (size_t)p * n * dim, r0, n, dim, as, tid);

  float row_s[4], row_inv[4];
  float rb[4], rs[4];
  int ri[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    row_s[i] = row < n ? s1[(size_t)p * n + row] : 0.f;
    row_inv[i] = row < n ? inv1[(size_t)p * n + row] : 0.f;
    rb[i] = kInvalid;
    rs[i] = kInvalid;
    ri[i] = 0;
  }

  for (int c0 = 0; c0 < m; c0 += kTileM) {
    __syncthreads();  // the previous tile's bs is no longer read
    load_tile(a2 + (size_t)p * m * dim, c0, m, dim, bs, tid);
    __syncthreads();

    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 8
    for (int w = 0; w < words; ++w) {
      const int4 a = *reinterpret_cast<const int4*>(as + w * kTileN + 4 * ty);
      const int4 b = *reinterpret_cast<const int4*>(bs + w * kTileM + 4 * tx);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 4 * tx + j;
      if (col >= m) continue;
      const float col_s = S2[col];
      const float col_inv = I2[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = kInvalid;
        if (col_inv > 0.f) {
          const float dot = __fadd_rn(
              __fadd_rn(__fmul_rn(alpha, __int2float_rn(acc[i][j])),
                        __fmul_rn(beta, __fadd_rn(row_s[i], col_s))),
              gamma);
          s = __fmul_rn(__fmul_rn(dot, row_inv[i]), col_inv);
        }
        // Columns reach a thread in increasing order: ties keep the first.
        topk2::push(s, col, rb[i], rs[i], ri[i]);
      }
    }
  }

  const size_t out0 = (size_t)p * n;
  topk2::merge_store(rb, rs, ri, r0, ty, tx, n, best + out0, second + out0,
                     best_idx + out0);
}

template <int kDim>
int launch(const void* a1, const void* a2, const void* s1, const void* s2,
           const void* inv1, const void* inv2, const void* coef, void* best,
           void* second, void* best_idx, int pairs, int n, int m, int dim,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      match_topk2_int8_kernel<kDim>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(dim));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTileN - 1) / kTileN, pairs);
  match_topk2_int8_kernel<kDim><<<grid, kThreads, smem_bytes(dim),
                                  (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(a1), static_cast<const int8_t*>(a2),
      static_cast<const float*>(s1), static_cast<const float*>(s2),
      static_cast<const float*>(inv1), static_cast<const float*>(inv2),
      static_cast<const float*>(coef), static_cast<float*>(best),
      static_cast<float*>(second), static_cast<int*>(best_idx), n, m, dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int match_topk2_int8_launch(const void* a1, const void* a2,
                                       const void* s1, const void* s2,
                                       const void* inv1, const void* inv2,
                                       const void* coef, void* best,
                                       void* second, void* best_idx, int pairs,
                                       int n, int m, int dim, void* stream) {
  if (dim <= 0 || dim % 128 != 0) return (int)cudaErrorInvalidValue;
  if (dim == 128)
    return launch<128>(a1, a2, s1, s2, inv1, inv2, coef, best, second,
                       best_idx, pairs, n, m, dim, stream);
  return launch<0>(a1, a2, s1, s2, inv1, inv2, coef, best, second, best_idx,
                   pairs, n, m, dim, stream);
}
