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
// What bounds it on an H100, at 28 pairs of 4096 x 4096 x 128:
//   * products: 2 * N * M * D int8 operations, 120 G a launch, 0.061 ms on
//     the s8 tensor cores (1,979 TOPS dense);
//   * epilogue: N * M similarities, 470 M a launch, each a conversion, 7
//     separately rounded FMUL / FADD and the top-2 update, about 14
//     instructions.  Each of the SM's 4 schedulers dispatches one warp
//     instruction a clock, so each instruction per similarity costs 0.014
//     ms a launch at 1.98 GHz: the floor is about 0.2 ms, 3x the products'.
// So the tensor cores make the product nearly free, and the design spends
// its care on the epilogue's instruction count and on overlapping it with
// the products.
//
// Design.  One block of three warpgroups per (pair, 128 rows of a1).
// Warpgroup 0 produces: one thread keeps a ring of K slices (128 rows x 128
// bytes of D, 128-byte swizzle) full by TMA, with full / empty mbarriers;
// each slot holds a2's slice of a column tile and the block's a1 slice of
// the same K.  a1 is read again for every column tile (from L2), so shared
// memory does not grow with D and every multiple of 128 launches; keeping
// the block's a1 rows resident instead read the same on the card at D = 128
// (0.341 against 0.342 ms a launch, calls back to back).  TMA's
// out-of-bounds fill zeroes rows past N and columns past M, never reaching
// into the next pair.
// Warp 1 of the producer writes each column tile's table, {s2, s2', inv2,
// inv2'} per column pair, with inv2 replaced by NaN where the column is
// masked (inv2 == 0) or past M.  Warpgroups 1 and 2 each own 64 rows: per
// column tile they run wgmma m64n128k32 s32.s8.s8 over D (4 k32 steps a
// slice, A and B K-major in shared memory), then the epilogue on the 64 s32
// accumulators in registers.  Each consumer keeps two sets of accumulators
// and starts tile j + 1's products before tile j's epilogue.  Integer sums
// are exact in any order, so acc equals the reference's bit for bit.
//
// The epilogue, per similarity:
//   * acc converted by __int2float_rn: one instruction (I2FP.F32.S32 on
//     sm_90).  The exact alternative on the FP32 pipes, float(acc +
//     0x4B400000 as bits) - 1.5 * 2^23 (exact for |acc| <= 2^22), takes two
//     dispatch slots, and the kernel read 5-10% slower with it on the card
//     (scripts/torch_match_variants.py, variant int8_bias_trick);
//   * the 7 float operations in the reference's order; everything per row
//     (s1, inv1) or per column (s2, inv2) is loaded once for the 2 rows and
//     2 columns it serves;
//   * the top-2 update without branches or a mask select
//     (topk2::push_skip_nan): a masked column's NaN similarity leaves the
//     state as the reference's -2 does, and the best column is kept as an
//     index inside the tile (an immediate), made global once a tile.
// Each thread owns rows r and r + 8 and 2 adjacent columns of every 8, in
// increasing order, so the strict '>' keeps the first maximum; the 4 lanes
// of a quad merge once at the end (lower index on a tie).  An invalid row
// (inv1 = 0) reads -0 for a column whose dot is negative and +0 otherwise;
// -0 and +0 compare equal, so its state equals the plain version's up to
// the sign of a zero (and the index, the first valid column, is the same).
//
// On an H100 80GB HBM3 (700 W) the kernel reads 0.40-0.44 ms a launch
// timed per call (chip_smoke.py) and 0.34-0.35 ms with calls back to back;
// back to back, the epilogue alone reads 0.26-0.28 and the products with
// the ring alone 0.10-0.12 (scripts/torch_match_variants.py): they hardly
// overlap, though each consumer has tile j + 1's products in flight.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "topk2.cuh"

namespace {

using namespace sm90;

constexpr int kBlockRows = 128;  // a1 rows per block: 64 per consumer warpgroup
constexpr int kTileCols = 128;   // a2 rows (similarity columns) per tile
constexpr int kSlab = 128;       // bytes of D per K slice: one swizzle row
constexpr int kSlabBytes = kTileCols * kSlab;  // one K slice of a tile, 16 KB
constexpr int kStages = 4;       // ring slots, one K slice of a2 and a1 each
constexpr int kStageBytes = 2 * kSlabBytes;
constexpr int kColStages = 4;    // ring of per-tile column tables
constexpr int kColBytes = kTileCols / 2 * 16;  // one float4 per column pair
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr int kBarriers = 2 * kStages + 2 * kColStages;
// Shared memory of a launch: [ring][column tables][barriers], + alignment.
constexpr int kSmemBytes =
    kStages * kStageBytes + kColStages * kColBytes + 8 * kBarriers + 1024;
static_assert(kSmemBytes <= kMaxSmem, "ring too large for a block");

// acc (+)= A B^T for one k32 step: m64n128k32, s8 A and B K-major in shared
// memory (128-byte swizzle), s32 accumulators; ``accumulate`` 0 overwrites.
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// kDim: the descriptor width fixed at compile time (128, the main path's,
// 2-4% faster on the card than the same width taken at run time), or 0 to
// take dim at run time (every other multiple of 128).
template <int kDim>
__global__ void __launch_bounds__(kThreads, 1)
match_topk2_int8_kernel(const __grid_constant__ CUtensorMap ta1,
                        const __grid_constant__ CUtensorMap ta2,
                        const float* __restrict__ s1,
                        const float* __restrict__ s2,
                        const float* __restrict__ inv1,
                        const float* __restrict__ inv2,
                        const float* __restrict__ coef,
                        float* __restrict__ best, float* __restrict__ second,
                        int* __restrict__ best_idx, int n, int m, int dim_) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int dim = kDim ? kDim : dim_;
  const int slabs = dim / kSlab;
  uint8_t* ring = smem;  // slot s: a2's K slice, then a1's
  float4* tables = reinterpret_cast<float4*>(ring + kStages * kStageBytes);
  const uint32_t bars = smem_addr(tables + kColStages * (kColBytes / 16));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto full_col = [&](int s) { return bars + 8 * (2 * kStages + s); };
  auto empty_col = [&](int s) { return bars + 8 * (2 * kStages + kColStages + s); };

  const int p = blockIdx.y;
  const int r0 = blockIdx.x * kBlockRows;
  const int tiles = (m + kTileCols - 1) / kTileCols;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < kColStages; ++s) {
      mbar_init(full_col(s), 32);  // every lane of the table warp
      mbar_init(empty_col(s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      int it = 0;
      for (int j = 0; j < tiles; ++j) {
        for (int k = 0; k < slabs; ++k, ++it) {
          const int s = it % kStages;
          const uint32_t slot = smem_addr(ring + s * kStageBytes);
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), kStageBytes);
          tma_load_3d(slot, &ta2, full(s), k * kSlab, j * kTileCols, p);
          tma_load_3d(slot + kSlabBytes, &ta1, full(s), k * kSlab, r0, p);
        }
      }
    } else if (warp == 1) {
      // Column tables: lane l writes column pairs l and l + 32 of a tile.
      const float* S2 = s2 + (size_t)p * m;
      const float* I2 = inv2 + (size_t)p * m;
      const float nan = __uint_as_float(0x7FFFFFFFu);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kColStages;
        mbar_wait(empty_col(s), ((j / kColStages) & 1) ^ 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pair = lane + 32 * h;
          float sv[2], iv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * kTileCols + 2 * pair + e;
            const float x = col < m ? I2[col] : 0.f;
            sv[e] = col < m ? S2[col] : 0.f;
            iv[e] = x > 0.f ? x : nan;  // masked: the plain version's -2
          }
          tables[s * (kColBytes / 16) + pair] = make_float4(sv[0], sv[1], iv[0], iv[1]);
        }
        mbar_arrive(full_col(s));  // release: the table is visible to waiters
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int w = warpgroup - 1;  // consumer 0 or 1: rows 64w..64w+63
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const float alpha = coef[0], beta = coef[1], gamma = coef[2];
    const int row0 = r0 + 64 * w + 16 * (t / 32) + lane / 4;  // and row0 + 8
    float row_s[2], row_inv[2], rb[2], rs[2];
    int ri[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      row_s[h] = row < n ? s1[(size_t)p * n + row] : 0.f;
      row_inv[h] = row < n ? inv1[(size_t)p * n + row] : 0.f;
      rb[h] = topk2::kInvalid;
      rs[h] = topk2::kInvalid;
      ri[h] = 0;
    }
    uint32_t acc0[64], acc1[64];  // tile j's epilogue runs beside j + 1's products
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;

    int it = 0;  // K slices taken from the ring so far
    // Start the products of every K slice of tile j into acc.  A slice is released once its
    // group has completed: the one before the last here, the last in done().
    auto multiply = [&](int j, uint32_t (&acc)[64]) {
#pragma unroll 1
      for (int k = 0; k < slabs; ++k, ++it) {
        const int s = it % kStages;
        const uint32_t slot = smem_addr(ring + s * kStageBytes);
        // This consumer's 64 a1 rows of the slice: 8 KB in, swizzle-aligned.
        const uint64_t da = sw128_desc(slot + kSlabBytes + 64 * w * kSlab);
        const uint64_t db = sw128_desc(slot);
        const int keep = k > 0;  // the first slice overwrites acc
        mbar_wait(full(s), (it / kStages) & 1);
        if (k == 0) fence_regs(acc);  // its last epilogue has read it
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 32; ++kk)  // 32 bytes per k32 step
          wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kk > 0 ? 1 : keep);
        wgmma_commit();
        if (k > 0) {
          wgmma_wait<1>();
          if (t == 0) mbar_arrive(empty((it - 1) % kStages));
        }
      }
    };
    auto done = [&](uint32_t (&acc)[64]) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(empty((it - 1) % kStages));
    };
    // The epilogue on tile j's accumulators: element 4c + 2h + e of this
    // thread is row row0 + 8h, column 8c + 2 quad + e of the tile.
    auto epilogue = [&](int j, const uint32_t (&acc)[64]) {
      const int cs = j % kColStages;
      mbar_wait(full_col(cs), (j / kColStages) & 1);
      const float4* table = tables + cs * (kColBytes / 16);
      int local[2] = {-1, -1};  // best column inside this tile, if it moved
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float4 cv = table[4 * c + quad];
        const float col_s[2] = {cv.x, cv.y};
        const float col_inv[2] = {cv.z, cv.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float f = __int2float_rn(static_cast<int>(acc[4 * c + 2 * h + e]));
            const float dot = __fadd_rn(
                __fadd_rn(__fmul_rn(alpha, f),
                          __fmul_rn(beta, __fadd_rn(row_s[h], col_s[e]))),
                gamma);
            const float sim = __fmul_rn(__fmul_rn(dot, row_inv[h]), col_inv[e]);
            topk2::push_skip_nan(sim, 8 * c + e, rb[h], rs[h], local[h]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_col(cs));
      const int col0 = j * kTileCols + 2 * quad;
#pragma unroll
      for (int h = 0; h < 2; ++h) ri[h] = local[h] >= 0 ? col0 + local[h] : ri[h];
    };

    multiply(0, acc0);
    done(acc0);
    // Two tiles a trip, so the accumulators alternate without copies; each
    // multiply() and its done() share a basic block, or ptxas serializes
    // the wgmma.
    int j = 0;
#pragma unroll 1
    for (; j + 2 < tiles; j += 2) {
      multiply(j + 1, acc1);
      epilogue(j, acc0);
      done(acc1);
      multiply(j + 2, acc0);
      epilogue(j + 1, acc1);
      done(acc0);
    }
    if (j + 1 < tiles) {
      multiply(j + 1, acc1);
      epilogue(j, acc0);
      done(acc1);
      epilogue(j + 1, acc1);
    } else {
      epilogue(j, acc0);
    }

    // Merge the 4 lanes of each quad (they share rows) and store.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, rb[h], off);
        const float os = __shfl_xor_sync(0xffffffffu, rs[h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, ri[h], off);
        topk2::merge(rb[h], rs[h], ri[h], ob, os, oi);
      }
      const int row = row0 + 8 * h;
      if (quad == 0 && row < n) {
        const size_t o = (size_t)p * n + row;
        best[o] = rb[h];
        second[o] = rs[h];
        best_idx[o] = ri[h];
      }
    }
  }
}

// The 3-D (D, rows, pairs) int8 tensor map of a (pairs, rows, D) tensor:
// box (128 bytes, 128 rows, 1), 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* base, int pairs, int rows, int dim) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dim, (cuuint64_t)rows, (cuuint64_t)pairs};
  const cuuint64_t strides[2] = {(cuuint64_t)dim, (cuuint64_t)rows * dim};
  const cuuint32_t box[3] = {kSlab, kTileCols, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kDim>
int launch(const CUtensorMap& ta1, const CUtensorMap& ta2, const void* s1,
           const void* s2, const void* inv1, const void* inv2, const void* coef,
           void* best, void* second, void* best_idx, int pairs, int n, int m,
           int dim, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      match_topk2_int8_kernel<kDim>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBlockRows - 1) / kBlockRows, pairs);
  match_topk2_int8_kernel<kDim><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      ta1, ta2, static_cast<const float*>(s1), static_cast<const float*>(s2),
      static_cast<const float*>(inv1), static_cast<const float*>(inv2),
      static_cast<const float*>(coef), static_cast<float*>(best),
      static_cast<float*>(second), static_cast<int*>(best_idx), n, m, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// a1 (pairs, n, dim) and a2 (pairs, m, dim) int8, 16-byte aligned; dim a
// multiple of 128 (the wrapper checks both).
extern "C" int match_topk2_int8_launch(const void* a1, const void* a2,
                                       const void* s1, const void* s2,
                                       const void* inv1, const void* inv2,
                                       const void* coef, void* best,
                                       void* second, void* best_idx, int pairs,
                                       int n, int m, int dim, void* stream) {
  if (dim <= 0 || dim % kSlab != 0 || n < 1 || m < 1 || pairs < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta1, ta2;
  if (!make_map(&ta1, a1, pairs, n, dim) || !make_map(&ta2, a2, pairs, m, dim))
    return (int)cudaErrorInvalidValue;
  if (dim == 128)
    return launch<128>(ta1, ta2, s1, s2, inv1, inv2, coef, best, second, best_idx,
                       pairs, n, m, dim, stream);
  return launch<0>(ta1, ta2, s1, s2, inv1, inv2, coef, best, second, best_idx, pairs,
                   n, m, dim, stream);
}
