// Row top-2 of the descriptor similarity d1 . d2^T, with or without the
// column argmax of the fused cross-check.
//
// Replaces two TPU kernels of vit_colmap_tpu/ops/pallas/match_kernel.py
// with one templated body:
//   * pallas_topk2 (body _make_topk2_kernel), kColmax = false: per row,
//     (best, second, best_idx) over valid columns, invalid columns reading
//     -2 (rules in topk2.cuh);
//   * pallas_topk2_colmax (body _make_topk2_colmax_kernel), kColmax = true:
//     the same rows, and per (128-row tile, column) the column max over
//     valid rows (invalid rows read as -2) and the lowest row reaching it.
//     The caller merges these partials over row tiles, first occurrence
//     winning, as the reference leaves that merge to XLA.
// Results do not depend on the tiling, so 128 x 128 tiles give the
// reference's 512 x 512 answers.  D is any multiple of 128, as the
// reference's kernels take.
//
// Similarities are IEEE fp32 FMA chains in a fixed order: s = fma(a_d, b_d, s)
// for d = 0..D-1 from s = 0, never split over d and never TF32.  The plain
// PyTorch version repeats that order, so kernel and plain version agree bit
// for bit and near-ties break the same way.  That contract is why the body
// stays off the tensor cores: TF32, 3xTF32 or bf16 products on wgmma would
// round or reorder the sum and move ties.
//
// What bounds it on an H100: 2 * N * M * D FLOP per pair (4.3 GFLOP at
// 4096 x 4096 x 128) against 4 MB of descriptors, so the fp32 FMA pipes
// (67 TFLOP/s at 1,980 MHz, ~64 us per pair) bound it, not bytes.  What the
// design does about it:
//   * each block computes a 128 x 128 output tile with 256 threads, each an
//     8 x 8 register tile (64 independent FMA chains): rows
//     64 * half + lane % 8 + 8 i, columns 16 j + 4 * (warp % 4) + lane / 8;
//   * operands stream through a 4-stage ring of 32-value chunks (16 KB of
//     d1 rows and 16 KB of d2 columns a stage), filled by cp.async 16-byte
//     copies (zero-filled past N and M) and stored untransposed with an XOR
//     swizzle of the 16-byte pieces (piece c of row r at c ^ (r % 8)): the
//     eight rows, or four columns, that a warp reads at one d land on
//     distinct banks, and one float4 shared load feeds 32 FMAs of a thread
//     (one wavefront per 16 FFMA of a warp);
//   * one block walks every column tile of its (pair, row tile) in
//     increasing order, so each thread scans its columns in order and keeps
//     its rows' top-2 in registers; the states of a row's 16 threads are
//     merged once, at the end;
//   * a tile's column partials are reduced over the eight lanes of each
//     64-row half by a reduce-scatter of warp shuffles (lane l keeps column
//     l % 8 of its eight) and written to shared memory; 128 threads merge
//     the two halves and store them after the next chunk's barrier, so
//     they add no block-wide barrier.
// Only the results (and, with kColmax, the column partials, N/128 x M per
// pair) reach device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk2.cuh"

namespace {

using topk2::kInvalid;

constexpr int kTile = 128;    // rows and columns of a block's output tile
constexpr int kChunk = 32;    // descriptor values per ring stage
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kChunkFloats = kTile * kChunk;       // one operand: 16 KB
constexpr int kStageFloats = 2 * kChunkFloats;     // d1 rows, d2 columns
constexpr int kRingFloats = kStages * kStageFloats;
constexpr int kSlotFloats = 2 * 2 * kTile;         // [half][col] value, row

template <bool kColmax>
constexpr int smem_bytes() {
  return (kRingFloats + (kColmax ? 2 * kSlotFloats : 0)) * 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A thread's share of a chunk of 128 rows stored as [row][piece ^ (row %
// 8)][4]: piece tid % 8 of rows tid / 8 + 32 u (u < 4).  src points at that
// piece of the chunk in the first of these rows; bit u of inside says that
// row u exists (rows past N or M read zeros, and their copy reads nothing:
// src-size 0, from the operand's base).
constexpr int kCopies = kChunkFloats / 4 / kThreads;
constexpr int kRowsApart = kThreads / (kChunk / 4);

__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           const float* base, size_t rows_apart,
                                           unsigned inside) {
#pragma unroll
  for (int u = 0; u < kCopies; ++u) {
    const bool in = inside >> u & 1u;
    cp_async16(dst + u * kRowsApart * kChunk, in ? src + u * rows_apart : base, in);
  }
}

// Bit u: row first + tid / 8 + 32 u is below count.
__device__ __forceinline__ unsigned rows_inside(int first, int count, int tid) {
  unsigned inside = 0;
#pragma unroll
  for (int u = 0; u < kCopies; ++u)
    if (first + tid / (kChunk / 4) + u * kRowsApart < count) inside |= 1u << u;
  return inside;
}

// acc[i][j] += a_d * b_d for the 32 values of one chunk, in order of d.
// a: the thread's first row in the stage (its rows are 8 apart), b: its
// first column (16 apart); sa, sb: the swizzle of those rows / columns.
__device__ __forceinline__ void fma_chunk(const float* a, const float* b,
                                          int sa, int sb,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    float4 av[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * 8 * kChunk + 4 * (q ^ sa));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + j * 16 * kChunk + 4 * (q ^ sb));
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
  }
}

// (v, r) := (ov, orow) if that is the larger value, or the lower row on a
// tie: the column max rule.
__device__ __forceinline__ void take_larger(float& v, int& r, float ov,
                                            int orow) {
  if (ov > v || (ov == v && orow < r)) {
    v = ov;
    r = orow;
  }
}

// One step of a reduce-scatter over the lanes lane ^ kWidth: of the
// 2 kWidth columns in v[0..2 kWidth), a lane keeps the upper kWidth if its
// bit kWidth is set, else the lower, merged with its partner's, in
// v[0..kWidth).
template <int kWidth>
__device__ __forceinline__ void scatter_step(float (&v)[8], int (&r)[8],
                                             int lane) {
  const bool upper = lane & kWidth;
#pragma unroll
  for (int c = 0; c < kWidth; ++c) {
    float keep_v = upper ? v[c + kWidth] : v[c];
    int keep_r = upper ? r[c + kWidth] : r[c];
    const float ov = __shfl_xor_sync(0xffffffffu, upper ? v[c] : v[c + kWidth], kWidth);
    const int orow = __shfl_xor_sync(0xffffffffu, upper ? r[c] : r[c + kWidth], kWidth);
    take_larger(keep_v, keep_r, ov, orow);
    v[c] = keep_v;
    r[c] = keep_r;
  }
}

// Tile c0's finished similarities: row top-2 pushes in increasing column
// order, and (kColmax) each column's max over the thread's rows, reduced
// over the eight lanes of its 64-row half (a reduce-scatter: lane l ends
// with column j = l % 8) and left in slot[half][col].
template <bool kColmax>
__device__ __forceinline__ void tile_epilogue(
    const float (&acc)[8][8], int c0, int col_first, unsigned cols_valid,
    unsigned rows_valid, const float (&row_floor)[8], int row_first, int lane,
    int half, float (&rb)[8], float (&rs)[8], int (&ri)[8], float* slot) {
  float cbest[8];
  int crow[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + col_first + 16 * j;
    const bool col_valid = cols_valid >> j & 1u;
    cbest[j] = -INFINITY;
    crow[j] = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = col_valid ? acc[i][j] : kInvalid;
      topk2::push_max(s, col, rb[i], rs[i], ri[i]);
      if (kColmax) {  // rows increase with i; rows past N read -inf
        const float sr = (rows_valid >> i & 1u) ? s : row_floor[i];
        if (sr > cbest[j]) {
          cbest[j] = sr;
          crow[j] = row_first + 8 * i;
        }
      }
    }
  }
  if (kColmax) {
    scatter_step<4>(cbest, crow, lane);
    scatter_step<2>(cbest, crow, lane);
    scatter_step<1>(cbest, crow, lane);
    const int c = half * kTile + col_first + 16 * (lane % 8);
    slot[c] = cbest[0];
    reinterpret_cast<int*>(slot)[2 * kTile + c] = crow[0];
  }
}

// Bit j: column c0 + col_first + 16 j is valid.  Columns past M read as
// invalid: a push of -2 changes no state.
__device__ __forceinline__ unsigned column_mask(const uint8_t* __restrict__ v2,
                                                int c0, int col_first, int m) {
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + col_first + 16 * j;
    if (col < m && v2[col] != 0) mask |= 1u << j;
  }
  return mask;
}

// Column partials of tile c0 from slot: the lower half's unless the upper
// half's is strictly larger (its rows are all larger).  Threads 0..127.
__device__ __forceinline__ void store_colmax(const float* slot, int c0, int m,
                                             int tid, float* col_val,
                                             int* col_row) {
  const int col = c0 + tid;
  if (col >= m) return;
  const int* rows = reinterpret_cast<const int*>(slot) + 2 * kTile;
  const bool upper = slot[kTile + tid] > slot[tid];
  col_val[col] = slot[upper * kTile + tid];
  col_row[col] = rows[upper * kTile + tid];
}

template <bool kColmax>
__global__ void __launch_bounds__(kThreads, 1)
match_topk2_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                   const uint8_t* __restrict__ valid1,
                   const uint8_t* __restrict__ valid2,
                   float* __restrict__ best, float* __restrict__ second,
                   int* __restrict__ best_idx, float* __restrict__ col_val,
                   int* __restrict__ col_row, int n, int m, int dim) {
  extern __shared__ __align__(16) float smem[];
  float* slots = smem + kRingFloats;  // kColmax: two tiles' column partials

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int half = warp / 4;                        // rows 64 * half ..
  const int row_in = 64 * half + lane % 8;          // + 8 i
  const int col_in = 4 * (warp % 4) + lane / 8;     // columns col_in + 16 j
  const int rt = blockIdx.x;
  const int p = blockIdx.y;
  const int r0 = rt * kTile;
  const float* A = d1 + (size_t)p * n * dim;
  const float* B = d2 + (size_t)p * m * dim;
  const uint8_t* v2 = valid2 + (size_t)p * m;
  const size_t part0 = ((size_t)p * gridDim.x + rt) * m;

  // kColmax: a row's value in the column max is its similarity if it is
  // valid, else row_floor: -2 for an invalid keypoint, -inf past N.
  unsigned rows_valid = 0;
  float row_floor[8];
  float rb[8], rs[8];
  int ri[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + row_in + 8 * i;
    row_floor[i] = row < n ? kInvalid : -INFINITY;
    if (kColmax && row < n && valid1[(size_t)p * n + row] != 0)
      rows_valid |= 1u << i;
    rb[i] = kInvalid;
    rs[i] = kInvalid;
    ri[i] = 0;
  }

  const int chunks = dim / kChunk;  // per column tile
  const int total = ((m + kTile - 1) / kTile) * chunks;
  // The copies' pointers advance by a chunk, and B's by a column tile.
  const int copy_row = tid / (kChunk / 4), copy_piece = tid % (kChunk / 4);
  const int copy_dst = copy_row * kChunk + 4 * (copy_piece ^ (copy_row & 7));
  const size_t rows_apart = (size_t)kRowsApart * dim;
  const unsigned a_inside = rows_inside(r0, n, tid);
  const float* a_src = A + (size_t)(r0 + copy_row) * dim + 4 * copy_piece;
  const float* b_src = B + (size_t)copy_row * dim + 4 * copy_piece;
  unsigned b_inside = rows_inside(0, m, tid);
  int load_tile = 0, load_k = 0;  // next chunk to copy
  auto load_next = [&](int it) {
    float* st = smem + (it % kStages) * kStageFloats + copy_dst;
    copy_chunk(st, a_src + load_k * kChunk, A, rows_apart, a_inside);
    copy_chunk(st + kChunkFloats, b_src + load_k * kChunk, B, rows_apart,
               b_inside);
    if (++load_k == chunks) {
      load_k = 0;
      ++load_tile;
      b_src += (size_t)kTile * dim;
      b_inside = rows_inside(load_tile * kTile, m, tid);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_next(s);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int tile = 0, k = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk it
    __syncthreads();  // everyone's copies landed; chunk it - 1 is consumed
    if (kColmax && k == 0 && tile > 0 && tid < kTile)  // last tile's partials
      store_colmax(slots + ((tile - 1) & 1) * kSlotFloats, (tile - 1) * kTile,
                   m, tid, col_val + part0, col_row + part0);
    if (it + kStages - 1 < total) load_next(it + kStages - 1);
    cp_async_commit();

    const float* st = smem + (it % kStages) * kStageFloats;
    fma_chunk(st + row_in * kChunk, st + kChunkFloats + col_in * kChunk,
              row_in & 7, col_in & 7, acc);

    if (++k == chunks) {  // the tile's similarities are complete
      // The mask is loaded here rather than at the tile's start, where the
      // variants script measured both kernels 1-3% slower.
      const unsigned cols_valid = column_mask(v2, tile * kTile, col_in, m);
      tile_epilogue<kColmax>(acc, tile * kTile, col_in, cols_valid, rows_valid,
                             row_floor, r0 + row_in, lane, half, rb, rs, ri,
                             slots + (tile & 1) * kSlotFloats);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      k = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free; the last tile's partials are written
  if (kColmax && tid < kTile)
    store_colmax(slots + ((tile - 1) & 1) * kSlotFloats, (tile - 1) * kTile, m,
                 tid, col_val + part0, col_row + part0);

  // Merge each row's 16 states: the four lanes of a warp that share its
  // rows by shuffles, then the four warps of a half through shared memory.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off < 32; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, rb[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, rs[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, ri[i], off);
      topk2::merge(rb[i], rs[i], ri[i], ob, os, oi);
    }
  }
  float* mb = smem;                                 // [warp % 4][row]
  float* ms = mb + 4 * kTile;
  int* mi = reinterpret_cast<int*>(ms + 4 * kTile);
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = (warp % 4) * kTile + row_in + 8 * i;
      mb[o] = rb[i];
      ms[o] = rs[i];
      mi[o] = ri[i];
    }
  }
  __syncthreads();
  if (tid < kTile && r0 + tid < n) {
    float b = mb[tid], s = ms[tid];
    int idx = mi[tid];
#pragma unroll
    for (int w = 1; w < 4; ++w)
      topk2::merge(b, s, idx, mb[w * kTile + tid], ms[w * kTile + tid],
                   mi[w * kTile + tid]);
    const size_t o = (size_t)p * n + r0 + tid;
    best[o] = b;
    second[o] = s;
    best_idx[o] = idx;
  }
}

template <bool kColmax>
int launch(const void* d1, const void* d2, const void* valid1,
           const void* valid2, void* best, void* second, void* best_idx,
           void* col_val, void* col_row, int pairs, int n, int m, int dim,
           void* stream) {
  if (dim <= 0 || dim % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      match_topk2_kernel<kColmax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<kColmax>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTile - 1) / kTile, pairs);
  match_topk2_kernel<kColmax>
      <<<grid, kThreads, smem_bytes<kColmax>(), (cudaStream_t)stream>>>(
          static_cast<const float*>(d1), static_cast<const float*>(d2),
          static_cast<const uint8_t*>(valid1),
          static_cast<const uint8_t*>(valid2), static_cast<float*>(best),
          static_cast<float*>(second), static_cast<int*>(best_idx),
          static_cast<float*>(col_val), static_cast<int*>(col_row), n, m, dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int match_topk2_colmax_launch(
    const void* d1, const void* d2, const void* valid1, const void* valid2,
    void* best, void* second, void* best_idx, void* col_val, void* col_row,
    int pairs, int n, int m, int dim, void* stream) {
  return launch<true>(d1, d2, valid1, valid2, best, second, best_idx, col_val,
                      col_row, pairs, n, m, dim, stream);
}

extern "C" int match_topk2_launch(const void* d1, const void* d2,
                                  const void* valid2, void* best, void* second,
                                  void* best_idx, int pairs, int n, int m,
                                  int dim, void* stream) {
  return launch<false>(d1, d2, nullptr, valid2, best, second, best_idx,
                       nullptr, nullptr, pairs, n, m, dim, stream);
}
