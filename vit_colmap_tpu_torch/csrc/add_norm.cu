// Residual add, LayerScale and LayerNorm at one block boundary of the DINOv2
// backbone (models/dinov2.py), bf16 residual stream in and out, f32
// statistics.
//
// Replaces no TPU kernel: the JAX package leaves this elementwise work to
// XLA, which fuses it into its neighbours.  The port's eager forward ran it
// as five passes over device memory a boundary (the LayerScale product, the
// residual add, an f32 copy of the stream, LayerNorm on that copy, the cast
// of its output back to bf16): about 30 bytes of traffic an element where
// the work needs 8.  One call here does
//
//   x_new = bf16(x + bf16(branch * bf16(gamma)))          (with a branch)
//   y     = out(w * (rstd * (f32(x_new) - mean)) + b)     rstd = rsqrt(var + eps)
//
// with the plain version's two bf16 roundings in its order, so x_new equals
// it bit for bit, and the mean and biased variance in f32.  y may differ
// from PyTorch's LayerNorm (Welford) only by the order of the f32 sums.
//
// What bounds it on an H100: bytes.  It reads x and the branch (2 + 2 B an
// element) and writes x_new and y (2 + 2 B, or 4 for the final norm's f32
// output), about 160 MB a call at ViT-L's batch of 2 x 9,691 tokens x
// 1,024, or 47 us at 3.35 TB/s.  What the design does about it:
//   * one warp a token row: each lane holds up to 8 x 8 values of the row
//     in registers (widths up to 2,048, any multiple of 8), so the row is
//     read once and both outputs are written once;
//   * 16-byte loads and stores, neighbouring lanes on neighbouring 16 bytes;
//     every load of the row is issued before the first use;
//   * the mean and then the variance over those registers (two passes, no
//     second read of memory), each a warp shuffle butterfly;
//   * gamma, w and b (f32, a few KB) are shared by every row and stay in
//     L1 and L2;
//   * a block of 4 rows, one wave after another: back to back on an H100 it
//     moves about 2.6 TB/s at ViT-L's shape, as a device-to-device copy of
//     the same bytes does.  A persistent grid whose warps load their next
//     row while finishing one, with gamma, w and b in shared memory,
//     measured 8-10% slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;    // one warp a row
constexpr int kVec = 8;             // bf16 values in one 16-byte load
constexpr int kMaxVecsPerLane = 8;  // widths up to 8 * 8 * 32 = 2,048

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float bf16_round(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

__device__ __forceinline__ void load8(const float* p, float (&f)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[kVec]) {
  *reinterpret_cast<uint4*>(p) = pack(f);
}

__device__ __forceinline__ void store8(float* p, const float (&f)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// NV: 16-byte vectors a lane holds (ceil(dim / 8 / 32)); kBranch: whether
// there is a branch to add; OutT: y's type (bf16, or float for the final
// norm).
template <int NV, bool kBranch, typename OutT>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
add_norm_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ branch,
                const float* __restrict__ gamma, const float* __restrict__ w,
                const float* __restrict__ b, __nv_bfloat16* __restrict__ x_new,
                OutT* __restrict__ y, int rows, int dim, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // a whole warp leaves: the shuffles stay full
  const int nvec = dim / kVec;
  const size_t base = static_cast<size_t>(row) * dim;

  uint4 xa[NV], ba[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * kWarp + lane;
    if (c < nvec) {
      xa[i] = reinterpret_cast<const uint4*>(x + base)[c];
      if constexpr (kBranch) ba[i] = reinterpret_cast<const uint4*>(branch + base)[c];
    }
  }

  float v[NV][kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * kWarp + lane;
    if (c < nvec) {
      unpack(xa[i], v[i]);
      if constexpr (kBranch) {
        float br[kVec], g[kVec];
        unpack(ba[i], br);
        load8(gamma + c * kVec, g);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float scaled = bf16_round(br[j] * bf16_round(g[j]));
          v[i][j] = bf16_round(v[i][j] + scaled);
        }
        store8(x_new + base + c * kVec, v[i]);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += v[i][j];
    }
  }
  const float mean = warp_sum(sum) / dim;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * kWarp + lane < nvec) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / dim + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * kWarp + lane;
    if (c < nvec) {
      float wv[kVec], bv[kVec], out[kVec];
      load8(w + c * kVec, wv);
      load8(b + c * kVec, bv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = wv[j] * (rstd * (v[i][j] - mean)) + bv[j];
      store8(y + base + c * kVec, out);
    }
  }
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* branch;
  const float* gamma;
  const float* w;
  const float* b;
  __nv_bfloat16* x_new;
  void* y;
  int rows, dim;
  float eps;
};

// The instantiation whose NV is the first at least ``nv``.
template <int NV, bool kBranch, typename OutT>
void launch_width(const Args& a, int nv, cudaStream_t stream) {
  if constexpr (NV < kMaxVecsPerLane) {
    if (nv > NV) return launch_width<NV + 1, kBranch, OutT>(a, nv, stream);
  }
  const int blocks = (a.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  add_norm_kernel<NV, kBranch, OutT><<<blocks, kWarp * kRowsPerBlock, 0, stream>>>(
      a.x, a.branch, a.gamma, a.w, a.b, a.x_new, static_cast<OutT*>(a.y), a.rows,
      a.dim, a.eps);
}

template <bool kBranch>
void launch_out(const Args& a, int nv, bool out_f32, cudaStream_t stream) {
  if (out_f32)
    launch_width<1, kBranch, float>(a, nv, stream);
  else
    launch_width<1, kBranch, __nv_bfloat16>(a, nv, stream);
}

}  // namespace

// x, branch: (rows, dim) bf16, contiguous (branch may be null, and then
// gamma and x_new are not read or written); gamma, w, b: (dim,) f32; y:
// (rows, dim) bf16, or f32 when out_f32.  Every pointer 16-byte aligned;
// dim a multiple of 8, at most 2,048.
extern "C" int add_norm_launch(const void* x, const void* branch, const void* gamma,
                               const void* w, const void* b, void* x_new, void* y,
                               int rows, int dim, float eps, int out_f32, void* stream) {
  if (dim <= 0 || dim % kVec != 0 || dim > kVec * kWarp * kMaxVecsPerLane || rows < 0)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(branch),
               static_cast<const float*>(gamma), static_cast<const float*>(w),
               static_cast<const float*>(b), static_cast<__nv_bfloat16*>(x_new), y,
               rows, dim, eps};
  const int nv = (dim / kVec + kWarp - 1) / kWarp;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (branch != nullptr)
    launch_out<true>(a, nv, out_f32 != 0, s);
  else
    launch_out<false>(a, nv, out_f32 != 0, s);
  return cudaGetLastError();
}
