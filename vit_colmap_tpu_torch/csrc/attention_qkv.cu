// Fixed-max softmax attention read in place from the packed qkv projection.
//
// Replaces the TPU kernel vit_colmap_tpu/ops/pallas/attention_kernel.py:
// fixed_max_attention_qkv (body _kernel_pair).  Same function, not the same
// blocking: the TPU version pairs heads into 128-lane blocks and folds the
// softmax denominator into the PV product through a [V | 1 | 0] column; here
// one block owns one (image, head, 64-row q tile) and keeps the denominator
// as a plain running sum.
//
// Numerics (held to the reference):
//   q' = bf16(q * sm_scale * log2(e))   scaled in f32, rounded to bf16
//   s  = q' . k                         f32 accumulation
//   p  = bf16(exp2(min(s, 100)))        no running max; frozen-model logits
//                                       are bounded, the clamp guards overflow
//   out = (sum_kv p v) / max(sum_kv p, 1e-30)   f32 sums, kv rows >= N excluded
//
// What bounds it on an H100: the work is 4 * N^2 * 64 FLOP per (image, head),
// which at N = 9,691 is ~24 GFLOP per head against ~4 MB of q/k/v, so the
// bound is arithmetic, not bytes.  This first version runs on the FP32 SIMT
// pipes (67 TFLOP/s peak), not the bf16 tensor cores (989 TFLOP/s): each
// thread holds a 4x4 register tile of S and of O, operands come from shared
// memory as float4 so each 16 FMAs cost two shared loads, and the q tile
// stays resident while k/v tiles stream.  Tensor cores (mma.sync / wgmma)
// and TMA staging are the next step.
//
// Layout: qkv is (B, N, 3*D) bf16 row-major with D = H*64; head h of q/k/v
// sits at columns 64h, D+64h, 2D+64h.  out is (B, N, D) bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTileQ = 64;
constexpr int kTileKV = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4x4 output tile
constexpr float kClamp = 100.f;
constexpr int kSmemFloats = 4 * kTileQ * kHeadDim;  // q, k, v, p tiles
constexpr int kSmemBytes = kSmemFloats * 4;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(h[j]);
}

__global__ void __launch_bounds__(kThreads)
attention_qkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, int n, int num_heads,
                     float q_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [d][q]   q tile, transposed
  float* ks = qs + kHeadDim * kTileQ;   // [d][kv]  k tile, transposed
  float* vs = ks + kHeadDim * kTileKV;  // [kv][d]  v tile
  float* ps = vs + kTileKV * kHeadDim;  // [q][kv]  probabilities

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns kv columns / output dims 4tx..4tx+3
  const int ty = tid / 16;  // owns q rows 4ty..4ty+3
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = num_heads * kHeadDim;
  const size_t row_stride = 3 * (size_t)D;
  const __nv_bfloat16* base = qkv + (size_t)b * n * row_stride;
  const int qcol = h * kHeadDim;
  const int kcol = D + h * kHeadDim;
  const int vcol = 2 * D + h * kHeadDim;

  // q tile: a warp covers 32 consecutive rows of one 8-column chunk, so the
  // transposed shared stores are conflict-free.
  for (int e = tid; e < kTileQ * (kHeadDim / 8); e += kThreads) {
    const int r = e % kTileQ;
    const int c8 = (e / kTileQ) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < n) {
      unpack8(*reinterpret_cast<const uint4*>(base + (q0 + r) * row_stride +
                                              qcol + c8),
              x);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = round_bf16(x[j] * q_scale);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) qs[(c8 + j) * kTileQ + r] = x[j];
  }

  float o[4][4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < n; kv0 += kTileKV) {
    __syncthreads();  // the previous tile's k/v/p are no longer read
    for (int e = tid; e < kTileKV * (kHeadDim / 8); e += kThreads) {
      // k: row-fastest mapping (transposed store); v: column-fastest.
      const int rk = e % kTileKV;
      const int ck = (e / kTileKV) * 8;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kv0 + rk < n)
        unpack8(*reinterpret_cast<const uint4*>(base + (kv0 + rk) * row_stride +
                                                kcol + ck),
                x);
#pragma unroll
      for (int j = 0; j < 8; ++j) ks[(ck + j) * kTileKV + rk] = x[j];

      const int rv = e / (kHeadDim / 8);
      const int cv = (e % (kHeadDim / 8)) * 8;
      float y[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kv0 + rv < n)
        unpack8(*reinterpret_cast<const uint4*>(base + (kv0 + rv) * row_stride +
                                                vcol + cv),
                y);
      float4* vdst = reinterpret_cast<float4*>(vs + rv * kHeadDim + cv);
      vdst[0] = make_float4(y[0], y[1], y[2], y[3]);
      vdst[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * kTileQ + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(ks + d * kTileKV + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // kv rows past N get no weight: the loop bound masks them.
        p[j] = (kv0 + 4 * tx + j < n)
                   ? round_bf16(exp2f(fminf(s[i][j], kClamp)))
                   : 0.f;
        l[i] += p[j];
      }
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * kTileKV + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kv = 0; kv < kTileKV; kv += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kTileKV + kv);
        pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 t =
            *reinterpret_cast<const float4*>(vs + (kv + u) * kHeadDim + 4 * tx);
        const float vv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv[i][u], vv[j], o[i][j]);
      }
    }
  }

  // Row sums: the 16 threads that share ty are lanes of one half-warp.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= n) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * n + row) * D + h * kHeadDim + 4 * tx);
    dst[0] = __floats2bfloat162_rn(o[i][0] / den, o[i][1] / den);
    dst[1] = __floats2bfloat162_rn(o[i][2] / den, o[i][3] / den);
  }
}

}  // namespace

extern "C" int attention_qkv_launch(const void* qkv, void* out, int batch,
                                    int n, int num_heads, float q_scale,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTileQ - 1) / kTileQ, num_heads, batch);
  attention_qkv_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      n, num_heads, q_scale);
  return (int)cudaGetLastError();
}
