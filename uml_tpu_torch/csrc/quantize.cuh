// Row-quantize passes of the int8 serving path: one warp per row.
//
// They replace the VPU passes inside the TPU kernels of
// uml_tpu/ops/quant.py (_ln_quantize_rows, _quantize_rows and
// _act_quantize_rows as _block_q8_kernel, _mlp_q8_kernel and
// tower_q8.py::_tower_q8_kernel call them on VMEM-resident rows):
//
//   ln_quantize_rows   bf16 x [R, K] -> int8 q [R, K], fp32 scale [R]:
//     mean, E[x^2], max and min in one pass over the row; var =
//     max(E[x^2] - mean^2, 0), rstd = 1/sqrt(var + eps); absmax =
//     max(max - mean, mean - min) * rstd; scale = max(absmax, 1e-12)/127;
//     q = clamp(floor((x - mean) * (rstd / scale) + 0.5), +-127)
//   quantize_rows      bf16 a [R, N] (the attention output) -> q, scale:
//     scale = max(max|a|, 1e-12)/127, q = clamp(floor(a / scale + 0.5))
//   act_quantize_rows  fp32 pre [R, M] (the MLP pre-activation with b1)
//     -> q, scale of quick_gelu(pre): scale = max(quick_gelu(max(pre)),
//     0.1654)/127 (quick_gelu's negative lobe, padded), then
//     q = clamp(floor(quick_gelu(pre) / scale + 0.5)); no reduction over
//     the activation.  quick_gelu(x) = x * (1 / (1 + exp(-1.702 x))).
//
// Rounding is floor(x + 0.5) (round half up) as in uml_tpu, and every
// fp32 step is an explicitly rounded intrinsic, so nvcc does not fuse
// them into FMAs; the row sums still run in another order than the plain
// version's, so an integer at an exact .5 tie can differ by one step.
//
// What bounds them on the H100: memory.  Each reads its row twice (the
// second read from L1/L2) and writes one byte per element: at ViT-B/16
// B=64 the act pass reads the 155 MB fp32 pre and writes 39 MB, ~58 us at
// 3.35 TB/s.  The TPU kernel keeps pre in VMEM; writing it and reading it
// back is the known cost of this simple form (a fused epilogue that
// quantizes a whole row tile is a later PR).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ln_gemm.cuh"

namespace uml {

constexpr int QROW_THREADS = 128;  // 4 warps, one row each
constexpr float Q8_MAX = 127.f;
constexpr float QUICK_GELU_LOBE = 0.1654f;

__device__ __forceinline__ int8_t q8_round(float v) {
  return (int8_t)fminf(fmaxf(floorf(__fadd_rn(v, 0.5f)), -Q8_MAX), Q8_MAX);
}

__device__ __forceinline__ float quick_gelu_rn(float x) {
  return __fmul_rn(x, __fdiv_rn(1.f, __fadd_rn(1.f, expf(__fmul_rn(-1.702f, x)))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void store_q8x8(int8_t* dst, const float* v, float k, bool divide) {
  union {
    uint2 u;
    int8_t q[8];
  } p;
#pragma unroll
  for (int j = 0; j < 8; ++j) p.q[j] = q8_round(divide ? __fdiv_rn(v[j], k) : __fmul_rn(v[j], k));
  *reinterpret_cast<uint2*>(dst) = p.u;
}

static __global__ void __launch_bounds__(QROW_THREADS)
ln_quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, int R, int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (QROW_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const __nv_bfloat16* row = x + (long long)r * K;
  float s = 0.f, ss = 0.f, mx = -CUDART_INF_F, mn = CUDART_INF_F;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(row + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = __bfloat162float(p.h[j]);
      s = __fadd_rn(s, v);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
      mx = fmaxf(mx, v);
      mn = fminf(mn, v);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mx = warp_max(mx);
  mn = -warp_max(-mn);
  const float mean = __fdiv_rn(s, (float)K);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, (float)K), __fmul_rn(mean, mean)), 0.f);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  const float absmax = __fmul_rn(fmaxf(__fsub_rn(mx, mean), __fsub_rn(mean, mn)), rstd);
  const float sc = __fdiv_rn(fmaxf(absmax, 1e-12f), Q8_MAX);
  const float k = __fdiv_rn(rstd, sc);
  if (lane == 0) scale[r] = sc;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(row + c);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fsub_rn(__bfloat162float(p.h[j]), mean);
    store_q8x8(q + (long long)r * K + c, v, k, false);
  }
}

static __global__ void __launch_bounds__(QROW_THREADS)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ a, int8_t* __restrict__ q,
                     float* __restrict__ scale, int R, int N) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (QROW_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const __nv_bfloat16* row = a + (long long)r * N;
  float mx = 0.f;
  for (int c = lane * 8; c < N; c += 32 * 8) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(row + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(__bfloat162float(p.h[j])));
  }
  mx = warp_max(mx);
  const float sc = __fdiv_rn(fmaxf(mx, 1e-12f), Q8_MAX);
  if (lane == 0) scale[r] = sc;
  for (int c = lane * 8; c < N; c += 32 * 8) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(row + c);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(p.h[j]);
    store_q8x8(q + (long long)r * N + c, v, sc, true);
  }
}

static __global__ void __launch_bounds__(QROW_THREADS)
act_quantize_rows_kernel(const float* __restrict__ pre, int8_t* __restrict__ q,
                         float* __restrict__ scale, int R, int M) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (QROW_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const float* row = pre + (long long)r * M;
  float mx = -CUDART_INF_F;
  for (int c = lane * 8; c < M; c += 32 * 8) {
    const float4 a = *reinterpret_cast<const float4*>(row + c);
    const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
    mx = fmaxf(mx, fmaxf(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)),
                         fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w))));
  }
  mx = warp_max(mx);
  const float sc = __fdiv_rn(fmaxf(quick_gelu_rn(mx), QUICK_GELU_LOBE), Q8_MAX);
  if (lane == 0) scale[r] = sc;
  for (int c = lane * 8; c < M; c += 32 * 8) {
    const float4 a = *reinterpret_cast<const float4*>(row + c);
    const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
    const float v[8] = {quick_gelu_rn(a.x), quick_gelu_rn(a.y), quick_gelu_rn(a.z),
                        quick_gelu_rn(a.w), quick_gelu_rn(b.x), quick_gelu_rn(b.y),
                        quick_gelu_rn(b.z), quick_gelu_rn(b.w)};
    store_q8x8(q + (long long)r * M + c, v, sc, true);
  }
}

// Launchers: return cudaGetLastError() after the launch; the row width
// must be a multiple of 8 (the wrappers check 64).
static inline dim3 qrow_grid(int R) {
  return dim3((R + QROW_THREADS / 32 - 1) / (QROW_THREADS / 32));
}

static inline cudaError_t launch_ln_quantize_rows(const __nv_bfloat16* x, int8_t* q, float* scale,
                                                  int R, int K, float eps, cudaStream_t stream) {
  if (K % 8 != 0) return cudaErrorInvalidValue;
  ln_quantize_rows_kernel<<<qrow_grid(R), QROW_THREADS, 0, stream>>>(x, q, scale, R, K, eps);
  return cudaGetLastError();
}

static inline cudaError_t launch_quantize_rows(const __nv_bfloat16* a, int8_t* q, float* scale,
                                               int R, int N, cudaStream_t stream) {
  if (N % 8 != 0) return cudaErrorInvalidValue;
  quantize_rows_kernel<<<qrow_grid(R), QROW_THREADS, 0, stream>>>(a, q, scale, R, N);
  return cudaGetLastError();
}

static inline cudaError_t launch_act_quantize_rows(const float* pre, int8_t* q, float* scale,
                                                   int R, int M, cudaStream_t stream) {
  if (M % 8 != 0) return cudaErrorInvalidValue;
  act_quantize_rows_kernel<<<qrow_grid(R), QROW_THREADS, 0, stream>>>(pre, q, scale, R, M);
  return cudaGetLastError();
}

}  // namespace uml
