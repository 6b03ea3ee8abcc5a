// Row-quantize passes of the int8 serving path: one warp per row.
//
// They replace the VPU passes inside the TPU kernels of
// uml_tpu/ops/quant.py (_ln_quantize_rows and _quantize_rows as
// _block_q8_kernel, _mlp_q8_kernel and tower_q8.py::_tower_q8_kernel call
// them on VMEM-resident rows):
//
//   ln_quantize_rows   bf16 x [R, K] -> int8 q [R, K], fp32 scale [R]:
//     mean, E[x^2], max and min in one pass over the row; var =
//     max(E[x^2] - mean^2, 0), rstd = 1/sqrt(var + eps); absmax =
//     max(max - mean, mean - min) * rstd; scale = max(absmax, 1e-12)/127;
//     q = clamp(floor((x - mean) * (rstd / scale) + 0.5), +-127)
//   quantize_rows      fp32 a [R, N] (the attention output before its
//     bf16 rounding, as the TPU kernel quantizes it) -> q, scale:
//     scale = max(max|a|, 1e-12)/127, q = clamp(floor(a / scale + 0.5))
//
// The third, _act_quantize_rows (quick_gelu of the MLP pre-activation,
// the scale from the row's max), runs in the epilogues of the c_fc
// product (q8_gemm.cuh's ROWMAX and ACTQ), so the fp32 pre-activation
// never reaches device memory.
//
// Rounding is floor(x + 0.5) (round half up) as in uml_tpu, and every
// fp32 step is an explicitly rounded intrinsic, so nvcc does not fuse
// them into FMAs; the row sums still run in another order than the plain
// version's, so an integer at an exact .5 tie can differ by one step.
//
// What bounds them on the H100: memory.  Each reads its row twice (the
// second read from L1/L2) and writes one byte per element: at ViT-B/16
// B=64 ln_quantize_rows reads 19.4 MB and writes 9.7 MB, ~9 us at 3.35
// TB/s; quantize_rows reads the 38.7 MB fp32 attention output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ln_gemm.cuh"

namespace uml {

constexpr int QROW_THREADS = 128;  // 4 warps, one row each

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
                        float* __restrict__ scale, int R, int K, float eps,
                        int* __restrict__ rowmax_init) {
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
  if (lane == 0) {
    scale[r] = sc;
    if (rowmax_init != nullptr) rowmax_init[r] = Q8_ORDERED_NEG_INF;
  }
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
quantize_rows_kernel(const float* __restrict__ a, int8_t* __restrict__ q,
                     float* __restrict__ scale, int R, int N) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (QROW_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const float* row = a + (long long)r * N;
  float mx = 0.f;
  for (int c = lane * 8; c < N; c += 32 * 8) {
    const float4 u = *reinterpret_cast<const float4*>(row + c);
    const float4 w = *reinterpret_cast<const float4*>(row + c + 4);
    mx = fmaxf(mx, fmaxf(fmaxf(fmaxf(fabsf(u.x), fabsf(u.y)), fmaxf(fabsf(u.z), fabsf(u.w))),
                         fmaxf(fmaxf(fabsf(w.x), fabsf(w.y)), fmaxf(fabsf(w.z), fabsf(w.w)))));
  }
  mx = warp_max(mx);
  const float sc = __fdiv_rn(fmaxf(mx, 1e-12f), Q8_MAX);
  if (lane == 0) scale[r] = sc;
  for (int c = lane * 8; c < N; c += 32 * 8) {
    const float4 u = *reinterpret_cast<const float4*>(row + c);
    const float4 w = *reinterpret_cast<const float4*>(row + c + 4);
    const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
    store_q8x8(q + (long long)r * N + c, v, sc, true);
  }
}

// Launchers: return cudaGetLastError() after the launch; the row width
// must be a multiple of 8 (the wrappers check 64).
static inline dim3 qrow_grid(int R) {
  return dim3((R + QROW_THREADS / 32 - 1) / (QROW_THREADS / 32));
}

// rowmax_init: where given, [R] set to Q8_ORDERED_NEG_INF, the first value
// of the row maxima that the next product's ROWMAX pass raises
static inline cudaError_t launch_ln_quantize_rows(const __nv_bfloat16* x, int8_t* q, float* scale,
                                                  int R, int K, float eps, cudaStream_t stream,
                                                  int* rowmax_init = nullptr) {
  if (K % 8 != 0) return cudaErrorInvalidValue;
  ln_quantize_rows_kernel<<<qrow_grid(R), QROW_THREADS, 0, stream>>>(x, q, scale, R, K, eps,
                                                                      rowmax_init);
  return cudaGetLastError();
}

static inline cudaError_t launch_quantize_rows(const float* a, int8_t* q, float* scale,
                                               int R, int N, cudaStream_t stream) {
  if (N % 8 != 0) return cudaErrorInvalidValue;
  quantize_rows_kernel<<<qrow_grid(R), QROW_THREADS, 0, stream>>>(a, q, scale, R, N);
  return cudaGetLastError();
}

}  // namespace uml
