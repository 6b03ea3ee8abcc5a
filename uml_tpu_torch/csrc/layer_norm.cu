// uml_layer_norm: row LayerNorm with an affine, fp32 statistics, the
// input's dtype kept (bf16 or fp32).
//
// Replaces uml_tpu/ops/layer_norm.py::_ln_kernel.  Unlike the LN prologue
// of ln_gemm.cuh (var = E[x^2] - E[x]^2, flax's fast variance) it takes the
// two-pass variance mean((x - mean)^2), as that kernel and its jnp twin do.
//
//   x, out [rows, K] contiguous, K a multiple of 8; scale, bias [K] fp32
//
// One warp per row, four rows per block.  A lane keeps its share of the row
// in registers (8-element chunks, 16 or 32 bytes a load) between the two
// passes and the write, so x is read from device memory once; rows wider
// than LN_REG_CHUNKS chunks per lane (K > 2048) are read again from L1/L2
// in each pass.  The TPU kernel's 256-row blocks and row padding are not
// carried: the grid covers the rows exactly.
//
// What bounds it on the H100: bytes.  At [64, 197, 768] bf16 it moves
// 38.7 MB (x in, out out) for ~5 FLOP per element: 11.6 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LN_ROWS_PER_BLOCK = 4;
constexpr int LN_REG_CHUNKS = 8;  // chunks of 8 elements a lane keeps: K <= 2048

__device__ inline void load8(const __nv_bfloat16* p, float (&v)[8]) {
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  } pk;
  pk.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(pk.h[j]);
}

__device__ inline void load8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ inline void store8(__nv_bfloat16* p, const float (&v)[8]) {
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  } pk;
#pragma unroll
  for (int j = 0; j < 8; ++j) pk.h[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = pk.u;
}

__device__ inline void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// IN_REGS: the row fits LN_REG_CHUNKS chunks per lane and stays in registers
template <typename T, bool IN_REGS>
__global__ void __launch_bounds__(32 * LN_ROWS_PER_BLOCK)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out, long long rows, int K,
                  float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: no block-wide barrier follows
  const T* xr = x + row * K;
  T* orow = out + row * K;

  float v[IN_REGS ? LN_REG_CHUNKS : 1][8];
  float s = 0.f;
  if (IN_REGS) {
#pragma unroll
    for (int i = 0; i < LN_REG_CHUNKS; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c < K) {
        load8(xr + c, v[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += v[i][j];
      }
    }
  } else {
    for (int c = lane * 8; c < K; c += 32 * 8) {
      load8(xr + c, v[0]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[0][j];
    }
  }
  const float mean = warp_sum(s) / K;

  float ss = 0.f;
  if (IN_REGS) {
#pragma unroll
    for (int i = 0; i < LN_REG_CHUNKS; ++i) {
      if ((lane + 32 * i) * 8 < K) {
#pragma unroll
        for (int j = 0; j < 8; ++j) ss += (v[i][j] - mean) * (v[i][j] - mean);
      }
    }
  } else {
    for (int c = lane * 8; c < K; c += 32 * 8) {
      load8(xr + c, v[0]);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += (v[0][j] - mean) * (v[0][j] - mean);
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / K + eps);

  auto write = [&](int c, const float (&xv)[8]) {
    float sc[8], bi[8], y[8];
    load8(scale + c, sc);
    load8(bias + c, bi);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = (xv[j] - mean) * rstd * sc[j] + bi[j];
    store8(orow + c, y);
  };
  if (IN_REGS) {
#pragma unroll
    for (int i = 0; i < LN_REG_CHUNKS; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c < K) write(c, v[i]);
    }
  } else {
    for (int c = lane * 8; c < K; c += 32 * 8) {
      load8(xr + c, v[0]);
      write(c, v[0]);
    }
  }
}

template <typename T>
cudaError_t launch_layer_norm(const void* x, const void* scale, const void* bias, void* out,
                              long long rows, int K, float eps, cudaStream_t stream) {
  const long long blocks = (rows + LN_ROWS_PER_BLOCK - 1) / LN_ROWS_PER_BLOCK;
  if (K % 8 != 0 || rows < 1 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const dim3 block(32 * LN_ROWS_PER_BLOCK);
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  if (K <= 32 * 8 * LN_REG_CHUNKS)
    layer_norm_kernel<T, true><<<grid, block, 0, stream>>>(xp, sp, bp, op, rows, K, eps);
  else
    layer_norm_kernel<T, false><<<grid, block, 0, stream>>>(xp, sp, bp, op, rows, K, eps);
  return cudaGetLastError();
}

}  // namespace

// is_f32: x and out are fp32 (else bf16); scale and bias are fp32 either way
extern "C" int uml_layer_norm(const void* x, const void* scale, const void* bias, void* out,
                              long long rows, int K, int is_f32, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) return (int)launch_layer_norm<float>(x, scale, bias, out, rows, K, eps, st);
  return (int)launch_layer_norm<__nv_bfloat16>(x, scale, bias, out, rows, K, eps, st);
}
