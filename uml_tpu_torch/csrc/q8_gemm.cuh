// q8_gemm: out = epi(((float)(A . W) * row_scale) * col_scale + b), int8
// operands, exact int32 accumulation on the tensor cores.
//
// The projection products of the int8 serving kernels: the QKV, out-
// projection, c_fc and c_proj dots (_q8_dot) of
// uml_tpu/ops/quant.py::_block_q8_kernel and ::_mlp_q8_kernel, and of
// uml_tpu/ops/tower_q8.py::_tower_q8_kernel.
//
//   A   [M, K] int8, row-major, contiguous (the row-quantized activations)
//   W   [K, N] int8, row-major (the JAX / flax [in, out] kernel layout)
//   row_scale [M] fp32, col_scale [N] fp32, b [N] fp32
//   res [M, N] bf16, contiguous (Q8_EPI_RESIDUAL only)
//   out [M, N] bf16 (fp32 for Q8_EPI_F32)
//
// Epilogue, in the reference's order (quant.py:158, 406, 426): y =
// ((float)acc * row_scale[m]) * col_scale[n], then
//   Q8_EPI_BF16      out = bf16(y + b)              the qkv
//   Q8_EPI_F32       out = y + b (fp32)             the MLP pre-activation,
//                                                    kept for act_quantize
//   Q8_EPI_RESIDUAL  out = bf16((res + y) + b)      x + delta + bo
// Every fp32 operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn), so nvcc does not contract them into FMAs and the epilogue
// rounds as the plain PyTorch version does.
//
// What bounds it on the H100: at ViT-B/16 B=64 the c_fc product is 12608
// x 768 x 3072 (59.5 G int8 ops) over 9.7 MB of A and 2.4 MB of W, far
// above the ridge, so the tensor cores bound it (30 us at the 1,979 TOPS
// int8 peak).  This first version runs nvcuda::wmma (mma.sync, 16x16x16
// s8 -> s32) on 64x64 block tiles with a register-prefetched K loop of 64;
// wgmma + TMA (a later PR) is the way to the int8 peak.  wmma needs each
// 16x16 int8 fragment 32-byte aligned, so the shared tiles are stored as
// four column slabs of 16 bytes per row (a fragment is then 256
// contiguous bytes, which also makes its load free of bank conflicts).

#pragma once

#include "ln_gemm.cuh"

namespace uml {

enum { Q8_EPI_BF16 = 0, Q8_EPI_F32 = 1, Q8_EPI_RESIDUAL = 2 };

constexpr int Q8_BM = 64;
constexpr int Q8_BN = 64;
constexpr int Q8_BK = 64;
constexpr int Q8_THREADS = 128;        // 4 warps, 2 x 2, each 32 x 32
constexpr int Q8_SLAB = 16;            // int8 columns per shared slab
constexpr int Q8_LDC = Q8_BN + 4;      // int32 elements

template <int EPI>
__global__ void __launch_bounds__(Q8_THREADS)
q8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
               const float* __restrict__ row_scale, const float* __restrict__ col_scale,
               const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
               void* __restrict__ out_ptr, int M, int N, int K) {
  using namespace nvcuda;
  // A tile [64 rows][64 k] as 4 slabs [64 rows][16 k]; W tile [64 k][64 n]
  // as 4 slabs [64 k][16 n]
  __shared__ __align__(128) signed char As[Q8_BM * Q8_BK];
  __shared__ __align__(128) signed char Bs[Q8_BK * Q8_BN];
  __shared__ __align__(128) int Cs[Q8_BM * Q8_LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // row tiles on grid.x, column tiles on grid.y
  const int m0 = blockIdx.x * Q8_BM;
  const int n0 = blockIdx.y * Q8_BN;

  // per k-step each thread moves 32 bytes of A (row lr, columns lc..lc+31)
  // and 32 of W (k-row lr, columns lc..lc+31): two 16-byte slab rows each
  const int lr = tid >> 1;
  const int lc = (tid & 1) * 32;
  const int gar = m0 + lr;

  uint4 ra[2], rb[2];
  auto load_global = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ra[i] = (gar < M) ? *reinterpret_cast<const uint4*>(a + (long long)gar * K + k0 + lc +
                                                           Q8_SLAB * i)
                        : make_uint4(0, 0, 0, 0);
      rb[i] = *reinterpret_cast<const uint4*>(w + (long long)(k0 + lr) * N + n0 + lc +
                                              Q8_SLAB * i);
    }
  };
  auto store_shared = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int slab = (lc >> 4) + i;
      *reinterpret_cast<uint4*>(&As[slab * Q8_BM * Q8_SLAB + lr * Q8_SLAB]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[slab * Q8_BK * Q8_SLAB + lr * Q8_SLAB]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int nk = K / Q8_BK;
  load_global(0);
  for (int kt = 0; kt < nk; ++kt) {
    store_shared();
    __syncthreads();
    if (kt + 1 < nk) load_global((kt + 1) * Q8_BK);
#pragma unroll
    for (int s = 0; s < Q8_BK / Q8_SLAB; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[s * Q8_BM * Q8_SLAB + (wm + 16 * i) * Q8_SLAB],
                               Q8_SLAB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], &Bs[((wn >> 4) + j) * Q8_BK * Q8_SLAB + s * Q8_SLAB * Q8_SLAB], Q8_SLAB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + 16 * i) * Q8_LDC + wn + 16 * j], acc[i][j], Q8_LDC,
                              wmma::mem_row_major);
  __syncthreads();

  // epilogue: 8 consecutive columns per thread per step
  for (int c = tid; c < Q8_BM * Q8_BN / 8; c += Q8_THREADS) {
    const int r = c / (Q8_BN / 8);
    const int cc = (c % (Q8_BN / 8)) * 8;
    const int gm = m0 + r;
    if (gm >= M) continue;
    const float rs = row_scale[gm];
    const long long o = (long long)gm * N + n0 + cc;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __fmul_rn(__fmul_rn(__int2float_rn(Cs[r * Q8_LDC + cc + j]), rs),
                       col_scale[n0 + cc + j]);
    if (EPI == Q8_EPI_RESIDUAL) {
      Pack8 rp;
      rp.u = *reinterpret_cast<const uint4*>(res + o);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(__bfloat162float(rp.h[j]), v[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], bias[n0 + cc + j]);
    if (EPI == Q8_EPI_F32) {
      float* o32 = static_cast<float*>(out_ptr) + o;
      *reinterpret_cast<float4*>(o32) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o32 + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      Pack8 p;
#pragma unroll
      for (int j = 0; j < 8; ++j) p.h[j] = __float2bfloat16(v[j]);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out_ptr) + o) = p.u;
    }
  }
}

// Launch one q8_gemm on `stream`; returns cudaGetLastError() after the
// launch.  Shapes must satisfy N % 64 == 0 and K % 64 == 0 (the Python
// wrappers check them and raise first).
static inline cudaError_t launch_q8_gemm(const int8_t* a, const int8_t* w, const float* row_scale,
                                         const float* col_scale, const float* bias,
                                         const __nv_bfloat16* res, void* out, int M, int N,
                                         int K, int epi, cudaStream_t stream) {
  if (N % Q8_BN != 0 || K % Q8_BK != 0) return cudaErrorInvalidValue;
  const dim3 grid((M + Q8_BM - 1) / Q8_BM, N / Q8_BN);
  if (epi == Q8_EPI_BF16)
    q8_gemm_kernel<Q8_EPI_BF16><<<grid, Q8_THREADS, 0, stream>>>(a, w, row_scale, col_scale,
                                                                  bias, res, out, M, N, K);
  else if (epi == Q8_EPI_F32)
    q8_gemm_kernel<Q8_EPI_F32><<<grid, Q8_THREADS, 0, stream>>>(a, w, row_scale, col_scale,
                                                                 bias, res, out, M, N, K);
  else if (epi == Q8_EPI_RESIDUAL)
    q8_gemm_kernel<Q8_EPI_RESIDUAL><<<grid, Q8_THREADS, 0, stream>>>(a, w, row_scale, col_scale,
                                                                      bias, res, out, M, N, K);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace uml
