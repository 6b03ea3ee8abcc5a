// ln_gemm: out = epi(prologue(A) . W + b), bf16 operands, fp32 accumulation.
//
// The building block of every projection on the CLIP serving path.  It
// replaces the matmuls that the TPU kernels compute in their own bodies:
// the QKV and out-projections of uml_tpu/ops/fused_attention.py
// (_block_kernel, _block_cls_kernel) and both MLP matmuls of
// uml_tpu/ops/ln_matmul.py (_mlp_block_kernel).
//
//   A   [M, K] bf16, row-major, contiguous
//   W   [K, N] bf16, row-major (the JAX / flax kernel layout)
//   b   [N] fp32
//   res [M, N] bf16 with row stride ldres (EPI_RESIDUAL only)
//   out [M, N] bf16, contiguous
//
// prologue (LN=true): the raw LayerNorm of each A row, statistics in fp32
//   with var = max(E[x^2] - E[x]^2, 0); the LN scale/bias are folded into
//   W and b by the caller (fold_ln_into_matmul), as on the TPU.  The
//   normalized row is rounded to bf16 before the product, as the TPU
//   kernels round it before the MXU dot.
// epilogue: EPI_NONE, EPI_QUICK_GELU (y * sigmoid(1.702 y)) or
//   EPI_RESIDUAL (y + res), always after the fp32 bias add; one bf16
//   rounding at the end.
//
// What bounds it on the H100: at ViT-B/16 B=64 the QKV product is
// 12608 x 768 x 2304 (44.6 GFLOP) over 16 MB of A and 3.5 MB of W, far
// above the card's ~295 FLOP/byte ridge, so the tensor cores bound it.
// This first version uses nvcuda::wmma (mma.sync, 16x16x16 bf16) on 64x64
// block tiles with a register-prefetched K loop; it does not reach wgmma /
// TMA rates (those need sm_90a warpgroup code, a later PR).  The LN
// statistics are recomputed by every block column of the grid (N/64
// blocks read the same 64 rows of A); that is N/64 extra reads of A that a
// fused kernel would not make.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace uml {

enum { EPI_NONE = 0, EPI_QUICK_GELU = 1, EPI_RESIDUAL = 2 };

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 128;      // 4 warps, 2 x 2, each 32 x 32
constexpr int GEMM_LDA = GEMM_BK + 8;  // bf16 elements; padding vs bank conflicts
constexpr int GEMM_LDB = GEMM_BN + 8;
constexpr int GEMM_LDC = GEMM_BN + 4;  // fp32 elements

union Pack8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

template <bool LN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
ln_gemm_kernel(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ res,
               __nv_bfloat16* __restrict__ out,
               int M, int N, int K, long long ldres, float eps) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[GEMM_BM * GEMM_LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[GEMM_BK * GEMM_LDB];
  __shared__ __align__(128) float Cs[GEMM_BM * GEMM_LDC];
  __shared__ float row_mean[GEMM_BM];
  __shared__ float row_rstd[GEMM_BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // row tiles on grid.x (up to 2^31 - 1 of them), column tiles on grid.y
  const int m0 = blockIdx.x * GEMM_BM;
  const int n0 = blockIdx.y * GEMM_BN;

  if (LN) {
    // fp32 row statistics of this block's 64 rows: one warp per row
    for (int r = warp; r < GEMM_BM; r += GEMM_THREADS / 32) {
      const int gm = m0 + r;
      float s = 0.f, ss = 0.f;
      if (gm < M) {
        const __nv_bfloat16* row = a + (long long)gm * K;
        for (int c = lane * 8; c < K; c += 32 * 8) {
          Pack8 p;
          p.u = *reinterpret_cast<const uint4*>(row + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float v = __bfloat162float(p.h[i]);
            s += v;
            ss += v * v;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      if (lane == 0) {
        const float mean = s / K;
        const float var = fmaxf(ss / K - mean * mean, 0.f);
        row_mean[r] = mean;
        row_rstd[r] = (gm < M) ? rsqrtf(var + eps) : 0.f;
      }
    }
    __syncthreads();
  }

  // per k-step each thread moves 16 elements of the A tile (row ar,
  // columns ac..ac+15) and 16 of the W tile (row br, columns bc..bc+15)
  const int ar = tid >> 1;
  const int ac = (tid & 1) * 16;
  const int br = tid >> 2;
  const int bc = (tid & 3) * 16;
  const int gar = m0 + ar;

  Pack8 ra[2], rb[2];
  auto load_global = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (gar < M) {
        ra[i].u = *reinterpret_cast<const uint4*>(
            a + (long long)gar * K + k0 + ac + 8 * i);
      } else {
        ra[i].u = make_uint4(0, 0, 0, 0);
      }
      rb[i].u = *reinterpret_cast<const uint4*>(
          w + (long long)(k0 + br) * N + n0 + bc + 8 * i);
    }
  };
  auto store_shared = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      Pack8 p = ra[i];
      if (LN) {
        const float mean = row_mean[ar];
        const float rstd = row_rstd[ar];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          p.h[j] = __float2bfloat16((__bfloat162float(p.h[j]) - mean) * rstd);
      }
      *reinterpret_cast<uint4*>(&As[ar * GEMM_LDA + ac + 8 * i]) = p.u;
      *reinterpret_cast<uint4*>(&Bs[br * GEMM_LDB + bc + 8 * i]) = rb[i].u;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int nk = K / GEMM_BK;
  load_global(0);
  for (int kt = 0; kt < nk; ++kt) {
    store_shared();
    __syncthreads();
    if (kt + 1 < nk) load_global((kt + 1) * GEMM_BK);
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm + 16 * i) * GEMM_LDA + kk], GEMM_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * GEMM_LDB + wn + 16 * j], GEMM_LDB);
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
      wmma::store_matrix_sync(&Cs[(wm + 16 * i) * GEMM_LDC + wn + 16 * j], acc[i][j],
                              GEMM_LDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: 8 consecutive columns per thread per step, 16-byte stores
  for (int c = tid; c < GEMM_BM * GEMM_BN / 8; c += GEMM_THREADS) {
    const int r = c / (GEMM_BN / 8);
    const int cc = (c % (GEMM_BN / 8)) * 8;
    const int gm = m0 + r;
    if (gm >= M) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = Cs[r * GEMM_LDC + cc + j] + bias[n0 + cc + j];
    if (EPI == EPI_QUICK_GELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = v[j] * (1.f / (1.f + expf(-1.702f * v[j])));
    } else if (EPI == EPI_RESIDUAL) {
      Pack8 rp;
      rp.u = *reinterpret_cast<const uint4*>(res + (long long)gm * ldres + n0 + cc);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(rp.h[j]);
    }
    Pack8 o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.h[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(out + (long long)gm * N + n0 + cc) = o.u;
  }
}

// Launch one ln_gemm on `stream`; returns cudaGetLastError() after the
// launch.  Shapes must satisfy N % 64 == 0, K % 32 == 0, ldres % 8 == 0
// (the Python wrappers check them and raise first).
static inline cudaError_t launch_ln_gemm(const __nv_bfloat16* a, const __nv_bfloat16* w,
                                         const float* bias, const __nv_bfloat16* res,
                                         __nv_bfloat16* out, int M, int N, int K,
                                         long long ldres, bool ln, int epi, float eps,
                                         cudaStream_t stream) {
  const dim3 grid((M + GEMM_BM - 1) / GEMM_BM, N / GEMM_BN);
  const dim3 block(GEMM_THREADS);
#define UML_GEMM_LAUNCH(L, E) \
  ln_gemm_kernel<L, E><<<grid, block, 0, stream>>>(a, w, bias, res, out, M, N, K, ldres, eps)
  // the three (prologue, epilogue) pairs the serving path uses
  if (ln && epi == EPI_NONE) UML_GEMM_LAUNCH(true, EPI_NONE);             // QKV
  else if (ln && epi == EPI_QUICK_GELU) UML_GEMM_LAUNCH(true, EPI_QUICK_GELU);  // MLP in
  else if (!ln && epi == EPI_RESIDUAL) UML_GEMM_LAUNCH(false, EPI_RESIDUAL);    // out-proj, MLP out
  else return cudaErrorInvalidValue;
#undef UML_GEMM_LAUNCH
  return cudaGetLastError();
}

}  // namespace uml
