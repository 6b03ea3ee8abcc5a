// ln_gemm: out = epi(prologue(A) . W + b), bf16 operands, fp32 accumulation.
//
// The building block of every projection of the CLIP layers.  It replaces
// the matmuls that the TPU kernels compute in their own bodies: the QKV
// and out-projections of uml_tpu/ops/fused_attention.py (_block_kernel,
// _block_cls_kernel, _block_kernel_stash), both MLP matmuls of
// uml_tpu/ops/ln_matmul.py (_mlp_block_kernel, _mlp_block_kernel_stash),
// and the two products with a transposed weight inside the attention
// backward kernels (dattn = g . wo^T and dxn = dqkv . W_eff^T of
// _block_bwd_stash_kernel, _block_bwd_cls_kernel).
//
//   A   [M, K] bf16, row-major, contiguous
//   W   [K, N] bf16, row-major (the JAX / flax kernel layout), or with
//       TRANS_B [N, K] row-major (the product then takes W^T)
//   b   [N] fp32, or null for no bias
//   res [M, N] bf16 with row stride ldres (EPI_RESIDUAL only)
//   out [M, N] bf16, contiguous (fp32 for EPI_F32)
//   aux [M, N] bf16, contiguous (EPI_GELU_STASH only)
//
// prologue (LN=true): the raw LayerNorm of each A row, statistics in fp32
//   with var = max(E[x^2] - E[x]^2, 0); the LN scale/bias are folded into
//   W and b by the caller (fold_ln_into_matmul), as on the TPU.  The
//   normalized row is rounded to bf16 before the product, as the TPU
//   kernels round it before the MXU dot.
// epilogue, always after the fp32 bias add, one rounding at the end:
//   EPI_NONE, EPI_QUICK_GELU (y * sigmoid(1.702 y)), EPI_RESIDUAL (y + res),
//   EPI_GELU_STASH (out = quick_gelu(y) and aux = y, the pre-activation
//   the MLP backward reads; the activation is taken of the unrounded fp32
//   y, the order of _mlp_block_kernel_stash, ln_matmul.py:199-204), and
//   EPI_F32 (y stored in fp32, for the LN backward that follows).
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

#include <type_traits>

namespace uml {

enum { EPI_NONE = 0, EPI_QUICK_GELU = 1, EPI_RESIDUAL = 2, EPI_GELU_STASH = 3, EPI_F32 = 4 };

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

// bf16 elements of the W tile in shared memory: [BK][LDB], or with
// TRANS_B [BN][LDA] (the tile of W^T stored column-major)
constexpr int GEMM_BS_ELEMS =
    (GEMM_BK * GEMM_LDB > GEMM_BN * GEMM_LDA) ? GEMM_BK * GEMM_LDB : GEMM_BN * GEMM_LDA;

template <bool LN, int EPI, bool TRANS_B>
__global__ void __launch_bounds__(GEMM_THREADS)
ln_gemm_kernel(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ res,
               void* __restrict__ out_ptr,
               __nv_bfloat16* __restrict__ aux,
               int M, int N, int K, long long ldres, float eps) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[GEMM_BM * GEMM_LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[GEMM_BS_ELEMS];
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
      if (TRANS_B) {
        // W^T tile = rows n0..n0+63 of the [N, K] weight, columns k0..k0+31
        rb[i].u = *reinterpret_cast<const uint4*>(
            w + (long long)(n0 + ar) * K + k0 + ac + 8 * i);
      } else {
        rb[i].u = *reinterpret_cast<const uint4*>(
            w + (long long)(k0 + br) * N + n0 + bc + 8 * i);
      }
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
      if (TRANS_B) {
        *reinterpret_cast<uint4*>(&Bs[ar * GEMM_LDA + ac + 8 * i]) = rb[i].u;
      } else {
        *reinterpret_cast<uint4*>(&Bs[br * GEMM_LDB + bc + 8 * i]) = rb[i].u;
      }
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
      using BLayout = typename std::conditional<TRANS_B, wmma::col_major, wmma::row_major>::type;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm + 16 * i) * GEMM_LDA + kk], GEMM_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (TRANS_B) {
          wmma::load_matrix_sync(fb[j], &Bs[(wn + 16 * j) * GEMM_LDA + kk], GEMM_LDA);
        } else {
          wmma::load_matrix_sync(fb[j], &Bs[kk * GEMM_LDB + wn + 16 * j], GEMM_LDB);
        }
      }
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
    for (int j = 0; j < 8; ++j)
      v[j] = Cs[r * GEMM_LDC + cc + j] + (bias != nullptr ? bias[n0 + cc + j] : 0.f);
    if (EPI == EPI_F32) {
      float* o32 = static_cast<float*>(out_ptr) + (long long)gm * N + n0 + cc;
      *reinterpret_cast<float4*>(o32) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o32 + 4) = make_float4(v[4], v[5], v[6], v[7]);
      continue;
    }
    if (EPI == EPI_GELU_STASH) {
      Pack8 p;
#pragma unroll
      for (int j = 0; j < 8; ++j) p.h[j] = __float2bfloat16(v[j]);
      *reinterpret_cast<uint4*>(aux + (long long)gm * N + n0 + cc) = p.u;
    }
    if (EPI == EPI_QUICK_GELU || EPI == EPI_GELU_STASH) {
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
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out_ptr) + (long long)gm * N + n0 +
                              cc) = o.u;
  }
}

// Launch one ln_gemm on `stream`; returns cudaGetLastError() after the
// launch.  Shapes must satisfy N % 64 == 0, K % 32 == 0, ldres % 8 == 0
// (the Python wrappers check them and raise first).
static inline cudaError_t launch_ln_gemm(const __nv_bfloat16* a, const __nv_bfloat16* w,
                                         const float* bias, const __nv_bfloat16* res,
                                         void* out, int M, int N, int K, long long ldres,
                                         bool ln, int epi, float eps, cudaStream_t stream,
                                         bool trans_b = false, __nv_bfloat16* aux = nullptr) {
  if (N % GEMM_BN != 0 || K % GEMM_BK != 0) return cudaErrorInvalidValue;
  const dim3 grid((M + GEMM_BM - 1) / GEMM_BM, N / GEMM_BN);
  const dim3 block(GEMM_THREADS);
#define UML_GEMM_LAUNCH(L, E, T)                                                           \
  ln_gemm_kernel<L, E, T><<<grid, block, 0, stream>>>(a, w, bias, res, out, aux, M, N, K, \
                                                      ldres, eps)
  // the (prologue, epilogue, layout) triples the CLIP layers use
  if (!trans_b && ln && epi == EPI_NONE) UML_GEMM_LAUNCH(true, EPI_NONE, false);  // QKV
  else if (!trans_b && ln && epi == EPI_QUICK_GELU)
    UML_GEMM_LAUNCH(true, EPI_QUICK_GELU, false);                               // MLP in
  else if (!trans_b && ln && epi == EPI_GELU_STASH)
    UML_GEMM_LAUNCH(true, EPI_GELU_STASH, false);                               // MLP in + pre
  else if (!trans_b && !ln && epi == EPI_RESIDUAL)
    UML_GEMM_LAUNCH(false, EPI_RESIDUAL, false);                                // out-proj, MLP out
  else if (trans_b && !ln && epi == EPI_NONE)
    UML_GEMM_LAUNCH(false, EPI_NONE, true);                                     // g . wo^T
  else if (trans_b && !ln && epi == EPI_F32)
    UML_GEMM_LAUNCH(false, EPI_F32, true);                                      // dqkv . W_eff^T
  else return cudaErrorInvalidValue;
#undef UML_GEMM_LAUNCH
  return cudaGetLastError();
}

}  // namespace uml
