// ln_gemm: out = epi(prologue(A) . W + b), bf16 operands, fp32 accumulation.
//
// The building block of every projection of the CLIP layers.  It replaces
// the matmuls that the TPU kernels compute in their own bodies: the QKV
// and out-projections of uml_tpu/ops/fused_attention.py (_block_kernel,
// _block_cls_kernel, _block_kernel_stash), both MLP matmuls of
// uml_tpu/ops/ln_matmul.py (_mlp_block_kernel, _mlp_block_kernel_stash),
// the two products with a transposed weight inside the attention
// backward kernels (dattn = g . wo^T and dxn = dqkv . W_eff^T of
// _block_bwd_stash_kernel, _block_bwd_cls_kernel, _block_bwd_kernel) and
// the MLP backward's (_mlp_bwd_kernel, _mlp_bwd_dw_kernel).
//
//   A   [M, K] bf16, row-major, contiguous
//   W   [K, N] bf16, row-major (the JAX / flax kernel layout), or with
//       TRANS_B [N, K] row-major (the product then takes W^T)
//   b   [N] fp32, or null for no bias
//   res [M, N] bf16 with row stride ldres (EPI_RESIDUAL, EPI_DACT), or
//       fp32 (EPI_DACT_F32)
//   out [M, N] bf16, contiguous (fp32 for EPI_F32)
//   aux [M, N] bf16, contiguous (EPI_GELU_STASH, EPI_DACT, EPI_DACT_F32)
//   colsum_part [ceil(M / 128), N] fp32, or null (EPI_DACT_F32 only)
//
// prologue (PRO_LN): the raw LayerNorm of each A row, statistics in fp32
//   with var = max(E[x^2] - E[x]^2, 0); the LN scale/bias are folded into
//   W and b by the caller (fold_ln_into_matmul), as on the TPU.  The
//   normalized row is rounded to bf16 before the product, as the TPU
//   kernels round it before the MXU dot.
//   PRO_LN_AFFINE applies the LN scale and bias (fp32 [K]) in the kernel,
//   in fp32, before that rounding (uml_tpu/ops/fused_attention.py::_kernel
//   and ln_matmul.py::_add_ln_matmul_kernel do not fold them; the
//   stand-alone ln_matmul takes this form too, so that its wrapper folds
//   nothing per call).
//   PRO_ADD_LN_AFFINE first adds a second operand: t = A + delta in fp32,
//   the statistics taken of the unrounded sum (ln_matmul.py:739-744), t
//   rounded to bf16 and written to t_out by the first column block of each
//   row tile; every column block forms the same fp32 sum again in its K
//   loop (delta is read N/64 times, as A is).
// epilogue, always after the fp32 bias add, one rounding at the end:
//   EPI_NONE, EPI_QUICK_GELU (y * sigmoid(1.702 y)), EPI_GELU_EXACT
//   (y * 0.5 * (1 + erf(y / sqrt 2)), with the card's erff: the TPU kernel's
//   sigmoid-quintic fit stands in for an erf that Mosaic lacks),
//   EPI_RESIDUAL (y + res),
//   EPI_GELU_STASH (out = quick_gelu(y) and aux = y, the pre-activation
//   the MLP backward reads; the activation is taken of the unrounded fp32
//   y, the order of _mlp_block_kernel_stash, ln_matmul.py:199-204), and
//   EPI_F32 (y stored in fp32, for the LN backward that follows), and
//   EPI_DACT / EPI_DACT_F32, the MLP backward's recompute (the bodies of
//   _mlp_bwd_kernel and _mlp_bwd_dw_kernel, ln_matmul.py:310-533): y is
//   the unrounded fp32 pre-activation, res the cotangent dy of the
//   activation (bf16, or fp32), aux = quick_gelu(y) and out = dpre =
//   dy * quick_gelu'(y), both rounded to bf16 once, with one sigmoid
//   s: quick_gelu'(y) = s (1 + 1.702 y (1 - s)) (ln_matmul.py:296-302).
//   EPI_DACT_F32 also writes the column sums of the fp32 dpre over each
//   128-row tile to colsum_part[row tile] (db1 is their sum over the row
//   tiles: a second pass, in a fixed order).
//
// Two mainloops, chosen by the (prologue, epilogue, layout) triple in
// launch_ln_gemm, for every caller alike (so the stash and the recompute
// backwards, which share their launches, stay bit-equal, and so do the
// MLP forward with and without its stash):
// * the wgmma + TMA engine of wgmma_gemm.cuh: (PRO_LN, EPI_NONE) QKV,
//   (PRO_LN, EPI_QUICK_GELU) and (PRO_LN, EPI_GELU_STASH) the MLP in (one
//   epilogue, OUT_GELU, with or without the stash), (PRO_NONE,
//   EPI_RESIDUAL) the out-projections and the MLP out, (PRO_NONE,
//   EPI_NONE, TRANS_B) g . wo^T, (PRO_NONE, EPI_F32, TRANS_B) dqkv .
//   W_eff^T, g . w2^T and dpre . w1^T, (PRO_LN, EPI_DACT) and (PRO_LN,
//   EPI_DACT_F32) the MLP backward's recompute (OUT_DACT_BF16 with a bf16
//   dy, OUT_DACT with an fp32 dy and the column sums).  Their PRO_LN prologue is a row pre-pass
//   (ln_rows_kernel, one warp per row): xn = bf16((x - mean) rstd) written
//   once to the caller's xn buffer (LnPrologue::xn), with the statistics
//   and the single rounding of the wmma prologue below, then read by TMA
//   like any operand; the dW products and the LN backward read that same
//   xn, which the MLP backwards return.
// * nvcuda::wmma (mma.sync 16x16x16) on 64x64 block tiles with a
//   register-prefetched K loop for the PRO_LN_AFFINE and PRO_ADD_LN_AFFINE
//   prologues of the stand-alone ops (rows 14-17, with EPI_NONE,
//   EPI_QUICK_GELU or EPI_GELU_EXACT), which recompute the LN statistics
//   in every block column (N/64 reads of the same rows).  They are queued
//   for the engine (ROADMAP K1).
//
// What bounds it on the H100: at ViT-B/16 B=64 the QKV product is
// 12608 x 768 x 2304 (44.6 GFLOP) over 16 MB of A and 3.5 MB of W, each
// MLP product 59.5 GFLOP: far above the card's ~295 FLOP/byte ridge, so
// the tensor cores bound them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

namespace uml {

// return the first launch error of a composition
#define UML_TRY(call)                             \
  do {                                            \
    const cudaError_t uml_err_ = (call);          \
    if (uml_err_ != cudaSuccess) return uml_err_; \
  } while (0)

enum {
  EPI_NONE = 0,
  EPI_QUICK_GELU = 1,
  EPI_RESIDUAL = 2,
  EPI_GELU_STASH = 3,
  EPI_F32 = 4,
  EPI_DACT = 5,
  EPI_DACT_F32 = 6,
  EPI_GELU_EXACT = 7
};

enum { PRO_NONE = 0, PRO_LN = 1, PRO_LN_AFFINE = 2, PRO_ADD_LN_AFFINE = 3 };

// the extra operands of the prologues (null where a triple takes none)
struct LnPrologue {
  const __nv_bfloat16* delta = nullptr;  // [M, K], PRO_ADD_LN_AFFINE
  const float* scale = nullptr;          // [K] LN scale
  const float* bias = nullptr;           // [K] LN bias
  __nv_bfloat16* t_out = nullptr;        // [M, K] = bf16(A + delta), PRO_ADD_LN_AFFINE
  __nv_bfloat16* xn = nullptr;           // [M, K] = bf16(rawLN(A)), PRO_LN on the engine
};

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


// The fp32 statistics of one row of x [., K] (K a multiple of 8), one
// warp: lane l sums columns 8l .. 8l+7 of every 256, then a butterfly.
// mean = E[x], rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps).  The LN
// pre-pass and the LN backward (attention_bwd.cuh) both take them from
// here, so the xn they form is the same.
static __device__ __forceinline__ void ln_row_stats(const __nv_bfloat16* __restrict__ row, int K,
                                                    float eps, float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
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
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  mean = s / K;
  rstd = rsqrtf(fmaxf(ss / K - mean * mean, 0.f) + eps);
}

constexpr int LNR_THREADS = 128;  // 4 rows per block, one warp each

// The LN pre-pass of the engine's PRO_LN triples: xn = bf16((x - mean)
// rstd), one warp per row of x [rows, K].
static __global__ void __launch_bounds__(LNR_THREADS)
ln_rows_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xn, int rows,
               int K, float eps) {
  const int row = blockIdx.x * (LNR_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (long long)row * K;
  float mean, rstd;
  ln_row_stats(xr, K, eps, mean, rstd);
  for (int c = (threadIdx.x & 31) * 8; c < K; c += 32 * 8) {
    Pack8 p, o;
    p.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int i = 0; i < 8; ++i) o.h[i] = __float2bfloat16((__bfloat162float(p.h[i]) - mean) * rstd);
    *reinterpret_cast<uint4*>(xn + (long long)row * K + c) = o.u;
  }
}

static inline cudaError_t launch_ln_rows(const __nv_bfloat16* x, __nv_bfloat16* xn, int rows,
                                         int K, float eps, cudaStream_t stream) {
  if (K % 8 != 0 || xn == nullptr) return cudaErrorInvalidValue;
  const int per_block = LNR_THREADS / 32;
  ln_rows_kernel<<<(rows + per_block - 1) / per_block, LNR_THREADS, 0, stream>>>(x, xn, rows, K,
                                                                                 eps);
  return cudaGetLastError();
}

template <int PRO, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
ln_gemm_kernel(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias,
               void* __restrict__ out_ptr,
               int M, int N, int K, float eps, LnPrologue pro) {
  using namespace nvcuda;
  constexpr bool LN = PRO != PRO_NONE;
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
          if (PRO == PRO_ADD_LN_AFFINE) {
            Pack8 d, t;
            d.u = *reinterpret_cast<const uint4*>(pro.delta + (long long)gm * K + c);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float v = __bfloat162float(p.h[i]) + __bfloat162float(d.h[i]);
              t.h[i] = __float2bfloat16(v);
              s += v;
              ss += v * v;
            }
            if (blockIdx.y == 0)
              *reinterpret_cast<uint4*>(pro.t_out + (long long)gm * K + c) = t.u;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float v = __bfloat162float(p.h[i]);
              s += v;
              ss += v * v;
            }
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

  Pack8 ra[2], rb[2], rd[2];
  int k_cur = 0;  // the k offset of the tile held in ra / rb / rd
  auto load_global = [&](int k0) {
    k_cur = k0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (gar < M) {
        ra[i].u = *reinterpret_cast<const uint4*>(
            a + (long long)gar * K + k0 + ac + 8 * i);
        if (PRO == PRO_ADD_LN_AFFINE)
          rd[i].u = *reinterpret_cast<const uint4*>(
              pro.delta + (long long)gar * K + k0 + ac + 8 * i);
      } else {
        ra[i].u = make_uint4(0, 0, 0, 0);
        if (PRO == PRO_ADD_LN_AFFINE) rd[i].u = make_uint4(0, 0, 0, 0);
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
        for (int j = 0; j < 8; ++j) {
          float v = __bfloat162float(p.h[j]);
          if (PRO == PRO_ADD_LN_AFFINE) v += __bfloat162float(rd[i].h[j]);
          v = (v - mean) * rstd;
          if (PRO == PRO_LN_AFFINE || PRO == PRO_ADD_LN_AFFINE) {
            // a padded row (rstd 0) becomes the LN bias: it is never stored
            const int kc = k_cur + ac + 8 * i + j;
            v = v * pro.scale[kc] + pro.bias[kc];
          }
          p.h[j] = __float2bfloat16(v);
        }
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
    for (int j = 0; j < 8; ++j)
      v[j] = Cs[r * GEMM_LDC + cc + j] + (bias != nullptr ? bias[n0 + cc + j] : 0.f);
    if (EPI == EPI_QUICK_GELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = v[j] * (1.f / (1.f + expf(-1.702f * v[j])));
    } else if (EPI == EPI_GELU_EXACT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = v[j] * 0.5f * (1.f + erff(v[j] * 0.70710678118654752f));
    }
    Pack8 o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.h[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out_ptr) + (long long)gm * N + n0 +
                              cc) = o.u;
  }
}

// Launch one ln_gemm on `stream`; returns the first launch error.  `pro`
// is one of PRO_*, `ops` the extra operands of the prologues (for PRO_LN
// on the engine, the xn buffer [M, K] it writes and reads).  The engine's
// triples take N and K multiples of 64 and an even ldres; the wmma ones
// N % 64 == 0 and K % 32 == 0 (the Python wrappers check them and raise
// first).
static inline cudaError_t launch_ln_gemm(const __nv_bfloat16* a, const __nv_bfloat16* w,
                                         const float* bias, const void* res, void* out, int M,
                                         int N, int K, long long ldres, int pro, int epi,
                                         float eps, cudaStream_t stream, bool trans_b = false,
                                         __nv_bfloat16* aux = nullptr,
                                         float* colsum_part = nullptr,
                                         LnPrologue ops = LnPrologue{}) {
  // the wgmma + TMA engine
  WggEpilogue ep;
  ep.bias = bias;
  ep.out = out;
  if (pro == PRO_LN && epi == EPI_NONE && !trans_b) {  // QKV
    UML_TRY(launch_ln_rows(a, ops.xn, M, K, eps, stream));
    return launch_wgmma_gemm<false, true, WGG_OUT_BF16>(ops.xn, w, ep, M, N, K, stream);
  }
  if (pro == PRO_LN && (epi == EPI_QUICK_GELU || epi == EPI_GELU_STASH) && !trans_b) {  // MLP in
    if (epi == EPI_GELU_STASH && aux == nullptr) return cudaErrorInvalidValue;
    UML_TRY(launch_ln_rows(a, ops.xn, M, K, eps, stream));
    ep.aux = epi == EPI_GELU_STASH ? aux : nullptr;
    return launch_wgmma_gemm<false, true, WGG_OUT_GELU>(ops.xn, w, ep, M, N, K, stream);
  }
  if (pro == PRO_NONE && epi == EPI_RESIDUAL && !trans_b) {  // out-projections, MLP out
    ep.res = static_cast<const __nv_bfloat16*>(res);
    ep.ldres = ldres;
    return launch_wgmma_gemm<false, true, WGG_OUT_RESIDUAL>(a, w, ep, M, N, K, stream);
  }
  if (pro == PRO_NONE && epi == EPI_NONE && trans_b)  // g . wo^T
    return launch_wgmma_gemm<false, false, WGG_OUT_BF16>(a, w, ep, M, N, K, stream);
  if (pro == PRO_NONE && epi == EPI_F32 && trans_b)  // dqkv . W_eff^T, g . w2^T, dpre . w1^T
    return launch_wgmma_gemm<false, false, WGG_OUT_F32>(a, w, ep, M, N, K, stream);
  if (pro == PRO_LN && (epi == EPI_DACT || epi == EPI_DACT_F32) && !trans_b) {  // MLP bwd
    UML_TRY(launch_ln_rows(a, ops.xn, M, K, eps, stream));
    ep.lddy = ldres;
    ep.aux = aux;
    if (epi == EPI_DACT) {
      ep.dy16 = static_cast<const __nv_bfloat16*>(res);
      return launch_wgmma_gemm<false, true, WGG_OUT_DACT_BF16>(ops.xn, w, ep, M, N, K, stream);
    }
    ep.dy = static_cast<const float*>(res);
    ep.colsum_part = colsum_part;
    return launch_wgmma_gemm<false, true, WGG_OUT_DACT>(ops.xn, w, ep, M, N, K, stream);
  }
  // the others: wmma
  if (N % GEMM_BN != 0 || K % GEMM_BK != 0) return cudaErrorInvalidValue;
  const dim3 grid((M + GEMM_BM - 1) / GEMM_BM, N / GEMM_BN);
  const dim3 block(GEMM_THREADS);
  if (trans_b) return cudaErrorInvalidValue;
#define UML_GEMM_CASE(P, E)                                                                 \
  if (pro == P && epi == E) {                                                               \
    ln_gemm_kernel<P, E><<<grid, block, 0, stream>>>(a, w, bias, out, M, N, K, eps, ops);   \
    return cudaGetLastError();                                                              \
  }
  UML_GEMM_CASE(PRO_LN_AFFINE, EPI_NONE)          // ln_matmul, ln_qkv_attention
  UML_GEMM_CASE(PRO_LN_AFFINE, EPI_QUICK_GELU)    // ln_matmul
  UML_GEMM_CASE(PRO_LN_AFFINE, EPI_GELU_EXACT)
  UML_GEMM_CASE(PRO_ADD_LN_AFFINE, EPI_NONE)      // add_ln_matmul
  UML_GEMM_CASE(PRO_ADD_LN_AFFINE, EPI_QUICK_GELU)
  UML_GEMM_CASE(PRO_ADD_LN_AFFINE, EPI_GELU_EXACT)
#undef UML_GEMM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace uml
