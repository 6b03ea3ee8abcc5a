// ln_gemm: out = epi(prologue(A) . W + b), bf16 operands, fp32 accumulation.
//
// The building block of every projection of the CLIP layers.  It replaces
// the matmuls that the TPU kernels compute in their own bodies: the QKV
// and out-projections of uml_tpu/ops/fused_attention.py (_block_kernel,
// _block_cls_kernel, _block_kernel_stash, _kernel), both MLP matmuls of
// uml_tpu/ops/ln_matmul.py (_mlp_block_kernel, _mlp_block_kernel_stash),
// the products of the stand-alone _ln_matmul_kernel, _ln_matmul_kernel_3d
// and _add_ln_matmul_kernel, the two products with a transposed weight
// inside the attention backward kernels (dattn = g . wo^T and dxn = dqkv .
// W_eff^T of _block_bwd_stash_kernel, _block_bwd_cls_kernel,
// _block_bwd_kernel) and the MLP backward's (_mlp_bwd_kernel,
// _mlp_bwd_dw_kernel).
//
//   A   [M, K] bf16, row-major, contiguous
//   W   [K, N] bf16, row-major (the JAX / flax kernel layout), or with
//       TRANS_B [N, K] row-major (the product then takes W^T)
//   b   [N] fp32, or null for no bias
//   res [M, N] bf16 with row stride ldres (EPI_RESIDUAL, EPI_DACT(_EXACT),
//       EPI_DACT_STASH(_EXACT): the pre stash), or fp32 (EPI_DACT_F32(_EXACT))
//   out [M, N] bf16, contiguous (fp32 for EPI_F32)
//   aux [M, N] bf16, contiguous (the two stashes and the six DACT epilogues)
//   colsum_part [ceil(M / 128), N] fp32, or null (EPI_DACT_F32(_EXACT) and
//       EPI_DACT_STASH(_EXACT) only)
//
// prologue: a row pre-pass (ln_rows_kernel, one warp per row) writes xn
//   [M, K] once to the caller's buffer (LnPrologue::xn); the product reads
//   it by TMA like any operand.  Statistics in fp32 with var = max(E[x^2]
//   - E[x]^2, 0) (row_stats), one rounding to bf16 at the end, as the TPU
//   kernels round the normalized row before the MXU dot.
//   PRO_LN: xn = bf16((x - mean) rstd), the raw LayerNorm; the LN
//   scale/bias are folded into W and b by the caller
//   (fold_ln_into_matmul), as on the TPU.  The dW products and the LN
//   backward read the same xn, which the MLP backwards return.
//   PRO_LN_AFFINE: xn = bf16(((x - mean) rstd) scale + bias), the LN scale
//   and bias (fp32 [K]) applied in fp32 before the rounding
//   (uml_tpu/ops/fused_attention.py::_kernel and
//   ln_matmul.py::_add_ln_matmul_kernel do not fold them; the stand-alone
//   ln_matmul takes this form too, so that its wrapper folds nothing per
//   call).
//   PRO_ADD_LN_AFFINE: the same of t32 = A + delta, the sum of the two bf16
//   values in fp32; the statistics are those of the unrounded t32
//   (ln_matmul.py:739-744), and the pass also writes t = bf16(t32) to
//   t_out.  x and delta are read once (the product never sees them).
// epilogue, always after the fp32 bias add, one rounding at the end:
//   EPI_NONE, EPI_QUICK_GELU (y * sigmoid(1.702 y)), EPI_GELU_EXACT
//   (y * 0.5 * (1 + erf(y / sqrt 2)), with the card's erff: the TPU
//   kernel's sigmoid-quintic fit stands in for an erf that Mosaic lacks),
//   EPI_RESIDUAL (y + res),
//   EPI_GELU_STASH (out = quick_gelu(y) and aux = y, the pre-activation
//   the MLP backward reads; the activation is taken of the unrounded fp32
//   y, the order of _mlp_block_kernel_stash, ln_matmul.py:199-204),
//   EPI_GELU_EXACT_STASH (the same with exact GELU: DINO's MLP in), and
//   EPI_F32 (y stored in fp32, for the LN backward that follows), and
//   EPI_DACT / EPI_DACT_F32, the MLP backward's recompute (the bodies of
//   _mlp_bwd_kernel and _mlp_bwd_dw_kernel, ln_matmul.py:310-533): y is
//   the unrounded fp32 pre-activation, res the cotangent dy of the
//   activation (bf16, or fp32), aux = quick_gelu(y) and out = dpre =
//   dy * quick_gelu'(y), both rounded to bf16 once, with one sigmoid
//   s: quick_gelu'(y) = s (1 + 1.702 y (1 - s)) (ln_matmul.py:296-302).
//   EPI_DACT_F32 also writes the column sums of the fp32 dpre over each
//   128-row tile to colsum_part[row tile] (db1 is their sum over the row
//   tiles: a second pass, in a fixed order).  EPI_DACT_EXACT and
//   EPI_DACT_F32_EXACT are the two with exact GELU (DINO): aux = gelu(y) =
//   y Phi(y), dpre = dy * (Phi(y) + y phi(y)) (ln_matmul.py:303-307, with
//   the card's erff where the TPU fits erf with a rational).
//   EPI_DACT_STASH and EPI_DACT_STASH_EXACT, the stash backward's dy = g .
//   w2^T (uml_tpu/ops/ln_matmul.py::_mlp_bwd_via_stash): the fp32
//   accumulator is dy (no bias), res the bf16 stash pre with row stride
//   ldres; act and act' of that rounded pre give aux = act(pre) and out =
//   dpre = dy * act'(pre), both rounded to bf16 once, and the column sums
//   of the fp32 dpre per 128-row tile as EPI_DACT_F32's.
//
// Every triple runs on the wgmma + TMA engine of wgmma_gemm.cuh, one route
// per (prologue, epilogue, layout) triple in launch_ln_gemm for every
// caller alike (so the stash and the recompute backwards, which share
// their launches, stay bit-equal, and so do the MLP forward with and
// without its stash): (PRO_LN, EPI_NONE) QKV, (PRO_LN, EPI_QUICK_GELU) and
// (PRO_LN, EPI_GELU_STASH) the MLP in (one epilogue, OUT_GELU, with or
// without the stash), (PRO_LN, EPI_GELU_EXACT) and (PRO_LN,
// EPI_GELU_EXACT_STASH) DINO's MLP in (OUT_GELU_EXACT, likewise),
// (PRO_NONE, EPI_RESIDUAL) the out-projections and the
// MLP out, (PRO_NONE, EPI_NONE, TRANS_B) g . wo^T, (PRO_NONE, EPI_F32,
// TRANS_B) dqkv . W_eff^T, g . w2^T and dpre . w1^T, (PRO_LN, EPI_DACT)
// and (PRO_LN, EPI_DACT_F32) the MLP backward's recompute (OUT_DACT_BF16
// with a bf16 dy, OUT_DACT with an fp32 dy and the column sums), (PRO_LN,
// EPI_DACT_EXACT) and (PRO_LN, EPI_DACT_F32_EXACT) DINO's (OUT_DACT_BF16_EXACT,
// OUT_DACT_EXACT), (PRO_NONE, EPI_DACT_STASH | EPI_DACT_STASH_EXACT,
// TRANS_B) the stash backward's g . w2^T (OUT_DACT_STASH(_EXACT)), and the
// stand-alone ops (rows 14-17): (PRO_LN_AFFINE | PRO_ADD_LN_AFFINE,
// EPI_NONE | EPI_QUICK_GELU | EPI_GELU_EXACT) on OUT_BF16, OUT_GELU
// (no stash) and OUT_GELU_EXACT.  Any other triple is refused.
//
// What bounds it on the H100: at ViT-B/16 B=64 the QKV product is
// 12608 x 768 x 2304 (44.6 GFLOP) over 16 MB of A and 3.5 MB of W, each
// MLP product 59.5 GFLOP: far above the card's ~295 FLOP/byte ridge, so
// the tensor cores bound them.  The pre-pass is bound by its bytes (19 MB
// of x read and of xn written at these widths; twice that with the add),
// ~1/8 of a product's time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
  EPI_GELU_EXACT = 7,
  EPI_GELU_EXACT_STASH = 8,
  EPI_DACT_EXACT = 9,
  EPI_DACT_F32_EXACT = 10,
  EPI_DACT_STASH = 11,
  EPI_DACT_STASH_EXACT = 12
};

enum { PRO_NONE = 0, PRO_LN = 1, PRO_LN_AFFINE = 2, PRO_ADD_LN_AFFINE = 3 };

// The activation codes of the C entries (ln_matmul.cu, mlp_block.cu,
// mlp_block_q8.cu): none, quick_gelu (CLIP), exact GELU (erf; DINO).
enum { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU_EXACT = 2 };

// an activation code's bf16 epilogue, or -1 for an unknown code
static inline int act_epilogue(int act) {
  return act == ACT_NONE ? EPI_NONE
         : act == ACT_QUICK_GELU ? EPI_QUICK_GELU
         : act == ACT_GELU_EXACT ? EPI_GELU_EXACT : -1;
}

// an activation code's stash epilogue (the training forward), or -1 where
// it has none (ACT_NONE: uml_tpu stashes only under an activation)
static inline int act_stash_epilogue(int act) {
  return act == ACT_QUICK_GELU ? EPI_GELU_STASH
         : act == ACT_GELU_EXACT ? EPI_GELU_EXACT_STASH : -1;
}

// an activation code's recompute epilogue of the MLP backward (dy fp32:
// row 20, with the column sums; bf16: row 19), or -1 where it has none
static inline int act_dact_epilogue(int act, bool dy_f32) {
  if (act == ACT_QUICK_GELU) return dy_f32 ? EPI_DACT_F32 : EPI_DACT;
  if (act == ACT_GELU_EXACT) return dy_f32 ? EPI_DACT_F32_EXACT : EPI_DACT_EXACT;
  return -1;
}

// an activation code's epilogue of the stash backward's dy = g . w2^T, or
// -1 where it has none
static inline int act_dact_stash_epilogue(int act) {
  return act == ACT_QUICK_GELU ? EPI_DACT_STASH
         : act == ACT_GELU_EXACT ? EPI_DACT_STASH_EXACT : -1;
}

// the operands of the prologues (null where a triple takes none)
struct LnPrologue {
  const __nv_bfloat16* delta = nullptr;  // [M, K], PRO_ADD_LN_AFFINE
  const float* scale = nullptr;          // [K] LN scale, PRO_LN_AFFINE / PRO_ADD_LN_AFFINE
  const float* bias = nullptr;           // [K] LN bias, the same
  __nv_bfloat16* t_out = nullptr;        // [M, K] = bf16(A + delta), PRO_ADD_LN_AFFINE
  __nv_bfloat16* xn = nullptr;           // [M, K], written by the pre-pass of every LN prologue
};

union Pack8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// Columns c .. c+7 of one row in fp32: x, or (ADD) x + delta, each the one
// fp32 addition of the two bf16 values.
template <bool ADD>
static __device__ __forceinline__ void row_chunk(const __nv_bfloat16* __restrict__ x,
                                                 const __nv_bfloat16* __restrict__ delta, int c,
                                                 float v[8]) {
  Pack8 p;
  p.u = *reinterpret_cast<const uint4*>(x + c);
  if (ADD) {
    Pack8 d;
    d.u = *reinterpret_cast<const uint4*>(delta + c);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __fadd_rn(__bfloat162float(p.h[i]), __bfloat162float(d.h[i]));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(p.h[i]);
  }
}

// The fp32 statistics of one row of x [., K] (or of x + delta), K a
// multiple of 8, one warp: lane l sums columns 8l .. 8l+7 of every 256,
// then a butterfly.  mean = E[v], rstd = rsqrt(max(E[v^2] - mean^2, 0) +
// eps).  The LN pre-pass and the LN backward (attention_bwd.cuh, through
// ln_row_stats) both take them from here, so the xn they form is the same.
template <bool ADD>
static __device__ __forceinline__ void row_stats(const __nv_bfloat16* __restrict__ x,
                                                 const __nv_bfloat16* __restrict__ delta, int K,
                                                 float eps, float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    float v[8];
    row_chunk<ADD>(x, delta, c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[i];
      ss += v[i] * v[i];
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

static __device__ __forceinline__ void ln_row_stats(const __nv_bfloat16* __restrict__ row, int K,
                                                    float eps, float& mean, float& rstd) {
  row_stats<false>(row, nullptr, K, eps, mean, rstd);
}

constexpr int LNR_THREADS = 128;  // 4 rows per block, one warp each

// p[0 .. 7] (fp32): two 16-byte loads where p is 16-byte aligned, else
// eight 4-byte ones (the same values)
static __device__ __forceinline__ void load8f(const float* __restrict__ p, bool vec, float v[8]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldg(p + i);
  }
}

// The LN pre-pass of the engine's triples, one warp per row of x [rows, K]
// (PRO one of PRO_LN, PRO_LN_AFFINE, PRO_ADD_LN_AFFINE; see the top of
// this file).  Each element is ((v - mean) * rstd) rounded, then for the
// affine prologues fma(., scale[k], bias[k]), then one rounding to bf16:
// the order and the contraction of the wmma prologue that computed rows
// 14-17 before this pass (nvcc, -fmad=true, contracted its `v * scale[k] +
// bias[k]` into one fma; the intrinsics here write that out, so no flag
// changes it), and its statistics in the same lane order: xn equals that
// kernel's operand bit for bit.  A lane reads the scale and bias of its 8
// columns as two 16-byte loads each: 8 scalar loads, each spread over 8
// cache lines by the lanes' 32-byte stride, made the L1 the bound (on the
// H100 the affine pass took 2.5x the raw one, on the same bytes).
template <int PRO>
static __global__ void __launch_bounds__(LNR_THREADS)
ln_rows_kernel(const __nv_bfloat16* __restrict__ x, const LnPrologue ops, int rows, int K,
               float eps) {
  constexpr bool ADD = PRO == PRO_ADD_LN_AFFINE;
  const int row = blockIdx.x * (LNR_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long off = (long long)row * K;
  const __nv_bfloat16* xr = x + off;
  const __nv_bfloat16* dr = ADD ? ops.delta + off : nullptr;
  const bool vec = ((reinterpret_cast<uintptr_t>(ops.scale) |
                     reinterpret_cast<uintptr_t>(ops.bias)) & 15) == 0;
  float mean, rstd;
  row_stats<ADD>(xr, dr, K, eps, mean, rstd);
  for (int c = (threadIdx.x & 31) * 8; c < K; c += 32 * 8) {
    float v[8], sc[8], bi[8];
    row_chunk<ADD>(xr, dr, c, v);
    if (PRO != PRO_LN) {
      load8f(ops.scale + c, vec, sc);
      load8f(ops.bias + c, vec, bi);
    }
    Pack8 o, t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y = __fmul_rn(__fsub_rn(v[i], mean), rstd);
      if (PRO != PRO_LN) y = __fmaf_rn(y, sc[i], bi[i]);
      o.h[i] = __float2bfloat16(y);
      if (ADD) t.h[i] = __float2bfloat16(v[i]);
    }
    *reinterpret_cast<uint4*>(ops.xn + off + c) = o.u;
    if (ADD) *reinterpret_cast<uint4*>(ops.t_out + off + c) = t.u;
  }
}

// Launch the pre-pass of prologue `pro` (PRO_LN, PRO_LN_AFFINE or
// PRO_ADD_LN_AFFINE) on `stream`; refuses a missing operand and K not a
// multiple of 8.
static inline cudaError_t launch_ln_prepass(const __nv_bfloat16* x, const LnPrologue& ops, int pro,
                                            int rows, int K, float eps, cudaStream_t stream) {
  const bool affine = pro == PRO_LN_AFFINE || pro == PRO_ADD_LN_AFFINE;
  if (K % 8 != 0 || ops.xn == nullptr || (pro != PRO_LN && !affine) ||
      (affine && (ops.scale == nullptr || ops.bias == nullptr)) ||
      (pro == PRO_ADD_LN_AFFINE && (ops.delta == nullptr || ops.t_out == nullptr)))
    return cudaErrorInvalidValue;
  const int per_block = LNR_THREADS / 32;
  const int grid = (rows + per_block - 1) / per_block;
  if (pro == PRO_LN)
    ln_rows_kernel<PRO_LN><<<grid, LNR_THREADS, 0, stream>>>(x, ops, rows, K, eps);
  else if (pro == PRO_LN_AFFINE)
    ln_rows_kernel<PRO_LN_AFFINE><<<grid, LNR_THREADS, 0, stream>>>(x, ops, rows, K, eps);
  else
    ln_rows_kernel<PRO_ADD_LN_AFFINE><<<grid, LNR_THREADS, 0, stream>>>(x, ops, rows, K, eps);
  return cudaGetLastError();
}

// The raw-LN pre-pass alone: xn = bf16((x - mean) rstd).
static inline cudaError_t launch_ln_rows(const __nv_bfloat16* x, __nv_bfloat16* xn, int rows,
                                         int K, float eps, cudaStream_t stream) {
  LnPrologue ops;
  ops.xn = xn;
  return launch_ln_prepass(x, ops, PRO_LN, rows, K, eps, stream);
}

// Launch one ln_gemm on `stream`; returns the first launch error.  `pro`
// is one of PRO_*, `ops` the operands of the prologues (for every LN
// prologue the xn buffer [M, K] its pre-pass writes and the product
// reads).  Takes N and K multiples of 64 and an even ldres (the Python
// wrappers check them and raise first); refuses a triple it has no route
// for.
static inline cudaError_t launch_ln_gemm(const __nv_bfloat16* a, const __nv_bfloat16* w,
                                         const float* bias, const void* res, void* out, int M,
                                         int N, int K, long long ldres, int pro, int epi,
                                         float eps, cudaStream_t stream, bool trans_b = false,
                                         __nv_bfloat16* aux = nullptr,
                                         float* colsum_part = nullptr,
                                         LnPrologue ops = LnPrologue{}) {
  WggEpilogue ep;
  ep.bias = bias;
  ep.out = out;
  if (pro == PRO_NONE) {
    if (epi == EPI_RESIDUAL && !trans_b) {  // out-projections, MLP out
      ep.res = static_cast<const __nv_bfloat16*>(res);
      ep.ldres = ldres;
      return launch_wgmma_gemm<false, true, WGG_OUT_RESIDUAL>(a, w, ep, M, N, K, stream);
    }
    if (epi == EPI_NONE && trans_b)  // g . wo^T
      return launch_wgmma_gemm<false, false, WGG_OUT_BF16>(a, w, ep, M, N, K, stream);
    if (epi == EPI_F32 && trans_b)  // dqkv . W_eff^T, g . w2^T, dpre . w1^T
      return launch_wgmma_gemm<false, false, WGG_OUT_F32>(a, w, ep, M, N, K, stream);
    if ((epi == EPI_DACT_STASH || epi == EPI_DACT_STASH_EXACT) && trans_b) {
      // the stash backward's g . w2^T: res is the bf16 pre stash
      ep.lddy = ldres;
      ep.aux = aux;
      ep.dy16 = static_cast<const __nv_bfloat16*>(res);
      ep.colsum_part = colsum_part;
      return epi == EPI_DACT_STASH
                 ? launch_wgmma_gemm<false, false, WGG_OUT_DACT_STASH>(a, w, ep, M, N, K, stream)
                 : launch_wgmma_gemm<false, false, WGG_OUT_DACT_STASH_EXACT>(a, w, ep, M, N, K,
                                                                            stream);
    }
    return cudaErrorInvalidValue;
  }
  // an LN prologue: QKV, the MLP in (quick_gelu, exact GELU or none) and
  // the MLP backward's recompute (PRO_LN), the stand-alone ops of rows
  // 14-17 (the affine prologues)
  const bool stash = epi == EPI_GELU_STASH || epi == EPI_GELU_EXACT_STASH;
  const bool routed =
      !trans_b && (epi == EPI_NONE || epi == EPI_QUICK_GELU || epi == EPI_GELU_EXACT ||
                   (pro == PRO_LN &&
                    (stash || epi == EPI_DACT || epi == EPI_DACT_F32 ||
                     epi == EPI_DACT_EXACT || epi == EPI_DACT_F32_EXACT)));
  if (!routed || (stash && aux == nullptr)) return cudaErrorInvalidValue;
  UML_TRY(launch_ln_prepass(a, ops, pro, M, K, eps, stream));
  const __nv_bfloat16* xn = ops.xn;
  switch (epi) {
    case EPI_NONE:
      return launch_wgmma_gemm<false, true, WGG_OUT_BF16>(xn, w, ep, M, N, K, stream);
    case EPI_QUICK_GELU:
    case EPI_GELU_STASH:
      ep.aux = epi == EPI_GELU_STASH ? aux : nullptr;
      return launch_wgmma_gemm<false, true, WGG_OUT_GELU>(xn, w, ep, M, N, K, stream);
    case EPI_GELU_EXACT:
    case EPI_GELU_EXACT_STASH:
      ep.aux = epi == EPI_GELU_EXACT_STASH ? aux : nullptr;
      return launch_wgmma_gemm<false, true, WGG_OUT_GELU_EXACT>(xn, w, ep, M, N, K, stream);
    case EPI_DACT:
    case EPI_DACT_EXACT:
      ep.lddy = ldres;
      ep.aux = aux;
      ep.dy16 = static_cast<const __nv_bfloat16*>(res);
      return epi == EPI_DACT
                 ? launch_wgmma_gemm<false, true, WGG_OUT_DACT_BF16>(xn, w, ep, M, N, K, stream)
                 : launch_wgmma_gemm<false, true, WGG_OUT_DACT_BF16_EXACT>(xn, w, ep, M, N, K,
                                                                          stream);
    default:  // EPI_DACT_F32, EPI_DACT_F32_EXACT
      ep.lddy = ldres;
      ep.aux = aux;
      ep.dy = static_cast<const float*>(res);
      ep.colsum_part = colsum_part;
      return epi == EPI_DACT_F32
                 ? launch_wgmma_gemm<false, true, WGG_OUT_DACT>(xn, w, ep, M, N, K, stream)
                 : launch_wgmma_gemm<false, true, WGG_OUT_DACT_EXACT>(xn, w, ep, M, N, K, stream);
  }
}

}  // namespace uml
