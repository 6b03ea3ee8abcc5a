// uml_mlp_bwd / uml_mlp_bwd_dw: the backward of the MLP half-block of a
// CLIP or DINO layer with no pre-activation stash (UML_MLP_STASH=0, or the
// memory gate off).  Both take the activation code of uml_mlp_block (1
// quick_gelu, CLIP; 2 exact GELU, DINO; 0 has no recompute epilogue and is
// refused): act and act' below are the code's (EPI_DACT* for quick_gelu,
// EPI_DACT*_EXACT for exact GELU: gelu' = Phi + y phi on erff and the
// fast exp).
//
// uml_mlp_bwd replaces uml_tpu/ops/ln_matmul.py::_mlp_bwd_kernel (via
// _mlp_bwd_call, UML_MLP_BWD=kernel).  From x and dy = g . w2^T (computed
// and rounded to bf16 by the caller, ln_matmul.py:400-402) it computes, in
// four launches with both products on the wgmma engine (wgmma_gemm.cuh):
//   1. xn = bf16(rawLN(x)) (the row pre-pass), then pre = xn . w1 + b1 in
//      fp32, yact = act(pre) and dpre = dy * act'(pre), both bf16
//                                      (ln_gemm, EPI_DACT or EPI_DACT_EXACT)
//   2. dxn = dpre . w1^T, kept in fp32           (ln_gemm, TRANS_B, EPI_F32)
//   3. the LN backward with no residual -> dx_ln (ln_bwd; xn is the
//      pre-pass's, the same statistics and rounding)
// -> (dx_ln, xn, dpre, yact); the residual, dw1 = xn^T dpre, dw2 = yact^T g
// and the bias sums stay outside (ln_matmul.py:405-414).
//
// uml_mlp_bwd_dw replaces ::_mlp_bwd_dw_kernel (via _mlp_bwd_dw_call,
// UML_MLP_BWD=dw), which also computes dy and the weight gradients in its
// own body; every product on the wgmma engine (wgmma_gemm.cuh):
//   1. dy = g . w2^T in fp32                     (ln_gemm, TRANS_B, EPI_F32)
//   2. xn = bf16(rawLN(x)) (the row pre-pass), then as 1. above with the
//      fp32 dy, and the column sums of the fp32 dpre per 128-row tile
//                              (ln_gemm, EPI_DACT_F32 or EPI_DACT_F32_EXACT)
//   3. dxn = dpre . w1^T, then the LN backward WITH the residual g -> dx
//      (it does not write xn again: the pre-pass's is the same)
//   4. dw1 = xn^T . dpre and dw2 = yact^T . g in fp32 (gemm_at, its row
//      chunks' partials in dy's buffer, dead by then), db1 = the sum of the
//      row tiles' column sums (colsum_parts)
// -> (dx, dw1, db1, dw2) in fp32 dW; only db2 = sum(g) stays outside
// (ln_matmul.py:541).
//
// What bounds them on the H100, at ViT-B/16 B=64 (12608 rows, K=768,
// M=3072): uml_mlp_bwd does two 59.5 GFLOP products (119 GFLOP, ~0.12 ms
// at the bf16 peak) and uml_mlp_bwd_dw five (298 GFLOP, ~0.30 ms), so the
// tensor cores bound both.  The TPU kernels keep the hidden-width tensors
// in VMEM; here they make round trips through device memory: dpre and
// yact bf16 (77.5 MB each) and, in uml_mlp_bwd_dw, the fp32 dy (155 MB),
// ~0.3 GB a layer.  Keeping the hidden on chip is queued (ROADMAP K8).
// At DINOv2-B/14 B=64 (16448 rows) the products are 155 and 388 GFLOP;
// the exact derivative costs an erff and an exp an element of the 50.5 M
// hidden values in the recompute's epilogue.

#include "attention_bwd.cuh"
#include "blocks.cuh"
#include "gemm_at.cuh"

namespace uml {

// x [rows, K], dy [rows, M] bf16 -> dx_ln [rows, K], xn [rows, K],
// dpre [rows, M], yact [rows, M]; dxn [rows, K] fp32 is scratch.
static inline cudaError_t run_mlp_bwd(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                                      const float* b1, const __nv_bfloat16* w1,
                                      __nv_bfloat16* dpre, __nv_bfloat16* yact, float* dxn,
                                      __nv_bfloat16* dx_ln, __nv_bfloat16* xn, int rows, int K,
                                      int M, int act, float eps, cudaStream_t stream) {
  const int epi = act_dact_epilogue(act, false);
  if (epi < 0) return cudaErrorInvalidValue;
  LnPrologue ops;
  ops.xn = xn;
  UML_TRY(launch_ln_gemm(x, w1, b1, dy, dpre, rows, M, K, M, PRO_LN, epi, eps, stream, false,
                         yact, nullptr, ops));
  UML_TRY(launch_ln_gemm(dpre, w1, nullptr, nullptr, dxn, rows, K, M, 0, PRO_NONE, EPI_F32, eps,
                         stream, true));
  return launch_ln_bwd(x, dxn, nullptr, dx_ln, nullptr, rows, K, 1, eps, stream);
}

// x, g [rows, K] -> dx [rows, K], dw1 [K, M], db1 [M], dw2 [M, K] (fp32);
// dy [rows, M] fp32, dpre and yact [rows, M] bf16, dxn [rows, K] fp32,
// db1_part [ceil(rows / 128), M] fp32 and xn [rows, K] bf16 are scratch.
static inline cudaError_t run_mlp_bwd_dw(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                         const float* b1, const __nv_bfloat16* w1,
                                         const __nv_bfloat16* w2, float* dy,
                                         __nv_bfloat16* dpre, __nv_bfloat16* yact, float* dxn,
                                         float* db1_part, __nv_bfloat16* dx, __nv_bfloat16* xn,
                                         float* dw1, float* db1, float* dw2, int rows, int K,
                                         int M, int act, float eps, cudaStream_t stream) {
  const int epi = act_dact_epilogue(act, true);
  if (epi < 0) return cudaErrorInvalidValue;
  UML_TRY(launch_ln_gemm(g, w2, nullptr, nullptr, dy, rows, M, K, 0, PRO_NONE, EPI_F32, eps, stream,
                         true));
  LnPrologue ops;
  ops.xn = xn;
  UML_TRY(launch_ln_gemm(x, w1, b1, dy, dpre, rows, M, K, M, PRO_LN, epi, eps, stream, false, yact,
                         db1_part, ops));
  UML_TRY(launch_ln_gemm(dpre, w1, nullptr, nullptr, dxn, rows, K, M, 0, PRO_NONE, EPI_F32, eps,
                         stream, true));
  UML_TRY(launch_ln_bwd(x, dxn, g, dx, nullptr, rows, K, 1, eps, stream));
  // dy is dead after the recompute: it holds gemm_at's partials
  const long long ws = (long long)rows * M;
  UML_TRY(launch_gemm_at(xn, dpre, dw1, dy, ws, rows, K, M, 0, stream));
  UML_TRY(launch_gemm_at(yact, g, dw2, dy, ws, rows, M, K, 0, stream));
  return launch_colsum_parts(db1_part, db1, (rows + WGG_BM - 1) / WGG_BM, M, stream);
}

}  // namespace uml

extern "C" int uml_mlp_bwd(const void* x, const void* dy, const void* b1, const void* w1,
                           void* dpre, void* yact, void* dxn, void* dx_ln, void* xn, int rows,
                           int K, int M, int act, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::run_mlp_bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const float*>(b1),
      static_cast<const bf16*>(w1), static_cast<bf16*>(dpre), static_cast<bf16*>(yact),
      static_cast<float*>(dxn), static_cast<bf16*>(dx_ln), static_cast<bf16*>(xn), rows, K, M,
      act, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int uml_mlp_bwd_dw(const void* x, const void* g, const void* b1, const void* w1,
                              const void* w2, void* dy, void* dpre, void* yact, void* dxn,
                              void* db1_part, void* dx, void* xn, void* dw1, void* db1,
                              void* dw2, int rows, int K, int M, int act, float eps,
                              void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::run_mlp_bwd_dw(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const float*>(b1),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), static_cast<float*>(dy),
      static_cast<bf16*>(dpre), static_cast<bf16*>(yact), static_cast<float*>(dxn),
      static_cast<float*>(db1_part), static_cast<bf16*>(dx), static_cast<bf16*>(xn),
      static_cast<float*>(dw1), static_cast<float*>(db1), static_cast<float*>(dw2), rows, K, M,
      act, eps, static_cast<cudaStream_t>(stream));
}
