// uml_ln_gemm / uml_gemm_at / uml_q8_gemm: one product of ln_gemm.cuh,
// gemm_at.cuh or q8_gemm.cuh on its own.  No model calls them: the
// half-block entries launch these products inside their own C calls.
// They let the card tests and chip_smoke.py hold each (prologue,
// epilogue, layout) triple of the rows, and gemm_at, against an
// fp32 product of the same bf16 operands, each int8 epilogue against its
// plain version bit for bit, and time each beside cuBLAS at its shape.

#include "gemm_at.cuh"
#include "ln_gemm.cuh"
#include "q8_gemm.cuh"

// xn: [M, K] bf16 scratch of the LN prologues; ln_scale, ln_bias: [K]
// fp32 (the affine prologues); delta, t: [M, K] bf16 (PRO_ADD_LN_AFFINE)
extern "C" int uml_ln_gemm(const void* a, const void* w, const void* bias, const void* res,
                           void* out, void* aux, void* colsum_part, void* xn,
                           const void* ln_scale, const void* ln_bias, const void* delta, void* t,
                           int M, int N, int K, long long ldres, int pro, int epi, int trans_b,
                           float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  uml::LnPrologue ops;
  ops.delta = static_cast<const bf16*>(delta);
  ops.scale = static_cast<const float*>(ln_scale);
  ops.bias = static_cast<const float*>(ln_bias);
  ops.t_out = static_cast<bf16*>(t);
  ops.xn = static_cast<bf16*>(xn);
  return (int)uml::launch_ln_gemm(static_cast<const bf16*>(a), static_cast<const bf16*>(w),
                                  static_cast<const float*>(bias), res, out, M, N, K, ldres, pro,
                                  epi, eps, static_cast<cudaStream_t>(stream), trans_b != 0,
                                  static_cast<bf16*>(aux), static_cast<float*>(colsum_part), ops);
}

// ws: fp32 scratch of ws_floats for the row chunks' partials; splits: the
// chunk count, or 0 for the launcher's choice
extern "C" int uml_gemm_at(const void* a, const void* b, void* c, void* ws, long long ws_floats,
                           int R, int P, int N, int splits, void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::launch_gemm_at(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                  static_cast<float*>(c), static_cast<float*>(ws), ws_floats, R,
                                  P, N, splits, static_cast<cudaStream_t>(stream));
}

// a [M, K] int8, w [N, K] int8 (K-major); epi one of Q8_EPI_*; rowmax [M]
// q8_ordered ints (raised by Q8_EPI_ROWMAX from the caller's initial
// values, read by Q8_EPI_ACTQ) and qscale [M] fp32 (Q8_EPI_ACTQ) or null
extern "C" int uml_q8_gemm(const void* a, const void* w, const void* row_scale,
                           const void* col_scale, const void* bias, const void* res, void* out,
                           void* rowmax, void* qscale, int M, int N, int K, int epi,
                           void* stream) {
  return (int)uml::launch_q8_gemm(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res), out, M, N, K, epi,
      static_cast<cudaStream_t>(stream), static_cast<int*>(rowmax),
      static_cast<float*>(qscale));
}
