// uml_ln_matmul and uml_add_ln_matmul: the stand-alone LayerNorm -> matmul
// ops of the non-fused CLIP branch.
//
// uml_ln_matmul replaces uml_tpu/ops/ln_matmul.py::_ln_matmul_kernel (2-d
// x, rows padded to 256 there) and ::_ln_matmul_kernel_3d (x [B, S, K], G
// images per program): out = act(LN_affine(x) . w + b).  The TPU kernel
// takes the LN affine folded into w and b, a fold its wrapper makes on
// every call; here the affine is applied in the LN pre-pass, in fp32
// before the rounding to bf16, so nothing is folded (ln_matmul_reference,
// the unfolded form, is the op's definition).  The TPU keeps a 3-d form only
// because flattening [B, S, K] with S = 197 repacks sublanes there; on this
// card a contiguous [B, S, K] is [B*S, K], so both are one call over rows =
// B*S with no row padding (TMA fills the last tile's missing rows with
// zeros and the stores are masked).
//
// uml_add_ln_matmul replaces ::_add_ln_matmul_kernel: t = x + delta,
// out = act(LN_affine(t) . w + b), two outputs; the statistics are those
// of the unrounded fp32 sum.
//
// act: 0 none, 1 quick_gelu (CLIP), 2 exact GELU (erf; DINO).
//
// Each is two launches through ln_gemm.cuh's launch_ln_gemm: the LN
// pre-pass (ln_rows_kernel<PRO_LN_AFFINE | PRO_ADD_LN_AFFINE>, one warp a
// row) reads x (and delta) once and writes xn = bf16(LN_affine(x)) into
// the caller's scratch (and t), then wgmma_gemm_kernel (wgmma + TMA, two
// consumer warpgroups, a persistent grid) runs xn . w with the bias and the
// activation in its epilogue (OUT_BF16, OUT_GELU, OUT_GELU_EXACT).
//
// What bounds them on the H100: at ViT-B/16 B=64 the QKV product is 44.6
// GFLOP and the c_fc product 59.5 GFLOP over ~40-120 MB of operands, far
// above the ~295 FLOP/byte ridge: the tensor cores bound both.  The
// pre-pass moves 38 MB (76 MB with the add) once, so the products read an
// operand that is ready in bf16 instead of normalizing it again in every
// column block.

#include "ln_gemm.cuh"

// xn: [rows, K] bf16 scratch for the normalized rows
extern "C" int uml_ln_matmul(const void* x, const void* scale, const void* bias, const void* w,
                             const void* b, void* xn, void* out, int rows, int K, int M, int act,
                             float eps, void* stream) {
  const int epi = uml::act_epilogue(act);
  if (epi < 0) return (int)cudaErrorInvalidValue;
  uml::LnPrologue ops;
  ops.scale = static_cast<const float*>(scale);
  ops.bias = static_cast<const float*>(bias);
  ops.xn = static_cast<__nv_bfloat16*>(xn);
  return (int)uml::launch_ln_gemm(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), nullptr, out, rows, M, K, 0, uml::PRO_LN_AFFINE,
      epi, eps, static_cast<cudaStream_t>(stream), false, nullptr, nullptr, ops);
}

// xn: [rows, K] bf16 scratch; t: [rows, K] bf16, the output x + delta
extern "C" int uml_add_ln_matmul(const void* x, const void* delta, const void* scale,
                                 const void* bias, const void* w, const void* b, void* xn,
                                 void* t, void* out, int rows, int K, int M, int act, float eps,
                                 void* stream) {
  const int epi = uml::act_epilogue(act);
  if (epi < 0) return (int)cudaErrorInvalidValue;
  uml::LnPrologue ops;
  ops.delta = static_cast<const __nv_bfloat16*>(delta);
  ops.scale = static_cast<const float*>(scale);
  ops.bias = static_cast<const float*>(bias);
  ops.t_out = static_cast<__nv_bfloat16*>(t);
  ops.xn = static_cast<__nv_bfloat16*>(xn);
  return (int)uml::launch_ln_gemm(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), nullptr, out, rows, M, K, 0, uml::PRO_ADD_LN_AFFINE,
      epi, eps, static_cast<cudaStream_t>(stream), false, nullptr, nullptr, ops);
}
