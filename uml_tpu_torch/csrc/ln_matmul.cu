// uml_ln_matmul and uml_add_ln_matmul: the stand-alone LayerNorm -> matmul
// ops of the non-fused CLIP branch.
//
// uml_ln_matmul replaces uml_tpu/ops/ln_matmul.py::_ln_matmul_kernel (2-d
// x, rows padded to 256 there) and ::_ln_matmul_kernel_3d (x [B, S, K], G
// images per program): out = act(LN_affine(x) . w + b).  The TPU kernel
// takes the LN affine folded into w and b, a fold its wrapper makes on
// every call; here the affine is applied in the kernel's prologue, in fp32
// before the rounding to bf16, so nothing is folded (ln_matmul_reference,
// the unfolded form, is the op's definition).  The TPU keeps a 3-d form only
// because flattening [B, S, K] with S = 197 repacks sublanes there; on this
// card a contiguous [B, S, K] is [B*S, K], so both are one ln_gemm launch
// over rows = B*S with no row padding (the kernel masks the last tile).
//
// uml_add_ln_matmul replaces ::_add_ln_matmul_kernel: t = x + delta,
// out = act(LN_affine(t) . w + b), two outputs from one launch; the LN
// affine is applied in the kernel (not folded), the statistics are those
// of the unrounded fp32 sum.
//
// act: 0 none, 1 quick_gelu (CLIP), 2 exact GELU (erf; DINO).
//
// What bounds them on the H100: at ViT-B/16 B=64 the QKV product is 44.6
// GFLOP and the c_fc product 59.5 GFLOP over ~40-120 MB of operands, far
// above the ~295 FLOP/byte ridge: the tensor cores bound both.  The
// kernel is the wmma ln_gemm of ln_gemm.cuh (64x64 tiles, mma.sync), which
// re-reads x (and delta) once per column block; see that file.

#include "ln_gemm.cuh"

namespace {

int epilogue_of(int act) {
  return act == 1 ? uml::EPI_QUICK_GELU : act == 2 ? uml::EPI_GELU_EXACT : uml::EPI_NONE;
}

}  // namespace

extern "C" int uml_ln_matmul(const void* x, const void* scale, const void* bias, const void* w,
                             const void* b, void* out, int rows, int K, int M, int act,
                             float eps, void* stream) {
  if (act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  const uml::LnPrologue ops{nullptr, static_cast<const float*>(scale),
                            static_cast<const float*>(bias), nullptr};
  return (int)uml::launch_ln_gemm(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), nullptr, out, rows, M, K, 0, uml::PRO_LN_AFFINE,
      epilogue_of(act), eps, static_cast<cudaStream_t>(stream), false, nullptr, nullptr, ops);
}

extern "C" int uml_add_ln_matmul(const void* x, const void* delta, const void* scale,
                                 const void* bias, const void* w, const void* b, void* t,
                                 void* out, int rows, int K, int M, int act, float eps,
                                 void* stream) {
  if (act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  const uml::LnPrologue ops{static_cast<const __nv_bfloat16*>(delta),
                            static_cast<const float*>(scale), static_cast<const float*>(bias),
                            static_cast<__nv_bfloat16*>(t)};
  return (int)uml::launch_ln_gemm(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), nullptr, out, rows, M, K, 0, uml::PRO_ADD_LN_AFFINE,
      epilogue_of(act), eps, static_cast<cudaStream_t>(stream), false, nullptr, nullptr, ops);
}
