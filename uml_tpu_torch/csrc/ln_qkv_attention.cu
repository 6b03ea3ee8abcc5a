// uml_ln_qkv_attention: LN (affine) -> packed QKV -> multi-head attention,
// no out-projection: x [B, S, K] -> [B, S, H*64].
//
// Replaces uml_tpu/ops/fused_attention.py::_kernel (the body behind
// ln_qkv_attention), which applies the LN scale and bias in the kernel,
// rounds the qkv with its bias to the activation dtype and runs the
// per-head attention on it.  Three launches: the affine LN pre-pass into
// the xn scratch [B*S, K] and the QKV product on the wgmma engine into the
// packed qkv scratch [B*S, 3*H*64] (launch_ln_gemm's (PRO_LN_AFFINE,
// EPI_NONE) route, which ln_matmul takes too), then the attention over
// every query row, causal or not (flash_attention.cu through attention.cuh,
// reading the packed qkv in place: any S).
//
// What bounds it on the H100: the QKV product (44.6 GFLOP at ViT-B/16
// B=64) and the attention (7.6 GFLOP) against ~40 MB of operands: the
// tensor cores.  As in the chain of the attention halves above S = 256,
// xn and the qkv make a round trip through device memory (19 MB and 58 MB
// written and read back) that the TPU kernel keeps in VMEM.

#include "attention.cuh"
#include "ln_gemm.cuh"

extern "C" int uml_ln_qkv_attention(const void* x, const void* scale, const void* bias,
                                    const void* w, const void* b, void* xn, void* qkv, void* out,
                                    int B, int S, int K, int H, int causal, float eps,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uml::LnPrologue ops;
  ops.scale = static_cast<const float*>(scale);
  ops.bias = static_cast<const float*>(bias);
  ops.xn = static_cast<__nv_bfloat16*>(xn);
  const cudaError_t err = uml::launch_ln_gemm(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), nullptr, qkv, B * S, 3 * H * uml::ATT_D, K, 0,
      uml::PRO_LN_AFFINE, uml::EPI_NONE, eps, st, false, nullptr, nullptr, ops);
  if (err != cudaSuccess) return (int)err;
  return (int)uml::launch_attention(static_cast<const __nv_bfloat16*>(qkv),
                                    static_cast<__nv_bfloat16*>(out), B, S, H, S, causal != 0,
                                    st);
}
