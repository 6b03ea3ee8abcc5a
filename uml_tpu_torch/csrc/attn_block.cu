// uml_attn_block: the attention half-block of a CLIP layer.
//
// Replaces uml_tpu/ops/fused_attention.py::_block_kernel (q_rows = S,
// causal or not) and ::_block_cls_kernel (q_rows = 1: the last image
// layer keeps only its CLS row).  uml_attn_block_stash replaces
// ::_block_kernel_stash, the training forward: the same launches, with
// qkv and the attention output returned to the caller for the backward
// instead of discarded.  The port's qkv stash includes b_eff (the TPU's
// is bias-free and its backward re-adds the q-bias); the k-bias only
// shifts every score of a row by a constant, which the softmax cancels,
// so both give the same gradients.  Three launches: the LN-prologue QKV
// ln_gemm, the attention kernel, the out-projection ln_gemm with the
// residual add (ln_gemm.cuh, attention.cuh).
//
// Unlike the TPU kernel, which keeps qkv, the scores and the attention
// output in VMEM, this first version round-trips qkv and the attention
// output through device memory: at ViT-B/16 B=64 that is 58.1 MB of qkv
// written and read back and 19.4 MB of attention output, ~155 MB per
// layer (~46 us at 3.35 TB/s).  Keeping them on chip is the fused
// half-block kernel of a later PR.  With q_rows = 1 the QKV ln_gemm still
// projects q for every row (the TPU kernel projects its 8 CLS rows only):
// a third of that GEMM, ~0.2 ms of the CLS half's ~0.74 ms at B=64.

#include "blocks.cuh"

extern "C" int uml_attn_block(const void* x, const void* w_eff, const void* b_eff,
                              const void* wo, const void* bo, void* qkv, void* attn, void* out,
                              int B, int S, int K, int H, int causal, int q_rows, float eps,
                              void* stream) {
  return (int)uml::run_attn_block(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_eff),
      static_cast<const float*>(b_eff), static_cast<const __nv_bfloat16*>(wo),
      static_cast<const float*>(bo), static_cast<__nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(attn), static_cast<__nv_bfloat16*>(out), B, S, K, H,
      causal != 0, q_rows, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int uml_attn_block_stash(const void* x, const void* w_eff, const void* b_eff,
                                    const void* wo, const void* bo, void* qkv, void* attn,
                                    void* out, int B, int S, int K, int H, int causal,
                                    float eps, void* stream) {
  return (int)uml::run_attn_block(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_eff),
      static_cast<const float*>(b_eff), static_cast<const __nv_bfloat16*>(wo),
      static_cast<const float*>(bo), static_cast<__nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(attn), static_cast<__nv_bfloat16*>(out), B, S, K, H,
      causal != 0, S, eps, static_cast<cudaStream_t>(stream));
}
