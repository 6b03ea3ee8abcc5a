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
// so both give the same gradients.
//
// Three launches for S <= 256 (blocks.cuh::run_attn_block): the LN row
// pre-pass into xn, qkv_attention.cu (the QKV product and the attention in
// one kernel, q, k and v of each (image, head) pair in shared memory), the
// out-projection with the residual add on the wgmma engine (ln_gemm.cuh's
// (PRO_NONE, EPI_RESIDUAL) triple; for the CLS block the residual rows are
// S*K apart).  The fused kernel replaces the chain's QKV product and
// flash_attention.cu, and with them the round trip of qkv through device
// memory (58.1 MB written and read back at ViT-B/16 B=64): the inference
// halves write no qkv and the wrappers allocate none; the stash writes it
// once.  The CLS block without a stash projects q for the first 64 rows
// only (the TPU kernel projects its 8 CLS rows).  The out-projection stays
// a launch of its own: it sums over all heads, which no (image, head)
// block owns.  Above S = 256 the halves keep the chain (the QKV product on
// the engine, then flash_attention.cu, any S).
//
// What bounds it on the H100: at ViT-B/16 B=64 the three products are 59.5
// GFLOP and the attention 7.6 (~68 us at 989 TFLOP/s); the bytes that must
// move (x in, out, the weights; xn, the attention output) are ~80 MB.

#include "blocks.cuh"

extern "C" int uml_attn_block(const void* x, const void* w_eff, const void* b_eff,
                              const void* wo, const void* bo, void* xn, void* qkv,
                              void* attn, void* out, int B, int S, int K, int H, int causal, int q_rows,
                              float eps, void* stream) {
  return (int)uml::run_attn_block(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_eff),
      static_cast<const float*>(b_eff), static_cast<const __nv_bfloat16*>(wo),
      static_cast<const float*>(bo), static_cast<__nv_bfloat16*>(xn),
      static_cast<__nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(attn), static_cast<__nv_bfloat16*>(out), B, S, K, H,
      causal != 0, q_rows, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int uml_attn_block_stash(const void* x, const void* w_eff, const void* b_eff,
                                    const void* wo, const void* bo, void* xn, void* qkv,
                                    void* attn, void* out, int B, int S, int K, int H,
                                    int causal, float eps, void* stream) {
  return (int)uml::run_attn_block(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_eff),
      static_cast<const float*>(b_eff), static_cast<const __nv_bfloat16*>(wo),
      static_cast<const float*>(bo), static_cast<__nv_bfloat16*>(xn),
      static_cast<__nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(attn), static_cast<__nv_bfloat16*>(out), B, S, K, H,
      causal != 0, S, eps, static_cast<cudaStream_t>(stream));
}
