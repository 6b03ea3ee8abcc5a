// uml_attn_block_bwd / uml_attn_block_cls_bwd: the backward of the
// attention half-block of a CLIP layer.
//
// uml_attn_block_bwd replaces uml_tpu/ops/fused_attention.py::
// _block_bwd_stash_kernel (via _block_bwd_stash_call): from the forward's
// qkv stash and the cotangent g it computes, as the TPU kernel does in
// its own body,
//   1. dattn = g . wo^T                        (ln_gemm, TRANS_B)
//   2. the per-head softmax backward -> dq, dk, dv   (attention_bwd.cuh)
//   3. dxn = dqkv . W_eff^T, kept in fp32      (ln_gemm, TRANS_B, EPI_F32)
//   4. the LN backward + the residual g -> dx, and xn  (ln_bwd)
// uml_attn_block_cls_bwd replaces ::_block_bwd_cls_kernel (via
// _block_bwd_cls_call), the backward of the CLS-only last image layer,
// whose cotangent has one live row per image: [B, 1, K] here (the TPU's
// [B, 8, K] is sublane padding).  It reads the qkv the CLS forward
// computed for every row (attn_block.cu projects q, k and v of all S
// rows), so K and V are not recomputed; dq is nonzero in row 0 only and
// g enters dx in row 0 only.
//
// dW_eff = xn^T dqkv, dwo = attn^T g and the bias sums stay outside, as
// the TPU package leaves them to XLA dots (fused_attention.py:1586-1594).
//
// At ViT-B/16 B=64 the four launches read and write ~0.2 GB per layer
// (qkv and dqkv 58 MB each, dxn 39 MB in fp32, x, g, dx, xn 19 MB each)
// beside ~110 GFLOP (the two projections 89, attention 21): the
// projections run on ln_gemm's wmma tiles and bound the time.

#include "attention_bwd.cuh"
#include "blocks.cuh"

namespace uml {

// Attention half backward from the stash (every query row live):
//   g [B, S, K] -> dx [B, S, K], dqkv [B*S, 3*H*64], xn [B, S, K];
//   dattn [B*S, H*64] bf16, stats [B*H*S] float4 and dxn [B*S, K] fp32
//   are scratch.
static inline cudaError_t run_attn_block_bwd(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                             const __nv_bfloat16* qkv,
                                             const __nv_bfloat16* w_eff,
                                             const __nv_bfloat16* wo, __nv_bfloat16* dattn,
                                             float4* stats, float* dxn, __nv_bfloat16* dqkv,
                                             __nv_bfloat16* dx, __nv_bfloat16* xn, int B, int S,
                                             int K, int H, bool causal, float eps,
                                             cudaStream_t stream) {
  const int hd = H * ATT_D;
  const int rows = B * S;
  UML_TRY(launch_ln_gemm(g, wo, nullptr, nullptr, dattn, rows, hd, K, 0, false, EPI_NONE, eps,
                         stream, true));
  UML_TRY(launch_attn_bwd(qkv, dattn, stats, dqkv, B, S, H, causal, stream));
  UML_TRY(launch_ln_gemm(dqkv, w_eff, nullptr, nullptr, dxn, rows, K, 3 * hd, 0, false,
                         EPI_F32, eps, stream, true));
  return launch_ln_bwd(x, dxn, g, dx, xn, rows, K, 1, eps, stream);
}

// CLS-only attention half backward: g [B, 1, K] (the CLS row of each
// image) -> dx [B, S, K], dqkv [B*S, 3*H*64], xn [B, S, K];
//   dattn [B, H*64] bf16 and dxn [B*S, K] fp32 are scratch.
static inline cudaError_t run_attn_block_cls_bwd(const __nv_bfloat16* x,
                                                 const __nv_bfloat16* g,
                                                 const __nv_bfloat16* qkv,
                                                 const __nv_bfloat16* w_eff,
                                                 const __nv_bfloat16* wo, __nv_bfloat16* dattn,
                                                 float* dxn, __nv_bfloat16* dqkv,
                                                 __nv_bfloat16* dx, __nv_bfloat16* xn, int B,
                                                 int S, int K, int H, float eps,
                                                 cudaStream_t stream) {
  const int hd = H * ATT_D;
  UML_TRY(launch_ln_gemm(g, wo, nullptr, nullptr, dattn, B, hd, K, 0, false, EPI_NONE, eps,
                         stream, true));
  UML_TRY(launch_cls_bwd(qkv, dattn, dqkv, B, S, H, stream));
  UML_TRY(launch_ln_gemm(dqkv, w_eff, nullptr, nullptr, dxn, B * S, K, 3 * hd, 0, false,
                         EPI_F32, eps, stream, true));
  return launch_ln_bwd(x, dxn, g, dx, xn, B * S, K, S, eps, stream);
}

}  // namespace uml

extern "C" int uml_attn_block_bwd(const void* x, const void* g, const void* qkv,
                                  const void* w_eff, const void* wo, void* dattn, void* stats,
                                  void* dxn, void* dqkv, void* dx, void* xn, int B, int S, int K,
                                  int H, int causal, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::run_attn_block_bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(qkv),
      static_cast<const bf16*>(w_eff), static_cast<const bf16*>(wo), static_cast<bf16*>(dattn),
      static_cast<float4*>(stats), static_cast<float*>(dxn), static_cast<bf16*>(dqkv),
      static_cast<bf16*>(dx), static_cast<bf16*>(xn), B, S, K, H, causal != 0, eps,
      static_cast<cudaStream_t>(stream));
}

extern "C" int uml_attn_block_cls_bwd(const void* x, const void* g, const void* qkv,
                                      const void* w_eff, const void* wo, void* dattn, void* dxn,
                                      void* dqkv, void* dx, void* xn, int B, int S, int K, int H,
                                      float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::run_attn_block_cls_bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(qkv),
      static_cast<const bf16*>(w_eff), static_cast<const bf16*>(wo), static_cast<bf16*>(dattn),
      static_cast<float*>(dxn), static_cast<bf16*>(dqkv), static_cast<bf16*>(dx),
      static_cast<bf16*>(xn), B, S, K, H, eps, static_cast<cudaStream_t>(stream));
}
