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
// rows), so K and V are not recomputed.  After dattn = g . wo^T (the
// engine, B rows) it runs cls_bwd.cuh's three passes: the attention
// backward per (image, head), u, w and z per (columns, head), and dxn with
// the LN backward per row in the factorized rank-2H form, so no product
// over B S x 3 H 64 is left and no fp32 dxn reaches device memory.
//
// uml_attn_block_bwd_recompute replaces ::_block_bwd_kernel (via
// _block_bwd_call), the backward with no stash (UML_BWD_STASH=0, and every
// causal layer): it first recomputes xn, qkv and the attention output with
// the forward's own launches (run_qkv_attention: the LN row pre-pass, then
// qkv_attention.cu writing its qkv stash, or above S = 256 the QKV product
// on the wgmma engine and flash_attention.cu, on the same inputs, so all
// three equal the forward's bit for bit), then runs the
// stash backward above on them; its LN backward skips writing xn, which
// the pre-pass wrote (the same values: ln_gemm.cuh's ln_row_stats and one
// rounding).  The
// attention output goes out too, as the TPU kernel's fourth output: dwo =
// attn^T g reads it.  The TPU kernel keeps the recomputed qkv and scores
// in VMEM; here qkv (58 MB at ViT-B/16 B=64) and attn (19 MB) make a round
// trip through device memory, and the recompute adds the QKV product
// (44.6 GFLOP) and the attention forward to the stash backward's work.
//
// dW_eff = xn^T dqkv, dwo = attn^T g and the bias sums stay outside, as
// the TPU package leaves them to XLA dots (fused_attention.py:1586-1594).
//
// At ViT-B/16 B=64 the recompute's seven launches (eight above S = 256) read and write ~0.35 GB
// per layer (qkv and dqkv 58 MB each, dxn 39 MB in fp32, x, g, dx, xn,
// attn, dattn 19 MB each) beside ~150 GFLOP (the three projections 104,
// attention 7.6 forward and 19 backward).  Every product runs on the
// wgmma engine (wgmma_gemm.cuh through ln_gemm.cuh's triples) or, the QKV
// product, in qkv_attention.cu with the attention forward (flash_attention.cu
// above S = 256), the attention backward's dq
// and dkv passes on wgmma with TMA-fed operands (attention_bwd.cuh).
//
// uml_attn_bwd launches the attention backward's passes on their own, for
// the card tests and chip_smoke.py to hold and time each; no model calls
// it.

#include "attention_bwd.cuh"
#include "blocks.cuh"
#include "cls_bwd.cuh"

namespace uml {

// Attention half backward from the stash (every query row live):
//   g [B, S, K] -> dx [B, S, K], dqkv [B*S, 3*H*64], xn [B, S, K] (unless
//   write_xn is false: the caller's pre-pass wrote it); dattn [B*S, H*64]
//   bf16, stats [B*H*S] float4 and dxn [B*S, K] fp32 are scratch.
static inline cudaError_t run_attn_block_bwd(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                             const __nv_bfloat16* qkv,
                                             const __nv_bfloat16* w_eff,
                                             const __nv_bfloat16* wo, __nv_bfloat16* dattn,
                                             float4* stats, float* dxn, __nv_bfloat16* dqkv,
                                             __nv_bfloat16* dx, __nv_bfloat16* xn, int B, int S,
                                             int K, int H, bool causal, float eps,
                                             cudaStream_t stream, bool write_xn = true) {
  const int hd = H * ATT_D;
  const int rows = B * S;
  UML_TRY(launch_ln_gemm(g, wo, nullptr, nullptr, dattn, rows, hd, K, 0, PRO_NONE, EPI_NONE, eps,
                         stream, true));
  UML_TRY(launch_attn_bwd(qkv, dattn, stats, dqkv, B, S, H, causal, stream));
  UML_TRY(launch_ln_gemm(dqkv, w_eff, nullptr, nullptr, dxn, rows, K, 3 * hd, 0, PRO_NONE,
                         EPI_F32, eps, stream, true));
  return launch_ln_bwd(x, dxn, g, dx, write_xn ? xn : nullptr, rows, K, 1, eps, stream);
}

// Attention half backward with no stash: recompute xn [B*S, K], qkv
// [B*S, 3*H*64] and attn [B*S, H*64] (outputs) from x as the forward
// does, then as above.
static inline cudaError_t run_attn_block_bwd_recompute(
    const __nv_bfloat16* x, const __nv_bfloat16* g, const __nv_bfloat16* w_eff,
    const float* b_eff, const __nv_bfloat16* wo, __nv_bfloat16* qkv, __nv_bfloat16* attn,
    __nv_bfloat16* dattn, float4* stats, float* dxn, __nv_bfloat16* dqkv, __nv_bfloat16* dx,
    __nv_bfloat16* xn, int B, int S, int K, int H, bool causal, float eps, cudaStream_t stream) {
  UML_TRY(run_qkv_attention(x, w_eff, b_eff, xn, qkv, attn, B, S, K, H, causal, S, eps,
                            stream));
  return run_attn_block_bwd(x, g, qkv, w_eff, wo, dattn, stats, dxn, dqkv, dx, xn, B, S, K, H,
                            causal, eps, stream, false);
}

// CLS-only attention half backward: g [B, 1, K] (the CLS row of each
// image) -> dx [B, S, K], dqkv [B*S, 3*H*64], xn [B, S, K]; dattn [B,
// H*64] bf16, coef [B, S, 2H] and proj [B, 3, H, K] fp32 are scratch.
static inline cudaError_t run_attn_block_cls_bwd(const __nv_bfloat16* x,
                                                 const __nv_bfloat16* g,
                                                 const __nv_bfloat16* qkv,
                                                 const __nv_bfloat16* w_eff,
                                                 const __nv_bfloat16* wo, __nv_bfloat16* dattn,
                                                 float* coef, float* proj, __nv_bfloat16* dqkv,
                                                 __nv_bfloat16* dx, __nv_bfloat16* xn, int B,
                                                 int S, int K, int H, float eps,
                                                 cudaStream_t stream) {
  const int hd = H * ATT_D;
  UML_TRY(launch_ln_gemm(g, wo, nullptr, nullptr, dattn, B, hd, K, 0, PRO_NONE, EPI_NONE, eps,
                         stream, true));
  return launch_cls_bwd(x, g, qkv, dattn, w_eff, coef, proj, dqkv, dx, xn, B, S, K, H, eps,
                        stream);
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

extern "C" int uml_attn_block_bwd_recompute(const void* x, const void* g, const void* w_eff,
                                            const void* b_eff, const void* wo, void* qkv,
                                            void* attn, void* dattn, void* stats, void* dxn,
                                            void* dqkv, void* dx, void* xn, int B, int S, int K,
                                            int H, int causal, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::run_attn_block_bwd_recompute(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(w_eff),
      static_cast<const float*>(b_eff), static_cast<const bf16*>(wo), static_cast<bf16*>(qkv),
      static_cast<bf16*>(attn), static_cast<bf16*>(dattn), static_cast<float4*>(stats),
      static_cast<float*>(dxn), static_cast<bf16*>(dqkv), static_cast<bf16*>(dx),
      static_cast<bf16*>(xn), B, S, K, H, causal != 0, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int uml_attn_block_cls_bwd(const void* x, const void* g, const void* qkv,
                                      const void* w_eff, const void* wo, void* dattn, void* coef,
                                      void* proj, void* dqkv, void* dx, void* xn, int B, int S,
                                      int K, int H, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::run_attn_block_cls_bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(qkv),
      static_cast<const bf16*>(w_eff), static_cast<const bf16*>(wo), static_cast<bf16*>(dattn),
      static_cast<float*>(coef), static_cast<float*>(proj), static_cast<bf16*>(dqkv),
      static_cast<bf16*>(dx), static_cast<bf16*>(xn), B, S, K, H, eps,
      static_cast<cudaStream_t>(stream));
}

// passes: 1 the dq pass (dq into dqkv's q columns, stats [B*H*S] float4),
// 2 the dkv pass from stats (dk, dv into dqkv's k and v columns), 3 both
extern "C" int uml_attn_bwd(const void* qkv, const void* dattn, void* stats, void* dqkv, int B,
                            int S, int H, int causal, int passes, void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::launch_attn_bwd(static_cast<const bf16*>(qkv), static_cast<const bf16*>(dattn),
                                   static_cast<float4*>(stats), static_cast<bf16*>(dqkv), B, S, H,
                                   causal != 0, static_cast<cudaStream_t>(stream), passes);
}
