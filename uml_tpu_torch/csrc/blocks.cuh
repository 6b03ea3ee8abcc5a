// Host-side compositions of the hand-written kernels into the CLIP and
// DINO half-blocks.  Each returns the first launch error (UML_TRY, in
// ln_gemm.cuh: cudaGetLastError() after every launch) or cudaSuccess;
// nothing here synchronises or allocates: the Python wrappers pass every
// buffer in.
//
// The attention halves, bf16 and int8, run three launches for S <= 256
// (qkv_attention.cuh's route, which the Python wrappers mirror to allocate
// no qkv scratch on it): the LN row pre-pass (ln_rows_kernel, or
// ln_quantize_rows in int8), then qkv_attention.cu (the QKV product and
// the attention in one kernel per call, q, k and v of each (image, head)
// pair in shared memory, no qkv in device memory unless a caller stashes
// it), then the out-projection with the residual on the wgmma engine (in
// int8 after quantize_rows of the attention output): the out-projection
// sums over every head, which no (image, head) block of the fused kernel
// owns.  Above S = 256 (q, k and v of one head no longer fit a block's
// shared memory beside the ring) they keep the chain of hand-written
// kernels: the QKV product on the engine into a qkv scratch, then
// flash_attention.cu reading it back (K/V streamed: any S).

#pragma once

#include "attention.cuh"
#include "ln_gemm.cuh"
#include "q8_gemm.cuh"
#include "qkv_attention.cuh"
#include "quantize.cuh"

namespace uml {

// Attention half: out = x[:, :q_rows] + MHA(rawLN(x) . w_eff + b_eff) . wo + bo
//   x [B, S, K]; w_eff [K, 3*H*64]; wo [H*64, K]; xn [B*S, K] and attn
//   [B*q_rows, H*64] are scratch; qkv [B*S, 3*H*64] is the stash (written
//   where non-null) on the fused route and scratch on the chain (S > 256,
//   where it must be given); out [B, q_rows, K].  q_rows is S (every query
//   row) or 1 (the CLS row of the last image layer).
// The first launches of the attention half: xn = bf16(rawLN(x)) (the row
// pre-pass), then q, k, v = xn . w_eff + b_eff and attn = MHA(q, k, v) for
// the first q_rows query rows, fused (S <= 256) or as the chain.  The
// recompute backward (attn_block_bwd.cu) runs exactly these launches on
// the forward's inputs, so its xn, qkv and attn equal the forward's bit
// for bit.
static inline cudaError_t run_qkv_attention(const __nv_bfloat16* x, const __nv_bfloat16* w_eff,
                                            const float* b_eff, __nv_bfloat16* xn,
                                            __nv_bfloat16* qkv, __nv_bfloat16* attn, int B,
                                            int S, int K, int H, bool causal, int q_rows,
                                            float eps, cudaStream_t stream) {
  if (qkv_attention_fused(S)) {
    UML_TRY(launch_ln_rows(x, xn, B * S, K, eps, stream));
    return launch_qkv_attention(xn, nullptr, w_eff, nullptr, b_eff, qkv, attn, B, S, K, H,
                                q_rows, causal, false, stream);
  }
  if (qkv == nullptr) return cudaErrorInvalidValue;
  LnPrologue ops;
  ops.xn = xn;
  UML_TRY(launch_ln_gemm(x, w_eff, b_eff, nullptr, qkv, B * S, 3 * H * ATT_D, K, 0, PRO_LN,
                         EPI_NONE, eps, stream, false, nullptr, nullptr, ops));
  return launch_attention(qkv, attn, B, S, H, q_rows, causal, stream);
}

static inline cudaError_t run_attn_block(const __nv_bfloat16* x, const __nv_bfloat16* w_eff,
                                         const float* b_eff, const __nv_bfloat16* wo,
                                         const float* bo, __nv_bfloat16* xn,
                                         __nv_bfloat16* qkv, __nv_bfloat16* attn,
                                         __nv_bfloat16* out, int B, int S, int K, int H,
                                         bool causal, int q_rows, float eps,
                                         cudaStream_t stream) {
  const int hd = H * ATT_D;
  UML_TRY(run_qkv_attention(x, w_eff, b_eff, xn, qkv, attn, B, S, K, H, causal, q_rows, eps,
                            stream));
  // residual row i of image b is x[b, i]: stride K when every row is kept,
  // stride S*K when only row 0 is (q_rows == 1)
  const long long ldres = (q_rows == S) ? (long long)K : (long long)S * K;
  return launch_ln_gemm(attn, wo, bo, x, out, B * q_rows, K, hd, ldres, PRO_NONE, EPI_RESIDUAL,
                        eps, stream);
}

// MLP half: out = x + act(rawLN(x) . w1 + b1) . w2 + b2, act one of
// ACT_NONE, ACT_QUICK_GELU (CLIP) and ACT_GELU_EXACT (DINO), and with pre
// non-null (either GELU; ACT_NONE has no stash) the pre-activation stash
// of the training forward, pre = bf16(rawLN(x) . w1 + b1), which the
// backward reads (the activation is taken of the unrounded pre).  Three
// launches, the same with the stash and without: the LN row pre-pass into
// xn, the MLP in (the activation in its epilogue) and the MLP out on the
// wgmma engine.
//   x [rows, K]; w1 [K, M]; w2 [M, K]; xn [rows, K] and hidden [rows, M]
//   are scratch; pre [rows, M] or null.
static inline cudaError_t run_mlp_block(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                                        const float* b1, const __nv_bfloat16* w2,
                                        const float* b2, __nv_bfloat16* xn,
                                        __nv_bfloat16* hidden, __nv_bfloat16* out, int rows,
                                        int K, int M, float eps, int act, cudaStream_t stream,
                                        __nv_bfloat16* pre = nullptr) {
  const int epi = pre != nullptr ? act_stash_epilogue(act) : act_epilogue(act);
  if (epi < 0) return cudaErrorInvalidValue;
  LnPrologue ops;
  ops.xn = xn;
  UML_TRY(launch_ln_gemm(x, w1, b1, nullptr, hidden, rows, M, K, 0, PRO_LN, epi, eps, stream,
                         false, pre, nullptr, ops));
  return launch_ln_gemm(hidden, w2, b2, x, out, rows, K, M, K, PRO_NONE, EPI_RESIDUAL, eps,
                        stream);
}

// Int8 attention half: out = x + MHA(LNquant(x) . wq -> bf16 qkv + b_eff)
// . wo + bo, wo int8 (q8_out: the attention output row-quantized, wosc its
// column scales) or bf16 (q8_out false: ln_gemm, wosc unused).
//   x [B, S, K]; wq [3*H*64, K] int8, wo [K, H*64] int8 or [H*64, K] bf16
//   (the int8 weights K-major, q8_gemm.cuh); q8 [B*S*max(K, H*64)] int8 and
//   qscale [B*S] are scratch for the row-quantized activations (the LN'd x,
//   then the attention output); attn [B*S, H*64] is scratch, fp32 with
//   q8_out (the attention output is quantized before any rounding, as the
//   TPU kernel quantizes it: a bf16 rounding there gives two sides that
//   round the same value apart an int8 step each), bf16 without; qkv
//   [B*S, 3*H*64] is scratch on the chain (S > 256; null on the fused
//   route); out [B, S, K].
static inline cudaError_t run_attn_block_q8(const __nv_bfloat16* x, const int8_t* wq,
                                            const float* wsc, const float* b_eff, const void* wo,
                                            const float* wosc, const float* bo, int8_t* q8,
                                            float* qscale, __nv_bfloat16* qkv, void* attn,
                                            __nv_bfloat16* out, int B, int S, int K, int H,
                                            bool causal, bool q8_out, float eps,
                                            cudaStream_t stream) {
  const int rows = B * S;
  const int hd = H * ATT_D;
  UML_TRY(launch_ln_quantize_rows(x, q8, qscale, rows, K, eps, stream));
  if (qkv_attention_fused(S)) {
    UML_TRY(launch_qkv_attention(q8, qscale, wq, wsc, b_eff, nullptr, attn, B, S, K, H, S,
                                 causal, true, stream, q8_out));
  } else {
    if (qkv == nullptr) return cudaErrorInvalidValue;
    UML_TRY(launch_q8_gemm(q8, wq, qscale, wsc, b_eff, nullptr, qkv, rows, 3 * hd, K,
                           Q8_EPI_BF16, stream));
    UML_TRY(launch_attention(qkv, attn, B, S, H, S, causal, stream, q8_out));
  }
  if (q8_out) {
    UML_TRY(launch_quantize_rows(static_cast<const float*>(attn), q8, qscale, rows, hd, stream));
    return launch_q8_gemm(q8, static_cast<const int8_t*>(wo), qscale, wosc, bo, x, out, rows, K,
                          hd, Q8_EPI_RESIDUAL, stream);
  }
  return launch_ln_gemm(static_cast<const __nv_bfloat16*>(attn),
                        static_cast<const __nv_bfloat16*>(wo), bo, x, out, rows, K, hd, K,
                        PRO_NONE, EPI_RESIDUAL, eps, stream);
}

// Int8 MLP half: out = x + actquant(LNquant(x) . w1q + b1) . w2q + b2,
// the activation ACT_QUICK_GELU (CLIP) or ACT_GELU_EXACT (DINO)
//   x [rows, K]; w1q [M, K], w2q [K, M] int8 (K-major); q8 [rows*(M + K)]
//   int8 and qscale [2*rows] fp32 are scratch: first the int8 hidden and its
//   row scales ([rows, M], [rows]: c_proj's operand), then LNquant(x) and
//   its ([rows, K], [rows]: c_fc's); rowmax [rows] int32 is scratch for
//   c_fc's row maxima (q8_ordered).
// Four launches: ln_quantize_rows (which also sets each row's max to
// -inf); c_fc with the ROWMAX epilogue (each row's max of y + b1, an
// atomicMax a 128-column tile, its only store: 50 KB at ViT-B/16 B=64);
// c_fc again with the ACTQ (quick_gelu) or ACTQ_GELU (exact GELU)
// epilogue (the same y + b1 bit for bit, the activation, int8 with the
// row's scale from that max, as the one-pass act quantization rounded
// them); c_proj with the residual.  No fp32
// pre-activation reaches device memory (q8_gemm.cuh says why the product
// runs twice).
static inline cudaError_t run_mlp_block_q8(const __nv_bfloat16* x, const int8_t* w1q,
                                           const float* w1sc, const float* b1,
                                           const int8_t* w2q, const float* w2sc,
                                           const float* b2, int8_t* q8, float* qscale,
                                           int* rowmax, __nv_bfloat16* out, int rows, int K,
                                           int M, float eps, int act, cudaStream_t stream) {
  if (act != ACT_QUICK_GELU && act != ACT_GELU_EXACT) return cudaErrorInvalidValue;
  int8_t* hq = q8;
  float* hs = qscale;
  int8_t* xq = q8 + (long long)rows * M;
  float* xs = qscale + rows;
  UML_TRY(launch_ln_quantize_rows(x, xq, xs, rows, K, eps, stream, rowmax));
  UML_TRY(launch_q8_gemm(xq, w1q, xs, w1sc, b1, nullptr, nullptr, rows, M, K, Q8_EPI_ROWMAX,
                         stream, rowmax));
  UML_TRY(launch_q8_gemm(xq, w1q, xs, w1sc, b1, nullptr, hq, rows, M, K,
                         act == ACT_GELU_EXACT ? Q8_EPI_ACTQ_GELU : Q8_EPI_ACTQ, stream, rowmax,
                         hs));
  return launch_q8_gemm(hq, w2q, hs, w2sc, b2, x, out, rows, K, M, Q8_EPI_RESIDUAL, stream);
}

}  // namespace uml
