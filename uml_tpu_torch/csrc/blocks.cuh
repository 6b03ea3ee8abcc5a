// Host-side compositions of the hand-written kernels into the CLIP
// half-blocks.  Each returns the first launch error (cudaGetLastError()
// after every launch) or cudaSuccess; nothing here synchronises or
// allocates: the Python wrappers pass every buffer in.

#pragma once

#include "attention.cuh"
#include "ln_gemm.cuh"

namespace uml {

#define UML_TRY(call)                        \
  do {                                       \
    const cudaError_t uml_err_ = (call);     \
    if (uml_err_ != cudaSuccess) return uml_err_; \
  } while (0)

// Attention half: out = x[:, :q_rows] + MHA(rawLN(x) . w_eff + b_eff) . wo + bo
//   x [B, S, K]; w_eff [K, 3*H*64]; wo [H*64, K]; qkv [B*S, 3*H*64] and
//   attn [B*q_rows, H*64] are scratch; out [B, q_rows, K].
//   q_rows is S (every query row) or 1 (the CLS row of the last image layer).
static inline cudaError_t run_attn_block(const __nv_bfloat16* x, const __nv_bfloat16* w_eff,
                                         const float* b_eff, const __nv_bfloat16* wo,
                                         const float* bo, __nv_bfloat16* qkv,
                                         __nv_bfloat16* attn, __nv_bfloat16* out, int B, int S,
                                         int K, int H, bool causal, int q_rows, float eps,
                                         cudaStream_t stream) {
  const int hd = H * ATT_D;
  UML_TRY(launch_ln_gemm(x, w_eff, b_eff, nullptr, qkv, B * S, 3 * hd, K, 0, true, EPI_NONE,
                         eps, stream));
  UML_TRY(launch_attention(qkv, attn, B, S, H, q_rows, causal, stream));
  // residual row i of image b is x[b, i]: stride K when every row is kept,
  // stride S*K when only row 0 is (q_rows == 1)
  const long long ldres = (q_rows == S) ? (long long)K : (long long)S * K;
  return launch_ln_gemm(attn, wo, bo, x, out, B * q_rows, K, hd, ldres, false, EPI_RESIDUAL,
                        eps, stream);
}

// MLP half: out = x + quick_gelu(rawLN(x) . w1 + b1) . w2 + b2
//   x [rows, K]; w1 [K, M]; w2 [M, K]; hidden [rows, M] is scratch.
static inline cudaError_t run_mlp_block(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                                        const float* b1, const __nv_bfloat16* w2,
                                        const float* b2, __nv_bfloat16* hidden,
                                        __nv_bfloat16* out, int rows, int K, int M, float eps,
                                        cudaStream_t stream) {
  UML_TRY(launch_ln_gemm(x, w1, b1, nullptr, hidden, rows, M, K, 0, true, EPI_QUICK_GELU, eps,
                         stream));
  return launch_ln_gemm(hidden, w2, b2, x, out, rows, K, M, K, false, EPI_RESIDUAL, eps,
                        stream);
}

// MLP half with the pre-activation stash (training forward):
//   out = x + quick_gelu(pre) . w2 + b2,  pre = rawLN(x) . w1 + b1 -> bf16
//   hidden [rows, M] is scratch; pre [rows, M] is kept for the backward.
static inline cudaError_t run_mlp_block_stash(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                                              const float* b1, const __nv_bfloat16* w2,
                                              const float* b2, __nv_bfloat16* pre,
                                              __nv_bfloat16* hidden, __nv_bfloat16* out,
                                              int rows, int K, int M, float eps,
                                              cudaStream_t stream) {
  UML_TRY(launch_ln_gemm(x, w1, b1, nullptr, hidden, rows, M, K, 0, true, EPI_GELU_STASH, eps,
                         stream, false, pre));
  return launch_ln_gemm(hidden, w2, b2, x, out, rows, K, M, K, false, EPI_RESIDUAL, eps,
                        stream);
}

}  // namespace uml
