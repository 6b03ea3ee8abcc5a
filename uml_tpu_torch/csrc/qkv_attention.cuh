// qkv_attention: the attention half-block's QKV product and its attention
// in one launch per call, one (image, head) pair a work item, with q, k and
// v of the pair kept in shared memory (qkv_attention.cu; the design note
// is there).  blocks.cuh runs it for S <= QKV_ATTN_MAX_S and keeps the
// chain of the QKV product on the engine and flash_attention.cu above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uml {

// the key rows one block holds: q, k and v of a head, 256 x 64 bf16 each,
// take 96 KB of shared memory
constexpr int QKV_ATTN_MAX_S = 256;

// The route of the attention halves (blocks.cuh, and the Python wrappers,
// which allocate no qkv scratch on it): the fused kernel for S <= 256.
static inline bool qkv_attention_fused(int S) { return S <= QKV_ATTN_MAX_S; }

// attn = MHA(a . w + bias) for the first q_rows query rows (S, or 1: the
// CLS row), and with qkv non-null the stash qkv = bf16(a . w + bias) of
// every row.  bf16 (q8 false): a = xn [B*S, K] bf16 (the LN'd rows), w =
// w_eff [K, 3*H*64] bf16, row_scale and col_scale null.  int8 (q8 true):
// a = [B*S, K] int8 row-quantized, row_scale [B*S], w = [3*H*64, K] int8
// K-major, col_scale [3*H*64], the value ((float)acc * row_scale) *
// col_scale + bias rounded once to bf16, as q8_gemm.cuh's Q8_EPI_BF16.
// bias [3*H*64] fp32; attn [B, q_rows, H*64] bf16, or fp32 with attn_f32
// (the int8 half's out-projection quantizes the unrounded output, as the
// TPU kernel does); qkv [B, S, 3*H*64] bf16 or null.  Takes S <= 256, K a
// multiple of 64, pointers 16-byte aligned; returns the launch error.
// Defined in qkv_attention.cu.
cudaError_t launch_qkv_attention(const void* a, const float* row_scale, const void* w,
                                 const float* col_scale, const float* bias, __nv_bfloat16* qkv,
                                 void* attn, int B, int S, int K, int H, int q_rows, bool causal,
                                 bool q8, cudaStream_t stream, bool attn_f32 = false);

}  // namespace uml
