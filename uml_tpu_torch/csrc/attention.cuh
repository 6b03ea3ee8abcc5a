// attention: the one attention core of every fused block, and the head
// dim the attention backward (attention_bwd.cuh) shares.
//
// The forward attention of the fused blocks is flash_attention.cu's wgmma
// + TMA kernel (K/V streamed through a 4-stage ring; for these blocks a
// walk over the K tiles for each row's max, then the softmax walk),
// declared here so that blocks.cuh and the C entries can launch it;
// the one library that _build.py links holds its definition.  It replaces
// the attention inside the TPU kernels of uml_tpu/ops/fused_attention.py
// (_pair_attention_split as called by _block_kernel, all query rows,
// causal or not, and by _block_cls_kernel, query row 0 only: the TPU's
// 8-row CLS_ROWS tile is a sublane artifact and is not copied), of
// text_tower.py::_tower_kernel, quant.py::_block_q8_kernel and
// tower_q8.py::_tower_q8_kernel, and of fused_attention.py::_kernel.  It
// takes any S: K/V are streamed, nothing of a head stays resident.
//
//   qkv [B, S, 3*H*64] bf16: q at column h*64, k at H*64 + h*64,
//                            v at 2*H*64 + h*64 (the packed flax layout)
//   out [B, q_rows, H*64] bf16 (or fp32): query rows 0 .. q_rows-1
//
// Numerics (flash_attention.cu with MAX_FIRST): fp32 scores, each row's
// max taken over all its keys first, then P rounded to bf16 unnormalized
// against it before P.V, the fp32 row sum, the 1/rowsum applied to the
// fp32 P.V, as the TPU kernel does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uml {

constexpr int ATT_D = 64;  // head dim (every CLIP / DINO tower)

// softmax(q k^T / sqrt(D)) v on [B, H, rows, D] bf16 views (strides in
// elements, multiples of 8; pointers 16-byte aligned): Sq query rows
// against S keys (Sq = S, or Sq < S non-causal: the first Sq queries),
// D 64 or 128; max_first (D = 64): each row's max over all its keys before
// the softmax walk, so P is rounded once against it; out bf16, or fp32
// with out_f32 (the int8 half quantizes the unrounded output).  Defined in
// flash_attention.cu; returns the launch error.
cudaError_t launch_flash_attention(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, void* out, long long B, int H, int Sq,
                                   int S, int D, bool causal, long long q_b, long long q_h,
                                   long long q_r, long long k_b, long long k_h, long long k_r,
                                   long long v_b, long long v_h, long long v_r, long long o_b,
                                   long long o_h, long long o_r, bool max_first,
                                   cudaStream_t stream, bool out_f32 = false);

// The attention of all B x H heads of a packed qkv, read in place, into
// out [B, q_rows, H*64] bf16, or fp32 with out_f32 (q_rows = S, or 1 for
// the CLS row).
static inline cudaError_t launch_attention(const __nv_bfloat16* qkv, void* out, int B, int S,
                                           int H, int q_rows, bool causal, cudaStream_t stream,
                                           bool out_f32 = false) {
  const long long hd = (long long)H * ATT_D;
  const long long row = 3 * hd, batch = (long long)S * row;
  return launch_flash_attention(qkv, qkv + hd, qkv + 2 * hd, out, B, H, q_rows, S, ATT_D, causal,
                                batch, ATT_D, row, batch, ATT_D, row, batch, ATT_D, row,
                                (long long)q_rows * hd, ATT_D, hd, true, stream, out_f32);
}

}  // namespace uml
