// q8_gemm: out = epi(((float)(A . W^T) * row_scale) * col_scale + b), int8
// operands, exact s32 accumulation on the tensor cores.
//
// The projection products of the int8 serving kernels: the QKV, out-
// projection, c_fc and c_proj dots (_q8_dot) of
// uml_tpu/ops/quant.py::_block_q8_kernel and ::_mlp_q8_kernel, and of
// uml_tpu/ops/tower_q8.py::_tower_q8_kernel.
//
//   A   [M, K] int8, row-major, contiguous (the row-quantized activations)
//   W   [N, K] int8, row-major: K-major, the transpose of the JAX / flax
//       [in, out] kernel (wgmma reads 8-bit operands K-major only, and TMA
//       does not transpose; the model quantizes and caches it once so)
//   row_scale [M] fp32, col_scale [N] fp32, b [N] fp32
//   res [M, N] bf16, contiguous (Q8_EPI_RESIDUAL only)
//   out [M, N] bf16 (fp32 for Q8_EPI_F32)
//
// Epilogue, in the reference's order (quant.py:158, 406, 426): y =
// ((float)acc * row_scale[m]) * col_scale[n], then
//   Q8_EPI_BF16      out = bf16(y + b)              the qkv
//   Q8_EPI_F32       out = y + b (fp32)             the product alone
//   Q8_EPI_RESIDUAL  out = bf16((res + y) + b)      x + delta + bo
//   Q8_EPI_ROWMAX    rowmax[m] = max(rowmax[m], max of y + b over row m),
//                    [M] ints in q8_ordered form (each 128-column tile an
//                    atomicMax; the caller sets Q8_ORDERED_NEG_INF first);
//                    no out
//   Q8_EPI_ACTQ      out = int8 of quick_gelu(y + b) per row, the scale
//                    max(quick_gelu(rowmax[m]), 0.1654) / 127, rounded
//                    floor(v / scale + 0.5) and clamped to +-127;
//                    qscale[m] = that scale (int8 out [M, N], fp32 [M])
//   Q8_EPI_ACTQ_GELU the same with exact GELU (erf) and its lobe, 0.1718
//                    (DINO's MLP)
//   Q8_EPI_ROWABSMAX rowmax[m] = max(rowmax[m], max of |y + b| over row m):
//                    no activation (uml_tpu's identity, _quantize_rows);
//                    each thread's first value 0, so any initial value of
//                    -inf or 0 gives the same result
//   Q8_EPI_QUANT     out = int8 of y + b per row, the scale
//                    max(rowmax[m], 1e-12) / 127 from ROWABSMAX's abs-max,
//                    rounded floor(v / scale + 0.5) and clamped to +-127;
//                    qscale[m] = that scale
// Every fp32 operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn), so nvcc does not contract them into FMAs and the epilogue
// rounds as the plain PyTorch version does.  The integer product of int8
// x int8 over K <= 4096 is exact in s32, so the output equals the plain
// version's (and torch._int_mm's integer sum) bit for bit.
//
// The int8 MLP in (blocks.cuh::run_mlp_block_q8) runs c_fc twice, ROWMAX
// then ACTQ (ROWABSMAX then QUANT without an activation).  The row's int8 scale needs the max of y + b over all M =
// 3,072 columns, which 24 column tiles hold; one pass that stored the fp32
// pre-activation for a row pass to quantize moved 2 x 155 MB at ViT-B/16
// B=64 (~92 us at 3.35 TB/s, more than the ~30 us the product's 59.5 G
// int8 ops take at 1,979 TOPS).  The s32 sum is exact and a max does not
// depend on its order, so the second product recomputes the same y + b
// bit for bit and quantizes it with the row's scale from the first pass's
// maxima: the integers and scales equal the one-pass form's, and only the
// 39 MB int8 hidden is stored.  The first pass keeps one int a row
// (atomicMax of each tile's max; ln_quantize_rows, which owns each row
// before it, writes the first value), not a partial per (row, column
// tile): the second pass then reads one value a row, loaded before its
// products and used after them, where 24 partials a row would be an L2
// round trip ahead of every tile's products.
//
// What bounds it on the H100: at ViT-B/16 B=64 the c_fc product is 12608
// x 768 x 3072 (59.5 G int8 ops) over 9.7 MB of A and 2.4 MB of W, far
// above the ridge, so the tensor cores bound it (30 us at the 1,979 TOPS
// int8 peak); ACTQ's epilogue adds CUDA-core work of the same order
// (quick_gelu and the rounding of 38.7 M values: act_q8's fast form, with
// the plain version's exact expression only near a rounding tie), which
// runs after each tile's products, not under them.  The product runs on
// the wgmma + TMA engine of
// wgmma_gemm.cuh, instantiated over int8: wgmma.m64n128k32.s32.s8.s8 from
// shared memory, 128 x 128 tiles with two consumer warpgroups, a producer
// warp with a 3-stage TMA ring of 128 of the contraction a stage (one
// 128-byte swizzled row), a persistent grid, and the epilogue above on the
// s32 accumulator registers (the fp32 layout, hopper.cuh).

#pragma once

#include "wgmma_gemm.cuh"

namespace uml {

enum { Q8_EPI_BF16 = 0, Q8_EPI_F32 = 1, Q8_EPI_RESIDUAL = 2, Q8_EPI_ROWMAX = 3,
       Q8_EPI_ACTQ = 4, Q8_EPI_ACTQ_GELU = 5, Q8_EPI_ROWABSMAX = 6, Q8_EPI_QUANT = 7 };

// Launch one q8_gemm on `stream`; returns the launch error.  N and K must
// be multiples of 64, the pointers 16-byte aligned (the Python wrappers
// check them and raise first).  rowmax [M] (q8_ordered ints):
// Q8_EPI_ROW(ABS)MAX raise it, Q8_EPI_ACTQ* and Q8_EPI_QUANT read it;
// qscale: Q8_EPI_ACTQ* and Q8_EPI_QUANT write it.
static inline cudaError_t launch_q8_gemm(const int8_t* a, const int8_t* w, const float* row_scale,
                                         const float* col_scale, const float* bias,
                                         const __nv_bfloat16* res, void* out, int M, int N,
                                         int K, int epi, cudaStream_t stream,
                                         int* rowmax = nullptr, float* qscale = nullptr) {
  WggEpilogue ep;
  ep.row_scale = row_scale;
  ep.col_scale = col_scale;
  ep.bias = bias;
  ep.out = out;
  ep.rowmax = rowmax;
  ep.qscale = qscale;
  if (epi == Q8_EPI_BF16)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_BF16>(a, w, ep, M, N, K, stream);
  if (epi == Q8_EPI_F32)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_F32>(a, w, ep, M, N, K, stream);
  if (epi == Q8_EPI_RESIDUAL) {
    ep.res = res;
    ep.ldres = N;
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_RESIDUAL>(a, w, ep, M, N, K, stream);
  }
  if (epi == Q8_EPI_ROWMAX)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_ROWMAX>(a, w, ep, M, N, K, stream);
  if (epi == Q8_EPI_ACTQ)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_ACTQ>(a, w, ep, M, N, K, stream);
  if (epi == Q8_EPI_ACTQ_GELU)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_ACTQ_GELU>(a, w, ep, M, N, K, stream);
  if (epi == Q8_EPI_ROWABSMAX)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_ROWABSMAX>(a, w, ep, M, N, K, stream);
  if (epi == Q8_EPI_QUANT)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_QUANT>(a, w, ep, M, N, K, stream);
  return cudaErrorInvalidValue;
}

}  // namespace uml
