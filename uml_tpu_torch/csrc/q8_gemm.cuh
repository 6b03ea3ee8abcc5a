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
//   Q8_EPI_F32       out = y + b (fp32)             the MLP pre-activation,
//                                                    kept for act_quantize
//   Q8_EPI_RESIDUAL  out = bf16((res + y) + b)      x + delta + bo
// Every fp32 operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn), so nvcc does not contract them into FMAs and the epilogue
// rounds as the plain PyTorch version does.  The integer product of int8
// x int8 over K <= 4096 is exact in s32, so the output equals the plain
// version's (and torch._int_mm's integer sum) bit for bit.
//
// What bounds it on the H100: at ViT-B/16 B=64 the c_fc product is 12608
// x 768 x 3072 (59.5 G int8 ops) over 9.7 MB of A and 2.4 MB of W, far
// above the ridge, so the tensor cores bound it (30 us at the 1,979 TOPS
// int8 peak).  The product runs on the wgmma + TMA engine of
// wgmma_gemm.cuh, instantiated over int8: wgmma.m64n128k32.s32.s8.s8 from
// shared memory, 128 x 128 tiles with two consumer warpgroups, a producer
// warp with a 3-stage TMA ring of 128 of the contraction a stage (one
// 128-byte swizzled row), a persistent grid, and the epilogue above on the
// s32 accumulator registers (the fp32 layout, hopper.cuh).

#pragma once

#include "wgmma_gemm.cuh"

namespace uml {

enum { Q8_EPI_BF16 = 0, Q8_EPI_F32 = 1, Q8_EPI_RESIDUAL = 2 };

// Launch one q8_gemm on `stream`; returns the launch error.  N and K must
// be multiples of 64, the pointers 16-byte aligned (the Python wrappers
// check them and raise first).
static inline cudaError_t launch_q8_gemm(const int8_t* a, const int8_t* w, const float* row_scale,
                                         const float* col_scale, const float* bias,
                                         const __nv_bfloat16* res, void* out, int M, int N,
                                         int K, int epi, cudaStream_t stream) {
  WggEpilogue ep;
  ep.row_scale = row_scale;
  ep.col_scale = col_scale;
  ep.bias = bias;
  ep.out = out;
  if (epi == Q8_EPI_BF16)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_BF16>(a, w, ep, M, N, K, stream);
  if (epi == Q8_EPI_F32)
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_F32>(a, w, ep, M, N, K, stream);
  if (epi == Q8_EPI_RESIDUAL) {
    ep.res = res;
    ep.ldres = N;
    return launch_wgmma_gemm<false, false, WGG_OUT_Q8_RESIDUAL>(a, w, ep, M, N, K, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace uml
