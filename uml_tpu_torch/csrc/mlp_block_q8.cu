// uml_mlp_block_q8: the int8 (W8A8) MLP half-block of a CLIP or DINO layer.
//
// Replaces uml_tpu/ops/quant.py::_mlp_q8_kernel with quick_gelu (act 1,
// CLIP) or exact GELU (act 2, DINO):
// out = x + actquant(rawLN(x) row-quantized . int8 W1 + b1) . int8 W2 + b2.
// Launches (blocks.cuh::run_mlp_block_q8): ln_quantize_rows; the c_fc
// q8_gemm with the ROWMAX epilogue (each row's max of pre = y + b1, an
// atomicMax of each 128-column tile's); c_fc again with the ACTQ (or
// ACTQ_GELU) epilogue (pre recomputed bit for bit, the activation, the
// int8 hidden with the scale from the row's max: quick_gelu by a fast
// form exact near ties, exact GELU in the plain version's expression);
// the c_proj q8_gemm with the residual epilogue; all three products on
// wgmma s8 + TMA (the engine of wgmma_gemm.cuh through q8_gemm.cuh).  The
// TPU's slab chunking (UML_Q8_MLP_SLAB) is a VMEM choice and is not
// carried.
//
// What bounds it on the H100: at ViT-B/16 B=64 the two int8 products are
// 119.0 G ops, ~60.1 us at the 1,979 TOPS int8 peak (compute-bound), and
// c_fc's second run 59.5 G more (~30 us).  The TPU kernel keeps the fp32
// pre of a row slab in VMEM; here the row scale, which needs the whole
// row, would need pre ([12608, 3072] fp32, 155 MB) stored and read back,
// ~92 us at 3.35 TB/s.  Running the product twice costs less than that
// round trip, and the max of a row does not depend on its order, so the
// integers and scales equal those of the one-pass form.  Its bytes now:
// x read twice and out written (58 MB), the LN'd rows written and read
// twice (29 MB), the 39 MB int8 hidden written and read, the weights (4.7
// MB) read twice, 50 KB of row maxima.
//
//   x [rows, K] bf16; w1q [M, K] int8; w1sc, b1 [M] fp32; w2q [K, M] int8
//   (both K-major, q8_gemm.cuh); w2sc, b2 [K] fp32; q8 [rows*(M + K)] int8,
//   qscale [2*rows] fp32 and rowmax [rows] int32 scratch (q8 and qscale
//   begin with the int8 hidden and its row scales); out [rows, K] bf16;
//   act 1 or 2 (any other code is refused: no activation, uml_tpu's
//   identity, needs a row abs-max, which ROWMAX does not find).

#include "blocks.cuh"

extern "C" int uml_mlp_block_q8(const void* x, const void* w1q, const void* w1sc,
                                const void* b1, const void* w2q, const void* w2sc,
                                const void* b2, void* q8, void* qscale, void* rowmax, void* out,
                                int rows, int K, int M, int act, float eps, void* stream) {
  return (int)uml::run_mlp_block_q8(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(w1sc), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2q), static_cast<const float*>(w2sc),
      static_cast<const float*>(b2), static_cast<int8_t*>(q8), static_cast<float*>(qscale),
      static_cast<int*>(rowmax), static_cast<__nv_bfloat16*>(out), rows, K, M, eps, act,
      static_cast<cudaStream_t>(stream));
}
