// uml_attn_block_q8: the int8 (W8A8) attention half-block of a CLIP layer.
//
// Replaces uml_tpu/ops/quant.py::_block_q8_kernel: x + MHA(rawLN(x)
// row-quantized . int8 W_eff -> bf16 qkv + b_eff) . wo + bo, causal or
// not, with the out-projection int8 (q8_out: the attention output
// row-quantized, the serving default) or bf16 (q8_out = 0, the int8_qkv
// mode).  Launches (blocks.cuh::run_attn_block_q8) for S <= 256:
// ln_quantize_rows, then qkv_attention.cu instantiated over int8 (the QKV
// product on wgmma s8 with q8_gemm.cuh's bf16 dequantization, so q, k and
// v equal the chain's qkv bit for bit, kept in shared memory, and the
// attention on them in the same kernel: no qkv in device memory), then
// quantize_rows + the out-projection q8_gemm with the residual epilogue,
// or the bf16 out-projection with the residual on the wgmma engine
// (ln_gemm.cuh).  The quantization of the attention output needs the
// whole row (every head), so it and the out-projection stay launches of
// their own.  Above S = 256: the QKV q8_gemm into a qkv scratch and
// flash_attention.cu.
//
// The quantized attention output is the attention's fp32 output, as the
// Pallas kernel quantizes it (quant.py:216-220; uml_tpu's jnp reference
// rounds it to bf16 first): near a row's absmax one bf16 ulp is about an
// int8 step, so two sides that each round to bf16 could land two steps
// apart.  The TPU's slab grouping (UML_Q8_SLAB: int8's 32-sublane tile) is a TPU
// padding choice and is not carried.
//
// What bounds it on the H100: at ViT-B/16 B=64 the two int8 products are
// 59.5 G ops (30 us at the 1,979 TOPS int8 peak) and the attention 7.63
// GFLOP bf16 (7.7 us at 989 TFLOP/s): ~37.8 us, compute-bound (its
// minimum traffic, x in and out plus the weights, is ~41 MB, 12 us).
//
//   x [B, S, K] bf16; wq [3*H*64, K] int8 (K-major, q8_gemm.cuh); wsc,
//   b_eff [3*H*64] fp32; wo [K, H*64] int8 (q8_out) or [H*64, K] bf16; wosc
//   [K] fp32 (q8_out) or null; bo [K] fp32; q8, qscale and attn scratch
//   (attn [B*S, H*64] fp32 with q8_out, bf16 without);
//   qkv scratch above S = 256, null at or below; out [B, S, K] bf16.

#include "blocks.cuh"

extern "C" int uml_attn_block_q8(const void* x, const void* wq, const void* wsc,
                                 const void* b_eff, const void* wo, const void* wosc,
                                 const void* bo, void* q8, void* qscale, void* qkv, void* attn,
                                 void* out, int B, int S, int K, int H, int causal, int q8_out,
                                 float eps, void* stream) {
  return (int)uml::run_attn_block_q8(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(wsc), static_cast<const float*>(b_eff), wo,
      static_cast<const float*>(wosc), static_cast<const float*>(bo), static_cast<int8_t*>(q8),
      static_cast<float*>(qscale), static_cast<__nv_bfloat16*>(qkv), attn,
      static_cast<__nv_bfloat16*>(out), B, S, K, H,
      causal != 0, q8_out != 0, eps, static_cast<cudaStream_t>(stream));
}
