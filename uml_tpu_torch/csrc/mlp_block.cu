// uml_mlp_block: the MLP half-block of a CLIP layer.
//
// Replaces uml_tpu/ops/ln_matmul.py::_mlp_block_kernel with quick_gelu:
// out = x + quick_gelu(rawLN(x) . w1_eff + b1) . w2 + b2, as two ln_gemm
// launches (LN prologue + quick_gelu epilogue, then the residual
// epilogue).  uml_mlp_block_stash replaces ::_mlp_block_kernel_stash, the
// training forward: its first ln_gemm also writes pre = rawLN(x) . w1 +
// b1 in bf16 (EPI_GELU_STASH), which the backward reads instead of
// recomputing that product.
//
// The TPU kernel keeps the [rows, 4K] hidden activation in VMEM; here it
// makes a round trip through device memory: at ViT-B/16 B=64 that is
// 12608 x 3072 bf16 = 77.5 MB written and read back, ~155 MB per layer
// (~46 us at 3.35 TB/s) beside the 119 GFLOP of the two matmuls (~0.12 ms
// at the bf16 peak).  Keeping the hidden on chip (a fused kernel looping
// over hidden chunks) is a later PR.

#include "blocks.cuh"

extern "C" int uml_mlp_block(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* hidden, void* out, int rows, int K, int M,
                             float eps, void* stream) {
  return (int)uml::run_mlp_block(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(hidden),
      static_cast<__nv_bfloat16*>(out), rows, K, M, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int uml_mlp_block_stash(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* pre, void* hidden,
                                   void* out, int rows, int K, int M, float eps, void* stream) {
  return (int)uml::run_mlp_block_stash(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(pre),
      static_cast<__nv_bfloat16*>(hidden), static_cast<__nv_bfloat16*>(out), rows, K, M, eps,
      static_cast<cudaStream_t>(stream));
}
