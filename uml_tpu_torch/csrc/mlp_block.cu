// uml_mlp_block: the MLP half-block of a CLIP layer.
//
// Replaces uml_tpu/ops/ln_matmul.py::_mlp_block_kernel with quick_gelu:
// out = x + quick_gelu(rawLN(x) . w1_eff + b1) . w2 + b2, as three
// launches (blocks.cuh::run_mlp_block): the LN row pre-pass writing xn =
// bf16(rawLN(x)) once, the MLP in (xn . w1 + b1, quick_gelu) and the MLP
// out (hidden . w2 + b2 + x), both on the wgmma + TMA engine
// (wgmma_gemm.cuh: 128 x 128 tiles, a 3-stage TMA ring, persistent).
// uml_mlp_block_stash replaces ::_mlp_block_kernel_stash, the training
// forward: the same launches, whose MLP in also writes pre = rawLN(x) .
// w1 + b1 in bf16 (EPI_GELU_STASH), which the backward reads instead of
// recomputing that product; out is the same bits as uml_mlp_block's.
//
// What bounds it on the H100: the 119 GFLOP of the two products at
// ViT-B/16 B=64 (~0.12 ms at the bf16 peak).  The TPU kernel keeps the
// [rows, 4K] hidden activation in VMEM; here it makes a round trip
// through device memory: 12608 x 3072 bf16 = 77.5 MB written and read
// back (and the stash another 77.5 MB written), ~155-230 MB per layer
// (~46-70 us at 3.35 TB/s), stored in whole 32-byte sectors.  Keeping the
// hidden on chip (a fused kernel looping over hidden chunks) is K4.

#include "blocks.cuh"

extern "C" int uml_mlp_block(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* xn, void* hidden, void* out, int rows, int K,
                             int M, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::run_mlp_block(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(xn),
      static_cast<bf16*>(hidden), static_cast<bf16*>(out), rows, K, M, eps,
      static_cast<cudaStream_t>(stream));
}

extern "C" int uml_mlp_block_stash(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* pre, void* xn,
                                   void* hidden, void* out, int rows, int K, int M, float eps,
                                   void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::run_mlp_block(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(xn),
      static_cast<bf16*>(hidden), static_cast<bf16*>(out), rows, K, M, eps,
      static_cast<cudaStream_t>(stream), static_cast<bf16*>(pre));
}
