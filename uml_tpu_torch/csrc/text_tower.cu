// uml_text_tower: all L causal layers of the CLIP text tower.
//
// Replaces uml_tpu/ops/text_tower.py::_tower_kernel.  The TPU kernel runs
// every layer in one program with the residual stream resident in VMEM;
// this version is a host loop over the layers that launches the causal
// attention half (3 launches at S <= 256: the LN pre-pass, qkv_attention.cu
// with q, k and v in shared memory, the out-projection on the engine; the
// chain of the QKV product and flash_attention.cu above) and the MLP half
// (3 launches: the LN pre-pass into the same xn scratch, both products on
// the engine) of blocks.cuh per layer, 6 L launches in all.
// The residual stays bf16 between halves and between layers, exactly the
// rounding the TPU kernel applies (text_tower.py:104-109, 120-121).
//
// What bounds it on the H100: at the text tower's S = 77, K = 512 a layer
// is ~0.42 GFLOP per sentence; with the hidden and residual making
// device-memory round trips and 72 launches per call, small batches are
// launch-bound.  A persistent whole-tower kernel (residual on chip, the
// next layer's weights prefetched) is a later PR.
//
//   x [B, S, K]; stacked weights w_eff [L, K, 3K'], b_eff [L, 3K'],
//   wo [L, K', K], bo [L, K], w1 [L, K, M], b1 [L, M], w2 [L, M, K],
//   b2 [L, K] with K' = H*64; xn, attn, hidden, mid are scratch, and qkv
//   above S = 256 (null at or below);
//   out [B, S, K].

#include "blocks.cuh"

extern "C" int uml_text_tower(const void* x, const void* w_eff, const void* b_eff,
                              const void* wo, const void* bo, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* xn, void* qkv,
                              void* attn, void* hidden, void* mid, void* out, int B, int S,
                              int K, int H, int M, int L, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long hd = (long long)H * uml::ATT_D;
  const int rows = B * S;
  const bf16* cur = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  bf16* m = static_cast<bf16*>(mid);
  for (int l = 0; l < L; ++l) {
    const cudaError_t e1 = uml::run_attn_block(
        cur, static_cast<const bf16*>(w_eff) + l * K * 3 * hd,
        static_cast<const float*>(b_eff) + l * 3 * hd,
        static_cast<const bf16*>(wo) + l * hd * K, static_cast<const float*>(bo) + l * K,
        static_cast<bf16*>(xn), static_cast<bf16*>(qkv), static_cast<bf16*>(attn), m, B, S, K,
        H, true, S, eps, st);
    if (e1 != cudaSuccess) return (int)e1;
    const cudaError_t e2 = uml::run_mlp_block(
        m, static_cast<const bf16*>(w1) + (long long)l * K * M,
        static_cast<const float*>(b1) + (long long)l * M,
        static_cast<const bf16*>(w2) + (long long)l * M * K,
        static_cast<const float*>(b2) + (long long)l * K, static_cast<bf16*>(xn),
        static_cast<bf16*>(hidden), o, rows, K, M, eps, st);
    if (e2 != cudaSuccess) return (int)e2;
    cur = o;
  }
  return (int)cudaSuccess;
}
