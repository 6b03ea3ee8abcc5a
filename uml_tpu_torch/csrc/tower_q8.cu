// uml_tower_q8: every full int8 (W8A8) layer of a tower in one call.
//
// Replaces uml_tpu/ops/tower_q8.py::_tower_q8_kernel.  The TPU kernel runs
// all L layers in one program (grid: batch groups x layers) with the
// residual stream resident in VMEM and the next layer's int8 weights
// streamed under the current layer's compute.  Here a host loop over the
// layers makes, per layer, the launches of uml_attn_block_q8 (non-causal,
// int8 out-projection) and uml_mlp_block_q8, 9 per layer at S <= 256:
// ln_quantize_rows, the int8 qkv_attention.cu, quantize_rows, the
// out-projection; ln_quantize_rows, c_fc ROWMAX, c_fc ACTQ, c_proj.  The
// same kernels on the same inputs, so its output equals the per-layer
// int8 path bit for bit.  The residual is bf16 between halves and between
// layers, the rounding the TPU kernel applies (tower_q8.py:83-86).  The
// TPU's batch grouping (UML_TOWER_Q8_G) is a VMEM choice and is not
// carried.
//
// What bounds it on the H100: 11 ViT-B/16 layers at B=64 are 1,963 G int8
// ops and 84 GFLOP bf16 attention, ~1.08 ms at the int8 and bf16 peaks
// (~98 us a layer).  A layer moves ~350 MB through device memory (~105 us
// at 3.35 TB/s), so bytes and operations now bound it about equally: the
// attention half 177 MB (x read twice and written once, 58 MB; the fp32
// attention output written and read, 77 MB; the int8 rows, 39 MB), the
// MLP half 174 MB (x read twice and written, 58 MB; the int8 hidden
// written and read, 77 MB; the LN'd rows read twice and written, 29 MB;
// the weights and 50 KB of row maxima).  An MLP in that stored its fp32
// pre-activation for a row pass to quantize would move 310 MB more, ~600
// MB a layer; c_fc runs twice instead (q8_gemm.cuh), once for each row's
// max and once to quantize, and stores only the int8 hidden.
//
// Why not one persistent kernel that walks work items (the text tower's
// design, text_tower.cu): what such a walk removes here is the launch
// boundaries and the residual's round trips (19.4 MB a half, which fit
// the 50 MB L2), while its one block per SM leaves each item's epilogue
// and hand-off unhidden; the text tower at B = 64 ran slower as a walk
// (1.89 ms) than as a chain (1.53).  Next in bytes are the int8 hidden
// (a c_fc -> c_proj kernel that keeps it on chip) and the fp32 attention
// output (quantized in its neighbours' epilogues).
//
//   x [B, S, K]; stacked, the int8 weights K-major (q8_gemm.cuh): wq
//   [L, 3HD, K], wsc, b_eff [L, 3HD], woq [L, K, HD], wosc, bo [L, K], w1q
//   [L, M, K], w1sc, b1 [L, M], w2q [L, K, M], w2sc, b2 [L, K] with HD =
//   H*64; q8 [B*S*(M + max(K, HD))] int8, qscale [2*B*S] fp32, attn [B*S,
//   HD] fp32, rowmax [B*S] int32 and mid [B, S, K] are
//   scratch, and qkv above S = 256 (null at or below); out [B, S, K].

#include "blocks.cuh"

extern "C" int uml_tower_q8(const void* x, const void* wq, const void* wsc, const void* b_eff,
                            const void* woq, const void* wosc, const void* bo, const void* w1q,
                            const void* w1sc, const void* b1, const void* w2q,
                            const void* w2sc, const void* b2, void* q8, void* qscale,
                            void* qkv, void* attn, void* rowmax, void* mid, void* out, int B,
                            int S, int K, int H, int M, int L, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long hd = (long long)H * uml::ATT_D;
  const long long k = K, m = M;
  const int rows = B * S;
  const bf16* cur = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  bf16* md = static_cast<bf16*>(mid);
  int8_t* q = static_cast<int8_t*>(q8);
  float* qs = static_cast<float*>(qscale);
  for (int l = 0; l < L; ++l) {
    const cudaError_t e1 = uml::run_attn_block_q8(
        cur, static_cast<const int8_t*>(wq) + l * k * 3 * hd,
        static_cast<const float*>(wsc) + l * 3 * hd, static_cast<const float*>(b_eff) + l * 3 * hd,
        static_cast<const int8_t*>(woq) + l * hd * k, static_cast<const float*>(wosc) + l * k,
        static_cast<const float*>(bo) + l * k, q, qs, static_cast<bf16*>(qkv),
        attn, md, B, S, K, H, false, true, eps, st);
    if (e1 != cudaSuccess) return (int)e1;
    const cudaError_t e2 = uml::run_mlp_block_q8(
        md, static_cast<const int8_t*>(w1q) + l * k * m, static_cast<const float*>(w1sc) + l * m,
        static_cast<const float*>(b1) + l * m, static_cast<const int8_t*>(w2q) + l * m * k,
        static_cast<const float*>(w2sc) + l * k, static_cast<const float*>(b2) + l * k, q, qs,
        static_cast<int*>(rowmax), o, rows, K, M, eps, st);
    if (e2 != cudaSuccess) return (int)e2;
    cur = o;
  }
  return (int)cudaSuccess;
}
