// wgmma_gemm: C = A . B on Hopper's warpgroup MMAs with the operands
// brought in by TMA; bf16 operands with fp32 accumulation, or int8
// operands with exact s32 accumulation (the OUT_Q8_* epilogues).
//
// The product engine of the CLIP and DINO layers: ln_gemm.cuh routes its
// QKV (PRO_LN, EPI_NONE), the MLP in (PRO_LN, EPI_QUICK_GELU /
// EPI_GELU_STASH, EPI_GELU_EXACT / EPI_GELU_EXACT_STASH),
// the out-projections and the MLP out (PRO_NONE, EPI_RESIDUAL), g . wo^T
// (EPI_NONE, TRANS_B), dqkv . W_eff^T / g . w2^T / dpre . w1^T (EPI_F32,
// TRANS_B), the MLP backward's recompute (PRO_LN, EPI_DACT with a bf16
// dy, EPI_DACT_F32 with an fp32 dy, and their exact-GELU twins
// EPI_DACT_EXACT, EPI_DACT_F32_EXACT), the stash backward's g . w2^T
// (PRO_NONE, EPI_DACT_STASH / EPI_DACT_STASH_EXACT, TRANS_B) and the
// stand-alone ops' (PRO_LN_AFFINE
// / PRO_ADD_LN_AFFINE with EPI_NONE, EPI_QUICK_GELU, EPI_GELU_EXACT)
// triples here, gemm_at.cuh its weight-gradient products A^T . B, and
// q8_gemm.cuh every int8 product.  Those are the products of
// uml_tpu/ops/fused_attention.py::_block_kernel, _block_cls_kernel,
// _block_kernel_stash, _block_bwd_kernel, _block_bwd_stash_kernel,
// _block_bwd_cls_kernel, _kernel, of ln_matmul.py::_mlp_block_kernel,
// _mlp_block_kernel_stash, _mlp_bwd_kernel, _mlp_bwd_dw_kernel,
// _ln_matmul_kernel, _ln_matmul_kernel_3d, _add_ln_matmul_kernel, of
// text_tower.py::_tower_kernel, and the _q8_dot products of
// quant.py::_block_q8_kernel, _mlp_q8_kernel and
// tower_q8.py::_tower_q8_kernel.
//
// What bounds it on the H100: at ViT-B/16 B=64 every product is 44.6-59.5
// GFLOP over 20-100 MB, far above the ~295 FLOP/byte ridge: the tensor
// cores (45-60 us each at 989 TFLOP/s bf16, half that at 1,979 int8
// TOPS).  So the design feeds wgmma without a stall:
//
// * A block computes a 128 x 128 tile of C: two consumer warpgroups of 64
//   rows each issue wgmma.m64n128k16 from shared memory into 64 fp32
//   registers a thread; one producer warp keeps a ring of WGG_STAGES
//   stages of TMA loads in flight (a "full" mbarrier per stage for the
//   bytes landed, an "empty" one for both warpgroups done with it: one
//   arrival per consumer warp).  A
//   stage is one 128-byte-swizzled panel of A and of B: 64 of the
//   contraction in bf16, 128 in int8 (wgmma.m64n128k32.s32.s8.s8, the
//   same 32 bytes a step, so the same descriptors and 16 KB per operand).
//   The grid is persistent (two blocks per SM, 3 stages each): a
//   block walks its tiles in turn, its producer runs ahead into the next
//   tile's stages while the consumers finish the last one, and the other
//   block's products run under this one's epilogue.
// * Layouts (the operands as the callers hold them, read in place):
//   A K-major ([M, K] row-major: one TMA box of 64 x 128) or M-major
//   ([K, M] row-major, gemm_at's A^T: two boxes of 64 x 64, one 64-column
//   panel per warpgroup); B K-major ([N, K], TRANS_B: one box of 64 x 128)
//   or N-major ([K, N], the flax weight layout or gemm_at's B: two boxes of
//   64 x 64).  The wgmma transpose bits say which (hopper.cuh); an MN-major
//   descriptor steps 16 contraction rows (2 KB) per k16 and takes the
//   64-column panel stride as its leading offset, as flash_attention.cu's V.
//   wgmma's transpose bits exist for 16-bit types only, and TMA does not
//   transpose: int8 takes A [M, K] and B [N, K], both K-major (the model
//   keeps its int8 weights [out, in], quantized and cached once).
// * TMA's zero fill covers the ragged edges: rows of C >= M, columns >= N
//   (N a multiple of 64, not 128), the contraction past K (gemm_at's rows).
//   Stores are masked.
// * The epilogue works on the accumulator registers (the layout at the top
//   of hopper.cuh: a thread holds rows r and r+8 of its warp's 16, two
//   adjacent columns of every 8), bias add in fp32 and one rounding:
//   OUT_BF16 (bf16 C), OUT_F32 (fp32 C), OUT_DACT (the MLP backward's
//   recompute: y = acc + b1, aux = quick_gelu(y), out = dpre = dy *
//   quick_gelu'(y) as bf16, dy fp32 with its row stride, and the column
//   sums of the fp32 dpre over the block's 128 rows, reduced in a fixed
//   order, to colsum_part[row tile]), OUT_DACT_BF16 (the same with a bf16
//   dy and no column sums: row 19's recompute), OUT_DACT_EXACT and
//   OUT_DACT_BF16_EXACT (the same two with DINO's exact GELU: aux =
//   gelu(y) = y Phi(y), dpre = dy * (Phi(y) + y phi(y)), Phi on the erff of
//   OUT_GELU_EXACT, phi = exp(-y^2 / 2) / sqrt(2 pi) on the fast exp),
//   OUT_DACT_STASH and OUT_DACT_STASH_EXACT (the stash backward's dy = g .
//   w2^T: the roles swap, the accumulator is dy and the bf16 tile read
//   beside it the stashed pre y; the same aux, out and column sums as
//   OUT_DACT(_EXACT), so dy never leaves the registers),
//   OUT_GELU (the MLP in: y = acc + b1, out = quick_gelu(y) of the
//   unrounded y with the fast exp and reciprocal and, where aux is given,
//   aux = y, each rounded once), OUT_GELU_EXACT (out = gelu_exact(y) of
//   the unrounded y = acc + b, the erf form, rounded once: the stand-alone
//   ops' exact GELU, and the one DINO's MLP takes; where aux is given, aux
//   = y as OUT_GELU's stash: DINO's training forward) and
//   OUT_RESIDUAL (out = (acc + b) + res, res bf16 with row stride ldres),
//   and the int8 epilogues of q8_gemm.cuh: y = ((float)acc * row_scale) *
//   col_scale, each step rounded on its own, then OUT_Q8_BF16 bf16(y + b),
//   OUT_Q8_F32 y + b in fp32, OUT_Q8_RESIDUAL bf16((res + y) + b), and the
//   two passes of the int8 MLP in: OUT_Q8_ROWMAX (each row's max of y + b,
//   by an atomicMax of the tile's max into one int a row, its only store)
//   and OUT_Q8_ACTQ (the same y + b recomputed, quick_gelu, and int8 with
//   the row's scale from that max: no fp32 pre-activation reaches device
//   memory; q8_gemm.cuh), or OUT_Q8_ACTQ_GELU, the same with exact GELU
//   (DINO's MLP); without an activation OUT_Q8_ROWABSMAX (each row's max
//   of |y + b|) and OUT_Q8_QUANT (y + b itself int8 with that max's
//   scale).
//   The MLP in writes two [rows, 4K] bf16 tensors (155 MB at ViT-B/16
//   B=64), the heaviest store traffic of any product here: the
//   sector-filling stores below carry it.
// * Split contraction (gemm_at, whose C has few tiles and long K): the
//   work items z = 0 .. splits-1 of a tile each take a chunk of K; chunk 0
//   stores to out, chunk z > 0 to slab z-1 of `part`, and the caller adds
//   the slabs in order (gemm_at.cuh).  No item waits on another.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace uml {

constexpr int WGG_BM = 128;
constexpr int WGG_BN = 128;
constexpr int WGG_BK = 64;                         // bf16 contraction per stage
constexpr int WGG_ROW_BYTES = 128;                 // a swizzled row: 64 bf16 or 128 int8
constexpr int WGG_STAGES = 3;
constexpr int WGG_BLOCKS_PER_SM = 2;
constexpr int WGG_CONSUMERS = 256;                 // two warpgroups
constexpr int WGG_THREADS = WGG_CONSUMERS + 32;    // + the producer warp
constexpr int WGG_PANEL = 64 * 128;                // a 64 x 64 bf16 panel: 8 KB
constexpr int WGG_A_BYTES = WGG_BM * WGG_ROW_BYTES;  // 16 KB
constexpr int WGG_B_BYTES = WGG_BN * WGG_ROW_BYTES;  // 16 KB
constexpr int WGG_STAGE_BYTES = WGG_A_BYTES + WGG_B_BYTES;
constexpr int WGG_RED_BYTES = 8 * WGG_BN * 4;      // per-warp column sums (OUT_DACT)
// the base is aligned up to 1024 bytes (the swizzle atom) in the kernel
constexpr size_t WGG_SMEM =
    1024 + (size_t)WGG_STAGES * WGG_STAGE_BYTES + 16 * WGG_STAGES + WGG_RED_BYTES;

enum { WGG_OUT_BF16 = 0, WGG_OUT_F32 = 1, WGG_OUT_DACT = 2, WGG_OUT_GELU = 3,
       WGG_OUT_RESIDUAL = 4, WGG_OUT_DACT_BF16 = 5, WGG_OUT_Q8_BF16 = 6,
       WGG_OUT_Q8_F32 = 7, WGG_OUT_Q8_RESIDUAL = 8, WGG_OUT_GELU_EXACT = 9,
       WGG_OUT_Q8_ROWMAX = 10, WGG_OUT_Q8_ACTQ = 11, WGG_OUT_Q8_ACTQ_GELU = 12,
       WGG_OUT_DACT_EXACT = 13, WGG_OUT_DACT_BF16_EXACT = 14, WGG_OUT_Q8_ROWABSMAX = 15,
       WGG_OUT_Q8_QUANT = 16, WGG_OUT_DACT_STASH = 17, WGG_OUT_DACT_STASH_EXACT = 18 };

// the MLP backward's recompute: quick_gelu (DACT, DACT_BF16) or exact GELU
// (DACT_EXACT, DACT_BF16_EXACT); an fp32 dy with the column sums (row 20)
// or a bf16 dy (row 19)
static __host__ __device__ constexpr bool wgg_dact_f32(int out) {
  return out == WGG_OUT_DACT || out == WGG_OUT_DACT_EXACT;
}
// the stash backward's dy = g . w2^T: the accumulator is dy, the bf16 tile
// read beside it the stashed pre-activation (quick_gelu or exact GELU)
static __host__ __device__ constexpr bool wgg_dact_stash(int out) {
  return out == WGG_OUT_DACT_STASH || out == WGG_OUT_DACT_STASH_EXACT;
}
static __host__ __device__ constexpr bool wgg_dact(int out) {
  return wgg_dact_f32(out) || wgg_dact_stash(out) || out == WGG_OUT_DACT_BF16 ||
         out == WGG_OUT_DACT_BF16_EXACT;
}
// the epilogues that write the column sums of the fp32 dpre per row tile
static __host__ __device__ constexpr bool wgg_colsum(int out) {
  return wgg_dact_f32(out) || wgg_dact_stash(out);
}
// exact GELU's act and act' (the others take quick_gelu's)
static __host__ __device__ constexpr bool wgg_dact_exact(int out) {
  return out == WGG_OUT_DACT_EXACT || out == WGG_OUT_DACT_BF16_EXACT ||
         out == WGG_OUT_DACT_STASH_EXACT;
}

// the quantizing passes of the int8 MLP in: quick_gelu (ACTQ), exact
// GELU (ACTQ_GELU) or no activation (QUANT)
static __host__ __device__ constexpr bool wgg_actq(int out) {
  return out == WGG_OUT_Q8_ACTQ || out == WGG_OUT_Q8_ACTQ_GELU || out == WGG_OUT_Q8_QUANT;
}

// the passes before them, which find each row's max of y + b (ROWMAX, for
// the GELUs) or of |y + b| (ROWABSMAX, for no activation)
static __host__ __device__ constexpr bool wgg_rowmax(int out) {
  return out == WGG_OUT_Q8_ROWMAX || out == WGG_OUT_Q8_ROWABSMAX;
}

// the int8 instantiations: s8 operands, s32 accumulators
static __host__ __device__ constexpr bool wgg_int8(int out) {
  return out == WGG_OUT_Q8_BF16 || out == WGG_OUT_Q8_F32 || out == WGG_OUT_Q8_RESIDUAL ||
         wgg_rowmax(out) || wgg_actq(out);
}

struct WggEpilogue {
  const float* bias = nullptr;         // [N] fp32, or null
  void* out = nullptr;                 // [M, N]: bf16 (OUT_BF16, OUT_DACT: dpre) or fp32
  const float* dy = nullptr;           // OUT_DACT(_EXACT): [M, lddy] fp32
  const __nv_bfloat16* dy16 = nullptr; // OUT_DACT_BF16(_EXACT): [M, lddy] bf16 dy;
                                       // OUT_DACT_STASH(_EXACT): the bf16 pre stash
  long long lddy = 0;
  __nv_bfloat16* aux = nullptr;        // OUT_DACT*: [M, N] act(y); OUT_GELU(_EXACT): y, or null
  const __nv_bfloat16* res = nullptr;  // OUT_RESIDUAL, OUT_Q8_RESIDUAL: [M, ldres] bf16
  long long ldres = 0;
  float* colsum_part = nullptr;        // OUT_DACT(_EXACT), OUT_DACT_STASH(_EXACT):
                                       // [ceil(M / 128), N], or null
  int splits = 1;                      // contraction chunks (OUT_F32, no bias)
  float* part = nullptr;               // splits > 1: [splits - 1, M, N] fp32 partials
  const float* row_scale = nullptr;    // OUT_Q8_*: [M] fp32
  const float* col_scale = nullptr;    // OUT_Q8_*: [N] fp32
  int* rowmax = nullptr;               // OUT_Q8_ROW(ABS)MAX (atomicMax), OUT_Q8_ACTQ* and
                                       // OUT_Q8_QUANT (read): [M], each row's max of y + b
                                       // (of |y + b|) as q8_ordered ints
  float* qscale = nullptr;             // OUT_Q8_ACTQ*: [M] fp32, the int8 out's row scales
};

// two floats as the bits of a bf16 pair (the lower column in the low half)
static __device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The exact GELU of the fp32 y, y * 0.5 * (1 + erf(y / sqrt 2)), on the
// card's erff (max 2 ulp): the TPU kernel's sigmoid-quintic fit stands in
// for an erf that Mosaic lacks.
static __device__ __forceinline__ float gelu_exact(float y) {
  return y * 0.5f * (1.f + erff(y * 0.70710678118654752f));
}

constexpr float Q8_MAX = 127.f;
// |the activation's minimum|, padded ~1% (uml_tpu/ops/quant.py:121): the
// row scale's floor, so that a row whose largest |act| lies on the
// negative lobe never clips
constexpr float QUICK_GELU_LOBE = 0.1654f;
constexpr float GELU_EXACT_LOBE = 0.1718f;

// the row scale's floor without an activation: max(absmax, 1e-12) / 127
// (uml_tpu/ops/quant.py::_quantize_rows)
constexpr float Q8_MIN_ABSMAX = 1e-12f;

// round half up (floor(v + 0.5)), clamped to +-127, as uml_tpu quantizes
static __device__ __forceinline__ int8_t q8_round(float v) {
  return (int8_t)fminf(fmaxf(floorf(__fadd_rn(v, 0.5f)), -Q8_MAX), Q8_MAX);
}

// x * (1 / (1 + exp(-1.702 x))), each step rounded as the plain version's
static __device__ __forceinline__ float quick_gelu_rn(float x) {
  return __fmul_rn(x, __fdiv_rn(1.f, __fadd_rn(1.f, expf(__fmul_rn(-1.702f, x)))));
}

// An fp32 as an int whose signed order is the floats' (an involution: it
// maps the int back too), so that atomicMax takes a row's max of fp32
// values; a max does not depend on its order, so the result is
// deterministic.  Q8_ORDERED_NEG_INF is -inf's, a row max's first value.
static __host__ __device__ __forceinline__ int q8_ordered(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}
constexpr int Q8_ORDERED_NEG_INF = (int)0x807fffff;

// round(quick_gelu_rn(y) / sc) as q8_round rounds it, at a fraction of its
// cost.  The fast form, y / (1 + 2^(y C)) (C = -1.702 log2 e, the
// special-function unit's exp2 and reciprocal) times 1 / sc, lies within
// ~1e-4 of the exact quotient in integer units: its relative error is a
// few 1e-7 where the quotient is large, and where exp2's argument is large
// the quotient is y to far below an ulp (y > 0) or far below a step
// (y < 0).  So it rounds as the exact quotient unless it lies within
// ACTQ_TIE of a rounding boundary; there (~2e-3 of the values) the exact
// expression decides, out of line.  No clamp: |quick_gelu(y) / sc| <= 127
// (sc >= quick_gelu(row max) / 127 and >= 0.1654 / 127, quick_gelu >=
// -0.1637), so floor(u) lies in [-126, 127] on both paths.
constexpr float ACTQ_TIE = 1e-3f;
static __device__ __noinline__ int8_t act_q8_exact(float y, float sc) {
  return q8_round(__fdiv_rn(quick_gelu_rn(y), sc));
}
static __device__ __forceinline__ int8_t act_q8(float y, float sc, float inv) {
  const float u = __fmaf_rn(__fdividef(y, 1.f + ex2_approx(y * -2.4554669595930156f)), inv,
                            0.5f);
  const float f = floorf(u);
  if (fabsf(u - f - 0.5f) < 0.5f - ACTQ_TIE) return (int8_t)(int)f;
  return act_q8_exact(y, sc);
}

// exact GELU's int8 in the plain version's expression, everywhere (no
// fast form): round(gelu_exact(y) / sc), |quotient| <= 127 as above
// (gelu_exact >= -0.1700 > -GELU_EXACT_LOBE)
static __device__ __forceinline__ int8_t gelu_q8(float y, float sc) {
  return q8_round(__fdiv_rn(gelu_exact(y), sc));
}

// The int8 epilogue's fp32 value in the reference's order, every step an
// explicitly rounded intrinsic (nvcc contracts none into an FMA), so it
// rounds as the plain PyTorch version does: ((float)acc * row_scale) *
// col_scale, then (res + y) for OUT_Q8_RESIDUAL, then + b.
template <int OUT>
static __device__ __forceinline__ float q8_value(int acc, float rs, float cs, float b,
                                                 float res) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
  if (OUT == WGG_OUT_Q8_RESIDUAL) v = __fadd_rn(res, v);
  return __fadd_rn(v, b);
}

// OUT_Q8_ROWMAX and OUT_Q8_ACTQ on a thread's accumulators (rows row_a and
// row_a + 8, columns n0 + 2 (lane % 4) + 8 j + {0, 1}), y = q8_value as
// OUT_Q8_F32 computes it.  ROWMAX: each row's max of y over the tile's
// columns (a quad of lanes holds a row of the warp's 16 whole, so the
// quad's shuffles finish it), then atomicMax into rowmax[row] (ordered
// ints; the caller initialises them to Q8_ORDERED_NEG_INF).  ACTQ: the
// int8 of act(y) / sc, sc = max(act(rowmax), lobe) / 127 from the row's
// max rmx (act quick_gelu, or exact GELU for ACTQ_GELU: both rise
// monotonically above their one minimum, so that bound covers the row),
// rounded as the one-pass act quantization rounded it (act_q8, gelu_q8),
// 8 contiguous bytes a lane after an exchange within the quad, and the row
// scales from the first column tile.  Without an activation (uml_tpu's
// identity, _quantize_rows) ROWABSMAX keeps each row's max of |y| instead:
// a non-negative float's bits order as ints (q8_ordered leaves them as
// they are), and every thread's first value is 0, above any initial value
// of the row; QUANT quantizes y itself with sc = max(absmax, 1e-12) / 127,
// round(y / sc) in q8_round's explicitly rounded steps, as the plain
// version divides and rounds.
template <int OUT>
static __device__ __forceinline__ void q8_act_epilogue(const int (&acc)[64],
                                                       const WggEpilogue& ep,
                                                       const float (&rs)[2],
                                                       const int (&rmx)[2], int row_a, int n0,
                                                       int M, int N, int lane) {
  const int q = lane & 3;
  const int col_a = n0 + 2 * q;
  if constexpr (wgg_rowmax(OUT)) {
    constexpr bool ABS = OUT == WGG_OUT_Q8_ROWABSMAX;
    float mx[2] = {ABS ? 0.f : -CUDART_INF_F, ABS ? 0.f : -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < WGG_BN / 8; ++j) {
      const int col = col_a + 8 * j;
      if (col >= N) continue;
      const float b0 = ep.bias[col], b1 = ep.bias[col + 1];
      const float cs0 = ep.col_scale[col], cs1 = ep.col_scale[col + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float y0 = q8_value<OUT>(acc[4 * j + 2 * r], rs[r], cs0, b0, 0.f);
        float y1 = q8_value<OUT>(acc[4 * j + 2 * r + 1], rs[r], cs1, b1, 0.f);
        if constexpr (ABS) {
          y0 = fabsf(y0);
          y1 = fabsf(y1);
        }
        mx[r] = fmaxf(mx[r], fmaxf(y0, y1));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const int row = row_a + 8 * r;
      if (q == 0 && row < M) atomicMax(ep.rowmax + row, q8_ordered(__float_as_int(mx[r])));
    }
  } else {
    constexpr bool EXACT = OUT == WGG_OUT_Q8_ACTQ_GELU;
    constexpr bool IDENT = OUT == WGG_OUT_Q8_QUANT;
    float sc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float top = __int_as_float(q8_ordered(rmx[r]));
      if constexpr (IDENT)
        sc[r] = __fdiv_rn(fmaxf(top, Q8_MIN_ABSMAX), Q8_MAX);
      else
        sc[r] = __fdiv_rn(EXACT ? fmaxf(gelu_exact(top), GELU_EXACT_LOBE)
                                : fmaxf(quick_gelu_rn(top), QUICK_GELU_LOBE),
                          Q8_MAX);
    }
    if (n0 == 0 && q == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row_a + 8 * r < M) ep.qscale[row_a + 8 * r] = sc[r];
    }
    int8_t* out = static_cast<int8_t*>(ep.out);
    const float inv[2] = {__frcp_rn(sc[0]), __frcp_rn(sc[1])};
#pragma unroll
    for (int g = 0; g < WGG_BN / 32; ++g) {
      // the two int8 of each 8-column block 4g + jj of both rows, then lane
      // q gathers block 4g + q: in round s it reads, from lane q - s, the
      // pair that lane sends for block (q - s) + s
      uint32_t h[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * g + jj, col = col_a + 8 * j;
        float b0 = 0.f, b1 = 0.f, cs0 = 0.f, cs1 = 0.f;
        if (col < N) {
          b0 = ep.bias[col];
          b1 = ep.bias[col + 1];
          cs0 = ep.col_scale[col];
          cs1 = ep.col_scale[col + 1];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float y0 = q8_value<OUT>(acc[4 * j + 2 * r], rs[r], cs0, b0, 0.f);
          const float y1 = q8_value<OUT>(acc[4 * j + 2 * r + 1], rs[r], cs1, b1, 0.f);
          if constexpr (IDENT)
            h[r][jj] = (uint32_t)(uint8_t)q8_round(__fdiv_rn(y0, sc[r])) |
                       (uint32_t)(uint8_t)q8_round(__fdiv_rn(y1, sc[r])) << 8;
          else if constexpr (EXACT)
            h[r][jj] = (uint32_t)(uint8_t)gelu_q8(y0, sc[r]) |
                       (uint32_t)(uint8_t)gelu_q8(y1, sc[r]) << 8;
          else
            h[r][jj] = (uint32_t)(uint8_t)act_q8(y0, sc[r], inv[r]) |
                       (uint32_t)(uint8_t)act_q8(y1, sc[r], inv[r]) << 8;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t w0 = 0u, w1 = 0u;  // bytes 0-3 and 4-7 (lane-dependent
                                    // slots: selects, not an indexed array)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int sel = (q + s) & 3, from = (q - s) & 3;
          const uint32_t send = sel == 0 ? h[r][0] : sel == 1 ? h[r][1]
                                : sel == 2 ? h[r][2] : h[r][3];
          const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | from)
                               << (16 * (from & 1));
          if (from < 2)
            w0 |= got;
          else
            w1 |= got;
        }
        const int row = row_a + 8 * r, col = n0 + 8 * (4 * g + q);
        if (row < M && col < N)
          *reinterpret_cast<uint2*>(out + (long long)row * N + col) = make_uint2(w0, w1);
      }
    }
  }
}

template <bool A_MN, bool B_MN, int OUT>
__global__ void __launch_bounds__(WGG_THREADS, WGG_BLOCKS_PER_SM)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const WggEpilogue ep, int M, int N, int K) {
  constexpr bool Q8 = wgg_int8(OUT);
  static_assert(!Q8 || (!A_MN && !B_MN), "int8 operands are K-major");
  constexpr int BK = Q8 ? WGG_ROW_BYTES : WGG_BK;  // contraction per stage
  using Acc = typename std::conditional<Q8, int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // stage s: A at base + s STAGE, B after it; full[s] at sBar + 8 s,
  // empty[s] at sBar + 8 (WGG_STAGES + s); the column-sum scratch after them
  const uint32_t sBar = base + WGG_STAGES * WGG_STAGE_BYTES;
  float* red = reinterpret_cast<float*>(smem_raw + (sBar + 16 * WGG_STAGES - raw));

  const int tid = threadIdx.x;
  // persistent: block b takes work items b, b + gridDim.x, ...; an item
  // is (contraction chunk, row tile, column tile), column tiles fastest,
  // so the blocks in flight share their A rows in L2
  const int tiles_n = (N + WGG_BN - 1) / WGG_BN;
  const int tiles = tiles_n * ((M + WGG_BM - 1) / WGG_BM);
  const int items = tiles * ep.splits;
  const int kt_all = (K + BK - 1) / BK;
  const int per = (kt_all + ep.splits - 1) / ep.splits;

  if (tid == 0) {
    for (int s = 0; s < WGG_STAGES; ++s) {
      mbar_init(sBar + 8 * s, 1);
      mbar_init(sBar + 8 * (WGG_STAGES + s), WGG_CONSUMERS / 32);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= WGG_CONSUMERS) {
    // the producer warp: one lane issues every copy, running ahead into
    // the next item while the consumers finish this one
    if (tid == WGG_CONSUMERS) {
      int it = 0;  // stages filled so far, over every item
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = item % tiles, split = item / tiles;
        const int n0 = (tile % tiles_n) * WGG_BN, m0 = (tile / tiles_n) * WGG_BM;
        const int kt0 = split * per, nk = min(kt_all, kt0 + per) - kt0;
        for (int t = 0; t < nk; ++t, ++it) {
          const int s = it % WGG_STAGES;
          mbar_wait(sBar + 8 * (WGG_STAGES + s), ((it / WGG_STAGES) & 1) ^ 1);
          const uint32_t full = sBar + 8 * s;
          const uint32_t sa = base + s * WGG_STAGE_BYTES;
          const uint32_t sb = sa + WGG_A_BYTES;
          const int k = (kt0 + t) * BK;
          mbar_arrive_expect_tx(full, WGG_STAGE_BYTES);
          if (A_MN) {
            tma_load_2d(sa, &ta, full, m0, k);
            tma_load_2d(sa + WGG_PANEL, &ta, full, m0 + 64, k);
          } else {
            tma_load_2d(sa, &ta, full, k, m0);
          }
          if (B_MN) {
            tma_load_2d(sb, &tb, full, n0, k);
            tma_load_2d(sb + WGG_PANEL, &tb, full, n0 + 64, k);
          } else {
            tma_load_2d(sb, &tb, full, k, n0);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 wg .. + 63 of each item's tile, all
  // 128 columns; stage t's products are issued, then stage t-1 is released
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid & 31;
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % tiles, split = item / tiles;
    const int n0 = (tile % tiles_n) * WGG_BN, m0 = (tile / tiles_n) * WGG_BM;
    const int kt0 = split * per, nk = min(kt_all, kt0 + per) - kt0;
    Acc acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    // OUT_Q8_ACTQ*: each of the thread's two rows' max of y, which the
    // ROWMAX pass left; loaded before the products and first read after
    // them, so the load's latency hides under the mainloop
    int act_max[2] = {Q8_ORDERED_NEG_INF, Q8_ORDERED_NEG_INF};
    if constexpr (wgg_actq(OUT)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * r;
        if (row < M) act_max[r] = __ldg(ep.rowmax + row);
      }
    }
    for (int t = 0; t < nk; ++t, ++it) {
      const int s = it % WGG_STAGES;
      mbar_wait(sBar + 8 * s, (it / WGG_STAGES) & 1);
      const uint32_t sa = base + s * WGG_STAGE_BYTES;
      const uint32_t sb = sa + WGG_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WGG_ROW_BYTES / 32; ++kk) {
        // K-major: 32 bytes along the swizzled 128-byte rows per step (k16
        // bf16, k32 int8); MN-major: 16 rows of 128 bytes per k16
        const uint64_t da = A_MN ? wgmma_desc(sa + wg * WGG_PANEL + kk * 2048, WGG_PANEL, 1024)
                                 : wgmma_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = B_MN ? wgmma_desc(sb + kk * 2048, WGG_PANEL, 1024)
                                 : wgmma_desc(sb + kk * 32, 16, 1024);
        if constexpr (Q8)
          wgmma_ss_n128_s8(acc, da, db, 1);
        else
          wgmma_ss_n128<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // stage t-1's products are done: release it
      if (t > 0 && lane == 0) mbar_arrive(sBar + 8 * (WGG_STAGES + (it - 1) % WGG_STAGES));
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    if (lane == 0) mbar_arrive(sBar + 8 * (WGG_STAGES + (it - 1) % WGG_STAGES));

    // epilogue on the accumulator registers, two 8-column blocks at a
    // time: the pair's dy loads are issued before its stores, so they are
    // in flight together (a larger group spills under the 96 registers
    // that two blocks per SM leave), and its bf16 results are exchanged
    // within each quad of lanes so that every store writes whole sectors
    const int row_a = m0 + 64 * wg + 16 * warp + (lane >> 2);  // and row_a + 8
    const int col_a = n0 + 2 * (lane & 3);                     // + 8 j, + {0, 1}
    constexpr bool RES = OUT == WGG_OUT_RESIDUAL || OUT == WGG_OUT_Q8_RESIDUAL;
    constexpr bool DACT = wgg_dact(OUT);
    float rs[2] = {0.f, 0.f};  // the int8 rows' scales
    if constexpr (Q8) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row_a + 8 * r < M) rs[r] = ep.row_scale[row_a + 8 * r];
    }
    if constexpr (wgg_rowmax(OUT) || wgg_actq(OUT)) {
      q8_act_epilogue<OUT>(acc, ep, rs, act_max, row_a, n0, M, N, lane);
      continue;
    }
#pragma unroll
    for (int j0 = 0; j0 < WGG_BN / 8; j0 += 2) {
      float2 in[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + 8 * r, col = col_a + 8 * (j0 + jj);
          in[jj][r] = make_float2(0.f, 0.f);
          if (wgg_dact_f32(OUT) && row < M && col < N)
            in[jj][r] = __ldg(reinterpret_cast<const float2*>(ep.dy + (long long)row * ep.lddy +
                                                               col));
          if (DACT && !wgg_dact_f32(OUT) && row < M && col < N)
            in[jj][r] = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
                ep.dy16 + (long long)row * ep.lddy + col)));
          if (RES && row < M && col < N)
            in[jj][r] = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
                ep.res + (long long)row * ep.ldres + col)));
        }
      }
      if constexpr (OUT == WGG_OUT_F32 || OUT == WGG_OUT_Q8_F32) {
        // fp32: a quad's 8-byte stores fill whole sectors as they stand;
        // chunk z > 0 stores to its slab of the partials
        float* dst = split == 0 ? static_cast<float*>(ep.out)
                                : ep.part + (long long)(split - 1) * M * N;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = col_a + 8 * (j0 + jj);
          if (col >= N) continue;
          float b0 = 0.f, b1 = 0.f;
          if (ep.bias != nullptr) {
            b0 = ep.bias[col];
            b1 = ep.bias[col + 1];
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row_a + 8 * r;
            if (row >= M) continue;
            const int i = 4 * (j0 + jj) + 2 * r;
            float2 v;
            if constexpr (Q8)
              v = make_float2(q8_value<OUT>(acc[i], rs[r], ep.col_scale[col], b0, 0.f),
                              q8_value<OUT>(acc[i + 1], rs[r], ep.col_scale[col + 1], b1, 0.f));
            else
              v = make_float2(acc[i] + b0, acc[i + 1] + b1);
            *reinterpret_cast<float2*>(dst + (long long)row * N + col) = v;
          }
        }
      } else {
        // bf16 results packed two columns a register, [output][jj][r]:
        // output 0 is out (OUT_BF16, OUT_GELU, OUT_GELU_EXACT, OUT_RESIDUAL) or dpre,
        // output 1 yact (OUT_DACT*) or the pre-activation y (OUT_GELU, OUT_GELU_EXACT)
        uint32_t pk[2][2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = j0 + jj;
          const int col = col_a + 8 * j;
          const bool col_ok = col < N;
          float b0 = 0.f, b1 = 0.f, cs0 = 0.f, cs1 = 0.f;
          if (col_ok && ep.bias != nullptr) {
            b0 = ep.bias[col];
            b1 = ep.bias[col + 1];
          }
          if (Q8 && col_ok) {
            cs0 = ep.col_scale[col];
            cs1 = ep.col_scale[col + 1];
          }
          float c0 = 0.f, c1 = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float v0, v1;
            if constexpr (Q8) {
              v0 = q8_value<OUT>(acc[4 * j + 2 * r], rs[r], cs0, b0, in[jj][r].x);
              v1 = q8_value<OUT>(acc[4 * j + 2 * r + 1], rs[r], cs1, b1, in[jj][r].y);
            } else {
              v0 = acc[4 * j + 2 * r] + b0;
              v1 = acc[4 * j + 2 * r + 1] + b1;
            }
            if (OUT == WGG_OUT_BF16 || Q8) {
              pk[0][jj][r] = bf16x2_bits(v0, v1);
            } else if (OUT == WGG_OUT_RESIDUAL) {
              pk[0][jj][r] = bf16x2_bits(v0 + in[jj][r].x, v1 + in[jj][r].y);
            } else if (OUT == WGG_OUT_GELU) {
              // quick_gelu(y) = y / (1 + exp(-1.702 y)) of the unrounded y,
              // on the special-function unit (ex2 and rcp, ~2 ulp each,
              // far inside the bf16 rounding that follows): with K = 768
              // the epilogue's arithmetic is a large share of a tile, and
              // the accurate expf and division made the MLP in ~20% slower
              pk[0][jj][r] = bf16x2_bits(__fdividef(v0, 1.f + __expf(-1.702f * v0)),
                                         __fdividef(v1, 1.f + __expf(-1.702f * v1)));
              pk[1][jj][r] = bf16x2_bits(v0, v1);
            } else if (OUT == WGG_OUT_GELU_EXACT) {
              pk[0][jj][r] = bf16x2_bits(gelu_exact(v0), gelu_exact(v1));
              pk[1][jj][r] = bf16x2_bits(v0, v1);
            } else {
              // the recompute epilogues: y = v the pre-activation, the tile
              // read beside it dy; the stash epilogues swap the roles: dy =
              // v (the product g . w2^T, no bias) and y the stashed bf16 pre
              // (act and act' of the rounded pre, as uml_tpu's stash
              // backward takes them)
              constexpr bool STASH = wgg_dact_stash(OUT);
              const float y0 = STASH ? in[jj][r].x : v0, y1 = STASH ? in[jj][r].y : v1;
              const float e0 = STASH ? v0 : in[jj][r].x, e1 = STASH ? v1 : in[jj][r].y;
              float d0, d1;
              if constexpr (wgg_dact_exact(OUT)) {
                // gelu(y) = y Phi(y) and gelu'(y) = Phi(y) + y phi(y): Phi
                // on erff as gelu_exact takes it (the same bits of yact),
                // phi(y) = exp(-y^2 / 2) / sqrt(2 pi) on the fast exp (its
                // relative error, under 1e-7 y^2 + 2 ulp, is < 3e-6
                // wherever y phi(y) exceeds 1e-5: far inside the bf16
                // rounding that follows); dy is 0 outside the matrix, so is
                // d there
                const float p0 = 0.5f * (1.f + erff(y0 * 0.70710678118654752f));
                const float p1 = 0.5f * (1.f + erff(y1 * 0.70710678118654752f));
                d0 = e0 * (p0 + y0 * (__expf(-0.5f * y0 * y0) * 0.3989422804014327f));
                d1 = e1 * (p1 + y1 * (__expf(-0.5f * y1 * y1) * 0.3989422804014327f));
                pk[1][jj][r] = bf16x2_bits(y0 * p0, y1 * p1);
              } else {
                // quick_gelu'(y) = s (1 + 1.702 y (1 - s)) with one sigmoid
                // s, on the special-function unit as OUT_GELU (2 ulp, far
                // inside the bf16 rounding that follows: the accurate expf
                // and division made row 19 ~8% and row 20 ~5% slower); dy
                // is 0 outside the matrix, so is d there
                const float s0 = __fdividef(1.f, 1.f + __expf(-1.702f * y0));
                const float s1 = __fdividef(1.f, 1.f + __expf(-1.702f * y1));
                d0 = e0 * (s0 * (1.f + 1.702f * y0 * (1.f - s0)));
                d1 = e1 * (s1 * (1.f + 1.702f * y1 * (1.f - s1)));
                pk[1][jj][r] = bf16x2_bits(y0 * s0, y1 * s1);
              }
              pk[0][jj][r] = bf16x2_bits(d0, d1);
              c0 += d0;
              c1 += d1;
            }
          }
          if (wgg_colsum(OUT)) {
            // the warp's 16 rows: the 8 lanes of one column pair, in a fixed tree
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              c0 += __shfl_xor_sync(0xffffffffu, c0, o);
              c1 += __shfl_xor_sync(0xffffffffu, c1, o);
            }
            if (lane < 4) {
              red[(wg * 4 + warp) * WGG_BN + 8 * j + 2 * lane] = c0;
              red[(wg * 4 + warp) * WGG_BN + 8 * j + 2 * lane + 1] = c1;
            }
          }
        }
        // a quad holds the pair's 16 columns of its two rows, 4 bytes a
        // lane per 8-column block; exchanged, lane q stores columns 4q ..
        // 4q+3 of them (8 bytes), so each store fills whole 32-byte sectors
        const int q = lane & 3;
        const int src = (lane & ~3) | (2 * (q & 1));
        const int col = n0 + 8 * j0 + 4 * q;
#pragma unroll
        for (int t = 0; t < (DACT || OUT == WGG_OUT_GELU || OUT == WGG_OUT_GELU_EXACT ? 2 : 1);
             ++t) {
          if (t == 1 && ep.aux == nullptr) break;  // OUT_GELU(_EXACT) without the stash
          __nv_bfloat16* dst = t == 0 ? static_cast<__nv_bfloat16*>(ep.out) : ep.aux;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t a0 = __shfl_sync(0xffffffffu, pk[t][0][r], src);
            const uint32_t a1 = __shfl_sync(0xffffffffu, pk[t][0][r], src + 1);
            const uint32_t b0 = __shfl_sync(0xffffffffu, pk[t][1][r], src);
            const uint32_t b1 = __shfl_sync(0xffffffffu, pk[t][1][r], src + 1);
            const int row = row_a + 8 * r;
            if (row < M && col < N)
              *reinterpret_cast<uint2*>(dst + (long long)row * N + col) =
                  q < 2 ? make_uint2(a0, a1) : make_uint2(b0, b1);
          }
        }
      }
    }
    if (wgg_colsum(OUT) && ep.colsum_part != nullptr) {
      // the 8 warps' sums in warp order: one thread per column; the second
      // barrier keeps the next item's sums out until they are read
      named_bar_sync(1, WGG_CONSUMERS);
      if (tid < WGG_BN && n0 + tid < N) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) t += red[w * WGG_BN + tid];
        ep.colsum_part[(long long)(m0 / WGG_BM) * N + n0 + tid] = t;
      }
      named_bar_sync(1, WGG_CONSUMERS);
    }
  }
}

// the blocks the card holds at once: two per SM
static inline int wgmma_block_slots() {
  static const int slots = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms * WGG_BLOCKS_PER_SM;
  }();
  return slots;
}

// Launch C = A . B on the engine; returns the launch error.  A_MN: a is
// [K, M] row-major (the product takes a^T), else [M, K]; B_MN: b is
// [K, N] row-major, else [N, K] (the product takes b^T).  a and b are
// bf16, or int8 for the OUT_Q8_* epilogues (both K-major).  Takes N a
// multiple of 64 and K a multiple of 64 (with A_MN: M a multiple of 64 and
// any K), pointers 16-byte aligned; refuses anything else.
template <bool A_MN, bool B_MN, int OUT>
static cudaError_t launch_wgmma_gemm(const void* a, const void* b, const WggEpilogue& ep, int M,
                                     int N, int K, cudaStream_t stream) {
  constexpr bool Q8 = wgg_int8(OUT);
  constexpr int esize = Q8 ? 1 : 2;  // bytes per element
  if (M < 1 || N < 64 || K < 1 || N % 64 != 0 || (A_MN ? M % 64 != 0 : K % 64 != 0) ||
      ep.splits < 1 || ep.splits > 64 ||
      (ep.splits > 1 && (OUT != WGG_OUT_F32 || ep.part == nullptr || ep.bias != nullptr)) ||
      ((OUT == WGG_OUT_RESIDUAL || OUT == WGG_OUT_Q8_RESIDUAL) &&
       (ep.res == nullptr || ep.ldres < N || ep.ldres % 2 != 0)) ||
      (wgg_dact(OUT) &&
       ((wgg_dact_f32(OUT) ? ep.dy == nullptr : ep.dy16 == nullptr) || ep.aux == nullptr ||
        ep.lddy < N || ep.lddy % 2 != 0)) ||
      (Q8 && (ep.row_scale == nullptr || ep.col_scale == nullptr || ep.bias == nullptr)) ||
      (wgg_rowmax(OUT) && ep.rowmax == nullptr) ||
      (wgg_actq(OUT) &&
       (ep.rowmax == nullptr || ep.qscale == nullptr || ep.out == nullptr)) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return cudaErrorInvalidValue;
  const CUtensorMapDataType type =
      Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // a K-major box is one 128-byte row of the contraction by 128 rows; an
  // MN-major one 64 columns (128 bytes) by 64 rows of the contraction
  constexpr cuuint32_t row = WGG_ROW_BYTES / esize;
  CUtensorMap ta, tb;
  {
    const cuuint64_t dims[2] = {A_MN ? (cuuint64_t)M : (cuuint64_t)K,
                                A_MN ? (cuuint64_t)K : (cuuint64_t)M};
    const cuuint64_t strides[1] = {dims[0] * esize};
    const cuuint32_t box[2] = {row, A_MN ? 64u : 128u};
    if (!make_tensor_map(&ta, a, 2, dims, strides, box, type)) return cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {B_MN ? (cuuint64_t)N : (cuuint64_t)K,
                                B_MN ? (cuuint64_t)K : (cuuint64_t)N};
    const cuuint64_t strides[1] = {dims[0] * esize};
    const cuuint32_t box[2] = {row, B_MN ? 64u : 128u};
    if (!make_tensor_map(&tb, b, 2, dims, strides, box, type)) return cudaErrorInvalidValue;
  }
  static const cudaError_t attr =
      cudaFuncSetAttribute(wgmma_gemm_kernel<A_MN, B_MN, OUT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WGG_SMEM);
  if (attr != cudaSuccess) return attr;
  const long long items =
      (long long)((N + WGG_BN - 1) / WGG_BN) * ((M + WGG_BM - 1) / WGG_BM) * ep.splits;
  const long long slots = wgmma_block_slots();
  wgmma_gemm_kernel<A_MN, B_MN, OUT><<<(unsigned)(items < slots ? items : slots), WGG_THREADS,
                                       WGG_SMEM, stream>>>(ta, tb, ep, M, N, K);
  return cudaGetLastError();
}

}  // namespace uml
