// uml_qkv_attention / uml_qkv_attention_q8 (uml::launch_qkv_attention):
// the attention half-block's QKV product and its attention in one launch,
// with q, k and v of each (image, head) pair kept in shared memory.
//
// Replaces the QKV product and the attention inside
// uml_tpu/ops/fused_attention.py::_block_kernel (every query row, causal
// or not), ::_block_kernel_stash (also writing qkv), ::_block_cls_kernel
// (the CLS row) and uml_tpu/ops/quant.py::_block_q8_kernel (the int8 QKV
// product), which keep qkv and the scores in VMEM.  blocks.cuh runs it for
// S <= 256 (every CLIP ViT-B/16, ViT-B/32 and text shape) in place of the
// chain of the QKV product on the wgmma engine (writing 58 MB of qkv at
// ViT-B/16 B=64) and flash_attention.cu (reading it back); above 256 the
// halves keep that chain.  The LN row pre-pass (ln_gemm.cuh's
// ln_rows_kernel, or quantize.cuh's ln_quantize_rows in int8) runs before
// it, and the out-projection after it, each a launch of its own: the
// out-projection sums over all heads, which no (image, head) block owns,
// and the int8 attention output's row scale needs the whole row.
//
// What bounds it on the H100: at ViT-B/16 B=64 the QKV product is 44.6
// GFLOP (58 GFLOP as computed: 197 rows pad to four m64 tiles) and the
// attention 7.6, against 19.4 MB of xn and 3.5 MB of w_eff read and 19.4
// MB of attention output written: the tensor cores (~53 us at 989
// TFLOP/s).  The design:
//
// * One work item is one (image, head) pair (768 at B=64), on a persistent
//   grid of one block per SM: two consumer warpgroups and a producer
//   warpgroup, one thread of which runs the TMA loads of the next item's
//   stages while the consumers finish this item's attention (setmaxnreg:
//   40 registers a producer thread, 232 a consumer thread).  Items go
//   image by image, so the blocks in flight share an image's xn in L2.
// * QKV: the item's rows of xn (a 3-d tensor map over [B, S, K], so rows
//   >= S read as TMA's zeros) against the head's three 64-column slices of
//   w_eff, in passes of 128 rows (64 a warpgroup) over a 3-stage ring of
//   64 of the contraction (bf16; 128 in int8) a stage: wgmma.m64n192k16
//   (bf16, w_eff N-major) or m64n192k32.s32.s8.s8 (int8, K-major), 96
//   accumulator registers a thread.  The epilogue adds b_eff in fp32 (int8:
//   q8_gemm.cuh's q8_value, so the values equal the chain's Q8_EPI_BF16
//   ones; the head's b_eff and column scales staged in shared memory once
//   an item), rounds once to bf16 and writes q, k and v into shared memory
//   in the 128-byte-swizzled layout wgmma reads (256 rows x 128 bytes
//   each, 96 KB).  The CLS block without a stash projects q for the first
//   m64 tile only (m64n128 over k and v elsewhere): a quarter of its QKV.
// * Attention: a warpgroup takes 64 query rows a turn.  The scores of the
//   whole key row (128 or 256 keys: one or two m64n128 chains, Q and K from
//   shared memory) stay in registers; each row's max over all its keys,
//   then P = 2^(s log2(e)/8 - m) rounded to bf16 once against that final
//   max (the MAX_FIRST numerics of flash_attention.cu, with no second
//   walk), the fp32 row sums, and O = P V with P as the register A operand
//   and V MN-major, 1/rowsum applied to the fp32 O.  Key columns >= S and,
//   causal, above the diagonal are masked without a branch inside a chunk
//   of 128 keys; the rows of shared memory past the last m64 tile stay
//   zero.  The softmax is bound by the special-function unit (an exp per
//   score: one warpgroup's tile keeps all four SM sub-partitions' units
//   busy), so the two warpgroups take turns at it (named barriers 2 and 3)
//   and one's softmax runs under the other's products.  Every key of a
//   chunk takes its exp: skipping 16-key blocks past S by a branch each cut
//   the row into blocks whose exps no longer interleave, and the softmax
//   ran slower (tools/exp_torch_qkv_trace.py times the phases).
// * With a qkv buffer (the training stash, and row 7's recompute, which
//   calls this same kernel so that its qkv and attention output equal the
//   stash forward's bit for bit) the consumers copy q, k and v from shared
//   memory to qkv [B, S, 3*H*64]; the inference halves write no qkv.
//
// Budget: shared memory 96 KB of q, k, v + 3 x 40 KB of ring + barriers
// and 1.5 KB of epilogue parameters, ~219 KB (one block per SM);
// registers: the consumers' 232 hold the 96 accumulators of a QKV pass, or
// the key row's scores (128 at S > 128), P (64) and O (32) of a turn; no
// spills (ptxas -v).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "attention.cuh"
#include "hopper.cuh"
#include "ln_gemm.cuh"
#include "qkv_attention.cuh"
#include "quantize.cuh"

namespace {

constexpr int QA_CONSUMERS = 256;                // two warpgroups
constexpr int QA_THREADS = QA_CONSUMERS + 128;   // + the producer warpgroup (one thread issues)
constexpr int QA_STAGES = 3;
constexpr int QA_CHUNK = 128;                    // xn rows per QKV pass
constexpr int QA_ROW = 128;                      // bytes of a swizzled row
constexpr int QA_HEAD = uml::QKV_ATTN_MAX_S * QA_ROW;  // one of q, k, v: 32 KB
constexpr int QA_PANEL = 64 * QA_ROW;            // 64 rows: 8 KB
constexpr int QA_A_BYTES = QA_CHUNK * QA_ROW;    // 16 KB
constexpr int QA_B_BYTES = 3 * QA_PANEL;         // q, k, v slices: 24 KB
constexpr int QA_STAGE = QA_A_BYTES + QA_B_BYTES;
constexpr int QA_EPI_BYTES = 2 * 3 * 64 * 4;     // the head's b_eff and int8 column scales
// the base is aligned up to 1024 bytes (the swizzle atom) in the kernel
constexpr size_t QA_SMEM =
    1024 + 3 * QA_HEAD + (size_t)QA_STAGES * QA_STAGE + 16 * QA_STAGES + QA_EPI_BYTES;
// registers a thread: the producer warpgroup gives back what the consumers
// take (128 x 40 + 256 x 232 <= 65,536)
constexpr int QA_PRODUCER_REGS = 40;
constexpr int QA_CONSUMER_REGS = 232;

struct QaArgs {
  const float* bias;       // [3*H*64]
  const float* row_scale;  // int8: [B*S]
  const float* col_scale;  // int8: [3*H*64]
  __nv_bfloat16* qkv;      // [B, S, 3*H*64] or null
  void* attn;              // [B, q_rows, H*64] bf16, or fp32 (attn_f32)
  int B, S, K, H, q_rows;
  bool attn_f32;           // the int8 half quantizes the fp32 output
  float scale_log2;        // 1/sqrt(64) * log2(e)
};

// one stage of the QKV pass: four 32-byte steps along the swizzled rows
// (k16 bf16, k32 int8); NP = 3 projects q, k and v (n192), NP = 2 only k
// and v (n128 over the last two panels of the stage's B)
template <bool Q8, int NP, typename Acc>
__device__ __forceinline__ void qkv_stage_mma(Acc (&acc)[96], uint32_t sa, uint32_t sb) {
  const uint32_t sbp = sb + (3 - NP) * QA_PANEL;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = wgmma_desc(sa + kk * 32, 16, 1024);
    if constexpr (Q8) {
      const uint64_t db = wgmma_desc(sbp + kk * 32, 16, 1024);
      if constexpr (NP == 3)
        wgmma_ss_n192_s8(acc, da, db, 1);
      else
        wgmma_ss_n128_s8(*reinterpret_cast<int(*)[64]>(&acc[0]), da, db, 1);
    } else {
      // w_eff N-major: 16 contraction rows (2 KB) a step, panels 8 KB apart
      const uint64_t db = wgmma_desc(sbp + kk * 2048, QA_PANEL, 1024);
      if constexpr (NP == 3)
        wgmma_ss_n192<0, 1>(acc, da, db, 1);
      else
        wgmma_ss_n128<0, 1>(*reinterpret_cast<float(*)[64]>(&acc[0]), da, db, 1);
    }
  }
}

// The QKV pass of one 128-row chunk for this warpgroup (64 rows): every
// stage of the ring is waited on and released by both warpgroups, which
// issue products only where their rows hold any of the S rows (active).
template <bool Q8, int NP, typename Acc>
__device__ __forceinline__ void qkv_pass(Acc (&acc)[96], int& it, int kt_n, uint32_t ring,
                                         uint32_t sBar, int wg, int lane, bool active) {
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0;
  for (int t = 0; t < kt_n; ++t, ++it) {
    const int s = it % QA_STAGES;
    mbar_wait(sBar + 8 * s, (it / QA_STAGES) & 1);
    if (active) {
      const uint32_t sa = ring + s * QA_STAGE;
      wgmma_fence();
      qkv_stage_mma<Q8, NP>(acc, sa + wg * 64 * QA_ROW, sa + QA_A_BYTES);
      wgmma_commit();
      wgmma_wait<1>();  // stage t-1's products are done: release it
    }
    if (t > 0 && lane == 0) mbar_arrive(sBar + 8 * (QA_STAGES + (it - 1) % QA_STAGES));
  }
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  if (lane == 0) mbar_arrive(sBar + 8 * (QA_STAGES + (it - 1) % QA_STAGES));
}

// acc + bias (int8: q8_value's dequantization first) rounded to bf16 into
// the swizzled q, k, v rows of shared memory at `qkv_smem`; rows row_a and
// row_a + 8 of the item, columns of the panels 3 - NP .. 2.  epi holds the
// head's 192 b_eff values, then (int8) its 192 column scales.
template <bool Q8, int NP, typename Acc>
__device__ __forceinline__ void qkv_epilogue(const Acc (&acc)[96], const QaArgs& a,
                                             unsigned char* qkv_smem, const float* epi, int b,
                                             int row_a, int lane) {
  float rs[2] = {0.f, 0.f};  // int8: the rows' scales (0 for TMA's zero rows past S)
  if constexpr (Q8) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_a + 8 * r < a.S) rs[r] = a.row_scale[(long long)b * a.S + row_a + 8 * r];
  }
#pragma unroll
  for (int j = 0; j < 8 * NP; ++j) {
    const int p = 3 - NP + j / 8, c8 = j % 8;
    const int col = p * uml::ATT_D + 8 * c8 + 2 * (lane & 3);  // of the head's 192
    const float2 bb = *reinterpret_cast<const float2*>(epi + col);
    float2 cs = make_float2(0.f, 0.f);
    if constexpr (Q8) cs = *reinterpret_cast<const float2*>(epi + 3 * uml::ATT_D + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      float v0, v1;
      if constexpr (Q8) {
        v0 = uml::q8_value<uml::WGG_OUT_Q8_BF16>(acc[4 * j + 2 * r], rs[r], cs.x, bb.x, 0.f);
        v1 = uml::q8_value<uml::WGG_OUT_Q8_BF16>(acc[4 * j + 2 * r + 1], rs[r], cs.y, bb.y, 0.f);
      } else {
        v0 = acc[4 * j + 2 * r] + bb.x;
        v1 = acc[4 * j + 2 * r + 1] + bb.y;
      }
      *reinterpret_cast<uint32_t*>(qkv_smem + p * QA_HEAD + row * QA_ROW +
                                   ((c8 ^ (row & 7)) << 4) + 4 * (lane & 3)) =
          uml::bf16x2_bits(v0, v1);
    }
  }
}

template <bool Q8, int NC, bool CAUSAL>
__global__ void __launch_bounds__(QA_THREADS, 1)
qkv_attention_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, const QaArgs a) {
  using Acc = typename std::conditional<Q8, int, float>::type;
  constexpr int BK = Q8 ? 128 : 64;  // contraction per stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* qkv_smem = smem_raw + (base - raw);  // q, k, v: QA_HEAD bytes each
  const uint32_t sQ = base, sK = base + QA_HEAD, sV = base + 2 * QA_HEAD;
  const uint32_t ring = base + 3 * QA_HEAD;  // stage s: A, then B
  const uint32_t sBar = ring + QA_STAGES * QA_STAGE;
  // full[s] at sBar + 8 s, empty[s] at sBar + 8 (QA_STAGES + s); then the
  // epilogue's per-head parameters
  float* epi = reinterpret_cast<float*>(qkv_smem + (sBar + 16 * QA_STAGES - base));

  const int tid = threadIdx.x;
  const int hd = a.H * uml::ATT_D;
  const int items = a.B * a.H;
  const int mt = (a.S + 63) / 64;          // m64 tiles of an image's rows
  const int chunks = (mt + 1) / 2;         // 128-row QKV passes
  const int kt_n = (a.K + BK - 1) / BK;
  // the CLS block without a stash projects q for the first m64 tile only
  const bool q_all = a.q_rows == a.S || a.qkv != nullptr;

  if (tid == 0) {
    for (int s = 0; s < QA_STAGES; ++s) {
      mbar_init(sBar + 8 * s, 1);
      mbar_init(sBar + 8 * (QA_STAGES + s), QA_CONSUMERS / 32);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= QA_CONSUMERS) {
    // the producer warpgroup: one thread issues every copy, running ahead
    // into the next item while the consumers finish this one
    setmaxnreg_dec<QA_PRODUCER_REGS>();
    if (tid == QA_CONSUMERS) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / a.H, h = item % a.H;
        for (int c = 0; c < chunks; ++c)
          for (int t = 0; t < kt_n; ++t, ++it) {
            const int s = it % QA_STAGES;
            mbar_wait(sBar + 8 * (QA_STAGES + s), ((it / QA_STAGES) & 1) ^ 1);
            const uint32_t full = sBar + 8 * s;
            const uint32_t sa = ring + s * QA_STAGE;
            mbar_arrive_expect_tx(full, QA_STAGE);
            tma_load_3d(sa, &ta, full, t * BK, c * QA_CHUNK, b);
            for (int p = 0; p < 3; ++p) {
              const int n0 = p * hd + h * uml::ATT_D;
              if (Q8)
                tma_load_2d(sa + QA_A_BYTES + p * QA_PANEL, &tb, full, t * BK, n0);
              else
                tma_load_2d(sa + QA_A_BYTES + p * QA_PANEL, &tb, full, n0, t * BK);
            }
          }
      }
    }
    return;
  }

  setmaxnreg_inc<QA_CONSUMER_REGS>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid & 31;
  // q, k, v rows past the last m64 tile are never written: zero them once
  for (int i = tid; i < 3 * QA_HEAD / 16; i += QA_CONSUMERS)
    reinterpret_cast<uint4*>(qkv_smem)[i] = make_uint4(0, 0, 0, 0);

  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / a.H, h = item % a.H;
    // the head's b_eff (and int8 column scales), read by every epilogue
    if (tid < 3 * uml::ATT_D) {
      const int gcol = (tid / uml::ATT_D) * hd + h * uml::ATT_D + tid % uml::ATT_D;
      epi[tid] = a.bias[gcol];
      if (Q8) epi[3 * uml::ATT_D + tid] = a.col_scale[gcol];
    }
    named_bar_sync(1, QA_CONSUMERS);
    // QKV: chunk c, this warpgroup's rows 128 c + 64 wg .. + 63
    for (int c = 0; c < chunks; ++c) {
      const int row0 = c * QA_CHUNK + wg * 64;
      const bool active = row0 < a.S;
      const int row_a = row0 + 16 * warp + (lane >> 2);
      Acc acc[96];
      if (q_all || row0 == 0) {
        qkv_pass<Q8, 3>(acc, it, kt_n, ring, sBar, wg, lane, active);
        if (active) qkv_epilogue<Q8, 3>(acc, a, qkv_smem, epi, b, row_a, lane);
      } else {
        qkv_pass<Q8, 2>(acc, it, kt_n, ring, sBar, wg, lane, active);
        if (active) qkv_epilogue<Q8, 2>(acc, a, qkv_smem, epi, b, row_a, lane);
      }
    }
    fence_proxy_async();  // the rows written above are read by wgmma
    named_bar_sync(1, QA_CONSUMERS);

    if (a.qkv != nullptr) {
      // the stash: rows < S of q, k, v, 16 bytes a thread, unswizzled
      const int per_panel = a.S * 8;
      for (int i = tid; i < 3 * per_panel; i += QA_CONSUMERS) {
        const int p = i / per_panel, row = (i % per_panel) / 8, c8 = i % 8;
        const uint4 v = *reinterpret_cast<const uint4*>(qkv_smem + p * QA_HEAD + row * QA_ROW +
                                                        ((c8 ^ (row & 7)) << 4));
        *reinterpret_cast<uint4*>(a.qkv + ((long long)b * a.S + row) * 3 * hd + p * hd +
                                  h * uml::ATT_D + 8 * c8) = v;
      }
    }

    // attention: warpgroup wg takes query tiles wg, wg + 2, ... of 64 rows,
    // one a turn.  The softmax (an exp per score on the special-function
    // unit, the phase's bottleneck) runs in one warpgroup at a time: the
    // two pass the turn by named barriers 2 and 3 (warpgroup 0 first), so
    // one's softmax runs under the other's products.  Both take the same
    // number of turns, a warpgroup without a tile an empty one.  A warp
    // whose 16 rows are all past the stored ones skips the softmax: its P
    // is 0
    const int q_tiles = a.q_rows == 1 ? 1 : mt;
    const int turns = (q_tiles + 1) / 2;
    const int col0 = 2 * (lane & 3);
    // the softmax turn: wait for it on barrier 2 (warpgroup 0) or 3, pass it
    // on the other's; warpgroup 1's last turn passes none (warpgroup 0
    // waits on barrier 2 once a turn, one arrival ahead)
    auto take_turn = [&] {
      if (wg == 0) named_bar_sync(2, QA_CONSUMERS);
      else named_bar_sync(3, QA_CONSUMERS);
    };
    auto pass_turn = [&](int turn) {
      if (wg == 0) named_bar_arrive(3, QA_CONSUMERS);
      else if (turn + 1 < turns) named_bar_arrive(2, QA_CONSUMERS);
    };
    if (wg == 1) named_bar_arrive(2, QA_CONSUMERS);
    for (int turn = 0; turn < turns; ++turn) {
      const int qt = 2 * turn + wg;
      if (qt >= q_tiles) {  // an empty turn
        take_turn();
        pass_turn(turn);
        continue;
      }
      const int wrow0 = qt * 64 + 16 * warp;     // the warp's first row
      const int qrow0 = wrow0 + (lane >> 2);     // the thread's rows: + 0, + 8
      const bool live = wrow0 < a.q_rows;
      float sc[NC][64];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(sc[c], wgmma_desc(sQ + qt * 64 * QA_ROW + kk * 32, 16, 1024),
                        wgmma_desc(sK + c * 128 * QA_ROW + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) wgmma_fence_regs(sc[c]);
      take_turn();

      // the softmax, branch-free inside a chunk of 128 keys (one basic
      // block: the exps of the whole row interleave): masked scores are
      // -inf and their P is 0.  Each row's max over all its keys first (log2
      // units), then P = 2^(s scale_log2 - m) rounded to bf16 once and the
      // fp32 row sums.
      float l[2] = {0.f, 0.f};
      uint32_t pa[NC * 8][4];
      if (live) {
        float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          // key columns >= S (a chunk that S ends in) and, causal, above the
          // diagonal
          if (CAUSAL || (c + 1) * 128 > a.S) {
            const int lim = a.S - c * 128 - col0;
            const int diag = qrow0 - c * 128 - col0;
#pragma unroll
            for (int i = 0; i < 64; ++i) {
              const int off = 8 * (i / 4) + (i & 1), r = (i >> 1) & 1;
              if (off >= lim || (CAUSAL && off > diag + 8 * r)) sc[c][i] = -CUDART_INF_F;
            }
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int r = (i >> 1) & 1;
            mx[2 * r + ((i >> 2) & 1)] = fmaxf(mx[2 * r + ((i >> 2) & 1)], sc[c][i]);
          }
        }
        float m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m = fmaxf(mx[2 * r], mx[2 * r + 1]);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          m_use[r] = m == -CUDART_INF_F ? 0.f : m * a.scale_log2;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          // the thread's sum of a chunk in column order, then the chunks in
          // order: flash_attention.cu's sums over its 128-key tiles (the
          // scores, P and P V follow its order too, so the output matches
          // the chain's; four partial sums moved int8 integers)
          float ps[2] = {0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = 8 * kk + 2 * j, r = j & 1;
              const float p0 = ex2_approx(fmaf(sc[c][i], a.scale_log2, -m_use[r]));
              const float p1 = ex2_approx(fmaf(sc[c][i + 1], a.scale_log2, -m_use[r]));
              ps[r] += p0;
              ps[r] += p1;
              pa[c * 8 + kk][j] = uml::bf16x2_bits(p0, p1);
            }
          l[0] += ps[0];
          l[1] += ps[1];
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NC * 8; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) pa[kk][j] = 0u;
      }
      pass_turn(turn);
      // O = P V over every key row held (P is 0 past S, and the rows past
      // the last m64 tile are zero)
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      wgmma_fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NC * 8; ++kk)
        wgmma_rs_n64(o, pa[kk], wgmma_desc(sV + kk * 16 * QA_ROW, QA_HEAD, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(o);
      if (!live) continue;

      // out = O / max(l, 1e-30), query rows < q_rows only
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = qrow0 + 8 * r;
        if (row >= a.q_rows) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        const long long off = ((long long)b * a.q_rows + row) * hd + h * uml::ATT_D + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v0 = o[4 * j + 2 * r] * inv, v1 = o[4 * j + 2 * r + 1] * inv;
          if (a.attn_f32)
            *reinterpret_cast<float2*>(static_cast<float*>(a.attn) + off + 8 * j) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.attn) + off +
                                               8 * j) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    // both warpgroups are done with q, k, v (and the epilogue parameters)
    // before the next item overwrites them
    named_bar_sync(1, QA_CONSUMERS);
  }
}

template <bool Q8, int NC, bool CAUSAL>
cudaError_t launch_qa(const CUtensorMap& ta, const CUtensorMap& tb, const QaArgs& a,
                      cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(qkv_attention_kernel<Q8, NC, CAUSAL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)QA_SMEM);
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int items = a.B * a.H;
  qkv_attention_kernel<Q8, NC, CAUSAL>
      <<<items < sms ? items : sms, QA_THREADS, QA_SMEM, stream>>>(ta, tb, a);
  return cudaGetLastError();
}

}  // namespace

namespace uml {

cudaError_t launch_qkv_attention(const void* a, const float* row_scale, const void* w,
                                 const float* col_scale, const float* bias, __nv_bfloat16* qkv,
                                 void* attn, int B, int S, int K, int H, int q_rows, bool causal,
                                 bool q8, cudaStream_t stream, bool attn_f32) {
  if (B < 1 || H < 1 || S < 1 || S > QKV_ATTN_MAX_S || K < 64 || K % 64 != 0 ||
      (q_rows != S && q_rows != 1) || (causal && q_rows != S) || bias == nullptr ||
      attn == nullptr || (q8 && (row_scale == nullptr || col_scale == nullptr)) ||
      (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  for (const void* p : {a, w, static_cast<const void*>(qkv), static_cast<const void*>(attn)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  const int hd = H * ATT_D;
  const int esize = q8 ? 1 : 2;
  const CUtensorMapDataType type =
      q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ta, tb;
  {
    // a as [B, S, K]: boxes of one 128-byte row of the contraction by 128
    // rows of one image; rows >= S read as zeros
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)K * esize, (cuuint64_t)S * K * esize};
    const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), (cuuint32_t)QA_CHUNK, 1};
    if (!make_tensor_map(&ta, a, 3, dims, strides, box, type)) return cudaErrorInvalidValue;
  }
  {
    // bf16 w_eff [K, 3 H 64] N-major: boxes of 64 columns by 64 rows of the
    // contraction; int8 [3 H 64, K] K-major: 128 of the contraction by 64
    const cuuint64_t dims[2] = {q8 ? (cuuint64_t)K : (cuuint64_t)3 * hd,
                                q8 ? (cuuint64_t)3 * hd : (cuuint64_t)K};
    const cuuint64_t strides[1] = {dims[0] * esize};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), 64};
    if (!make_tensor_map(&tb, w, 2, dims, strides, box, type)) return cudaErrorInvalidValue;
  }
  QaArgs args;
  args.bias = bias;
  args.row_scale = row_scale;
  args.col_scale = col_scale;
  args.qkv = qkv;
  args.attn = attn;
  args.B = B;
  args.S = S;
  args.K = K;
  args.H = H;
  args.q_rows = q_rows;
  args.attn_f32 = attn_f32;
  args.scale_log2 = 0.125f * 1.4426950408889634f;
  const int nc = S > 128 ? 2 : 1;  // 128-key chunks of the score row
#define UML_QA(Q, N, C) \
  if (q8 == Q && nc == N && causal == C) return launch_qa<Q, N, C>(ta, tb, args, stream);
  UML_QA(false, 1, false)
  UML_QA(false, 1, true)
  UML_QA(false, 2, false)
  UML_QA(false, 2, true)
  UML_QA(true, 1, false)
  UML_QA(true, 1, true)
  UML_QA(true, 2, false)
  UML_QA(true, 2, true)
#undef UML_QA
  return cudaErrorInvalidValue;
}

}  // namespace uml

// The fused kernel on its own, for the card tests and chip_smoke.py (the
// half-blocks launch it inside their own C calls, blocks.cuh).
//   bf16: x [B, S, K]; w_eff [K, 3*H*64]; b_eff [3*H*64] fp32; xn [B*S, K]
//   scratch (the LN pre-pass); qkv [B, S, 3*H*64] or null; attn [B,
//   q_rows, H*64].
extern "C" int uml_qkv_attention(const void* x, const void* w_eff, const void* b_eff, void* xn,
                                 void* qkv, void* attn, int B, int S, int K, int H, int causal,
                                 int q_rows, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      uml::launch_ln_rows(static_cast<const bf16*>(x), static_cast<bf16*>(xn), B * S, K, eps, st);
  if (err != cudaSuccess) return (int)err;
  return (int)uml::launch_qkv_attention(xn, nullptr, w_eff, nullptr,
                                        static_cast<const float*>(b_eff),
                                        static_cast<bf16*>(qkv), attn, B, S, K, H, q_rows,
                                        causal != 0, false, st, false);
}

//   int8: x [B, S, K] bf16; wq [3*H*64, K] int8 (K-major); wsc, b_eff
//   [3*H*64] fp32; q8 [B*S*K] int8 and qscale [B*S] scratch
//   (ln_quantize_rows); attn [B, S, H*64] fp32 (what the int8 half
//   quantizes for its out-projection).
extern "C" int uml_qkv_attention_q8(const void* x, const void* wq, const void* wsc,
                                    const void* b_eff, void* q8, void* qscale, void* attn,
                                    int B, int S, int K, int H, int causal, float eps,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = uml::launch_ln_quantize_rows(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q8),
      static_cast<float*>(qscale), B * S, K, eps, st);
  if (err != cudaSuccess) return (int)err;
  return (int)uml::launch_qkv_attention(
      q8, static_cast<const float*>(qscale), wq, static_cast<const float*>(wsc),
      static_cast<const float*>(b_eff), nullptr, attn, B, S, K, H, S, causal != 0, true, st,
      true);
}
