// uml_flash_attention: softmax(q k^T / sqrt(D)) v with an online softmax,
// q, k, v, out [B, H, S, D] views with any batch, head and row strides (the
// last axis contiguous), bf16, D 64 or 128, any S, causal or not.
//
// Replaces uml_tpu/ops/attention.py::_flash_kernel, and is the one
// attention core of the fused blocks too (uml::launch_flash_attention,
// declared in attention.cuh): the attention of _block_kernel,
// _block_cls_kernel, _block_kernel_stash, _block_bwd_kernel's recompute,
// _tower_kernel, _block_q8_kernel, _tower_q8_kernel and _kernel, read in
// place from the packed qkv [B, S, 3*H*64].  The CLS block takes a
// one-row query view (Sq = 1 query rows against S keys): one 128-row query
// tile per (image, head), TMA's zero fill for its rows 1..127, only row 0
// stored.  What bounds it on the
// H100: per (batch, head) it reads q, k, v and writes out once (4 S D 2
// bytes) for 4 S^2 D FLOPs (half when causal), S/4 FLOP per byte: the
// bytes at S = 197 ([64,12,197,64]: 77.5 MB, 23 us), the tensor cores from
// S ~ 1200 up ([8,16,2048,64]: 137 GFLOP, 139 us at 989 TFLOP/s).  So the
// products have to run at the wgmma rate and nothing may stall them:
//
// * One block per (batch*head, 128-query tile), three warpgroups' worth of
//   roles: two consumer warpgroups of 64 query rows each, one producer
//   warp.  The producer issues TMA loads (cp.async.bulk.tensor, 128-byte
//   swizzle) of Q once and of K/V tiles into a ring of FA_STAGES stages,
//   each stage with a "full" mbarrier (TMA bytes landed) and an "empty"
//   one (both consumers done), so tile t+1.. load while tile t computes.
//   TMA's zero fill covers the ragged last tile and the query rows >= S;
//   the masks still apply.  The tensor maps carry the strides, so a packed
//   qkv [B, S, 3, H, D] is read in place.
// * S = Q K^T is one wgmma chain per key tile (m64nBKk16, Q and K from
//   shared memory, K-major both), the fp32 scores in registers.
// * The softmax runs on those registers: in the wgmma accumulator layout a
//   thread holds two fixed rows, so a row max or sum is a thread-local
//   reduction and two __shfl_xor within the quad; the rescale by
//   exp(m_old - m_new) multiplies the thread's own output registers.
//   exp2 with log2(e) folded into the scale.
// * O += P V is a second wgmma chain with P as the register A operand,
//   converted in place from the score fragment to bf16 (the accumulator
//   and A fragments map rows and columns to threads alike), and V from
//   shared memory MN-major.  No score, P or factor tile touches shared
//   memory.
// * The softmax costs about as much as the products (an exp per score on
//   the special-function unit), so it must overlap them: iteration t
//   issues S(t) and P(t-1) V(t-1) together and computes the softmax of
//   tile t while P V runs, and the two warpgroups take turns at issuing
//   (named barriers), so one's softmax runs under the other's products.
// * Key tile: 128 keys at D = 64, 64 at D = 128 (scores 64xBK and output
//   64xD fp32 per warpgroup, P as bf16: ~130 registers a thread either way).
//
// Numerics as attention.py:90-147: fp32 scores and statistics, key
// columns >= S (and, causal, above the diagonal) masked, P rounded to bf16
// before P.V, l the sum of the unrounded P, out = acc / max(l, 1e-30).  A
// row with no valid key yet keeps m = -inf, l = 0, P = 0.
// * MAX_FIRST (the fused blocks): the TPU block kernels take the softmax
//   of a whole row at once, so P is rounded to bf16 once, against the
//   row's final max, and attention_plain computes it so.  The online order
//   rounds P(t) against the running max and rescales it later: the same
//   error in size, but other roundings, and the int8 blocks' quantized
//   output moves by up to two steps with them.  So these blocks first walk
//   the K tiles alone for each row's max (the scores once more, no V), and
//   the second walk's m never grows (alpha = 1).  The stand-alone row 13
//   keeps the one online walk.
// The causal block skip of attention.py:136-141: a block stops at the key
// tile of its last row (at D = 128 the first warpgroup also takes that
// tile, all masked, to keep the turns of the two in step); causal blocks
// start heavy tiles first (the last query tile is scheduled first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

constexpr int FA_BQ = 128;                      // query rows per block
constexpr int FA_CONSUMERS = 256;               // two warpgroups x 64 rows
constexpr int FA_THREADS = FA_CONSUMERS + 32;   // + the producer warp
constexpr int FA_STAGES = 4;                    // K/V ring depth (2 and 3 measured slower)

template <int D>
struct FaCfg {
  static constexpr int BK = D == 64 ? 128 : 64;  // keys per tile
  static constexpr int PANELS = D / 64;          // 128-byte column panels of a row
  static constexpr int Q_PANEL = FA_BQ * 128;    // bytes of one panel of the Q tile
  static constexpr int KV_PANEL = BK * 128;      // ... of a K or V tile
  static constexpr int Q_BYTES = Q_PANEL * PANELS;
  static constexpr int KV_BYTES = KV_PANEL * PANELS;
  // the base is aligned up to 1024 bytes (the swizzle atom) in the kernel
  static constexpr size_t SMEM = 1024 + Q_BYTES + (size_t)FA_STAGES * 2 * KV_BYTES
                                 + 8 * (2 * FA_STAGES + 1);
};

template <int D>
__device__ __forceinline__ void scores_mma(float (&s)[FaCfg<D>::BK / 2], uint32_t q,
                                           uint32_t k) {
  using C = FaCfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns of D: panel kk/4, 32 bytes into its swizzled rows
    const uint32_t off_q = (kk / 4) * C::Q_PANEL + (kk % 4) * 32;
    const uint32_t off_k = (kk / 4) * C::KV_PANEL + (kk % 4) * 32;
    const uint64_t da = wgmma_desc(q + off_q, 16, 1024);
    const uint64_t db = wgmma_desc(k + off_k, 16, 1024);
    if constexpr (C::BK == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
}

template <int D>
__device__ __forceinline__ void pv_mma(float (&o)[D / 2],
                                       const uint32_t (&p)[FaCfg<D>::BK / 16][4],
                                       uint32_t v) {
  using C = FaCfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    // 16 key rows of V (2048 bytes); N = D spans PANELS panels
    const uint64_t db = wgmma_desc(v + kk * 16 * 128, C::KV_PANEL, 1024);
    if constexpr (D == 64)
      wgmma_rs_n64(o, p[kk], db);
    else
      wgmma_rs_n128(o, p[kk], db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the scores of edge tiles: key columns >= S and, causal, above the
// diagonal to -inf
template <int D, bool CAUSAL>
__device__ __forceinline__ void mask_tile(float (&sc)[FaCfg<D>::BK / 2], int k0, int S,
                                          int wg_first, int row0, int col0) {
  constexpr int BK = FaCfg<D>::BK;
  if (k0 + BK > S || (CAUSAL && k0 + BK - 1 > wg_first)) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + col0 + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (col >= S || (CAUSAL && col > row)) sc[i] = -CUDART_INF_F;
    }
  }
}

template <int D, bool CAUSAL, bool MAX_FIRST>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, void* __restrict__ out,
                       int H, int Sq, int S, long long o_b, long long o_h, long long o_r,
                       float scale_log2, bool out_f32) {
  using C = FaCfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage s: K at sKV + 2 s KV_BYTES, V after it
  const uint32_t sBar = sKV + FA_STAGES * 2 * C::KV_BYTES;
  const uint32_t q_bar = sBar + 8 * 2 * FA_STAGES;
  // full[s] at sBar + 8 s, empty[s] at sBar + 8 (FA_STAGES + s)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = CAUSAL ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * FA_BQ;
  const int tiles_all = (S + BK - 1) / BK;
  const int n_tiles = CAUSAL ? min(tiles_all, (q0 + FA_BQ - 1) / BK + 1) : tiles_all;
  const int u0 = MAX_FIRST ? n_tiles : 0;  // ring slots of the max walk

  if (tid == 0) {
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(sBar + 8 * s, 1);
      mbar_init(sBar + 8 * (FA_STAGES + s), FA_CONSUMERS);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= FA_CONSUMERS) {
    // the producer warp: one lane issues every copy; ring slot u holds
    // K tile u of the max walk (u < u0), then K and V tile u - u0
    if (tid == FA_CONSUMERS) {
      mbar_arrive_expect_tx(q_bar, C::Q_BYTES);
      for (int p = 0; p < C::PANELS; ++p)
        tma_load_4d(sQ + p * C::Q_PANEL, &tq, q_bar, 64 * p, q0, h, b);
      for (int u = 0; u < u0 + n_tiles; ++u) {
        const int s = u % FA_STAGES, t = u < u0 ? u : u - u0;
        const bool with_v = u >= u0;
        mbar_wait(sBar + 8 * (FA_STAGES + s), ((u / FA_STAGES) & 1) ^ 1);
        const uint32_t full = sBar + 8 * s;
        const uint32_t k_dst = sKV + s * 2 * C::KV_BYTES;
        mbar_arrive_expect_tx(full, (with_v ? 2 : 1) * C::KV_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_4d(k_dst + p * C::KV_PANEL, &tk, full, 64 * p, t * BK, h, b);
          if (with_v)
            tma_load_4d(k_dst + C::KV_BYTES + p * C::KV_PANEL, &tv, full, 64 * p, t * BK, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows q0 + 64 wg .. + 63 of the block's tile.
  // Iteration t issues S(t) = Q K(t)^T and O += P(t-1) V(t-1) back to back,
  // then runs the softmax of tile t while P V still runs; the two
  // warpgroups take turns at issuing (named barriers 1 and 2), so one's
  // softmax overlaps the other's products.
  const int wg = tid / 128;
  const int lane = tid & 31;
  const int row0 = q0 + wg * 64 + ((tid % 128) / 32) * 16 + (lane >> 2);  // and row0 + 8
  const int col0 = 2 * (lane & 3);
  const int wg_first = q0 + wg * 64;
  const uint32_t q_wg = sQ + wg * 64 * 128;  // the warpgroup's rows in each panel
  // ring slot u0 + t holds K and V tile t of the softmax walk
  auto stage_kv = [&](int t) { return sKV + ((u0 + t) % FA_STAGES) * 2 * C::KV_BYTES; };
  auto empty_bar = [&](int t) { return sBar + 8 * (FA_STAGES + (u0 + t) % FA_STAGES); };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // m in log2 units (the scores times scale_log2); alpha rescales O to the
  // newest m before the next P V
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  uint32_t pa[BK / 16][4];
  float sc[BK / 2];
  mbar_wait(q_bar, 0);
  if constexpr (MAX_FIRST) {
    // the max walk: each row's max over all its keys, in log2 units
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int u = 0; u < u0; ++u) {
      mbar_wait(sBar + 8 * (u % FA_STAGES), (u / FA_STAGES) & 1);
      wgmma_fence();
      scores_mma<D>(sc, q_wg, sKV + (u % FA_STAGES) * 2 * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(sc);
      mbar_arrive(sBar + 8 * (FA_STAGES + u % FA_STAGES));
      mask_tile<D, CAUSAL>(sc, u * BK, S, wg_first, row0, col0);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m[r] = mx[r] * scale_log2;
    }
  }
  if (wg == 1) named_bar_arrive(1, FA_CONSUMERS);  // warpgroup 0 issues first

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    mbar_wait(sBar + 8 * ((u0 + t) % FA_STAGES), ((u0 + t) / FA_STAGES) & 1);
    named_bar_sync(1 + wg, FA_CONSUMERS);
    wgmma_fence();
    scores_mma<D>(sc, q_wg, stage_kv(t));
    wgmma_commit();
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      wgmma_fence_regs(o);
      wgmma_fence();
      pv_mma<D>(o, pa, stage_kv(t - 1) + C::KV_BYTES);
      wgmma_commit();
    }
    if (wg == 1 ? t + 1 < n_tiles : true) named_bar_arrive(2 - wg, FA_CONSUMERS);
    if (t > 0)
      wgmma_wait<1>();  // S(t) done; P(t-1) V(t-1) may still run
    else
      wgmma_wait<0>();
    wgmma_fence_regs(sc);

    // mask (edge tiles only), row max over the thread's columns
    mask_tile<D, CAUSAL>(sc, k0, S, wg_first, row0, col0);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      // a row with no valid key so far: m stays -inf, P = 0, l = 0
      m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      // MAX_FIRST: m is the row's max already
      alpha[r] = MAX_FIRST ? 1.f : ex2_approx(m[r] - m_use[r]);
      m[r] = m_new;
    }
    // P = 2^(s scale_log2 - m); l sums the fp32 P (over the thread's
    // columns: the quad's partial sums are added once, at the end)
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2_approx(fmaf(sc[i], scale_log2, -m_use[r]));
      ps[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];

    wgmma_wait<0>();  // P(t-1) V(t-1) done: its registers and stage are free
    wgmma_fence_regs(o);
    if (t > 0) mbar_arrive(empty_bar(t - 1));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
  }
  // the last tile's P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  wgmma_fence_regs(o);
  wgmma_fence();
  pv_mma<D>(o, pa, stage_kv(n_tiles - 1) + C::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(o);
  mbar_arrive(empty_bar(n_tiles - 1));

  // out = acc / max(l, 1e-30), two bf16 (or fp32: out_f32) a store, query
  // rows < Sq only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const long long off = b * o_b + h * o_h + row * o_r + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float v0 = o[4 * j + 2 * r] * inv, v1 = o[4 * j + 2 * r + 1] * inv;
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off + 8 * j) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off + 8 * j) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
}

// -- host --------------------------------------------------------------------

// a [B, H, S, D] bf16 view (strides in elements) as a 4-d tensor map of
// (D, S, H, B), boxes of 64 columns x box_rows rows, 128-byte swizzle;
// out-of-bounds rows read as zeros
bool make_map(CUtensorMap* map, const void* ptr, long long B, int H, int S, int D,
              long long sb, long long sh, long long sr, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sr * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return make_tensor_map(map, ptr, 4, dims, strides, box);
}

template <int D, bool CAUSAL, bool MAX_FIRST>
cudaError_t launch_flash(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         void* out, long long B, int H, int Sq, int S, long long o_b,
                         long long o_h, long long o_r, cudaStream_t stream, bool out_f32) {
  const int smem = (int)FaCfg<D>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<D, CAUSAL, MAX_FIRST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + FA_BQ - 1) / FA_BQ));
  // 1 / sqrt(D) and log2(e) in one factor
  const float scale_log2 = (D == 64 ? 0.125f : 0.08838834764831845f) * 1.4426950408889634f;
  flash_attention_kernel<D, CAUSAL, MAX_FIRST><<<grid, FA_THREADS, smem, stream>>>(
      tq, tk, tv, out, H, Sq, S, o_b, o_h, o_r, scale_log2, out_f32);
  return cudaGetLastError();
}

}  // namespace

namespace uml {

cudaError_t launch_flash_attention(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, void* out, long long B, int H, int Sq,
                                   int S, int D, bool causal, long long q_b, long long q_h,
                                   long long q_r, long long k_b, long long k_h, long long k_r,
                                   long long v_b, long long v_h, long long v_r, long long o_b,
                                   long long o_h, long long o_r, bool max_first,
                                   cudaStream_t stream, bool out_f32) {
  const long long q_tiles = (Sq + FA_BQ - 1) / FA_BQ;
  if ((D != 64 && D != 128) || B < 1 || H < 1 || S < 1 || Sq < 1 || Sq > S ||
      (causal && Sq != S) || B * H > 2147483647LL || q_tiles > 65535)
    return cudaErrorInvalidValue;
  const long long strides[12] = {q_b, q_h, q_r, k_b, k_h, k_r, v_b, v_h, v_r, o_b, o_h, o_r};
  for (long long st : strides)
    if (st % 8 != 0) return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(q), static_cast<const void*>(k),
                        static_cast<const void*>(v), static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  const int bk = D == 64 ? FaCfg<64>::BK : FaCfg<128>::BK;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, H, Sq, D, q_b, q_h, q_r, FA_BQ) ||
      !make_map(&tk, k, B, H, S, D, k_b, k_h, k_r, bk) ||
      !make_map(&tv, v, B, H, S, D, v_b, v_h, v_r, bk))
    return cudaErrorInvalidValue;
#define UML_FLASH(d, c, mf)                                                          \
  if (D == d && causal == c && max_first == mf)                                      \
    return launch_flash<d, c, mf>(tq, tk, tv, out, B, H, Sq, S, o_b, o_h, o_r, stream, out_f32);
  UML_FLASH(64, false, false)
  UML_FLASH(64, true, false)
  UML_FLASH(128, false, false)
  UML_FLASH(128, true, false)
  // the fused blocks' head dim
  UML_FLASH(64, false, true)
  UML_FLASH(64, true, true)
#undef UML_FLASH
  return cudaErrorInvalidValue;
}

}  // namespace uml

// q, k, v, out: [B, H, S, D] bf16 views; *_b, *_h, *_r their batch, head
// and row strides in elements (multiples of 8; the last axis contiguous;
// every pointer 16-byte aligned)
extern "C" int uml_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   long long B, int H, int S, int D, int causal,
                                   long long q_b, long long q_h, long long q_r, long long k_b,
                                   long long k_h, long long k_r, long long v_b, long long v_h,
                                   long long v_r, long long o_b, long long o_h, long long o_r,
                                   void* stream) {
  using bf16 = __nv_bfloat16;
  return (int)uml::launch_flash_attention(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      out, B, H, S, S, D, causal != 0, q_b, q_h, q_r, k_b, k_h, k_r, v_b, v_h, v_r, o_b, o_h,
      o_r, false, static_cast<cudaStream_t>(stream), false);
}
