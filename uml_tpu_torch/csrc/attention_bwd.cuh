// attention backward from the stashed qkv, and the LayerNorm backward row
// pass: the kernel work of the TPU's stash backward of the attention half
// (uml_tpu/ops/fused_attention.py::_block_bwd_stash_kernel, the body of
// _block_bwd_one_stash, :1017-1103), and the LN backward of the
// non-CLS attention and MLP backwards.
//
//   qkv   [B, S, 3*H*64] bf16, the forward's stash (q at h*64, k at H*64 +
//         h*64, v at 2*H*64 + h*64; the port's stash includes b_eff)
//   dattn [B, S, H*64] bf16, dO = g . wo^T (ln_gemm with TRANS_B)
//   dqkv  [B, S, 3*H*64] bf16, written here
//   stats [B, H, S] float4 (m, 1/l, D, 0), written by the dq pass and read
//         by the dkv pass
//
// The softmax statistics are recomputed from the stash in fp32: the
// scores, the row max m, l = rowsum(exp(s - m)), exact expf (the forward
// takes the same statistics online with ex2.approx; the backward holds to
// the plain version's exp).  With p = exp(s - m) / l:
//   dV = p^T dO,  dP = dO V^T,  D = rowsum(p * dP),  dS = p * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q
// p and dS are rounded to bf16 before their products (the tensor cores
// take bf16), every product accumulates in fp32, dq/dk/dv are rounded to
// bf16 once.  D is the reference's rowsum(p * dP) in fp32, not
// FlashAttention-2's rowsum(dO * O) of the bf16 output.  (The TPU kernel
// uses the max-free exp2 with its clamp at 96 and the head-pair lane
// masks; both are TPU layout choices.)
//
// Two kernels split the work the FlashAttention-2 way, because Hopper's
// blocks cannot carry a sum between them as the TPU's sequential grid
// does; no atomics, no block waits on another, so the sums are the same
// on every run.  Both run on wgmma with their operands brought in by TMA
// (hopper.cuh), and both stream the other side in 64-row tiles, so S has
// no bound:
//   attn_bwd_dq:  one block per (image, head, 64 query rows): one
//     warpgroup, Q and dO of its rows resident (TMA, 128-byte swizzle), K
//     and V tiles through a ring of AB_STAGES stages.  Walk 1 over the key
//     tiles: S = Q K^T and dP = dO V^T (wgmma, both operands from shared
//     memory, K-major), the row's m, l and D's numerator sum_j exp(s_j -
//     m) dP_j taken online on the accumulator registers (a thread holds
//     two rows: thread-local partial sums, the max reduced in its quad,
//     the partials rescaled like l when m grows and added in the quad at
//     the end).  Walk 2 over the same tiles: S and dP again, dS = p (dP -
//     D) in registers, rounded to bf16 as the register A operand of dQ +=
//     dS K, K read MN-major from the same stage (the forward's P V).  It
//     writes dq and each row's (m, 1/l, D).
//   attn_bwd_dkv: one block per (image, head, 64 key rows): K and V
//     resident, Q, dO and the statistics rows of each query tile through
//     the ring.  S^T = K Q^T and dP^T = V dO^T (wgmma from shared memory),
//     p^T and dS^T in registers from the statistics, then dV += p^T dO and
//     dK += dS^T Q with p^T and dS^T as register A operands, dO and Q
//     MN-major from the stage that fed S^T and dP^T.
// In both, thread 0 of the warpgroup is the producer: a stage is refilled
// as soon as every warp has passed it (a block barrier), AB_STAGES - 1
// tiles ahead of the one in use.
// What bounds them on the H100: per (image, head) at S = 197 (256 with
// the tiles' padding) the dq pass does 5 and the dkv pass 4 products of
// 2 x 256 x 256 x 64 FLOPs (~58 GFLOP in all at ViT-B/16 B=64, ~59 us at
// 989 TFLOP/s) over ~60 MB of qkv, dO and dqkv (~18 us), plus one exact
// expf per score in each of the three softmax walks: short tiles, little
// reuse, so latency rather than either peak.  The design keeps every
// score on the accumulator registers (no score, p or dS tile touches
// shared memory, unlike the wmma kernels these replace), overlaps one
// block's softmax with another's products by running three one-warpgroup
// blocks on each SM (~66-68 KB of shared memory each), and lets TMA bring
// the next tiles while a tile computes.
//
// The CLS-only backward (one live query row per image) has its own
// kernels in cls_bwd.cuh.
//
// ln_bwd: dx = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)) + g, the LN
// backward of the prologue (the LN scale/bias are folded into W_eff, so
// the raw LN's backward is all that is left), one warp per row, with the
// statistics of ln_gemm.cuh's ln_row_stats.  It writes xn (bf16), which
// the dW_eff product outside reads, unless the caller passes no xn
// buffer: where the LN pre-pass of the engine already wrote it (the
// recompute backward, the MLP dW backward), ln_bwd skips the copy, and the
// two are the same values (the same statistics, the same rounding).
// With g null it leaves the residual out (the MLP backward of
// _mlp_bwd_kernel, whose residual is added outside).
//
// The __global__ functions here are static or templates: the header is
// included by more than one .cu file (attn_block_bwd.cu, mlp_block_bwd.cu).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include "attention.cuh"
#include "hopper.cuh"
#include "ln_gemm.cuh"

namespace uml {

constexpr int AB_ROWS = 64;          // rows of a block's own tile and of each streamed tile
constexpr int AB_THREADS = 128;      // one warpgroup; thread 0 also issues the copies
constexpr int AB_STAGES = 3;         // ring depth
constexpr int AB_BLOCKS_PER_SM = 3;
constexpr int AB_TILE = AB_ROWS * ATT_D * 2;          // a 64 x 64 bf16 tile: 8 KB
constexpr int AB_STATS = AB_ROWS * 16;                // 64 rows of (m, 1/l, D, 0): 1 KB
constexpr int AB_DKV_STAGE = 2 * AB_TILE + AB_STATS;  // Q, dO, stats: the tiles stay 1024-aligned
// the base is aligned up to 1024 bytes (the swizzle atom) in the kernels
constexpr size_t AB_DQ_SMEM =
    1024 + 2 * AB_TILE + (size_t)AB_STAGES * 2 * AB_TILE + 8 * (AB_STAGES + 1);
constexpr size_t AB_DKV_SMEM =
    1024 + 2 * AB_TILE + (size_t)AB_STAGES * AB_DKV_STAGE + 8 * (AB_STAGES + 1);

// d (+)= A . B^T over the head dim: A and B 64 x 64 tiles with the head
// dim contiguous (K-major both), m64n64k16 in four steps
static __device__ __forceinline__ void ab_mma_nt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < ATT_D / 16; ++kk)
    wgmma_ss_n64<0, 0>(d, wgmma_desc(a + kk * 32, 16, 1024), wgmma_desc(b + kk * 32, 16, 1024),
                       kk > 0);
}

// d += A . B: A 64 x 64 bf16 in registers (four k16 fragments), B a 64 x 64
// tile whose rows run along the contraction (MN-major, as the forward's V)
static __device__ __forceinline__ void ab_mma_rn(float (&d)[32], const uint32_t (&a)[4][4],
                                                 uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < AB_ROWS / 16; ++kk)
    wgmma_rs_n64(d, a[kk], wgmma_desc(b + kk * 16 * 128, AB_TILE, 1024));
}

// the accumulator's values of column block j, row half r (its elements 4j
// + 2r, 4j + 2r + 1) into the matching A fragment (hopper.cuh's layouts)
static __device__ __forceinline__ void ab_pack(uint32_t (&f)[4][4], int j, int r, float lo,
                                               float hi) {
  f[j / 2][2 * (j & 1) + r] = bf16x2_bits(lo, hi);
}

// a thread's rows row0, row0 + 8 of an m64n64 fp32 accumulator, times mul,
// to dst[row * ld + col] as bf16 (rows < row_end): the values are exchanged
// within each quad of lanes, so a lane stores 8 bytes and a quad 32
// contiguous bytes, whole sectors (wgmma_gemm.cuh's epilogue does the same)
static __device__ __forceinline__ void ab_store(const float (&acc)[32], float mul,
                                                __nv_bfloat16* dst, long long ld, int row0,
                                                int row_end, int lane) {
  const int q = lane & 3;
  const int src = (lane & ~3) | (2 * (q & 1));
#pragma unroll
  for (int j0 = 0; j0 < ATT_D / 8; j0 += 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t p0 = bf16x2_bits(acc[4 * j0 + 2 * r] * mul, acc[4 * j0 + 2 * r + 1] * mul);
      const uint32_t p1 =
          bf16x2_bits(acc[4 * j0 + 4 + 2 * r] * mul, acc[4 * j0 + 4 + 2 * r + 1] * mul);
      const uint32_t a0 = __shfl_sync(0xffffffffu, p0, src);
      const uint32_t a1 = __shfl_sync(0xffffffffu, p0, src + 1);
      const uint32_t b0 = __shfl_sync(0xffffffffu, p1, src);
      const uint32_t b1 = __shfl_sync(0xffffffffu, p1, src + 1);
      const int row = row0 + 8 * r;
      if (row < row_end)
        *reinterpret_cast<uint2*>(dst + (long long)row * ld + 8 * j0 + 4 * q) =
            q < 2 ? make_uint2(a0, a1) : make_uint2(b0, b1);
    }
  }
}

template <bool CAUSAL>
__global__ void __launch_bounds__(AB_THREADS, AB_BLOCKS_PER_SM)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   __nv_bfloat16* __restrict__ dqkv, float4* __restrict__ stats, int S, int H,
                   float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + AB_TILE;
  const uint32_t sKV = base + 2 * AB_TILE;              // stage s: K at sKV + 2 s TILE, V after
  const uint32_t sBar = sKV + AB_STAGES * 2 * AB_TILE;  // full[s] at sBar + 8 s
  const uint32_t q_bar = sBar + 8 * AB_STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // causal: the query tiles with the most keys first
  const int q0 = (CAUSAL ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y) * AB_ROWS;
  // causal: key tiles past the tile's last query row have p = 0
  const int n_tiles =
      CAUSAL ? (min(S, q0 + AB_ROWS) - 1) / AB_ROWS + 1 : (S + AB_ROWS - 1) / AB_ROWS;
  const int slots = 2 * n_tiles;  // slot u: key tile u % n_tiles of walk u / n_tiles
  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  auto load_kv = [&](int u) {
    const int s = u % AB_STAGES;
    const uint32_t full = sBar + 8 * s, dst = sKV + s * 2 * AB_TILE;
    mbar_arrive_expect_tx(full, 2 * AB_TILE);
    tma_load_4d(dst, map_k, full, 0, (u % n_tiles) * AB_ROWS, h, b);
    tma_load_4d(dst + AB_TILE, map_v, full, 0, (u % n_tiles) * AB_ROWS, h, b);
  };
  if (tid == 0) {
    for (int s = 0; s < AB_STAGES; ++s) mbar_init(sBar + 8 * s, 1);
    mbar_init(q_bar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(q_bar, 2 * AB_TILE);
    tma_load_4d(sQ, &tq, q_bar, 0, q0, h, b);
    tma_load_4d(sO, &tdo, q_bar, 0, q0, h, b);
    for (int u = 0; u < min(slots, AB_STAGES); ++u) load_kv(u);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid & 31;
  const int row0 = q0 + 16 * warp + (lane >> 2);  // the thread's query rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  // per row: the running max (scaled scores), its stand-in for exp (0
  // while no key is valid), the partial sums of exp(s - m) and of exp(s -
  // m) dP; after walk 1 1/l and D
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, mu[2] = {0.f, 0.f};
  float l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float dq[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(q_bar, 0);
  for (int u = 0; u < slots; ++u) {
    const int s = u % AB_STAGES, k0 = (u % n_tiles) * AB_ROWS;
    const uint32_t sK = sKV + s * 2 * AB_TILE;
    mbar_wait(sBar + 8 * s, (u / AB_STAGES) & 1);
    wgmma_fence();
    ab_mma_nt(sc, sQ, sK);
    ab_mma_nt(dp, sO, sK + AB_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(sc);
    wgmma_fence_regs(dp);
    // edge tiles: key columns >= S and, causal, above the diagonal to -inf
    if (k0 + AB_ROWS > S || (CAUSAL && k0 + AB_ROWS - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i / 4) + col0 + (i & 1);
        if (col >= S || (CAUSAL && col > row0 + 8 * ((i >> 1) & 1))) sc[i] = -CUDART_INF_F;
      }
    }
    if (u < n_tiles) {
      // walk 1: the quad's rows share m, so the thread partials rescale alike
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale);
        mu[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float alpha = expf(m[r] - mu[r]);  // 0 while m was -inf
        l[r] *= alpha;
        dn[r] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float e = expf(sc[i] * scale - mu[r]);
        l[r] += e;
        dn[r] += e * dp[i];
      }
      if (u == n_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          dn[r] += __shfl_xor_sync(0xffffffffu, dn[r], 1);
          dn[r] += __shfl_xor_sync(0xffffffffu, dn[r], 2);
          linv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
          dsum[r] = dn[r] * linv[r];
        }
      }
    } else {
      // walk 2: dS = p (dP - D) as the A operand of dQ += dS K
      uint32_t f[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r;
          const float p0 = expf(sc[i] * scale - mu[r]) * linv[r];
          const float p1 = expf(sc[i + 1] * scale - mu[r]) * linv[r];
          ab_pack(f, j, r, p0 * (dp[i] - dsum[r]), p1 * (dp[i + 1] - dsum[r]));
        }
      }
      wgmma_fence();
      ab_mma_rn(dq, f, sK);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(dq);
    }
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && u + AB_STAGES < slots) load_kv(u + AB_STAGES);
  }
  const long long ld = 3LL * H * ATT_D;
  ab_store(dq, scale, dqkv + (long long)b * S * ld + h * ATT_D, ld, row0, S, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S)
        stats[((long long)b * H + h) * S + row0 + 8 * r] =
            make_float4(mu[r], linv[r], dsum[r], 0.f);
  }
}

template <bool CAUSAL>
__global__ void __launch_bounds__(AB_THREADS, AB_BLOCKS_PER_SM)
attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tst, __nv_bfloat16* __restrict__ dqkv,
                    int S, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + AB_TILE;
  const uint32_t sRing = base + 2 * AB_TILE;  // stage s: Q, dO, stats at sRing + s DKV_STAGE
  const uint32_t sBar = sRing + AB_STAGES * AB_DKV_STAGE;  // full[s] at sBar + 8 s
  const uint32_t kv_bar = sBar + 8 * AB_STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * AB_ROWS;
  // causal: the query tiles before the key tile see none of its keys
  const int t0 = CAUSAL ? (int)blockIdx.y : 0;
  const int slots = (S + AB_ROWS - 1) / AB_ROWS - t0;  // slot u: query tile t0 + u
  const CUtensorMap* map_q = &tq;
  const CUtensorMap* map_do = &tdo;
  const CUtensorMap* map_st = &tst;
  auto load_q = [&](int u) {
    const int s = u % AB_STAGES, qt0 = (t0 + u) * AB_ROWS;
    const uint32_t full = sBar + 8 * s, dst = sRing + s * AB_DKV_STAGE;
    mbar_arrive_expect_tx(full, AB_DKV_STAGE);
    tma_load_4d(dst, map_q, full, 0, qt0, h, b);
    tma_load_4d(dst + AB_TILE, map_do, full, 0, qt0, h, b);
    tma_load_4d(dst + 2 * AB_TILE, map_st, full, 0, qt0, h, b);
  };
  if (tid == 0) {
    for (int s = 0; s < AB_STAGES; ++s) mbar_init(sBar + 8 * s, 1);
    mbar_init(kv_bar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(kv_bar, 2 * AB_TILE);
    tma_load_4d(sK, &tk, kv_bar, 0, k0, h, b);
    tma_load_4d(sV, &tv, kv_bar, 0, k0, h, b);
    for (int u = 0; u < min(slots, AB_STAGES); ++u) load_q(u);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid & 31;
  const int row0 = k0 + 16 * warp + (lane >> 2);  // the thread's key rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  float dk[32], dv[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_bar, 0);
  for (int u = 0; u < slots; ++u) {
    const int s = u % AB_STAGES, qt0 = (t0 + u) * AB_ROWS;
    const uint32_t sQ = sRing + s * AB_DKV_STAGE, sO = sQ + AB_TILE;
    // the query rows' statistics; rows >= S read as zeros (TMA's fill), so
    // their p = exp(0 - 0) * 0 = 0 (their Q rows are zeros too)
    const float4* stat = reinterpret_cast<const float4*>(smem_raw + (sQ + 2 * AB_TILE - raw));
    mbar_wait(sBar + 8 * s, (u / AB_STAGES) & 1);
    wgmma_fence();
    ab_mma_nt(st, sK, sQ);
    ab_mma_nt(dpt, sV, sO);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(st);
    wgmma_fence_regs(dpt);
    // causal: the diagonal tile masks key > query
    const bool diag = CAUSAL && qt0 < k0 + AB_ROWS;
    uint32_t fp[4][4], fs[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = qt0 + 8 * j + col0;
      const float4 s0 = stat[8 * j + col0], s1 = stat[8 * j + col0 + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r, key = row0 + 8 * r;
        const float p0 = (diag && key > q) ? 0.f : expf(st[i] * scale - s0.x) * s0.y;
        const float p1 = (diag && key > q + 1) ? 0.f : expf(st[i + 1] * scale - s1.x) * s1.y;
        ab_pack(fp, j, r, p0, p1);
        ab_pack(fs, j, r, p0 * (dpt[i] - s0.z), p1 * (dpt[i + 1] - s1.z));
      }
    }
    wgmma_fence();
    ab_mma_rn(dv, fp, sO);
    ab_mma_rn(dk, fs, sQ);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(dv);
    wgmma_fence_regs(dk);
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && u + AB_STAGES < slots) load_q(u + AB_STAGES);
  }
  const long long ld = 3LL * H * ATT_D;
  __nv_bfloat16* dst = dqkv + (long long)b * S * ld + h * ATT_D;
  ab_store(dk, scale, dst + H * ATT_D, ld, row0, S, lane);
  ab_store(dv, 1.f, dst + 2 * H * ATT_D, ld, row0, S, lane);
}

constexpr int LNB_THREADS = 128;  // 4 rows per block, one warp each

// LN backward of the raw-LN prologue, one warp per row of x [rows, K]:
//   dx = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)) + g;  xn -> bf16
//   unless xn is null
// g_every = 1: g has one row per x row; g_every = S: only row 0 of each
// image has a cotangent (the CLS layer), g [rows / S, K]; g null: none.
static __global__ void __launch_bounds__(LNB_THREADS)
ln_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dxn,
              const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dx,
              __nv_bfloat16* __restrict__ xn, int rows, int K, int g_every, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LNB_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (long long)row * K;
  const float* dr = dxn + (long long)row * K;
  float mean, rstd;
  ln_row_stats(xr, K, eps, mean, rstd);
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Pack8 p, o;
    p.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float n = (__bfloat162float(p.h[i]) - mean) * rstd;
      const float d = dr[c + i];
      m1 += d;
      m2 += d * n;
      o.h[i] = __float2bfloat16(n);
    }
    if (xn != nullptr) *reinterpret_cast<uint4*>(xn + (long long)row * K + c) = o.u;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, o);
    m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  }
  m1 /= K;
  m2 /= K;
  const bool has_g = g != nullptr && (row % g_every) == 0;
  const __nv_bfloat16* gr = has_g ? g + (long long)(row / g_every) * K : nullptr;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Pack8 p, gp, o;
    p.u = *reinterpret_cast<const uint4*>(xr + c);
    gp.u = has_g ? *reinterpret_cast<const uint4*>(gr + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float n = (__bfloat162float(p.h[i]) - mean) * rstd;
      o.h[i] = __float2bfloat16(rstd * (dr[c + i] - m1 - n * m2) + __bfloat162float(gp.h[i]));
    }
    *reinterpret_cast<uint4*>(dx + (long long)row * K + c) = o.u;
  }
}

// a [B, S, H, 64] bf16 view (row stride ld elements, heads 64 apart, batch
// stride S ld) as a 4-d tensor map of (64, S, H, B), boxes of 64 x 64
static inline bool ab_map(CUtensorMap* map, const void* p, int B, int S, int H, long long ld) {
  const cuuint64_t dims[4] = {ATT_D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ld * 2, ATT_D * 2, (cuuint64_t)S * ld * 2};
  const cuuint32_t box[4] = {ATT_D, AB_ROWS, 1, 1};
  return make_tensor_map(map, p, 4, dims, strides, box);
}

template <bool CAUSAL>
static cudaError_t launch_attn_bwd_passes(const CUtensorMap (&maps)[5], float4* stats,
                                          __nv_bfloat16* dqkv, int B, int S, int H, int passes,
                                          cudaStream_t stream) {
  static const cudaError_t attr_dq =
      cudaFuncSetAttribute(attn_bwd_dq_kernel<CAUSAL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)AB_DQ_SMEM);
  static const cudaError_t attr_dkv =
      cudaFuncSetAttribute(attn_bwd_dkv_kernel<CAUSAL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)AB_DKV_SMEM);
  UML_TRY(attr_dq);
  UML_TRY(attr_dkv);
  const dim3 grid((unsigned)(B * H), (unsigned)((S + AB_ROWS - 1) / AB_ROWS));
  const float scale = 0.125f;  // 1 / sqrt(64)
  if (passes & 1) {
    attn_bwd_dq_kernel<CAUSAL><<<grid, AB_THREADS, AB_DQ_SMEM, stream>>>(
        maps[0], maps[1], maps[2], maps[3], dqkv, stats, S, H, scale);
    UML_TRY(cudaGetLastError());
  }
  if (passes & 2)
    attn_bwd_dkv_kernel<CAUSAL><<<grid, AB_THREADS, AB_DKV_SMEM, stream>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], dqkv, S, H, scale);
  return cudaGetLastError();
}

// The attention backward of B x H heads of 64: passes 1 runs the dq pass
// (dq into dqkv's q columns, the statistics into stats), 2 the dkv pass
// (dk, dv from stats), 3 both in turn.  Pointers 16-byte aligned.
static inline cudaError_t launch_attn_bwd(const __nv_bfloat16* qkv, const __nv_bfloat16* dattn,
                                          float4* stats, __nv_bfloat16* dqkv, int B, int S,
                                          int H, bool causal, cudaStream_t stream,
                                          int passes = 3) {
  if (B < 1 || S < 1 || H < 1 || (long long)B * H > INT_MAX ||
      (S + AB_ROWS - 1) / AB_ROWS > 65535 || passes < 1 || passes > 3)
    return cudaErrorInvalidValue;
  const long long hd = (long long)H * ATT_D;
  CUtensorMap maps[5];  // q, k, v, dO, the statistics
  const cuuint64_t st_dims[4] = {4, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t st_strides[3] = {16, (cuuint64_t)S * 16, (cuuint64_t)H * S * 16};
  const cuuint32_t st_box[4] = {4, AB_ROWS, 1, 1};
  if (!ab_map(&maps[0], qkv, B, S, H, 3 * hd) || !ab_map(&maps[1], qkv + hd, B, S, H, 3 * hd) ||
      !ab_map(&maps[2], qkv + 2 * hd, B, S, H, 3 * hd) ||
      !ab_map(&maps[3], dattn, B, S, H, hd) ||
      !make_tensor_map(&maps[4], stats, 4, st_dims, st_strides, st_box,
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  return causal ? launch_attn_bwd_passes<true>(maps, stats, dqkv, B, S, H, passes, stream)
                : launch_attn_bwd_passes<false>(maps, stats, dqkv, B, S, H, passes, stream);
}

static inline cudaError_t launch_ln_bwd(const __nv_bfloat16* x, const float* dxn,
                                        const __nv_bfloat16* g, __nv_bfloat16* dx,
                                        __nv_bfloat16* xn, int rows, int K, int g_every,
                                        float eps, cudaStream_t stream) {
  const int per_block = LNB_THREADS / 32;
  ln_bwd_kernel<<<(rows + per_block - 1) / per_block, LNB_THREADS, 0, stream>>>(
      x, dxn, g, dx, xn, rows, K, g_every, eps);
  return cudaGetLastError();
}

}  // namespace uml
