// attention backward from the stashed qkv, and the LayerNorm backward row
// pass: the kernel work of the TPU's stash backward of the attention half
// (uml_tpu/ops/fused_attention.py::_block_bwd_stash_kernel, the body of
// _block_bwd_one_stash, :1017-1103) and of its CLS-only twin
// (::_block_bwd_cls_kernel, :1298-1423).
//
//   qkv   [B, S, 3*H*64] bf16, the forward's stash (q at h*64, k at H*64 +
//         h*64, v at 2*H*64 + h*64; the port's stash includes b_eff)
//   dattn [B, S, H*64] bf16, dO = g . wo^T (ln_gemm with TRANS_B)
//   dqkv  [B, S, 3*H*64] bf16, written here
//
// The softmax statistics are recomputed from the stash in fp32: the
// scores, the row max m, l = rowsum(exp(s - m)), exact expf (the forward
// takes the same statistics online with ex2.approx; the backward holds to
// the plain version's exp).  With p = exp(s - m) / l:
//   dV = p^T dO,  dP = dO V^T,  D = rowsum(p * dP),  dS = p * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q
// p and dS are rounded to bf16 before their products (the tensor cores
// take bf16), every product accumulates in fp32, dq/dk/dv are rounded to
// bf16 once.  (The TPU kernel uses the max-free exp2 with its clamp at
// 96 and the head-pair lane masks; both are TPU layout choices.)
//
// Two kernels split the work the FlashAttention-2 way, because Hopper's
// blocks cannot carry a sum between them as the TPU's sequential grid
// does; both stream the other side in 64-row tiles, so S has no bound:
//   attn_bwd_dq:  one block per (image, head, 64 query rows), Q and dO of
//     its rows in shared memory; it walks the key tiles twice, two lanes
//     per query row (each every other key, one shuffle to combine), the
//     row's statistics in registers.  Pass 1 takes them online: m, l and
//     the numerator of D = rowsum(p * dP) = sum_j exp(s_j - m) dP_j / l,
//     rescaled like l when m grows (the scores S = Q K^T and dP = dO V^T
//     of each tile).  Pass 2 forms p and dS = p (dP - D) of each tile
//     again and accumulates dQ = dS K in registers (wmma fragments); it
//     writes dQ and each row's (m, 1/l, D).  D is the reference's
//     rowsum(p * dP) in fp32, not FlashAttention-2's rowsum(dO * O) of
//     the bf16 output.
//   attn_bwd_dkv: one block per (image, head, 64 key rows): walks the
//     query tiles, recomputes p and dS of its keys from those statistics,
//     and accumulates dK and dV in registers (wmma fragments).
// What bounds them on the H100: per (image, head) at S = 197 they do
// ~6 x 2 x S x S x 64 FLOPs (30 MFLOP, the dq pass's two walks included)
// over ~100 KB of qkv/dO, so they are compute- and latency-bound on
// nvcuda::wmma; a wgmma attention backward is queued (ROADMAP).  attn_bwd_dq
// takes ~79 KB of shared memory (two blocks per SM) for any S.
//
// cls_bwd: the CLS-only layer has one live query row per image, so per
// (image, head) the scores are one [S] row, dV and dK are outer products
// and dQ is one row; one block per (image, head) on the CUDA cores,
// walking S three times (the max; the sum and D; then p, dS, dK, dV and
// dQ in chunks of 128 keys): any S.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "attention.cuh"
#include "ln_gemm.cuh"

namespace uml {

constexpr int ATTB_BK = 64;                 // keys per tile of the dq pass
constexpr int ATTB_LDS = ATTB_BK + 4;       // fp32 row stride of its score tiles
constexpr int ATTB_LDT = ATT_BQ + 4;        // fp32 row stride of the dkv kernel's per-warp tiles

// shared memory of attn_bwd_dq: Q, dO, K, V tiles (bf16), the fp32 scores
// and dP of the block's rows against one key tile, the bf16 dS tile
constexpr size_t ATTB_DQ_SMEM = (size_t)4 * ATT_BQ * ATT_LDK * 2 +
                                (size_t)2 * ATT_BQ * ATTB_LDS * 4 +
                                (size_t)ATT_BQ * ATT_LDK * 2;

template <bool CAUSAL>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ dattn,
                   __nv_bfloat16* __restrict__ dqkv, float4* __restrict__ stats, int S,
                   int H, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + ATT_BQ * ATT_LDK;
  __nv_bfloat16* Ks = dOs + ATT_BQ * ATT_LDK;
  __nv_bfloat16* Vs = Ks + ATTB_BK * ATT_LDK;
  float* Ss = reinterpret_cast<float*>(Vs + ATTB_BK * ATT_LDK);  // scores, later dQ
  float* dPs = Ss + ATT_BQ * ATTB_LDS;
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(dPs + ATT_BQ * ATTB_LDS);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * ATT_BQ;
  const int hd = H * ATT_D;
  const long long row_stride = 3LL * hd;
  const __nv_bfloat16* base = qkv + (long long)b * S * row_stride;
  const __nv_bfloat16* dbase = dattn + (long long)b * S * hd;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int idx = tid; idx < ATT_BQ * 8; idx += ATT_THREADS) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    const int qi = q0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0), ov = make_uint4(0, 0, 0, 0);
    if (qi < S) {
      qv = *reinterpret_cast<const uint4*>(base + qi * row_stride + h * ATT_D + c);
      ov = *reinterpret_cast<const uint4*>(dbase + (long long)qi * hd + h * ATT_D + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * ATT_LDK + c) = qv;
    *reinterpret_cast<uint4*>(dOs + r * ATT_LDK + c) = ov;
  }
  // the statistics of the lane's row (lanes 2r, 2r+1 hold the same):
  // the running max, the sum of exp(s - m) and that of exp(s - m) dP
  float row_m = -CUDART_INF_F, row_l = 0.f, row_dn = 0.f;
  // causal: key tiles past the block's last query row have p = 0
  const int q_last = min(S, q0 + ATT_BQ) - 1;
  const int n_tiles = CAUSAL ? q_last / ATTB_BK + 1 : (S + ATTB_BK - 1) / ATTB_BK;
  // warp w owns query rows 16w .. 16w+15 of the tile
  const int wr = warp * 16;
  const bool live = q0 + wr < S;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq[ATT_D / 16];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fo[ATT_D / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[ATT_D / 16];
#pragma unroll
  for (int c = 0; c < ATT_D / 16; ++c) wmma::fill_fragment(dq[c], 0.f);

  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * ATTB_BK;
      __syncthreads();  // the previous tile's K / V reads (and the Q / dO stores) are done
      for (int idx = tid; idx < ATTB_BK * 8; idx += ATT_THREADS) {
        const int r = idx >> 3, c = (idx & 7) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (k0 + r < S) {
          const __nv_bfloat16* src = base + (k0 + r) * row_stride + h * ATT_D + c;
          kv = *reinterpret_cast<const uint4*>(src + hd);
          vv = *reinterpret_cast<const uint4*>(src + 2 * hd);
        }
        *reinterpret_cast<uint4*>(Ks + r * ATT_LDK + c) = kv;
        *reinterpret_cast<uint4*>(Vs + r * ATT_LDK + c) = vv;
      }
      __syncthreads();
      if (!live) continue;
      if (pass == 0 && t == 0) {
#pragma unroll
        for (int kk = 0; kk < ATT_D / 16; ++kk) {
          wmma::load_matrix_sync(fq[kk], Qs + wr * ATT_LDK + 16 * kk, ATT_LDK);
          wmma::load_matrix_sync(fo[kk], dOs + wr * ATT_LDK + 16 * kk, ATT_LDK);
        }
      }
      // S = Q K^T and dP = dO V^T of the warp's 16 rows against the tile
#pragma unroll
      for (int n = 0; n < ATTB_BK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_p;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
        for (int kk = 0; kk < ATT_D / 16; ++kk) {
          // K^T and V^T as column-major B operands are K and V row-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fk, fv;
          wmma::load_matrix_sync(fk, Ks + 16 * n * ATT_LDK + 16 * kk, ATT_LDK);
          wmma::load_matrix_sync(fv, Vs + 16 * n * ATT_LDK + 16 * kk, ATT_LDK);
          wmma::mma_sync(acc_s, fq[kk], fk, acc_s);
          wmma::mma_sync(acc_p, fo[kk], fv, acc_p);
        }
        wmma::store_matrix_sync(Ss + wr * ATTB_LDS + 16 * n, acc_s, ATTB_LDS,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(dPs + wr * ATTB_LDS + 16 * n, acc_p, ATTB_LDS,
                                wmma::mem_row_major);
      }
      __syncwarp();
      // the lane's row: lanes 2r and 2r+1 share row r of the warp's 16,
      // each taking every other key of the tile (32 each)
      {
        const int r = wr + (lane >> 1);
        const int qi = q0 + r;
        const int h2 = lane & 1;
        const float* srow = Ss + r * ATTB_LDS + h2;
        const float* prow = dPs + r * ATTB_LDS + h2;
        // keys k0 + 2c + h2 < S (and, causal, <= qi) are valid
        const int lim = min(S, CAUSAL ? qi + 1 : S) - k0 - h2;  // 2c < lim
        if (pass == 0) {
          float mx = -CUDART_INF_F;
#pragma unroll 8
          for (int c = 0; c < ATTB_BK / 2; ++c)
            if (qi < S && 2 * c < lim) mx = fmaxf(mx, srow[2 * c] * scale);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          const float m_new = fmaxf(row_m, mx);
          // a row with no valid key so far keeps m = -inf, l = 0
          const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
          float e = 0.f, ed = 0.f;
#pragma unroll 8
          for (int c = 0; c < ATTB_BK / 2; ++c) {
            if (qi < S && 2 * c < lim) {
              const float x = expf(srow[2 * c] * scale - m_use);
              e += x;
              ed += x * prow[2 * c];
            }
          }
          e += __shfl_xor_sync(0xffffffffu, e, 1);
          ed += __shfl_xor_sync(0xffffffffu, ed, 1);
          const float alpha = row_m == -CUDART_INF_F ? 0.f : expf(row_m - m_use);
          row_l = row_l * alpha + e;
          row_dn = row_dn * alpha + ed;
          row_m = m_new;
        } else {
          const float linv = row_l > 0.f ? 1.f / row_l : 0.f;
          const float dsum = row_dn * linv;
          __nv_bfloat16* dsrow = dSs + r * ATT_LDK + h2;
#pragma unroll 8
          for (int c = 0; c < ATTB_BK / 2; ++c) {
            float ds = 0.f;
            if (qi < S && 2 * c < lim)
              ds = expf(srow[2 * c] * scale - row_m) * linv * (prow[2 * c] - dsum);
            dsrow[2 * c] = __float2bfloat16(ds);
          }
        }
      }
      if (pass == 1) {
        __syncwarp();
        // dQ += dS K for the warp's 16 rows
#pragma unroll
        for (int kt = 0; kt < ATTB_BK / 16; ++kt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fs;
          wmma::load_matrix_sync(fs, dSs + wr * ATT_LDK + 16 * kt, ATT_LDK);
#pragma unroll
          for (int c = 0; c < ATT_D / 16; ++c) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fk;
            wmma::load_matrix_sync(fk, Ks + 16 * kt * ATT_LDK + 16 * c, ATT_LDK);
            wmma::mma_sync(dq[c], fs, fk, dq[c]);
          }
        }
        __syncwarp();  // dS is read before the next tile's rows overwrite it
      }
    }
  }
  if (!live) return;
  // the score tile is free: the warp's dQ rows go there
#pragma unroll
  for (int c = 0; c < ATT_D / 16; ++c)
    wmma::store_matrix_sync(Ss + wr * ATTB_LDS + 16 * c, dq[c], ATTB_LDS, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int qi = q0 + wr + rr;
    if (qi >= S) break;
    const float2 o = *reinterpret_cast<const float2*>(Ss + (wr + rr) * ATTB_LDS + 2 * lane);
    *reinterpret_cast<__nv_bfloat162*>(dqkv + ((long long)b * S + qi) * row_stride + h * ATT_D +
                                       2 * lane) =
        __floats2bfloat162_rn(o.x * scale, o.y * scale);
  }
  const int qi = q0 + wr + (lane >> 1);
  if ((lane & 1) == 0 && qi < S) {
    const float linv = row_l > 0.f ? 1.f / row_l : 0.f;
    stats[((long long)b * H + h) * S + qi] = make_float4(row_m, linv, row_dn * linv, 0.f);
  }
}

// shared memory of attn_bwd_dkv: K, V, Q, dO tiles (bf16), per warp the
// fp32 S^T and dP^T tiles and the bf16 p^T and dS^T tiles, the query
// tile's statistics
constexpr size_t ATTB_DKV_SMEM =
    (size_t)4 * ATT_BQ * ATT_LDK * 2 + (size_t)2 * ATT_BQ * ATTB_LDT * 4 +
    (size_t)2 * ATT_BQ * ATT_LDK * 2 + (size_t)ATT_BQ * 16;

template <bool CAUSAL>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ dattn, const float4* __restrict__ stats,
                    __nv_bfloat16* __restrict__ dqkv, int S, int H, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Kt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vt = Kt + ATT_BQ * ATT_LDK;
  __nv_bfloat16* Qt = Vt + ATT_BQ * ATT_LDK;
  __nv_bfloat16* dOt = Qt + ATT_BQ * ATT_LDK;
  float* St = reinterpret_cast<float*>(dOt + ATT_BQ * ATT_LDK);  // [64 keys][LDT]
  float* dPt = St + ATT_BQ * ATTB_LDT;
  __nv_bfloat16* pT = reinterpret_cast<__nv_bfloat16*>(dPt + ATT_BQ * ATTB_LDT);
  __nv_bfloat16* dST = pT + ATT_BQ * ATT_LDK;
  float4* qstat = reinterpret_cast<float4*>(dST + ATT_BQ * ATT_LDK);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int k0 = blockIdx.z * ATT_BQ;
  const int hd = H * ATT_D;
  const long long row_stride = 3LL * hd;
  const __nv_bfloat16* base = qkv + (long long)b * S * row_stride;
  const __nv_bfloat16* dbase = dattn + (long long)b * S * hd;
  const float4* sbase = stats + ((long long)b * H + h) * S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp * 16;  // the warp's 16 key rows of the tile
  const bool live = k0 + wr < S;

  for (int idx = tid; idx < ATT_BQ * 8; idx += ATT_THREADS) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (k0 + r < S) {
      const __nv_bfloat16* src = base + (k0 + r) * row_stride + h * ATT_D + c;
      kv = *reinterpret_cast<const uint4*>(src + hd);
      vv = *reinterpret_cast<const uint4*>(src + 2 * hd);
    }
    *reinterpret_cast<uint4*>(Kt + r * ATT_LDK + c) = kv;
    *reinterpret_cast<uint4*>(Vt + r * ATT_LDK + c) = vv;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[ATT_D / 16], dv[ATT_D / 16];
#pragma unroll
  for (int c = 0; c < ATT_D / 16; ++c) {
    wmma::fill_fragment(dk[c], 0.f);
    wmma::fill_fragment(dv[c], 0.f);
  }

  for (int q0 = 0; q0 < S; q0 += ATT_BQ) {
    // causal: a query tile that ends before the key tile starts has p = 0
    if (CAUSAL && q0 + ATT_BQ <= k0) continue;
    __syncthreads();  // the previous tile's Q / dO reads are done
    for (int idx = tid; idx < ATT_BQ * 8; idx += ATT_THREADS) {
      const int r = idx >> 3, c = (idx & 7) * 8;
      const int qi = q0 + r;
      uint4 qv = make_uint4(0, 0, 0, 0), ov = make_uint4(0, 0, 0, 0);
      if (qi < S) {
        qv = *reinterpret_cast<const uint4*>(base + qi * row_stride + h * ATT_D + c);
        ov = *reinterpret_cast<const uint4*>(dbase + (long long)qi * hd + h * ATT_D + c);
      }
      *reinterpret_cast<uint4*>(Qt + r * ATT_LDK + c) = qv;
      *reinterpret_cast<uint4*>(dOt + r * ATT_LDK + c) = ov;
    }
    for (int r = tid; r < ATT_BQ; r += ATT_THREADS)
      qstat[r] = (q0 + r < S) ? sbase[q0 + r] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    if (!live) continue;

    // S^T = K_w Q^T and dP^T = V_w dO^T for the warp's 16 keys x 64 queries
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fk[ATT_D / 16],
          fv[ATT_D / 16];
#pragma unroll
      for (int kk = 0; kk < ATT_D / 16; ++kk) {
        wmma::load_matrix_sync(fk[kk], Kt + wr * ATT_LDK + 16 * kk, ATT_LDK);
        wmma::load_matrix_sync(fv[kk], Vt + wr * ATT_LDK + 16 * kk, ATT_LDK);
      }
#pragma unroll
      for (int n = 0; n < ATT_BQ / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_p;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
        for (int kk = 0; kk < ATT_D / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fq, fo;
          wmma::load_matrix_sync(fq, Qt + 16 * n * ATT_LDK + 16 * kk, ATT_LDK);
          wmma::load_matrix_sync(fo, dOt + 16 * n * ATT_LDK + 16 * kk, ATT_LDK);
          wmma::mma_sync(acc_s, fk[kk], fq, acc_s);
          wmma::mma_sync(acc_p, fv[kk], fo, acc_p);
        }
        wmma::store_matrix_sync(St + wr * ATTB_LDT + 16 * n, acc_s, ATTB_LDT,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(dPt + wr * ATTB_LDT + 16 * n, acc_p, ATTB_LDT,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();
    // p^T and dS^T of the warp's keys, from the query rows' statistics
    for (int idx = lane; idx < 16 * ATT_BQ; idx += 32) {
      const int r = idx / ATT_BQ, c = idx % ATT_BQ;
      const int j = k0 + wr + r, qi = q0 + c;
      float p = 0.f, ds = 0.f;
      if (j < S && qi < S && (!CAUSAL || j <= qi)) {
        const float4 st = qstat[c];
        p = expf(St[(wr + r) * ATTB_LDT + c] * scale - st.x) * st.y;
        ds = p * (dPt[(wr + r) * ATTB_LDT + c] - st.z);
      }
      pT[(wr + r) * ATT_LDK + c] = __float2bfloat16(p);
      dST[(wr + r) * ATT_LDK + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    // dV += p^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < ATT_BQ / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp, fs;
      wmma::load_matrix_sync(fp, pT + wr * ATT_LDK + 16 * kk, ATT_LDK);
      wmma::load_matrix_sync(fs, dST + wr * ATT_LDK + 16 * kk, ATT_LDK);
#pragma unroll
      for (int c = 0; c < ATT_D / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fo, fq;
        wmma::load_matrix_sync(fo, dOt + 16 * kk * ATT_LDK + 16 * c, ATT_LDK);
        wmma::load_matrix_sync(fq, Qt + 16 * kk * ATT_LDK + 16 * c, ATT_LDK);
        wmma::mma_sync(dv[c], fp, fo, dv[c]);
        wmma::mma_sync(dk[c], fs, fq, dk[c]);
      }
    }
  }
  if (!live) return;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < ATT_D / 16; ++c) {
    wmma::store_matrix_sync(St + wr * ATTB_LDT + 16 * c, dk[c], ATTB_LDT, wmma::mem_row_major);
    wmma::store_matrix_sync(dPt + wr * ATTB_LDT + 16 * c, dv[c], ATTB_LDT, wmma::mem_row_major);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int j = k0 + wr + rr;
    if (j >= S) break;
    const float2 kx = *reinterpret_cast<const float2*>(St + (wr + rr) * ATTB_LDT + 2 * lane);
    const float2 vx = *reinterpret_cast<const float2*>(dPt + (wr + rr) * ATTB_LDT + 2 * lane);
    __nv_bfloat16* dst = dqkv + ((long long)b * S + j) * row_stride + h * ATT_D + 2 * lane;
    *reinterpret_cast<__nv_bfloat162*>(dst + hd) = __floats2bfloat162_rn(kx.x * scale,
                                                                         kx.y * scale);
    *reinterpret_cast<__nv_bfloat162*>(dst + 2 * hd) = __floats2bfloat162_rn(vx.x, vx.y);
  }
}

constexpr int CLSB_THREADS = 128;  // and keys per chunk of the last walk

__device__ inline float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < CLSB_THREADS / 32; ++w) t += red[w];
  return t;
}

__device__ inline float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < CLSB_THREADS / 32; ++w) t = fmaxf(t, red[w]);
  return t;
}

// CLS-only attention backward, one block per (image, head), any S.
//   dattn [B, H*64] bf16: dO of each image's CLS row
static __global__ void __launch_bounds__(CLSB_THREADS)
cls_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dattn,
               __nv_bfloat16* __restrict__ dqkv, int S, int H, float scale) {
  __shared__ float q0[ATT_D], dO[ATT_D], dq_part[CLSB_THREADS];
  // p and dS of the chunk's keys, rounded to bf16 (the operands of the products)
  __shared__ float pb[CLSB_THREADS], dsb[CLSB_THREADS];
  __shared__ float red[CLSB_THREADS / 32];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int hd = H * ATT_D;
  const long long row_stride = 3LL * hd;
  const __nv_bfloat16* base = qkv + (long long)b * S * row_stride;
  __nv_bfloat16* dbase = dqkv + (long long)b * S * row_stride;
  const int tid = threadIdx.x;

  if (tid < ATT_D) {
    q0[tid] = __bfloat162float(base[h * ATT_D + tid]);
    dO[tid] = __bfloat162float(dattn[(long long)b * hd + h * ATT_D + tid]);
  }
  __syncthreads();
  // key j's scaled score and dP = dO . v_j
  auto score = [&](int j, float& sc, float& dp) {
    const __nv_bfloat16* kr = base + j * row_stride + hd + h * ATT_D;
    const __nv_bfloat16* vr = kr + hd;
    float s = 0.f, d = 0.f;
    for (int c = 0; c < ATT_D; c += 8) {
      Pack8 kp, vp;
      kp.u = *reinterpret_cast<const uint4*>(kr + c);
      vp.u = *reinterpret_cast<const uint4*>(vr + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += q0[c + i] * __bfloat162float(kp.h[i]);
        d += dO[c + i] * __bfloat162float(vp.h[i]);
      }
    }
    sc = s * scale;
    dp = d;
  };
  float mx = -CUDART_INF_F;
  for (int j = tid; j < S; j += CLSB_THREADS) {
    float sc, dp;
    score(j, sc, dp);
    mx = fmaxf(mx, sc);
  }
  mx = block_max(mx, red);
  float sum = 0.f, dn = 0.f;
  for (int j = tid; j < S; j += CLSB_THREADS) {
    float sc, dp;
    score(j, sc, dp);
    const float e = expf(sc - mx);
    sum += e;
    dn += e * dp;
  }
  sum = block_sum(sum, red);
  dn = block_sum(dn, red);
  const float linv = 1.f / sum;
  const float dsum = dn * linv;  // D = rowsum(p * dP)

  // in chunks of CLSB_THREADS keys: p and dS, dK and dV rows (outer
  // products; the q section of rows 1.. is zero), dQ (row 0): thread pair
  // (c, half) sums half of the keys for column c
  const int c = tid & (ATT_D - 1), half = tid >> 6;
  float dq_acc = 0.f;
  for (int j0 = 0; j0 < S; j0 += CLSB_THREADS) {
    const int j = j0 + tid;
    float p = 0.f, ds = 0.f;
    if (j < S) {
      float sc, dp;
      score(j, sc, dp);
      p = expf(sc - mx) * linv;
      ds = p * (dp - dsum);
    }
    __syncthreads();  // the previous chunk's pb / dsb reads are done
    pb[tid] = __bfloat162float(__float2bfloat16(p));
    dsb[tid] = __bfloat162float(__float2bfloat16(ds));
    __syncthreads();
    const int n = min(CLSB_THREADS, S - j0);
    for (int i = half; i < n; i += 2)
      dq_acc += dsb[i] * __bfloat162float(base[(j0 + i) * row_stride + hd + h * ATT_D + c]);
    for (int idx = tid; idx < n * ATT_D; idx += CLSB_THREADS) {
      const int i = idx / ATT_D, cc = idx % ATT_D;
      __nv_bfloat16* dst = dbase + (j0 + i) * row_stride + h * ATT_D + cc;
      if (j0 + i > 0) dst[0] = __float2bfloat16(0.f);
      dst[hd] = __float2bfloat16(dsb[i] * q0[cc] * scale);
      dst[2 * hd] = __float2bfloat16(pb[i] * dO[cc]);
    }
  }
  dq_part[tid] = dq_acc;
  __syncthreads();
  if (tid < ATT_D)
    dbase[h * ATT_D + tid] = __float2bfloat16((dq_part[tid] + dq_part[tid + ATT_D]) * scale);
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

static inline cudaError_t launch_attn_bwd(const __nv_bfloat16* qkv, const __nv_bfloat16* dattn,
                                          float4* stats, __nv_bfloat16* dqkv, int B, int S,
                                          int H, bool causal, cudaStream_t stream) {
  const size_t smem = ATTB_DQ_SMEM;
  const dim3 grid(B, H, (S + ATT_BQ - 1) / ATT_BQ);
  const float scale = 0.125f;  // 1 / sqrt(64)
#define UML_ATTB_LAUNCH(C)                                                                    \
  do {                                                                                        \
    cudaFuncSetAttribute(attn_bwd_dq_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         (int)smem);                                                          \
    attn_bwd_dq_kernel<C><<<grid, ATT_THREADS, smem, stream>>>(qkv, dattn, dqkv, stats, S, H, \
                                                               scale);                        \
    const cudaError_t e = cudaGetLastError();                                                 \
    if (e != cudaSuccess) return e;                                                           \
    cudaFuncSetAttribute(attn_bwd_dkv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         (int)ATTB_DKV_SMEM);                                                 \
    attn_bwd_dkv_kernel<C><<<grid, ATT_THREADS, ATTB_DKV_SMEM, stream>>>(qkv, dattn, stats,   \
                                                                         dqkv, S, H, scale);  \
  } while (0)
  if (causal) UML_ATTB_LAUNCH(true);
  else UML_ATTB_LAUNCH(false);
#undef UML_ATTB_LAUNCH
  return cudaGetLastError();
}

static inline cudaError_t launch_cls_bwd(const __nv_bfloat16* qkv, const __nv_bfloat16* dattn,
                                         __nv_bfloat16* dqkv, int B, int S, int H,
                                         cudaStream_t stream) {
  cls_bwd_kernel<<<dim3(B, H), CLSB_THREADS, 0, stream>>>(qkv, dattn, dqkv, S, H, 0.125f);
  return cudaGetLastError();
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
