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
// The softmax statistics are recomputed from the stash exactly as the
// forward kernel (attention.cuh) computes them: fp32 scores, fp32 row max,
// e = exp(s - max) in fp32, 1/rowsum(e) in fp32.  With p = e / rowsum:
//   dV = p^T dO,  dP = dO V^T,  D = rowsum(p * dP),  dS = p * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q
// p and dS are rounded to bf16 before their products (the tensor cores
// take bf16), every product accumulates in fp32, dq/dk/dv are rounded to
// bf16 once.  (The TPU kernel uses the max-free exp2 with its clamp at
// 96 and the head-pair lane masks; both are TPU layout choices.)
//
// Two kernels split the work the FlashAttention-2 way, because Hopper's
// blocks cannot carry a sum between them as the TPU's sequential grid
// does:
//   attn_bwd_dq:  one block per (image, head, 64 query rows): K and V of
//     the head in shared memory (as in the forward), the fp32 scores and
//     dP of the block's rows; writes dQ and each row's (max, 1/sum, D).
//   attn_bwd_dkv: one block per (image, head, 64 key rows): walks the
//     query tiles, recomputes p and dS of its keys from those statistics,
//     and accumulates dK and dV in registers (wmma fragments).
// What bounds them on the H100: per (image, head) at S = 197 they do
// ~5 x 2 x S x S x 64 FLOPs (25 MFLOP) over ~100 KB of qkv/dO, so they are
// compute- and latency-bound; attn_bwd_dq takes ~188 KB of shared memory
// at S = 197 (one block of 4 warps per SM), the first thing a faster
// version would change.
//
// cls_bwd: the CLS-only layer has one live query row per image, so per
// (image, head) the scores are one [S] row, dV and dK are outer products
// and dQ is one row; one block per (image, head) on the CUDA cores.
//
// ln_bwd: dx = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)) + g, the LN
// backward of the prologue (the LN scale/bias are folded into W_eff, so
// the raw LN's backward is all that is left), one warp per row; it also
// writes xn (bf16), which the dW_eff product outside reads.  With g null
// it leaves the residual out (the MLP backward of _mlp_bwd_kernel, whose
// residual is added outside).
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

constexpr int ATTB_MAX_SPAD = 256;  // shared-memory bound of attn_bwd_dq, see below
constexpr int ATTB_MAXT = ATTB_MAX_SPAD / 32;
constexpr int ATTB_LDT = ATT_BQ + 4;  // fp32 row stride of the dkv kernel's per-warp tiles

static inline size_t attn_bwd_dq_smem_bytes(int s) {
  const int sp = attention_spad(s);
  return (size_t)2 * sp * ATT_LDK * 2            // K, V
         + (size_t)2 * ATT_BQ * ATT_LDK * 2      // Q, dO
         + (size_t)2 * ATT_BQ * attention_lds(s) * 4;  // fp32 scores/p, dP (dS aliases dP)
}

template <bool CAUSAL>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ dattn,
                   __nv_bfloat16* __restrict__ dqkv, float4* __restrict__ stats, int S,
                   int H, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = attention_spad(S);
  const int lds = attention_lds(S);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + sp * ATT_LDK;
  __nv_bfloat16* Qs = Vs + sp * ATT_LDK;
  __nv_bfloat16* dOs = Qs + ATT_BQ * ATT_LDK;
  float* Ps = reinterpret_cast<float*>(dOs + ATT_BQ * ATT_LDK);  // scores, then p
  float* dPs = Ps + ATT_BQ * lds;                                  // dP
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(dPs);      // dS, row stride 2*lds

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

  for (int idx = tid; idx < sp * 8; idx += ATT_THREADS) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < S) {
      const __nv_bfloat16* src = base + r * row_stride + h * ATT_D + c;
      kv = *reinterpret_cast<const uint4*>(src + hd);
      vv = *reinterpret_cast<const uint4*>(src + 2 * hd);
    }
    *reinterpret_cast<uint4*>(Ks + r * ATT_LDK + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * ATT_LDK + c) = vv;
  }
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
  __syncthreads();

  // warp w owns query rows 16w .. 16w+15 of the tile; warp-local from here
  const int wr = warp * 16;
  if (q0 + wr >= S) return;
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq[ATT_D / 16];
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fo[ATT_D / 16];
#pragma unroll
    for (int kk = 0; kk < ATT_D / 16; ++kk) {
      wmma::load_matrix_sync(fq[kk], Qs + wr * ATT_LDK + 16 * kk, ATT_LDK);
      wmma::load_matrix_sync(fo[kk], dOs + wr * ATT_LDK + 16 * kk, ATT_LDK);
    }
    for (int n = 0; n < sp / 16; ++n) {
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
      wmma::store_matrix_sync(Ps + wr * lds + 16 * n, acc_s, lds, wmma::mem_row_major);
      wmma::store_matrix_sync(dPs + wr * lds + 16 * n, acc_p, lds, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // per row: the forward's softmax statistics, D = rowsum(p * dP), dS
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wr + rr;
    const int qi = q0 + r;
    float sv[ATTB_MAXT], dp[ATTB_MAXT];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < ATTB_MAXT; ++t) {
      const int j = lane + 32 * t;
      float v = -CUDART_INF_F;
      dp[t] = 0.f;
      if (qi < S && j < S && (!CAUSAL || j <= qi)) {
        v = Ps[r * lds + j] * scale;
        dp[t] = dPs[r * lds + j];
      }
      sv[t] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < ATTB_MAXT; ++t) {
      const float e = (sv[t] == -CUDART_INF_F) ? 0.f : expf(sv[t] - mx);
      sv[t] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float linv = sum > 0.f ? 1.f / sum : 0.f;
    float dsum = 0.f;
#pragma unroll
    for (int t = 0; t < ATTB_MAXT; ++t) {
      sv[t] *= linv;  // p
      dsum += sv[t] * dp[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    __syncwarp();  // every lane has read the fp32 dP row before dS overwrites it
    __nv_bfloat16* dsrow = dSs + r * (2 * lds);
#pragma unroll
    for (int t = 0; t < ATTB_MAXT; ++t) {
      const int j = lane + 32 * t;
      if (j < sp) dsrow[j] = __float2bfloat16(sv[t] * (dp[t] - dsum));
    }
    if (lane == 0 && qi < S)
      stats[((long long)b * H + h) * S + qi] = make_float4(mx, linv, dsum, 0.f);
    __syncwarp();
  }

  // dQ = scale * dS . K for the warp's 16 rows
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[ATT_D / 16];
#pragma unroll
    for (int c = 0; c < ATT_D / 16; ++c) wmma::fill_fragment(acc[c], 0.f);
    for (int kt = 0; kt < sp / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fs;
      wmma::load_matrix_sync(fs, dSs + wr * (2 * lds) + 16 * kt, 2 * lds);
#pragma unroll
      for (int c = 0; c < ATT_D / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fk;
        wmma::load_matrix_sync(fk, Ks + 16 * kt * ATT_LDK + 16 * c, ATT_LDK);
        wmma::mma_sync(acc[c], fs, fk, acc[c]);
      }
    }
    // the scores/p buffer is free: the warp's dQ rows go there
#pragma unroll
    for (int c = 0; c < ATT_D / 16; ++c)
      wmma::store_matrix_sync(Ps + wr * lds + 16 * c, acc[c], lds, wmma::mem_row_major);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int qi = q0 + wr + rr;
    if (qi >= S) break;
    const float2 o = *reinterpret_cast<const float2*>(Ps + (wr + rr) * lds + 2 * lane);
    *reinterpret_cast<__nv_bfloat162*>(dqkv + ((long long)b * S + qi) * row_stride + h * ATT_D +
                                       2 * lane) =
        __floats2bfloat162_rn(o.x * scale, o.y * scale);
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

constexpr int CLSB_THREADS = 128;
constexpr int CLSB_MAX_S = 512;

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

// CLS-only attention backward, one block per (image, head).
//   dattn [B, H*64] bf16: dO of each image's CLS row
static __global__ void __launch_bounds__(CLSB_THREADS)
cls_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dattn,
               __nv_bfloat16* __restrict__ dqkv, int S, int H, float scale) {
  __shared__ float q0[ATT_D], dO[ATT_D], dq_part[CLSB_THREADS];
  // p and dS hold bf16-rounded values (the operands of the products)
  __shared__ float sc[CLSB_MAX_S], dp[CLSB_MAX_S], pb[CLSB_MAX_S], dsb[CLSB_MAX_S];
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
  float mx = -CUDART_INF_F;
  for (int j = tid; j < S; j += CLSB_THREADS) {
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
    sc[j] = s * scale;
    dp[j] = d;
    mx = fmaxf(mx, s * scale);
  }
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int j = tid; j < S; j += CLSB_THREADS) {
    const float e = expf(sc[j] - mx);
    sc[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  const float linv = 1.f / sum;
  float dsum = 0.f;
  for (int j = tid; j < S; j += CLSB_THREADS) {
    const float p = sc[j] * linv;
    sc[j] = p;
    dsum += p * dp[j];
  }
  dsum = block_sum(dsum, red);
  for (int j = tid; j < S; j += CLSB_THREADS) {
    pb[j] = __bfloat162float(__float2bfloat16(sc[j]));
    dsb[j] = __bfloat162float(__float2bfloat16(sc[j] * (dp[j] - dsum)));
  }
  __syncthreads();

  // dQ (row 0): thread pair (c, half) sums half of the keys for column c
  {
    const int c = tid & (ATT_D - 1), half = tid >> 6;
    float acc = 0.f;
    for (int j = half; j < S; j += 2)
      acc += dsb[j] * __bfloat162float(base[j * row_stride + hd + h * ATT_D + c]);
    dq_part[tid] = acc;
  }
  __syncthreads();
  if (tid < ATT_D)
    dbase[h * ATT_D + tid] = __float2bfloat16((dq_part[tid] + dq_part[tid + ATT_D]) * scale);
  // dK, dV: outer products; the q section of rows 1.. is zero
  for (int idx = tid; idx < S * ATT_D; idx += CLSB_THREADS) {
    const int j = idx / ATT_D, c = idx % ATT_D;
    __nv_bfloat16* dst = dbase + j * row_stride + h * ATT_D + c;
    if (j > 0) dst[0] = __float2bfloat16(0.f);
    dst[hd] = __float2bfloat16(dsb[j] * q0[c] * scale);
    dst[2 * hd] = __float2bfloat16(pb[j] * dO[c]);
  }
}

constexpr int LNB_THREADS = 128;  // 4 rows per block, one warp each

// LN backward of the raw-LN prologue, one warp per row of x [rows, K]:
//   dx = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)) + g;  xn -> bf16
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
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = __bfloat162float(p.h[i]);
      s += v;
      ss += v * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mean = s / K;
  const float rstd = rsqrtf(fmaxf(ss / K - mean * mean, 0.f) + eps);
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
    *reinterpret_cast<uint4*>(xn + (long long)row * K + c) = o.u;
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
  if (attention_spad(S) > ATTB_MAX_SPAD) return cudaErrorInvalidValue;
  const size_t smem = attn_bwd_dq_smem_bytes(S);
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
  if (S > CLSB_MAX_S) return cudaErrorInvalidValue;
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
