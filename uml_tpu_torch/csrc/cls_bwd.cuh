// The CLS-only attention backward as a bytes-bound pass: the kernel work of
// uml_tpu/ops/fused_attention.py::_block_bwd_cls_kernel (:1298-1423) after
// dattn = g . wo^T, in three launches (attn_block_bwd.cu runs them).
//
// The CLS layer has one live query row per image, so per (image, head) the
// backward is rank one in the keys.  With p_j = P at key j, q0 the CLS
// row's q (with its bias) and dO the head's cotangent:
//   dv_j = p_j dO,  dk_j = ds_j q0 scale,  dq0 = scale sum_j ds_j k_j,
// and the k and v parts of dxn row j = dqkv_j . W_eff^T are
//   sum_h ( ds_{j,h} u_h + p_{j,h} w_h ),
//   u_h = scale q0_h . Wk_h^T,  w_h = dO_h . Wv_h^T,
// each a K-vector per (image, head); row 0 adds z = sum_h dq0_h . Wq_h^T.
// So the dense dxn = dqkv . W_eff^T (B S x 3 H 64 x K: 44.6 GFLOP at
// ViT-B/16 B=64) becomes [S, 2H] x [2H, K] per image (~0.46 GFLOP), and
// no fp32 dxn reaches device memory:
//
//   cls_attn_bwd_kernel (one block per (image, head)): the scores and dP
//     of every key (8 lanes a key, 16 bytes of k and v each), the row max,
//     l and D, then p and dS rounded to bf16 (the operands of the TPU
//     kernel's products, as attn_block_bwd_plain rounds them) into coef
//     [B, S, 2H] (dS at h, p at H + h), dk and dv of every row and dq of
//     row 0 into dqkv (the q columns of rows 1.. zero: dqkv keeps its
//     layout for dW_eff = xn^T dqkv outside).
//   cls_proj_kernel (one block per (64 columns of K, head, u | w | z)):
//     u, w and z of every image for those columns, [B, 3, H, K] fp32; the
//     head's 64 x 64 slice of W_eff is read once for all images.
//   cls_rows_kernel (64 rows of one image a block, 8 a warp): u and w of
//     the image into shared memory, dxn of its rows from coef and u, w (z
//     in row 0), then the LN backward of ln_bwd_kernel (dx = rstd (dxn -
//     mean(dxn) - xn mean(dxn xn)) + g in row 0) in two sweeps over the
//     columns, dxn recomputed in the second, so it never leaves the
//     registers; writes xn and dx.
//
// The factorized dxn differs from the TPU kernel's in rounding only: the
// TPU rounds dk and dv to bf16 before its dxn product
// (fused_attention.py:1398-1410), here dS and p are the bf16 operands and
// u, w, z stay fp32 (attn_block_cls_bwd_factored_plain is the plain
// version).
//
// What bounds it on the H100: its bytes.  At ViT-B/16 B=64 it reads k and
// v (39 MB of qkv), x (19 MB) and W_eff (3.5 MB) and writes dqkv (58 MB),
// dx and xn (19 MB each): ~0.05 ms at 3.35 TB/s; coef (1.2 MB) and u, w, z
// (7 MB) stay in L2.  The FLOPs (~0.5 GFLOP of dxn, 0.2 of the scores and
// dS, 0.1 of u, w, z) run on the CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention.cuh"
#include "ln_gemm.cuh"

namespace uml {

constexpr int CLSA_THREADS = 256;  // 32 keys a step, 8 lanes a key
constexpr int CLSP_THREADS = 256;  // 64 columns x 4 image groups
constexpr int CLSR_THREADS = 256;  // 8 warps
constexpr int CLSR_ROWS = 8;       // rows a warp
constexpr int CLS_MAX_HEADS = 32;  // coef of a row in shared memory: 2H floats
// u and w of one image in the row pass's shared memory beside its 16 KB of
// coef: 2 H K fp32 <= 200 KB (H K <= 25,600: every CLIP ViT up to ViT-bigG)
constexpr int CLSR_MAX_UW_BYTES = 200 * 1024;

// the float of v rounded to bf16
static __device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <bool MAX>
static __device__ __forceinline__ float cls_block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, t) : v + t;
  }
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < CLSA_THREADS / 32; ++w) t = MAX ? fmaxf(t, red[w]) : t + red[w];
  return t;
}

// One (image, head): qkv [B, S, 3*H*64] (the CLS forward's, b_eff
// included), dattn [B, H*64] (dO of the CLS rows) -> dqkv [B, S, 3*H*64],
// coef [B, S, 2H] (bf16(dS) at h, bf16(p) at H + h, as floats).
static __global__ void __launch_bounds__(CLSA_THREADS)
cls_attn_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ dattn, __nv_bfloat16* __restrict__ dqkv,
                    float* __restrict__ coef, int S, int H, float scale) {
  __shared__ float dq_part[CLSA_THREADS / 8][ATT_D];
  __shared__ float red[CLSA_THREADS / 32];
  const int b = blockIdx.x, h = blockIdx.y;
  const int hd = H * ATT_D;
  const long long ld = 3LL * hd;
  const __nv_bfloat16* base = qkv + (long long)b * S * ld;
  __nv_bfloat16* dbase = dqkv + (long long)b * S * ld;
  float* cf = coef + (long long)b * S * 2 * H;
  const int tid = threadIdx.x;
  const int grp = tid >> 3, sub = tid & 7;  // key group of 8 lanes; dims 8 sub .. + 7
  const int d0 = 8 * sub;

  float q0[8], dO[8];
  {
    Pack8 qp, dp;
    qp.u = *reinterpret_cast<const uint4*>(base + h * ATT_D + d0);
    dp.u = *reinterpret_cast<const uint4*>(dattn + (long long)b * hd + h * ATT_D + d0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q0[i] = __bfloat162float(qp.h[i]);
      dO[i] = __bfloat162float(dp.h[i]);
    }
  }
  // walk 1: key j's scaled score and dP = dO . v_j, kept in coef's slots;
  // every lane takes every step (the shuffles need the whole warp)
  float mx = -CUDART_INF_F;
#pragma unroll 2
  for (int j0 = 0; j0 < S; j0 += CLSA_THREADS / 8) {
    const int j = j0 + grp;
    const bool ok = j < S;
    Pack8 kp, vp;
    kp.u = vp.u = make_uint4(0, 0, 0, 0);
    if (ok) {
      const __nv_bfloat16* kr = base + (long long)j * ld + hd + h * ATT_D + d0;
      kp.u = *reinterpret_cast<const uint4*>(kr);
      vp.u = *reinterpret_cast<const uint4*>(kr + hd);
    }
    float s = 0.f, d = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += q0[i] * __bfloat162float(kp.h[i]);
      d += dO[i] * __bfloat162float(vp.h[i]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      d += __shfl_xor_sync(0xffffffffu, d, o);
    }
    if (!ok) continue;
    s *= scale;
    mx = fmaxf(mx, s);
    if (sub == 0) {
      cf[(long long)j * 2 * H + h] = s;
      cf[(long long)j * 2 * H + H + h] = d;
    }
  }
  mx = cls_block_reduce<true>(mx, red);  // its barriers also publish coef's slots
  // walk 2: l = sum exp(s - m), D = sum p dP
  float sum = 0.f, dn = 0.f;
  for (int j = tid; j < S; j += CLSA_THREADS) {
    const float e = expf(cf[(long long)j * 2 * H + h] - mx);
    sum += e;
    dn += e * cf[(long long)j * 2 * H + H + h];
  }
  sum = cls_block_reduce<false>(sum, red);
  dn = cls_block_reduce<false>(dn, red);
  const float linv = 1.f / sum;
  const float dsum = dn * linv;

  // walk 3: p and dS (bf16), dk and dv rows, coef, and this group's dq
  float dq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dq[i] = 0.f;
  for (int j0 = 0; j0 < S; j0 += CLSA_THREADS / 8) {
    const int j = j0 + grp;
    if (j >= S) break;  // the groups past S have no later keys either
    const float s = cf[(long long)j * 2 * H + h];
    const float dp = cf[(long long)j * 2 * H + H + h];
    const float p = expf(s - mx) * linv;
    const float pb = bf16_round(p), dsb = bf16_round(p * (dp - dsum));
    // the group's 8 lanes (one aligned octet of the warp) have read the slots
    __syncwarp(0xffu << (threadIdx.x & 24));
    if (sub == 0) {
      cf[(long long)j * 2 * H + h] = dsb;
      cf[(long long)j * 2 * H + H + h] = pb;
    }
    const long long row = (long long)j * ld + h * ATT_D + d0;
    Pack8 kp, dk, dv;
    kp.u = *reinterpret_cast<const uint4*>(base + row + hd);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dq[i] += dsb * __bfloat162float(kp.h[i]);
      dk.h[i] = __float2bfloat16(dsb * q0[i] * scale);
      dv.h[i] = __float2bfloat16(pb * dO[i]);
    }
    if (j > 0) *reinterpret_cast<uint4*>(dbase + row) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dbase + row + hd) = dk.u;
    *reinterpret_cast<uint4*>(dbase + row + 2 * hd) = dv.u;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) dq_part[grp][d0 + i] = dq[i];
  __syncthreads();
  if (tid < ATT_D) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < CLSA_THREADS / 8; ++g) t += dq_part[g][tid];
    dbase[h * ATT_D + tid] = __float2bfloat16(t * scale);
  }
}

// One (64 columns of K, head, t): t = 0 u = (scale q0) . Wk^T, t = 1 w =
// dO . Wv^T, t = 2 z = dq0 . Wq^T of every image -> proj [B, 3, H, K]
// fp32; q0 and dq0 are row 0's q columns of qkv and dqkv.
static __global__ void __launch_bounds__(CLSP_THREADS)
cls_proj_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dattn,
                const __nv_bfloat16* __restrict__ dqkv, const __nv_bfloat16* __restrict__ w_eff,
                float* __restrict__ proj, int B, int S, int K, int H, float scale) {
  __shared__ float wt[ATT_D][ATT_D + 1];  // [head dim][column]
  __shared__ __align__(16) float av[ATT_D][ATT_D];  // [image][head dim]
  const int k0 = blockIdx.x * ATT_D, h = blockIdx.y, t = blockIdx.z;
  const int hd = H * ATT_D;
  const long long ld = 3LL * hd;
  const int tid = threadIdx.x;
  // the weight section of each vector: k for u, v for w, q for z
  const int sect = t == 0 ? 1 : (t == 1 ? 2 : 0);
  for (int i = tid; i < ATT_D * ATT_D; i += CLSP_THREADS) {
    const int kk = i / ATT_D, d = i % ATT_D;
    wt[d][kk] = __bfloat162float(w_eff[(long long)(k0 + kk) * ld + sect * hd + h * ATT_D + d]);
  }
  const int col = tid % ATT_D, bg = tid / ATT_D;
  for (int b0 = 0; b0 < B; b0 += ATT_D) {
    const int nb = min(ATT_D, B - b0);
    __syncthreads();  // wt is in place; the previous chunk's av reads are done
    for (int i = tid; i < nb * ATT_D; i += CLSP_THREADS) {
      const int bb = i / ATT_D, d = i % ATT_D;
      const long long b = b0 + bb;
      float v;
      if (t == 0)
        v = __bfloat162float(qkv[b * S * ld + h * ATT_D + d]) * scale;
      else if (t == 1)
        v = __bfloat162float(dattn[b * hd + h * ATT_D + d]);
      else
        v = __bfloat162float(dqkv[b * S * ld + h * ATT_D + d]);
      av[bb][d] = v;
    }
    __syncthreads();
    float acc[ATT_D / 4];
#pragma unroll
    for (int i = 0; i < ATT_D / 4; ++i) acc[i] = 0.f;
    // four of the head dim a step: an image's four values in one 16-byte
    // load (the warp's lanes share the image: a broadcast)
#pragma unroll 4
    for (int d = 0; d < ATT_D; d += 4) {
      const float w0 = wt[d][col], w1 = wt[d + 1][col], w2 = wt[d + 2][col],
                  w3 = wt[d + 3][col];
#pragma unroll
      for (int i = 0; i < ATT_D / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(&av[bg + 4 * i][d]);
        acc[i] += v.x * w0 + v.y * w1 + v.z * w2 + v.w * w3;
      }
    }
#pragma unroll
    for (int i = 0; i < ATT_D / 4; ++i) {
      const int bb = bg + 4 * i;
      if (bb < nb) proj[(((long long)(b0 + bb) * 3 + t) * H + h) * K + k0 + col] = acc[i];
    }
  }
}

// dxn of a warp's CLSR_ROWS rows at columns c .. c + 7: the rows' coef
// (sc, [row][2H]) against u and w of the image (uw4, [2H][K] fp32), and z
// summed over the heads (fp32, from proj) where the first row is row 0
static __device__ __forceinline__ void cls_dxn_chunk(
    float (&acc)[CLSR_ROWS][8], const float4* uw4,
    const float (&sc)[CLSR_ROWS][2 * CLS_MAX_HEADS], const float* pb, int c, int K, int H,
    bool row0) {
#pragma unroll
  for (int r = 0; r < CLSR_ROWS; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  for (int i = 0; i < 2 * H; ++i) {
    const float4 a = uw4[(i * K + c) / 4], bq = uw4[(i * K + c) / 4 + 1];
    const float v[8] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w};
#pragma unroll
    for (int r = 0; r < CLSR_ROWS; ++r) {
      const float cr = sc[r][i];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] += cr * v[e];
    }
  }
  if (row0) {
    for (int i = 0; i < H; ++i) {
      const float4* src = reinterpret_cast<const float4*>(pb + (long long)(2 * H + i) * K + c);
      const float4 a = __ldg(src), bq = __ldg(src + 1);
      const float v[8] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[0][e] += v[e];
    }
  }
}

// Block (c, b) takes rows 64 c .. + 63 of image b, warp w rows 64 c + 8 w
// .. + 7: u and w of the image (2H x K fp32) in shared memory, then dxn of
// its rows from coef and them (z from proj in row 0), then the LN
// backward.  x, dx, xn [B, S, K]; g [B, K].
static __global__ void __launch_bounds__(CLSR_THREADS)
cls_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                const float* __restrict__ coef, const float* __restrict__ proj,
                __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ xn, int S, int K,
                int H, float eps) {
  extern __shared__ float4 uw4[];  // [2H][K]: u of every head, then w
  __shared__ float sc[CLSR_THREADS / 32][CLSR_ROWS][2 * CLS_MAX_HEADS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int h2 = 2 * H;
  const float* pb = proj + (long long)b * 3 * H * K;  // u [H, K], w [H, K], z [H, K]
  for (int i = threadIdx.x; i < h2 * K / 4; i += CLSR_THREADS)
    uw4[i] = __ldg(reinterpret_cast<const float4*>(pb) + i);
  __syncthreads();
  const int j0 = (blockIdx.x * (CLSR_THREADS / 32) + warp) * CLSR_ROWS;
  if (j0 >= S) return;
  const int nr = min(CLSR_ROWS, S - j0);
  for (int i = lane; i < CLSR_ROWS * h2; i += 32)
    sc[warp][i / h2][i % h2] =
        i / h2 < nr ? coef[((long long)b * S + j0 + i / h2) * h2 + i % h2] : 0.f;
  __syncwarp();
  const long long row0 = (long long)b * S + j0;
  // the rows' fp32 statistics, ln_row_stats's sums in its lane order, the
  // rows' loads and butterflies interleaved; rows past S read row j0's
  float mean[CLSR_ROWS], rstd[CLSR_ROWS], m1[CLSR_ROWS], m2[CLSR_ROWS];
  const __nv_bfloat16* xr[CLSR_ROWS];
#pragma unroll
  for (int r = 0; r < CLSR_ROWS; ++r) {
    xr[r] = x + (row0 + (r < nr ? r : 0)) * K;
    mean[r] = 0.f, rstd[r] = 0.f, m1[r] = 0.f, m2[r] = 0.f;
  }
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Pack8 p[CLSR_ROWS];
#pragma unroll
    for (int r = 0; r < CLSR_ROWS; ++r) p[r].u = *reinterpret_cast<const uint4*>(xr[r] + c);
#pragma unroll
    for (int r = 0; r < CLSR_ROWS; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = __bfloat162float(p[r].h[i]);
        mean[r] += v;
        rstd[r] += v * v;
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < CLSR_ROWS; ++r) {
      mean[r] += __shfl_xor_sync(0xffffffffu, mean[r], o);
      rstd[r] += __shfl_xor_sync(0xffffffffu, rstd[r], o);
    }
#pragma unroll
  for (int r = 0; r < CLSR_ROWS; ++r) {
    const float mu = mean[r] / K;
    rstd[r] = rsqrtf(fmaxf(rstd[r] / K - mu * mu, 0.f) + eps);
    mean[r] = mu;
  }
  // sweep 1: xn, and the sums of dxn and dxn xn (the rows' x loaded
  // before the chunk's products, so their latency hides under them)
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Pack8 px[CLSR_ROWS];
#pragma unroll
    for (int r = 0; r < CLSR_ROWS; ++r) px[r].u = *reinterpret_cast<const uint4*>(xr[r] + c);
    float acc[CLSR_ROWS][8];
    cls_dxn_chunk(acc, uw4, sc[warp], pb, c, K, H, j0 == 0);
#pragma unroll
    for (int r = 0; r < CLSR_ROWS; ++r) {
      if (r >= nr) break;
      Pack8 o;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float n = (__bfloat162float(px[r].h[e]) - mean[r]) * rstd[r];
        m1[r] += acc[r][e];
        m2[r] += acc[r][e] * n;
        o.h[e] = __float2bfloat16(n);
      }
      *reinterpret_cast<uint4*>(xn + (row0 + r) * K + c) = o.u;
    }
  }
#pragma unroll
  for (int r = 0; r < CLSR_ROWS; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m1[r] += __shfl_xor_sync(0xffffffffu, m1[r], o);
      m2[r] += __shfl_xor_sync(0xffffffffu, m2[r], o);
    }
    m1[r] /= K;
    m2[r] /= K;
  }
  // sweep 2: dx, with the residual g in row 0; dxn recomputed, never stored
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Pack8 px[CLSR_ROWS], gp;
#pragma unroll
    for (int r = 0; r < CLSR_ROWS; ++r) px[r].u = *reinterpret_cast<const uint4*>(xr[r] + c);
    gp.u = j0 == 0 ? *reinterpret_cast<const uint4*>(g + (long long)b * K + c)
                   : make_uint4(0, 0, 0, 0);
    float acc[CLSR_ROWS][8];
    cls_dxn_chunk(acc, uw4, sc[warp], pb, c, K, H, j0 == 0);
#pragma unroll
    for (int r = 0; r < CLSR_ROWS; ++r) {
      if (r >= nr) break;
      Pack8 o;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float n = (__bfloat162float(px[r].h[e]) - mean[r]) * rstd[r];
        const float gv = j0 + r == 0 ? __bfloat162float(gp.h[e]) : 0.f;
        o.h[e] = __float2bfloat16(rstd[r] * (acc[r][e] - m1[r] - n * m2[r]) + gv);
      }
      *reinterpret_cast<uint4*>(dx + (row0 + r) * K + c) = o.u;
    }
  }
}

// The three launches after dattn = g . wo^T: qkv, dattn and w_eff in;
// dqkv, dx, xn out; coef [B, S, 2H] and proj [B, 3, H, K] fp32 scratch.
// Takes K a multiple of 64, H <= CLS_MAX_HEADS, 2 H K floats <=
// CLSR_MAX_UW_BYTES, pointers 16-byte aligned.
static inline cudaError_t launch_cls_bwd(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                         const __nv_bfloat16* qkv, const __nv_bfloat16* dattn,
                                         const __nv_bfloat16* w_eff, float* coef, float* proj,
                                         __nv_bfloat16* dqkv, __nv_bfloat16* dx,
                                         __nv_bfloat16* xn, int B, int S, int K, int H,
                                         float eps, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || H > CLS_MAX_HEADS || K < 64 || K % 64 != 0 || B > 65535 ||
      2LL * H * K * sizeof(float) > CLSR_MAX_UW_BYTES)
    return cudaErrorInvalidValue;
  const float scale = 0.125f;  // 1 / sqrt(64)
  cls_attn_bwd_kernel<<<dim3(B, H), CLSA_THREADS, 0, stream>>>(qkv, dattn, dqkv, coef, S, H,
                                                                scale);
  UML_TRY(cudaGetLastError());
  cls_proj_kernel<<<dim3(K / ATT_D, H, 3), CLSP_THREADS, 0, stream>>>(qkv, dattn, dqkv, w_eff,
                                                                      proj, B, S, K, H, scale);
  UML_TRY(cudaGetLastError());
  const int rows_per_block = (CLSR_THREADS / 32) * CLSR_ROWS;
  static const cudaError_t attr = cudaFuncSetAttribute(
      cls_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CLSR_MAX_UW_BYTES);
  UML_TRY(attr);
  cls_rows_kernel<<<dim3((S + rows_per_block - 1) / rows_per_block, B), CLSR_THREADS,
                    2 * H * K * (int)sizeof(float), stream>>>(x, g, coef, proj, dx, xn, S, K, H,
                                                              eps);
  return cudaGetLastError();
}

}  // namespace uml
