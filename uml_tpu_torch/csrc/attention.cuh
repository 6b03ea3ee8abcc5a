// attention: softmax(q k^T / sqrt(D)) v for one (image, head, 64-query
// tile) per block, on the packed qkv of a CLIP layer.
//
// It replaces the attention inside the TPU kernels of
// uml_tpu/ops/fused_attention.py: _pair_attention_split as called by
// _block_kernel (all query rows, causal or not) and _block_cls_kernel
// (query row 0 only: q_rows = 1 here; the TPU's 8-row CLS_ROWS tile is a
// sublane artifact and is not copied).
//
//   qkv [B, S, 3*H*64] bf16: q at column h*64, k at H*64 + h*64,
//                            v at 2*H*64 + h*64 (the packed flax layout)
//   out [B, q_rows, H*64] bf16: query rows 0 .. q_rows-1
//
// K and V of the head stay in shared memory for the whole block (S <= 400
// rows; ViT-B/16's S = 197 takes 2 x 29 KB), the fp32 scores of the
// block's 64 query rows beside them; scores and P.V run on the tensor
// cores (nvcuda::wmma bf16, fp32 accumulation).  The softmax keeps the
// exact row max in fp32 for both the causal and the non-causal path (the
// TPU's non-causal max-free exp2 with its clamp at 96 is a VPU saving that
// a row max in registers does not need).  P is rounded to bf16
// unnormalized and the 1/rowsum is applied to the fp32 P.V, as the TPU
// kernel does.
//
// What bounds it on the H100: per (image, head) it reads S x 64 x 2 bf16
// of K/V (50 KB at S = 197) and does 4 x S x S x 64 FLOPs (9.9 MFLOP),
// ~200 FLOP/byte, so with L2 absorbing the re-reads of K/V by the four
// query tiles it is compute- and latency-bound; its dynamic shared memory
// (121 KB at S = 197) allows one block of 4 warps per SM, which is the
// first thing a faster version (flash-style K/V streaming) would change.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace uml {

constexpr int ATT_D = 64;              // head dim (every CLIP / DINO tower)
constexpr int ATT_BQ = 64;             // query rows per block
constexpr int ATT_THREADS = 128;       // 4 warps x 16 query rows
constexpr int ATT_LDK = ATT_D + 8;     // bf16 elements
constexpr int ATT_MAX_SPAD = 400;      // shared-memory bound, see attention_smem_bytes
constexpr int ATT_MAXT = (ATT_MAX_SPAD + 31) / 32;

__host__ __device__ inline int attention_spad(int s) { return (s + 15) / 16 * 16; }
// fp32 row stride of the score buffer, which later holds the 64-column
// P.V output of the same rows: at least 64 columns, +4 against bank
// conflicts (a multiple of 4, as wmma's fp32 ldm must be)
__host__ __device__ inline int attention_lds(int s) {
  const int sp = attention_spad(s);
  return (sp > ATT_D ? sp : ATT_D) + 4;
}

static inline size_t attention_smem_bytes(int s) {
  const int sp = attention_spad(s);
  return (size_t)2 * sp * ATT_LDK * 2      // K, V
         + (size_t)ATT_BQ * ATT_LDK * 2    // Q
         + (size_t)ATT_BQ * attention_lds(s) * 4  // fp32 scores (P and O alias it)
         + (size_t)ATT_BQ * 4;             // 1 / rowsum
}

template <bool CAUSAL>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                 int S, int H, int q_rows, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = attention_spad(S);
  const int lds = attention_lds(S);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + sp * ATT_LDK;
  __nv_bfloat16* Qs = Vs + sp * ATT_LDK;
  float* Ss = reinterpret_cast<float*>(Qs + ATT_BQ * ATT_LDK);
  float* row_inv = Ss + ATT_BQ * lds;
  // P (bf16, row stride 2*lds) aliases the fp32 scores row by row
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss);

  // images on grid.x (no 65535 cap on the batch), heads on y, query tiles on z
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * ATT_BQ;
  const int hd = H * ATT_D;
  const long long row_stride = 3LL * hd;
  const __nv_bfloat16* base = qkv + (long long)b * S * row_stride;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // K, V: all S rows of this head (rows S..sp-1 zero); Q: the tile's rows
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
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (qi < q_rows) qv = *reinterpret_cast<const uint4*>(base + qi * row_stride + h * ATT_D + c);
    *reinterpret_cast<uint4*>(Qs + r * ATT_LDK + c) = qv;
  }
  __syncthreads();

  // scores: warp w owns query rows 16w .. 16w+15 of the tile; from here on
  // every step is warp-local, so a warp with no live query row leaves
  const int wr = warp * 16;
  if (q0 + wr >= q_rows) return;
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq[ATT_D / 16];
#pragma unroll
    for (int kk = 0; kk < ATT_D / 16; ++kk)
      wmma::load_matrix_sync(fq[kk], Qs + wr * ATT_LDK + 16 * kk, ATT_LDK);
    for (int n = 0; n < sp / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < ATT_D / 16; ++kk) {
        // K^T as a column-major B operand is K row-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, Ks + 16 * n * ATT_LDK + 16 * kk, ATT_LDK);
        wmma::mma_sync(acc, fq[kk], fk, acc);
      }
      wmma::store_matrix_sync(Ss + wr * lds + 16 * n, acc, lds, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // row softmax in fp32 (exact row max), P = bf16(exp(s - max)) unnormalized
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wr + rr;
    const int qi = q0 + r;
    const float* srow = Ss + r * lds;
    float vals[ATT_MAXT];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < ATT_MAXT; ++t) {
      const int j = lane + 32 * t;
      float v = -CUDART_INF_F;
      if (j < S && (!CAUSAL || j <= qi)) v = srow[j] * scale;
      vals[t] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < ATT_MAXT; ++t) {
      const float e = (vals[t] == -CUDART_INF_F) ? 0.f : expf(vals[t] - mx);
      vals[t] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();  // every lane has read the fp32 row before P overwrites it
    __nv_bfloat16* prow = Ps + r * (2 * lds);
#pragma unroll
    for (int t = 0; t < ATT_MAXT; ++t) {
      const int j = lane + 32 * t;
      if (j < sp) prow[j] = __float2bfloat16(vals[t]);
    }
    if (lane == 0) row_inv[r] = (qi < q_rows && sum > 0.f) ? 1.f / sum : 0.f;
    __syncwarp();
  }

  // O = P . V for the warp's 16 rows, 64 columns
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[ATT_D / 16];
#pragma unroll
    for (int c = 0; c < ATT_D / 16; ++c) wmma::fill_fragment(acc[c], 0.f);
    for (int kt = 0; kt < sp / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, Ps + wr * (2 * lds) + 16 * kt, 2 * lds);
#pragma unroll
      for (int c = 0; c < ATT_D / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + 16 * kt * ATT_LDK + 16 * c, ATT_LDK);
        wmma::mma_sync(acc[c], fp, fv, acc[c]);
      }
    }
    __syncwarp();  // all P reads done before O overwrites the warp's rows
#pragma unroll
    for (int c = 0; c < ATT_D / 16; ++c)
      wmma::store_matrix_sync(Ss + wr * lds + 16 * c, acc[c], lds, wmma::mem_row_major);
  }
  __syncwarp();

  // out = O / rowsum, two columns per lane
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wr + rr;
    const int qi = q0 + r;
    if (qi >= q_rows) break;
    const float inv = row_inv[r];
    const float2 o = *reinterpret_cast<const float2*>(Ss + r * lds + 2 * lane);
    *reinterpret_cast<__nv_bfloat162*>(out + ((long long)b * q_rows + qi) * hd + h * ATT_D +
                                       2 * lane) = __floats2bfloat162_rn(o.x * inv, o.y * inv);
  }
}

// Launch the attention of all B x H heads on `stream`; returns
// cudaGetLastError().  The wrapper checks S <= ATT_MAX_SPAD and head dim 64.
static inline cudaError_t launch_attention(const __nv_bfloat16* qkv, __nv_bfloat16* out,
                                           int B, int S, int H, int q_rows, bool causal,
                                           cudaStream_t stream) {
  if (attention_spad(S) > ATT_MAX_SPAD) return cudaErrorInvalidValue;
  const size_t smem = attention_smem_bytes(S);
  const dim3 grid(B, H, (q_rows + ATT_BQ - 1) / ATT_BQ);
  const float scale = 0.125f;  // 1 / sqrt(64)
  if (causal) {
    cudaFuncSetAttribute(attention_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    attention_kernel<true><<<grid, ATT_THREADS, smem, stream>>>(qkv, out, S, H, q_rows, scale);
  } else {
    cudaFuncSetAttribute(attention_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    attention_kernel<false><<<grid, ATT_THREADS, smem, stream>>>(qkv, out, S, H, q_rows, scale);
  }
  return cudaGetLastError();
}

}  // namespace uml
