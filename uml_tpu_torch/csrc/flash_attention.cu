// uml_flash_attention: softmax(q k^T / sqrt(D)) v with an online softmax,
// q, k, v, out [B, H, S, D] bf16, D 64 or 128, any S, causal or not.
//
// Replaces uml_tpu/ops/attention.py::_flash_kernel.  One block per
// (batch*head, 64-query tile); K and V stream through shared memory in
// 64-key tiles, so shared memory does not grow with S (attention.cuh keeps
// a whole head's K/V there and stops at S = 400).  Four warps, each owning
// 16 query rows: per key tile a warp computes its 16 x 64 scores on the
// tensor cores (nvcuda::wmma bf16, fp32 accumulation), updates the rows'
// running max m and sum l in fp32, rounds P = exp(s - m) to bf16 and adds
// P . V to the output accumulators, which stay in registers as wmma
// fragments.  The accumulators are rescaled by exp(m_old - m_new) through a
// 16 x 16 fragment loaded from a tile holding that factor per row (two
// accumulator fragments of one type map elements to threads alike, so the
// product is elementwise).  At the end out = acc / max(l, 1e-30)
// (attention.py:147).
//
// Masking as the TPU kernel's (attention.py:119-122): key columns >= S and,
// when causal, columns above the diagonal contribute nothing; a causal
// block stops at its diagonal tile (query and key tiles are both 64 wide,
// so that is tile blockIdx.y), the skip of attention.py:136-141.  Padded
// query rows (>= S) are computed on zeros and never written.  The TPU
// kernel pads S to 128 and keeps P in fp32; here the ragged last tile is
// masked in place and P is bf16, as in mha_plain and attention.cuh.
//
// What bounds it on the H100: per (batch, head) it reads q, k, v and writes
// out once (4 S D 2 bytes) for 4 S^2 D FLOPs (half when causal): S/4
// FLOP/byte, so bytes at S = 197 (77.5 MB at B=64, H=12: 23 us) and the
// tensor cores from S ~ 1200 up (137 GFLOP at B=8, H=16, S=2048: 139 us).
// This first version is single-buffered (load tile, barrier, compute,
// barrier) and re-reads K/V once per query tile from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int FA_BQ = 64;        // query rows per block
constexpr int FA_BK = 64;        // keys per streamed tile
constexpr int FA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_LDS = FA_BK + 4;  // fp32 scores, per warp [16][FA_LDS]
constexpr int FA_LDP = FA_BK + 8;  // bf16 P, per warp [16][FA_LDP]

template <int D>
struct FaSmem {
  static constexpr int LDQ = D + 8;      // bf16 row stride of the Q, K, V tiles
  static constexpr int LDO = D + 4;      // fp32 row stride of the output staging
  static constexpr int STAGE = 16 * (LDO > FA_LDS ? LDO : FA_LDS);  // floats per warp
  static constexpr size_t BYTES =
      (size_t)(FA_BQ + 2 * FA_BK) * LDQ * 2   // Q, K, V tiles
      + (size_t)FA_WARPS * STAGE * 4          // scores, later the output staging
      + (size_t)FA_WARPS * 16 * FA_LDP * 2    // P
      + (size_t)FA_WARPS * 16 * 16 * 4        // per-row factor tiles
      + (size_t)2 * FA_BQ * 4;                // m, l
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int S, float scale) {
  using namespace nvcuda;
  using Sm = FaSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + FA_BQ * Sm::LDQ;
  __nv_bfloat16* Vs = Ks + FA_BK * Sm::LDQ;
  float* stage = reinterpret_cast<float*>(Vs + FA_BK * Sm::LDQ);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(stage + FA_WARPS * Sm::STAGE);
  float* factor = reinterpret_cast<float*>(Ps + FA_WARPS * 16 * FA_LDP);
  float* row_m = factor + FA_WARPS * 16 * 16;
  float* row_l = row_m + FA_BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // batch*head on grid.x (no 65535 cap), query tiles on grid.y
  const long long head = (long long)blockIdx.x * S * D;
  const int q0 = blockIdx.y * FA_BQ;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;
  constexpr int CPR = D / 8;  // 16-byte chunks per row

  for (int idx = tid; idx < FA_BQ * CPR; idx += FA_THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) qv = *reinterpret_cast<const uint4*>(qh + (long long)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * Sm::LDQ + c) = qv;
  }
  if (tid < FA_BQ) {
    row_m[tid] = -CUDART_INF_F;
    row_l[tid] = 0.f;
  }

  // the warp's 16 query rows: tile rows wr .. wr+15; a warp with no live
  // row still loads tiles and meets the barriers, but computes nothing
  const int wr = warp * 16;
  const bool live = q0 + wr < S;
  float* Sw = stage + warp * Sm::STAGE;
  __nv_bfloat16* Pw = Ps + warp * 16 * FA_LDP;
  float* Fw = factor + warp * 16 * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) wmma::fill_fragment(acc[c], 0.f);

  const int tiles_all = (S + FA_BK - 1) / FA_BK;
  const int n_tiles = CAUSAL ? min(tiles_all, (int)blockIdx.y + 1) : tiles_all;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();  // the previous tile's K/V are no longer read (and Q, m, l are set)
    for (int idx = tid; idx < FA_BK * CPR; idx += FA_THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kh + (long long)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vh + (long long)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * Sm::LDQ + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * Sm::LDQ + c) = vv;
    }
    __syncthreads();
    if (!live) continue;

    // scores of the warp's rows against the tile's 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc[FA_BK / 16];
#pragma unroll
      for (int n = 0; n < FA_BK / 16; ++n) wmma::fill_fragment(sc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq;
        wmma::load_matrix_sync(fq, Qs + wr * Sm::LDQ + 16 * kk, Sm::LDQ);
#pragma unroll
        for (int n = 0; n < FA_BK / 16; ++n) {
          // K^T as a column-major B operand is K row-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fk;
          wmma::load_matrix_sync(fk, Ks + 16 * n * Sm::LDQ + 16 * kk, Sm::LDQ);
          wmma::mma_sync(sc[n], fq, fk, sc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < FA_BK / 16; ++n)
        wmma::store_matrix_sync(Sw + 16 * n, sc[n], FA_LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, a row at a time: lane owns key columns lane, lane + 32
    for (int rr = 0; rr < 16; ++rr) {
      const int qi = q0 + wr + rr;
      float sv[2];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = k0 + lane + 32 * h;
        const bool valid = j < S && (!CAUSAL || j <= qi);
        sv[h] = valid ? Sw[rr * FA_LDS + lane + 32 * h] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, sv[h]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_m[wr + rr];
      const float m_new = fmaxf(m_old, mx);
      // a row with no valid key so far keeps m = -inf, l = 0 and P = 0
      const float alpha = (m_new == -CUDART_INF_F) ? 1.f : expf(m_old - m_new);
      float psum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = (sv[h] == -CUDART_INF_F) ? 0.f : expf(sv[h] - m_new);
        Pw[rr * FA_LDP + lane + 32 * h] = __float2bfloat16(p);
        psum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      __syncwarp();  // every lane has read m before lane 0 replaces it
      if (lane == 0) {
        row_m[wr + rr] = m_new;
        row_l[wr + rr] = row_l[wr + rr] * alpha + psum;
      }
      if (lane < 16) Fw[rr * 16 + lane] = alpha;
    }
    __syncwarp();

    // acc = acc * alpha (per row) + P . V
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fa;
      wmma::load_matrix_sync(fa, Fw, 16, wmma::mem_row_major);
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
#pragma unroll
        for (int i = 0; i < fa.num_elements; ++i) acc[c].x[i] *= fa.x[i];
#pragma unroll
      for (int kt = 0; kt < FA_BK / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp;
        wmma::load_matrix_sync(fp, Pw + 16 * kt, FA_LDP);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
          wmma::load_matrix_sync(fv, Vs + 16 * kt * Sm::LDQ + 16 * c, Sm::LDQ);
          wmma::mma_sync(acc[c], fp, fv, acc[c]);
        }
      }
    }
    __syncwarp();  // P, the scores and the factor tile are free for the next tile
  }
  if (!live) return;

  // out = acc / max(l, 1e-30): staged through shared memory, 8 columns a lane
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
    wmma::store_matrix_sync(Sw + 16 * c, acc[c], Sm::LDO, wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int rr = idx / CPR, c = (idx % CPR) * 8;
    const int qi = q0 + wr + rr;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(row_l[wr + rr], 1e-30f);
    union {
      uint4 u;
      __nv_bfloat16 h[8];
    } o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.h[j] = __float2bfloat16(Sw[rr * Sm::LDO + c + j] * inv);
    *reinterpret_cast<uint4*>(out + head + (long long)qi * D + c) = o.u;
  }
}

template <int D>
cudaError_t launch_flash(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         __nv_bfloat16* out, long long BH, int S, bool causal,
                         cudaStream_t stream) {
  const int q_tiles = (S + FA_BQ - 1) / FA_BQ;
  if (BH < 1 || BH > 2147483647LL || S < 1 || q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)BH, q_tiles);
  const int smem = (int)FaSmem<D>::BYTES;
  const float scale = D == 64 ? 0.125f : 0.08838834764831845f;  // 1 / sqrt(D)
  if (causal) {
    cudaFuncSetAttribute(flash_attention_kernel<D, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_attention_kernel<D, true><<<grid, FA_THREADS, smem, stream>>>(q, k, v, out, S, scale);
  } else {
    cudaFuncSetAttribute(flash_attention_kernel<D, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_attention_kernel<D, false><<<grid, FA_THREADS, smem, stream>>>(q, k, v, out, S, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int uml_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   long long BH, int S, int D, int causal, void* stream) {
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_flash<64>(qp, kp, vp, op, BH, S, causal != 0, st);
  if (D == 128) return (int)launch_flash<128>(qp, kp, vp, op, BH, S, causal != 0, st);
  return (int)cudaErrorInvalidValue;
}
