// gemm_at: C = A^T . B, contracting over the rows of both operands; bf16
// operands, fp32 accumulation, fp32 output.
//
// The weight-gradient products that uml_tpu/ops/ln_matmul.py::
// _mlp_bwd_dw_kernel accumulates in its own body over the sequential batch
// grid (dw1 += xn^T . dpre, dw2 += yact^T . g, ln_matmul.py:528-533).
//
//   A [R, P] bf16, row-major, contiguous (xn [rows, K] or yact [rows, M])
//   B [R, N] bf16, row-major, contiguous (dpre [rows, M] or g [rows, K])
//   C [P, N] fp32, row-major, contiguous; overwritten
//
// P and N must be multiples of 64; R is any count (TMA zero-fills the last
// row tile).  What bounds it on the H100: at ViT-B/16 B=64 each product is
// 2 x 12608 x 768 x 3072 = 59.5 GFLOP over 97 MB of operands, far above
// the ~295 FLOP/byte ridge, so the tensor cores bound it.  It runs on the
// wgmma engine (wgmma_gemm.cuh) with A as an M-major and B as an N-major
// operand, read in place.  C has few tiles (6 x 24 = 144 of 128 x 128 at
// that shape, a wave and a ninth of the 132 SMs) and a long contraction,
// so the rows are split into `splits` chunks: chunk 0 writes C, chunk z >
// 0 its fp32 partial to slab z-1 of a workspace the caller provides, and a
// second launch adds the slabs into C in chunk order, the same sums in the
// same order on every run.  Nothing waits on another block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma_gemm.cuh"

namespace uml {

constexpr int GAT_MAX_SPLITS = 8;  // row chunks at most (workspace: 7 slabs of P x N)

// the number of row chunks (1..GAT_MAX_SPLITS, at least 8 k-steps each)
// that minimizes a cost in microseconds: the busiest SM's share of the
// products (tiles x s items, each 1/s of a tile, over the SMs) plus the
// partials' round trip (8 P N bytes a chunk past the first).  The rates
// are the H100's as the engine runs: a 64-row step of a 128 x 128 tile
// 0.42 us (one chunk, 144 tiles: 0.167 ms at 197 steps, two tiles on the
// busiest SM), the partials at ~2.5 TB/s; at row 20's shapes this picks 3
// chunks, the fastest of 1..8 there (0.133 and 0.123 ms against 0.167 and
// 0.156 for one chunk)
static inline int gemm_at_splits(int tiles, int k_steps, long long pn) {
  const int sms = wgmma_block_slots() / WGG_BLOCKS_PER_SM;
  const double tile_us = 0.42 * k_steps, slab_us = 8.0 * (double)pn / 2.5e6;
  double best = 0.0;
  int pick = 1;
  for (int s = 1; s <= GAT_MAX_SPLITS && (s == 1 || k_steps / s >= 8); ++s) {
    const long long per_sm = ((long long)tiles * s + sms - 1) / sms;
    const double cost = tile_us * (double)per_sm / s + slab_us * (s - 1);
    if (s == 1 || cost < best) {
      best = cost;
      pick = s;
    }
  }
  return pick;
}

// c[i] += part[0][i] + part[1][i] + ..., added in slab order; n4 float4s
static __global__ void gemm_at_add_parts_kernel(float4* __restrict__ c,
                                                const float4* __restrict__ part, int parts,
                                                long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 t = c[i];
    for (int z = 0; z < parts; ++z) {
      const float4 p = __ldcs(part + (long long)z * n4 + i);
      t.x += p.x;
      t.y += p.y;
      t.z += p.z;
      t.w += p.w;
    }
    c[i] = t;
  }
}

// Launch one gemm_at on `stream`; returns the launch error.  ws: fp32
// scratch of ws_floats for the partials (chunks are cut to what fits: up
// to (GAT_MAX_SPLITS - 1) P N floats are used), or null; splits: the row
// chunks, or 0 for gemm_at_splits' choice.
static inline cudaError_t launch_gemm_at(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                         float* c, float* ws, long long ws_floats, int R, int P,
                                         int N, int splits, cudaStream_t stream) {
  if (P % 64 != 0 || N % 64 != 0 || splits < 0 || splits > GAT_MAX_SPLITS ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0 || reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return cudaErrorInvalidValue;
  const int tiles = ((P + WGG_BM - 1) / WGG_BM) * ((N + WGG_BN - 1) / WGG_BN);
  const int k_steps = (R + WGG_BK - 1) / WGG_BK;
  const long long pn = (long long)P * N;
  int s = splits > 0 ? splits : gemm_at_splits(tiles, k_steps, pn);
  s = (int)std::min<long long>(s, 1 + (ws != nullptr ? ws_floats / pn : 0));
  s = std::max(1, std::min(s, k_steps));
  const int per = (k_steps + s - 1) / s;
  s = (k_steps + per - 1) / per;  // every chunk non-empty
  WggEpilogue ep;
  ep.out = c;
  ep.splits = s;
  ep.part = ws;
  const cudaError_t e = launch_wgmma_gemm<true, true, WGG_OUT_F32>(a, b, ep, P, N, R, stream);
  if (e != cudaSuccess || s == 1) return e;
  const long long n4 = pn / 4;
  const int blocks = (int)std::min<long long>((n4 + 255) / 256, 4LL * wgmma_block_slots());
  gemm_at_add_parts_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<float4*>(c),
                                                       reinterpret_cast<const float4*>(ws),
                                                       s - 1, n4);
  return cudaGetLastError();
}

// db1 = the column sums of dpre: the per-row-tile partial sums that
// ln_gemm's EPI_DACT_F32 epilogue wrote, part [tiles, N], added in tile
// order (one thread per column).
static __global__ void colsum_parts_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int tiles, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float t = 0.f;
  for (int i = 0; i < tiles; ++i) t += part[(long long)i * N + n];
  out[n] = t;
}

static inline cudaError_t launch_colsum_parts(const float* part, float* out, int tiles, int N,
                                              cudaStream_t stream) {
  colsum_parts_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part, out, tiles, N);
  return cudaGetLastError();
}

}  // namespace uml
