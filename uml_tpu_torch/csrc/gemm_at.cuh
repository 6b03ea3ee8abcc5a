// gemm_at: C = A^T . B, contracting over the rows of both operands; bf16
// operands, fp32 accumulation, fp32 output.
//
// The weight-gradient products that uml_tpu/ops/ln_matmul.py::
// _mlp_bwd_dw_kernel accumulates in its own body over the sequential batch
// grid (dw1 += xn^T . dpre, dw2 += yact^T . g, ln_matmul.py:528-533).
// Hopper's blocks cannot carry a sum from one grid step to the next, so
// here each block owns one 64 x 64 tile of C and walks all R rows itself.
//
//   A [R, P] bf16, row-major, contiguous (xn [rows, K] or yact [rows, M])
//   B [R, N] bf16, row-major, contiguous (dpre [rows, M] or g [rows, K])
//   C [P, N] fp32, row-major, contiguous; overwritten
//
// P and N must be multiples of 64; R is any count (the last row tile is
// zero-filled).  What bounds it on the H100: at ViT-B/16 B=64 each product
// is 2 x 12608 x 768 x 3072 = 59.5 GFLOP over 97 MB of operands, far above
// the ~295 FLOP/byte ridge, so the tensor cores bound it.  This first
// version runs nvcuda::wmma (16x16x16 bf16) on 64 x 64 tiles with a
// register-prefetched row loop, as ln_gemm does: 576 blocks at that shape,
// each walking 394 row tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "ln_gemm.cuh"

namespace uml {

constexpr int GAT_BP = 64;
constexpr int GAT_BN = 64;
constexpr int GAT_BR = 32;
constexpr int GAT_THREADS = 128;   // 4 warps, 2 x 2, each 32 x 32 of C
constexpr int GAT_LD = 64 + 8;     // bf16 elements; padding vs bank conflicts

// static: a __global__ in a header that several .cu files may include
static __global__ void __launch_bounds__(GAT_THREADS)
gemm_at_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
               float* __restrict__ c, int R, int P, int N) {
  using namespace nvcuda;
  // row tile [GAT_BR][GAT_LD] of A (columns p0..p0+63) and of B
  __shared__ __align__(128) __nv_bfloat16 As[GAT_BR * GAT_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[GAT_BR * GAT_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * GAT_BP;
  const int n0 = blockIdx.y * GAT_BN;
  // per row tile each thread moves 16 elements of A and 16 of B: row lr,
  // columns lc..lc+15
  const int lr = tid >> 2;
  const int lc = (tid & 3) * 16;

  Pack8 ra[2], rb[2];
  auto load_global = [&](int r0) {
    const int gr = r0 + lr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (gr < R) {
        ra[i].u = *reinterpret_cast<const uint4*>(a + (long long)gr * P + p0 + lc + 8 * i);
        rb[i].u = *reinterpret_cast<const uint4*>(b + (long long)gr * N + n0 + lc + 8 * i);
      } else {
        ra[i].u = make_uint4(0, 0, 0, 0);
        rb[i].u = make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store_shared = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(&As[lr * GAT_LD + lc + 8 * i]) = ra[i].u;
      *reinterpret_cast<uint4*>(&Bs[lr * GAT_LD + lc + 8 * i]) = rb[i].u;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int wp = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int nr = (R + GAT_BR - 1) / GAT_BR;
  load_global(0);
  for (int rt = 0; rt < nr; ++rt) {
    store_shared();
    __syncthreads();
    if (rt + 1 < nr) load_global((rt + 1) * GAT_BR);
#pragma unroll
    for (int kk = 0; kk < GAT_BR; kk += 16) {
      // A^T as the matrix_a operand: the [rows][p] tile read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[kk * GAT_LD + wp + 16 * i], GAT_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * GAT_LD + wn + 16 * j], GAT_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c + (long long)(p0 + wp + 16 * i) * N + n0 + wn + 16 * j,
                              acc[i][j], N, wmma::mem_row_major);
}

// Launch one gemm_at on `stream`; returns cudaGetLastError() after it.
static inline cudaError_t launch_gemm_at(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                         float* c, int R, int P, int N, cudaStream_t stream) {
  if (P % GAT_BP != 0 || N % GAT_BN != 0) return cudaErrorInvalidValue;
  gemm_at_kernel<<<dim3(P / GAT_BP, N / GAT_BN), GAT_THREADS, 0, stream>>>(a, b, c, R, P, N);
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
