// uml_moe_gemm: the routed experts' products of a MoE layer in one launch,
// float32, with each expert's row count read on the device.
//
// Replaces no TPU kernel: uml_tpu has no mixture of experts.  It carries
// models/deepseek_v2.py's routed experts on the card, where one product a
// projection an expert (64 x 3 cuBLAS launches a layer) left the host
// sizing each product after reading the experts' row counts, so the host
// and its synchronisations paced the call.
//
//   a        [R, K] fp32, contiguous: the routed (token, slot) rows sorted
//            by expert, expert g's rows offsets[g] .. offsets[g + 1]
//   w0, w1   device arrays of G pointers, expert g's weight [N, K] fp32
//            row-major (nn.Linear's layout); w1 only with swiglu
//   offsets  [G + 1] int32 on the device, offsets[0] = 0, offsets[G] = R
//   c        [R, N] fp32: swiglu ? silu(a w0^T) * (a w1^T) : a w0^T
//   tiles    the grid's row tiles, at least ceil(R / 64) + G (the host
//            knows R, not the counts)
//   N a multiple of 64 (swiglu) or 128, K a multiple of 16
//
// A block computes a 64-row x 128-column tile with 256 threads, 4 x 8
// outputs a thread, over K in steps of 16 staged through shared memory
// (the next step's tile is loaded into registers while this one is
// multiplied).  Under swiglu the 128 columns are 64 of w0 and the same 64
// of w1, and the epilogue writes silu(gate) * up.  Row tiles are numbered
// expert by expert; each block finds its expert by a scan of the G tile
// counts (G <= 256), and blocks past the last tile return at once.  Rows
// past an expert's end load zeros and are not written.  The products are
// plain FFMA in float32, as the configuration states (TF32 would not
// be): the card's 67 TFLOP/s outside the tensor cores bound them, and at
// DeepSeek-V2-Lite's widths each expert's weights (11.5 MB a projection)
// are read once a tile column, so at ~100 rows an expert the weights'
// bytes weigh as much as the operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MG_BM = 64;       // rows a block
constexpr int MG_BN = 128;      // columns a block (64 + 64 under swiglu)
constexpr int MG_BK = 16;       // depth a step
constexpr int MG_THREADS = 256;
constexpr int MG_PAD = 4;       // shared rows padded: fewer bank conflicts, 16-byte aligned

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(MG_THREADS)
moe_gemm_kernel(const float* __restrict__ a, const float* const* __restrict__ w0,
                const float* const* __restrict__ w1, const int* __restrict__ offsets,
                float* __restrict__ c, int groups, int n, int k, int swiglu) {
  __shared__ __align__(16) float as[MG_BK][MG_BM + MG_PAD];
  __shared__ __align__(16) float ws[MG_BK][MG_BN + MG_PAD];
  __shared__ int warp_sum[MG_THREADS / 32];
  __shared__ int s_group, s_row0, s_rows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's expert: an inclusive scan of the experts' tile counts
  int rows = 0, tiles = 0;
  if (tid < groups) {
    rows = offsets[tid + 1] - offsets[tid];
    tiles = (rows + MG_BM - 1) / MG_BM;
  }
  int v = tiles;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (tid == 0) s_group = -1;
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_sum[w];
  const int tile = blockIdx.x, first = v - tiles;
  if (tid < groups && tile >= first && tile < v) {
    s_group = tid;
    s_row0 = offsets[tid] + (tile - first) * MG_BM;
    s_rows = min(MG_BM, rows - (tile - first) * MG_BM);
  }
  __syncthreads();
  const int group = s_group;
  if (group < 0) return;
  const int row0 = s_row0, nrows = s_rows;
  const int n_out = swiglu ? MG_BN / 2 : MG_BN;   // output columns a block
  const int col0 = blockIdx.y * n_out;

  // loads: a thread brings 4 consecutive k of one A row and of two W rows
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const float* ap = a + (size_t)(row0 + lr) * k + lk;
  const bool a_live = lr < nrows;
  const float* wa = w0[group] + (size_t)(col0 + lr) * k + lk;
  const float* wb = swiglu ? w1[group] + (size_t)(col0 + lr) * k + lk
                           : w0[group] + (size_t)(col0 + 64 + lr) * k + lk;
  // products: rows ty*4 + i, columns tx*4 + j and 64 + tx*4 + j
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra = a_live ? *reinterpret_cast<const float4*>(ap) : make_float4(0, 0, 0, 0);
  float4 rwa = *reinterpret_cast<const float4*>(wa);
  float4 rwb = *reinterpret_cast<const float4*>(wb);
  for (int k0 = 0; k0 < k; k0 += MG_BK) {
    as[lk + 0][lr] = ra.x; as[lk + 1][lr] = ra.y; as[lk + 2][lr] = ra.z; as[lk + 3][lr] = ra.w;
    ws[lk + 0][lr] = rwa.x; ws[lk + 1][lr] = rwa.y; ws[lk + 2][lr] = rwa.z; ws[lk + 3][lr] = rwa.w;
    ws[lk + 0][64 + lr] = rwb.x; ws[lk + 1][64 + lr] = rwb.y;
    ws[lk + 2][64 + lr] = rwb.z; ws[lk + 3][64 + lr] = rwb.w;
    __syncthreads();
    if (k0 + MG_BK < k) {
      const int off = k0 + MG_BK;
      ra = a_live ? *reinterpret_cast<const float4*>(ap + off) : make_float4(0, 0, 0, 0);
      rwa = *reinterpret_cast<const float4*>(wa + off);
      rwb = *reinterpret_cast<const float4*>(wb + off);
    }
#pragma unroll
    for (int kk = 0; kk < MG_BK; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 p = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 q = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float xr[4] = {x.x, x.y, x.z, x.w};
      const float wr[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrows) continue;
    float* out = c + (size_t)(row0 + r) * n + col0;
    if (swiglu) {
      *reinterpret_cast<float4*>(out + tx * 4) =
          make_float4(silu(acc[i][0]) * acc[i][4], silu(acc[i][1]) * acc[i][5],
                      silu(acc[i][2]) * acc[i][6], silu(acc[i][3]) * acc[i][7]);
    } else {
      *reinterpret_cast<float4*>(out + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(out + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

}  // namespace

extern "C" int uml_moe_gemm(const void* a, const void* w0, const void* w1, const void* offsets,
                            void* c, int groups, int tiles, int n, int k, int swiglu,
                            void* stream) {
  if (groups < 1 || groups > MG_THREADS || k % MG_BK != 0 || n % (swiglu ? 64 : 128) != 0)
    return (int)cudaErrorInvalidValue;
  if (tiles == 0) return 0;
  const dim3 grid(tiles, n / (swiglu ? MG_BN / 2 : MG_BN));
  moe_gemm_kernel<<<grid, MG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float* const*>(w0),
      static_cast<const float* const*>(w1), static_cast<const int*>(offsets),
      static_cast<float*>(c), groups, n, k, swiglu);
  return (int)cudaGetLastError();
}
