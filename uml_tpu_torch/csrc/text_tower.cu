// uml_text_tower: all L causal layers of the CLIP text tower in one launch.
//
// Replaces uml_tpu/ops/text_tower.py::_tower_kernel, which runs the whole
// tower as one program: the residual of a group of sequences stays in
// VMEM for all layers, the weights stream by layer, the projections run
// group-flat over the group's rows and only the causal attention runs per
// sequence.
//
// What bounds it on the H100.  At the main path's shape, B = 1 (features
// encodes one class's prompts a call: one prompt under the default
// --text_augmentation), the tower does 5.8 GFLOP and reads 12 x 6.3 MB of
// weights: bytes, ~0.023 ms at 3.35 TB/s.  At B = 64 it does 372 GFLOP:
// the tensor cores, ~0.38 ms.  A chain of launches (6 a layer) pays each
// launch's fill and drain 72 times, and every intermediate makes a
// device-memory round trip at every boundary.
//
// The design (text_tower_fused(): S <= 128, K <= 512, H*64 <= 512, which
// takes the ViT-B text tower; the ViT-L/14 text tower, K = 768, and S >
// 128 take the chain below, a route between two hand-written paths):
//
// * One persistent launch: a grid of one block per SM (sized by the
//   occupancy API) walks a table of work items that the host plans
//   (ops/text_tower.py::tower_plan).  An item is one stage of one layer for
//   one group of whole sequences, seven stages a layer: LN1 (xn =
//   rawLN(residual) of 32 rows), QKV (xn . w_eff + b_eff on 128 rows by
//   64 or 128 columns), ATTN (one sequence, one head), OUT (attn . wo + bo
//   + the residual), LN2, MLP_IN (quick_gelu(xn . w1 + b1)), MLP_OUT
//   (hidden . w2 + b2 + the residual).  Block b takes items b, b + grid,
//   ... in order.
// * A counter per (group, layer, stage) in device memory takes the place
//   of a kernel boundary: a block signals it (release, after a barrier of
//   its consumers and a proxy fence) when an item is done, and the item
//   that needs the stage complete waits for its count (acquire, then a
//   proxy fence before its TMA loads).  Sequences never interact, so no
//   grid-wide barrier is needed.  Every item's dependency comes earlier in
//   the table and every block is resident, so the least unfinished item
//   can always run: no deadlock.  The last block out sets the counters
//   back to zero for the next call.
// * Groups: at B = 64 groups of 8 sequences (616 rows in five 128-row
//   tiles: 96% of the rows real, where a 77-row sequence alone pads to
//   128) run their products group-flat over 128 columns.  At B = 1 the
//   products run 64 columns wide (the kernel is built for both widths;
//   tower_plan picks one for the call), and the out-projection and the MLP
//   out split their contraction in 2 and 4 parts (a part's fp32 sums to
//   scratch, the last part to arrive adds the parts in order and runs the
//   epilogue: the result does not depend on the arrival order), so that
//   16-32 SMs stream each stage's weights; every block prefetches its share
//   of the next layer's weights into L2 (cp.async.bulk.prefetch.L2) when
//   it first meets a layer.
// * The intermediates (the residual in out, xn, q/k/v, the attention
//   output, the hidden) live in scratch that is written and read once a
//   stage: 50 MB at B = 64 (mostly L2-resident), 0.8 MB at B = 1.  The
//   residual is rounded to bf16 where the TPU kernel rounds it
//   (text_tower.py:104-109, 120-121); xn, q/k/v, the attention output and
//   the hidden once each.  LN items keep ln_gemm.cuh's statistics and
//   arithmetic, so xn is the chain's bit for bit.
// * Every product runs on wgmma (m64n128k16 or m64n64k16, two consumer
//   warpgroups of 64 rows) fed by TMA through two rings, the activations'
//   (8 stages of 128 rows x 64) and the weights' (6 stages of 64 rows x 128
//   columns), which the producer fills across item boundaries.  ATTN
//   takes q, k and v of its sequence's head as three stages of the first
//   ring (an LN item one stage with no bytes: the ring's empty barriers
//   keep the producer from running ahead of the consumers on every item)
//   and runs qkv_attention.cu's softmax for one 128-key chunk: each
//   query row's max over all its keys first, P rounded once against it
//   (MAX_FIRST), the causal mask and keys >= S masked.
// * tools/exp_torch_tower_trace.py timestamps the items' phases.
//
// Budget: shared memory 8 x 16 KB + 6 x 16 KB of rings + barriers, 230,624
// bytes, one block per SM; 288 threads (two consumer warpgroups and a
// producer warp, one thread of which walks the table ahead of the
// consumers, waits for each item's stage and issues its loads); 168
// registers a thread (ptxas -v).
//
// The chain (every other shape): a host loop over the layers of the
// attention half (the LN pre-pass, qkv_attention.cu at S <= 256 or the
// QKV product and flash_attention.cu above, the out-projection) and the
// MLP half (the LN pre-pass and both products on the engine) of
// blocks.cuh, 6 L launches.
//
//   x [B, S, K]; stacked weights w_eff [L, K, 3K'], b_eff [L, 3K'],
//   wo [L, K', K], bo [L, K], w1 [L, K, M], b1 [L, M], w2 [L, M, K],
//   b2 [L, K] with K' = H*64; out [B, S, K].
//   The tower launch: xn [B*S, K], qkv [B*S, 3K'], attn [B*S, K'],
//   hidden [B*S, M] scratch, partial fp32 scratch of the split tiles;
//   plan [n_items, TT_FIELDS] int32 (tower_plan's table); counters
//   [n_counters + 1] int32, zero (and left zero); bn 64 or 128.
//   The chain: xn, attn, hidden, mid scratch, and qkv above S = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blocks.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TT_MAX_S = 128;   // one 128-key chunk of attention
constexpr int TT_MAX_K = 512;   // the widths the route takes (the LN's rows in registers)
constexpr int TT_CONSUMERS = 256;
constexpr int TT_PRODUCER = TT_CONSUMERS;       // the producer warp's first thread
constexpr int TT_THREADS = TT_CONSUMERS + 32;
constexpr int TT_BM = 128;
constexpr int TT_PANEL = 64 * 128;              // 64 rows of 128 bytes
constexpr int TT_BOX = TT_BM * 128;             // 128 rows x 64 columns: 16 KB
constexpr int TT_ASTAGES = 8;                   // the activation ring: 128 rows x 64 a stage
constexpr int TT_BSTAGES = 6;                   // the weight ring: 64 rows x 128 columns a stage
constexpr int TT_BSTAGE = 2 * TT_PANEL;         // 16 KB
constexpr int TT_LN_ROWS = 32;                  // rows of an LN item: 4 a warp
constexpr int TT_BARRIERS = 2 * TT_BSTAGES + 2 * TT_ASTAGES;
constexpr size_t TT_SMEM =
    1024 + (size_t)TT_ASTAGES * TT_BOX + (size_t)TT_BSTAGES * TT_BSTAGE + 8 * TT_BARRIERS;

// the item table (ops/text_tower.py::tower_plan writes the same fields)
constexpr int TT_FIELDS = 14;
enum { TT_OP = 0, TT_LAYER, TT_ROW0, TT_ROWS, TT_COL0, TT_BN, TT_WAIT, TT_TARGET, TT_SIGNAL,
       TT_KN, TT_PARTS, TT_PART, TT_POFF, TT_TILE };
enum { OP_LN1 = 0, OP_QKV = 1, OP_ATTN = 2, OP_OUT = 3, OP_LN2 = 4, OP_MLP_IN = 5, OP_MLP_OUT = 6 };

struct TtArgs {
  const bf16* x;
  bf16* out;
  bf16* xn;
  bf16* qkv;
  bf16* attn;
  bf16* hidden;
  float* partial;  // split tiles' fp32 parts
  const float *b_eff, *bo, *b1, *b2;
  const bf16 *w_eff, *wo, *w1, *w2;  // for the L2 prefetch
  const int* plan;
  int* counters;
  int n_items, n_counters;
  int S, K, H, M, L;
  float eps, scale_log2;
};

static __device__ __forceinline__ void tt_wait(const int* cnt, int target) {
  const long long start = clock64();
  while (true) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(cnt) : "memory");
    if (v >= target) return;
    if (clock64() - start > (1LL << 34)) __trap();  // ~9 s: fail, never hang the card
    __nanosleep(64);
  }
}

// order generic-proxy global writes and async-proxy (TMA) reads of them
static __device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

static __device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// this block's share of `bytes` at p (a multiple of 16 bytes)
static __device__ __forceinline__ void prefetch_share(const void* p, long long bytes) {
  const long long chunk = ((bytes + gridDim.x - 1) / gridDim.x + 15) / 16 * 16;
  const long long off = (long long)blockIdx.x * chunk;
  if (off < bytes)
    prefetch_l2(static_cast<const char*>(p) + off, (uint32_t)min(chunk, bytes - off));
}

// The epilogue's bias (and, for the out-projection and the MLP out, the
// residual) of this thread's rows row_a, row_a + 8 and two columns of
// each 8-column block, read before the products are waited for
template <int NJ>
static __device__ __forceinline__ void epi_preload(uint32_t (&rv)[NJ][2], float2 (&bv)[NJ],
                                                   const float* bias, const bf16* resid,
                                                   bool res_add, int row0, int row_a, int rows,
                                                   int col0, int ld, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = col0 + 8 * j + 2 * (lane & 3);
    bv[j] = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rv[j][r] = 0u;
      const int row = row_a + 8 * r;
      if (res_add && row < rows)
        rv[j][r] = __ldcg(
            reinterpret_cast<const unsigned int*>(resid + (long long)(row0 + row) * ld + c));
    }
  }
}

// An LN item: xn = bf16(rawLN(x)) of rows row0 .. row0 + rows - 1 (at most
// TT_LN_ROWS), warp w on rows 4 w .. 4 w + 3, the four rows' loads and
// butterflies interleaved: ln_gemm.cuh's row_stats (lane l on columns
// 8 l .. + 7 of every 256) and ln_rows_kernel's arithmetic, so xn is the
// chain's bit for bit.  x is read past L1 (other blocks wrote it).
static __device__ __forceinline__ void ln_rows(const bf16* __restrict__ x, bf16* __restrict__ xn,
                                               int K, float eps, int row0, int rows, int cwarp,
                                               int lane) {
  constexpr int R = TT_LN_ROWS / (TT_CONSUMERS / 32);
  const int r0 = cwarp * R;
  if (r0 >= rows) return;
  const bf16* xr[R];
#pragma unroll
  for (int q = 0; q < R; ++q) xr[q] = x + (long long)(row0 + min(r0 + q, rows - 1)) * K;
  float s[R], ss[R];
#pragma unroll
  for (int q = 0; q < R; ++q) s[q] = ss[q] = 0.f;
  uml::Pack8 v[R][TT_MAX_K / 256];
#pragma unroll
  for (int i = 0; i < TT_MAX_K / 256; ++i) {
    const int c = lane * 8 + 256 * i;
    if (c >= K) break;
#pragma unroll
    for (int q = 0; q < R; ++q) v[q][i].u = __ldcg(reinterpret_cast<const uint4*>(xr[q] + c));
  }
#pragma unroll
  for (int i = 0; i < TT_MAX_K / 256; ++i) {
    if (lane * 8 + 256 * i >= K) break;
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = __bfloat162float(v[q][i].h[e]);
        s[q] += f;
        ss[q] += f * f;
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
      ss[q] += __shfl_xor_sync(0xffffffffu, ss[q], o);
    }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (r0 + q >= rows) break;
    const float mean = s[q] / K;
    const float rstd = rsqrtf(fmaxf(ss[q] / K - mean * mean, 0.f) + eps);
#pragma unroll
    for (int i = 0; i < TT_MAX_K / 256; ++i) {
      const int c = lane * 8 + 256 * i;
      if (c >= K) break;
      uml::Pack8 o;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o.h[e] = __float2bfloat16(
            __fmul_rn(__fsub_rn(__bfloat162float(v[q][i].h[e]), mean), rstd));
      *reinterpret_cast<uint4*>(xn + (long long)(row0 + r0 + q) * K + c) = o.u;
    }
  }
}

// BN: the columns of a product item's tile, 64 or 128 for the whole call
// (tower_plan picks it), so no branch chooses a wgmma shape inside the
// kernel (ptxas serializes wgmma on such a path, C7520)
template <int BN>
__global__ void __launch_bounds__(TT_THREADS, 1)
text_tower_kernel(const __grid_constant__ CUtensorMap txn,
                  const __grid_constant__ CUtensorMap tattn,
                  const __grid_constant__ CUtensorMap thid,
                  const __grid_constant__ CUtensorMap tqkv,
                  const __grid_constant__ CUtensorMap tweff,
                  const __grid_constant__ CUtensorMap two, const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tw2, const TtArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int tt_last;  // a split tile's last part is this block's
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ring_smem = smem_raw + (base - raw);
  const uint32_t aring = base;                              // activations (and q, k, v)
  const uint32_t bring = aring + TT_ASTAGES * TT_BOX;       // weights
  const uint32_t bBar = bring + TT_BSTAGES * TT_BSTAGE;
  // the weight ring's full[s] at bBar + 8 s, empty[s] at bBar + 8 (BSTAGES
  // + s); the activation ring's at aBar the same way
  const uint32_t aBar = bBar + 16 * TT_BSTAGES;
  const int tid = threadIdx.x;
  const int hd = a.H * uml::ATT_D;

  if (tid == 0) {
    for (int s = 0; s < TT_BSTAGES; ++s) {
      mbar_init(bBar + 8 * s, 1);
      mbar_init(bBar + 8 * (TT_BSTAGES + s), TT_CONSUMERS / 32);
    }
    for (int s = 0; s < TT_ASTAGES; ++s) {
      mbar_init(aBar + 8 * s, 1);
      mbar_init(aBar + 8 * (TT_ASTAGES + s), TT_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TT_PRODUCER) {
    // the producer: walk the items, wait for each one's stage, issue its
    // loads into the two rings (running ahead into the next items)
    if (tid == TT_PRODUCER) {
      int it = 0, at = 0, pf_layer = -1;
      // the next activation stage: one 128-row box at (c0, row0) of map m
      auto a_load = [&](const CUtensorMap* m, int c0, int row0) {
        const int s = at % TT_ASTAGES;
        mbar_wait(aBar + 8 * (TT_ASTAGES + s), ((at / TT_ASTAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(aBar + 8 * s, TT_BOX);
        tma_load_2d(aring + s * TT_BOX, m, aBar + 8 * s, c0, row0);
        ++at;
      };
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const int* f = a.plan + (long long)item * TT_FIELDS;
        const int op = f[TT_OP], l = f[TT_LAYER], row0 = f[TT_ROW0], col0 = f[TT_COL0];
        const int wait = f[TT_WAIT];
        if (l != pf_layer) {  // the next layer's weights into L2, this block's share
          pf_layer = l;
          if (l + 1 < a.L) {
            const long long kk = a.K, m = a.M, h = hd;
            prefetch_share(a.w_eff + (l + 1) * kk * 3 * h, kk * 3 * h * 2);
            prefetch_share(a.wo + (l + 1) * h * kk, h * kk * 2);
            prefetch_share(a.w1 + (l + 1) * kk * m, kk * m * 2);
            prefetch_share(a.w2 + (l + 1) * m * kk, m * kk * 2);
          }
        }
        if (wait >= 0) tt_wait(a.counters + wait, f[TT_TARGET]);
        fence_proxy_global();
        if (op == OP_LN1 || op == OP_LN2) {
          // the consumers read the residual themselves: hand them the item
          // through a stage of the activation ring with no bytes, whose
          // empty barrier keeps the producer from running ahead of them
          const int s = at % TT_ASTAGES;
          mbar_wait(aBar + 8 * (TT_ASTAGES + s), ((at / TT_ASTAGES) & 1) ^ 1);
          mbar_arrive(aBar + 8 * s);
          ++at;
          continue;
        }
        if (op == OP_ATTN) {  // q, k, v of the sequence's head: three stages
          for (int p = 0; p < 3; ++p) a_load(&tqkv, p * hd + col0 * uml::ATT_D, row0);
          continue;
        }
        const CUtensorMap* ta = op == OP_OUT ? &tattn : op == OP_MLP_OUT ? &thid : &txn;
        const CUtensorMap* tb = op == OP_QKV ? &tweff
                                : op == OP_OUT ? &two
                                : op == OP_MLP_IN ? &tw1 : &tw2;
        const int kc = op == OP_OUT ? hd : op == OP_MLP_OUT ? a.M : a.K;
        const int kn = f[TT_KN], t0 = f[TT_PART] * kn / 64;
        for (int t = t0; t < t0 + kn / 64; ++t, ++it) {
          a_load(ta, t * 64, row0);
          const int s = it % TT_BSTAGES;
          mbar_wait(bBar + 8 * (TT_BSTAGES + s), ((it / TT_BSTAGES) & 1) ^ 1);
          const uint32_t full = bBar + 8 * s;
          const uint32_t st = bring + s * TT_BSTAGE;
          mbar_arrive_expect_tx(full, BN * 128);
          for (int p = 0; p < BN / 64; ++p)
            tma_load_2d(st + p * TT_PANEL, tb, full, col0 + 64 * p, l * kc + t * 64);
        }
      }
    }
  } else {
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid & 31;
    int it = 0, at = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      const int* f = a.plan + (long long)item * TT_FIELDS;
      const int op = f[TT_OP], l = f[TT_LAYER], row0 = f[TT_ROW0], rows = f[TT_ROWS];
      const int col0 = f[TT_COL0];
      if (op == OP_LN1 || op == OP_LN2) {
        const int s = at % TT_ASTAGES;
        mbar_wait(aBar + 8 * s, (at / TT_ASTAGES) & 1);
        ln_rows(op == OP_LN1 && l == 0 ? a.x : a.out, a.xn, a.K, a.eps, row0, rows, tid / 32,
                lane);
        if (lane == 0) mbar_arrive(aBar + 8 * (TT_ASTAGES + s));
        ++at;
      } else if (op == OP_ATTN) {
        // one sequence (rows row0 .. row0 + S - 1), head col0: warpgroup wg
        // takes query rows 64 wg .. + 63 against the 128 keys held
        uint32_t sQKV[3];
        for (int p = 0; p < 3; ++p) {
          const int s = (at + p) % TT_ASTAGES;
          mbar_wait(aBar + 8 * s, ((at + p) / TT_ASTAGES) & 1);
          sQKV[p] = aring + s * TT_BOX;
        }
        const uint32_t sQ = sQKV[0], sK = sQKV[1], sV = sQKV[2];
        const int S = a.S;
        // V rows >= S hold the next sequence's rows (or scratch not yet
        // written this call): zero them, so that P = 0 there gives 0
        for (int i = S * 8 + tid; i < TT_BM * 8; i += TT_CONSUMERS)
          reinterpret_cast<uint4*>(ring_smem + (sV - aring))[i] = make_uint4(0, 0, 0, 0);
        fence_proxy_async();
        named_bar_sync(1, TT_CONSUMERS);
        const int wrow0 = wg * 64 + 16 * warp;
        const int qrow0 = wrow0 + (lane >> 2);
        const int col = 2 * (lane & 3);
        const bool live = wrow0 < S;
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(sc, wgmma_desc(sQ + wg * 64 * 128 + kk * 32, 16, 1024),
                        wgmma_desc(sK + kk * 32, 16, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_regs(sc);
        float l_[2] = {0.f, 0.f};
        uint32_t pa[8][4];
        if (live) {
          // keys >= S and above the diagonal masked, each row's max first,
          // then P = 2^(s scale_log2 - m) rounded once (qkv_attention.cu)
          float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int off = 8 * (i / 4) + (i & 1), r = (i >> 1) & 1;
            if (off >= S - col || off > qrow0 - col + 8 * r) sc[i] = -CUDART_INF_F;
            mx[2 * r + ((i >> 2) & 1)] = fmaxf(mx[2 * r + ((i >> 2) & 1)], sc[i]);
          }
          float m_use[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float m = fmaxf(mx[2 * r], mx[2 * r + 1]);
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            m_use[r] = m == -CUDART_INF_F ? 0.f : m * a.scale_log2;
          }
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = 8 * kk + 2 * j, r = j & 1;
              const float p0 = ex2_approx(fmaf(sc[i], a.scale_log2, -m_use[r]));
              const float p1 = ex2_approx(fmaf(sc[i + 1], a.scale_log2, -m_use[r]));
              l_[r] += p0;
              l_[r] += p1;
              pa[kk][j] = uml::bf16x2_bits(p0, p1);
            }
        } else {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) pa[kk][j] = 0u;
        }
        float o[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
        wgmma_fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_rs_n64(o, pa[kk], wgmma_desc(sV + kk * 16 * 128, TT_BOX, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_regs(o);
        if (lane == 0)  // q, k, v are free
          for (int p = 0; p < 3; ++p)
            mbar_arrive(aBar + 8 * (TT_ASTAGES + (at + p) % TT_ASTAGES));
        at += 3;
        if (live) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l_[r] += __shfl_xor_sync(0xffffffffu, l_[r], 1);
            l_[r] += __shfl_xor_sync(0xffffffffu, l_[r], 2);
            const int row = qrow0 + 8 * r;
            if (row >= S) continue;
            const float inv = 1.f / fmaxf(l_[r], 1e-30f);
            bf16* orow = a.attn + (long long)(row0 + row) * hd + col0 * uml::ATT_D + col;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
                  __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
          }
        }
      } else {
        const int kt_n = f[TT_KN] / 64, parts = f[TT_PARTS];
        constexpr int NJ = BN / 8;  // 8-column blocks of the tile
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        for (int t = 0; t < kt_n; ++t, ++it) {
          const int sa_ = (at + t) % TT_ASTAGES;
          mbar_wait(aBar + 8 * sa_, ((at + t) / TT_ASTAGES) & 1);
          const int s = it % TT_BSTAGES;
          mbar_wait(bBar + 8 * s, (it / TT_BSTAGES) & 1);
          const uint32_t sa = aring + sa_ * TT_BOX + wg * 64 * 128;
          const uint32_t st = bring + s * TT_BSTAGE;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = wgmma_desc(sa + kk * 32, 16, 1024);
            const uint64_t db = wgmma_desc(st + kk * 2048, TT_PANEL, 1024);
            if constexpr (BN == 128)
              wgmma_ss_n128<0, 1>(acc, da, db, 1);
            else
              wgmma_ss_n64<0, 1>(*reinterpret_cast<float(*)[32]>(&acc[0]), da, db, 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // step t-1's products are done: release its stages
          if (t > 0 && lane == 0) {
            mbar_arrive(bBar + 8 * (TT_BSTAGES + (it - 1) % TT_BSTAGES));
            mbar_arrive(aBar + 8 * (TT_ASTAGES + (at + t - 1) % TT_ASTAGES));
          }
        }
        // the epilogue's bias and residual are read while the last
        // products run (out is written in place, so the residual comes
        // first): rows row_a, row_a + 8 of the tile, two columns of each
        // 8-column block
        const int row_a = 64 * wg + 16 * warp + (lane >> 2);
        const float* bias = op == OP_QKV ? a.b_eff + (long long)l * 3 * hd
                            : op == OP_OUT ? a.bo + (long long)l * a.K
                            : op == OP_MLP_IN ? a.b1 + (long long)l * a.M
                                              : a.b2 + (long long)l * a.K;
        const int ld = op == OP_QKV ? 3 * hd : op == OP_MLP_IN ? a.M : a.K;
        bf16* dst = op == OP_QKV ? a.qkv : op == OP_MLP_IN ? a.hidden : a.out;
        const bf16* resid = (op == OP_OUT && l == 0) ? a.x : a.out;
        const bool res_add = op == OP_OUT || op == OP_MLP_OUT;
        uint32_t rv[NJ][2];
        float2 bv[NJ];
        if (BN == 128 || parts == 1)
          epi_preload<NJ>(rv, bv, bias, resid, res_add, row0, row_a, rows, col0, ld, lane);
        wgmma_wait<0>();
        wgmma_fence_regs(acc);
        if (lane == 0) {
          mbar_arrive(bBar + 8 * (TT_BSTAGES + (it - 1) % TT_BSTAGES));
          mbar_arrive(aBar + 8 * (TT_ASTAGES + (at + kt_n - 1) % TT_ASTAGES));
        }
        at += kt_n;
        // (tower_plan splits tiles only where they are 64 columns wide)
        if (BN == 64 && parts > 1) {
          // a split tile: this part's fp32 sums to its block, then the
          // last part to arrive adds the parts in order (its own from its
          // registers; each other part's block read whole, its loads in
          // flight together) and runs the epilogue
          const int part = f[TT_PART];
          float* blk = a.partial + f[TT_POFF];
          const int cq = 2 * (lane & 3);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = row_a + 8 * r;
              if (row < rows)
                *reinterpret_cast<float2*>(blk + ((long long)part * TT_BM + row) * BN + 8 * j +
                                           cq) = make_float2(acc[4 * j + 2 * r],
                                                             acc[4 * j + 2 * r + 1]);
            }
          __threadfence();
          named_bar_sync(1, TT_CONSUMERS);
          if (tid == 0) tt_last = atomicAdd(a.counters + f[TT_TILE], 1) == parts - 1;
          named_bar_sync(1, TT_CONSUMERS);
          if (!tt_last) goto signal;
          __threadfence();
          epi_preload<NJ>(rv, bv, bias, resid, res_add, row0, row_a, rows, col0, ld, lane);
          float sum[BN / 2];
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
          for (int p = 0; p < parts; ++p) {
            float v[BN / 2];
            if (p == part) {
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) v[i] = acc[i];
            } else {
#pragma unroll
              for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int row = min(row_a + 8 * r, rows - 1);
                  const float2 w = __ldcg(reinterpret_cast<const float2*>(
                      blk + ((long long)p * TT_BM + row) * BN + 8 * j + cq));
                  v[4 * j + 2 * r] = w.x;
                  v[4 * j + 2 * r + 1] = w.y;
                }
            }
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sum[i] += v[i];
          }
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i];
          if (tid == 0) a.counters[f[TT_TILE]] = 0;  // for the next layer and call
        }
        // each pair of 8-column blocks is exchanged within each quad of
        // lanes, so that a lane stores 8 bytes and a quad a whole 32-byte
        // sector (wgmma_gemm.cuh's epilogue)
        const int q = lane & 3;
        const int src = (lane & ~3) | (2 * (q & 1));
#pragma unroll
        for (int j0 = 0; j0 < NJ; j0 += 2) {
          uint32_t pk[2][2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = j0 + jj;
            const float2 bb = bv[j];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float v0 = acc[4 * j + 2 * r] + bb.x, v1 = acc[4 * j + 2 * r + 1] + bb.y;
              if (op == OP_MLP_IN) {
                v0 = __fdividef(v0, 1.f + __expf(-1.702f * v0));
                v1 = __fdividef(v1, 1.f + __expf(-1.702f * v1));
              } else if (res_add) {
                const float2 rf = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&rv[j][r]));
                v0 += rf.x;
                v1 += rf.y;
              }
              pk[jj][r] = uml::bf16x2_bits(v0, v1);
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t a0 = __shfl_sync(0xffffffffu, pk[0][r], src);
            const uint32_t a1 = __shfl_sync(0xffffffffu, pk[0][r], src + 1);
            const uint32_t b0 = __shfl_sync(0xffffffffu, pk[1][r], src);
            const uint32_t b1 = __shfl_sync(0xffffffffu, pk[1][r], src + 1);
            const int row = row_a + 8 * r;
            if (row < rows)
              *reinterpret_cast<uint2*>(dst + (long long)(row0 + row) * ld + col0 + 8 * j0 +
                                        4 * q) = q < 2 ? make_uint2(a0, a1) : make_uint2(b0, b1);
          }
        }
      }
    signal:
      // the item is done: signal its stage
      fence_proxy_global();
      named_bar_sync(1, TT_CONSUMERS);
      if (tid == 0) {
        __threadfence();
        atomicAdd(a.counters + f[TT_SIGNAL], 1);
      }
    }
  }
  // the last block out sets the counters back to zero for the next call
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.counters + a.n_counters, 1) == (int)gridDim.x - 1) {
      for (int i = 0; i <= a.n_counters; ++i) a.counters[i] = 0;
      __threadfence();
    }
  }
}

}  // namespace

namespace uml {

// The route: the one-launch tower for S <= 128 (one 128-key chunk of
// attention), K <= 512 and H*64 <= 512 (an LN item's rows in registers);
// the chain for every other shape.  ops/text_tower.py::text_tower_fused
// mirrors it.
static inline bool text_tower_fused(int S, int K, int H) {
  return S <= TT_MAX_S && K <= TT_MAX_K && H * ATT_D <= TT_MAX_K;
}

static cudaError_t launch_text_tower(const bf16* x, const bf16* w_eff, const float* b_eff,
                                     const bf16* wo, const float* bo, const bf16* w1,
                                     const float* b1, const bf16* w2, const float* b2, bf16* xn,
                                     bf16* qkv, bf16* attn, bf16* hidden, bf16* out,
                                     const int* plan, int* counters, float* partial,
                                     int n_items, int n_counters, int grid, int bn, int B, int S,
                                     int K,
                                     int H, int M, int L, float eps, cudaStream_t stream) {
  const long long rows = (long long)B * S;
  const int hd = H * ATT_D;
  if (!text_tower_fused(S, K, H) || B < 1 || L < 1 || K < 64 || K % 64 != 0 || M < 64 ||
      M % 64 != 0 || rows > 2147483647LL || plan == nullptr || counters == nullptr ||
      n_items < 1 || n_counters < 1 || grid < 1 || grid > n_items || (bn != 64 && bn != 128) ||
      partial == nullptr ||
      xn == nullptr ||
      qkv == nullptr || attn == nullptr || hidden == nullptr)
    return cudaErrorInvalidValue;
  static const cudaError_t attr64 = cudaFuncSetAttribute(
      text_tower_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TT_SMEM);
  static const cudaError_t attr128 = cudaFuncSetAttribute(
      text_tower_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TT_SMEM);
  UML_TRY(attr64);
  UML_TRY(attr128);
  // every block must be resident at once (a waiting block holds its SM)
  int dev = 0, sms = 0, per_sm = 0;
  UML_TRY(cudaGetDevice(&dev));
  UML_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  UML_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bn == 128 ? text_tower_kernel<128> : text_tower_kernel<64>, TT_THREADS,
      TT_SMEM));
  if (grid > sms * per_sm) return cudaErrorInvalidValue;
  CUtensorMap txn, tattn, thid, tqkv, tweff, two, tw1, tw2;
  // an activation [rows, cols] in boxes of 64 columns by 128 rows
  auto act = [&](CUtensorMap* m, const void* p, int cols) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {64, TT_BM};
    return make_tensor_map(m, p, 2, dims, strides, box);
  };
  // a stacked weight [L * rows, cols] in boxes of 64 columns by 64 rows
  auto wt = [&](CUtensorMap* m, const void* p, long long wrows, int cols) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)(L * wrows)};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {64, 64};
    return make_tensor_map(m, p, 2, dims, strides, box);
  };
  if (!act(&txn, xn, K) || !act(&tattn, attn, hd) || !act(&thid, hidden, M) ||
      !act(&tqkv, qkv, 3 * hd) || !wt(&tweff, w_eff, K, 3 * hd) || !wt(&two, wo, hd, K) ||
      !wt(&tw1, w1, K, M) || !wt(&tw2, w2, M, K))
    return cudaErrorInvalidValue;
  TtArgs args;
  args.x = x;
  args.out = out;
  args.xn = xn;
  args.qkv = qkv;
  args.attn = attn;
  args.hidden = hidden;
  args.partial = partial;
  args.b_eff = b_eff;
  args.bo = bo;
  args.b1 = b1;
  args.b2 = b2;
  args.w_eff = w_eff;
  args.wo = wo;
  args.w1 = w1;
  args.w2 = w2;
  args.plan = plan;
  args.counters = counters;
  args.n_items = n_items;
  args.n_counters = n_counters;
  args.S = S;
  args.K = K;
  args.H = H;
  args.M = M;
  args.L = L;
  args.eps = eps;
  args.scale_log2 = 0.125f * 1.4426950408889634f;
  if (bn == 128)
    text_tower_kernel<128><<<grid, TT_THREADS, TT_SMEM, stream>>>(txn, tattn, thid, tqkv, tweff,
                                                                 two, tw1, tw2, args);
  else
    text_tower_kernel<64><<<grid, TT_THREADS, TT_SMEM, stream>>>(txn, tattn, thid, tqkv, tweff,
                                                                two, tw1, tw2, args);
  return cudaGetLastError();
}

}  // namespace uml

extern "C" int uml_text_tower(const void* x, const void* w_eff, const void* b_eff,
                              const void* wo, const void* bo, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* xn, void* qkv,
                              void* attn, void* hidden, void* mid, void* out, const void* plan,
                              void* counters, void* partial, int B, int S, int K, int H, int M,
                              int L,
                              int n_items, int n_counters, int grid, int bn, float eps,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (uml::text_tower_fused(S, K, H))
    return (int)uml::launch_text_tower(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w_eff),
        static_cast<const float*>(b_eff), static_cast<const bf16*>(wo),
        static_cast<const float*>(bo), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<bf16*>(xn), static_cast<bf16*>(qkv),
        static_cast<bf16*>(attn), static_cast<bf16*>(hidden), static_cast<bf16*>(out),
        static_cast<const int*>(plan), static_cast<int*>(counters),
        static_cast<float*>(partial), n_items, n_counters, grid, bn, B, S, K, H, M, L, eps, st);
  // the chain: the attention half and the MLP half of every layer
  if (plan != nullptr || partial != nullptr || xn == nullptr || mid == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long hd = (long long)H * uml::ATT_D;
  const int rows = B * S;
  const bf16* cur = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  bf16* m = static_cast<bf16*>(mid);
  for (int l = 0; l < L; ++l) {
    const cudaError_t e1 = uml::run_attn_block(
        cur, static_cast<const bf16*>(w_eff) + l * K * 3 * hd,
        static_cast<const float*>(b_eff) + l * 3 * hd,
        static_cast<const bf16*>(wo) + l * hd * K, static_cast<const float*>(bo) + l * K,
        static_cast<bf16*>(xn), static_cast<bf16*>(qkv), static_cast<bf16*>(attn), m, B, S, K,
        H, true, S, eps, st);
    if (e1 != cudaSuccess) return (int)e1;
    const cudaError_t e2 = uml::run_mlp_block(
        m, static_cast<const bf16*>(w1) + (long long)l * K * M,
        static_cast<const float*>(b1) + (long long)l * M,
        static_cast<const bf16*>(w2) + (long long)l * M * K,
        static_cast<const float*>(b2) + (long long)l * K, static_cast<bf16*>(xn),
        static_cast<bf16*>(hidden), o, rows, K, M, eps, st);
    if (e2 != cudaSuccess) return (int)e2;
    cur = o;
  }
  return (int)cudaSuccess;
}
