// Fused GEGLU-MoE feed-forward for Hopper, and the fused MoE routing kernel of
// the unfused FF path, on wgmma, TMA and mbarrier rings.
//
// Replaces the Pallas TPU kernels diffusion_models_moe_tpu/ops/geglu_ff_fused.py
// :_kernel (pallas_call at :194) and diffusion_models_moe_tpu/ops/
// routing_kernel.py:_routing_kernel (pallas_call at :106). The first keeps W1
// (C, 2H) and W2 (H, C) resident in VMEM and runs the whole FF per row block.
// On the H100 W1 alone is 26 MB at C = 1280 against 227 KB of shared memory
// an SM, so the work is split where a row's data must be complete:
//
//   0. ln_rows_kernel   (with LN) one warp a row, the row in registers:
//                       mean and variance in f32 (fast variance),
//                       xn = (x - mu) * (rsqrt * g) + b rounded to bf16, as
//                       the TPU kernel rounds it before its products. Once a
//                       row, not once a column block.
//   1. ff_up_kernel     h = xn W1[:H]^T, g = xn W1[H:]^T: a dual GEMM on
//                       tiles of one or two consumer warpgroups of 64 rows x
//                       128 columns of h and of g, dealt to one persistent
//                       block an SM; a producer warp keeps a 3-4 stage TMA
//                       ring of the x tile and the two W1 tiles (128-byte
//                       swizzle) in flight across tiles, and wgmma
//                       m64n128k16 takes both from shared memory. The
//                       epilogue adds b1 and applies exact GELU (erff) or
//                       ReLU in f32 and writes bf16(h*ga) (routed, also ga
//                       in bf16 for the scores) through a swizzled staging
//                       tile and TMA stores, which run under the next
//                       tile's products.
//   2. routing stage    (routed) scores, selection, mask; see below.
//   3. ff_down_kernel   y = prod W2^T + b2 (f32) rounded to bf16, + the
//                       residual x in bf16: the output GEMM of
//                       down_gemm.cuh, which kernel 6 (attn_absorb.cu)
//                       shares: the same ring and warpgroups, 160
//                       output channels a block (wgmma m64n160k16).
//                       Where the grid is small (N = 1024 and 256 at H =
//                       5120) the H depth is split over grid z; the f32 parts
//                       are added in the order z = 0, 1, ... by
//                       wg::split_finish_kernel (b2 added in f32 before the
//                       rounding), so a repeat is bit-equal.
//
// The routing stage is shared with the routing kernel (dmoe_route_multiply):
//
//   a. route_scores_kernel  S = bf16(gate) P^T in f32: a GEMM of N x E x H,
//                           64 rows and all E <= 256 experts a block (NE
//                           products of 64 experts), the H depth split over
//                           grid y where the rows alone give too few blocks;
//                           the parts are written apart, never added by
//                           atomics.
//   b. route_select_kernel  8 or 32 lanes a row: the parts added in split order,
//                           the E scores in registers (8 a lane), the k-th
//                           largest exactly by a radix select on their bits,
//                           and an expert kept iff fewer than k experts
//                           score strictly higher (ties kept); sel (N, E)
//                           0/1 bf16.
//   c. route_mask_kernel    m = sel P by wgmma with sel from registers and
//                           the P tile as the MN-major operand, then
//                           prod = bf16(hidden*gate*m): 128 rows (two
//                           warpgroups on each P tile) and a run of
//                           64-column tiles a block, P and the hidden/gate
//                           tiles through one TMA ring (P from L2, once a
//                           block), the products out by TMA stores; enough
//                           blocks to fill the card.
//
// Rounding. JAX rounds ga to the model dtype for the score and writes
// bf16(h*ga*m). ff_up writes bf16(h*ga) and the mask kernel bf16(bf16(h*ga)
// * m), which equals bf16(h*ga*m) bit for bit when m is 0, 1 or 2 (zero or
// a power of two). Every pattern the model builds gives such an m: one 1 a
// column from taps.patterns_from_labels, zero or one after expert_remove
// zeroes rows. A 0/1 pattern with a column of three or more ones (m an
// integer up to E, bf16(h*ga) * m exact in f32) is rounded twice there, so
// its product may differ from bf16(h*ga*m) by one bf16 unit in the last
// place; the kernel takes it so, with no f32 copy of h*ga and no look at P
// on the host. The routing kernel rounds as the TPU's does:
// bf16(bf16(hidden*gate) * bf16(m)).
//
// What a row's result depends on. The depth splits of ff_down and of the
// scores are chosen from N (ops/geglu_ff_fused.py:ff_plan,
// ops/routing_kernel.py:route_plan), and the f32 sums are added in another
// order with another split, so a row's bits may depend on N; at one N they do
// not depend on the other rows (the serving engine's batch-of-one and
// co-batched requests run at one N).
//
// What binds (builds with one piece taken out, on an NVIDIA H100 80GB HBM3
// at 700 W). The work of ff_up and ff_down is tensor-core bound at SD1.5
// widths (2 C and 1 C operations a byte of the (N, H) intermediate). ff_up's
// products alone run at about cuBLAS's rate for x W1^T; its epilogue, the
// erff of the exact GELU above all, adds about half again at C = 320, where
// the depth is short: the two consumer warpgroups share a tile, so the
// epilogue does not overlap their products (only the loads and the TMA
// stores overlap it). The routing stage is bound by the bytes of ga and h*ga
// read and prod written (6 bytes an element of (N, H); the routing kernel
// 8: the gate is read by the scores and by the mask pass) at N = 16384, and
// by its launches' latency below.
//
// Inference only: there is no backward.
#include "down_gemm.cuh"

namespace {

constexpr int UP_BN = 128;          // h and g columns an ff_up block
constexpr int TILE64 = 64 * 128;    // bytes of a 64 x 64 bf16 tile
constexpr int R_THREADS = 160;      // scores: a consumer warpgroup + a producer warp

__device__ __forceinline__ __nv_bfloat162 pack2(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------- LayerNorm
// V > 0: the row's V x 256 values stay in registers between the two passes
// (C <= 256 V); V = 0: any C, read twice.
template <int V>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ b, float eps, int n, int c,
    bf16* __restrict__ xn) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= n) return;
  const bf16* xr = x + (size_t)row * c;
  bf16* out = xn + (size_t)row * c;
  float s = 0.f, ss = 0.f;
  alignas(16) bf16 t[V > 0 ? V : 1][8];
  if (V > 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = (32 * v + lane) * 8;
      *reinterpret_cast<uint4*>(t[v]) =
          col < c ? *reinterpret_cast<const uint4*>(xr + col) : zero_u4();
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float f = bf2f(t[v][q]);
        s += f;
        ss += f * f;
      }
    }
  } else {
    for (int col = lane * 8; col < c; col += 256) {
      *reinterpret_cast<uint4*>(t[0]) = *reinterpret_cast<const uint4*>(xr + col);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float f = bf2f(t[0][q]);
        s += f;
        ss += f * f;
      }
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)c;
  const float var = fmaxf(ss / (float)c - mu * mu, 0.f);
  const float rs = 1.0f / sqrtf(var + eps);
  auto finish = [&](bf16 (&u)[8], int col) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      u[q] = f2bf((bf2f(u[q]) - mu) * (rs * g[col + q]) + b[col + q]);
    *reinterpret_cast<uint4*>(out + col) = *reinterpret_cast<const uint4*>(u);
  };
  if (V > 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = (32 * v + lane) * 8;
      if (col < c) finish(t[v], col);
    }
  } else {
    for (int col = lane * 8; col < c; col += 256) {
      *reinterpret_cast<uint4*>(t[0]) = *reinterpret_cast<const uint4*>(xr + col);
      finish(t[0], col);
    }
  }
}

// The byte offset of (row r, bf16 column col) in a 64 x 64 tile of 128-byte
// rows in the TMA's 128-byte swizzle.
__device__ __forceinline__ int swz(int r, int col) {
  return r * 128 + ((((col >> 3) ^ (r & 7))) << 4) + (col & 7) * 2;
}

// ----------------------------------------------------------------- ff_up
template <int NWG, bool ROUTE>
struct UpCfg {
  static constexpr int A_BYTES = NWG * ROWS_WG * 128;
  static constexpr int B_BYTES = UP_BN * 128;
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  // the epilogue's staging: a warpgroup's 64 x 128 tile of each output
  // (h*ga; routed also ga) as two 64 x 64 boxes in the 128-byte swizzle
  static constexpr int OUTS = ROUTE ? 2 : 1;
  static constexpr int STAGING = NWG * OUTS * 2 * TILE64;
  static constexpr int FIT = (232448 - STAGING - 2048) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int SMEM = STAGES * STAGE + STAGING + 2048;
};

// Persistent: block b takes tiles b, b + gridDim.x, ... of 64 NWG rows x 128
// columns (column tiles fastest), so the producer loads the next tile's
// chunks while the consumers run this tile's epilogue, and the epilogue's
// TMA stores run under the next tile's products.
template <int NWG, bool ROUTE, bool RELU>
__global__ void __launch_bounds__(UpCfg<NWG, ROUTE>::THREADS, 1) ff_up_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap hgmap,
    const __grid_constant__ CUtensorMap gamap, const bf16* __restrict__ b1,
    int n, int c, int hdim) {
  using Cfg = UpCfg<NWG, ROUTE>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  unsigned char* staging = smem + STAGES * Cfg::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + Cfg::STAGING);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = tid >> 7;            // 0: producer; 1..NWG: consumers
  const int nchunks = (c + BK - 1) / BK;
  const int col_tiles = (hdim + UP_BN - 1) / UP_BN;
  const int tiles = (n + NWG * ROWS_WG - 1) / (NWG * ROWS_WG) * col_tiles;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 4 * NWG);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (group == 0) {
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / col_tiles * NWG * ROWS_WG;
        const int col0 = tile % col_tiles * UP_BN;
        for (int ci = 0; ci < nchunks; ++ci) {
          wg::mbar_wait(empty + ring.stage, ring.phase ^ 1);
          unsigned char* st = smem + ring.stage * Cfg::STAGE;
          uint64_t* bar = full + ring.stage;
          wg::mbar_expect_tx(bar, Cfg::STAGE);
          wg::tma_load_2d(st, &amap, bar, ci * BK, row0);
          wg::tma_load_2d(st + Cfg::A_BYTES, &wmap, bar, ci * BK, col0);
          wg::tma_load_2d(st + Cfg::A_BYTES + Cfg::B_BYTES, &wmap, bar,
                          ci * BK, hdim + col0);
          ring.advance(STAGES);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ the consumers
  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = group - 1;
  const bool leader = (tid & 127) == 0;          // issues the WG's stores
  unsigned char* stage_out = staging + wgi * Cfg::OUTS * 2 * TILE64;
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  wg::Ring ring;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / col_tiles * NWG * ROWS_WG;
    const int col0 = tile % col_tiles * UP_BN;
    // the epilogue's biases, loaded under the main loop
    __nv_bfloat162 bias_h[UP_BN / 8], bias_g[UP_BN / 8];
#pragma unroll
    for (int j = 0; j < UP_BN / 8; ++j) {
      const int col = min(col0 + 8 * j + 2 * t, hdim - 2);
      bias_h[j] = *reinterpret_cast<const __nv_bfloat162*>(b1 + col);
      bias_g[j] = *reinterpret_cast<const __nv_bfloat162*>(b1 + hdim + col);
    }
    float acc_h[64], acc_g[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc_h[i] = 0.f;
      acc_g[i] = 0.f;
    }
    int prev = 0;
    for (int ci = 0; ci < nchunks; ++ci) {
      wg::mbar_wait(full + ring.stage, ring.phase);
      const unsigned char* st = smem + ring.stage * Cfg::STAGE;
      const uint64_t ad = wg::kmajor_desc<128>(st + wgi * ROWS_WG * 128);
      const uint64_t hd = wg::kmajor_desc<128>(st + Cfg::A_BYTES);
      const uint64_t gd = wg::kmajor_desc<128>(st + Cfg::A_BYTES + Cfg::B_BYTES);
      wg::fence_regs(acc_h);
      wg::fence_regs(acc_g);
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wg::wgmma_ss(acc_h, ad + 2 * ks, hd + 2 * ks, true);
        wg::wgmma_ss(acc_g, ad + 2 * ks, gd + 2 * ks, true);
      }
      wg::wgmma_commit();
      if (ci > 0) {
        wg::wgmma_wait<1>();
        if (lane == 0) wg::mbar_arrive(empty + prev);
      }
      prev = ring.stage;
      ring.advance(STAGES);
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc_h);
    wg::fence_regs(acc_g);
    if (lane == 0) wg::mbar_arrive(empty + prev);

    // the epilogue: the previous tile's stores have read the staging
    if (leader) wg::bulk_wait_read();
    wg::named_sync(2 + wgi, 128);
    // this thread: rows 16 w + g and + 8 of its warpgroup's 64, columns
    // 8 j + 2 t + {0, 1} of the tile's 128
#pragma unroll
    for (int j = 0; j < UP_BN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      if (col < hdim) {
        const __nv_bfloat162 bh = bias_h[j], bg = bias_g[j];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * w + g + 8 * half;
          const float h0 = acc_h[4 * j + 2 * half] + bf2f(bh.x);
          const float h1 = acc_h[4 * j + 2 * half + 1] + bf2f(bh.y);
          const float g0 = acc_g[4 * j + 2 * half] + bf2f(bg.x);
          const float g1 = acc_g[4 * j + 2 * half + 1] + bf2f(bg.y);
          const float a0 = RELU ? fmaxf(g0, 0.f) : gelu_exact(g0);
          const float a1 = RELU ? fmaxf(g1, 0.f) : gelu_exact(g1);
          const int off = (j >> 3) * TILE64 + swz(r, 8 * (j & 7) + 2 * t);
          *reinterpret_cast<__nv_bfloat162*>(stage_out + off) = pack2(h0 * a0, h1 * a1);
          if (ROUTE)
            *reinterpret_cast<__nv_bfloat162*>(stage_out + 2 * TILE64 + off) =
                pack2(a0, a1);
        }
      }
    }
    wg::fence_proxy_async();
    wg::named_sync(2 + wgi, 128);
    if (leader) {
      const int r0 = row0 + wgi * ROWS_WG;
#pragma unroll
      for (int box = 0; box < 2; ++box) {
        if (col0 + 64 * box < hdim) {
          wg::tma_store_2d(&hgmap, stage_out + box * TILE64, col0 + 64 * box, r0);
          if (ROUTE)
            wg::tma_store_2d(&gamap, stage_out + (2 + box) * TILE64,
                             col0 + 64 * box, r0);
        }
      }
      wg::bulk_commit();
    }
  }
  if (leader) wg::bulk_wait();
}

// --------------------------------------------------------------- ff_down
// y = prod W2^T + b2 (+ x): the shared output GEMM of down_gemm.cuh.
template <int NWG, bool SPLIT, bool RESID>
__global__ void __launch_bounds__(DownCfg<NWG>::THREADS, 1) ff_down_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ b2,
    const bf16* __restrict__ x, int n, int c, int nchunks, int per,
    bf16* __restrict__ y, float* __restrict__ partial) {
  down_gemm<NWG, SPLIT, RESID>(amap, wmap, b2, x, n, c, nchunks, per, y,
                               partial);
}

// ------------------------------------------------------- routing: scores
template <int NE>
struct ScoreCfg {
  static constexpr int STAGE = TILE64 * (1 + NE);
  static constexpr int STAGES = 4;
  static constexpr int SMEM = STAGES * STAGE + 2048;
};

// partial[s] (N, epad) f32 = gate[:, depth chunks of split s] P^T over the
// same chunks; 64 rows a block (grid x), split s = grid y.
template <int NE>
__global__ void __launch_bounds__(R_THREADS) route_scores_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap pmap, int n, int nchunks, int per,
    float* __restrict__ partial) {
  constexpr int EPAD = 64 * NE;
  using Cfg = ScoreCfg<NE>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS_WG;
  const int chunk0 = blockIdx.y * per;
  const int nc = min(per, nchunks - chunk0);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 4);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      wg::Ring ring;
      for (int ci = 0; ci < nc; ++ci) {
        wg::mbar_wait(empty + ring.stage, ring.phase ^ 1);
        unsigned char* st = smem + ring.stage * Cfg::STAGE;
        uint64_t* bar = full + ring.stage;
        const int k0 = (chunk0 + ci) * BK;
        wg::mbar_expect_tx(bar, Cfg::STAGE);
        wg::tma_load_2d(st, &amap, bar, k0, row0);
#pragma unroll
        for (int et = 0; et < NE; ++et)
          wg::tma_load_2d(st + TILE64 * (1 + et), &pmap, bar, k0, 64 * et);
        ring.advance(STAGES);
      }
    }
    return;
  }

  float acc[NE][32];
#pragma unroll
  for (int et = 0; et < NE; ++et)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[et][i] = 0.f;
  wg::Ring ring;
  int prev = 0;
  for (int ci = 0; ci < nc; ++ci) {
    wg::mbar_wait(full + ring.stage, ring.phase);
    const unsigned char* st = smem + ring.stage * Cfg::STAGE;
    const uint64_t ad = wg::kmajor_desc<128>(st);
#pragma unroll
    for (int et = 0; et < NE; ++et) wg::fence_regs(acc[et]);
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int et = 0; et < NE; ++et)
        wg::wgmma_ss(acc[et], ad + 2 * ks,
                     wg::kmajor_desc<128>(st + TILE64 * (1 + et)) + 2 * ks, true);
    wg::wgmma_commit();
    if (ci > 0) {
      wg::wgmma_wait<1>();
      if (lane == 0) wg::mbar_arrive(empty + prev);
    }
    prev = ring.stage;
    ring.advance(STAGES);
  }
  wg::wgmma_wait<0>();
#pragma unroll
  for (int et = 0; et < NE; ++et) wg::fence_regs(acc[et]);

  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + 16 * warp + g;
  float* part = partial + (size_t)blockIdx.y * n * EPAD;
#pragma unroll
  for (int et = 0; et < NE; ++et)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row < n)
          *reinterpret_cast<float2*>(part + (size_t)row * EPAD + 64 * et +
                                     8 * j + 2 * t) =
              make_float2(acc[et][4 * j + 2 * half],
                          acc[et][4 * j + 2 * half + 1]);
      }
}

// ---------------------------------------------------- routing: selection
// A score's 32-bit key in the order of the floats (-0 taken as +0).
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// L lanes a row (8 at E <= 64, else 32; 32 / L rows a warp),
// NQ = EPAD / L scores a lane: score = the split parts added in order; then
// the k-th largest score exactly, by a radix select on the keys from the top
// bit down (T: the largest key that at least k keys reach, 32 steps of a
// count summed over the row's lanes); expert e is kept iff e < E and its key
// reaches T, i.e. fewer than k experts score strictly higher (ties kept).
// sel (N, EPAD) 0/1 bf16, zero past E.
template <int EPAD>
__global__ void __launch_bounds__(256) route_select_kernel(
    const float* __restrict__ partial, int nsplit, int n, int e, int k,
    bf16* __restrict__ sel) {
  constexpr int L = EPAD == 64 ? 8 : 32;
  constexpr int NQ = EPAD / L;
  const int lane = threadIdx.x & 31, sub = lane % L;
  const int row0 = (blockIdx.x * 8 + (threadIdx.x >> 5)) * (32 / L);
  if (row0 >= n) return;                      // the whole warp
  const int row = row0 + lane / L;
  const bool live = row < n;
  float s[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) s[q] = 0.f;
  if (live) {
    const float* p = partial + (size_t)row * EPAD + sub;
    const size_t plane = (size_t)n * EPAD;
#pragma unroll 4
    for (int sp = 0; sp < nsplit; ++sp)
#pragma unroll
      for (int q = 0; q < NQ; ++q) s[q] += p[sp * plane + L * q];
  }
  uint32_t key[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    key[q] = live && sub + L * q < e ? order_key(s[q]) : 0u;
  uint32_t kth = 0;
#pragma unroll 4
  for (int b = 31; b >= 0; --b) {
    const uint32_t cand = kth | (1u << b);
    int c = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) c += key[q] >= cand;
    if (L == 32) {
      c = __reduce_add_sync(0xffffffffu, c);
    } else {
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    }
    if (c >= k) kth = cand;
  }
  if (!live) return;
  bf16* out = sel + (size_t)row * EPAD + sub;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    out[L * q] = f2bf(sub + L * q < e && key[q] >= kth ? 1.f : 0.f);
}

// --------------------------------------------------------- routing: mask
template <int NE, bool HID>
struct MaskCfg {
  static constexpr int ROWS = 2 * ROWS_WG;         // two consumer warpgroups
  static constexpr int THREADS = 2 * 128 + 32;     // and a producer warp
  static constexpr int P_BYTES = NE * TILE64;
  static constexpr int D_BYTES = (HID ? 2 : 1) * 2 * TILE64;
  static constexpr int STAGE = P_BYTES + D_BYTES;
  static constexpr int PITCH = 64 * NE + 8;        // bf16 of a sel row
  // the selection rows, then (once in registers) the products' staging:
  // a warpgroup's 64 x 64 tile for each warpgroup
  static constexpr int SEL_BYTES = (ROWS * PITCH * 2 + 1023) / 1024 * 1024;
  static constexpr int OUT_BYTES = 2 * TILE64;
  static constexpr int SHARED = SEL_BYTES > OUT_BYTES ? SEL_BYTES : OUT_BYTES;
  // as many stages (at most 4) as leave two blocks an SM at E <= 64
  // (routing_kernel.py:mask_blocks_per_sm), one block otherwise: at E = 128
  // two blocks of two stages waited on their loads
  static constexpr int BUDGET = NE == 1 ? 115712 : 232448;
  static constexpr int FIT = (BUDGET - SHARED - 2048) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr int SMEM = STAGES * STAGE + SHARED + 2048;
};

// m = sel P and out = bf16(hidden * gate * m) over 128 rows (grid x) and a
// run of `per` 64-column tiles (grid y): each P tile serves both consumer
// warpgroups. HID: the routing kernel (hidden and gate tiles,
// bf16(bf16(hidden * gate) * bf16(m))); else the FF's stage (the h*ga tile,
// bf16(bf16(h*ga) * m)).
template <int NE, bool HID>
__global__ void __launch_bounds__(MaskCfg<NE, HID>::THREADS) route_mask_kernel(
    const __grid_constant__ CUtensorMap pmap,
    const __grid_constant__ CUtensorMap dmap0,
    const __grid_constant__ CUtensorMap dmap1,
    const __grid_constant__ CUtensorMap omap, const bf16* __restrict__ sel,
    int n, int hdim, int per) {
  using Cfg = MaskCfg<NE, HID>;
  constexpr int STAGES = Cfg::STAGES, PITCH = Cfg::PITCH, EPAD = 64 * NE;
  constexpr int DTILE = 2 * TILE64;               // a data tile of 128 rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  unsigned char* shared = smem + STAGES * Cfg::STAGE;
  bf16* sel_s = reinterpret_cast<bf16*>(shared);
  uint64_t* full = reinterpret_cast<uint64_t*>(shared + Cfg::SHARED);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * Cfg::ROWS;
  const int tile0 = blockIdx.y * per;
  const int nt = min(per, hdim / 64 - tile0);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 8);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      wg::Ring ring;
      for (int i = 0; i < nt; ++i) {
        wg::mbar_wait(empty + ring.stage, ring.phase ^ 1);
        unsigned char* st = smem + ring.stage * Cfg::STAGE;
        uint64_t* bar = full + ring.stage;
        const int col = (tile0 + i) * 64;
        wg::mbar_expect_tx(bar, Cfg::STAGE);
#pragma unroll
        for (int et = 0; et < NE; ++et)
          wg::tma_load_2d(st + TILE64 * et, &pmap, bar, col, 64 * et);
        wg::tma_load_2d(st + Cfg::P_BYTES, &dmap0, bar, col, row0);
        if (HID) wg::tma_load_2d(st + Cfg::P_BYTES + DTILE, &dmap1, bar, col, row0);
        ring.advance(STAGES);
      }
    }
    return;
  }

  // the block's selection rows into shared memory, then into A fragments
  for (int v = tid; v < Cfg::ROWS * (EPAD / 8); v += 256) {
    const int r = v / (EPAD / 8), cv = (v % (EPAD / 8)) * 8;
    const uint4 val = row0 + r < n ? *reinterpret_cast<const uint4*>(
                                         sel + (size_t)(row0 + r) * EPAD + cv)
                                   : zero_u4();
    *reinterpret_cast<uint4*>(sel_s + r * PITCH + cv) = val;
  }
  wg::named_sync(1, 256);
  const int wgi = tid >> 7, w = warp & 3;
  uint32_t a[4 * NE][4];
  const uint32_t a_base = wg::smem_u32(
      sel_s + (64 * wgi + 16 * w + (lane & 15)) * PITCH + (lane >> 4) * 8);
#pragma unroll
  for (int ks = 0; ks < 4 * NE; ++ks) wg::ldsm_x4(a[ks], a_base + ks * 32);
  wg::named_sync(1, 256);          // the selection area becomes the staging

  const bool leader = (tid & 127) == 0;
  const int g = lane >> 2, t = lane & 3;
  wg::Ring ring;
  for (int i = 0; i < nt; ++i) {
    const int col0 = (tile0 + i) * 64;
    wg::mbar_wait(full + ring.stage, ring.phase);
    const unsigned char* st = smem + ring.stage * Cfg::STAGE;
    float acc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.f;
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int et = 0; et < NE; ++et)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wg::wgmma_rs_mn(acc, a[4 * et + ks],
                        wg::mnmajor_desc<128>(st + TILE64 * et + ks * 16 * 128,
                                              TILE64));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);

    // the product into this warpgroup's staging tile (once the store of
    // the tile before has read it), the stage back to the producer, the
    // staging tile out by TMA
    const unsigned char* d0 = st + Cfg::P_BYTES + wgi * TILE64;
    unsigned char* ob = shared + wgi * TILE64;
    if (leader) wg::bulk_wait_read();
    wg::named_sync(2 + wgi, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * w + g + 8 * half, row = row0 + 64 * wgi + r;
        if (row < n) {
          const int cl = 8 * j + 2 * t;
          const int off = swz(r, cl);
          const float m0 = acc[4 * j + 2 * half], m1 = acc[4 * j + 2 * half + 1];
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(d0 + off);
          float v0, v1;
          if (HID) {
            const __nv_bfloat162 gv =
                *reinterpret_cast<const __nv_bfloat162*>(d0 + DTILE + off);
            v0 = bf2f(f2bf(bf2f(hv.x) * bf2f(gv.x))) * bf2f(f2bf(m0));
            v1 = bf2f(f2bf(bf2f(hv.y) * bf2f(gv.y))) * bf2f(f2bf(m1));
          } else {
            v0 = bf2f(hv.x) * m0;
            v1 = bf2f(hv.y) * m1;
          }
          *reinterpret_cast<__nv_bfloat162*>(ob + off) = pack2(v0, v1);
        }
      }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + ring.stage);
    wg::fence_proxy_async();
    wg::named_sync(2 + wgi, 128);
    if (leader) {
      wg::tma_store_2d(&omap, ob, col0, row0 + 64 * wgi);
      wg::bulk_commit();
    }
    ring.advance(STAGES);
  }
  if (leader) wg::bulk_wait();
}

// ----------------------------------------------------------- launchers
template <int NE>
cudaError_t launch_scores(const CUtensorMap& amap, const CUtensorMap& pmap,
                          int n, int hdim, int e, int k, int split, int per,
                          float* partial, bf16* sel, cudaStream_t st) {
  static bool done = false;
  auto kernel = route_scores_kernel<NE>;
  cudaError_t err = configure(kernel, ScoreCfg<NE>::SMEM, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + ROWS_WG - 1) / ROWS_WG, split);
  kernel<<<grid, R_THREADS, ScoreCfg<NE>::SMEM, st>>>(amap, pmap, n, hdim / BK,
                                                      per, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int rows = NE == 1 ? 32 : 8;      // a block's (8 warps)
  route_select_kernel<64 * NE><<<(n + rows - 1) / rows, 256, 0, st>>>(
      partial, split, n, e, k, sel);
  return cudaGetLastError();
}

template <int NE, bool HID>
cudaError_t launch_mask(const CUtensorMap& pmap, const CUtensorMap& d0,
                        const CUtensorMap& d1, const CUtensorMap& omap,
                        const bf16* sel, int n, int hdim, int per,
                        cudaStream_t st) {
  static bool done = false;
  auto kernel = route_mask_kernel<NE, HID>;
  constexpr int smem = MaskCfg<NE, HID>::SMEM;
  cudaError_t err = configure(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const int tiles = hdim / 64, rows = MaskCfg<NE, HID>::ROWS;
  const dim3 grid((n + rows - 1) / rows, (tiles + per - 1) / per);
  kernel<<<grid, MaskCfg<NE, HID>::THREADS, smem, st>>>(pmap, d0, d1, omap, sel,
                                                        n, hdim, per);
  return cudaGetLastError();
}

// The routing stage: scores, selection, mask. `data` is h*ga (FF) or
// hidden (routing kernel, rows ld apart) with `gate` beside it.
struct RouteArgs {
  const bf16 *score_in, *data, *gate, *pat;
  int ld, n, hdim, e, k, split, per, mask_per;
  float* partial;
  bf16 *sel, *out;
  cudaStream_t st;
};

template <bool HID>
cudaError_t route_stage(const RouteArgs& r) {
  const int ne = (r.e + 63) / 64;
  CUtensorMap amap, pmap, d0, d1, omap;
  const uint64_t row = (uint64_t)r.hdim * 2;
  if (!map_2d(&amap, r.score_in, r.hdim, r.n, row, 64) ||
      !map_2d(&pmap, r.pat, r.hdim, r.e, row, 64) ||
      !map_2d(&d0, r.data, r.hdim, r.n, (uint64_t)r.ld * 2, 128) ||
      !map_2d(&d1, r.gate, r.hdim, r.n, row, 128) ||
      !map_2d(&omap, r.out, r.hdim, r.n, row, 64))
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (ne) {
    case 1: err = launch_scores<1>(amap, pmap, r.n, r.hdim, r.e, r.k, r.split, r.per, r.partial, r.sel, r.st); break;
    case 2: err = launch_scores<2>(amap, pmap, r.n, r.hdim, r.e, r.k, r.split, r.per, r.partial, r.sel, r.st); break;
    case 3: err = launch_scores<3>(amap, pmap, r.n, r.hdim, r.e, r.k, r.split, r.per, r.partial, r.sel, r.st); break;
    case 4: err = launch_scores<4>(amap, pmap, r.n, r.hdim, r.e, r.k, r.split, r.per, r.partial, r.sel, r.st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  switch (ne) {
    case 1: return launch_mask<1, HID>(pmap, d0, d1, omap, r.sel, r.n, r.hdim, r.mask_per, r.st);
    case 2: return launch_mask<2, HID>(pmap, d0, d1, omap, r.sel, r.n, r.hdim, r.mask_per, r.st);
    case 3: return launch_mask<3, HID>(pmap, d0, d1, omap, r.sel, r.n, r.hdim, r.mask_per, r.st);
    default: return launch_mask<4, HID>(pmap, d0, d1, omap, r.sel, r.n, r.hdim, r.mask_per, r.st);
  }
}

struct UpArgs {
  CUtensorMap amap, wmap, hgmap, gamap;
  const bf16* b1;
  int n, c, hdim, ctas;
  cudaStream_t st;
};

template <int NWG, bool ROUTE, bool RELU>
cudaError_t launch_up(const UpArgs& a) {
  using Cfg = UpCfg<NWG, ROUTE>;
  static bool done = false;
  auto kernel = ff_up_kernel<NWG, ROUTE, RELU>;
  cudaError_t err = configure(kernel, Cfg::SMEM, done);
  if (err != cudaSuccess) return err;
  kernel<<<a.ctas, Cfg::THREADS, Cfg::SMEM, a.st>>>(
      a.amap, a.wmap, a.hgmap, a.gamap, a.b1, a.n, a.c, a.hdim);
  return cudaGetLastError();
}

template <int NWG>
cudaError_t dispatch_up(bool route, bool relu, const UpArgs& a) {
  if (route)
    return relu ? launch_up<NWG, true, true>(a) : launch_up<NWG, true, false>(a);
  return relu ? launch_up<NWG, false, true>(a) : launch_up<NWG, false, false>(a);
}

template <int NWG, bool SPLIT, bool RESID>
cudaError_t launch_down(const CUtensorMap& amap, const CUtensorMap& wmap,
                        const bf16* b2, const bf16* x, int n, int c, int hdim,
                        int split, int per, bf16* y, float* partial,
                        cudaStream_t st) {
  static bool done = false;
  return launch_down_gemm<NWG, SPLIT>(ff_down_kernel<NWG, SPLIT, RESID>, done,
                                      amap, wmap, b2, x, n, c, hdim / BK,
                                      split, per, y, partial, st);
}

template <int NWG>
cudaError_t dispatch_down(bool split, bool resid, const CUtensorMap& amap,
                          const CUtensorMap& wmap, const bf16* b2,
                          const bf16* x, int n, int c, int hdim, int nsplit,
                          int per, bf16* y, float* partial, cudaStream_t st) {
  if (split)
    return resid ? launch_down<NWG, true, true>(amap, wmap, b2, x, n, c, hdim, nsplit, per, y, partial, st)
                 : launch_down<NWG, true, false>(amap, wmap, b2, x, n, c, hdim, nsplit, per, y, partial, st);
  return resid ? launch_down<NWG, false, true>(amap, wmap, b2, x, n, c, hdim, nsplit, per, y, partial, st)
               : launch_down<NWG, false, false>(amap, wmap, b2, x, n, c, hdim, nsplit, per, y, partial, st);
}

}  // namespace

extern "C" {

const char* dmoe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches 0-2 of the fused FF: the LN pass (ln_g, ln_b (c) f32, or both
// null: no LN), ff_up and, with pat (e, hdim) bf16 (e <= 256, 1 <= k <= e),
// the routing stage; the result, prod (n, hdim) bf16, is what ff_down
// reads. x (n, c), w1 (2 hdim, c), b1 (2 hdim) bf16; c % 32 == 0 and
// hdim % 64 == 0 (checked by the wrapper). Scratch: xn (n, c) bf16 with LN;
// routed, ga and hg (n, hdim) bf16, partial (split, n, epad) f32 and sel
// (n, epad) bf16, epad = 64 ceil(e / 64). The plan is the wrapper's
// (geglu_ff_fused.py:ff_plan): up_wgs consumer warpgroups and up_ctas
// persistent blocks of ff_up, the scores' depth split into `split` parts of
// `per` 64-deep chunks, `mask_per` 64-column tiles a mask block.
int dmoe_ff_front(const void* x, const void* w1, const void* b1,
                  const void* ln_g, const void* ln_b, float eps,
                  const void* pat, int e, int k, int n, int c, int hdim,
                  int relu, int up_wgs, int up_ctas, int split, int per,
                  int mask_per, void* xn, void* ga, void* hg, void* partial,
                  void* sel, void* prod,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(x);
  if (ln_g != nullptr) {
    const auto G = static_cast<const float*>(ln_g);
    const auto Bb = static_cast<const float*>(ln_b);
    const auto XN = static_cast<bf16*>(xn);
    const int blocks = (n + 7) / 8;
    switch ((c + 255) / 256) {
      case 1: ln_rows_kernel<1><<<blocks, 256, 0, st>>>(a, G, Bb, eps, n, c, XN); break;
      case 2: ln_rows_kernel<2><<<blocks, 256, 0, st>>>(a, G, Bb, eps, n, c, XN); break;
      case 3: ln_rows_kernel<3><<<blocks, 256, 0, st>>>(a, G, Bb, eps, n, c, XN); break;
      case 4: ln_rows_kernel<4><<<blocks, 256, 0, st>>>(a, G, Bb, eps, n, c, XN); break;
      case 5: ln_rows_kernel<5><<<blocks, 256, 0, st>>>(a, G, Bb, eps, n, c, XN); break;
      default: ln_rows_kernel<0><<<blocks, 256, 0, st>>>(a, G, Bb, eps, n, c, XN); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a = static_cast<const bf16*>(xn);
  }
  const bool route = pat != nullptr;
  bf16* up_out = static_cast<bf16*>(route ? hg : prod);
  UpArgs u;
  const uint64_t hrow = (uint64_t)hdim * 2;
  if (!map_2d(&u.amap, a, c, n, (uint64_t)c * 2, up_wgs * ROWS_WG) ||
      !map_2d(&u.wmap, w1, c, 2 * (uint64_t)hdim, (uint64_t)c * 2, UP_BN) ||
      !map_2d(&u.hgmap, up_out, hdim, n, hrow, ROWS_WG) ||
      !map_2d(&u.gamap, route ? ga : up_out, hdim, n, hrow, ROWS_WG))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto P = static_cast<const bf16*>(pat);
  const auto GA = static_cast<bf16*>(ga);
  u.b1 = static_cast<const bf16*>(b1);
  u.n = n;
  u.c = c;
  u.hdim = hdim;
  u.ctas = up_ctas;
  u.st = st;
  cudaError_t err = up_wgs == 2 ? dispatch_up<2>(route, relu != 0, u)
                                : dispatch_up<1>(route, relu != 0, u);
  if (err != cudaSuccess || !route) return static_cast<int>(err);
  const RouteArgs r{GA, up_out, GA, P, hdim, n, hdim, e, k, split, per, mask_per,
                    static_cast<float*>(partial), static_cast<bf16*>(sel),
                    static_cast<bf16*>(prod), st};
  return static_cast<int>(route_stage<false>(r));
}

// The routing kernel: out = bf16(bf16(hidden * gate) * topk_mask). hidden
// (n, hdim) bf16 with rows ld_hidden elements apart (ld_hidden % 8 == 0);
// gate (n, hdim) bf16, activated, contiguous; pat (e, hdim) bf16 with
// e <= 256, 1 <= k <= e; hdim % 64 == 0. Scratch and plan as the FF's
// routing stage (routing_kernel.py:route_plan).
int dmoe_route_multiply(const void* hidden, int ld_hidden, const void* gate,
                        const void* pat, int n, int hdim, int e, int k,
                        int split, int per, int mask_per, void* partial,
                        void* sel, void* out, void* stream) {
  const RouteArgs r{static_cast<const bf16*>(gate),
                    static_cast<const bf16*>(hidden),
                    static_cast<const bf16*>(gate),
                    static_cast<const bf16*>(pat), ld_hidden, n, hdim, e, k,
                    split, per, mask_per, static_cast<float*>(partial),
                    static_cast<bf16*>(sel),
                    static_cast<bf16*>(out), static_cast<cudaStream_t>(stream)};
  return static_cast<int>(route_stage<true>(r));
}

// Launch 3. prod (n, hdim), w2 (c, hdim), b2 (c) bf16, x (n, c) or null (no
// residual). The plan: wgs consumer warpgroups, the hdim depth split into
// `split` parts of `per` 64-deep chunks; with split > 1, partial is an f32
// scratch of (split, n, c).
int dmoe_ff_down(const void* prod, const void* w2, const void* b2,
                 const void* x, int n, int c, int hdim, int wgs, int split,
                 int per, void* partial, void* y, void* stream) {
  CUtensorMap amap, wmap;
  if (!map_2d(&amap, prod, hdim, n, (uint64_t)hdim * 2, wgs * ROWS_WG) ||
      !map_2d(&wmap, w2, hdim, c, (uint64_t)hdim * 2, DOWN_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto B2 = static_cast<const bf16*>(b2);
  const auto X = static_cast<const bf16*>(x);
  const auto Y = static_cast<bf16*>(y);
  const auto PART = static_cast<float*>(partial);
  const cudaError_t err =
      wgs == 2 ? dispatch_down<2>(split > 1, x != nullptr, amap, wmap, B2, X, n, c, hdim, split, per, Y, PART, st)
               : dispatch_down<1>(split > 1, x != nullptr, amap, wmap, B2, X, n, c, hdim, split, per, Y, PART, st);
  return static_cast<int>(err);
}

}  // extern "C"
