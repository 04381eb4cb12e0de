// The absorbed self-attention sub-block's projection kernels for Hopper, on
// wgmma, TMA and mbarrier rings: LayerNorm + q/k/v projection before the
// flash kernel, and output projection + bias + residual after it.
//
// Replaces the Pallas TPU kernels diffusion_models_moe_tpu/ops/
// attn_absorb_fused.py:_qkv_kernel (pallas_call at :142) and :_out_kernel
// (pallas_call at :241). Those exist to hand the TPU flash call its
// (B, H, S, 128-lane) operands without a transpose or a pad pass. The flash
// kernel of this package (sd_attention.cu) reads (B, S, H, D) through
// strides at the native head dim, so neither the transpose nor the pad is
// carried over; what is carried over is the fusion:
//
//   ln_qkv_kernel    (kernel 5) y (N, 3C) = [q | k | v] = LN(x) [Wq Wk Wv]^T.
//                    A block owns a panel of 64 or 128 rows of x (one or two
//                    consumer warpgroups) and a run of 160-column output
//                    tiles, each inside one of q, k, v (a third of
//                    ceil(C / 160) tiles: no tile straddles two weights).
//                    A producer warp brings the panel in once by TMA, as
//                    64-column sub-tiles in the 128-byte swizzle; the
//                    consumers compute each row's mean and variance in f32
//                    from shared memory (8 lanes a row, fast variance, the
//                    rsqrt folded into the scale as ln_rows_kernel does) and
//                    write bf16((x - mu) (rs g) + b) back into the panel in
//                    place: the TPU kernel's rounding point. The panel is
//                    then the A operand of every product of the block, so x
//                    is read once and normalised once a block. The weights
//                    (three (C, C) nn.Linear weights, three tensor maps:
//                    nothing is concatenated) stream through a 3-4 stage TMA
//                    ring of 160 x 64 tiles, the K-major B operand of wgmma
//                    m64n160k16. The epilogue rounds the f32 sums to bf16
//                    into a staging of 32-column boxes in the 64-byte
//                    swizzle and TMA-stores them through one map a
//                    third (strides (S*3C, 3C, D, 1) for q, k, v viewed as
//                    (B, S, H, D): kernel 2 takes them as they are); the
//                    stores run under the next tile's products.
//   attn_out_kernel  (kernel 6) y (N, C) = bf16(bf16(o Wo^T + bo) + x): the
//                    output GEMM of down_gemm.cuh, which kernel 1's ff_down
//                    shares (m64n160k16 on 160-channel tiles, a 5-6 stage
//                    TMA ring, the depth split below half a wave and
//                    finished in a fixed order by wg::split_finish_kernel).
//                    A is the flash output (B, S, H, D) read through a 2-D
//                    (C, B*S) tensor map over its row stride: the heads
//                    must be dense (stride D) and the rows evenly spaced,
//                    which kernel 2's output and a column third of kernel
//                    5's output are (the wrapper checks).
//
// Shared memory of kernel 5 (227 KB a block): the panel is
// 128 B x rows x ceil(C / 64), the ring 20 KB a stage, the staging 4 KB a
// box (five a tile). C = 320 takes two warpgroups (80 KB of panel, 40 KB
// of staging, a 4-stage ring); C = 640 one (80 + 20 KB, 4 stages); C = 1280
// one, and its 160 KB panel leaves room for a 3-stage ring beside a
// one-box staging that the epilogue fills five times (with all five boxes
// the ring would have two stages, and the weight loads' latency would not
// be hidden). C above 1408 does not fit (the plan raises).
//
// The plan (warpgroups, the run of column tiles, the ring's depth, kernel
// 6's depth split) is the wrapper's: ops/attn_absorb_fused.py:absorb_plan.
// Where the row panels alone leave half the SMs idle, a block takes a share
// of the 3 ceil(C / 160) column tiles instead of all of them, and the panel
// is loaded and normalised once in each such block.
//
// What binds (NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6). Kernel 5
// moves 8 C bytes a row (x in, q, k, v out) for 6 C^2 operations: memory
// bound at C = 320, tensor-core bound above. At C = 320 and 640 it runs at
// about cuBLAS's time for the product alone; the two warpgroups of a C = 320
// block share each tile, so the LayerNorm and the epilogues are not under
// products. At C = 1280 the 160 KB panel leaves room for three weight tiles
// in flight, too few to hide their load latency, and each block pays its
// panel's load and LayerNorm before its first product; multicasting the
// weight tiles over clusters of two or four blocks (each weight read from L2
// half or a quarter as often) was slower at every shape, so L2 bandwidth is
// not what binds. Kernel 6 is memory bound at C = 320 and 640 and
// latency-bound at the two small levels, where its depth is split.
//
// Inference only: there is no backward.
#include "down_gemm.cuh"

namespace {

constexpr int QKV_BN = 160;                      // columns of an output tile
constexpr int W_TILE = QKV_BN * 128;             // a 160 x 64 weight tile
constexpr int BOX_COLS = 32;                     // a staging box: 64-byte rows
constexpr int BOXES = QKV_BN / BOX_COLS;         // five boxes a tile
constexpr int BOX = ROWS_WG * BOX_COLS * 2;      // bytes of a 64 x 32 box
constexpr int SMEM_BUDGET = 232448;

// Bytes of kernel 5's layout: the panel, the ring, the staging (`boxes`
// boxes a warpgroup), the barriers, and the slack that aligns the first to
// 1024 bytes (attn_absorb_fused.py:qkv_smem says the same).
inline int qkv_smem(int nwg, int c, int stages, int boxes) {
  const int nsub = (c + BK - 1) / BK;
  return nsub * nwg * ROWS_WG * 128 + stages * W_TILE + nwg * boxes * BOX +
         2048;
}

// The byte offset of (row r, bf16 column col) in a 64 x 32 box of 64-byte
// rows in the TMA's 64-byte swizzle (16-byte chunk ^= address bits 7-8).
__device__ __forceinline__ int swz64(int r, int col) {
  return r * 64 + ((((col >> 3) ^ ((r >> 1) & 3))) << 4) + (col & 7) * 2;
}

// The consumer warpgroups of ln_qkv_kernel: the LayerNorm of their rows of
// the panel in place, then the products of the block's column tiles and
// their epilogue.
template <int NWG, bool LN>
__device__ __forceinline__ void consume(
    unsigned char* smem, unsigned char* ring, unsigned char* staging,
    uint64_t* full, uint64_t* empty, uint64_t* panel_bar,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b, float eps,
    int c, int stages, int boxes, int row0, int tile0, int ntiles, int third,
    const CUtensorMap& yqmap, const CUtensorMap& ykmap,
    const CUtensorMap& yvmap) {
  constexpr int ROWS = NWG * ROWS_WG;
  constexpr int SUB = ROWS * 128;
  const int nsub = (c + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = tid >> 7;
  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = group - 1;
  const bool leader = (tid & 127) == 0;          // issues the WG's stores
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  wg::mbar_wait(panel_bar, 0);
  if (LN) {
    // the warpgroup's own 64 rows, 8 lanes a row and four rows a lane
    // (16 apart, so the same swizzled place in each): lane `sub` takes the
    // 16-byte chunk `sub` (columns 64 kc + 8 sub ..) of every sub-tile
    constexpr int RL = ROWS_WG / 16;
    const int sub = lane & 7;
    const int r0 = wgi * ROWS_WG + 4 * w + (lane >> 3);
    unsigned char* at = smem + r0 * 128 + ((sub ^ (r0 & 7)) << 4);
    float s[RL], ss[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i) s[i] = ss[i] = 0.f;
#pragma unroll 2
    for (int kc = 0; kc < nsub; ++kc)
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        alignas(16) bf16 v[8];
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(at + kc * SUB + i * 16 * 128);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float f = bf2f(v[q]);
          s[i] += f;
          ss[i] += f * f;
        }
      }
    float mu[RL], rs[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
        ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], o);
      }
      mu[i] = s[i] / (float)c;
      const float var = fmaxf(ss[i] / (float)c - mu[i] * mu[i], 0.f);
      rs[i] = 1.0f / sqrtf(var + eps);
    }
#pragma unroll 2
    for (int kc = 0; kc < nsub; ++kc) {
      const int col = kc * BK + sub * 8;
      if (col >= c) continue;                    // the zeros past C stay
      alignas(16) float g8[8], b8[8];
      *reinterpret_cast<float4*>(g8) = *reinterpret_cast<const float4*>(ln_g + col);
      *reinterpret_cast<float4*>(g8 + 4) =
          *reinterpret_cast<const float4*>(ln_g + col + 4);
      *reinterpret_cast<float4*>(b8) = *reinterpret_cast<const float4*>(ln_b + col);
      *reinterpret_cast<float4*>(b8 + 4) =
          *reinterpret_cast<const float4*>(ln_b + col + 4);
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        unsigned char* p = at + kc * SUB + i * 16 * 128;
        alignas(16) bf16 v[8];
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[q] = f2bf((bf2f(v[q]) - mu[i]) * (rs[i] * g8[q]) + b8[q]);
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
      }
    }
    // the generic-proxy writes, seen by wgmma (async proxy) after the
    // warpgroup's barrier
    wg::fence_proxy_async();
  }
  wg::named_sync(2 + wgi, 128);

  unsigned char* stage_out = staging + wgi * boxes * BOX;
  const unsigned char* a_rows = smem + wgi * ROWS_WG * 128;
  wg::Ring rg;
  for (int i = 0; i < ntiles; ++i) {
    const int which = (tile0 + i) / third;
    const int n0 = (tile0 + i - which * third) * QKV_BN;
    float acc[80];
#pragma unroll
    for (int q = 0; q < 80; ++q) acc[q] = 0.f;
    int prev = 0;
    for (int kc = 0; kc < nsub; ++kc) {
      wg::mbar_wait(full + rg.stage, rg.phase);
      const uint64_t ad = wg::kmajor_desc<128>(a_rows + kc * SUB);
      const uint64_t bd = wg::kmajor_desc<128>(ring + rg.stage * W_TILE);
      wg::fence_regs(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wg::wgmma_ss(acc, ad + 2 * ks, bd + 2 * ks, true);
      wg::wgmma_commit();
      if (kc > 0) {
        wg::wgmma_wait<1>();
        if (lane == 0) wg::mbar_arrive(empty + prev);
      }
      prev = rg.stage;
      rg.advance(stages);
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if (lane == 0) wg::mbar_arrive(empty + prev);

    // the epilogue, box by box into the staging in rounds of `boxes`: a
    // round starts once the stores before have read the staging. This
    // thread: rows 16 w + g and + 8 of its warpgroup's 64, columns
    // 8 j + 2 t + {0, 1} of the tile's 160 (box j / 4).
    const CUtensorMap* ymap =
        which == 0 ? &yqmap : (which == 1 ? &ykmap : &yvmap);
#pragma unroll
    for (int box = 0; box < BOXES; ++box) {
      const int slot = box % boxes;
      if (slot == 0) {
        if (leader) wg::bulk_wait_read();
        wg::named_sync(2 + wgi, 128);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 4 * box + jj, r = 16 * w + g + 8 * half;
          *reinterpret_cast<__nv_bfloat162*>(stage_out + slot * BOX +
                                             swz64(r, 8 * jj + 2 * t)) =
              __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                    acc[4 * j + 2 * half + 1]);
        }
      if (slot == boxes - 1 || box == BOXES - 1) {
        wg::fence_proxy_async();
        wg::named_sync(2 + wgi, 128);
        if (leader) {
          for (int k = 0; k <= slot; ++k) {
            const int col = n0 + BOX_COLS * (box - slot + k);
            if (col < c)
              wg::tma_store_2d(ymap, stage_out + k * BOX, col,
                               row0 + wgi * ROWS_WG);
          }
          wg::bulk_commit();
        }
      }
    }
  }
  if (leader) wg::bulk_wait();
}

// A block: rows [blockIdx.y * 64 NWG, + 64 NWG), column tiles
// [blockIdx.x * run, + run) of the 3 ceil(C / 160). A warpgroup stages its
// tile's five boxes in
// rounds of `boxes` (5, or 1 where five would cost the ring a stage).
template <int NWG, bool LN>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) ln_qkv_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wqmap,
    const __grid_constant__ CUtensorMap wkmap,
    const __grid_constant__ CUtensorMap wvmap,
    const __grid_constant__ CUtensorMap yqmap,
    const __grid_constant__ CUtensorMap ykmap,
    const __grid_constant__ CUtensorMap yvmap, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, float eps, int c, int stages, int run,
    int boxes) {
  constexpr int ROWS = NWG * ROWS_WG;
  constexpr int SUB = ROWS * 128;                // bytes of a panel sub-tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  const int nsub = (c + BK - 1) / BK;            // sub-tiles = depth chunks
  unsigned char* ring = smem + nsub * SUB;
  unsigned char* staging = ring + stages * W_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + NWG * boxes * BOX);
  uint64_t* empty = full + stages;
  uint64_t* panel_bar = empty + stages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = tid >> 7;                    // 0: producer; 1..NWG
  const int row0 = blockIdx.y * ROWS;
  const int third = (c + QKV_BN - 1) / QKV_BN;   // column tiles of q, k or v
  const int tile0 = blockIdx.x * run;
  const int ntiles = min(run, 3 * third - tile0);   // >= 1 by the plan

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 4 * NWG);
    }
    wg::mbar_init(panel_bar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (group == 0) {
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      // the panel once (zeros past N and past C), then the weight tiles
      wg::mbar_expect_tx(panel_bar, nsub * SUB);
      for (int kc = 0; kc < nsub; ++kc)
        wg::tma_load_2d(smem + kc * SUB, &xmap, panel_bar, kc * BK, row0);
      wg::Ring rg;
      for (int i = 0; i < ntiles; ++i) {
        const int which = (tile0 + i) / third;
        const int n0 = (tile0 + i - which * third) * QKV_BN;
        const CUtensorMap* wmap =
            which == 0 ? &wqmap : (which == 1 ? &wkmap : &wvmap);
        for (int kc = 0; kc < nsub; ++kc) {
          wg::mbar_wait(empty + rg.stage, rg.phase ^ 1);
          uint64_t* bar = full + rg.stage;
          wg::mbar_expect_tx(bar, W_TILE);
          wg::tma_load_2d(ring + rg.stage * W_TILE, wmap, bar, kc * BK, n0);
          rg.advance(stages);
        }
      }
    }
  } else {
    consume<NWG, LN>(smem, ring, staging, full, empty, panel_bar, ln_g, ln_b,
                     eps, c, stages, boxes, row0, tile0, ntiles, third,
                     yqmap, ykmap, yvmap);
  }
}


// A third of y (C columns of rows 3C apart) in boxes of 32 columns x 64 rows
// in the 64-byte swizzle: what kernel 5's staging holds.
bool third_map(CUtensorMap* map, const bf16* y, int c, int n) {
  const uint64_t dims[2] = {(uint64_t)c, (uint64_t)n};
  const uint64_t strides[1] = {(uint64_t)c * 6};
  const uint32_t box[2] = {BOX_COLS, ROWS_WG};
  return wg::encode_bf16_map(map, y, 2, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_64B);
}

struct QkvArgs {
  CUtensorMap x, w[3], y[3];
  const float *g, *b;
  float eps;
  int n, c, stages, run, boxes;
  cudaStream_t st;
};

template <int NWG, bool LN>
cudaError_t launch_qkv(const QkvArgs& a) {
  static bool done = false;
  auto kernel = ln_qkv_kernel<NWG, LN>;
  const cudaError_t err = configure(kernel, SMEM_BUDGET, done);
  if (err != cudaSuccess) return err;
  const int tiles = 3 * ((a.c + QKV_BN - 1) / QKV_BN);
  const dim3 grid((tiles + a.run - 1) / a.run,
                  (a.n + NWG * ROWS_WG - 1) / (NWG * ROWS_WG));
  kernel<<<grid, 128 * (NWG + 1), qkv_smem(NWG, a.c, a.stages, a.boxes),
           a.st>>>(a.x, a.w[0], a.w[1], a.w[2], a.y[0], a.y[1], a.y[2], a.g,
                   a.b, a.eps, a.c, a.stages, a.run, a.boxes);
  return cudaGetLastError();
}

template <int NWG, bool SPLIT>
__global__ void __launch_bounds__(DownCfg<NWG>::THREADS, 1) attn_out_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ bo,
    const bf16* __restrict__ resid, int n, int c, int nchunks, int per,
    bf16* __restrict__ y, float* __restrict__ partial) {
  down_gemm<NWG, SPLIT, true>(amap, wmap, bo, resid, n, c, nchunks, per, y,
                              partial);
}

template <int NWG, bool SPLIT>
cudaError_t launch_out(const CUtensorMap& amap, const CUtensorMap& wmap,
                       const bf16* bo, const bf16* resid, int n, int c,
                       int split, int per, bf16* y, float* partial,
                       cudaStream_t st) {
  static bool done = false;
  return launch_down_gemm<NWG, SPLIT>(attn_out_kernel<NWG, SPLIT>, done, amap,
                                      wmap, bo, resid, n, c, (c + BK - 1) / BK,
                                      split, per, y, partial, st);
}

}  // namespace

extern "C" {

// Kernel 5. x (n, c) bf16; wq, wk, wv (c, c) bf16 in the nn.Linear layout
// (out, in); ln_g, ln_b (c) f32 or both null (no LayerNorm); y (n, 3c)
// bf16. c % 8 == 0 (checked by the wrapper). The plan: wgs consumer
// warpgroups, a ring of `stages` weight tiles, `run` column tiles a block,
// `boxes` staging boxes a warpgroup (1 or 5).
int dmoe_ln_qkv(const void* x, const void* wq, const void* wk, const void* wv,
                const void* ln_g, const void* ln_b, float eps, int n, int c,
                int wgs, int stages, int run, int boxes, void* y,
                void* stream) {
  if (qkv_smem(wgs, c, stages, boxes) > SMEM_BUDGET || boxes < 1 ||
      boxes > BOXES)
    return static_cast<int>(cudaErrorInvalidValue);
  QkvArgs a;
  const uint64_t row = (uint64_t)c * 2;
  const auto Y = static_cast<const bf16*>(y);
  const void* w[3] = {wq, wk, wv};
  if (!map_2d(&a.x, x, c, n, row, wgs * ROWS_WG))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i)
    if (!map_2d(&a.w[i], w[i], c, c, row, QKV_BN) ||
        !third_map(&a.y[i], Y + i * c, c, n))
      return static_cast<int>(cudaErrorInvalidValue);
  a.g = static_cast<const float*>(ln_g);
  a.b = static_cast<const float*>(ln_b);
  a.eps = eps;
  a.n = n;
  a.c = c;
  a.stages = stages;
  a.run = run;
  a.boxes = boxes;
  a.st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ln_g != nullptr)
    err = wgs == 2 ? launch_qkv<2, true>(a) : launch_qkv<1, true>(a);
  else
    err = wgs == 2 ? launch_qkv<2, false>(a) : launch_qkv<1, false>(a);
  return static_cast<int>(err);
}

// Kernel 6. o: the (n, c) rows of the flash output, `ld` elements apart
// (ld % 8 == 0), each row's C values contiguous (heads dense); wo (c, c)
// bf16 (out, in); bo (c) bf16; resid and y (n, c) bf16, contiguous. The
// plan: wgs consumer warpgroups, the c depth split into `split` parts of
// `per` 64-deep chunks; with split > 1, partial is an f32 scratch of
// (split, n, c).
int dmoe_attn_out_residual(const void* o, long long ld, const void* wo,
                           const void* bo, const void* resid, int n, int c,
                           int wgs, int split, int per, void* partial, void* y,
                           void* stream) {
  CUtensorMap amap, wmap;
  if (!map_2d(&amap, o, c, n, (uint64_t)ld * 2, wgs * ROWS_WG) ||
      !map_2d(&wmap, wo, c, c, (uint64_t)c * 2, DOWN_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto BO = static_cast<const bf16*>(bo);
  const auto R = static_cast<const bf16*>(resid);
  const auto Y = static_cast<bf16*>(y);
  const auto P = static_cast<float*>(partial);
  cudaError_t err;
  if (split > 1)
    err = wgs == 2 ? launch_out<2, true>(amap, wmap, BO, R, n, c, split, per, Y, P, st)
                   : launch_out<1, true>(amap, wmap, BO, R, n, c, split, per, Y, P, st);
  else
    err = wgs == 2 ? launch_out<2, false>(amap, wmap, BO, R, n, c, split, per, Y, P, st)
                   : launch_out<1, false>(amap, wmap, BO, R, n, c, split, per, Y, P, st);
  return static_cast<int>(err);
}

}  // extern "C"
