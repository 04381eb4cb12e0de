// The fused Winograd F(2x2, 3x3) convolution for Hopper: stride-1 SAME 3x3
// conv as input transform, 16 tensor-core products and inverse transform in
// one kernel, on wgmma, TMA and a producer/consumer pipeline.
//
// Replaces the Pallas TPU kernel diffusion_models_moe_tpu/ops/
// winograd_fused.py:_kernel (pallas_call at :203). That kernel gets its input
// de-interleaved into even and odd columns and stacked into overlapping row
// bands outside the kernel, keeps a whole (16, Cin, Cout-block) filter in
// VMEM and writes four output planes that are transposed afterwards; all of
// that is layout work for Mosaic. Here:
//
//   rows     a square of 8 x 8 output tiles (16 x 16 pixels) of one image, 64
//            rows of every product
//   columns  Cout, 128 a block: two consumer warpgroups of 64 columns each,
//            on the same V tiles
//   depth    Cin in chunks of 32
//
// The producer warpgroup, per chunk. One thread asks TMA for the square's
// raw input patch, 18 x 18 pixels x 32 channels with its 1-pixel halo (a 4-D
// tensor map of x with signed start coordinates: outside the image and past
// Cin the hardware writes zeros), and for the 16 tiles U[p] (128 x 32) of the
// hoisted filter u (16, Cout, Cin) (a 3-D map, 64-byte swizzle) through a
// ring of 6 stages, all completing on mbarriers. The other three producer
// warps transform the patch, V = B^T d B in f32 (rows of the patch first,
// then columns, then one rounding to bf16: the TPU kernel's order), 4
// channels an item, into the 16 tiles V[p] (64 x 32) of the *next* chunk's
// buffer, in the 64-byte swizzle that wgmma reads, and hand the buffer over
// through an mbarrier: the transform runs while the consumers multiply the
// chunk before.
//
// The consumers. Sixteen (64 x 64) f32 accumulators do not fit in registers.
// The inverse transform A^T M A is linear, so it commutes with the sum over
// Cin: per position p a consumer warpgroup runs wgmma m64n64k16 twice over
// the chunk (A = V[p], B = U[p], both from shared memory, the first with
// scale-d 0, so nothing is zeroed) into one product tile and adds it, with
// its sign, into the 4 output planes it belongs to (the entries of A^T are 0
// and +-1: 36 signed adds of a product tile for 16 products, not 36 MMAs).
// The planes are 128 registers a thread, the product tile 32: the consumers
// take 208 registers with setmaxnreg and the producers keep 88. While one
// warpgroup adds, the other's products have the tensor cores.
//
// What binds it. Not the tensor cores and no single stage: a position is 64
// tensor-core cycles of work a warpgroup between two synchronisations, the
// 36 signed adds a chunk take issue slots beside the transform, and a
// product with both operands in shared memory reads 4 KB of it. Chunks of 64
// channels would halve the adds and synchronisations per channel, but a V
// buffer would then take 128 KB and could not be doubled.
//
// Shared memory: 2 V buffers of 16 x 64 x 64 B (128 KB), 6 U stages of 8 KB,
// 2 raw patches of 20.25 KB: 217 KB, one block an SM.
//
// Where the grid is under half a wave (16 x 16 at batch 4) the wrapper splits
// the chunks over several blocks (grid z): each writes its f32 planes to a
// scratch and wg::split_finish_kernel adds them in a fixed order, rounds and
// adds the bias. Otherwise the epilogue rounds each plane to bf16, adds the
// bias in bf16 and writes the plane's pixel of every tile in place, from
// registers.
//
// Compute-bound at every SD1.5 shape but the smallest (2*16*Cin*Cout
// operations a tile against 2*4*(Cin + Cout) bytes and the filter once).
// Inference only: there is no backward.
#include "wgmma_tile.cuh"

namespace {

constexpr int W_POS = 16;               // Winograd positions 4 xi + yi
constexpr int W_BK = 32;                // input channels a chunk
constexpr int W_BN = 128;               // output channels a block
constexpr int W_SIDE = 8;               // output tiles along a side of a block
constexpr int W_RAW_SIDE = 2 * W_SIDE + 2;          // patch pixels along a side
constexpr int W_RAW = W_RAW_SIDE * W_RAW_SIDE * W_BK * 2;   // 20736 bytes
constexpr int W_VTILE = 64 * W_BK * 2;  // one position's V tile, 4096 bytes
constexpr int W_VBUF = W_POS * W_VTILE;
constexpr int W_UTILE = W_BN * W_BK * 2;            // 8192 bytes
constexpr int W_USTAGES = 6;
constexpr int W_THREADS = 384;
constexpr int W_TRANSFORMERS = 96;      // threads of the 3 transform warps
constexpr int W_ITEMS = 64 * (W_BK / 4);            // (tile, 4 channels)
constexpr int W_BARS = 2 * W_USTAGES + 8;
constexpr int W_SMEM =
    W_USTAGES * W_UTILE + 2 * W_VBUF + 2 * W_RAW + W_BARS * 8 + 1024;

// A^T of F(2x2, 3x3): rows (1, 1, 1, 0) and (0, 1, -1, -1)
__host__ __device__ constexpr int at_coef(int a, int k) {
  return a == 0 ? (k < 3 ? 1 : 0) : (k == 0 ? 0 : (k == 1 ? 1 : -1));
}

// out = B^T in along one axis: (i0 - i2, i1 + i2, i2 - i1, i1 - i3)
__device__ __forceinline__ void bt_combo(float (&o)[4], float i0, float i1,
                                         float i2, float i3) {
  o[0] = i0 - i2;
  o[1] = i1 + i2;
  o[2] = i2 - i1;
  o[3] = i1 - i3;
}

// The two channels packed in the 16 words `raw` (a 4 x 4 patch, row-major),
// transformed and stored: word p = 4 xi + yi, V[xi][yi] of both channels
// (one cvt packs the pair), goes to dst + p * W_VTILE.
__device__ __forceinline__ void transform_pair(unsigned char* dst,
                                               const uint32_t (&raw)[16]) {
  float t0[4][4], t1[4][4], o0[4], o1[4];
  // rows of the patch: t[xi][s] = sum_r B^T[xi][r] d[r][s]
#pragma unroll
  for (int ss = 0; ss < 4; ++ss) {
    bt_combo(o0, __uint_as_float(raw[ss] << 16),
             __uint_as_float(raw[4 + ss] << 16),
             __uint_as_float(raw[8 + ss] << 16),
             __uint_as_float(raw[12 + ss] << 16));
    bt_combo(o1, __uint_as_float(raw[ss] & 0xffff0000u),
             __uint_as_float(raw[4 + ss] & 0xffff0000u),
             __uint_as_float(raw[8 + ss] & 0xffff0000u),
             __uint_as_float(raw[12 + ss] & 0xffff0000u));
#pragma unroll
    for (int xi = 0; xi < 4; ++xi) {
      t0[xi][ss] = o0[xi];
      t1[xi][ss] = o1[xi];
    }
  }
  // columns: v[xi][yi] = sum_s B^T[yi][s] t[xi][s], rounded to bf16
#pragma unroll
  for (int xi = 0; xi < 4; ++xi) {
    bt_combo(o0, t0[xi][0], t0[xi][1], t0[xi][2], t0[xi][3]);
    bt_combo(o1, t1[xi][0], t1[xi][1], t1[xi][2], t1[xi][3]);
#pragma unroll
    for (int yi = 0; yi < 4; ++yi)
      *reinterpret_cast<__nv_bfloat162*>(dst + (4 * xi + yi) * W_VTILE) =
          __floats2bfloat162_rn(o0[yi], o1[yi]);
  }
}

template <bool SPLIT>
__global__ void __launch_bounds__(W_THREADS, 1) winograd_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap umap, const bf16* __restrict__ bias,
    int h, int wd, int cin, int cout, int blocks_x, int blocks_per_image,
    int chunks_per_split, bf16* __restrict__ y, float* __restrict__ partial) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  unsigned char* u_tiles = smem;                          // [6][128][64 B]
  unsigned char* v_bufs = u_tiles + W_USTAGES * W_UTILE;  // [2][16][64][64 B]
  unsigned char* raws = v_bufs + 2 * W_VBUF;              // [2][18][18][64 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(raws + 2 * W_RAW);
  uint64_t* full_u = bars;                     // U tile landed (TMA)
  uint64_t* empty_u = bars + W_USTAGES;        // its products completed
  uint64_t* full_raw = bars + 2 * W_USTAGES;   // raw patch landed (TMA)
  uint64_t* empty_raw = full_raw + 2;          // raw patch transformed
  uint64_t* full_v = full_raw + 4;             // V buffer stored
  uint64_t* empty_v = full_raw + 6;            // V buffer multiplied

  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid >> 7;                  // 0, 1 consumers; 2 producers
  const int warp_in_group = (tid >> 5) & 3;
  const int col0 = blockIdx.x * W_BN;
  const int pb = blockIdx.y / blocks_per_image;
  const int blk = blockIdx.y - pb * blocks_per_image;
  const int oy = (blk / blocks_x) * 2 * W_SIDE;    // the square's first pixel
  const int ox = (blk % blocks_x) * 2 * W_SIDE;
  const int nchunks = (cin + W_BK - 1) / W_BK;
  const int chunk0 = blockIdx.z * chunks_per_split;
  const int n = min(chunks_per_split, nchunks - chunk0);   // >= 1 by the plan

  if (tid == 0) {
    for (int s = 0; s < W_USTAGES; ++s) {
      wg::mbar_init(full_u + s, 1);
      wg::mbar_init(empty_u + s, 8);
    }
    for (int s = 0; s < 2; ++s) {
      wg::mbar_init(full_raw + s, 1);
      wg::mbar_init(empty_raw + s, W_TRANSFORMERS);
      wg::mbar_init(full_v + s, W_TRANSFORMERS);
      wg::mbar_init(empty_v + s, 8);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (group == 2) {
    // ------------------------------------------------------ the producers
    wg::setmaxnreg_dec<88>();
    if (warp_in_group == 0) {
      if (lane == 0) {
        auto load_raw = [&](int ci) {
          const int buf = ci & 1;
          wg::mbar_wait(empty_raw + buf, ((ci >> 1) & 1) ^ 1);
          wg::mbar_expect_tx(full_raw + buf, W_RAW);
          wg::tma_load_4d(raws + buf * W_RAW, &xmap, full_raw + buf,
                          (chunk0 + ci) * W_BK, ox - 1, oy - 1, pb);
        };
        // the raw patch runs two chunks ahead of the U tiles, so that chunk
        // c + 1 is transformed while chunk c is multiplied
        load_raw(0);
        if (n > 1) load_raw(1);
        wg::Ring ring;
        for (int ci = 0; ci < n; ++ci) {
          for (int p = 0; p < W_POS; ++p) {
            wg::mbar_wait(empty_u + ring.stage, ring.phase ^ 1);
            wg::mbar_expect_tx(full_u + ring.stage, W_UTILE);
            wg::tma_load_3d(u_tiles + ring.stage * W_UTILE, &umap,
                            full_u + ring.stage, (chunk0 + ci) * W_BK, col0, p);
            ring.advance(W_USTAGES);
          }
          if (ci + 2 < n) load_raw(ci + 2);
        }
      }
    } else {
      const int pt = tid - 2 * 128 - 32;           // 0..95
      const int quad = pt & 7;                     // this thread's 4 channels
      for (int ci = 0; ci < n; ++ci) {
        const int buf = ci & 1;
        const uint32_t par = (ci >> 1) & 1;
        wg::mbar_wait(full_raw + buf, par);
        wg::mbar_wait(empty_v + buf, par ^ 1);
        const unsigned char* raw = raws + buf * W_RAW;
        unsigned char* vb = v_bufs + buf * W_VBUF;
#pragma unroll 1
        for (int i = pt; i < W_ITEMS; i += W_TRANSFORMERS) {
          const int r = i >> 3;                    // tile (r / 8, r % 8)
          const unsigned char* src =
              raw + ((2 * (r >> 3)) * W_RAW_SIDE + 2 * (r & 7)) * (W_BK * 2) +
              quad * 8;
          // row r of every V[p]: 64 bytes, 16-byte piece c stored at piece
          // c ^ ((r / 2) % 4), the 64-byte swizzle
          unsigned char* dst = vb + r * (W_BK * 2) +
                               (((quad >> 1) ^ ((r >> 1) & 3)) << 4) +
                               ((quad & 1) << 3);
#pragma unroll
          for (int pair = 0; pair < 2; ++pair) {
            uint32_t in[16];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
#pragma unroll
              for (int ss = 0; ss < 4; ++ss)
                in[4 * rr + ss] = *reinterpret_cast<const uint32_t*>(
                    src + (rr * W_RAW_SIDE + ss) * (W_BK * 2) + 4 * pair);
            transform_pair(dst + 4 * pair, in);
          }
        }
        wg::fence_proxy_async();
        wg::mbar_arrive(full_v + buf);
        wg::mbar_arrive(empty_raw + buf);
      }
    }
  } else {
    // ------------------------------------------------------ the consumers
    wg::setmaxnreg_inc<208>();
    float plane[4][32];   // output pixel (a, b) of every tile: 2a + b
    float prod[32];       // the product of one position
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      prod[i] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) plane[q][i] = 0.f;
    }
    wg::Ring ring;
    for (int ci = 0; ci < n; ++ci) {
      const int buf = ci & 1;
      wg::mbar_wait(full_v + buf, (ci >> 1) & 1);
      const uint64_t v_desc = wg::kmajor_desc<64>(v_bufs + buf * W_VBUF);
#pragma unroll
      for (int p = 0; p < W_POS; ++p) {
        wg::mbar_wait(full_u + ring.stage, ring.phase);
        // this warpgroup's 64 rows of the U tile
        const uint64_t u_desc = wg::kmajor_desc<64>(
            u_tiles + ring.stage * W_UTILE + group * 64 * (W_BK * 2));
        const uint64_t a_desc = v_desc + ((p * W_VTILE) >> 4);
        wg::wgmma_fence();
        wg::wgmma_m64n64k16_ss(prod, a_desc, u_desc, false);
        wg::wgmma_m64n64k16_ss(prod, a_desc + 2, u_desc + 2, true);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        if (lane == 0) {
          wg::mbar_arrive(empty_u + ring.stage);
          if (p == W_POS - 1) wg::mbar_arrive(empty_v + buf);
        }
        ring.advance(W_USTAGES);
        // the inverse transform, folded: plane (a, b) += A^T[a][xi] A^T[b][yi] M
        const int xi = p >> 2, yi = p & 3;
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int coef = at_coef(a, xi) * at_coef(b, yi);
            if (coef == 0) continue;
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              if (coef > 0)
                plane[2 * a + b][e] += prod[e];
              else
                plane[2 * a + b][e] -= prod[e];
            }
          }
      }
    }

    // the epilogue, from registers: this thread holds tiles (2 warp, 2 warp +
    // 1) x (lane / 4) of the square, channels 8 j + 2 (lane % 4) + {0, 1} of
    // the warpgroup's 64
    const int tx = lane >> 2;
    const int cq = col0 + 64 * group + 2 * (lane & 3);
    const size_t m = (size_t)gridDim.y / blocks_per_image * h * wd;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gy = oy + 2 * (2 * warp_in_group + half) + (q >> 1);
        const int gx = ox + 2 * tx + (q & 1);
        if (gy >= h || gx >= wd) continue;
        const size_t pix = ((size_t)pb * h + gy) * wd + gx;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = cq + 8 * j;
          if (co >= cout) break;
          const float v0 = plane[q][4 * j + 2 * half];
          const float v1 = plane[q][4 * j + 2 * half + 1];
          if (SPLIT) {
            *reinterpret_cast<float2*>(
                partial + ((size_t)blockIdx.z * m + pix) * cout + co) =
                make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(y + pix * cout + co) =
                wg::finish2(v0, v1, bias != nullptr ? bias + co : nullptr,
                            nullptr);
          }
        }
      }
  }
}

template <bool SPLIT>
int launch_winograd(const void* x, const void* u, const void* bias, int batch,
                    int h, int wd, int cin, int cout, int blocks_x,
                    int blocks_y, int split, int chunks_per_split, void* y,
                    void* partial, void* stream_ptr) {
  auto kernel = winograd_kernel<SPLIT>;
  static bool configured = false;   // per instance of this template
  cudaError_t err = cudaSuccess;
  if (!configured) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap xmap, umap;
  // x (B, H, W, Cin): boxes of 18 x 18 pixels x 32 channels, unswizzled
  const uint64_t xdims[4] = {(uint64_t)cin, (uint64_t)wd, (uint64_t)h,
                             (uint64_t)batch};
  const uint64_t xstrides[3] = {(uint64_t)cin * 2, (uint64_t)wd * cin * 2,
                                (uint64_t)h * wd * cin * 2};
  const uint32_t xbox[4] = {W_BK, W_RAW_SIDE, W_RAW_SIDE, 1};
  // u (16, Cout, Cin): boxes of 128 x 32 of one position, 64-byte swizzle
  const uint64_t udims[3] = {(uint64_t)cin, (uint64_t)cout, W_POS};
  const uint64_t ustrides[2] = {(uint64_t)cin * 2, (uint64_t)cout * cin * 2};
  const uint32_t ubox[3] = {W_BK, W_BN, 1};
  if (!wg::encode_bf16_map(&xmap, x, 4, xdims, xstrides, xbox,
                           CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !wg::encode_bf16_map(&umap, u, 3, udims, ustrides, ubox,
                           CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = blocks_x * blocks_y;
  const dim3 grid((cout + W_BN - 1) / W_BN, batch * blocks, split);
  kernel<<<grid, W_THREADS, W_SMEM, stream>>>(
      xmap, umap, static_cast<const bf16*>(bias), h, wd, cin, cout, blocks_x,
      blocks, chunks_per_split, static_cast<bf16*>(y),
      static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return static_cast<int>(err);
  wg::launch_split_finish(static_cast<const float*>(partial), split,
                          batch * h * wd, h * wd, cout,
                          static_cast<const bf16*>(bias), 0, nullptr,
                          static_cast<bf16*>(y), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) and y (B, H, W, Cout) bf16 in channels-last memory; u
// (16, Cout, Cin) bf16, the transformed filter; bias (Cout) bf16 or null.
// H and W even, Cin % 8 == 0 and Cout % 8 == 0 (checked by the wrapper). The
// plan is the wrapper's (winograd_fused.py:fused_plan): blocks_x * blocks_y
// squares of 16 x 16 pixels an image, the Cin chunks of 32 dealt to `split`
// blocks, chunks_per_split each; with split > 1, partial is an f32 scratch
// of (split, B, H, W, Cout).
int dmoe_winograd3x3(const void* x, const void* u, const void* bias, int batch,
                     int h, int wd, int cin, int cout, int blocks_x,
                     int blocks_y, int split, int chunks_per_split, void* y,
                     void* partial, void* stream) {
  return split > 1
             ? launch_winograd<true>(x, u, bias, batch, h, wd, cin, cout,
                                     blocks_x, blocks_y, split,
                                     chunks_per_split, y, partial, stream)
             : launch_winograd<false>(x, u, bias, batch, h, wd, cin, cout,
                                      blocks_x, blocks_y, split,
                                      chunks_per_split, y, partial, stream);
}

}  // extern "C"
