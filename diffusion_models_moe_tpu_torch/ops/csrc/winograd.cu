// The fused Winograd F(2x2, 3x3) convolution for Hopper: stride-1 SAME 3x3
// conv as input transform, 16 tensor-core products and inverse transform in
// one kernel, x read and y written once.
//
// Replaces the Pallas TPU kernel diffusion_models_moe_tpu/ops/
// winograd_fused.py:_kernel (pallas_call at :203). That kernel gets its input
// de-interleaved into even and odd columns and stacked into overlapping row
// bands outside the kernel, keeps a whole (16, Cin, Cout-block) filter in
// VMEM and writes four output planes that are transposed afterwards; all of
// that is layout work for Mosaic. Here:
//
//   rows     the B * H/2 * W/2 output tiles of 2x2 pixels, 64 or 32 a block.
//            A tile's 4x4 input patch (1-pixel halo, zero outside the image)
//            is read from x itself in channels-last memory, so the Cin
//            values of a pixel are contiguous
//   columns  Cout, 128 a block, from the hoisted filter u (16, Cout, Cin)
//   depth    Cin in steps of 32. For each step the block transforms its
//            patches once, V = B^T d B in f32 rounded to bf16, into 16
//            shared-memory tiles V[p] (rows x 32); then for each of the 16
//            positions p it multiplies V[p] U[p]^T on the shared mma.sync
//            tile. The U[p] tiles (128 x 32) stream through a ring of 4
//            shared-memory stages by cp.async, asked for 3 products ahead: a
//            product is 16 MMAs a warp, far less than a trip to memory (a
//            one-deep register prefetch on 64-row tiles left that latency
//            exposed: at 16x16 1280->1280, UNet batch 4, 0.69 ms against
//            0.39 ms now, the smaller row tile included).
//
// Accumulators. Sixteen (rows x 128) f32 accumulators do not fit in
// registers. The inverse transform A^T M A is linear, so it commutes with the
// sum over Cin: each product of one depth step goes into a product tile and
// is added, with its sign, into the 4 output planes it belongs to (the
// entries of A^T are 0 and +-1: 36 signed adds of a product tile for the 16
// products, against 36 MMAs if every nonzero were a product of its own).
// With 64 rows the planes take 128 registers a thread and one block runs on
// an SM; with 32 rows two do. On an H100, 32 rows were faster where 64-row
// tiles would leave a quarter of the SMs idle (the 16x16 and 32x32 levels at
// batch 4) and slower elsewhere: the launcher chooses by the block count.
// Adding a product tile only every 64 channels (two depth tiles a position)
// was tried and was slower.
//
// Compute-bound at every SD1.5 shape but the smallest (2*16*Cin*Cout
// operations a tile against 2*4*(Cin + Cout) bytes and the filter once). The
// epilogue rounds each plane to bf16, adds the bias in bf16 and writes the
// plane's pixel of every tile in place. No TMA or wgmma yet. Inference only:
// there is no backward.
#include "gemm_tile.cuh"

namespace {

constexpr int W_POS = 16;                  // Winograd positions 4 xi + yi
constexpr int U_ELEMS = T_BN * T_LDS;      // one U tile
constexpr int V_WORDS = T_BK / 2;          // channel pairs of a V tile row
constexpr int U_STAGES = 4;                // U tiles in flight; divides W_POS
static_assert(W_POS % U_STAGES == 0, "the ring stage is a constant per position");

// W_BM output tiles (rows) a block: 16 V tiles and the ring of U tiles, or
// the epilogue's staging
template <int W_BM>
constexpr size_t wino_smem() {
  constexpr size_t tiles =
      (size_t)(W_POS * W_BM * T_LDS + U_STAGES * U_ELEMS) * sizeof(bf16);
  return tiles > Tile<W_BM>::STAGE_BYTES ? tiles : Tile<W_BM>::STAGE_BYTES;
}

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

template <int W_BM, bool BIAS>
__global__ void __launch_bounds__(T_THREADS, W_BM == 32 ? 2 : 1) winograd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ u,
    const bf16* __restrict__ bias, int batch, int h, int wd, int cin, int cout,
    bf16* __restrict__ y) {
  using T = Tile<W_BM>;
  constexpr int V_ELEMS = W_BM * T_LDS;   // one position's V tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Vs = reinterpret_cast<bf16*>(smem);   // [16][W_BM][T_LDS]
  bf16* Us = Vs + W_POS * V_ELEMS;            // [U_STAGES][T_BN][T_LDS]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int th = h >> 1, tw = wd >> 1;
  const int m = batch * th * tw;
  const int row0 = blockIdx.y * W_BM;
  const int col0 = blockIdx.x * T_BN;

  // V of depth step k0 into Vs: each thread takes (tile row, channel pair)
  // items; a tile's 16 input pixels, the two transforms in f32 (rows of the
  // patch first, then columns, as the TPU kernel orders them), 16 stores
  auto stage_v = [&](int k0) {
#pragma unroll 1
    for (int i = tid; i < W_BM * V_WORDS; i += T_THREADS) {
      const int r = i / V_WORDS, word = i % V_WORDS;
      const int gr = row0 + r, c = k0 + 2 * word;
      uint32_t raw[4][4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int ss = 0; ss < 4; ++ss) raw[rr][ss] = 0u;
      if (gr < m && c < cin) {
        const int pb = gr / (th * tw);
        const int rem = gr - pb * th * tw;
        const int ty = rem / tw, tx = rem - ty * tw;
        const int yy0 = 2 * ty - 1, xx0 = 2 * tx - 1;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int yy = yy0 + rr;
          if (yy < 0 || yy >= h) continue;
#pragma unroll
          for (int ss = 0; ss < 4; ++ss) {
            const int xx = xx0 + ss;
            if (xx < 0 || xx >= wd) continue;
            raw[rr][ss] = *reinterpret_cast<const uint32_t*>(
                x + ((size_t)(pb * h + yy) * wd + xx) * cin + c);
          }
        }
      }
      uint32_t packed[4][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float t[4][4], o[4];
        // rows of the patch: t[xi][s] = sum_r B^T[xi][r] d[r][s]
#pragma unroll
        for (int ss = 0; ss < 4; ++ss) {
          float d[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            d[rr] = __uint_as_float(half == 0 ? raw[rr][ss] << 16
                                              : raw[rr][ss] & 0xffff0000u);
          bt_combo(o, d[0], d[1], d[2], d[3]);
#pragma unroll
          for (int xi = 0; xi < 4; ++xi) t[xi][ss] = o[xi];
        }
        // columns: v[xi][yi] = sum_s B^T[yi][s] t[xi][s], rounded to bf16
#pragma unroll
        for (int xi = 0; xi < 4; ++xi) {
          bt_combo(o, t[xi][0], t[xi][1], t[xi][2], t[xi][3]);
#pragma unroll
          for (int yi = 0; yi < 4; ++yi) {
            const uint32_t bits = __bfloat16_as_ushort(f2bf(o[yi]));
            packed[xi][yi] = half == 0 ? bits : (packed[xi][yi] | (bits << 16));
          }
        }
      }
#pragma unroll
      for (int p = 0; p < W_POS; ++p)
        *reinterpret_cast<uint32_t*>(Vs + p * V_ELEMS + r * T_LDS + 2 * word) =
            packed[p >> 2][p & 3];
    }
  };

  // the U[p] tile of depth step k0 into ring stage `stage`, asynchronously:
  // rows col0.. of u[p] (cout, cin), zeros past cout and cin
  auto load_u = [&](int p, int k0, int stage) {
    const int col = k0 + chunk_col(tid);
#pragma unroll
    for (int it = 0; it < T_B_PER; ++it) {
      const int row = chunk_row(tid, it);
      const bool ok = col0 + row < cout && col < cin;
      cp_async16(Us + stage * U_ELEMS + row * T_LDS + chunk_col(tid),
                 ok ? u + ((size_t)p * cout + col0 + row) * cin + col : u, ok);
    }
  };

  T tile;
  float plane[4][2][T::NI][4];   // output pixel (a, b) of every tile: 2a + b
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) plane[q][mi][ni][e] = 0.f;

  // Products g = 16 ks + p (depth step ks, position p). The U tile of
  // product g lives in ring stage p % U_STAGES and is asked for U_STAGES - 1
  // products ahead, one copy group a product, so that the copies' latency
  // overlaps the products between.
  const int ksteps = (cin + T_BK - 1) / T_BK;
#pragma unroll
  for (int p = 0; p < U_STAGES - 1; ++p) {
    load_u(p, 0, p);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * T_BK;
#pragma unroll
    for (int p = 0; p < W_POS; ++p) {
      // this product's U tile has landed, for every thread, and every warp
      // is past the product before: its ring stage, and at p = 0 the V
      // tiles, are free
      cp_async_wait<U_STAGES - 2>();
      __syncthreads();
      constexpr int ahead = U_STAGES - 1;
      if (p + ahead < W_POS)
        load_u(p + ahead, k0, (p + ahead) % U_STAGES);
      else if (ks + 1 < ksteps)
        load_u(p + ahead - W_POS, k0 + T_BK, (p + ahead) % U_STAGES);
      cp_async_commit();
      if (p == 0) {
        stage_v(k0);
        __syncthreads();
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) tile.acc[mi][ni][e] = 0.f;
      tile.mma(Vs + p * V_ELEMS, Us + (p % U_STAGES) * U_ELEMS, warp);
      // the inverse transform, folded: plane (a, b) += A^T[a][xi] A^T[b][yi] M
      const int xi = p >> 2, yi = p & 3;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int coef = at_coef(a, xi) * at_coef(b, yi);
          if (coef == 0) continue;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (coef > 0)
                  plane[2 * a + b][mi][ni][e] += tile.acc[mi][ni][e];
                else
                  plane[2 * a + b][mi][ni][e] -= tile.acc[mi][ni][e];
              }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is past its last product: the tiles are dead

  float* Cs = reinterpret_cast<float*>(smem);   // the tiles are dead now
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) tile.acc[mi][ni][e] = plane[q][mi][ni][e];
    tile.stage(Cs, warp);
    __syncthreads();
    const int a = q >> 1, b = q & 1;
    for (int i = tid; i < W_BM * (T_BN / 8); i += T_THREADS) {
      const int r = i / (T_BN / 8), cc = (i % (T_BN / 8)) * 8;
      const int gr = row0 + r, co = col0 + cc;
      if (gr >= m || co >= cout) continue;
      const int pb = gr / (th * tw);
      const int rem = gr - pb * th * tw;
      const int ty = rem / tw, tx = rem - ty * tw;
      const size_t off =
          ((size_t)(pb * h + 2 * ty + a) * wd + 2 * tx + b) * cout + co;
      alignas(16) bf16 add[8], out[8];
      if (BIAS)
        *reinterpret_cast<uint4*>(add) =
            *reinterpret_cast<const uint4*>(bias + co);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bf16 v = f2bf(Cs[r * T_LDC + cc + e]);
        if (BIAS) v = f2bf(bf2f(v) + bf2f(add[e]));
        out[e] = v;
      }
      *reinterpret_cast<uint4*>(y + off) = *reinterpret_cast<const uint4*>(out);
    }
    __syncthreads();
  }
}

template <int W_BM, bool BIAS>
int launch_winograd(const void* x, const void* u, const void* bias, int batch,
                    int h, int wd, int cin, int cout, void* y, void* stream) {
  constexpr size_t smem = wino_smem<W_BM>();
  cudaError_t err = cudaFuncSetAttribute(
      winograd_kernel<W_BM, BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = batch * (h / 2) * (wd / 2);
  const dim3 grid((cout + T_BN - 1) / T_BN, (m + W_BM - 1) / W_BM);
  winograd_kernel<W_BM, BIAS><<<grid, T_THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(u),
      static_cast<const bf16*>(bias), batch, h, wd, cin, cout,
      static_cast<bf16*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) and y (B, H, W, Cout) bf16 in channels-last memory; u
// (16, Cout, Cin) bf16, the transformed filter; bias (Cout) bf16 or null.
// H and W even, Cin % 8 == 0 and Cout % 8 == 0 (checked by the wrapper).
int dmoe_winograd3x3(const void* x, const void* u, const void* bias, int batch,
                     int h, int wd, int cin, int cout, void* y, void* stream) {
  // 32-row tiles where 64-row tiles would leave a quarter of the SMs idle
  const long long blocks64 = (long long)((batch * (h / 2) * (wd / 2) + 63) / 64) *
                             ((cout + T_BN - 1) / T_BN);
  const bool small = 4 * blocks64 <= 3 * (long long)sm_count();
  if (small)
    return bias != nullptr
               ? launch_winograd<32, true>(x, u, bias, batch, h, wd, cin, cout,
                                           y, stream)
               : launch_winograd<32, false>(x, u, bias, batch, h, wd, cin,
                                            cout, y, stream);
  return bias != nullptr
             ? launch_winograd<64, true>(x, u, bias, batch, h, wd, cin, cout,
                                         y, stream)
             : launch_winograd<64, false>(x, u, bias, batch, h, wd, cin, cout,
                                          y, stream);
}

}  // extern "C"
