// GroupNorm of a channels-last bf16 activation, with the resblock's time
// bias before it and SiLU after it, in two passes over x and one write of y.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses the f32 cast, the statistics, the affine, SiLU and the cast back
// into the neighbouring ops. In PyTorch the same sequence is five passes
// over the tensor (the bf16 -> f32 copy, the moments, the apply, f32 SiLU,
// the f32 -> bf16 copy) and cuDNN's NCHW -> NHWC transpose in front of the
// conv that reads the result: some 36 bytes an element where this kernel
// moves 6 (read x, read x again, write y) and the floor is 4.
//
// It is bound by bytes alone (a few f32 operations an element against the
// card's 295 a byte), so the design is about reading along C with 16-byte
// vectors and keeping every SM streaming:
//
//   block    `rows` x C/8 threads; thread (r, v) owns the 8 channels of
//            vector v and walks pixels r, r + rows, ... of its tile, four
//            16-byte loads in flight
//   tile     `pixels` consecutive pixels of one image; an image is `tiles`
//            tiles (the wrapper's plan, from H*W and C alone, so that a
//            sample's result does not depend on the batch it came in)
//
// gn_stats_kernel: each thread keeps Welford moments (count, mean, M2) of
// its 8 channels over its pixels; the block merges them (Chan et al.) per
// group through shared memory into one (mean, M2) for each (image, group,
// tile) in the scratch. gn_apply_kernel: each block issues its first loads
// of x, copies its image's tile partials (tiles x groups, at most 4096, from
// L2) into shared memory with every thread at once and merges them per
// group while those loads are in flight, folds mean, rstd and the affine
// into a per-channel scale and shift, and streams its tile: y = silu(x *
// scale + shift), rounded to bf16 once. The apply pass walks the tiles in
// reverse order, so that its first reads find what the statistics pass read
// last still in L2. Moments are merged, never taken as E[x^2] - E[x]^2:
// after a SiLU the mean is large against the spread. Every sum is taken in a
// fixed order: the result is the same on a repeat and whatever else shares
// the batch. Two blocks an SM (64 registers a thread): at fewer the fixed
// costs of a block (its first loads, the merges) are not hidden.
//
// Inference only: there is no backward (the model takes the plain version
// where autograd records the call).
#include "common.cuh"

namespace {

constexpr int GN_VEC = 8;          // bf16 channels a 16-byte vector
constexpr int GN_THREADS = 512;    // most threads a block (rows x C/8)
constexpr int GN_UNROLL = 4;       // 16-byte loads in flight a thread
constexpr int GN_MAX_GROUPS = 512;
constexpr int GN_MAX_PARTS = 4096; // tiles x groups an image

// Chan's merge of (nb, mb, m2b) into (n, m, m2); nb == 0 leaves it as it is.
__device__ __forceinline__ void chan_merge(float& n, float& m, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - m;
  const float wb = __fdividef(nb, nn);
  m += d * wb;
  m2 += m2b + d * d * n * wb;
  n = nn;
}

// Merges the moments of the 32 lanes; lane 0 ends with all of them.
__device__ __forceinline__ void warp_merge(float& n, float& m, float& m2) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, o);
    const float mb = __shfl_down_sync(0xffffffffu, m, o);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, o);
    chan_merge(n, m, m2, nb, mb, m2b);
  }
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[GN_VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < GN_VEC / 2; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[GN_VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < GN_VEC / 2; ++j)
    h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return u;
}

// x + bias in f32, rounded to bf16 (the rounding of a bf16 add), as f32
__device__ __forceinline__ void add_bias(float (&f)[GN_VEC],
                                         const float (&b)[GN_VEC]) {
#pragma unroll
  for (int j = 0; j < GN_VEC; ++j) f[j] = bf2f(f2bf(f[j] + b[j]));
}

struct Geometry {
  int hw, c, groups, rows, pixels, tiles;
};

// The tile's pixel range [p0, p1) within its image.
__device__ __forceinline__ void tile_range(const Geometry& g, int tile,
                                           int& p0, int& p1) {
  p0 = tile * g.pixels;
  p1 = min(p0 + g.pixels, g.hw);
}

// Thread (r, v)'s loads of pixels p, p + rows, ... (GN_UNROLL of them, zeros
// past p1).
__device__ __forceinline__ void load_batch(uint4 (&u)[GN_UNROLL],
                                           const bf16* __restrict__ x,
                                           size_t base, int c, int p, int p1,
                                           int rows, int v) {
#pragma unroll
  for (int k = 0; k < GN_UNROLL; ++k) {
    const int q = p + k * rows;
    u[k] = q < p1 ? __ldg(reinterpret_cast<const uint4*>(
                        x + base + (size_t)q * c) + v)
                  : zero_u4();
  }
}

// Thread (r, v)'s loop over its pixels of [p0, p1): f(pixel, 8 values). The
// caller has loaded the first batch into u.
template <typename F>
__device__ __forceinline__ void walk(uint4 (&u)[GN_UNROLL],
                                     const bf16* __restrict__ x, size_t base,
                                     int c, int p0, int p1, int r, int rows,
                                     int v, F f) {
  for (int p = p0 + r; p < p1; p += GN_UNROLL * rows) {
    if (p != p0 + r) load_batch(u, x, base, c, p, p1, rows, v);
#pragma unroll
    for (int k = 0; k < GN_UNROLL; ++k) {
      const int q = p + k * rows;
      if (q < p1) {
        float f_[GN_VEC];
        unpack(u[k], f_);
        f(q, f_);
      }
    }
  }
}

__device__ __forceinline__ void load_bias(const bf16* __restrict__ bias,
                                          int img, int c, int v,
                                          float (&b)[GN_VEC]) {
  if (bias == nullptr) return;
  unpack(__ldg(reinterpret_cast<const uint4*>(bias + (size_t)img * c) + v), b);
}

__global__ void __launch_bounds__(GN_THREADS, 2)
gn_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bias,
                float* __restrict__ part_mean, float* __restrict__ part_m2,
                Geometry g) {
  __shared__ float s_mean[GN_THREADS * GN_VEC];
  __shared__ float s_m2[GN_THREADS * GN_VEC];
  __shared__ float s_n[GN_THREADS];
  const int img = blockIdx.x / g.tiles, tile = blockIdx.x % g.tiles;
  const int vecs = g.c / GN_VEC;
  const int v = threadIdx.x % vecs, r = threadIdx.x / vecs;
  int p0, p1;
  tile_range(g, tile, p0, p1);
  const size_t base = (size_t)img * g.hw * g.c;
  uint4 u[GN_UNROLL];
  load_batch(u, x, base, g.c, p0 + r, p1, g.rows, v);
  float b[GN_VEC] = {};
  load_bias(bias, img, g.c, v, b);
  float n = 0.f, mean[GN_VEC] = {}, m2[GN_VEC] = {};
  walk(u, x, base, g.c, p0, p1, r, g.rows, v,
       [&](int, float (&f)[GN_VEC]) {
         if (bias != nullptr) add_bias(f, b);
         n += 1.f;
         const float inv = __frcp_rn(n);
#pragma unroll
         for (int j = 0; j < GN_VEC; ++j) {
           const float d = f[j] - mean[j];
           mean[j] += d * inv;
           m2[j] += d * (f[j] - mean[j]);
         }
       });
#pragma unroll
  for (int j = 0; j < GN_VEC; ++j) {
    s_mean[r * g.c + v * GN_VEC + j] = mean[j];
    s_m2[r * g.c + v * GN_VEC + j] = m2[j];
  }
  if (v == 0) s_n[r] = n;
  __syncthreads();
  // a full warp a group: lanes over the group's (row, channel) moments
  const int cpg = g.c / g.groups, items = g.rows * cpg;
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int grp = threadIdx.x / 32; grp < g.groups && threadIdx.x < warps * 32;
       grp += warps) {
    float gn = 0.f, gm = 0.f, gm2 = 0.f;
    for (int i = lane; i < items; i += 32) {
      const int row = i / cpg, ch = grp * cpg + i % cpg;
      chan_merge(gn, gm, gm2, s_n[row], s_mean[row * g.c + ch],
                 s_m2[row * g.c + ch]);
    }
    warp_merge(gn, gm, gm2);
    if (lane == 0) {
      const size_t at = ((size_t)img * g.groups + grp) * g.tiles + tile;
      part_mean[at] = gm;
      part_m2[at] = gm2;
    }
  }
}

template <bool SILU>
__global__ void __launch_bounds__(GN_THREADS, 2)
gn_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bias,
                const float* __restrict__ gamma,
                const float* __restrict__ beta,
                const float* __restrict__ part_mean,
                const float* __restrict__ part_m2, bf16* __restrict__ y,
                Geometry g, float eps) {
  __shared__ float s_pmean[GN_MAX_PARTS];
  __shared__ float s_pm2[GN_MAX_PARTS];
  __shared__ float s_mean[GN_MAX_GROUPS];
  __shared__ float s_rstd[GN_MAX_GROUPS];
  const int block = gridDim.x - 1 - blockIdx.x;   // reverse of the stats pass
  const int img = block / g.tiles, tile = block % g.tiles;
  const int vecs = g.c / GN_VEC;
  const int v = threadIdx.x % vecs, r = threadIdx.x / vecs;
  int p0, p1;
  tile_range(g, tile, p0, p1);
  const size_t base = (size_t)img * g.hw * g.c;
  // the first loads of x do not wait for the statistics
  uint4 u[GN_UNROLL];
  load_batch(u, x, base, g.c, p0 + r, p1, g.rows, v);
  const int parts = g.groups * g.tiles;
  const size_t at = (size_t)img * parts;
  for (int i = threadIdx.x; i < parts; i += blockDim.x) {
    s_pmean[i] = part_mean[at + i];
    s_pm2[i] = part_m2[at + i];
  }
  __syncthreads();
  const int cpg = g.c / g.groups;
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int grp = threadIdx.x / 32; grp < g.groups && threadIdx.x < warps * 32;
       grp += warps) {
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int t = lane; t < g.tiles; t += 32) {
      const int q0 = t * g.pixels;
      const float nt = (float)(min(q0 + g.pixels, g.hw) - q0) * cpg;
      chan_merge(n, m, m2, nt, s_pmean[grp * g.tiles + t],
                 s_pm2[grp * g.tiles + t]);
    }
    warp_merge(n, m, m2);
    if (lane == 0) {
      s_mean[grp] = m;
      s_rstd[grp] = rsqrtf(m2 / n + eps);
    }
  }
  __syncthreads();
  float scale[GN_VEC], shift[GN_VEC], b[GN_VEC] = {};
#pragma unroll
  for (int j = 0; j < GN_VEC; ++j) {
    const int ch = v * GN_VEC + j, grp = ch / cpg;
    scale[j] = s_rstd[grp] * gamma[ch];
    shift[j] = beta[ch] - s_mean[grp] * scale[j];
  }
  load_bias(bias, img, g.c, v, b);
  walk(u, x, base, g.c, p0, p1, r, g.rows, v, [&](int q, float (&f)[GN_VEC]) {
    if (bias != nullptr) add_bias(f, b);
#pragma unroll
    for (int j = 0; j < GN_VEC; ++j) {
      const float t = fmaf(f[j], scale[j], shift[j]);
      f[j] = SILU ? t * __frcp_rn(1.f + __expf(-t)) : t;
    }
    reinterpret_cast<uint4*>(y + base + (size_t)q * g.c)[v] = pack(f);
  });
}

}  // namespace

extern "C" {

// x and y (B, H, W, C) bf16 in channels-last memory, 16-byte aligned; bias
// (B, C) bf16 or null, added to x (rounded to bf16) before the statistics;
// gamma, beta (C) f32. C % 8 == 0, C % groups == 0, groups <= 512,
// rows * C / 8 <= 512, groups * tiles <= 4096 (checked by the wrapper). The plan is the wrapper's
// (group_norm_nhwc.py:gn_plan): `tiles` tiles of `pixels` pixels an image,
// `rows` pixels a block at a time. part_mean and part_m2 are f32 scratch of
// (B, groups, tiles) each.
int dmoe_group_norm_nhwc(const void* x, const void* bias, const void* gamma,
                         const void* beta, int batch, int hw, int c,
                         int groups, int rows, int pixels, int tiles,
                         float eps, int silu, void* part_mean, void* part_m2,
                         void* y, void* stream) {
  const Geometry g{hw, c, groups, rows, pixels, tiles};
  const dim3 grid(batch * tiles), block(rows * (c / GN_VEC));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bias);
  float* pm = static_cast<float*>(part_mean);
  float* pv = static_cast<float*>(part_m2);
  gn_stats_kernel<<<grid, block, 0, s>>>(xb, bb, pm, pv, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  bf16* yb = static_cast<bf16*>(y);
  if (silu)
    gn_apply_kernel<true><<<grid, block, 0, s>>>(xb, bb, ga, be, pm, pv, yb,
                                                 g, eps);
  else
    gn_apply_kernel<false><<<grid, block, 0, s>>>(xb, bb, ga, be, pm, pv, yb,
                                                  g, eps);
  return cudaGetLastError();
}

}  // extern "C"
