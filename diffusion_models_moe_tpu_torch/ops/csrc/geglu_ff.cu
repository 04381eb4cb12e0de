// Fused GEGLU-MoE feed-forward for Hopper, in three hand-written launches,
// and the fused MoE routing kernel of the unfused FF path.
//
// Replaces the Pallas TPU kernels diffusion_models_moe_tpu/ops/geglu_ff_fused.py
// :_kernel (pallas_call at :194) and diffusion_models_moe_tpu/ops/
// routing_kernel.py:_routing_kernel (pallas_call at :106). The first keeps
// W1 (C, 2H) and W2 (H, C) resident in VMEM and runs the whole FF per row block. On the H100 W1 alone
// is 26 MB at C = 1280 against 227 KB of shared memory per SM, so the work is
// split where a row's data must be complete:
//
//   1. ff_up_kernel     LayerNorm prologue (f32, fast variance, rsqrt folded
//                       into the scale as flax does) on the A-tile load, then
//                       the dual GEMM h = xn W1[:H]^T, g = xn W1[H:]^T with a
//                       GELU epilogue. Routed: writes ga (model dtype, for the
//                       score) and h*ga (f32). Unrouted: writes bf16(h*ga).
//   2. route_kernel     per 32-row block: expert scores S = ga P^T (f32
//                       accumulation), exact threshold selection s >= kth (an
//                       expert is kept when fewer than k experts score strictly
//                       higher: ties kept), neuron mask m = sel P, and
//                       prod = bf16(h*ga*m); both products on the tensor cores.
//   3. ff_down_kernel   y = prod W2^T + b2, rounded to the model dtype, plus
//                       the residual x added in the model dtype.
//
// The routing kernel (dmoe_route_multiply) is route_kernel of launch 2 on the
// FF path that keeps hidden and gate apart (taps, neuron masks, out-weight
// masks): it reads hidden and the activated gate as bf16 (N, H) and writes
// bf16(hidden*gate) * mask, as the TPU routing kernel rounds it. It is bound
// like launch 2: by the reads of hidden and gate and the write of the
// product, and at E = 256 by streaming P twice per 32-row block.
//
// The rounding points are the JAX kernel's: ga and prod are cast to the model
// dtype before their products, the residual is added in the model dtype.
// GEMMs are bf16 WMMA (mma.sync) tiles with f32 accumulation, single-buffered
// through shared memory: simple first, not yet fast (no TMA, no wgmma). The
// GEMMs are compute-bound at SD widths; the routing pass is bound by the reads
// of ga and h*ga and, at E = 256, by streaming P (2.6 MB, from L2) twice per
// 32-row block.
//
// Inference only: there is no backward.
#include "common.cuh"

namespace {

constexpr int G_BM = 64;            // rows per block
constexpr int G_BN = 64;            // output columns per block
constexpr int G_BK = 32;            // depth per shared-memory tile
constexpr int G_LDS = G_BK + 8;     // bf16 row stride of the A/B tiles
constexpr int G_LDC = G_BN + 4;     // f32 row stride of the epilogue staging
constexpr int G_THREADS = 128;      // 4 warps, each a 32x32 quarter of the tile

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Loads 8 consecutive bf16 of row `gr` (zeros past the last row).
__device__ __forceinline__ uint4 load8(const bf16* base, int gr, int n, size_t ld,
                                       int col) {
  if (gr >= n) return zero_u4();
  return *reinterpret_cast<const uint4*>(base + (size_t)gr * ld + col);
}

template <bool LN, bool ROUTE, bool RELU>
__global__ void __launch_bounds__(G_THREADS) ff_up_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const float* __restrict__ ln_g,
    const float* __restrict__ ln_b, float eps, int n, int c, int hdim,
    bf16* __restrict__ ga_out, float* __restrict__ hg_out,
    bf16* __restrict__ prod_out) {
  constexpr int TILE_BYTES = (G_BM + 2 * G_BN) * G_LDS * 2;
  constexpr int STAGE_BYTES = 2 * G_BM * G_LDC * 4;
  __shared__ __align__(128) unsigned char smem[cmax(TILE_BYTES, STAGE_BYTES)];
  __shared__ float s_mu[G_BM], s_rs[G_BM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bh = As + G_BM * G_LDS;
  bf16* Bg = Bh + G_BN * G_LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * G_BM;
  const int col0 = blockIdx.x * G_BN;  // column inside [0, hdim)

  if (LN) {
    // per-row statistics, one warp per row
    for (int r = warp; r < G_BM; r += G_THREADS / 32) {
      const int gr = row0 + r;
      float s = 0.f, ss = 0.f;
      if (gr < n) {
        const bf16* xr = x + (size_t)gr * c;
        for (int j = lane; j < c; j += 32) {
          const float v = bf2f(xr[j]);
          s += v;
          ss += v * v;
        }
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      if (lane == 0) {
        const float mu = s / (float)c;
        const float var = fmaxf(ss / (float)c - mu * mu, 0.f);
        s_mu[r] = mu;
        s_rs[r] = 1.0f / sqrtf(var + eps);
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_h[2][2], acc_g[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc_h[i][j], 0.f);
      wmma::fill_fragment(acc_g[i][j], 0.f);
    }
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  for (int k0 = 0; k0 < c; k0 += G_BK) {
    for (int i = tid; i < G_BM * (G_BK / 8); i += G_THREADS) {
      const int r = i / (G_BK / 8), ch = (i % (G_BK / 8)) * 8;
      alignas(16) bf16 tmp[8];
      *reinterpret_cast<uint4*>(tmp) = load8(x, row0 + r, n, c, k0 + ch);
      if (LN && row0 + r < n) {
        const float mu = s_mu[r], rs = s_rs[r];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int cc = k0 + ch + q;
          const float mul = rs * ln_g[cc];
          tmp[q] = f2bf((bf2f(tmp[q]) - mu) * mul + ln_b[cc]);
        }
      }
      *reinterpret_cast<uint4*>(As + r * G_LDS + ch) =
          *reinterpret_cast<const uint4*>(tmp);
    }
    for (int i = tid; i < G_BN * (G_BK / 8); i += G_THREADS) {
      const int r = i / (G_BK / 8), ch = (i % (G_BK / 8)) * 8;
      *reinterpret_cast<uint4*>(Bh + r * G_LDS + ch) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(col0 + r) * c + k0 + ch);
      *reinterpret_cast<uint4*>(Bg + r * G_LDS + ch) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(hdim + col0 + r) * c +
                                          k0 + ch);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < G_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bh[2], bg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * G_LDS + kk, G_LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bh[j], Bh + (wn + 16 * j) * G_LDS + kk, G_LDS);
        wmma::load_matrix_sync(bg[j], Bg + (wn + 16 * j) * G_LDS + kk, G_LDS);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc_h[i][j], a[i], bh[j], acc_h[i][j]);
          wmma::mma_sync(acc_g[i][j], a[i], bg[j], acc_g[i][j]);
        }
    }
    __syncthreads();
  }

  // epilogue through shared memory (the tiles are dead now)
  float* Ch = reinterpret_cast<float*>(smem);
  float* Cg = Ch + G_BM * G_LDC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (wm + 16 * i) * G_LDC + wn + 16 * j;
      wmma::store_matrix_sync(Ch + off, acc_h[i][j], G_LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(Cg + off, acc_g[i][j], G_LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = tid; i < G_BM * G_BN; i += G_THREADS) {
    const int r = i / G_BN, cc = i % G_BN, gr = row0 + r;
    if (gr >= n) continue;
    const int j = col0 + cc;
    const float h = Ch[r * G_LDC + cc] + bf2f(b1[j]);
    const float g = Cg[r * G_LDC + cc] + bf2f(b1[hdim + j]);
    const float ga = RELU ? fmaxf(g, 0.f) : gelu_exact(g);
    const size_t o = (size_t)gr * hdim + j;
    if (ROUTE) {
      ga_out[o] = f2bf(ga);
      hg_out[o] = h * ga;
    } else {
      prod_out[o] = f2bf(h * ga);
    }
  }
}

constexpr int R_BM = 32;            // rows per block
constexpr int R_BK = 64;            // hidden columns per pattern tile
constexpr int R_LDT = R_BK + 8;     // bf16 row stride of the ga and P tiles
constexpr int R_LDM = R_BK + 4;     // f32 row stride of the mask tile
constexpr int R_THREADS = 256;      // 8 warps
constexpr int R_MAX_E = 256;

struct RouteLayout {
  int ep, lds, ldsel;
  size_t a, p, s, sel, m, total;
};

__host__ __device__ inline size_t round128(size_t b) {
  return (b + 127) & ~size_t(127);
}

__host__ __device__ inline RouteLayout route_layout(int e) {
  RouteLayout L;
  L.ep = (e + 15) / 16 * 16;  // experts padded to the MMA width
  L.lds = L.ep + 4;
  L.ldsel = L.ep + 8;
  size_t off = 0;
  L.a = off; off += round128((size_t)R_BM * R_LDT * 2);
  L.p = off; off += round128((size_t)L.ep * R_LDT * 2);
  L.s = off; off += round128((size_t)R_BM * L.lds * 4);
  L.sel = off; off += round128((size_t)R_BM * L.ldsel * 2);
  L.m = off; off += round128((size_t)R_BM * R_LDM * 4);
  L.total = off;
  return L;
}

// P[:, h0:h0+R_BK] into shared memory as (ep, R_BK); rows past e are zero.
__device__ __forceinline__ void load_pattern_tile(bf16* Ps, const bf16* pat,
                                                  int e, int ep, int hdim,
                                                  int h0, int tid) {
  for (int i = tid; i < ep * (R_BK / 8); i += R_THREADS) {
    const int r = i / (R_BK / 8), ch = (i % (R_BK / 8)) * 8;
    *reinterpret_cast<uint4*>(Ps + r * R_LDT + ch) = load8(pat, r, e, hdim, h0 + ch);
  }
}

// hidden * gate of one element, in f32. Launch 2 of the fused FF hands in
// hg = h*ga already formed in f32 from the unrounded gate; the routing
// kernel hands in hidden as bf16 and multiplies by the bf16 gate (the
// product of two bf16 values is exact in f32).
__device__ __forceinline__ float hidden_times_gate(const float* hg,
                                                   const bf16*) {
  return *hg;
}
__device__ __forceinline__ float hidden_times_gate(const bf16* hidden,
                                                   const bf16* ga) {
  return bf2f(*hidden) * bf2f(*ga);
}

// Routing as two small GEMMs on the tensor cores: scores S = ga P^T (bf16
// products of 0/1 patterns are exact, sums in f32), the selection per row in
// shared memory, then the neuron mask m = sel P (small integers, exact) with
// the product epilogue prod = bf16(hidden*gate*m). Rows of hg lie ldh
// elements apart (hidden may be the first half of the (N, 2H) projection).
template <typename HT>
__global__ void __launch_bounds__(R_THREADS) route_kernel(
    const bf16* __restrict__ ga, const HT* __restrict__ hg, int ldh,
    const bf16* __restrict__ pat, int n, int hdim, int e, int k,
    bf16* __restrict__ prod) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RouteLayout L = route_layout(e);
  bf16* As = reinterpret_cast<bf16*>(smem + L.a);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  bf16* Sel = reinterpret_cast<bf16*>(smem + L.sel);
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.x * R_BM;
  const int nf = L.ep / 16;  // expert column fragments; warp w owns w, w+8

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int h0 = 0; h0 < hdim; h0 += R_BK) {
    for (int i = tid; i < R_BM * (R_BK / 8); i += R_THREADS) {
      const int r = i / (R_BK / 8), ch = (i % (R_BK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * R_LDT + ch) =
          load8(ga, row0 + r, n, hdim, h0 + ch);
    }
    load_pattern_tile(Ps, pat, e, L.ep, hdim, h0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < R_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + 16 * i * R_LDT + kk, R_LDT);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = warp + 8 * j;
        if (f >= nf) continue;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ps + 16 * f * R_LDT + kk, R_LDT);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = warp + 8 * j;
    if (f >= nf) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(Ss + 16 * i * L.lds + 16 * f, acc[i][j], L.lds,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // exact threshold selection: kept iff fewer than k experts score higher
  for (int pr = tid; pr < R_BM * L.ep; pr += R_THREADS) {
    const int r = pr / L.ep, ei = pr % L.ep;
    float keep = 0.f;
    if (ei < e) {
      const float s = Ss[r * L.lds + ei];
      int beats = 0;
      for (int e2 = 0; e2 < e; ++e2) beats += Ss[r * L.lds + e2] > s;
      keep = beats < k ? 1.f : 0.f;
    }
    Sel[r * L.ldsel + ei] = f2bf(keep);
  }
  __syncthreads();

  // neuron mask m = sel P, 64 hidden columns at a time, and the product
  const int fi = warp >> 2, fj = warp & 3;  // the warp's 16x16 piece of 32x64
  for (int h0 = 0; h0 < hdim; h0 += R_BK) {
    load_pattern_tile(Ps, pat, e, L.ep, hdim, h0, tid);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> macc;
    wmma::fill_fragment(macc, 0.f);
    for (int kk = 0; kk < L.ep; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Sel + 16 * fi * L.ldsel + kk, L.ldsel);
      wmma::load_matrix_sync(b, Ps + kk * R_LDT + 16 * fj, R_LDT);
      wmma::mma_sync(macc, a, b, macc);
    }
    wmma::store_matrix_sync(Ms + 16 * fi * R_LDM + 16 * fj, macc, R_LDM,
                            wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < R_BM * R_BK; i += R_THREADS) {
      const int r = i / R_BK, j = i % R_BK, gr = row0 + r;
      if (gr >= n) continue;
      const size_t o = (size_t)gr * hdim + h0 + j;
      const float hgv = hidden_times_gate(hg + (size_t)gr * ldh + h0 + j, ga + o);
      prod[o] = f2bf(hgv * Ms[r * R_LDM + j]);
    }
    __syncthreads();  // Ps and Ms are rewritten by the next tile
  }
}

template <bool RESID>
__global__ void __launch_bounds__(G_THREADS) ff_down_kernel(
    const bf16* __restrict__ prod, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, const bf16* __restrict__ x, int n, int c,
    int hdim, bf16* __restrict__ y) {
  constexpr int TILE_BYTES = (G_BM + G_BN) * G_LDS * 2;
  constexpr int STAGE_BYTES = G_BM * G_LDC * 4;
  __shared__ __align__(128) unsigned char smem[cmax(TILE_BYTES, STAGE_BYTES)];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + G_BM * G_LDS;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.y * G_BM;
  const int col0 = blockIdx.x * G_BN;  // output column inside [0, c)
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < hdim; k0 += G_BK) {
    for (int i = tid; i < G_BM * (G_BK / 8); i += G_THREADS) {
      const int r = i / (G_BK / 8), ch = (i % (G_BK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * G_LDS + ch) =
          load8(prod, row0 + r, n, hdim, k0 + ch);
      *reinterpret_cast<uint4*>(Bs + r * G_LDS + ch) =
          load8(w2, col0 + r, c, hdim, k0 + ch);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < G_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * G_LDS + kk, G_LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn + 16 * j) * G_LDS + kk, G_LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * G_LDC + wn + 16 * j, acc[i][j],
                              G_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < G_BM * G_BN; i += G_THREADS) {
    const int r = i / G_BN, cc = i % G_BN, gr = row0 + r, gc = col0 + cc;
    if (gr >= n || gc >= c) continue;
    const size_t o = (size_t)gr * c + gc;
    bf16 out = f2bf(Cs[r * G_LDC + cc] + bf2f(b2[gc]));
    if (RESID) out = f2bf(bf2f(x[o]) + bf2f(out));
    y[o] = out;
  }
}

template <bool LN, bool ROUTE>
cudaError_t launch_up(bool relu, dim3 grid, cudaStream_t st, const bf16* x,
                      const bf16* w1, const bf16* b1, const float* g,
                      const float* b, float eps, int n, int c, int hdim,
                      bf16* ga, float* hg, bf16* prod) {
  if (relu)
    ff_up_kernel<LN, ROUTE, true><<<grid, G_THREADS, 0, st>>>(
        x, w1, b1, g, b, eps, n, c, hdim, ga, hg, prod);
  else
    ff_up_kernel<LN, ROUTE, false><<<grid, G_THREADS, 0, st>>>(
        x, w1, b1, g, b, eps, n, c, hdim, ga, hg, prod);
  return cudaGetLastError();
}

template <typename HT>
int launch_route(const bf16* ga, const HT* hg, int ldh, const void* pat, int n,
                 int hdim, int e, int k, void* prod, void* stream) {
  const RouteLayout L = route_layout(e);
  cudaError_t err = cudaFuncSetAttribute(
      route_kernel<HT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + R_BM - 1) / R_BM);
  route_kernel<HT><<<grid, R_THREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
      ga, hg, ldh, static_cast<const bf16*>(pat), n, hdim, e, k,
      static_cast<bf16*>(prod));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dmoe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch 1. x (n, c), w1 (2*hdim, c), b1 (2*hdim) bf16; ln_g/ln_b (c) f32 or
// null. Requires c % 32 == 0 and hdim % 64 == 0 (checked by the wrapper).
// route != 0 writes ga (n, hdim) bf16 and hg (n, hdim) f32; otherwise prod.
int dmoe_ff_up(const void* x, const void* w1, const void* b1, const void* ln_g,
               const void* ln_b, float eps, int n, int c, int hdim, int relu,
               int route, void* ga, void* hg, void* prod, void* stream) {
  const dim3 grid(hdim / G_BN, (n + G_BM - 1) / G_BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const bf16*>(x);
  auto W = static_cast<const bf16*>(w1);
  auto B = static_cast<const bf16*>(b1);
  auto G = static_cast<const float*>(ln_g);
  auto Bb = static_cast<const float*>(ln_b);
  auto GA = static_cast<bf16*>(ga);
  auto HG = static_cast<float*>(hg);
  auto P = static_cast<bf16*>(prod);
  cudaError_t err;
  if (ln_g != nullptr) {
    err = route ? launch_up<true, true>(relu, grid, st, X, W, B, G, Bb, eps, n, c,
                                        hdim, GA, HG, P)
                : launch_up<true, false>(relu, grid, st, X, W, B, G, Bb, eps, n,
                                         c, hdim, GA, HG, P);
  } else {
    err = route ? launch_up<false, true>(relu, grid, st, X, W, B, G, Bb, eps, n,
                                         c, hdim, GA, HG, P)
                : launch_up<false, false>(relu, grid, st, X, W, B, G, Bb, eps, n,
                                          c, hdim, GA, HG, P);
  }
  return static_cast<int>(err);
}

// Launch 2. pat (e, hdim) bf16 0/1 with e <= 256, 1 <= k <= e; hdim % 64 == 0.
int dmoe_ff_route(const void* ga, const void* hg, const void* pat, int n,
                  int hdim, int e, int k, void* prod, void* stream) {
  return launch_route(static_cast<const bf16*>(ga),
                      static_cast<const float*>(hg), hdim, pat, n, hdim, e, k,
                      prod, stream);
}

// The routing kernel: out = bf16(hidden * gate) * topk_mask. hidden (n, hdim)
// bf16 with rows ld_hidden elements apart; gate (n, hdim) bf16, activated,
// contiguous; pat (e, hdim) bf16 0/1 with e <= 256, 1 <= k <= e;
// hdim % 64 == 0.
int dmoe_route_multiply(const void* hidden, int ld_hidden, const void* gate,
                        const void* pat, int n, int hdim, int e, int k,
                        void* out, void* stream) {
  return launch_route(static_cast<const bf16*>(gate),
                      static_cast<const bf16*>(hidden), ld_hidden, pat, n,
                      hdim, e, k, out, stream);
}

// Launch 3. prod (n, hdim), w2 (c, hdim), b2 (c), x (n, c) or null; hdim % 32 == 0.
int dmoe_ff_down(const void* prod, const void* w2, const void* b2,
                 const void* x, int n, int c, int hdim, void* y, void* stream) {
  const dim3 grid((c + G_BN - 1) / G_BN, (n + G_BM - 1) / G_BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto P = static_cast<const bf16*>(prod);
  auto W = static_cast<const bf16*>(w2);
  auto B = static_cast<const bf16*>(b2);
  auto X = static_cast<const bf16*>(x);
  auto Y = static_cast<bf16*>(y);
  if (x != nullptr)
    ff_down_kernel<true><<<grid, G_THREADS, 0, st>>>(P, W, B, X, n, c, hdim, Y);
  else
    ff_down_kernel<false><<<grid, G_THREADS, 0, st>>>(P, W, B, X, n, c, hdim, Y);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
