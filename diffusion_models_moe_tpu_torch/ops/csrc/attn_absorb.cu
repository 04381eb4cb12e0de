// The absorbed self-attention sub-block's projection kernels for Hopper:
// LayerNorm + q/k/v projection before the flash kernel, and output
// projection + bias + residual after it.
//
// Replaces the Pallas TPU kernels diffusion_models_moe_tpu/ops/
// attn_absorb_fused.py:_qkv_kernel (pallas_call at :142) and :_out_kernel
// (pallas_call at :241). Those exist to hand the TPU flash call its
// (B, H, S, 128-lane) operands without a transpose or a pad pass. The flash
// kernel of this package (sd_attention.cu) reads (B, S, H, D) through
// strides at the native head dim, so neither the transpose nor the pad is
// carried over; what is carried over is the fusion:
//
//   ln_qkv_kernel    x (N, C) is read once per output tile, normalised on the
//                    A-tile load (f32, fast variance, rsqrt folded into the
//                    scale as flax does, rounded to bf16), multiplied against
//                    [Wq | Wk | Wv] (three (C, C) nn.Linear weights, taken by
//                    pointer: nothing is concatenated) with f32 accumulation,
//                    and written as one (N, 3C) bf16 tensor. q, k and v are
//                    its column thirds: viewed as (B, S, H, D) they have the
//                    strides (S*3C, 3C, D, 1) that the flash kernel takes as
//                    they are.
//   attn_out_kernel  gathers the flash output o (B, S, H, D) by its strides
//                    into rows of H*D on the A-tile load, multiplies by Wo
//                    (C, C), adds the bias in f32, rounds to bf16, adds the
//                    residual in bf16, and writes (N, C) once.
//
// Both are GEMMs of 2*N*C*3C and 2*N*C*C operations over N*C-sized
// activations: compute-bound at every SD1.5 shape (C >= 320). They run the
// shared BM x 128 mma.sync tile of gemm_tile.cuh with its two-buffer
// pipelined depth loop (register prefetch; no TMA or wgmma yet). Each block recomputes
// the LayerNorm statistics of its rows (C reads a row from L2), which keeps
// the kernel one launch. Inference only: there is no backward.
#include "gemm_tile.cuh"

namespace {

// (two BM = 128 blocks a SM need at most 128 registers a thread)
template <int BM, bool LN>
__global__ void __launch_bounds__(T_THREADS, BM == 128 ? 2 : 1) ln_qkv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wq,
    const bf16* __restrict__ wk, const bf16* __restrict__ wv,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b, float eps,
    int n, int c, bf16* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_mu[BM], s_rs[BM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * T_BN;   // column inside [0, 3c)
  const int nout = 3 * c;

  if (LN) {
    // per-row statistics, one warp per row, 8 values a lane per step
    for (int r = warp; r < BM; r += T_THREADS / 32) {
      const int gr = row0 + r;
      float s = 0.f, ss = 0.f;
      if (gr < n) {
        const bf16* xr = x + (size_t)gr * c;
        for (int j = lane * 8; j < c; j += 32 * 8) {
          alignas(16) bf16 tmp[8];
          *reinterpret_cast<uint4*>(tmp) =
              *reinterpret_cast<const uint4*>(xr + j);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float v = bf2f(tmp[q]);
            s += v;
            ss += v * v;
          }
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

  // output column j of [Wq | Wk | Wv] is row j % c of weight j / c: this
  // thread's B rows never change over the depth loop
  const bf16* wrow[T_B_PER];
#pragma unroll
  for (int it = 0; it < T_B_PER; ++it) {
    const int j = col0 + chunk_row(tid, it);
    const int t = j / c;
    wrow[it] = j < nout ? (t == 0 ? wq : (t == 1 ? wk : wv)) +
                              (size_t)(j - t * c) * c
                        : nullptr;
  }
  const int ch = chunk_col(tid);
  uint4 ra[Tile<BM>::A_PER], rb[T_B_PER];
  int kc = 0;   // depth column of the chunks in ra and rb

  auto fetch = [&](int step) {
    kc = step * T_BK + ch;
#pragma unroll
    for (int it = 0; it < Tile<BM>::A_PER; ++it)
      ra[it] = load8_guard(x, row0 + chunk_row(tid, it), n, c, kc, c);
#pragma unroll
    for (int it = 0; it < T_B_PER; ++it)
      rb[it] = wrow[it] != nullptr && kc < c
                   ? *reinterpret_cast<const uint4*>(wrow[it] + kc)
                   : zero_u4();
  };
  auto commit = [&](bf16* As, bf16* Bs) {
#pragma unroll
    for (int it = 0; it < Tile<BM>::A_PER; ++it) {
      const int r = chunk_row(tid, it);
      if (LN && row0 + r < n && kc < c) {
        alignas(16) bf16 tmp[8];
        *reinterpret_cast<uint4*>(tmp) = ra[it];
        const float mu = s_mu[r], rs = s_rs[r];
        alignas(16) float g8[8], b8[8];
        load8_f32(g8, ln_g + kc);
        load8_f32(b8, ln_b + kc);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          tmp[q] = f2bf((bf2f(tmp[q]) - mu) * (rs * g8[q]) + b8[q]);
        ra[it] = *reinterpret_cast<const uint4*>(tmp);
      }
      *reinterpret_cast<uint4*>(As + r * T_LDS + ch) = ra[it];
    }
    commit_weight_tile(rb, Bs, tid);
  };

  Tile<BM> tile;
  tile.run(smem, (c + T_BK - 1) / T_BK, warp, fetch, commit);

  float* Cs = reinterpret_cast<float*>(smem);   // the tiles are dead now
  tile.stage(Cs, warp);
  __syncthreads();
  for (int i = tid; i < BM * (T_BN / 8); i += T_THREADS) {
    const int r = i / (T_BN / 8), cc = (i % (T_BN / 8)) * 8;
    const int gr = row0 + r, j = col0 + cc;
    if (gr >= n || j >= nout) continue;
    alignas(16) bf16 out[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) out[q] = f2bf(Cs[r * T_LDC + cc + q]);
    *reinterpret_cast<uint4*>(y + (size_t)gr * nout + j) =
        *reinterpret_cast<const uint4*>(out);
  }
}

struct OStrides {
  long long b, s, h;
};

template <int BM>
__global__ void __launch_bounds__(T_THREADS) attn_out_kernel(
    const bf16* __restrict__ o, OStrides os, const bf16* __restrict__ wo,
    const bf16* __restrict__ bo, const bf16* __restrict__ resid, int n, int s,
    int c, int d, bf16* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * T_BN;

  // row (b, s) of the A operand: head h's D values sit at o[b, s, h, :];
  // this thread's rows never change over the depth loop
  const bf16* orow[Tile<BM>::A_PER];
#pragma unroll
  for (int it = 0; it < Tile<BM>::A_PER; ++it) {
    const int gr = row0 + chunk_row(tid, it);
    const int bi = gr / s, si = gr - bi * s;
    orow[it] = gr < n ? o + bi * os.b + si * os.s : nullptr;
  }
  const int ch = chunk_col(tid);
  uint4 ra[Tile<BM>::A_PER], rb[T_B_PER];

  auto fetch = [&](int step) {
    const int kc = step * T_BK + ch;
    const int h = kc / d, dd = kc - h * d;
#pragma unroll
    for (int it = 0; it < Tile<BM>::A_PER; ++it)
      ra[it] = orow[it] != nullptr && kc < c
                   ? *reinterpret_cast<const uint4*>(orow[it] + h * os.h + dd)
                   : zero_u4();
    fetch_weight_tile(rb, wo, col0, c, c, c, step * T_BK, tid);
  };
  auto commit = [&](bf16* As, bf16* Bs) {
#pragma unroll
    for (int it = 0; it < Tile<BM>::A_PER; ++it)
      *reinterpret_cast<uint4*>(As + chunk_row(tid, it) * T_LDS + ch) = ra[it];
    commit_weight_tile(rb, Bs, tid);
  };

  Tile<BM> tile;
  tile.run(smem, (c + T_BK - 1) / T_BK, warp, fetch, commit);

  float* Cs = reinterpret_cast<float*>(smem);
  tile.stage(Cs, warp);
  __syncthreads();
  for (int i = tid; i < BM * (T_BN / 8); i += T_THREADS) {
    const int r = i / (T_BN / 8), cc = (i % (T_BN / 8)) * 8;
    const int gr = row0 + r, j = col0 + cc;
    if (gr >= n || j >= c) continue;
    const size_t off = (size_t)gr * c + j;
    alignas(16) bf16 res[8], bias[8], out[8];
    *reinterpret_cast<uint4*>(res) = *reinterpret_cast<const uint4*>(resid + off);
    *reinterpret_cast<uint4*>(bias) = *reinterpret_cast<const uint4*>(bo + j);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bf16 proj = f2bf(Cs[r * T_LDC + cc + q] + bf2f(bias[q]));
      out[q] = f2bf(bf2f(res[q]) + bf2f(proj));
    }
    *reinterpret_cast<uint4*>(y + off) = *reinterpret_cast<const uint4*>(out);
  }
}

template <int BM, bool LN>
int launch_qkv(const void* x, const void* wq, const void* wk, const void* wv,
               const void* ln_g, const void* ln_b, float eps, int n, int c,
               void* y, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_kernel<BM, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<BM>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((3 * c + T_BN - 1) / T_BN, (n + BM - 1) / BM);
  ln_qkv_kernel<BM, LN><<<grid, T_THREADS, Tile<BM>::SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), eps, n,
      c, static_cast<bf16*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_out(const void* o, const long long* st, const void* wo,
               const void* bo, const void* resid, int n, int s, int c, int d,
               void* y, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_out_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<BM>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c + T_BN - 1) / T_BN, (n + BM - 1) / BM);
  attn_out_kernel<BM><<<grid, T_THREADS, Tile<BM>::SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), OStrides{st[0], st[1], st[2]},
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const bf16*>(resid), n, s, c, d, static_cast<bf16*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (n, c) bf16; wq, wk, wv (c, c) bf16 in the nn.Linear layout (out, in);
// ln_g, ln_b (c) f32 or both null (no LayerNorm); y (n, 3c) bf16.
// c % 8 == 0 (checked by the wrapper).
int dmoe_ln_qkv(const void* x, const void* wq, const void* wk, const void* wv,
                const void* ln_g, const void* ln_b, float eps, int n, int c,
                void* y, void* stream) {
  const bool big = big_tiles_fill(n, 3 * c, 1);
  if (ln_g != nullptr)
    return big ? launch_qkv<128, true>(x, wq, wk, wv, ln_g, ln_b, eps, n, c, y, stream)
               : launch_qkv<64, true>(x, wq, wk, wv, ln_g, ln_b, eps, n, c, y, stream);
  return big ? launch_qkv<128, false>(x, wq, wk, wv, ln_g, ln_b, eps, n, c, y, stream)
             : launch_qkv<64, false>(x, wq, wk, wv, ln_g, ln_b, eps, n, c, y, stream);
}

// o (B, S, H, D) bf16 with unit stride in D and the (batch, seq, head) element
// strides in `strides` (3 values, multiples of 8); wo (c, c) bf16 (out, in)
// with c = H*D; bo (c) bf16; resid and y (n = B*S, c) bf16, contiguous.
// D % 8 == 0 (checked by the wrapper).
int dmoe_attn_out_residual(const void* o, const long long* strides,
                           const void* wo, const void* bo, const void* resid,
                           int n, int s, int c, int d, void* y, void* stream) {
  return big_tiles_fill(n, c, 1)
             ? launch_out<128>(o, strides, wo, bo, resid, n, s, c, d, y, stream)
             : launch_out<64>(o, strides, wo, bo, resid, n, s, c, d, y, stream);
}

}  // extern "C"
