// The fused resblock conv chain for Hopper: GroupNorm-affine + SiLU prologue,
// 3x3 stride-1 SAME convolution, bias (+ time embedding) and residual
// epilogue, in one kernel.
//
// Replaces the Pallas TPU kernel diffusion_models_moe_tpu/ops/
// conv_chain_fused.py:_kernel (pallas_call at :297). That kernel stacks
// overlapping row bands outside the kernel and keeps the whole (9, Cin, Cout)
// weight resident in VMEM; here 9 x 2560 x 1280 weights are 59 MB against
// 227 KB of shared memory, so the convolution is an implicit GEMM tiled over
// its depth K = (tap, Cin):
//
//   rows     the B*H*W output pixels, BM a block (channels-last memory: the
//            Cin values of a pixel are contiguous, so an A-tile row is 16-byte
//            loads; the halo is read from x itself, nothing is gathered or
//            stacked beforehand)
//   columns  Cout, 128 a block, from the weight as (Cout, 3, 3, Cin)
//   depth    for each of the 9 taps, Cin in steps of 32
//
// On the A-tile load each value goes through xn = x*scale + shift (the folded
// GroupNorm affine of its sample and channel, f32), SiLU in f32, and is
// rounded to bf16. A tap that falls outside the image contributes zeros of
// the normalised tensor: the zero is written after the prologue, never put
// through it (silu(shift) != 0). The epilogue follows the TPU kernel's
// rounding order: round(acc) to bf16, + (bias + time embedding) in bf16,
// + residual in bf16.
//
// Compute-bound at every SD1.5 shape (2*9*Cin*Cout operations a pixel against
// 2*(Cin + Cout) bytes). The prologue is recomputed for each of the 9 taps
// and each 128-column block that reads a pixel, between the global load and
// the shared-memory store of the shared mma.sync tile's pipelined depth loop
// (gemm_tile.cuh: register prefetch over two buffers; no TMA or wgmma yet).
// Inference only: there is no backward.
#include "gemm_tile.cuh"

namespace {

__device__ __forceinline__ float silu_f32(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

template <int BM, bool PRO, bool RES>
__global__ void __launch_bounds__(T_THREADS) conv_chain_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const bf16* __restrict__ w,
    const bf16* __restrict__ bt, const bf16* __restrict__ resid, int batch,
    int h, int wd, int cin, int cout, bf16* __restrict__ y) {
  constexpr int A_PER = Tile<BM>::A_PER;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m = batch * h * wd;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * T_BN;

  // this thread's A-tile rows: the same pixels for every tap and depth step
  const int ch = chunk_col(tid);
  int pb[A_PER], py[A_PER], px[A_PER];
#pragma unroll
  for (int it = 0; it < A_PER; ++it) {
    const int gr = row0 + chunk_row(tid, it);
    if (gr < m) {
      pb[it] = gr / (h * wd);
      const int rem = gr - pb[it] * h * wd;
      py[it] = rem / wd;
      px[it] = rem - py[it] * wd;
    } else {
      pb[it] = -1;
      py[it] = px[it] = 0;
    }
  }

  const int ksteps = (cin + T_BK - 1) / T_BK;   // depth steps a tap
  uint4 ra[A_PER], rb[T_B_PER];
  bool live[A_PER];   // the chunk in ra[it] lies inside the image and Cin
  int kc = 0;         // input channel of the chunks in ra and rb

  // fetch is called with step = 0, 1, 2, ...: the tap and the depth step
  // inside it advance with it, no division in the loop
  int tap = 0, kstep = -1;
  auto fetch = [&](int) {
    if (++kstep == ksteps) {
      kstep = 0;
      ++tap;
    }
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    kc = kstep * T_BK + ch;
#pragma unroll
    for (int it = 0; it < A_PER; ++it) {
      const int yy = py[it] + dy, xx = px[it] + dx;
      live[it] = pb[it] >= 0 && kc < cin && yy >= 0 && yy < h && xx >= 0 &&
                 xx < wd;
      ra[it] = live[it]
                   ? *reinterpret_cast<const uint4*>(
                         x + ((size_t)(pb[it] * h + yy) * wd + xx) * cin + kc)
                   : zero_u4();
    }
    // w is (cout, 9, cin): tap's (cout, cin) slice has row stride 9*cin
    fetch_weight_tile(rb, w + (size_t)tap * cin, col0, cout, (size_t)9 * cin,
                      cin, kc - ch, tid);
  };
  auto commit = [&](bf16* As, bf16* Bs) {
#pragma unroll
    for (int it = 0; it < A_PER; ++it) {
      // a tap outside the image stays zero: zeros of the normalised tensor
      if (PRO && live[it]) {
        alignas(16) bf16 tmp[8];
        *reinterpret_cast<uint4*>(tmp) = ra[it];
        alignas(16) float sc[8], sh[8];
        load8_f32(sc, scale + (size_t)pb[it] * cin + kc);
        load8_f32(sh, shift + (size_t)pb[it] * cin + kc);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          tmp[q] = f2bf(silu_f32(bf2f(tmp[q]) * sc[q] + sh[q]));
        ra[it] = *reinterpret_cast<const uint4*>(tmp);
      }
      *reinterpret_cast<uint4*>(As + chunk_row(tid, it) * T_LDS + ch) = ra[it];
    }
    commit_weight_tile(rb, Bs, tid);
  };

  Tile<BM> tile;
  tile.run(smem, 9 * ksteps, warp, fetch, commit);

  float* Cs = reinterpret_cast<float*>(smem);   // the tiles are dead now
  tile.stage(Cs, warp);
  __syncthreads();
  for (int i = tid; i < BM * (T_BN / 8); i += T_THREADS) {
    const int r = i / (T_BN / 8), cc = (i % (T_BN / 8)) * 8;
    const int gr = row0 + r, co = col0 + cc;
    if (gr >= m || co >= cout) continue;
    const size_t off = (size_t)gr * cout + co;
    alignas(16) bf16 add[8], res[8], out[8];
    *reinterpret_cast<uint4*>(add) = *reinterpret_cast<const uint4*>(
        bt + (size_t)(gr / (h * wd)) * cout + co);
    if (RES)
      *reinterpret_cast<uint4*>(res) =
          *reinterpret_cast<const uint4*>(resid + off);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      bf16 v = f2bf(Cs[r * T_LDC + cc + q]);
      v = f2bf(bf2f(v) + bf2f(add[q]));
      if (RES) v = f2bf(bf2f(v) + bf2f(res[q]));
      out[q] = v;
    }
    *reinterpret_cast<uint4*>(y + off) = *reinterpret_cast<const uint4*>(out);
  }
}

template <int BM, bool PRO, bool RES>
int launch_chain(const void* x, const void* scale, const void* shift,
                 const void* w, const void* bt, const void* resid, int batch,
                 int h, int wd, int cin, int cout, void* y, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_chain_kernel<BM, PRO, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<BM>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = batch * h * wd;
  const dim3 grid((cout + T_BN - 1) / T_BN, (m + BM - 1) / BM);
  conv_chain_kernel<BM, PRO, RES><<<grid, T_THREADS, Tile<BM>::SMEM,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bt), static_cast<const bf16*>(resid), batch, h,
      wd, cin, cout, static_cast<bf16*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int dispatch_chain(bool pro, bool res, const void* x, const void* scale,
                   const void* shift, const void* w, const void* bt,
                   const void* resid, int batch, int h, int wd, int cin,
                   int cout, void* y, void* stream) {
  if (pro)
    return res ? launch_chain<BM, true, true>(x, scale, shift, w, bt, resid, batch, h, wd, cin, cout, y, stream)
               : launch_chain<BM, true, false>(x, scale, shift, w, bt, resid, batch, h, wd, cin, cout, y, stream);
  return res ? launch_chain<BM, false, true>(x, scale, shift, w, bt, resid, batch, h, wd, cin, cout, y, stream)
             : launch_chain<BM, false, false>(x, scale, shift, w, bt, resid, batch, h, wd, cin, cout, y, stream);
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) and y, resid (B, H, W, Cout) bf16 in channels-last memory;
// scale, shift (B, Cin) f32 or both null (no prologue); w (Cout, 3, 3, Cin)
// bf16; bt (B, Cout) bf16; resid may be null. Cin % 8 == 0 and Cout % 8 == 0
// (checked by the wrapper).
int dmoe_conv3x3_chain(const void* x, const void* scale, const void* shift,
                       const void* w, const void* bt, const void* resid,
                       int batch, int h, int wd, int cin, int cout, void* y,
                       void* stream) {
  const bool pro = scale != nullptr, res = resid != nullptr;
  return big_tiles_fill(batch * h * wd, cout, 2)
             ? dispatch_chain<128>(pro, res, x, scale, shift, w, bt, resid,
                                   batch, h, wd, cin, cout, y, stream)
             : dispatch_chain<64>(pro, res, x, scale, shift, w, bt, resid,
                                  batch, h, wd, cin, cout, y, stream);
}

}  // extern "C"
