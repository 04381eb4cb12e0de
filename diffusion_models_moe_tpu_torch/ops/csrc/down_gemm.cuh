// The output GEMM with a bias and residual epilogue, shared by the fused FF's
// ff_down (geglu_ff.cu, kernel 1) and the absorbed attention's output
// projection (attn_absorb.cu, kernel 6):
//
//   y (n, c) = bf16(bf16(a W^T + bias) + resid)
//
// a (n, K) bf16 through a 2-D tensor map (rows any multiple of 16 bytes
// apart), W (c, K) bf16 in the nn.Linear layout (already the K-major B
// operand), bias (c) and resid (n, c) bf16; the sum in f32, the bias added
// in f32 before the first rounding, the residual in bf16 after it (the TPU
// kernels' order). A block takes 64 NWG rows (one or two consumer warpgroups)
// x 160 output channels (wgmma m64n160k16, both operands in shared memory);
// a producer warp keeps a 5-6 stage TMA ring of the a and W tiles (64 deep,
// 128-byte swizzle) in flight, and the TMA's zero fill past K and past n
// covers a ragged edge. Where the grid is small the K depth is split over
// grid z: each part writes its f32 sum apart, and wg::split_finish_kernel
// adds them in the order z = 0, 1, ... (bias in f32 before the rounding), so
// a repeat is bit-equal and a row's result does not depend on the other rows.
// The plan (warpgroups, split) is the wrapper's: geglu_ff_fused.down_cut.
//
// Each source instantiates the body in a kernel of its own name
// (ff_down_kernel, attn_out_kernel), so a profile tells the two apart.
#pragma once

#include "wgmma_tile.cuh"

namespace {

constexpr int BK = 64;              // depth a stage: one 128-byte swizzled row
constexpr int ROWS_WG = 64;         // rows of a consumer warpgroup
constexpr int DOWN_BN = 160;        // output channels a block
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// A 2-D map (inner, outer) with rows `row_bytes` apart, in boxes of 64 inner
// x `box_outer` outer in the 128-byte swizzle.
bool map_2d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
            uint64_t row_bytes, uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint64_t strides[1] = {row_bytes};
  const uint32_t box[2] = {64, box_outer};
  return wg::encode_bf16_map(map, base, 2, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, int smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = err == cudaSuccess;
  return err;
}

template <int NWG>
struct DownCfg {
  static constexpr int A_BYTES = NWG * ROWS_WG * 128;
  static constexpr int B_BYTES = DOWN_BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = NWG == 2 ? 5 : 6;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int SMEM = STAGES * STAGE + 2048;
};

// The epilogue of the block's 160 output channels from registers (this
// thread: rows r0 and r0 + 8, channels col + 8 j + {0, 1}): the biases and
// residuals are all loaded first, so that their loads are in flight
// together.
template <bool SPLIT, bool RESID>
__device__ __forceinline__ void down_store(const float (&acc)[80], int r0,
                                           int col, int n, int c,
                                           const bf16* __restrict__ b2,
                                           const bf16* __restrict__ x,
                                           bf16* __restrict__ y,
                                           float* __restrict__ part) {
  constexpr int J = DOWN_BN / 8;
  if (SPLIT) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half, cc = col + 8 * j;
        if (row < n && cc < c)
          *reinterpret_cast<float2*>(part + (size_t)row * c + cc) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    return;
  }
  __nv_bfloat162 bb[J], xx[J][2];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = min(col + 8 * j, c - 2);
    bb[j] = *reinterpret_cast<const __nv_bfloat162*>(b2 + cc);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (RESID)
        xx[j][half] = *reinterpret_cast<const __nv_bfloat162*>(
            x + (size_t)min(r0 + 8 * half, n - 1) * c + cc);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = col + 8 * j;
    if (cc < c) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row < n) {
          bf16 o0 = f2bf(acc[4 * j + 2 * half] + bf2f(bb[j].x));
          bf16 o1 = f2bf(acc[4 * j + 2 * half + 1] + bf2f(bb[j].y));
          if (RESID) {
            o0 = f2bf(bf2f(xx[j][half].x) + bf2f(o0));
            o1 = f2bf(bf2f(xx[j][half].y) + bf2f(o1));
          }
          __nv_bfloat162 out;
          out.x = o0;
          out.y = o1;
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * c + cc) = out;
        }
      }
    }
  }
}

// The body of a block: rows blockIdx.y, channels blockIdx.x, depth chunks
// [blockIdx.z per, + per) of the `nchunks` 64-deep chunks of K.
template <int NWG, bool SPLIT, bool RESID>
__device__ __forceinline__ void down_gemm(const CUtensorMap& amap,
                                          const CUtensorMap& wmap,
                                          const bf16* __restrict__ b2,
                                          const bf16* __restrict__ x, int n,
                                          int c, int nchunks, int per,
                                          bf16* __restrict__ y,
                                          float* __restrict__ partial) {
  using Cfg = DownCfg<NWG>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = tid >> 7;
  const int row0 = blockIdx.y * NWG * ROWS_WG, col0 = blockIdx.x * DOWN_BN;
  const int chunk0 = blockIdx.z * per;
  const int nc = min(per, nchunks - chunk0);   // >= 1 by the plan

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
      for (int ci = 0; ci < nc; ++ci) {
        wg::mbar_wait(empty + ring.stage, ring.phase ^ 1);
        unsigned char* st = smem + ring.stage * Cfg::STAGE;
        uint64_t* bar = full + ring.stage;
        wg::mbar_expect_tx(bar, Cfg::STAGE);
        wg::tma_load_2d(st, &amap, bar, (chunk0 + ci) * BK, row0);
        wg::tma_load_2d(st + Cfg::A_BYTES, &wmap, bar, (chunk0 + ci) * BK, col0);
        ring.advance(STAGES);
      }
    }
    return;
  }

  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = group - 1;
  float acc[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = 0.f;
  wg::Ring ring;
  int prev = 0;
  for (int ci = 0; ci < nc; ++ci) {
    wg::mbar_wait(full + ring.stage, ring.phase);
    const unsigned char* st = smem + ring.stage * Cfg::STAGE;
    const uint64_t ad = wg::kmajor_desc<128>(st + wgi * ROWS_WG * 128);
    const uint64_t bd = wg::kmajor_desc<128>(st + Cfg::A_BYTES);
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wg::wgmma_ss(acc, ad + 2 * ks, bd + 2 * ks, true);
    wg::wgmma_commit();
    if (ci > 0) {
      wg::wgmma_wait<1>();
      if (lane == 0) wg::mbar_arrive(empty + prev);
    }
    prev = ring.stage;
    ring.advance(STAGES);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);

  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + wgi * ROWS_WG + 16 * w + g;
  float* part = SPLIT ? partial + (size_t)blockIdx.z * n * c : nullptr;
  down_store<SPLIT, RESID>(acc, r0, col0 + 2 * t, n, c, b2, x, y, part);
}

// Launches `kernel` (a __global__ instance of down_gemm<NWG, SPLIT, RESID>
// with down_gemm's parameters; `configured` its own flag) over the plan's
// grid, then with a split the fixed-order finish:
// y = bf16(sum of the parts + bias) (+ resid in bf16), as the unsplit
// epilogue.
template <int NWG, bool SPLIT, typename Kernel>
cudaError_t launch_down_gemm(Kernel kernel, bool& configured,
                             const CUtensorMap& amap, const CUtensorMap& wmap,
                             const bf16* bias, const bf16* resid, int n, int c,
                             int nchunks, int split, int per, bf16* y,
                             float* partial, cudaStream_t st) {
  cudaError_t err = configure(kernel, DownCfg<NWG>::SMEM, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + DOWN_BN - 1) / DOWN_BN,
                  (n + NWG * ROWS_WG - 1) / (NWG * ROWS_WG), split);
  kernel<<<grid, DownCfg<NWG>::THREADS, DownCfg<NWG>::SMEM, st>>>(
      amap, wmap, bias, resid, n, c, nchunks, per, y, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return err;
  wg::launch_split_finish(partial, split, n, 1, c, bias, 0, resid, y, st, true);
  return cudaGetLastError();
}

}  // namespace
