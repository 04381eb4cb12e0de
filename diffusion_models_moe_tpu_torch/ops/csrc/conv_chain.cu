// The fused resblock conv chain for Hopper: GroupNorm-affine + SiLU prologue,
// 3x3 stride-1 SAME convolution, bias (+ time embedding) and residual
// epilogue, on wgmma, TMA and a producer/consumer pipeline.
//
// Replaces the Pallas TPU kernel diffusion_models_moe_tpu/ops/
// conv_chain_fused.py:_kernel (pallas_call at :297). That kernel stacks
// overlapping row bands outside the kernel and keeps the whole (9, Cin, Cout)
// weight resident in VMEM; here 9 x 2560 x 1280 weights are 59 MB against
// 227 KB of shared memory, so the convolution is an implicit GEMM tiled over
// its depth (Cin chunk, tap):
//
//   rows     a rectangle of 8 x 8 NWG output pixels of one image, NWG = 1 or
//            2 consumer warpgroups, each on an 8 x 8 square (a wgmma operand
//            of 64 rows is 8 whole rows of the square)
//   columns  Cout, 160 a block (divides 320, 640 and 1280)
//   depth    Cin in chunks of 64; inside a chunk the 9 taps
//
// The patch, once. For each chunk the producer warps bring the block's halo
// patch (10 x (8 NWG + 2) pixels x 64 channels) to shared memory through
// registers with 16-byte loads, and on the way put every value through
// xn = x * scale + shift (the folded GroupNorm affine of its sample and
// channel, f32), SiLU in f32 and the rounding to bf16: once per value and
// chunk, where each of the 9 taps and each column block did it before. A
// pixel outside the image is stored as zero and never put through the
// prologue (silu(shift) != 0): zeros of the normalised tensor. The patch has
// two buffers; the producers fill chunk c + 1 while the products run on c.
// There are as many producer warpgroups as consumer warpgroups: with one
// producer warpgroup for two consumers the prologue was what the consumers
// waited for (chip_smoke.py phase 2c on an NVIDIA H100 80GB HBM3 at 700 W,
// 64x64 320->320 at batch 4: 0.090 ms with one, 0.071 ms with two), so the
// 8 x 16 tile runs 512 threads, the consumers at 168 registers and the
// producers at 88 (setmaxnreg), each producer thread with all its loads of a
// chunk in flight.
//
// The taps are 9 shifted views of that patch. A shifted view does not keep a
// swizzle's alignment, so A goes through registers: each consumer lane gives
// ldmatrix its own pixel's address (pixel pitch 144 bytes, conflict-free),
// and wgmma m64n160k16 takes A from registers, the weight tile from shared
// memory and keeps the f32 sums in 80 registers a thread. The fragments of
// tap t + 1 are read while the products of tap t run.
//
// The weights come by TMA: w (Cout, 3, 3, Cin) is a 3-D tensor map (Cin, tap,
// Cout), box (64, 1, 160) in the 128-byte swizzle, so a ragged Cin or Cout is
// zero-filled by the hardware inside its own tap. One producer thread keeps a
// ring of 4-5 tiles in flight on mbarriers; consumer warps free a tile when
// its products have completed.
//
// Where the grid is small (8x8 and 16x16 at batch 4) the wrapper splits the
// chunks over several blocks (grid z): each writes its f32 sums to a scratch
// and wg::split_finish_kernel adds them in a fixed order and runs the
// epilogue, so the result does not depend on the order the blocks ran in.
// The epilogue follows the TPU kernel's rounding order: round(acc) to bf16,
// + (bias + time embedding) in bf16, + residual in bf16.
//
// Compute-bound at every SD1.5 shape above 8x8 (2*9*Cin*Cout operations a
// pixel against 2*(Cin + Cout) bytes); at 8x8 the weight's bytes bind.
// Inference only: there is no backward.
#include "wgmma_tile.cuh"

namespace {

constexpr int C_BN = 160;               // output channels a block
constexpr int C_BK = 64;                // input channels a chunk
constexpr int C_TH = 8;                 // output rows a block
constexpr int C_PITCH = 144;            // bytes from a patch pixel to the next
constexpr int C_BTILE = C_BN * 128;     // bytes of one weight tile

template <int NWG>
struct ChainCfg {
  static constexpr int TW = 8 * NWG;                 // output columns a block
  static constexpr int PW = TW + 2, PH = C_TH + 2;   // the patch with its halo
  static constexpr int ITEMS = PH * PW * (C_BK / 8); // 16-byte pieces of it
  static constexpr int PATCH = (PH * PW * C_PITCH + 127) / 128 * 128;
  // two blocks an SM with one consumer warpgroup, one with two
  static constexpr int STAGES = NWG == 1 ? 4 : 5;
  // as many producer warpgroups as consumer warpgroups: the first warp
  // issues the TMA loads, the others make the patch
  static constexpr int THREADS = 2 * NWG * 128;
  static constexpr int PRODUCERS = NWG * 128 - 32;
  // patch loads a thread keeps in flight: all of a chunk's with two
  // producer warpgroups (7), half of them with one (5 of 9)
  static constexpr int BATCH = NWG == 1 ? 5 : 7;
  static constexpr int PRODUCER_REGS = NWG == 1 ? 104 : 88;
  static constexpr int CONSUMER_REGS = NWG == 1 ? 152 : 168;
  static constexpr int BARS = 2 * STAGES + 4;
  static constexpr int SMEM = STAGES * C_BTILE + 2 * PATCH + BARS * 8 + 1024;
};

__device__ __forceinline__ float silu_f32(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

template <int NWG, bool PRO, bool SPLIT>
__global__ void __launch_bounds__(ChainCfg<NWG>::THREADS, NWG == 1 ? 2 : 1)
conv_chain_kernel(const __grid_constant__ CUtensorMap wmap,
                  const bf16* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, const bf16* __restrict__ bt,
                  const bf16* __restrict__ resid, int h, int wd, int cin,
                  int cout, int tiles_x, int tiles_per_image,
                  int chunks_per_split, bf16* __restrict__ y,
                  float* __restrict__ partial) {
  using Cfg = ChainCfg<NWG>;
  constexpr int PW = Cfg::PW, STAGES = Cfg::STAGES;
  constexpr int C_PRODUCERS = Cfg::PRODUCERS, C_BATCH = Cfg::BATCH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  unsigned char* b_tiles = smem;                          // [STAGES][160][128 B]
  unsigned char* patches = smem + STAGES * C_BTILE;       // [2][PATCH]
  uint64_t* bars = reinterpret_cast<uint64_t*>(patches + 2 * Cfg::PATCH);
  uint64_t* full_b = bars;                // weight tile landed (TMA)
  uint64_t* empty_b = bars + STAGES;      // its products completed
  uint64_t* full_p = bars + 2 * STAGES;   // patch stored
  uint64_t* empty_p = full_p + 2;         // patch read into fragments

  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid >> 7;             // warpgroup: consumers first
  const int warp_in_group = (tid >> 5) & 3;
  const int col0 = blockIdx.x * C_BN;
  const int pb = blockIdx.y / tiles_per_image;
  const int tile = blockIdx.y - pb * tiles_per_image;
  const int ty0 = (tile / tiles_x) * C_TH, tx0 = (tile % tiles_x) * Cfg::TW;
  const int nchunks = (cin + C_BK - 1) / C_BK;
  const int chunk0 = blockIdx.z * chunks_per_split;
  const int n = min(chunks_per_split, nchunks - chunk0);   // >= 1 by the plan

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full_b + s, 1);
      wg::mbar_init(empty_b + s, 4 * NWG);
    }
    for (int s = 0; s < 2; ++s) {
      wg::mbar_init(full_p + s, C_PRODUCERS);
      wg::mbar_init(empty_p + s, 4 * NWG);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (group >= NWG) {
    // ------------------------------------------------------ the producers
    wg::setmaxnreg_dec<Cfg::PRODUCER_REGS>();
    if (tid < NWG * 128 + 32) {
      if (lane == 0) {
        wg::Ring ring;
        for (int ci = 0; ci < n; ++ci)
          for (int tap = 0; tap < 9; ++tap) {
            wg::mbar_wait(empty_b + ring.stage, ring.phase ^ 1);
            wg::mbar_expect_tx(full_b + ring.stage, C_BTILE);
            wg::tma_load_3d(b_tiles + ring.stage * C_BTILE, &wmap,
                            full_b + ring.stage, (chunk0 + ci) * C_BK, tap,
                            col0);
            ring.advance(STAGES);
          }
      }
    } else {
      const int pt = tid - NWG * 128 - 32;          // 0..PRODUCERS-1
      const int c8 = (pt & 7) * 8;                  // this thread's channels
      const bf16* ximg = x + (size_t)pb * h * wd * cin;
      for (int ci = 0; ci < n; ++ci) {
        const int buf = ci & 1;
        const int ch = (chunk0 + ci) * C_BK + c8;
        const bool ch_ok = ch < cin;
        alignas(16) float sc[8], sh[8];
        if (PRO && ch_ok) {
          const float* s = scale + (size_t)pb * cin + ch;
          const float* t = shift + (size_t)pb * cin + ch;
          *reinterpret_cast<float4*>(sc) = *reinterpret_cast<const float4*>(s);
          *reinterpret_cast<float4*>(sc + 4) =
              *reinterpret_cast<const float4*>(s + 4);
          *reinterpret_cast<float4*>(sh) = *reinterpret_cast<const float4*>(t);
          *reinterpret_cast<float4*>(sh + 4) =
              *reinterpret_cast<const float4*>(t + 4);
        }
        wg::mbar_wait(empty_p + buf, ((ci >> 1) & 1) ^ 1);
        unsigned char* patch = patches + buf * Cfg::PATCH;
        for (int i0 = pt; i0 < Cfg::ITEMS; i0 += C_PRODUCERS * C_BATCH) {
          uint4 raw[C_BATCH];
          bool live[C_BATCH];
#pragma unroll
          for (int k = 0; k < C_BATCH; ++k) {
            const int pix = (i0 + k * C_PRODUCERS) >> 3;
            const int gy = ty0 - 1 + pix / PW, gx = tx0 - 1 + pix % PW;
            live[k] = i0 + k * C_PRODUCERS < Cfg::ITEMS && ch_ok && gy >= 0 &&
                      gy < h && gx >= 0 && gx < wd;
            raw[k] = live[k] ? *reinterpret_cast<const uint4*>(
                                   ximg + ((size_t)gy * wd + gx) * cin + ch)
                             : zero_u4();
          }
#pragma unroll
          for (int k = 0; k < C_BATCH; ++k) {
            const int i = i0 + k * C_PRODUCERS;
            if (i >= Cfg::ITEMS) break;
            // outside the image or past Cin: zeros of the normalised tensor
            if (PRO && live[k]) {
              alignas(16) bf16 v[8];
              *reinterpret_cast<uint4*>(v) = raw[k];
#pragma unroll
              for (int q = 0; q < 8; ++q)
                v[q] = f2bf(silu_f32(bf2f(v[q]) * sc[q] + sh[q]));
              raw[k] = *reinterpret_cast<const uint4*>(v);
            }
            *reinterpret_cast<uint4*>(patch + (i >> 3) * C_PITCH + 2 * c8) =
                raw[k];
          }
        }
        wg::mbar_arrive(full_p + buf);
      }
    }
  } else {
    // ------------------------------------------------------ the consumers
    wg::setmaxnreg_inc<Cfg::CONSUMER_REGS>();
    float acc[80];
#pragma unroll
    for (int i = 0; i < 80; ++i) acc[i] = 0.f;
    // this lane's ldmatrix row: pixel r of the warpgroup's 8 x 8 square,
    // depth half lane / 16, at the patch's pixel (r / 8, r % 8 + 8 group)
    const int r = warp_in_group * 16 + (lane & 15);
    const uint32_t a_off =
        ((r >> 3) * PW + (r & 7) + 8 * group) * C_PITCH + (lane >> 4) * 16;
    wg::Ring ring;
    int prev_stage = 0;
    for (int ci = 0; ci < n; ++ci) {
      const int buf = ci & 1;
      wg::mbar_wait(full_p + buf, (ci >> 1) & 1);
      const uint32_t a_base = wg::smem_u32(patches + buf * Cfg::PATCH) + a_off;
      uint32_t a[2][4][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t view = a_base + ((tap / 3) * PW + tap % 3) * C_PITCH;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wg::ldsm_x4(a[tap & 1][ks], view + ks * 32);
        if (tap == 8) {
          // the patch is in registers: the producers may refill it
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(empty_p + buf);
        }
        wg::mbar_wait(full_b + ring.stage, ring.phase);
        const uint64_t desc =
            wg::kmajor_desc<128>(b_tiles + ring.stage * C_BTILE);
        wg::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg::wgmma_m64n160k16_rs(acc, a[tap & 1][ks], desc + 2 * ks);
        wg::wgmma_commit();
        if (tap > 0) {
          // the tap before has completed: its fragments and its tile are free
          wg::wgmma_wait<1>();
          if (lane == 0) wg::mbar_arrive(empty_b + prev_stage);
        }
        prev_stage = ring.stage;
        ring.advance(STAGES);
      }
      wg::wgmma_wait<0>();
      if (lane == 0) wg::mbar_arrive(empty_b + prev_stage);
    }

    // the epilogue, from registers: this thread holds rows (2 warp, 2 warp +
    // 1) of the square at column lane / 4, channels 8 j + 2 (lane % 4) + {0, 1}
    const int gx = tx0 + 8 * group + (lane >> 2);
    const int cq = col0 + 2 * (lane & 3);
    const size_t m = (size_t)gridDim.y / tiles_per_image * h * wd;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gy = ty0 + 2 * warp_in_group + half;
      if (gy >= h || gx >= wd) continue;
      const size_t pix = ((size_t)pb * h + gy) * wd + gx;
#pragma unroll
      for (int j = 0; j < C_BN / 8; ++j) {
        const int co = cq + 8 * j;
        if (co >= cout) break;
        const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if (SPLIT) {
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * m + pix) *
                                                   cout + co) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(y + pix * cout + co) = wg::finish2(
              v0, v1, bt + (size_t)pb * cout + co,
              resid != nullptr ? resid + pix * cout + co : nullptr);
        }
      }
    }
  }
}

struct ChainArgs {
  const void *x, *scale, *shift, *w, *bt, *resid;
  int batch, h, wd, cin, cout, tiles_x, tiles_y, split, chunks_per_split;
  void *y, *partial, *stream;
};

template <int NWG, bool PRO, bool SPLIT>
int launch_chain(const ChainArgs& a) {
  using Cfg = ChainCfg<NWG>;
  auto kernel = conv_chain_kernel<NWG, PRO, SPLIT>;
  static bool configured = false;   // per instance of this template
  cudaError_t err = cudaSuccess;
  if (!configured) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // w (Cout, 3, 3, Cin) in channels-last memory is row-major (Cout, 9, Cin)
  CUtensorMap wmap;
  const uint64_t dims[3] = {(uint64_t)a.cin, 9, (uint64_t)a.cout};
  const uint64_t strides[2] = {(uint64_t)a.cin * 2, (uint64_t)a.cin * 18};
  const uint32_t box[3] = {C_BK, 1, C_BN};
  if (!wg::encode_bf16_map(&wmap, a.w, 3, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(a.stream);
  const int tiles = a.tiles_x * a.tiles_y;
  const dim3 grid((a.cout + C_BN - 1) / C_BN, a.batch * tiles, a.split);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      wmap, static_cast<const bf16*>(a.x), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.shift), static_cast<const bf16*>(a.bt),
      static_cast<const bf16*>(a.resid), a.h, a.wd, a.cin, a.cout, a.tiles_x,
      tiles, a.chunks_per_split, static_cast<bf16*>(a.y),
      static_cast<float*>(a.partial));
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return static_cast<int>(err);
  wg::launch_split_finish(static_cast<const float*>(a.partial), a.split,
                          a.batch * a.h * a.wd, a.h * a.wd, a.cout,
                          static_cast<const bf16*>(a.bt), a.cout,
                          static_cast<const bf16*>(a.resid),
                          static_cast<bf16*>(a.y), stream);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG>
int dispatch_chain(const ChainArgs& a) {
  const bool pro = a.scale != nullptr, split = a.split > 1;
  if (pro)
    return split ? launch_chain<NWG, true, true>(a)
                 : launch_chain<NWG, true, false>(a);
  return split ? launch_chain<NWG, false, true>(a)
               : launch_chain<NWG, false, false>(a);
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) and y, resid (B, H, W, Cout) bf16 in channels-last memory;
// scale, shift (B, Cin) f32 or both null (no prologue); w (Cout, 3, 3, Cin)
// bf16; bt (B, Cout) bf16; resid may be null. Cin % 8 == 0 and Cout % 8 == 0
// (checked by the wrapper). The plan is the wrapper's (conv_chain_fused.py:
// chain_plan): tiles of 8 x tile_w pixels (tile_w 8 or 16), tiles_x * tiles_y
// of them an image, the Cin chunks of 64 dealt to `split` blocks,
// chunks_per_split each; with split > 1, partial is an f32 scratch of
// (split, B, H, W, Cout).
int dmoe_conv3x3_chain(const void* x, const void* scale, const void* shift,
                       const void* w, const void* bt, const void* resid,
                       int batch, int h, int wd, int cin, int cout, int tile_w,
                       int tiles_x, int tiles_y, int split,
                       int chunks_per_split, void* y, void* partial,
                       void* stream) {
  const ChainArgs a{x, scale, shift, w, bt, resid, batch, h, wd, cin, cout,
                    tiles_x, tiles_y, split, chunks_per_split, y, partial,
                    stream};
  if (tile_w != 8 && tile_w != 16) return static_cast<int>(cudaErrorInvalidValue);
  return tile_w == 16 ? dispatch_chain<2>(a) : dispatch_chain<1>(a);
}

}  // extern "C"
