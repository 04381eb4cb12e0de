// SD self- and cross-attention for Hopper at native head dims.
//
// Replaces the Pallas TPU kernels diffusion_models_moe_tpu/ops/sd_flash.py
// :_self_kernel (pallas_call at :97) and :_cross_kernel (pallas_call at :182).
//
//   sd_self_attn   non-causal flash attention with online softmax: f32 scores,
//                  running max and denominator, p rounded to v's dtype before
//                  P.V, f32 accumulator, divide after the last kv tile.
//   sd_cross_attn  the same body with all keys in one tile: the 77 text
//                  tokens sit whole in shared memory (zero rows up to 80,
//                  masked to -inf), one pass per (batch, head, q-tile).
//
// Both read q, k, v (B, S, H, D) through strides, so the (B, S, C) projection
// outputs are used in place: no transpose copy and no HBM pad pass. D in
// {40, 80, 160} is padded with zeros to a multiple of 16 in shared memory only
// (the MMA depth). Scores and P.V run as bf16 mma.sync m16n8k16 with f32
// accumulation; each of the 4 warps owns 16 query rows of the 64-row tile and
// keeps scores, probabilities and its output accumulator in registers. The
// self kernel is compute-bound at S >= 1024 and the cross kernel bound by q
// reads and o writes; both are first versions without TMA, wgmma or
// pipelining of the K/V loads. Inference only: there is no backward.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int A_BQ = 64;        // query rows per block, 16 per warp
constexpr int A_THREADS = 128;
constexpr int A_BKV_SELF = 64;  // keys per tile of the self kernel
constexpr int A_BKV_CROSS = 80; // the cross kernel's one tile: 77 text tokens

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col); PTX fragment
// layouts: a row g / g+8, k 2t..2t+1 / +8; b k 2t..2t+1 / +8, n g; c row g /
// g+8, n 2t..2t+1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DP, int BKV>
constexpr size_t attn_smem_bytes() {
  return ((size_t)A_BQ * (DP + 8) + (size_t)BKV * (DP + 8) +
          (size_t)DP * (BKV + 8)) * 2;
}

// One block: 64 query rows of one (batch, head); each warp owns 16 rows and
// keeps its scores, probabilities and output accumulator in registers.
// Keys stream through shared memory BKV at a time (the cross kernel takes
// all keys in one tile); V is stored transposed so that its MMA operand
// loads are 32-bit. DP is the head dim padded to 16 (zeros, in shared
// memory only).
template <int DP, int BKV>
__global__ void __launch_bounds__(A_THREADS) sd_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int sq, int skv, int d,
    float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int LDQ = DP + 8;   // bf16 row stride of Qs and Ks
  constexpr int LDV = BKV + 8;  // bf16 row stride of Vt
  constexpr int NT = BKV / 8;   // n8 tiles of the scores
  constexpr int DT = DP / 8;    // n8 tiles of the output
  constexpr int PCH = DP / 8;   // 16-byte chunks per padded row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + A_BQ * LDQ;
  bf16* Vt = Ks + BKV * LDQ;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * A_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nch = d / 8;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  for (int i = tid; i < A_BQ * PCH; i += A_THREADS) {
    const int r = i / PCH, ch = i % PCH;
    uint4 val = zero_u4();
    if (q0 + r < sq && ch < nch)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * qs.s + ch * 8);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + ch * 8) = val;
  }

  const int r0 = warp * 16;
  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g, g+8

  const int n_tiles = (skv + BKV - 1) / BKV;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BKV;
    __syncthreads();  // Q is stored; the previous tile's K/V are consumed
    for (int i = tid; i < BKV * PCH; i += A_THREADS) {
      const int r = i / PCH, ch = i % PCH;
      uint4 kv = zero_u4();
      alignas(16) bf16 vv[8];
      *reinterpret_cast<uint4*>(vv) = zero_u4();
      if (k0 + r < skv && ch < nch) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * ks.s + ch * 8);
        *reinterpret_cast<uint4*>(vv) =
            *reinterpret_cast<const uint4*>(vb + (k0 + r) * vs.s + ch * 8);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDQ + ch * 8) = kv;
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(ch * 8 + j) * LDV + r] = vv[j];
    }
    __syncthreads();

    // S = Q K^T (f32), 16 x BKV per warp
    float sacc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
#pragma unroll
    for (int kq = 0; kq < DP / 16; ++kq) {
      const bf16* pa = Qs + (r0 + g) * LDQ + kq * 16 + t4 * 2;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LDQ), ld32(pa + 8),
                             ld32(pa + 8 * LDQ + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* pb = Ks + (nt * 8 + g) * LDQ + kq * 16 + t4 * 2;
        mma16816(sacc[nt], a, ld32(pb), ld32(pb + 8));
      }
    }

    // online softmax: scale, mask past skv, running max and denominator
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + t4 * 2 + j < skv;
        sacc[nt][j] = ok ? sacc[nt][j] * scale : -INFINITY;
        sacc[nt][2 + j] = ok ? sacc[nt][2 + j] * scale : -INFINITY;
        mx_a = fmaxf(mx_a, sacc[nt][j]);
        mx_b = fmaxf(mx_b, sacc[nt][2 + j]);
      }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pf[NT / 2][4];  // P rounded to bf16, as MMA A fragments
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(sacc[nt][0] - mn_a), p1 = expf(sacc[nt][1] - mn_a);
      const float p2 = expf(sacc[nt][2] - mn_b), p3 = expf(sacc[nt][3] - mn_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      pf[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o2);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o2);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;

    // O = O * alpha + P V
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] *= al_a;
      oacc[dt][1] *= al_a;
      oacc[dt][2] *= al_b;
      oacc[dt][3] *= al_b;
#pragma unroll
      for (int kt = 0; kt < BKV / 16; ++kt) {
        const bf16* pb = Vt + (dt * 8 + g) * LDV + kt * 16 + t4 * 2;
        mma16816(oacc[dt], pf[kt], ld32(pb), ld32(pb + 8));
      }
    }
  }

  bf16* ob = o + b * os.b + h * os.h;
  const int ra = q0 + r0 + g, rb = ra + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (col >= d) continue;
    if (ra < sq)
      *reinterpret_cast<uint32_t*>(ob + ra * os.s + col) =
          pack_bf16(oacc[dt][0] / l_a, oacc[dt][1] / l_a);
    if (rb < sq)
      *reinterpret_cast<uint32_t*>(ob + rb * os.s + col) =
          pack_bf16(oacc[dt][2] / l_b, oacc[dt][3] / l_b);
  }
}

template <int DP, int BKV>
int launch_attn(const void* q, const void* k, const void* v, void* o,
                int batch, int heads, int sq, int skv, int d, float scale,
                const long long* st, void* stream) {
  constexpr size_t smem = attn_smem_bytes<DP, BKV>();
  cudaError_t err = cudaFuncSetAttribute(
      sd_attn_kernel<DP, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((sq + A_BQ - 1) / A_BQ, heads, batch);
  sd_attn_kernel<DP, BKV><<<grid, A_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, skv, d, scale,
      qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

// Head dims the kernels are instantiated for, padded to 16: SD1.x's 40, 80
// and 160.
template <int BKV>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               int batch, int heads, int sq, int skv, int d, float scale,
               const long long* st, void* stream) {
  switch ((d + 15) / 16 * 16) {
    case 48:
      return launch_attn<48, BKV>(q, k, v, o, batch, heads, sq, skv, d, scale, st, stream);
    case 80:
      return launch_attn<80, BKV>(q, k, v, o, batch, heads, sq, skv, d, scale, st, stream);
    case 160:
      return launch_attn<160, BKV>(q, k, v, o, batch, heads, sq, skv, d, scale, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, D) bf16 with unit stride in D; `strides` holds
// (batch, seq, head) element strides for q, k, v, o in that order (12 values).
// D % 8 == 0 with ceil16(D) in {48, 80, 160}; strides and pointers 16-byte
// aligned (the wrapper checks).
int dmoe_sd_self_attention(const void* q, const void* k, const void* v, void* o,
                           int batch, int heads, int seq, int d, float scale,
                           const long long* strides, void* stream) {
  return dispatch_d<A_BKV_SELF>(q, k, v, o, batch, heads, seq, seq, d, scale,
                                strides, stream);
}

// q, o: (B, S_q, H, D); k, v: (B, S_kv, H, D); keys at or past kv_valid
// (<= 80) are masked out. All keys sit in one shared-memory tile.
int dmoe_sd_cross_attention(const void* q, const void* k, const void* v,
                            void* o, int batch, int heads, int sq, int kv_valid,
                            int d, float scale, const long long* strides,
                            void* stream) {
  if (kv_valid < 1 || kv_valid > A_BKV_CROSS)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d<A_BKV_CROSS>(q, k, v, o, batch, heads, sq, kv_valid, d,
                                 scale, strides, stream);
}

}  // extern "C"
