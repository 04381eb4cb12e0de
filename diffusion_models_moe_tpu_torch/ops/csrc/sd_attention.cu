// SD self- and cross-attention for Hopper at native head dims, on wgmma, TMA
// rings and warp-specialised softmax.
//
// Replaces the Pallas TPU kernels diffusion_models_moe_tpu/ops/sd_flash.py
// :_self_kernel (pallas_call at :97) and :_cross_kernel (pallas_call at :182).
// What both compute: non-causal attention at the native head dim D, f32
// scores, running max and denominator, p rounded to v's dtype before P.V, an
// f32 accumulator divided once at the end, keys at or past the valid count
// masked out.
//
// What binds them on this card. A score costs 4 D tensor-core operations and
// one exponential; the special-function unit gives 16 exponentials a clock
// per SM against ~4000 bf16 tensor operations, so at D = 40 (64x64 latents)
// the exponentials bound the arithmetic. The design keeps the two units
// busy at once (below); measured on an H100, what binds the D = 40 kernel
// is neither: taking the exponentials, the P V product or the whole softmax
// out leaves its time where it is, and the time follows the number of
// (block, key tile) pairs. It is not L2 bandwidth alone either: two-block
// clusters sharing each K/V tile by TMA multicast (half the L2 reads) ran
// slower. What remains per pair is bringing in a tile of 128 short rows
// (80 bytes of K or V each) by TMA (PERF.md, section 6).
//
//   block       one producer warp and NWG consumer warpgroups of 64 query
//               rows each (NWG = 2: 128 rows, 288 threads; NWG = 1 where
//               the grid would not fill the card)
//   loads       one producer thread issues every TMA load: Q once, then K
//               and V tiles of BKV keys through a ring on full/empty
//               mbarriers, as deep as shared memory holds (the plan's
//               `stages`: 4-6; 2 stages left the loads' latency exposed);
//               no consumer thread spends an instruction on a copy
//   layouts     q, k, v, o are (B, S, H, D) read through their strides as
//               4-D tensor maps (D, H, S, B): the (B, S, C) projection
//               outputs and the column thirds of kernel 5's (B, S, 3C) tensor
//               without a copy. A row of D sits in chunks of 64 values in
//               the TMA's 128-byte swizzle (D = 40, 64: one TMA row a key)
//               or of 32 values in its 64-byte swizzle (D = 72, 80, 160);
//               D = 40, 72 and 80 are padded to 64, 96 and 96 by the TMA's
//               out-of-bounds zeros, in shared memory only (every load
//               writes its whole box, so no step reads a stale pad)
//   S = Q K^T   wgmma m64nBKVk16, both operands K-major in shared memory,
//               ceil(D / 16) depth steps (the zero pad past D is skipped
//               where it fills a whole step; at D = 72 the fifth step
//               multiplies 8 values of D by 8 zeros of the pad)
//   softmax     in registers, exp2 of scores pre-multiplied by
//               scale * log2(e); row max across the quad each tile, row sums
//               per thread until the end
//   O += P V    wgmma with P as the register A operand (the f32 score
//               accumulator packed to bf16 is already in A-fragment layout)
//               and V as the MN-major B operand read by its descriptor: no
//               transpose anywhere
//   overlap     inside a warpgroup, the P V product of tile t - 1 runs while
//               the softmax of tile t does; across the two warpgroups, named
//               barriers let one issue its products while the other runs its
//               exponentials (ping-pong)
//   output      normalised O through shared memory (the warpgroup's Q tile,
//               dead by then) and out by TMA stores, clipped at S and D
//               (P V is wgmma m64nDk16 at the native D: n72 at D = 72)
//
// Cross-attention (77 text keys of CLIP, 120 of T5): one block holds the
// BKV-row (zero-padded) K and V of one (batch, head), loaded once by TMA, and
// walks a run of 64-row query tiles that come through a 2-stage TMA ring; O
// leaves through shared memory by TMA stores that overlap the next tile.
// BKV is the plan's key tile: 80 (S is wgmma m64n80k16, P V a depth of 80 in
// 5 steps) or 128 (m64n128k16, 8 steps; at D <= 80, where two blocks of
// 57-87 KB still fit an SM). Bound by q reads and o writes.
//
// The launch plan (rows a block, keys a tile, the cross kernel's run of
// query tiles) is the wrapper's (ops/sd_flash.py: attn_plan). No atomics and
// no split of a row's keys over blocks: every output depends only on its own
// row's inputs, whatever the batch. Inference only: there is no backward.
#include <math.h>

#include "wgmma_tile.cuh"

namespace {

constexpr int A_QROWS = 64;      // query rows a consumer warpgroup
constexpr float A_LOG2E = 1.4426950408889634f;

// CKV: the cross kernel's key tile (80 or 128)
template <int D, int NWG, bool CROSS, int CKV = 80>
struct AttnCfg {
  // a row of D in chunks of ROW bytes in the TMA swizzle of that width: one
  // 128-byte chunk at D = 40 and 64 (one TMA row a key), 64-byte chunks at
  // D = 72, 80 and 160 (the pad to 96, 96 and 160 stays small)
  static constexpr int ROW = D <= 64 ? 128 : 64;
  static constexpr int CW = ROW / 2;               // D values a chunk
  static constexpr int NCH = (D + CW - 1) / CW;    // chunks of a row
  static constexpr int QTILE = A_QROWS * ROW;      // one chunk of 64 rows
  static constexpr int KSTEPS = (D + 15) / 16;     // depth steps of Q K^T
  static constexpr int BKV = CROSS ? CKV : (D > 80 ? 64 : 128);
  static constexpr int PSTEPS = BKV / 16;          // depth steps of P V
  static constexpr int STAGES = 2;                 // the cross kernel's Q ring
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int KVTILE = BKV * ROW;         // one chunk of K or V
  static constexpr int Q_BYTES = (CROSS ? STAGES : NWG) * NCH * QTILE;
  static constexpr int KV_STAGE = NCH * KVTILE;    // one K (or V) tile
  // self: the K/V ring's depth is the launch plan's; cross: K and V once
  static constexpr int O_BYTES = CROSS ? NCH * QTILE : 0;   // self: Q's
  static int smem(int kv_stages) {
    return Q_BYTES + 2 * kv_stages * KV_STAGE + O_BYTES +
           (3 * (CROSS ? STAGES : kv_stages) + 2) * 8 + 1024;
  }
};
constexpr int A_SMEM_MAX = 232448;   // what a block may ask for on sm_90

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S = Q K^T for one warpgroup: q0 is the warpgroup's rows in chunk 0 of Q,
// the next chunk q_stride bytes on; k0 is chunk 0 of a K tile. A chunk row
// of ROW bytes holds ROW / 32 depth steps of 16.
template <int KSTEPS, int ROW, int N2>
__device__ __forceinline__ void scores(float (&s)[N2], const unsigned char* q0,
                                       int q_stride, const unsigned char* k0,
                                       int k_stride) {
  constexpr int SPC = ROW / 32;
  wg::fence_regs(s);
  wg::wgmma_fence();
#pragma unroll
  for (int st = 0; st < KSTEPS; ++st) {
    const uint64_t a =
        wg::kmajor_desc<ROW>(q0 + (st / SPC) * q_stride) + 2 * (st % SPC);
    const uint64_t b =
        wg::kmajor_desc<ROW>(k0 + (st / SPC) * k_stride) + 2 * (st % SPC);
    wg::wgmma_ss(s, a, b, st > 0);
  }
  wg::wgmma_commit();
}

// O += P V: p holds the bf16 A fragments of PSTEPS depth steps, v_tile is
// chunk 0 of a V tile of `kv_bytes` a chunk (rows of ROW bytes).
template <int ROW, int PSTEPS, int D2>
__device__ __forceinline__ void pv(float (&o)[D2], const uint32_t (&p)[PSTEPS][4],
                                   const unsigned char* v_tile, int kv_bytes) {
  wg::fence_regs(o);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PSTEPS; ++kk)
    wg::wgmma_rs_mn(o, p[kk],
                    wg::mnmajor_desc<ROW>(v_tile + kk * 16 * ROW, kv_bytes));
  wg::wgmma_commit();
}

// One tile of online softmax on the raw scores s (this thread: rows g and
// g + 8 of its warp, columns 8 j + 2 t + {0, 1}); keys at or past `valid`
// (tile-relative) are masked when MASK. m_* are running maxima in
// log2-scaled units; on return s holds p = 2^(s * sl2 - m), sc_* the factor
// by which the accumulator is to be rescaled and l_* this thread's share of
// the running denominators.
template <bool MASK, int N2>
__device__ __forceinline__ void softmax_tile(float (&s)[N2], float sl2,
                                             int valid, int t4, float& m_a,
                                             float& m_b, float& l_a, float& l_b,
                                             float& sc_a, float& sc_b) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < N2 / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (MASK && 8 * j + 2 * t4 + e >= valid) {
        s[4 * j + e] = -INFINITY;
        s[4 * j + 2 + e] = -INFINITY;
      }
      mx_a = fmaxf(mx_a, s[4 * j + e]);
      mx_b = fmaxf(mx_b, s[4 * j + 2 + e]);
    }
  const float mn_a = fmaxf(m_a, quad_max(mx_a) * sl2);
  const float mn_b = fmaxf(m_b, quad_max(mx_b) * sl2);
  sc_a = wg::ex2(m_a - mn_a);
  sc_b = wg::ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < N2 / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = wg::ex2(fmaf(s[4 * j + e], sl2, -mn_a));
      s[4 * j + 2 + e] = wg::ex2(fmaf(s[4 * j + 2 + e], sl2, -mn_b));
      sum_a += s[4 * j + e];
      sum_b += s[4 * j + 2 + e];
    }
  l_a = l_a * sc_a + sum_a;
  l_b = l_b * sc_b + sum_b;
}

// p (f32, accumulator layout) -> bf16 A fragments of the P V product
template <int PSTEPS>
__device__ __forceinline__ void to_fragments(uint32_t (&p)[PSTEPS][4],
                                             const float (&s)[PSTEPS * 8]) {
#pragma unroll
  for (int kk = 0; kk < PSTEPS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int D2>
__device__ __forceinline__ void rescale(float (&o)[D2], float sc_a, float sc_b) {
#pragma unroll
  for (int j = 0; j < D2 / 4; ++j) {
    o[4 * j] *= sc_a;
    o[4 * j + 1] *= sc_a;
    o[4 * j + 2] *= sc_b;
    o[4 * j + 3] *= sc_b;
  }
}

// O / l rounded to bf16 into a 64-row staging tile (chunk c at c * chunk
// bytes, rows of ROW bytes, no swizzle), for a TMA store clipped at S and D.
template <int ROW, int D2>
__device__ __forceinline__ void stage_output(unsigned char* stage, int chunk,
                                             const float (&o)[D2], float l_a,
                                             float l_b, int warp, int lane) {
  const float ia = 1.f / quad_sum(l_a), ib = 1.f / quad_sum(l_b);
  const int ra = 16 * warp + (lane >> 2), t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < D2 / 4; ++j) {
    const int col = 8 * j + 2 * t4;
    unsigned char* at =
        stage + col / (ROW / 2) * chunk + ra * ROW + col % (ROW / 2) * 2;
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[4 * j] * ia, o[4 * j + 1] * ia);
    *reinterpret_cast<uint32_t*>(at + 8 * ROW) =
        pack_bf16(o[4 * j + 2] * ib, o[4 * j + 3] * ib);
  }
}

struct Maps {
  CUtensorMap q, k, v, o;
};

// ------------------------------------------------------------------ self
template <int D, int NWG>
__global__ void __launch_bounds__(AttnCfg<D, NWG, false>::THREADS, 1)
sd_self_attn_kernel(const __grid_constant__ Maps maps, int seq, int stages,
                    float sl2) {
  using Cfg = AttnCfg<D, NWG, false>;
  constexpr int NCH = Cfg::NCH, BKV = Cfg::BKV;
  constexpr int KVTILE = Cfg::KVTILE, QTILE = Cfg::QTILE, ROW = Cfg::ROW;
  constexpr int CW = Cfg::CW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  unsigned char* qs = smem;                          // [NCH][NWG * 64 rows]
  unsigned char* ks = qs + Cfg::Q_BYTES;             // [stages][NCH][BKV rows]
  unsigned char* vs = ks + stages * Cfg::KV_STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + stages * Cfg::KV_STAGE);
  uint64_t* full_k = bars;
  uint64_t* full_v = bars + stages;
  uint64_t* empty = bars + 2 * stages;
  uint64_t* full_q = bars + 3 * stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const int group = tid >> 7;                        // consumers first
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NWG * A_QROWS;
  const int n_tiles = (seq + BKV - 1) / BKV;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(full_k + s, 1);
      wg::mbar_init(full_v + s, 1);
      wg::mbar_init(empty + s, 4 * NWG);
    }
    wg::mbar_init(full_q, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (group == NWG) {
    // ------------------------------------------------------ the producer
    if (lane == 0) {
      wg::mbar_expect_tx(full_q, Cfg::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        wg::tma_load_4d(qs + c * NWG * QTILE, &maps.q, full_q, CW * c, h, q0, b);
      wg::Ring ring;
      for (int t = 0; t < n_tiles; ++t) {
        wg::mbar_wait(empty + ring.stage, ring.phase ^ 1);
        unsigned char* kt = ks + ring.stage * NCH * KVTILE;
        unsigned char* vt = vs + ring.stage * NCH * KVTILE;
        wg::mbar_expect_tx(full_k + ring.stage, NCH * KVTILE);
        for (int c = 0; c < NCH; ++c)
          wg::tma_load_4d(kt + c * KVTILE, &maps.k, full_k + ring.stage, CW * c,
                          h, t * BKV, b);
        wg::mbar_expect_tx(full_v + ring.stage, NCH * KVTILE);
        for (int c = 0; c < NCH; ++c)
          wg::tma_load_4d(vt + c * KVTILE, &maps.v, full_v + ring.stage, CW * c,
                          h, t * BKV, b);
        ring.advance(stages);
      }
    }
    return;
  }

  // -------------------------------------------------------- the consumers
  const unsigned char* q_own = qs + group * QTILE;
  const int t4 = lane & 3;
  // ping-pong: the warpgroups issue their products in turn, each between a
  // sync on its own barrier (1 + group) and an arrive on the next one's;
  // the last group opens the first turn and skips its last arrive, so
  // every barrier sees as many arrives as syncs
  const int next = group + 1 == NWG ? 0 : group + 1;
  auto turn_wait = [&] {
    if (NWG > 1) wg::named_sync(1 + group, 256);
  };
  auto turn_pass = [&](bool last) {
    if (NWG > 1 && !(group == NWG - 1 && last)) wg::named_arrive(1 + next, 256);
  };
  if (NWG > 1 && group == NWG - 1) wg::named_arrive(1, 256);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[BKV / 2];
  uint32_t p[Cfg::PSTEPS][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float sc_a = 1.f, sc_b = 1.f;
  const bool ragged = seq % BKV != 0;

  wg::mbar_wait(full_q, 0);
  wg::Ring ring;
  wg::mbar_wait(full_k + ring.stage, ring.phase);
  turn_wait();
  scores<Cfg::KSTEPS, ROW>(s, q_own, NWG * QTILE, ks + ring.stage * NCH * KVTILE,
                      KVTILE);
  turn_pass(n_tiles == 1);
  wg::wgmma_wait<0>();
  wg::fence_regs(s);
  if (ragged && n_tiles == 1)
    softmax_tile<true>(s, sl2, seq, t4, m_a, m_b, l_a, l_b, sc_a, sc_b);
  else
    softmax_tile<false>(s, sl2, seq, t4, m_a, m_b, l_a, l_b, sc_a, sc_b);
  to_fragments(p, s);

  for (int t = 1; t < n_tiles; ++t) {
    const wg::Ring prev = ring;
    ring.advance(stages);
    wg::mbar_wait(full_k + ring.stage, ring.phase);
    turn_wait();
    scores<Cfg::KSTEPS, ROW>(s, q_own, NWG * QTILE, ks + ring.stage * NCH * KVTILE,
                        KVTILE);
    rescale(o, sc_a, sc_b);
    wg::mbar_wait(full_v + prev.stage, prev.phase);
    pv<ROW>(o, p, vs + prev.stage * NCH * KVTILE, KVTILE);
    turn_pass(t == n_tiles - 1);
    wg::wgmma_wait<1>();
    wg::fence_regs(s);
    if (ragged && t == n_tiles - 1)
      softmax_tile<true>(s, sl2, seq - t * BKV, t4, m_a, m_b, l_a, l_b, sc_a,
                         sc_b);
    else
      softmax_tile<false>(s, sl2, 0, t4, m_a, m_b, l_a, l_b, sc_a, sc_b);
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
    wg::fence_regs(p);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + prev.stage);
    to_fragments(p, s);
  }
  rescale(o, sc_a, sc_b);
  wg::mbar_wait(full_v + ring.stage, ring.phase);
  pv<ROW>(o, p, vs + ring.stage * NCH * KVTILE, KVTILE);
  wg::wgmma_wait<0>();
  wg::fence_regs(o);
  wg::fence_regs(p);

  // the warpgroup's own Q rows are dead: O is staged in their place
  unsigned char* stage = qs + group * QTILE;
  stage_output<ROW>(stage, NWG * QTILE, o, l_a, l_b, warp, lane);
  wg::fence_proxy_async();
  wg::named_sync(1 + NWG + group, 128);
  if ((tid & 127) == 0) {
    for (int c = 0; c < NCH; ++c)
      wg::tma_store_4d(&maps.o, stage + c * NWG * QTILE, CW * c, h,
                       q0 + group * A_QROWS, b);
    wg::bulk_commit();
    wg::bulk_wait();
  }
}

// ----------------------------------------------------------------- cross
template <int D, int BKV>
__global__ void __launch_bounds__(AttnCfg<D, 1, true, BKV>::THREADS, 2)
sd_cross_attn_kernel(const __grid_constant__ Maps maps, int sq, int kv_valid,
                     int run, float sl2) {
  using Cfg = AttnCfg<D, 1, true, BKV>;
  constexpr int NCH = Cfg::NCH, STAGES = Cfg::STAGES, KVTILE = Cfg::KVTILE;
  constexpr int QTILE = Cfg::QTILE, ROW = Cfg::ROW, CW = Cfg::CW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::smem_base_1024(smem_raw);
  unsigned char* qs = smem;                          // [STAGES][NCH][64 rows]
  unsigned char* ks = qs + Cfg::Q_BYTES;             // [NCH][BKV rows]
  unsigned char* vs = ks + Cfg::KV_STAGE;
  unsigned char* os = vs + Cfg::KV_STAGE;            // [NCH][64 rows]
  uint64_t* bars = reinterpret_cast<uint64_t*>(os + Cfg::O_BYTES);
  uint64_t* full_q = bars;
  uint64_t* empty_q = bars + STAGES;
  uint64_t* full_kv = bars + 2 * STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tile0 = blockIdx.x * run;
  const int n = min(run, (sq + A_QROWS - 1) / A_QROWS - tile0);   // >= 1

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full_q + s, 1);
      wg::mbar_init(empty_q + s, 4);
    }
    wg::mbar_init(full_kv, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ------------------------------------------------------ the producer
    if (lane == 0) {
      wg::mbar_expect_tx(full_kv, 2 * NCH * KVTILE);
      for (int c = 0; c < NCH; ++c) {
        wg::tma_load_4d(ks + c * KVTILE, &maps.k, full_kv, CW * c, h, 0, b);
        wg::tma_load_4d(vs + c * KVTILE, &maps.v, full_kv, CW * c, h, 0, b);
      }
      wg::Ring ring;
      for (int i = 0; i < n; ++i) {
        wg::mbar_wait(empty_q + ring.stage, ring.phase ^ 1);
        unsigned char* qt = qs + ring.stage * NCH * QTILE;
        wg::mbar_expect_tx(full_q + ring.stage, NCH * QTILE);
        for (int c = 0; c < NCH; ++c)
          wg::tma_load_4d(qt + c * QTILE, &maps.q, full_q + ring.stage, CW * c,
                          h, (tile0 + i) * A_QROWS, b);
        ring.advance(STAGES);
      }
    }
    return;
  }

  // --------------------------------------------------------- the consumer
  const int t4 = lane & 3;
  float s[Cfg::BKV / 2];
  float o[D / 2];
  uint32_t p[Cfg::PSTEPS][4];
  wg::mbar_wait(full_kv, 0);
  wg::Ring ring;
  for (int i = 0; i < n; ++i) {
    wg::mbar_wait(full_q + ring.stage, ring.phase);
    scores<Cfg::KSTEPS, ROW>(s, qs + ring.stage * NCH * QTILE, QTILE, ks, KVTILE);
    wg::wgmma_wait<0>();
    wg::fence_regs(s);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty_q + ring.stage);
    ring.advance(STAGES);
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, sc_a, sc_b;
    softmax_tile<true>(s, sl2, kv_valid, t4, m_a, m_b, l_a, l_b, sc_a, sc_b);
    to_fragments(p, s);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    pv<ROW>(o, p, vs, KVTILE);
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
    wg::fence_regs(p);
    if (i > 0) {
      // the previous tile's store has read the staging tile
      if (tid == 0) wg::bulk_wait_read();
      wg::named_sync(1, 128);
    }
    stage_output<ROW>(os, QTILE, o, l_a, l_b, warp, lane);
    wg::fence_proxy_async();
    wg::named_sync(1, 128);
    if (tid == 0) {
      for (int c = 0; c < NCH; ++c)
        wg::tma_store_4d(&maps.o, os + c * QTILE, CW * c, h,
                         (tile0 + i) * A_QROWS, b);
      wg::bulk_commit();
    }
  }
  if (tid == 0) wg::bulk_wait();
}

// (B, S, H, D) through element strides (batch, seq, head) as a 4-D map
// (D, H, S, B) with boxes of cw x 1 x rows x 1 (wg::encode_bf16_map keeps
// the maps encoded before).
bool encode_bshd(CUtensorMap* map, const void* base, int batch, int seq,
                 int heads, int d, const long long* st, int cw, int rows,
                 CUtensorMapSwizzle swizzle) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)heads, (uint64_t)seq,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)st[2] * 2, (uint64_t)st[1] * 2,
                               (uint64_t)st[0] * 2};
  const uint32_t box[4] = {(uint32_t)cw, 1, (uint32_t)rows, 1};
  return wg::encode_bf16_map(map, base, 4, dims, strides, box, swizzle);
}

template <typename Kernel>
int configure(Kernel kernel, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, A_SMEM_MAX);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

struct AttnArgs {
  const void *q, *k, *v;
  void* o;
  int batch, heads, sq, skv, d, wgs, bkv, run, stages;
  float sl2;
  const long long* st;     // (batch, seq, head) strides of q, k, v, o
  cudaStream_t stream;
};

// q, k, v in the swizzle of ROW-byte chunks; o unswizzled (the staging tile)
bool encode_all(Maps& m, const AttnArgs& a, int row, int q_rows, int kv_rows) {
  const int cw = row / 2;
  const auto sw = row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode_bshd(&m.q, a.q, a.batch, a.sq, a.heads, a.d, a.st, cw, q_rows,
                     sw) &&
         encode_bshd(&m.k, a.k, a.batch, a.skv, a.heads, a.d, a.st + 3, cw,
                     kv_rows, sw) &&
         encode_bshd(&m.v, a.v, a.batch, a.skv, a.heads, a.d, a.st + 6, cw,
                     kv_rows, sw) &&
         encode_bshd(&m.o, a.o, a.batch, a.sq, a.heads, a.d, a.st + 9, cw,
                     A_QROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int D, int NWG>
int launch_self(const AttnArgs& a) {
  using Cfg = AttnCfg<D, NWG, false>;
  static bool configured = false;
  int err = configure(sd_self_attn_kernel<D, NWG>, configured);
  if (err != 0) return err;
  const int smem = Cfg::smem(a.stages);
  // the plan's key tile must be the one this instance is built for
  if (a.bkv != Cfg::BKV || a.stages < 2 || smem > A_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  if (!encode_all(m, a, Cfg::ROW, NWG * A_QROWS, Cfg::BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = NWG * A_QROWS;
  const dim3 grid((a.sq + rows - 1) / rows, a.heads, a.batch);
  sd_self_attn_kernel<D, NWG><<<grid, Cfg::THREADS, smem, a.stream>>>(
      m, a.sq, a.stages, a.sl2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BKV>
int launch_cross(const AttnArgs& a, int kv_valid) {
  using Cfg = AttnCfg<D, 1, true, BKV>;
  static bool configured = false;
  int err = configure(sd_cross_attn_kernel<D, BKV>, configured);
  if (err != 0) return err;
  Maps m;
  if (!encode_all(m, a, Cfg::ROW, A_QROWS, Cfg::BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (a.sq + A_QROWS - 1) / A_QROWS;
  const dim3 grid((tiles + a.run - 1) / a.run, a.heads, a.batch);
  sd_cross_attn_kernel<D, BKV><<<grid, Cfg::THREADS, Cfg::smem(1), a.stream>>>(
      m, a.sq, kv_valid, a.run, a.sl2);
  return static_cast<int>(cudaGetLastError());
}

// the plan's key tile: 80, or 128 up to D = 80 (at D = 160 K and V of 128
// keys alone take 80 KB, and two blocks an SM would not fit)
template <int D>
int dispatch_cross(const AttnArgs& a, int kv_valid) {
  if (kv_valid > a.bkv) return static_cast<int>(cudaErrorInvalidValue);
  if (a.bkv == 80) return launch_cross<D, 80>(a, kv_valid);
  if constexpr (D <= 80) {
    if (a.bkv == 128) return launch_cross<D, 128>(a, kv_valid);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int dispatch_self(const AttnArgs& a) {
  if (a.wgs == 2) return launch_self<D, 2>(a);
  if (a.wgs == 1) return launch_self<D, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, D) bf16 with unit stride in D; `strides` holds
// (batch, seq, head) element strides for q, k, v, o in that order (12 values),
// each a multiple of 8, pointers 16-byte aligned; D in {40, 64, 72, 80, 160}
// (the wrapper checks: ops/sd_flash.py attn_kernel_ok). `wgs` consumer
// warpgroups a block (64 query rows each), `bkv` keys a tile (checked
// against the instance) and `stages` of the K/V ring, from attn_plan.
int dmoe_sd_self_attention(const void* q, const void* k, const void* v, void* o,
                           int batch, int heads, int seq, int d, float scale,
                           int wgs, int bkv, int stages,
                           const long long* strides, void* stream) {
  const AttnArgs a{q, k, v, o, batch, heads, seq, seq, d, wgs, bkv, 1, stages,
                   scale * A_LOG2E, strides, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 40: return dispatch_self<40>(a);
    case 64: return dispatch_self<64>(a);
    case 72: return dispatch_self<72>(a);
    case 80: return dispatch_self<80>(a);
    case 160: return dispatch_self<160>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, o: (B, S_q, H, D); k, v: (B, S_kv, H, D); keys at or past kv_valid
// (1..bkv) are masked out, and only the first `bkv` key rows are read (80,
// or 128 at D <= 80: the plan's key tile). A block takes `run` consecutive
// 64-row query tiles of one (batch, head).
int dmoe_sd_cross_attention(const void* q, const void* k, const void* v,
                            void* o, int batch, int heads, int sq, int s_kv,
                            int kv_valid, int d, float scale, int bkv, int run,
                            const long long* strides, void* stream) {
  if (kv_valid < 1 || run < 1) return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs a{q, k, v, o, batch, heads, sq, s_kv, d, 1, bkv, run, 0,
                   scale * A_LOG2E, strides, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 40: return dispatch_cross<40>(a, kv_valid);
    case 64: return dispatch_cross<64>(a, kv_valid);
    case 72: return dispatch_cross<72>(a, kv_valid);
    case 80: return dispatch_cross<80>(a, kv_valid);
    case 160: return dispatch_cross<160>(a, kv_valid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
