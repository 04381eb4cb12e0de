// The block-level GEMM tile of the attention-absorb kernels (the two
// convolution kernels are built on wgmma_tile.cuh instead): a BM x 128
// output tile per block of 8 warps, depth T_BK per
// shared-memory tile, bf16 mma.sync m16n8k16 with f32 accumulation on
// fragments that ldmatrix reads from shared memory.
//
// The depth loop is software-pipelined over two shared-memory buffers: while
// the tensor cores work on step s, each thread's global loads for step s + 1
// are in flight into registers (`fetch`), and they are transformed and
// stored into the other buffer after the products (`commit`), one
// __syncthreads a step. Each kernel brings its own fetch and commit (that is
// where its prologue lives) and its own epilogue over the staged f32 tile.
//
// BM is 128 where the problem fills the card with such tiles and 64 where it
// does not (the launchers choose by the tile count against the card's SM
// count, see big_tiles_fill).
#pragma once

#include "common.cuh"

constexpr int T_BN = 128;          // output columns per block
constexpr int T_BK = 32;           // depth per shared-memory tile
constexpr int T_LDS = T_BK + 8;    // bf16 row stride of the A and B tiles
constexpr int T_LDC = T_BN + 4;    // f32 row stride of the epilogue staging
constexpr int T_THREADS = 256;     // 8 warps
constexpr int T_CHUNKS = T_BK / 8; // 16-byte chunks per tile row
constexpr int T_ROWS_PER_PASS = T_THREADS / T_CHUNKS;  // tile rows the block
                                   // covers with one 16-byte chunk a thread
constexpr int T_B_PER = T_BN / T_ROWS_PER_PASS;        // B chunks a thread

// Four 8 x 8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i holds matrix i in the mma fragment
// layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM>
struct Tile {
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static constexpr int WARPS_M = BM / 32;           // 2 or 4 warps down
  static constexpr int WARPS_N = 8 / WARPS_M;       // 4 or 2 warps across
  static constexpr int WN = T_BN / WARPS_N;         // 32 or 64 columns a warp
  static constexpr int NI = WN / 8;                 // 4 or 8 n8 tiles across
  static constexpr int A_PER = BM / T_ROWS_PER_PASS;   // A chunks a thread
  static constexpr int BUF_ELEMS = (BM + T_BN) * T_LDS;
  static constexpr size_t TILE_BYTES = (size_t)2 * BUF_ELEMS * 2;
  static constexpr size_t STAGE_BYTES = (size_t)BM * T_LDC * 4;
  static constexpr size_t SMEM =
      TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES;

  float acc[2][NI][4];   // the m16n8 tiles of the warp's 32 x WN output tile

  static __device__ __forceinline__ bf16* a_tile(unsigned char* smem, int buf) {
    return reinterpret_cast<bf16*>(smem) + buf * BUF_ELEMS;
  }
  static __device__ __forceinline__ bf16* b_tile(unsigned char* smem, int buf) {
    return a_tile(smem, buf) + BM * T_LDS;
  }

  // acc += As (BM x T_BK, row-major) * Bs^T (128 x T_BK, one output column a
  // row). One ldmatrix.x4 reads a 16 x 16 piece of As as an A fragment, or
  // two (n8 x k16) pieces of Bs as two B fragments.
  __device__ __forceinline__ void mma(const bf16* As, const bf16* Bs, int warp) {
    const int lane = threadIdx.x & 31;
    const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * WN;
    const bf16* a_base = As + (wm + (lane & 15)) * T_LDS + ((lane >> 4) << 3);
    const bf16* b_base = Bs + (wn + (lane & 7) + ((lane >> 4) << 3)) * T_LDS +
                         (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int kk = 0; kk < T_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], a_base + mi * 16 * T_LDS + kk);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t b[4];
        ldsm_x4(b, b_base + nj * 16 * T_LDS + kk);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  // The pipelined depth loop. fetch(s) starts this thread's global loads of
  // step s into registers; commit(As, Bs) stores what the last fetch loaded
  // into a buffer's tiles. Ends with every warp past its last product, so
  // the caller may overwrite the tiles (stage()).
  template <class Fetch, class Commit>
  __device__ __forceinline__ void run(unsigned char* smem, int nsteps, int warp,
                                      Fetch fetch, Commit commit) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    fetch(0);
    commit(a_tile(smem, 0), b_tile(smem, 0));
    __syncthreads();
    for (int s = 0; s < nsteps; ++s) {
      const int cur = s & 1;
      const bool more = s + 1 < nsteps;
      if (more) fetch(s + 1);
      mma(a_tile(smem, cur), b_tile(smem, cur), warp);
      if (more) commit(a_tile(smem, cur ^ 1), b_tile(smem, cur ^ 1));
      __syncthreads();
    }
  }

  // The accumulators into Cs (BM x 128 f32, row stride T_LDC): lane (g, t)
  // holds rows g and g + 8, columns 2t and 2t + 1 of each m16n8 tile.
  __device__ __forceinline__ void stage(float* Cs, int warp) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * WN;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float* p = Cs + (wm + 16 * mi + g) * T_LDC + wn + 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<float2*>(p + 8 * T_LDC) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
  }
};

// This thread's chunk `it` of a tile: row r of the tile, columns ch..ch+7.
__device__ __forceinline__ int chunk_row(int tid, int it) {
  return tid / T_CHUNKS + it * T_ROWS_PER_PASS;
}
__device__ __forceinline__ int chunk_col(int tid) {
  return (tid % T_CHUNKS) * 8;
}

// 8 consecutive bf16 of row r at column `col` of a (nrows, ncols) matrix with
// row stride ld; zeros outside (ncols % 8 == 0, so a chunk never straddles).
__device__ __forceinline__ uint4 load8_guard(const bf16* base, int r, int nrows,
                                             size_t ld, int col, int ncols) {
  if (r >= nrows || col >= ncols) return zero_u4();
  return *reinterpret_cast<const uint4*>(base + (size_t)r * ld + col);
}

// 8 consecutive f32 from a 16-byte aligned address.
__device__ __forceinline__ void load8_f32(float (&v)[8], const float* p) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(p + 4);
}

// This thread's chunks of a (128 x T_BK) weight tile into registers: rows
// col0.. of w (nrows, k) with row stride ld, at depth k0.
__device__ __forceinline__ void fetch_weight_tile(uint4 (&rb)[T_B_PER],
                                                  const bf16* w, int col0,
                                                  int nrows, size_t ld, int k,
                                                  int k0, int tid) {
#pragma unroll
  for (int it = 0; it < T_B_PER; ++it)
    rb[it] = load8_guard(w, col0 + chunk_row(tid, it), nrows, ld,
                         k0 + chunk_col(tid), k);
}

__device__ __forceinline__ void commit_weight_tile(const uint4 (&rb)[T_B_PER],
                                                   bf16* Bs, int tid) {
#pragma unroll
  for (int it = 0; it < T_B_PER; ++it)
    *reinterpret_cast<uint4*>(Bs + chunk_row(tid, it) * T_LDS + chunk_col(tid)) =
        rb[it];
}

// True when BM = 128 tiles give every SM at least `per_sm` blocks: the LN +
// qkv kernel repeats its row statistics in every column block and is faster
// on the larger tile from 1 a SM. The SM count is the current device's,
// asked once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

inline bool big_tiles_fill(int rows, int cols, int per_sm) {
  return (long long)((rows + 127) / 128) * ((cols + T_BN - 1) / T_BN) >=
         (long long)per_sm * sm_count();
}
