// Hopper building blocks shared by the convolution kernels (conv_chain.cu,
// winograd.cu), the attention kernels (sd_attention.cu) and the fused FF and
// routing kernels (geglu_ff.cu): mbarriers, named
// barriers, TMA tensor maps, loads and stores, the warpgroup matrix product
// (wgmma) with its fences, shared-memory matrix descriptors (K-major and
// MN-major), register rebalancing between warpgroups, and the fixed-order
// reduction that finishes a convolution or the FF's output product whose
// depth was split over several blocks.
//
// The kernels are warp-specialised: a producer warpgroup fills rings of
// shared-memory tiles (one thread issues TMA loads that complete on an
// mbarrier; the other producer warps prepare the activation operand), and
// one or two consumer warpgroups wait on the "full" barriers, issue
// wgmma.mma_async on the tiles and arrive on the "empty" barriers. The
// k-th use of a ring slot waits its full barrier with parity k & 1 and its
// empty barrier with parity (k & 1) ^ 1, so the first fill passes at once.
//
// Tensor maps are encoded on the host in the launchers, through the entry
// point of cuTensorMapEncodeTiled that the CUDA runtime hands out (no link
// against libcuda), kept by their arguments for the next launch, and passed
// by value as __grid_constant__ kernel parameters.
#pragma once

#include <cuda.h>

#include <cstring>
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the TMA unit (async proxy)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// spins until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma reading through a descriptor), before the barrier that
// hands the tile over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A slot of a ring of `n` stages and the parity of its current use.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int n) {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ------------------------------------------------------------------ TMA
// one box of a 2-D / 3-D / 4-D tensor map into shared memory, completing on
// `bar`; coordinates innermost first, signed, zeros outside the tensor
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of shared memory into a 2-D / 4-D tensor map (coordinates
// innermost first; what falls outside the tensor is not written), as one
// bulk group of the issuing thread
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the issuing thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the issuing thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------ named barriers
// `count` threads (a multiple of 32) meet at barrier `id` (1-15; 0 is
// __syncthreads); arrive does not wait
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Host side: a bf16 tensor map of `rank` dimensions (innermost first; its
// elements contiguous), `strides` in bytes for dimensions 1.., each a
// multiple of 16. Returns false if the encoding is refused. A map is a pure
// function of these arguments, and the caching allocator hands a UNet call
// the same buffers step after step, so the maps encoded before are kept by
// their arguments and a repeat costs a hash and a comparison instead of an
// encode (the launchers' host time); the table is emptied when it reaches
// MAP_CACHE entries.
struct MapKey {
  const void* base;
  uint64_t dims[5], strides[4];
  uint32_t box[5], rank, swizzle, pad;
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
    uint64_t h = 1469598103934665603ull;                 // FNV-1a
    for (size_t i = 0; i < sizeof(MapKey); ++i) h = (h ^ p[i]) * 1099511628211ull;
    return static_cast<size_t>(h);
  }
};
struct MapKeyEq {
  bool operator()(const MapKey& a, const MapKey& b) const {
    return std::memcmp(&a, &b, sizeof(MapKey)) == 0;
  }
};
struct MapBits {
  uint64_t w[sizeof(CUtensorMap) / 8];
};
constexpr size_t MAP_CACHE = 4096;

inline bool encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                            const uint64_t* dims, const uint64_t* strides,
                            const uint32_t* box, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  MapKey key;
  std::memset(&key, 0, sizeof(key));   // padding included: keys compare whole
  key.base = base;
  key.rank = static_cast<uint32_t>(rank);
  key.swizzle = static_cast<uint32_t>(swizzle);
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i > 0) key.strides[i - 1] = strides[i - 1];
  }
  static std::mutex lock;
  static std::unordered_map<MapKey, MapBits, MapKeyHash, MapKeyEq> cache;
  static Encode encode = nullptr;
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    std::memcpy(map, &hit->second, sizeof(CUtensorMap));
    return true;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  cuuint64_t gdims[5], gstrides[4];
  cuuint32_t gbox[5], estrides[5];
  for (int i = 0; i < rank; ++i) {
    gdims[i] = dims[i];
    gbox[i] = box[i];
    estrides[i] = 1;
    if (i > 0) gstrides[i - 1] = strides[i - 1];
  }
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), gdims, gstrides, gbox, estrides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= MAP_CACHE) cache.clear();
  MapBits bits;
  std::memcpy(&bits, map, sizeof(CUtensorMap));
  cache.emplace(key, bits);
  return true;
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N of the newest committed groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Descriptor of a K-major operand tile in shared memory: rows of ROW_BYTES
// (128 or 64: 64 or 32 bf16 of depth) in the matching TMA swizzle, 8-row
// groups ROW_BYTES * 8 apart; the tile starts on a multiple of that. A depth
// step of 16 bf16 inside the row advances the descriptor by 32 bytes (+2).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "128B or 64B swizzle");
  uint64_t d = (smem_u32(tile) & 0x3FFFFu) >> 4;
  d |= 1ull << 16;                                   // LBO: unused when swizzled
  d |= static_cast<uint64_t>((ROW_BYTES * 8) >> 4) << 32;   // SBO
  d |= (ROW_BYTES == 128 ? 1ull : 2ull) << 62;       // swizzle mode
  return d;
}

// Descriptor of an MN-major operand tile (B of wgmma with its transpose
// bit set) in the TMA's swizzle of ROW_BYTES (128 or 64): rows of depth
// ROW_BYTES apart, each ROW_BYTES / 2 bf16 of the N dimension; the next
// ROW_BYTES / 2 of N start `lbo_bytes` further on (the next column chunk),
// the next 8 of depth 8 rows further on. A depth step of 16 advances the
// start by 16 rows.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile,
                                                 uint32_t lbo_bytes) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "128B or 64B swizzle");
  uint64_t d = (smem_u32(tile) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>(lbo_bytes >> 4) << 16;           // LBO: next N chunk
  d |= static_cast<uint64_t>((ROW_BYTES * 8) >> 4) << 32;     // SBO: next 8 of depth
  d |= (ROW_BYTES == 128 ? 1ull : 2ull) << 62;                // swizzle mode
  return d;
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence (CUTLASS's
// warpgroup_fence_operand): put it after wgmma_wait and before the issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(r[i]);
}

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 b16 matrices from shared memory (addresses in the shared
// window): lane l gives the address of row l % 8 of matrix l / 8. With lanes
// 0-15 on rows 0-15 at depth 0 and lanes 16-31 on the same rows at depth 8,
// the four registers are a warp's 16 x 16 A fragment of wgmma (and mma.sync).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (64 x 160 f32, this warpgroup's) += a (64 x 16 bf16 in registers: warp w
// holds rows 16w..16w+15) * b^T (160 x 16 bf16 through its descriptor).
// Thread (warp w, lane 4g + t) holds d[4j + {0,1}] = row 16w + g, columns
// 8j + 2t + {0,1} and d[4j + {2,3}] = row 16w + g + 8, the same columns.
__device__ __forceinline__ void wgmma_m64n160k16_rs(float (&d)[80],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// d (64 x 64 f32) = [d +] a (64 x 16 bf16) * b^T (64 x 16 bf16), both through
// descriptors; `accumulate` false starts d afresh (no zeroing pass). The
// thread layout of d is that of the 160-wide product.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t a_desc,
                                                   uint64_t b_desc,
                                                   bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate ? 1 : 0));
}

// The attention kernels' products. wgmma_ss: d (64 x N f32) = [d +] a (64 x
// 16 bf16) * b^T (N x 16 bf16), both K-major through descriptors, N = 128,
// 80 or 64 by the size of d (160 below). wgmma_rs_mn: d (64 x N f32) += a (64 x 16 bf16 in
// registers, the layout of wgmma_m64n160k16_rs) * b (16 x N bf16, MN-major
// through its descriptor), N = 40, 64, 80 or 160 by the size of d. The thread
// layout of d is that of the 160-wide product above.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a_desc,
                                         uint64_t b_desc, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate ? 1 : 0));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t a_desc,
                                         uint64_t b_desc, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate ? 1 : 0));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[20],
                                            const uint32_t (&a)[4],
                                            uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[80],
                                            const uint32_t (&a)[4],
                                            uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a_desc,
                                         uint64_t b_desc, bool accumulate) {
  wgmma_m64n64k16_ss(d, a_desc, b_desc, accumulate);
}

// d (64 x 160 f32) = [d +] a (64 x 16 bf16) * b^T (160 x 16 bf16), both
// K-major through descriptors (the fused FF's output projection).
__device__ __forceinline__ void wgmma_ss(float (&d)[80], uint64_t a_desc,
                                         uint64_t b_desc, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate ? 1 : 0));
}

// The dynamic shared memory of a block, from its first multiple of 1024
// bytes (swizzled tiles start on multiples of their 8-row group); launchers
// ask for 1024 bytes more than they lay out.
__device__ __forceinline__ unsigned char* smem_base_1024(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024u - (a & 1023u)) & 1023u);
}

// ------------------------------------------------- finishing a split depth
// y = round(sum over s of partial[s]) (+ add) (+ resid): the f32 partial sums
// of `nsplit` blocks, each (m, cout) with m = batch * hw pixels in
// channels-last order (or m rows), added in the order s = 0, 1, ...
// whatever order the blocks ran in, then the epilogue in the kernels'
// rounding order: the sum to bf16, + add in bf16 (row pixel / hw of `add`,
// or its only row when add_stride is 0; with add_f32, added to the f32 sum
// before the rounding instead), + resid in bf16. One thread takes 8
// channels.
static __global__ void __launch_bounds__(256) split_finish_kernel(
    const float* __restrict__ partial, int nsplit, int m, int hw, int cout,
    const bf16* __restrict__ add, int add_stride, int add_f32,
    const bf16* __restrict__ resid, bf16* __restrict__ y) {
  const int groups = cout >> 3;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)m * groups) return;
  const int pix = static_cast<int>(i / groups);
  const int co = static_cast<int>(i - (long long)pix * groups) << 3;
  const size_t off = (size_t)pix * cout + co;
  const size_t plane = (size_t)m * cout;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float4 lo = *reinterpret_cast<const float4*>(partial + s * plane + off);
    const float4 hi =
        *reinterpret_cast<const float4*>(partial + s * plane + off + 4);
    acc[0] += lo.x; acc[1] += lo.y; acc[2] += lo.z; acc[3] += lo.w;
    acc[4] += hi.x; acc[5] += hi.y; acc[6] += hi.z; acc[7] += hi.w;
  }
  alignas(16) bf16 a8[8], r8[8], out[8];
  if (add != nullptr)
    *reinterpret_cast<uint4*>(a8) = *reinterpret_cast<const uint4*>(
        add + (size_t)(pix / hw) * add_stride + co);
  if (resid != nullptr)
    *reinterpret_cast<uint4*>(r8) = *reinterpret_cast<const uint4*>(resid + off);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    bf16 v;
    if (add != nullptr && add_f32) {
      v = f2bf(acc[q] + bf2f(a8[q]));
    } else {
      v = f2bf(acc[q]);
      if (add != nullptr) v = f2bf(bf2f(v) + bf2f(a8[q]));
    }
    if (resid != nullptr) v = f2bf(bf2f(v) + bf2f(r8[q]));
    out[q] = v;
  }
  *reinterpret_cast<uint4*>(y + off) = *reinterpret_cast<const uint4*>(out);
}

inline void launch_split_finish(const float* partial, int nsplit, int m, int hw,
                                int cout, const bf16* add, int add_stride,
                                const bf16* resid, bf16* y,
                                cudaStream_t stream, bool add_f32 = false) {
  const long long items = (long long)m * (cout / 8);
  split_finish_kernel<<<static_cast<unsigned>((items + 255) / 256), 256, 0,
                        stream>>>(partial, nsplit, m, hw, cout, add, add_stride,
                                  add_f32 ? 1 : 0, resid, y);
}

// The epilogue's value for two neighbouring channels from registers, in the
// kernels' rounding order: v to bf16, + add in bf16, + resid in bf16.
__device__ __forceinline__ __nv_bfloat162 finish2(float v0, float v1,
                                                  const bf16* add,
                                                  const bf16* resid) {
  bf16 a = f2bf(v0), b = f2bf(v1);
  if (add != nullptr) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(add);
    a = f2bf(bf2f(a) + bf2f(t.x));
    b = f2bf(bf2f(b) + bf2f(t.y));
  }
  if (resid != nullptr) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(resid);
    a = f2bf(bf2f(a) + bf2f(t.x));
    b = f2bf(bf2f(b) + bf2f(t.y));
  }
  __nv_bfloat162 out;
  out.x = a;
  out.y = b;
  return out;
}

}  // namespace wg
