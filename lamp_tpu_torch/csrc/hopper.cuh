// Hopper (sm_90a) building blocks in raw PTX: mbarriers, cp.async tracked
// by mbarriers, thread-block clusters, TMA tensor loads,
// warpgroup matrix multiplies (wgmma, bf16 or f16 inputs, f32 accumulators)
// on swizzled shared-memory tiles, register reallocation between
// warpgroups, and the host-side encoding of TMA tensor maps. Included by
// the kernels that use them.
//
// Tile layout. A 16-bit tile of R rows by D columns lies in shared memory as
// column blocks of [R][W / 2], each row W bytes, where W is the swizzle:
// 128 bytes (64 columns) for D a multiple of 64, 64 bytes (32 columns) for
// D = 32. TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B (or _64B): in every
// atom of 8 rows (1024 or 512 bytes), the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8) (128B), or c ^ ((r / 2) % 4) (64B). Each column block
// starts on a 1024-byte boundary. wgmma reads such a tile through a matrix
// descriptor (layout type 1 for the 128-byte swizzle, 2 for 64):
//  - K-major (the product's depth runs along the row, as for A = Q and
//    B = K in S = Q K^T): the 16-column slice kk starts at column block
//    kk / (W / 32), byte (kk % (W / 32)) * 32 of the row; 8-row groups lie
//    8 W bytes apart (SBO); the leading offset is unused.
//  - MN-major (the depth runs down the rows, as for B = K in dQ = dS K):
//    the 16-row slice kk starts 16 W bytes further down; 8-row groups lie
//    8 W bytes apart (SBO) and the column blocks R W bytes apart (LBO); the
//    instruction's transpose bit is set.
//
// Register fragments. An m64nN f32 accumulator is N / 2 floats a thread:
// in the warpgroup, warp w owns rows 16w..16w+15; lane 4g + t holds, for
// every 8-column chunk j, d[4j], d[4j+1] at row 16w + g, columns 8j + 2t,
// 8j + 2t + 1, and d[4j+2], d[4j+3] at row 16w + g + 8. A register A
// operand of m64nNk16 (64 rows by 16 of depth) is four 32-bit registers of
// 16-bit pairs: (row g, k 2t), (row g + 8, k 2t), (row g, k 2t + 8), (row
// g + 8, k 2t + 8). So the accumulator columns 16kk..16kk+15 become the A
// operand of depth slice kk by packing d[8kk..8kk+7] in pairs (acc_to_a).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive, and expect `bytes` more from TMA loads before the phase completes
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed
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

// ---------------------------------------------------------------------------
// cp.async (non-bulk): 16 bytes by .cg, 8 or 4 bytes by .ca; src-size 0
// zero-fills the destination without reading. An mbarrier can track a
// thread's copies (cp_async_arrive_noinc); wgmma reads what they wrote only
// after fence_proxy_async (they write through the generic proxy, wgmma
// reads through the async proxy).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}

// an arrival on `bar` once every cp.async this thread issued before has
// landed; it counts toward the barrier's expected arrivals (.noinc)
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// orders this thread's view of shared memory written through the generic
// proxy (cp.async, st.shared) before its later async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// thread-block clusters: a split barrier (an arrival that lets the block go
// on, later a wait for every block's arrival), another block's shared
// memory (mapa), and stores into it that complete on that block's mbarrier
// (st.async): distributed shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the address of shared memory `addr` of this block in cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into the shared memory of another block of the cluster,
// completing 16 bytes on that block's mbarrier `bar` (both mapped)
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA: one box of a 3-D tensor map (column c0, row c1, slab c2) into shared
// memory, completing on `bar`; elements past the tensor's edges read 0
// ---------------------------------------------------------------------------

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

// one box of a 2-D tensor map (column c0, row c1) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// register reallocation between the producer and consumer warpgroups
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a W-byte-swizzled shared-memory matrix (W = 128 or 64; see
// the header)
template <int W>
__device__ __forceinline__ uint64_t sw_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  static_assert(W == 128 || W == 64, "128- or 64-byte swizzle");
  constexpr uint64_t layout = W == 128 ? 1 : 2;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// depth slice kk of a K-major tile of R rows in column blocks of W bytes
template <int R, int W = 128>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk) {
  constexpr int kSlices = W / 32;  // 16-column slices a column block holds
  return sw_desc<W>(tile + (kk / kSlices) * R * W + (kk % kSlices) * 32, 16,
                    8 * W);
}

// depth slice kk (rows 16kk..16kk+15) of an MN-major tile of R rows in
// column blocks of W bytes
template <int R, int W = 128>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int kk) {
  return sw_desc<W>(tile + kk * 16 * W, R * W, 8 * W);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across the wait that ends it
template <int R>
__device__ __forceinline__ void wg_keep(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void wg_keep(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// two floats rounded to a pair of T (bf16 or f16), as one 32-bit register
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// a pair of T as two floats
template <typename T>
__device__ __forceinline__ float2 unpack2(T a, T b) {
  if constexpr (std::is_same<T, __half>::value)
    return make_float2(__half2float(a), __half2float(b));
  else
    return make_float2(__bfloat162float(a), __bfloat162float(b));
}

// an m64nN accumulator as the register A operands of N / 16 depth slices
template <int N, typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4],
                                         const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<T>(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// The accumulator operands of m64nN: N / 2 floats, "+f"(d[i]) each.
#define LAMP_ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define LAMP_ACC16 LAMP_ACC8(0), LAMP_ACC8(8)
#define LAMP_ACC32 LAMP_ACC16, LAMP_ACC8(16), LAMP_ACC8(24)
#define LAMP_ACC64 \
  LAMP_ACC32, LAMP_ACC8(32), LAMP_ACC8(40), LAMP_ACC8(48), LAMP_ACC8(56)
#define LAMP_ACC96 \
  LAMP_ACC64, LAMP_ACC8(64), LAMP_ACC8(72), LAMP_ACC8(80), LAMP_ACC8(88)
#define LAMP_ACC128 \
  LAMP_ACC96, LAMP_ACC8(96), LAMP_ACC8(104), LAMP_ACC8(112), LAMP_ACC8(120)
// their places in the instruction's text
#define LAMP_R16                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define LAMP_R32                                                         \
  LAMP_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "  \
           "%27, %28, %29, %30, %31"
#define LAMP_R64                                                         \
  LAMP_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
           "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
           "%55, %56, %57, %58, %59, %60, %61, %62, %63"
#define LAMP_R96                                                         \
  LAMP_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "  \
           "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
           "%87, %88, %89, %90, %91, %92, %93, %94, %95"
#define LAMP_R128                                                        \
  LAMP_R96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "  \
           "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
           "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
           "%126, %127"

// D = (scale_d ? D : 0) + A B, both from shared memory, K-major; TY is the
// inputs' type (bf16 or f16), A and B the operands after the accumulator
#define LAMP_WGMMA_SS(N, TY, REGS, ACC, A, B, P)                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " {" REGS "}, %" A ", %" B ", p, 1, 1, 0, 0;\n}\n"          \
               : ACC                                                      \
               : "l"(a), "l"(b), "r"(scale_d))
// D += A B, A from registers, B from shared memory, MN-major
#define LAMP_WGMMA_RS(N, TY, REGS, ACC, A0, B, P)                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " {" REGS "}, {%" A0 "}, %" B ", p, 1, 1, 1;\n}\n"          \
               : ACC                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// D (m64nN, f32) = (scale_d ? D : 0) + A B, A and B of type T (bf16 or
// f16) in shared memory, both K-major (N = 32, 64, 128)
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  static_assert(N == 32 || N == 64 || N == 128, "m64nNk16, N = 32, 64, 128");
  if constexpr (N == 32) {
    if constexpr (f16) LAMP_WGMMA_SS(32, "f16", LAMP_R16, LAMP_ACC16, "16", "17", "18");
    else LAMP_WGMMA_SS(32, "bf16", LAMP_R16, LAMP_ACC16, "16", "17", "18");
  } else if constexpr (N == 64) {
    if constexpr (f16) LAMP_WGMMA_SS(64, "f16", LAMP_R32, LAMP_ACC32, "32", "33", "34");
    else LAMP_WGMMA_SS(64, "bf16", LAMP_R32, LAMP_ACC32, "32", "33", "34");
  } else {
    if constexpr (f16) LAMP_WGMMA_SS(128, "f16", LAMP_R64, LAMP_ACC64, "64", "65", "66");
    else LAMP_WGMMA_SS(128, "bf16", LAMP_R64, LAMP_ACC64, "64", "65", "66");
  }
}

// D (m64nN, f32) += A B, A of type T in registers, B in shared memory,
// MN-major (N = 32, 64, 128, 192, 256: B's N columns span N / 64 column
// blocks of a 128-byte-swizzled tile, LBO apart)
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  static_assert(N == 32 || N == 64 || N == 128 || N == 192 || N == 256,
                "m64nNk16, N = 32, 64, 128, 192, 256");
  if constexpr (N == 32) {
    if constexpr (f16) LAMP_WGMMA_RS(32, "f16", LAMP_R16, LAMP_ACC16, "16, %17, %18, %19", "20", "21");
    else LAMP_WGMMA_RS(32, "bf16", LAMP_R16, LAMP_ACC16, "16, %17, %18, %19", "20", "21");
  } else if constexpr (N == 64) {
    if constexpr (f16) LAMP_WGMMA_RS(64, "f16", LAMP_R32, LAMP_ACC32, "32, %33, %34, %35", "36", "37");
    else LAMP_WGMMA_RS(64, "bf16", LAMP_R32, LAMP_ACC32, "32, %33, %34, %35", "36", "37");
  } else if constexpr (N == 128) {
    if constexpr (f16) LAMP_WGMMA_RS(128, "f16", LAMP_R64, LAMP_ACC64, "64, %65, %66, %67", "68", "69");
    else LAMP_WGMMA_RS(128, "bf16", LAMP_R64, LAMP_ACC64, "64, %65, %66, %67", "68", "69");
  } else if constexpr (N == 192) {
    if constexpr (f16) LAMP_WGMMA_RS(192, "f16", LAMP_R96, LAMP_ACC96, "96, %97, %98, %99", "100", "101");
    else LAMP_WGMMA_RS(192, "bf16", LAMP_R96, LAMP_ACC96, "96, %97, %98, %99", "100", "101");
  } else {
    if constexpr (f16) LAMP_WGMMA_RS(256, "f16", LAMP_R128, LAMP_ACC128, "128, %129, %130, %131", "132", "133");
    else LAMP_WGMMA_RS(256, "bf16", LAMP_R128, LAMP_ACC128, "128, %129, %130, %131", "132", "133");
  }
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps, encoded by libcuda's cuTensorMapEncodeTiled,
// fetched through the runtime so that nothing links libcuda. The encoder
// needs the device's context current on the calling thread.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// what tile_map returns when libcuda's encoder was not found
constexpr int kNoEncoder = -1;

// encodes the map of a contiguous [slabs, rows, cols] tensor of T (bf16 or
// f16) read in boxes of box_rows x W / 2 columns, W-byte swizzled (W = 128
// or 64); reads past an edge give 0, also where a box is wider than the
// tensor's rows. Returns 0, libcuda's CUresult, or kNoEncoder.
template <typename T, int W>
int tile_map(CUtensorMap* map, const void* base, int slabs, int rows,
             int cols, int box_rows) {
  static_assert(W == 128 || W == 64, "128- or 64-byte swizzle");
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {W / 2, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(encode(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// the map's element type of a 1-, 2-, 4- or 8-byte type (1 byte: fp8 as
// bytes)
template <typename X>
constexpr CUtensorMapDataType map_type() {
  if constexpr (sizeof(X) == 1) return CU_TENSOR_MAP_DATA_TYPE_UINT8;
  else if constexpr (std::is_same<X, __half>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  else if constexpr (std::is_same<X, __nv_bfloat16>::value) return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  else if constexpr (std::is_same<X, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else return CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
}

// encodes the map of a [rows, cols] matrix of elements of `type` whose rows
// lie `stride` bytes apart (a multiple of 16), read in boxes of box_rows x
// box_cols (box_cols times the element a multiple of 16 bytes), unswizzled
// or swizzled (a box row then at most the swizzle's span); reads past an
// edge give 0. Returns 0, libcuda's CUresult, or kNoEncoder.
inline int row_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                   long long rows, int cols, long long stride, int box_rows,
                   int box_cols,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return static_cast<int>(encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace hopper
