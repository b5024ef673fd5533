// Paged decode attention for Hopper (sm_90a).
//
// Replaces lamp_tpu/ops/paged_attention.py:_paged_kernel (the Pallas TPU
// kernel). One query token per sequence attends over its KV history, which
// lives in fixed-size pages of a shared pool, addressed through a page table.
//
// What bounds it: KV bytes read. One decode step reads, per layer,
// B x live tokens x 2 (K and V) x F x 2 bytes (bf16, F = H_kv * D) and does
// only ~2 * q_per_kv FLOPs per byte, far below the card's ~295 FLOP/byte
// ridge. The design therefore reads each K/V row from device memory exactly
// once per kv head, not once per query head: a block owns one (sequence,
// kv head) pair and scores every query head of the GQA group against each
// row it loads.
//
// fp8 pools (float8_e4m3fn or float8_e5m2, with a float32, bfloat16 or
// float16 q) halve those bytes against 16-bit pools. The kernels are
// templated on the pool's type, and every value converts to f32 exactly
// (each fp8 value is exact in bf16), which is the TPU kernel's upcast
// before its dots. q, the append rows and the output stay in q's dtype.
//
// Layout (the JAX package's, unchanged):
//   q          [B, H, D]
//   K/V pool   row (page p, slot s, kv head g) at p*page_stride + s*F + g*D;
//              the fused pool [P, 2, page, F] passes V = K + page*F and
//              page_stride = 2*page*F, split pools page_stride = page*F
//   page_table [B, pages_per_seq] int32, lengths [B] int32
//   windows    [B] int32 per-request limits (<= 0: none), or null
//   new_k/new_v [B, F] current token's K/V (append mode), or null
//   out        [B, H, D] in q's dtype
//   (q, new_k, new_v and out share one dtype T; the pools have type KV,
//   which is T or an fp8 type)
//
// Two kernels compute the same function.
//
// paged_attention_fixed<T, KV, D, MMA>, for D = 64 or 128, at most 8 query
// heads a kv head and pages of a multiple of 16 tokens (the serving slice's
// decode: 12 / 4 heads of 64, bf16 or fp8 pools). What held the kernel it
// replaces (one block of 128 threads a (sequence, kv head), 128 blocks on
// 132 SMs) at ~10x its byte bound, and what this one does about each:
//  1. A chain of dependent round trips a tile (the length, then the page,
//     then the K row; V only after the scores), V read 4 bytes at a time.
//     Here a tile is a box of 16 keys: one TMA load of their K rows and one
//     of their V rows (a 2-D map of the pool's rows, [rows, CW bytes] boxes
//     of the head's columns, swizzled over CW = 128 or 64 bytes), both
//     completing on one mbarrier. Each warp walks its own boxes through a
//     ring of its own (8 KB: up to 4 slots), issued by its lane 0 as a slot
//     frees, so a warp never waits on another. The length, the request's
//     window and the pages of a warp's first boxes are read in one round
//     trip, and the boxes go out as soon as the length says which hold a
//     key of the band (kFixSpec > 0 would put a warp's first boxes in
//     flight before, when no window is set; boxes past the length cost more
//     than the wait they save). The maps hold the pool's rows (the caller's
//     total_pages), and a box is kept inside them: a garbage page id reads
//     pool rows, which are masked.
//  2. Too few blocks, and every block walking its tiles in turn: the keys
//     are split (flash-decoding) over P parts of one (sequence, kv head):
//     the caller's plan (ops/paged_attention.py:_paged_plan, from shapes
//     alone: 2 splits at the serving decode) asks for 4 parts a split, and
//     they are the 8 warps of one block, or of a thread-block cluster of
//     ranks past 8 parts. Part p = r + ranks w (warp w of rank r) walks the
//     band's boxes p, p + P, ... counted from the band's first, so a
//     one-page decode call spreads over every warp. Each part's partial (m,
//     l, o) goes to the rank that owns the head (by st.async into its
//     shared memory, completing on its mbarrier, in a cluster), which adds
//     the parts in (rank, warp) order: one launch, no atomics, no
//     workspace, two calls bit for bit.
//  3. Scalar FMAs from registers. 16-bit q (MMA): a box's products on
//     mma.sync m16n8k16 with the group's heads as n = 8: S = K q^T (K rows
//     by ldmatrix, q's fragments in registers), an online softmax per warp
//     in the log2 domain, P rounded to q's type (the plain version's
//     p.to(v.dtype)) and moved into the B operand by movmatrix.trans, O =
//     V^T P (V by ldmatrix.trans). fp8 rows are converted to q's type in
//     registers (exact); V's pairs are transposed by movmatrix, which
//     permutes the output columns a thread holds (undone at the record).
//     f32 q (held to 1e-4: no TF32) keeps FFMA: a lane scores one key over
//     half its row by 16-byte reads, then owns D / 32 output columns.
// The append column's score and V row are read while the boxes are in
// flight. V rows outside the band read as 0 in the products, so garbage
// rows of a box cannot turn p = 0 into a NaN.
//
// paged_attention_any<T, KV, A>, for every other head dim (any D, also
// odd), group (any number of query heads per kv head) and float64 (A, the
// accumulators' type, is double there and f32 otherwise). What held its
// first design at a third of the byte bound (OpenLLaMA-3B's layer, B=32,
// 32 / 32 heads of 100) and far below it with few kv heads (MQA 32/1: 32
// blocks on 132 SMs), and what this one does about each:
//  1. Too few blocks with few kv heads: the grid was B x H_kv. Here the
//     keys are split over the blocks of a thread-block cluster
//     (flash-decoding): rank r of `splits` (<= 8) walks the pages [r per,
//     (r + 1) per) of the sequence; a rank whose pages lie past lengths[b]
//     or outside the window band walks nothing and gives an empty partial
//     (m = -inf, l = 0). The plan (splits) is the caller's, from shapes
//     alone (ops/paged_attention.py:_paged_plan; lengths are never read on
//     the host, so a step can be captured in a CUDA graph). The partials
//     are added inside the cluster, as int4_matmul.cu's decode kernel adds
//     its split-K partials: rank r owns the heads [r hs, (r + 1) hs); each
//     rank sends the records (m, l, o) of each owner's heads by st.async
//     into the owner's shared memory, completing on the owner's mbarrier,
//     and the owner adds them in rank order. One launch, no workspace, no
//     atomics: two calls give the same bits.
//  2. Copies a block could not keep in flight (stage, barrier, score,
//     barrier, softmax, stage V, barrier, accumulate; 4-byte cp.async of
//     each word). Here each tile of tt tokens (64; 32 or 16 where the rows
//     are wide) goes into a ring of `stages`, on the stage's mbarrier.
//     Where the pool's rows (F elements) lie a multiple of 16 bytes apart
//     and the head's units are whole, one thread loads a tile's K and V
//     rows by TMA: a 2-D map of the pool's rows (encoded once for a pool
//     and kept), boxes of kBoxRows rows (or of a page's, when smaller) by
//     the head's columns, only those that hold a key of the band (a short
//     decode's last tile then reads about its keys, not the whole tile),
//     from the 16-byte boundary at or below the head's columns (a box's
//     start must be 16-byte aligned: one of 200 bytes at 200-byte offsets
//     faulted), the head then (g D sz & 15) bytes into each box row; tiles
//     start at tile boundaries of the sequence, the tokens below the band
//     masked; a tile's V boxes go out once it is scored, into its K rows'
//     place, in flight under the softmax (half the shared memory, so an SM
//     holds twice the blocks: a short decode's 1024 blocks then run in one
//     wave). Elsewhere every thread
//     copies pieces as wide as the rows' alignment allows by cp.async
//     (from 4 bytes), arriving by cp.async.mbarrier.arrive.noinc, or 2 or
//     1 bytes at a time at an odd D. A cp.async piece costs an H100 about
//     the same whatever its width, so the copies of 200-byte rows in 8-byte
//     pieces held the MHA layer at ~2 TB/s (PERF.md §6): TMA moves
//     them at less cost. The page table is read for a tile `stages` tiles
//     ahead. The ring is one stage unless a tile's products
//     are long (the plan): a second and third stage cost more in blocks an
//     SM holds than their overlap gains, and the blocks an SM holds
//     overlap each other's copies and products (PERF.md §6).
//  3. Idle threads on small groups (one thread a (head, token) score, one
//     a (head, column) output), and scalar reads from shared memory. Here
//     a block is 8 warps (4 for one f32 query head a kv head); a thread reads a staged row a unit at a time
//     (the row's alignment: 8 bf16 values of a head of 128, 4 of one of
//     100), scores it against up to 4 query heads at once, and a score's
//     dot product is split over ds lanes (interleaved units, summed by
//     shuffles) until the block's threads are busy; the output's (head,
//     unit of columns) products are split over sb subsets of the tile's
//     tokens, whose sums are added in order at the end, two tokens in
//     flight a thread. Staged rows are padded to an odd number of their
//     pieces, so that the rows a warp reads at one unit fall in different
//     banks.
// Everything that grows with D or the group lies in dynamic shared memory
// (opted in above 48 KB): the stages, q, the tile's scores, each head's
// record (m, l, and the output columns, per token subset) and the cluster
// sum's slots. A block computes up to 256 output columns (more are split
// over blockIdx.z, and each part reads the K rows again) and the query
// heads of the group that fit in 227 KB (a larger group is split over
// blockIdx.z too): the tile and the heads a pass are the host's plan
// (any_plan), fewest passes first, then the largest tile.
// Rows with no valid key (length 0 and no append) give exactly 0.
//
// Not carried over from the TPU kernel: grouping G sequences per grid cell,
// single_pass, the cross-cell DMA parity counter and pages_per_block were
// devices for the TPU's sequential grid and its MXU; offsets are int64
// because (page_offset + page) * page_stride passes 2^31 elements at serving
// pool sizes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kMaxQ = 8;  // query heads a kv head of paged_attention_fixed
constexpr int kNoWindow = 0x3FFFFFFF;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }
// fp8 pools: every e4m3 and e5m2 value converts to f32 exactly
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// paged_attention_fixed: head_dim 64 or 128, at most kMaxQ query heads a kv
// head, pages of a multiple of kFixBox tokens (see the header)
// ---------------------------------------------------------------------------

constexpr int kFixWarps = 8;          // a block's warps
constexpr int kFixSplitWarps = 4;     // parts (warps) a split of the plan asks for
constexpr int kFixBox = 16;           // keys a box: 16 rows of K, 16 of V
constexpr int kFixRing = 8 * 1024;    // bytes of a warp's ring of boxes
constexpr int kFixMaxSlots = 4;
// boxes a warp reads before the length is known (when no window is set):
// none, since the pages come in the length's round trip anyway and a box
// past the length costs DRAM reads (PERF.md §6)
constexpr int kFixSpec = 0;

// A ring slot holds one box of K rows, then one of V rows. A row's D sz
// bytes lie as NC column blocks of [kFixBox][CW] bytes, each written by one
// TMA box swizzled over CW (128 or 64) bytes: the 16-byte chunk c of row r
// at c ^ (r % 8) (CW = 128) or c ^ ((r / 2) % 4) (CW = 64), so that the
// rows a warp reads at one chunk fall in different banks.
template <typename KV, int D>
struct FixShape {
  static constexpr int RB = D * static_cast<int>(sizeof(KV));  // 64 to 512
  static constexpr int CW = RB < 128 ? RB : 128;
  static constexpr int NC = RB / CW;
  static constexpr int BOX = kFixBox * CW;  // a TMA box's bytes
  static constexpr int HALF = NC * BOX;     // a box's 16 rows of K (or V)
  static constexpr int SLOT = 2 * HALF;
  static constexpr int SLOTS = kFixRing / SLOT < 1 ? 1
                               : kFixRing / SLOT > kFixMaxSlots ? kFixMaxSlots
                                                                : kFixRing / SLOT;
  static constexpr int REC = D + 4;  // a head's record: m, l, 2 unused, o[D]
  // the byte of a slot's half that holds byte c of staged row r
  __device__ static __forceinline__ int at(int r, int c) {
    const int cw = c % CW;
    const int sw = CW == 128 ? (r & 7) : ((r >> 1) & 3);
    return (c / CW) * BOX + r * CW + (((cw >> 4) ^ sw) << 4) + (cw & 15);
  }
};

// What a launch of paged_attention_fixed needs beside its pointers, from
// the host (launch_fixed)
struct FixPlan {
  int ranks;   // cluster ranks over a sequence's keys
  int hs;      // query heads each rank owns in the cluster's sum
  int rows;    // the maps' rows (the pool's): boxes are kept inside
  int o_bar, o_recv, o_w, o_q, o_p, smem;  // dynamic shared memory
};

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// mma.sync m16n8k16, 16-bit operands, f32 accumulators. In a warp, lane =
// 4 gq + tq. A (16 x 16) holds rows gq and gq + 8, columns 2tq, 2tq + 1,
// 2tq + 8, 2tq + 9; B (16 x 8) rows 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of
// column gq; C (16 x 8) rows gq (c[0], c[1]) and gq + 8 (c[2], c[3]) at
// columns 2tq and 2tq + 1.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// an 8 x 8 matrix of 16-bit values transposed across the warp: lane 4g + t
// holds row g's columns 2t, 2t + 1, and gets column g's rows 2t, 2t + 1
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// 2^x by the SFU (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two fp8 values in x's low 16 bits (the first in the low byte) as a
// pair of T (bf16 or f16), exactly
template <typename T, typename KV>
__device__ __forceinline__ uint32_t fp8x2(uint32_t x) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x & 0xffffu),
      std::is_same<KV, __nv_fp8_e4m3>::value ? __NV_E4M3 : __NV_E5M2);
  if constexpr (std::is_same<T, __half>::value) {
    return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
  } else {
    const float2 f = __half22float2(__half2(h));
    return hopper::pack2<T>(f.x, f.y);
  }
}

// p as the output's type would round it (the plain version's p.to(v.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16(p));
  else if constexpr (std::is_same<T, __half>::value)
    return __half2float(__float2half(p));
  else
    return p;
}

// C consecutive values of a staged row (C sz bytes, within one 16-byte
// chunk) as floats
template <typename KV, int C>
__device__ __forceinline__ void load_cols(const unsigned char* p, float (&x)[C]) {
  constexpr int bytes = C * static_cast<int>(sizeof(KV));
  union {
    uint4 v4;
    uint2 v2;
    uint32_t v1;
    unsigned short s;
  } raw;
  if constexpr (bytes == 16) raw.v4 = *reinterpret_cast<const uint4*>(p);
  else if constexpr (bytes == 8) raw.v2 = *reinterpret_cast<const uint2*>(p);
  else if constexpr (bytes == 4) raw.v1 = *reinterpret_cast<const uint32_t*>(p);
  else raw.s = *reinterpret_cast<const unsigned short*>(p);
  const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int i = 0; i < C; ++i) x[i] = to_float(e[i]);
}

// grid = ranks x B x H_kv, clusters of `ranks` blocks along x, kFixWarps
// warps a block: P = ranks x kFixWarps parts of one (sequence, kv head).
// Part p = r + ranks w (warp w of rank r) walks the band's boxes p, p + P,
// p + 2P, ... (counted from the band's first), each into the next slot of
// the warp's own ring, with its own online softmax. MMA: the products on
// mma.sync (16-bit q); else FFMA. The parts are summed in (rank, warp)
// order.
template <typename T, typename KV, int D, bool MMA>
__global__ void __launch_bounds__(kFixWarps * 32)
paged_attention_fixed(const T* __restrict__ q, const T* __restrict__ new_k,
                      const T* __restrict__ new_v,
                      const int* __restrict__ page_table,
                      const int* __restrict__ lengths,
                      const int* __restrict__ windows, T* __restrict__ out,
                      int num_heads, int num_kv_heads, int page_size,
                      int pages_per_seq, int rpp, long long page_offset,
                      int static_window, float scale2, const FixPlan pl,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v) {
  using S = FixShape<KV, D>;
  constexpr int W = kFixWarps, NS = S::SLOTS, REC = S::REC;
  constexpr int sz = sizeof(KV);
  extern __shared__ unsigned char fix_raw[];
  unsigned char* smem = align1k(fix_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rank = blockIdx.x, cs = pl.ranks, b = blockIdx.y, g = blockIdx.z;
  const int qpk = num_heads / num_kv_heads;
  const bool append = new_k != nullptr;
  unsigned char* ring = smem + warp * NS * S::SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + pl.o_bar) + warp * NS;
  uint64_t* comb = reinterpret_cast<uint64_t*>(smem + pl.o_bar) + W * NS;
  float* recv = reinterpret_cast<float*>(smem + pl.o_recv);
  const int hs = pl.hs, own0 = rank * hs, nown = max(0, min(hs, qpk - own0));
  const int page = page_size;

  // each warp's ring barriers (one arrival: lane 0's, with the boxes'
  // bytes); the cluster's sum barrier (every part's records of this rank's
  // heads)
  if (lane == 0) {
    for (int s = 0; s < NS; ++s) hopper::mbar_init(&full[s], 1);
    if (warp == 0) {
      if (cs > 1) {
        hopper::mbar_init(comb, 1);
        hopper::mbar_arrive_tx(comb, cs * W * nown * REC * 4);
      }
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_k) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_v) : "memory");
    }
    hopper::mbar_fence_init();
  }
  __syncwarp();
  if (cs > 1) hopper::cluster_arrive_relaxed();  // this rank's barrier exists

  // One round trip: the length, the request's window, and the pages of the
  // part's first NS boxes if the band starts at token 0 (no window)
  const int* table = page_table + (long long)b * pages_per_seq;
  const int P = cs * W, part = rank + cs * warp;
  const int end = pages_per_seq * page;  // the table's tokens
  int pg = 0;
  {
    const int tok = (part + P * lane) * kFixBox;
    if (lane < NS && tok < end) pg = __ldg(table + tok / page);
  }
  const int len = __ldg(lengths + b);
  const int wreq = windows != nullptr ? __ldg(windows + b) : 0;

  // lane 0: box j of the part (the tokens [t0, t0 + kFixBox) of page pgid)
  // into slot j % NS, K and V on the slot's barrier, after the warp's reads
  // of the slot; a box outside the pool (a garbage page id past the length)
  // is moved inside it, and its keys are masked
  const int col = g * D;
  auto issue = [&](int j, int t0, int pgid) {
    const int s = j % NS;
    unsigned char* st = ring + s * S::SLOT;
    long long row = ((long long)pgid + page_offset) * rpp + t0 % page;
    row = row < 0 ? 0 : row > pl.rows - kFixBox ? pl.rows - kFixBox : row;
    hopper::fence_proxy_async();
    hopper::mbar_arrive_tx(&full[s], S::SLOT);
#pragma unroll
    for (int c = 0; c < S::NC; ++c) {
      hopper::tma_load_2d(st + c * S::BOX, &tm_k, &full[s], col + c * S::CW / sz,
                          static_cast<int>(row));
      hopper::tma_load_2d(st + S::HALF + c * S::BOX, &tm_v, &full[s],
                          col + c * S::CW / sz, static_cast<int>(row));
    }
  };

  // Without a window the band starts at token 0, so the part's first boxes
  // are known before the length is: they go out now, and those past the
  // length are waited for and dropped
  const bool spec = windows == nullptr && static_window <= 0;
  const int nspec = spec ? min(kFixSpec, NS) : 0;
  for (int j = 0; j < nspec; ++j) {
    const int t0 = (part + P * j) * kFixBox;
    const int pj = __shfl_sync(0xffffffffu, pg, j);
    if (lane == 0 && t0 < end) issue(j, t0, pj);
  }

  // key band [lo, hi): the tighter of the static and per-request windows;
  // in append mode the new token takes one place of the band
  const int hi = min(len, end);
  int w = kNoWindow;
  if (wreq > 0) w = wreq;
  if (static_window > 0) w = min(w, static_window);
  const int w_old = append ? max(w - 1, 0) : w;
  const int tlo = max(len - w_old, 0), thi = hi;
  // the band's boxes [ib0, ib0 + nball); the part's are ib0 + part + P j
  const int ib0 = tlo / kFixBox;
  const int nball = thi > tlo ? (thi + kFixBox - 1) / kFixBox - ib0 : 0;
  const int nbox = nball > part ? (nball - part + P - 1) / P : 0;
  auto box_tok = [&](int j) { return (ib0 + part + P * j) * kFixBox; };
  // the first slots' boxes not in flight yet (their pages read again when
  // a window moved the band's start)
  if (ib0 != 0) {
    const int tok = box_tok(lane);
    pg = lane < NS && lane < nbox ? __ldg(table + tok / page) : 0;
  }
  for (int j = nspec; j < min(NS, nbox); ++j) {
    const int pj = __shfl_sync(0xffffffffu, pg, j);
    if (lane == 0) issue(j, box_tok(j), pj);
  }

  // the warp's online softmax (log2 domain: scores times scale2)
  constexpr int DT = D / 16;  // 16-column slices of a row
  constexpr int C = D / 32;   // FFMA: output columns a lane
  float m2[2] = {-INFINITY, -INFINITY}, l2[2] = {0.f, 0.f};  // MMA: heads 2tq, 2tq + 1
  float o2[MMA ? DT : 1][4] = {};
  uint32_t qb[MMA ? DT : 1][2] = {};
  float mf[MMA ? 1 : kMaxQ], lf[MMA ? 1 : kMaxQ];
  float of[MMA ? 1 : kMaxQ][C];
  float* q_s = reinterpret_cast<float*>(smem + pl.o_q);               // FFMA: [kMaxQ][D]
  float* p_s = reinterpret_cast<float*>(smem + pl.o_p) + warp * kMaxQ * kFixBox;
  const T* q_row = q + ((long long)b * num_heads + (long long)g * qpk) * D;
  if constexpr (MMA) {
    // q as the B operand of S = K q^T (column gq = head gq), in registers:
    // a 16-bit row's k = 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of each slice; an
    // fp8 row's fragments hold its values 4tq .. 4tq + 3 (below), so q's
    // do too (the depth is summed over, in any order)
    if (gq < qpk) {
      const T* qh = q_row + gq * D;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        if constexpr (sz == 2) {
          qb[kk][0] = *reinterpret_cast<const uint32_t*>(qh + 16 * kk + 2 * tq);
          qb[kk][1] = *reinterpret_cast<const uint32_t*>(qh + 16 * kk + 2 * tq + 8);
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(qh + 16 * kk + 4 * tq);
          qb[kk][0] = v.x;
          qb[kk][1] = v.y;
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < kMaxQ; ++h) {
      mf[h] = -INFINITY;
      lf[h] = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) of[h][i] = 0.f;
    }
    for (int i = tid; i < qpk * D; i += W * 32) q_s[i] = to_float(q_row[i]);
    __syncthreads();
  }

  // while the boxes are in flight: the append column's score (log2
  // domain) of each head this rank owns, one warp a head, and its V row
  float* sn_c = reinterpret_cast<float*>(smem + pl.o_w);  // [hs]
  float* nv_s = sn_c + hs;                                 // [D]
  const long long kv_row = ((long long)b * num_kv_heads + g) * D;
  if (append) {
    for (int hh = warp; hh < nown; hh += W) {
      const T* qh = q_row + (long long)(own0 + hh) * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot += to_float(qh[d]) * to_float(new_k[kv_row + d]);
      dot = warp_sum(dot);
      if (lane == 0) sn_c[hh] = dot * scale2;
    }
    if (nown > 0)
      for (int i = tid; i < D; i += W * 32) nv_s[i] = to_float(new_v[kv_row + i]);
  }

  for (int j = 0; j < nbox; ++j) {
    const int s = j % NS, t0 = box_tok(j);
    // the page of the box this slot takes next
    int pnext = 0;
    if (lane == 0 && j + NS < nbox) pnext = __ldg(table + box_tok(j + NS) / page);
    hopper::mbar_wait(&full[s], (j / NS) & 1);
    const unsigned char* ks = ring + s * S::SLOT;
    const unsigned char* vs = ks + S::HALF;
    if constexpr (MMA) {
      // S = K q^T: 16 keys (M) by the group's heads (N = 8) over the depth
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        uint32_t a[4];
        if constexpr (sz == 2) {
          ldsm4(a, ks + S::at(lane & 15, (2 * kk + (lane >> 4)) * 16));
        } else {  // row gq's and gq + 8's values 16kk + 4tq .. + 3
          const uint32_t x0 = *reinterpret_cast<const uint32_t*>(ks + S::at(gq, 16 * kk + 4 * tq));
          const uint32_t x1 = *reinterpret_cast<const uint32_t*>(ks + S::at(gq + 8, 16 * kk + 4 * tq));
          a[0] = fp8x2<T, KV>(x0);
          a[1] = fp8x2<T, KV>(x1);
          a[2] = fp8x2<T, KV>(x0 >> 16);
          a[3] = fp8x2<T, KV>(x1 >> 16);
        }
        mma16816<T>(sc, a, qb[kk][0], qb[kk][1]);
      }
      const int k0 = t0 + gq, k1 = k0 + 8;
      const bool in0 = k0 >= tlo && k0 < thi, in1 = k1 >= tlo && k1 < thi;
      const float x0 = in0 ? sc[0] * scale2 : -INFINITY;
      const float x1 = in0 ? sc[1] * scale2 : -INFINITY;
      const float x2 = in1 ? sc[2] * scale2 : -INFINITY;
      const float x3 = in1 ? sc[3] * scale2 : -INFINITY;
      float mx0 = fmaxf(x0, x2), mx1 = fmaxf(x1, x3);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      // finite: every box holds a key of the band
      const float mn0 = fmaxf(m2[0], mx0), mn1 = fmaxf(m2[1], mx1);
      const float al0 = ex2(m2[0] - mn0), al1 = ex2(m2[1] - mn1);
      const float p0 = ex2(x0 - mn0), p1 = ex2(x1 - mn1);
      const float p2 = ex2(x2 - mn0), p3 = ex2(x3 - mn1);
      l2[0] = l2[0] * al0 + p0 + p2;
      l2[1] = l2[1] * al1 + p1 + p3;
      m2[0] = mn0;
      m2[1] = mn1;
      // P (keys by heads) rounded to T, transposed into the B operand of
      // O = V^T P: keys 2tq, 2tq + 1 (+ 8) of head gq
      const uint32_t pb0 = movt(hopper::pack2<T>(p0, p1));
      const uint32_t pb1 = movt(hopper::pack2<T>(p2, p3));
      // V rows outside the band read as 0 (a box's other rows may hold
      // anything, and p = 0 times a NaN is a NaN)
      uint32_t vm0 = 0xffffffffu, vm1 = 0xffffffffu;
      if (t0 < tlo || t0 + kFixBox > thi) {
        const int ka = t0 + 2 * tq, kb = ka + 8;
        vm0 = (ka >= tlo && ka < thi ? 0xffffu : 0u) |
              (ka + 1 >= tlo && ka + 1 < thi ? 0xffff0000u : 0u);
        vm1 = (kb >= tlo && kb < thi ? 0xffffu : 0u) |
              (kb + 1 >= tlo && kb + 1 < thi ? 0xffff0000u : 0u);
      }
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) {
        o2[dd][0] *= al0;
        o2[dd][1] *= al1;
        o2[dd][2] *= al0;
        o2[dd][3] *= al1;
        // A = V^T: 16 columns (M) by the box's 16 keys (K)
        uint32_t a[4];
        if constexpr (sz == 2) {
          ldsm4t(a, vs + S::at((lane & 7) + ((lane >> 4) << 3),
                               (2 * dd + ((lane >> 3) & 1)) * 16));
        } else {
          // rows gq and gq + 8's values 16dd + 4tq .. + 3 as two 8 x 8
          // matrices of pairs each, transposed: rows gq and gq + 8 of A are
          // then the columns 16dd + 4(gq / 2) + gq % 2 and that + 2
          const uint32_t x0 = *reinterpret_cast<const uint32_t*>(vs + S::at(gq, 16 * dd + 4 * tq));
          const uint32_t x1 = *reinterpret_cast<const uint32_t*>(vs + S::at(gq + 8, 16 * dd + 4 * tq));
          a[0] = movt(fp8x2<T, KV>(x0));
          a[1] = movt(fp8x2<T, KV>(x0 >> 16));
          a[2] = movt(fp8x2<T, KV>(x1));
          a[3] = movt(fp8x2<T, KV>(x1 >> 16));
        }
        a[0] &= vm0;
        a[1] &= vm0;
        a[2] &= vm1;
        a[3] &= vm1;
        mma16816<T>(o2[dd], a, pb0, pb1);
      }
    } else {
      // scores: lane 16hf + kr takes key kr's row against every head over
      // half the row (16-byte reads), the halves summed by a shuffle
      const int kr = lane & 15, hf = lane >> 4;
      constexpr int E = 16 / sz;            // values a 16-byte chunk
      constexpr int CH = S::RB / 16 / 2;    // chunks of a half row
      float sc[kMaxQ];
#pragma unroll
      for (int h = 0; h < kMaxQ; ++h) sc[h] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int cb = hf * CH + c;
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + S::at(kr, cb * 16));
        const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
        for (int i = 0; i < E; i += 4) {
          const float k0 = to_float(e[i]), k1 = to_float(e[i + 1]);
          const float k2 = to_float(e[i + 2]), k3 = to_float(e[i + 3]);
#pragma unroll
          for (int h = 0; h < kMaxQ; ++h) {
            if (h < qpk) {
              const float4 qv = *reinterpret_cast<const float4*>(q_s + h * D + cb * E + i);
              sc[h] = fmaf(qv.x, k0, fmaf(qv.y, k1, fmaf(qv.z, k2, fmaf(qv.w, k3, sc[h]))));
            }
          }
        }
      }
      const int key = t0 + kr;
      const bool in = key >= tlo && key < thi;
#pragma unroll
      for (int h = 0; h < kMaxQ; ++h) {
        if (h < qpk) {
          float x = sc[h] + __shfl_xor_sync(0xffffffffu, sc[h], 16);
          x = in ? x * scale2 : -INFINITY;
          float mx = x;
#pragma unroll
          for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float mn = fmaxf(mf[h], mx);
          const float al = ex2(mf[h] - mn);
          const float p = ex2(x - mn);
          lf[h] = lf[h] * al + p;
          mf[h] = mn;
#pragma unroll
          for (int i = 0; i < C; ++i) of[h][i] *= al;
          if (hf == 0) p_s[h * kFixBox + kr] = round_to<T>(p);
        }
      }
      __syncwarp();
      // o += p V over the box's band keys: lane l the columns C l .. + C - 1
      const int j0 = max(tlo - t0, 0), j1 = min(thi - t0, kFixBox);
      for (int jj = j0; jj < j1; ++jj) {
        float vx[C];
        load_cols<KV, C>(vs + S::at(jj, lane * C * sz), vx);
#pragma unroll
        for (int h = 0; h < kMaxQ; ++h) {
          if (h < qpk) {
            const float pj = p_s[h * kFixBox + jj];
#pragma unroll
            for (int i = 0; i < C; ++i) of[h][i] = fmaf(pj, vx[i], of[h][i]);
          }
        }
      }
    }
    __syncwarp();  // the slot (and p_s) are free
    if (lane == 0 && j + NS < nbox) issue(j + NS, box_tok(j + NS), pnext);
  }
  // boxes put in flight past the band land before the ring is reused
  for (int j = nbox; j < nspec; ++j)
    if ((part + P * j) * kFixBox < end) hopper::mbar_wait(&full[j], 0);

  // the warp's record of each head (m, l, o) into its own ring
  float* rec = reinterpret_cast<float*>(ring);
  if constexpr (MMA) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l2[0] += __shfl_xor_sync(0xffffffffu, l2[0], o);
      l2[1] += __shfl_xor_sync(0xffffffffu, l2[1], o);
    }
    const int h0 = 2 * tq;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int h = h0 + x;
      if (h < qpk) {
        float* r = rec + h * REC;
        if (gq == 0) {
          r[0] = m2[x];
          r[1] = l2[x];
        }
#pragma unroll
        for (int dd = 0; dd < DT; ++dd) {
          const int da = sz == 2 ? 16 * dd + gq : 16 * dd + 4 * (gq >> 1) + (gq & 1);
          const int db = sz == 2 ? da + 8 : da + 2;
          r[4 + da] = o2[dd][x];
          r[4 + db] = o2[dd][2 + x];
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < kMaxQ; ++h) {
      if (h < qpk) {
        float l = lf[h];
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
        float* r = rec + h * REC;
        if (lane == 0) {
          r[0] = mf[h];
          r[1] = l;
        }
#pragma unroll
        for (int i = 0; i < C; ++i) r[4 + lane * C + i] = of[h][i];
      }
    }
  }
  __syncwarp();

  // The cluster's sum: rank r owns the heads [r hs, (r + 1) hs); every
  // warp sends the records of each owner's heads into the owner's recv
  // [rank][warp][hs] by st.async, completing on the owner's barrier, and
  // each owner adds the parts in (rank, warp) order once every byte has
  // landed. Without a split the block's warps' records are the parts.
  if (cs > 1) {
    hopper::cluster_wait();  // every rank's barrier exists
    constexpr int Q4 = REC / 4;
    const int slot = rank * W + warp;
    for (int i = lane; i < qpk * Q4; i += 32) {
      const int h = i / Q4, c = i % Q4, owner = h / hs;
      const uint32_t dst = hopper::map_rank(
          hopper::smem_u32(recv + (slot * hs + h - owner * hs) * REC + 4 * c), owner);
      const uint32_t bar = hopper::map_rank(hopper::smem_u32(comb), owner);
      hopper::st_async(dst, *reinterpret_cast<const uint4*>(rec + h * REC + 4 * c), bar);
    }
    if (nown > 0) hopper::mbar_wait(comb, 0);
  }
  __syncthreads();  // the parts, the append score and V row are in place
  auto part_rec = [&](int p, int hh) -> const float* {
    return cs > 1 ? recv + (p * hs + hh) * REC
                  : reinterpret_cast<const float*>(smem + p * NS * S::SLOT) +
                        (own0 + hh) * REC;
  };
  // each output of an owned head: the combined max M, each part's weight
  // exp2(m_p - M), the sums L and o over the parts in order
  const int parts = cs * W;
  T* out_row = out + ((long long)b * num_heads + (long long)g * qpk + own0) * D;
  for (int i = tid; i < nown * D; i += W * 32) {
    const int hh = i / D, c = i % D;
    float M = -INFINITY;
    for (int p = 0; p < parts; ++p) M = fmaxf(M, part_rec(p, hh)[0]);
    const float mu = M == -INFINITY ? 0.f : M;
    float o = 0.f, l = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float* r = part_rec(p, hh);
      const float wr = ex2(r[0] - mu);
      l = fmaf(wr, r[1], l);
      o = fmaf(wr, r[4 + c], o);
    }
    if (append) {
      // one more online-softmax column: always visible to its own query
      const float m = M, sn = sn_c[hh];
      const float mx = fmaxf(m, sn);
      const float al = ex2(m - mx), pn = ex2(sn - mx);
      l = l * al + pn;
      o = o * al + pn * nv_s[c];
    }
    store(out_row + (long long)hh * D + c, l == 0.f ? 0.f : o / l);
  }
}

// ---------------------------------------------------------------------------
// paged_attention_any: every head dim and every group (see the header)
// ---------------------------------------------------------------------------

// accumulator arithmetic: f32, or f64 for float64 inputs
template <typename A, typename X>
__device__ __forceinline__ A to_acc(X x) {
  if constexpr (std::is_same<X, double>::value) return x;
  else return to_float(x);
}
__device__ __forceinline__ float amax(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double amax(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ float afma(float x, float y, float z) { return fmaf(x, y, z); }
__device__ __forceinline__ double afma(double x, double y, double z) { return fma(x, y, z); }
__device__ __forceinline__ float aexp(float x) { return expf(x); }
__device__ __forceinline__ double aexp(double x) { return exp(x); }
__device__ __forceinline__ void store(double* p, double x) { *p = x; }

constexpr int kAnyThreads = 256;  // a block's most threads: 8 warps
constexpr int kMaxStages = 3;   // K/V tiles in flight: this one and two more
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxHb = 4;       // query heads a thread scores against a row
constexpr int kBoxRows = 16;    // a TMA box's rows (fewer: a page's)
// the largest dynamic shared memory a block may opt into on an H100
constexpr int kSmemMax = 227 * 1024;

// The elements a thread reads from a staged row at once (a unit): the copy
// piece's VB bytes, and at least a pair of 16- or 8-bit elements (an odd
// D's rows are copied 2 or 1 bytes at a time but lie 4-byte aligned)
template <int VB, typename KV>
__host__ __device__ constexpr int unit_elems() {
  return sizeof(KV) <= 2 && VB < 2 * static_cast<int>(sizeof(KV))
             ? 2
             : VB / static_cast<int>(sizeof(KV));
}

// a unit of VE elements of a staged row at byte p, as A
template <int VE, typename KV, typename A>
__device__ __forceinline__ void load_unit(const unsigned char* p, A (&x)[VE]) {
  constexpr int bytes = VE * sizeof(KV);
  union {
    uint4 v4;
    uint2 v2;
    uint32_t v1;
    unsigned short s;
  } raw;
  if constexpr (bytes == 16) raw.v4 = *reinterpret_cast<const uint4*>(p);
  else if constexpr (bytes == 8) raw.v2 = *reinterpret_cast<const uint2*>(p);
  else if constexpr (bytes == 4) raw.v1 = *reinterpret_cast<const uint32_t*>(p);
  else raw.s = *reinterpret_cast<const unsigned short*>(p);
  const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int i = 0; i < VE; ++i) x[i] = to_acc<A>(e[i]);
}

// VE consecutive values of A in shared memory (aligned to VE values)
template <int VE, typename A>
__device__ __forceinline__ void load_vals(const A* p, A (&x)[VE]) {
  if constexpr (std::is_same<A, float>::value && VE % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VE; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      x[i] = f.x, x[i + 1] = f.y, x[i + 2] = f.z, x[i + 3] = f.w;
    }
  } else if constexpr (VE % 2 == 0 && sizeof(A) * 2 <= 16) {
#pragma unroll
    for (int i = 0; i < VE; i += 2) {
      if constexpr (std::is_same<A, float>::value) {
        const float2 f = *reinterpret_cast<const float2*>(p + i);
        x[i] = f.x, x[i + 1] = f.y;
      } else {
        const double2 f = *reinterpret_cast<const double2*>(p + i);
        x[i] = f.x, x[i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < VE; ++i) x[i] = p[i];
  }
}

// What a launch of paged_attention_any needs beside its pointers, computed
// on the host (any_plan): the tile, the split, the work's layout over the
// threads and of dynamic shared memory.
struct AnyPlan {
  int tt, ltt;     // tokens a tile (64, 32 or 16) and its log2
  int qh;          // query heads a pass (a group past 227 KB takes several)
  int passes, chunks, dout;  // output columns a chunk (<= 256)
  int splits;      // blocks over one (sequence, kv head)'s pages: a cluster
  int per;         // pages a split
  int st;          // stages of the ring (1 to kMaxStages)
  int vb;          // bytes a row's offsets are aligned to: 16, 8, 4, 2 or 1
  int tma;         // rows loaded by TMA boxes of `box` rows (tm_k, tm_v),
                   // else by vb-byte pieces (cp.async from 4 bytes, plain
                   // loads and stores below)
  int box, rpp;    // a box's rows (it divides the tile and the page), and
                   // a page's rows in the maps
  int sk, sv;      // a staged K row's and V row's stride, 4-byte words
  int ro;          // o's values in a head's record (the chunk's units), then m, l
  int hw;          // 4-byte words of a record, % 4 == 0
  int hb;          // query heads a score thread takes (<= kMaxHb)
  int ds, lds;     // threads a score's dot product is split over (pow. of 2)
  int sb;          // token subsets of the output products
  int hs;          // heads each rank of the cluster owns in the sum
  int nt;          // threads a block: 128 or kAnyThreads
  // byte offsets into dynamic shared memory, and its size
  int o_stage, o_rows, o_q, o_s, o_rec, o_alpha, o_recv, o_w, smem;
};

// Where a thread's copy pieces of a tile lie: from piece (j, c) (token,
// piece of its rows) in steps of a block's threads, (dj, dc); no division
// in the copy loop.
struct Walk {
  int j, c, dj, dc;
};

// Copies of the rows of one tile into a stage: the `n` tokens' K rows
// (whole, D elements) and V rows (the chunk's nc columns from c0), VB-byte
// pieces (pk of a K row, then pv of a V row) spread over the block's
// threads in order; 16-, 8- and 4-byte pieces by cp.async, 2- and 1-byte
// ones by plain loads and stores. `rows` holds each token's element offset
// in the pools.
template <int VB, typename KV>
__device__ __forceinline__ void issue_rows(unsigned char* stage,
                                           const long long* rows, int n,
                                           const KV* k, const KV* v, int c0,
                                           int pk, int pv, Walk w,
                                           const AnyPlan& pl) {
  const int per = pk + pv;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) +
                            (long long)c0 * sizeof(KV);
  unsigned char* vs = stage + pl.tt * pl.sk * 4;
  for (int j = w.j, c = w.c; j < n;) {
    const long long off = rows[j] * static_cast<long long>(sizeof(KV));
    const bool is_k = c < pk;
    const unsigned char* src = (is_k ? kb + c * VB : vb + (c - pk) * VB) + off;
    unsigned char* dst = is_k ? stage + j * pl.sk * 4 + c * VB
                              : vs + j * pl.sv * 4 + (c - pk) * VB;
    if constexpr (VB == 16)
      hopper::cp_async16(dst, src, true);
    else if constexpr (VB == 8 || VB == 4)
      hopper::cp_async_ca<VB>(dst, src, true);
    else if constexpr (VB == 2)
      *reinterpret_cast<unsigned short*>(dst) =
          __ldg(reinterpret_cast<const unsigned short*>(src));
    else
      *dst = __ldg(src);
    j += w.dj;
    c += w.dc;
    if (c >= per) c -= per, ++j;
  }
}

// grid = splits x B x (H_kv * passes * chunks), clusters of `splits` blocks
// along x: rank r of a cluster walks the pages [r per, (r + 1) per) of one
// (sequence, kv head) for the pass's qh query heads and the chunk's dout
// output columns, and the ranks then add their partials through
// distributed shared memory (the header). VB: the copy pieces' bytes.
template <typename T, typename KV, typename A, int VB>
__global__ void __launch_bounds__(kAnyThreads)
paged_attention_any(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const T* __restrict__ new_k,
                    const T* __restrict__ new_v,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const int* __restrict__ windows, T* __restrict__ out,
                    int num_heads, int num_kv_heads, int D, int page_size,
                    int pages_per_seq, long long page_stride,
                    long long page_offset, int static_window, A sm_scale,
                    const AnyPlan pl, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v) {
  constexpr int VE = unit_elems<VB, KV>(), sz = sizeof(KV);
  extern __shared__ __align__(16) unsigned char smem_any[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_any);  // a stage's copies
  uint64_t* vfull = full + kMaxStages;  // by TMA: a stage's V rows
  uint64_t* comb = vfull + kMaxStages;  // the partials sent to this rank
  unsigned char* stages = smem_any + pl.o_stage;  // [ST][tt K rows, tt V rows]
  long long* rows_s = reinterpret_cast<long long*>(smem_any + pl.o_rows);
  A* q_s = reinterpret_cast<A*>(smem_any + pl.o_q);   // [qh][dq]
  A* s_s = reinterpret_cast<A*>(smem_any + pl.o_s);   // [qh][tt]
  uint32_t* rec = reinterpret_cast<uint32_t*>(smem_any + pl.o_rec);
  A* alpha_s = reinterpret_cast<A*>(smem_any + pl.o_alpha);
  uint32_t* recv = reinterpret_cast<uint32_t*>(smem_any + pl.o_recv);
  A* w_s = reinterpret_cast<A*>(smem_any + pl.o_w);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = pl.nt, warps = nt / 32;
  const int rank = blockIdx.x, cs = pl.splits, b = blockIdx.y;
  const int g = blockIdx.z / (pl.passes * pl.chunks);  // kv head
  const int pz = blockIdx.z % (pl.passes * pl.chunks);
  const int qpk = num_heads / num_kv_heads;
  const int h0 = (pz / pl.chunks) * pl.qh;  // first head of the pass
  const int nh = min(pl.qh, qpk - h0);
  const int c0 = (pz % pl.chunks) * pl.dout;  // first output column
  const int nc = min(pl.dout, D - c0);
  const int tt = pl.tt, ro = pl.ro, ST = pl.st;
  const int nu = (D + VE - 1) / VE, nuv = (nc + VE - 1) / VE;  // units a row
  const int dq = nu * VE;
  const long long F = (long long)num_kv_heads * D;
  const bool append = new_k != nullptr;
  const int pk = D * sz / VB, pv = nc * sz / VB;  // copy pieces a row
  // head h's record in token subset u: o[ro], then m and l (subset 0's)
  auto record = [&](int u, int h) {
    return reinterpret_cast<A*>(rec + (u * pl.qh + h) * pl.hw);
  };
  const int hs = pl.hs, own0 = rank * hs;  // this rank's heads in the sum
  const int nown = max(0, min(hs, nh - own0));

  const int* table = page_table + (long long)b * pages_per_seq;
  // by TMA: the first thread fetches the maps' descriptors, and the first
  // box threads the pages of this split's first tile before the length
  // is known (the first tile starts there unless a window cuts it)
  int first_page = 0;
  if (pl.tma) {
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_k) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_v) : "memory");
    }
    if (tid < pl.tt / pl.box)
      first_page = table[min(rank * pl.per + tid * pl.box / page_size,
                             pages_per_seq - 1)];
  }
  // key band [lo, hi), as paged_attention_fixed, cut to this split's pages
  const int len = lengths[b];
  const int hi = min(len, pages_per_seq * page_size);
  int w = kNoWindow;
  if (windows != nullptr && windows[b] > 0) w = windows[b];
  if (static_window > 0) w = min(w, static_window);
  const int w_old = append ? max(w - 1, 0) : w;
  const int lo = max(len - w_old, 0);
  const int tlo = max(lo, rank * pl.per * page_size);
  const int thi = min(hi, min((rank + 1) * pl.per, pages_per_seq) * page_size);
  // tiles from tlo; by TMA from the tile boundary below it (a box never
  // crosses a page), the tokens below tlo masked
  const int t_first = pl.tma ? tlo / tt * tt : tlo;
  const int tiles = thi > tlo ? (thi - t_first + tt - 1) / tt : 0;

  if (tid == 0) {
    // TMA: the first thread's arrival with the boxes' bytes; else every
    // thread's when its copies land
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], pl.tma ? 1 : nt);
      hopper::mbar_init(&vfull[s], 1);
    }
    if (cs > 1) {  // every rank's partials of this rank's heads
      hopper::mbar_init(comb, 1);
      hopper::mbar_arrive_tx(comb, cs * nown * pl.hw * 4);
    }
    hopper::mbar_fence_init();
  }
  // the records: o = 0, l = 0, m = -inf (subset 0's)
  {
    const int na = pl.hw * 4 / static_cast<int>(sizeof(A));  // A's a record
    A* ra = reinterpret_cast<A*>(rec);
    for (int i = tid; i < pl.sb * pl.qh * na; i += nt)
      ra[i] = i < pl.qh * na && i % na == ro ? A(-INFINITY) : A(0);
  }
  // the staged rows' tails past D (K) and nc (V) elements read as 0: an
  // odd D's last unit reaches past its last element (TMA's rows are whole
  // units)
  if (!pl.tma) {
    const int k0 = D * sz / 4, v0 = nc * sz / 4;
    const int kt = pl.sk - k0, vt = pl.sv - v0;
    uint32_t* st32 = reinterpret_cast<uint32_t*>(stages);
    for (int i = tid; i < ST * tt * (kt + vt); i += nt) {
      const int s = i / (tt * (kt + vt)), r = i % (tt * (kt + vt));
      uint32_t* base = st32 + s * tt * (pl.sk + pl.sv);
      if (r < tt * kt)
        base[(r / kt) * pl.sk + k0 + r % kt] = 0;
      else
        base[tt * pl.sk + ((r - tt * kt) / vt) * pl.sv + v0 + (r - tt * kt) % vt] = 0;
    }
  }
  // the pass's query rows: head h of the pass at q_row + h * D
  const T* q_row = q + ((long long)b * num_heads + (long long)g * qpk + h0) * D;
  for (int i = tid; i < nh * dq; i += nt) {
    const int h = i / dq, e = i % dq;
    q_s[i] = e < D ? to_acc<A>(q_row[(long long)h * D + e]) : A(0);
  }
  // each token's element offset in the pools (K's row; V's at the chunk),
  // or by TMA each box's row in the maps, for tile i into its slot (ST + 1
  // slots: by TMA a tile's V boxes go out after its scores)
  auto slot = [&](int i) { return rows_s + (i % (ST + 1)) * tt; };
  auto locate = [&](int i) {
    if (pl.tma) {
      const int tok = t_first + i * tt + tid * pl.box;
      if (tid < tt / pl.box && tok < thi) {
        const int pi = tok / page_size;
        const int page =
            i == 0 && pi == rank * pl.per + tid * pl.box / page_size
                ? first_page : table[pi];
        slot(i)[tid] = ((long long)page + page_offset) * pl.rpp +
                       tok % page_size;
      }
      return;
    }
    const int tok = tlo + i * tt + tid;
    if (tid < tt && tok < thi)
      slot(i)[tid] =
          ((long long)table[tok / page_size] + page_offset) * page_stride +
          (long long)(tok % page_size) * F + (long long)g * D;
  };
  for (int i = 0; i < ST && i < tiles; ++i) locate(i);
  __syncthreads();
  if (cs > 1) hopper::cluster_arrive_relaxed();  // this rank's barrier exists

  // put tile i in flight into its stage; each thread's copies arrive on
  // the stage's barrier
  const int pieces = pk + pv, wj = tid / pieces;
  const Walk walk{wj, tid - wj * pieces, nt / pieces, nt % pieces};
  // TMA: the boxes start at the 16-byte boundary at or below the head's
  // columns (a box's start in its rows must be 16-byte aligned), which
  // then lie hshift bytes into each box row
  const int hshift = pl.tma ? static_cast<int>((g * (long long)D * sz) & 15) : 0;
  const int col0 = pl.tma ? static_cast<int>((g * (long long)D * sz - hshift) / sz) : 0;
  // a stage: tt K rows, then tt V rows; by TMA the V rows replace the K
  // rows once the tile is scored (half the shared memory: more blocks an
  // SM holds), the V boxes in flight under the softmax
  const int stage_bytes = tt * (pl.sk + (pl.tma ? 0 : pl.sv)) * 4;
  // the first thread's K (or V) boxes of tile i that hold a key of the
  // band [tlo, thi), after the generic proxy's reads of the stage
  auto boxes_of = [&](int i, uint64_t* bar, const CUtensorMap* map, int col) {
    const int t0 = t_first + i * tt;
    const int boxes = min(tt, thi - t0 + pl.box - 1) / pl.box;
    const int x0 = max(0, tlo - t0) / pl.box;  // boxes below the band
    unsigned char* st = stages + (i % ST) * stage_bytes;
    hopper::fence_proxy_async();
    hopper::mbar_arrive_tx(bar, (boxes - x0) * pl.box * pl.sk * 4);
    for (int x = x0; x < boxes; ++x)
      hopper::tma_load_2d(st + x * pl.box * pl.sk * 4, map, bar, col,
                          static_cast<int>(slot(i)[x]));
  };
  auto issue = [&](int i) {
    const int s = i % ST;
    unsigned char* st = stages + s * stage_bytes;
    if (pl.tma) {
      if (tid == 0) boxes_of(i, &full[s], &tm_k, col0);
      return;
    }
    const int n = min(tt, thi - (tlo + i * tt));
    issue_rows<VB>(st, slot(i), n, k, v, c0, pk, pv, walk, pl);
    if constexpr (VB >= 4)
      hopper::cp_async_arrive_noinc(&full[s]);
    else
      hopper::mbar_arrive(&full[s]);
  };
  for (int i = 0; i < ST - 1 && i < tiles; ++i) issue(i);

  const int hb = pl.hb, nhb = (nh + hb - 1) / hb;  // head blocks of scores
  const int ds = pl.ds;
  for (int i = 0; i < tiles; ++i) {
    const int s = i % ST;
    const int t0 = t_first + i * tt, n = min(tt, thi - t0);
    const int jlo = max(0, tlo - t0);  // tokens below the band (TMA)
    // the tile ST - 1 on goes out into the stage the last tile left (the
    // one after it finds its rows below)
    if (i + ST - 1 < tiles) issue(i + ST - 1);
    hopper::mbar_wait(&full[s], (i / ST) & 1);
    const unsigned char* ks = stages + s * stage_bytes;
    const unsigned char* vs = pl.tma ? ks : ks + tt * pl.sk * 4;
    // scores: a thread takes hb query heads against one token's row over
    // every ds-th unit of it (ds lanes a dot product, summed by shuffles),
    // two partial sums a head
    for (int i0 = 0; i0 < nhb * tt * ds; i0 += nt) {
      const int it = i0 + tid;
      const int item = it >> pl.lds, part = it & (ds - 1);
      const int hq = (item >> pl.ltt) * hb, j = item & (tt - 1);
      const bool in = hq < nh && j < n && j >= jlo;
      A acc[kMaxHb][2] = {};
      if (in) {
        const unsigned char* kr = ks + j * pl.sk * 4 + hshift;
        for (int u = part; u < nu; u += ds) {
          A kx[VE];
          load_unit<VE, KV>(kr + u * VE * sz, kx);
#pragma unroll
          for (int x = 0; x < kMaxHb; ++x) {
            if (x < hb && hq + x < nh) {
              A qx[VE];
              load_vals<VE>(q_s + (hq + x) * dq + u * VE, qx);
#pragma unroll
              for (int e = 0; e < VE; ++e)
                acc[x][e & 1] = afma(qx[e], kx[e], acc[x][e & 1]);
            }
          }
        }
      }
#pragma unroll
      for (int x = 0; x < kMaxHb; ++x) {
        A sum = acc[x][0] + acc[x][1];
        for (int o = ds / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (in && part == 0 && x < hb && hq + x < nh)
          s_s[(hq + x) * tt + j] = sum * sm_scale;
      }
    }
    __syncthreads();
    if (pl.tma && tid == 0) boxes_of(i, &vfull[s], &tm_v, col0 + c0);
    // the rows of tile i + ST, into the slot of tile i - 1's
    if (i + ST < tiles) locate(i + ST);
    // one warp a query head: the online softmax's step
    for (int h = warp; h < nh; h += warps) {
      A* sh = s_s + h * tt;
      A x[4], mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = lane + 32 * jj;
        x[jj] = j < n && j >= jlo ? sh[j] : A(-INFINITY);
        mx = amax(mx, x[jj]);
      }
      mx = warp_max(mx);  // finite: every tile holds >= 1 key of the band
      A* r0 = record(0, h) + ro;
      const A m_old = r0[0], m_new = amax(m_old, mx);
      const A alpha = aexp(m_old - m_new);  // 0 on the first tile
      A sum = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = lane + 32 * jj;
        const A p = j < n && j >= jlo ? aexp(x[jj] - m_new) : A(0);
        if (j < n) sh[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        r0[0] = m_new;
        r0[1] = r0[1] * alpha + sum;
        alpha_s[h] = alpha;
      }
    }
    __syncthreads();
    if (pl.tma) hopper::mbar_wait(&vfull[s], (i / ST) & 1);
    // o = o alpha + p V over the chunk's columns: a unit of a head's
    // columns and a subset of the tokens (every sb-th) a thread, two
    // tokens at a time
    const int items = nh * nuv;
    for (int it = tid; it < items * pl.sb; it += nt) {
      const int u = it / items, r = it % items, h = r / nuv, cu = r % nuv;
      A* o = record(u, h) + cu * VE;
      const A* ph = s_s + h * tt;
      const A a = alpha_s[h];
      A o0[VE], o1[VE];
      load_vals<VE>(o, o0);
#pragma unroll
      for (int e = 0; e < VE; ++e) o0[e] *= a, o1[e] = 0;
      const int sb = pl.sb;
      int j = jlo + u;
      for (; j + sb < n; j += 2 * sb) {
        A x0[VE], x1[VE];
        load_unit<VE, KV>(vs + j * pl.sv * 4 + hshift + cu * VE * sz, x0);
        load_unit<VE, KV>(vs + (j + sb) * pl.sv * 4 + hshift + cu * VE * sz,
                          x1);
        const A p0 = ph[j], p1 = ph[j + sb];
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          o0[e] = afma(p0, x0[e], o0[e]);
          o1[e] = afma(p1, x1[e], o1[e]);
        }
      }
      if (j < n) {
        A x0[VE];
        load_unit<VE, KV>(vs + j * pl.sv * 4 + hshift + cu * VE * sz, x0);
        const A p0 = ph[j];
#pragma unroll
        for (int e = 0; e < VE; ++e) o0[e] = afma(p0, x0[e], o0[e]);
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) o[e] = o0[e] + o1[e];
    }
    __syncthreads();  // the stage, the scores and alpha are free
  }
  // the token subsets' sums, in order, into subset 0's records
  if (pl.sb > 1) {
    for (int i = tid; i < nh * ro; i += nt) {
      const int h = i / ro, c = i % ro;
      A acc = record(0, h)[c];
      for (int u = 1; u < pl.sb; ++u) acc += record(u, h)[c];
      record(0, h)[c] = acc;
    }
    __syncthreads();
  }

  // The cluster's sum: rank r owns the heads [r hs, (r + 1) hs) of the
  // pass; every rank sends the records of each owner's heads to the
  // owner's recv [splits][hs][hw] (slot = the sender's rank) by st.async,
  // which completes on the owner's mbarrier, and each owner, once every
  // byte has landed, adds the partials in rank order. Without a split a
  // rank reads its own records.
  const uint32_t* src = rec + own0 * pl.hw;
  int parts = 1, stride = 0;
  if (cs > 1) {
    hopper::cluster_wait();  // every rank's comb barrier exists
    for (int r = 0; r < cs; ++r) {
      const int words = max(0, min(hs, nh - r * hs)) * pl.hw;
      const uint32_t* from = rec + r * hs * pl.hw;
      const uint32_t slot = hopper::map_rank(hopper::smem_u32(recv + rank * hs * pl.hw), r);
      const uint32_t bar = hopper::map_rank(hopper::smem_u32(comb), r);
      for (int i = 4 * tid; i < words; i += 4 * nt)
        hopper::st_async(slot + i * 4, *reinterpret_cast<const uint4*>(from + i), bar);
    }
    hopper::mbar_wait(comb, 0);
    src = recv;
    parts = cs;
    stride = hs * pl.hw;
  }
  auto part_rec = [&](int r, int hh) {
    return reinterpret_cast<const A*>(src + r * stride + hh * pl.hw);
  };
  // per owned head: the combined max M and sum L, each part's weight
  // exp(m_r - M) (w_s [parts][hs]), and the append column's score
  A* m_c = w_s + parts * hs;
  A* l_c = m_c + hs;
  A* sn_c = l_c + hs;
  for (int hh = tid; hh < nown; hh += nt) {
    A M = -INFINITY;
    for (int r = 0; r < parts; ++r) M = amax(M, part_rec(r, hh)[ro]);
    const A mu = M == A(-INFINITY) ? A(0) : M;
    A L = 0;
    for (int r = 0; r < parts; ++r) {
      const A wr = aexp(part_rec(r, hh)[ro] - mu);
      w_s[r * hs + hh] = wr;
      L += wr * part_rec(r, hh)[ro + 1];
    }
    m_c[hh] = M;
    l_c[hh] = L;
  }
  const long long kv_row = (long long)b * F + (long long)g * D;
  if (append) {
    // the current token's score over the whole head, one warp a head
    for (int hh = warp; hh < nown; hh += warps) {
      const T* qh = q_row + (long long)(own0 + hh) * D;
      A part = 0;
      for (int d = lane; d < D; d += 32)
        part += to_acc<A>(qh[d]) * to_acc<A>(new_k[kv_row + d]);
      part = warp_sum(part);
      if (lane == 0) sn_c[hh] = part * sm_scale;
    }
  }
  __syncthreads();
  T* out_row = out + ((long long)b * num_heads + (long long)g * qpk + h0 + own0) * D;
  for (int i = tid; i < nown * nc; i += nt) {
    const int hh = i / nc, c = i % nc;
    A o = 0;
    for (int r = 0; r < parts; ++r) o = afma(w_s[r * hs + hh], part_rec(r, hh)[c], o);
    A l = l_c[hh];
    if (append) {
      // one more online-softmax column: always visible to its own query
      const A m = m_c[hh], sn = sn_c[hh];
      const A mf = amax(m, sn);
      const A alpha = aexp(m - mf), pn = aexp(sn - mf);
      l = l * alpha + pn;
      o = o * alpha + pn * to_acc<A>(new_v[kv_row + c0 + c]);
    }
    store(out_row + (long long)hh * D + c0 + c, l == A(0) ? A(0) : o / l);
  }
}

// the largest of 16, 8, 4, 2 and 1 that divides x
int piece_bytes(long long x) {
  for (int p = 16; p > 1; p /= 2)
    if (x % p == 0) return p;
  return 1;
}

// a staged row's stride in 4-byte words for `bytes` of row copied by
// pieces of vb bytes: aligned to the piece, an odd number of pieces (or of
// words, below 4 bytes), so that the rows a warp reads at one column fall
// in different banks
int row_words(int bytes, int vb) {
  const int u = vb >= 4 ? vb / 4 : 1;
  const int units = ((bytes + 3) / 4 + u - 1) / u;
  return u * (units | 1);
}

int align16(int x) { return (x + 15) & ~15; }

// The plan of a launch with `splits` blocks over a sequence's pages and a
// ring of `stages` (chosen by the caller: ops/paged_attention.py:
// _paged_plan): the tile (64, 32 or 16 tokens) and the query heads a pass
// that fit in 227 KB, fewest passes first, then the largest tile. Rows
// aligned to 4 or 8 bytes are copied as 16-byte windows when every page
// is a multiple of 16 bytes (a window then never reaches past the pool).
// Returns false if nothing fits (unreachable: one head in 16-token tiles
// does).
template <typename T, typename KV, int VB>
bool any_plan(AnyPlan& pl, int num_heads, int num_kv_heads, int D,
              int page_size, int pages_per_seq, long long page_stride,
              int splits, int stages) {
  using A = typename std::conditional<std::is_same<T, double>::value, double,
                                      float>::type;
  constexpr int VE = unit_elems<VB, KV>();
  const int sz = sizeof(KV), asz = sizeof(A);
  const int qpk = num_heads / num_kv_heads;
  pl.splits = splits;
  pl.per = (pages_per_seq + splits - 1) / splits;
  pl.st = stages;
  pl.vb = VB;
  pl.dout = D < 256 ? D : 256;
  pl.chunks = (D + pl.dout - 1) / pl.dout;
  // TMA: rows of whole units (D sz % 4 == 0) a multiple of 16 bytes apart
  // (the pool's rows, F sz), one chunk, tiles of whole pages or pages of
  // whole tiles (below)
  pl.tma = pl.tma != 0 && VB >= 4 &&
           (long long)num_kv_heads * D * sz % 16 == 0 && pl.chunks == 1;
  pl.rpp = static_cast<int>(page_stride / ((long long)num_kv_heads * D));
  if (pl.tma) {  // a box row: the head's columns from the 16-byte
                 // boundary at or below them (16 - VB bytes early at most),
                 // an odd number of 16-byte units where a box may be that
                 // wide (256 columns): the rows a warp reads at one unit
                 // then fall in different banks
    const int units = (D * sz + 31 - VB) / 16;
    pl.sk = pl.sv = 4 * (units % 2 == 0 && (units + 1) * 16 <= 256 * sz
                             ? units + 1 : units);
  } else {
    pl.sk = row_words(D * sz, VB);
    pl.sv = row_words(pl.dout * sz, VB);
  }
  pl.ro = (pl.dout + VE - 1) / VE * VE;
  pl.hw = ((pl.ro + 2) * asz + 15) / 16 * 4;
  const int dq = (D + VE - 1) / VE * VE;
  const int units = pl.ro / VE;
  // 4 warps for one f32 query head a kv head: its blocks are many and
  // short, and an SM holds twice as many of them (registers); 8 warps
  // for the products of a group or of float64
  pl.nt = qpk == 1 && asz == 4 ? 128 : kAnyThreads;
  bool found = false;
  for (int lt = 6; lt >= 4; --lt) {
    const int tt = 1 << lt;
    if (pl.tma && page_size % tt != 0 && tt % page_size != 0) continue;
    for (int qh = qpk; qh >= 1; --qh) {
      AnyPlan c = pl;
      c.tt = tt;
      c.box = std::min(kBoxRows, std::min(tt, page_size));
      c.ltt = lt;
      c.qh = qh;
      c.passes = (qpk + qh - 1) / qh;
      c.hb = std::min(kMaxHb, qh);
      c.lds = 0;
      while (c.lds < 5 && (qh + c.hb - 1) / c.hb * tt * (2 << c.lds) <= c.nt)
        ++c.lds;
      c.ds = 1 << c.lds;
      c.sb = std::max(1, c.nt / (qh * units));
      c.hs = (qh + splits - 1) / splits;
      int o = 128;  // the mbarriers; TMA boxes 128-byte aligned
      c.o_stage = o;
      o = align16(o + stages * tt * (c.sk + (c.tma ? 0 : c.sv)) * 4);
      c.o_rows = o;
      o = align16(o + (stages + 1) * tt * 8);
      c.o_q = o;
      o = align16(o + qh * dq * asz);
      c.o_s = o;
      o = align16(o + qh * tt * asz);
      c.o_rec = o;
      o = align16(o + c.sb * qh * c.hw * 4);
      c.o_alpha = o;
      o = align16(o + qh * asz);
      c.o_recv = o;
      o = align16(o + (splits > 1 ? splits * c.hs * c.hw * 4 : 0));
      c.o_w = o;
      o = align16(o + (splits + 3) * c.hs * asz);
      c.smem = o;
      if (c.smem > kSmemMax) continue;
      if (!found || c.passes < pl.passes) pl = c;
      found = true;
      break;
    }
  }
  if (!found && pl.tma) {  // no tile divides the pages: copies
    pl.tma = 0;
    return any_plan<T, KV, VB>(pl, num_heads, num_kv_heads, D, page_size,
                               pages_per_seq, page_stride, splits, stages);
  }
  return found;
}

// The map of a pool's rows ([rows, cols] of `type`, `stride` bytes apart) in
// boxes of box_rows x box_cols, encoded once and kept: a decode step calls
// the kernel once a layer over one pool (layer-stacked: page_offset), on a
// host that holds the card back. The last kMapCache maps are kept,
// replaced round robin; a map is a function of its key alone.
constexpr int kMapCache = 16;
struct MapKey {
  const void* base;
  CUtensorMapDataType type;
  long long rows, stride;
  int cols, box_rows, box_cols;
  CUtensorMapSwizzle swizzle;
  bool operator==(const MapKey& o) const {
    return base == o.base && type == o.type && rows == o.rows &&
           stride == o.stride && cols == o.cols && box_rows == o.box_rows &&
           box_cols == o.box_cols && swizzle == o.swizzle;
  }
};

cudaError_t pool_map(CUtensorMap* map, const MapKey& key) {
  static std::mutex mu;
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return cudaSuccess;
    }
  // the encoder needs the pool's device current on this thread: made so
  // for the encode, and the caller's device restored
  cudaPointerAttributes at;
  int current = 0;
  cudaError_t err = cudaPointerGetAttributes(&at, key.base);
  if (err == cudaSuccess) err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(at.device);
  if (err != cudaSuccess) return err;
  const int rc = hopper::row_map(map, key.base, key.type, key.rows, key.cols,
                                 key.stride, key.box_rows, key.box_cols,
                                 key.swizzle);
  if (current != at.device) err = cudaSetDevice(current);
  if (rc != 0) return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  if (used < kMapCache) ++used;
  return cudaSuccess;
}

template <typename T, typename KV, int VB>
cudaError_t launch_any_vb(const void* q, const void* k, const void* v,
                          const void* new_k, const void* new_v,
                          const int* page_table, const int* lengths,
                          const int* windows, void* out, int batch,
                          int num_heads, int num_kv_heads, int D, int page_size,
                          int pages_per_seq, long long pool_rows,
                          long long page_stride, long long page_offset,
                          int static_window, double sm_scale, int splits,
                          int stages, cudaStream_t stream) {
  // f32 accumulators, f64 for float64
  using A = typename std::conditional<std::is_same<T, double>::value, double,
                                      float>::type;
  AnyPlan pl;
  pl.tma = -1;  // undecided
  if (!any_plan<T, KV, VB>(pl, num_heads, num_kv_heads, D, page_size,
                           pages_per_seq, page_stride, splits, stages))
    return cudaErrorInvalidValue;
  // the maps of the K and V rows ([pool_rows, F] of KV, F sz bytes apart),
  // boxes of pl.box rows by the head's columns
  CUtensorMap maps[2] = {};
  if (pl.tma) {
    const void* bases[2] = {k, v};
    const long long stride = (long long)num_kv_heads * D * sizeof(KV);
    for (int i = 0; i < 2; ++i) {
      const cudaError_t err = pool_map(
          &maps[i], MapKey{bases[i], hopper::map_type<KV>(), pool_rows, stride,
                           num_kv_heads * D, pl.box,
                           pl.sk * 4 / static_cast<int>(sizeof(KV)),
                           CU_TENSOR_MAP_SWIZZLE_NONE});
      if (err != cudaSuccess) return err;
    }
  }
  auto kernel = paged_attention_any<T, KV, A, VB>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, batch, num_kv_heads * pl.passes * pl.chunks);
  cfg.blockDim = dim3(pl.nt);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // a cluster of one block without a split (on an H100 the MHA layer ran
  // 4-12% faster so than by a plain launch: PERF.md §6)
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const T*>(new_k),
      static_cast<const T*>(new_v), page_table, lengths, windows,
      static_cast<T*>(out), num_heads, num_kv_heads, D, page_size,
      pages_per_seq, page_stride, page_offset, static_window,
      static_cast<A>(sm_scale), pl, maps[0], maps[1]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan and the maps of a paged_attention_fixed launch, then the launch:
// the caller's `splits` ask for splits x kFixSplitWarps parts over a
// sequence's keys, as warps of one block up to kFixWarps and as cluster
// ranks past that (on an H100 one block of 8 warps beat a cluster of 2
// blocks of 4 at the serving decode: PERF.md §6); the maps of the pool's K
// and V rows ([pool_rows, F] of KV, F sz bytes apart), boxes of kFixBox
// rows by CW bytes of the head's columns, swizzled over CW
template <typename T, typename KV, int D, bool MMA>
cudaError_t launch_fixed(const void* q, const void* k, const void* v,
                         const void* new_k, const void* new_v,
                         const int* page_table, const int* lengths,
                         const int* windows, void* out, int batch, int num_heads,
                         int num_kv_heads, int page_size, int pages_per_seq,
                         long long pool_rows, long long page_stride,
                         long long page_offset, int static_window,
                         double sm_scale, int splits, cudaStream_t stream) {
  using S = FixShape<KV, D>;
  const long long F = (long long)num_kv_heads * D;
  if (page_stride % F != 0 || pool_rows < kFixBox || pool_rows > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  const int qpk = num_heads / num_kv_heads;
  FixPlan pl = {};
  const int ranks = (splits * kFixSplitWarps + kFixWarps - 1) / kFixWarps;
  pl.ranks = ranks;
  pl.hs = (qpk + ranks - 1) / ranks;
  pl.rows = static_cast<int>(pool_rows);
  int o = kFixWarps * S::SLOTS * S::SLOT;  // the warps' rings, 1 KB aligned
  pl.o_bar = o;
  o = align16(o + (kFixWarps * S::SLOTS + 1) * 8);
  pl.o_recv = o;
  o = align16(o + (ranks > 1 ? ranks * kFixWarps * pl.hs * S::REC * 4 : 0));
  pl.o_w = o;
  o = align16(o + (pl.hs + D) * 4);
  pl.o_q = o;
  o = align16(o + (MMA ? 0 : kMaxQ * D * 4));
  pl.o_p = o;
  o += MMA ? 0 : kFixWarps * kMaxQ * kFixBox * 4;
  pl.smem = o + 1024;  // room to align the rings
  CUtensorMap maps[2] = {};
  const void* bases[2] = {k, v};
  for (int i = 0; i < 2; ++i) {
    const cudaError_t err = pool_map(
        &maps[i],
        MapKey{bases[i], hopper::map_type<KV>(), pool_rows,
               F * static_cast<long long>(sizeof(KV)), static_cast<int>(F),
               kFixBox, S::CW / static_cast<int>(sizeof(KV)),
               S::CW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B});
    if (err != cudaSuccess) return err;
  }
  auto kernel = paged_attention_fixed<T, KV, D, MMA>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, batch, num_kv_heads);
  cfg.blockDim = dim3(kFixWarps * 32);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(new_k),
      static_cast<const T*>(new_v), page_table, lengths, windows,
      static_cast<T*>(out), num_heads, num_kv_heads, page_size, pages_per_seq,
      static_cast<int>(page_stride / F), page_offset, static_window,
      static_cast<float>(sm_scale * 1.4426950408889634), pl, maps[0], maps[1]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The copy pieces' bytes: the largest of 16, 8, 4, 2, 1 that divides a
// row's bytes (every row offset is a multiple of D elements of a 16-byte
// aligned pool, every chunk's of 256 elements), a kernel instance each.
template <typename T, typename KV>
cudaError_t launch_any(const void* q, const void* k, const void* v,
                       const void* new_k, const void* new_v,
                       const int* page_table, const int* lengths,
                       const int* windows, void* out, int batch, int num_heads,
                       int num_kv_heads, int D, int page_size,
                       int pages_per_seq, long long pool_rows,
                       long long page_stride, long long page_offset,
                       int static_window, double sm_scale, int splits,
                       int stages, cudaStream_t stream) {
  if (stages < 1 || stages > kMaxStages) return cudaErrorInvalidValue;
  const int vb = piece_bytes((long long)D * sizeof(KV));
#define LAMP_PA_ANY(VB)                                                          \
  if (vb == VB) {                                                                \
    if constexpr (VB >= static_cast<int>(sizeof(KV)))                           \
      return launch_any_vb<T, KV, VB>(q, k, v, new_k, new_v, page_table, lengths, \
                                      windows, out, batch, num_heads,            \
                                      num_kv_heads, D, page_size, pages_per_seq, \
                                      pool_rows, page_stride, page_offset,       \
                                      static_window, sm_scale, splits, stages,   \
                                      stream);                                   \
  }
  LAMP_PA_ANY(16)
  LAMP_PA_ANY(8)
  LAMP_PA_ANY(4)
  LAMP_PA_ANY(2)
  LAMP_PA_ANY(1)
#undef LAMP_PA_ANY
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: q's (and new_k/new_v's and out's): 0 = float32, 1 = bfloat16,
// 2 = float16, 3 = float64. kv_dtype: the pools': 0 = float32, 1 =
// bfloat16, 4 = float16, 5 = float64 (each only with a q of the same
// dtype), 2 = float8_e4m3fn, 3 = float8_e5m2 (with a float32, bfloat16 or
// float16 q). float64 computes in double, in paged_attention_any. Any
// head_dim and any number of query heads per kv head: D = 64 or 128 with
// at most kMaxQ of them and pages of a multiple of kFixBox tokens take
// paged_attention_fixed (which takes `splits` and keeps its own ring),
// everything else paged_attention_any with a ring of `stages` (1 to 3);
// both over `splits` blocks a sequence's pages (1 to 8, at most
// pages_per_seq): the caller's plan, which it passes on every call.
// total_pages: the pool's pages (its first dimension), which bound the
// kernels' reads. Returns the cudaError_t of the launch; the caller raises
// on non-zero.
int lamp_paged_attention(const void* q, const void* k, const void* v,
                         const void* new_k, const void* new_v, const void* page_table,
                         const void* lengths, const void* windows, void* out,
                         int batch, int num_heads, int num_kv_heads, int head_dim,
                         int page_size, int pages_per_seq, int total_pages,
                         long long page_stride, long long page_offset,
                         int static_window, double sm_scale, int dtype, int kv_dtype,
                         int splits, int stages, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (num_kv_heads <= 0 || head_dim <= 0 || num_heads % num_kv_heads != 0 ||
      page_size <= 0 || total_pages <= 0 || splits < 1 || splits > kMaxSplits ||
      splits > pages_per_seq)
    return cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  const int* wn = static_cast<const int*>(windows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the pool's rows in the maps: a page's rows lie page_stride / F rows
  // apart (2 pages of rows in the fused pool)
  const long long F = (long long)num_kv_heads * head_dim;
  const long long pool_rows =
      (long long)(total_pages - 1) * (page_stride / F) + page_size;
  const bool fixed = num_heads / num_kv_heads <= kMaxQ && page_size % kFixBox == 0;
#define LAMP_PA_FIXED(T, KV, D)                                                     \
  return launch_fixed<T, KV, D, (sizeof(T) == 2)>(                                   \
      q, k, v, new_k, new_v, pt, ln, wn, out, batch, num_heads, num_kv_heads,        \
      page_size, pages_per_seq, pool_rows, page_stride, page_offset, static_window,  \
      sm_scale, splits, st)
#define LAMP_PA_DIMS(T, KV)                                                       \
  if (fixed && head_dim == 64) LAMP_PA_FIXED(T, KV, 64);                          \
  if (fixed && head_dim == 128) LAMP_PA_FIXED(T, KV, 128);                        \
  return launch_any<T, KV>(q, k, v, new_k, new_v, pt, ln, wn, out, batch,         \
                           num_heads, num_kv_heads, head_dim, page_size,          \
                           pages_per_seq, pool_rows, page_stride, page_offset,    \
                           static_window, sm_scale, splits, stages, st)
  if (dtype == 1 && kv_dtype == 1) { LAMP_PA_DIMS(__nv_bfloat16, __nv_bfloat16); }
  if (dtype == 0 && kv_dtype == 0) { LAMP_PA_DIMS(float, float); }
  if (dtype == 2 && kv_dtype == 4) { LAMP_PA_DIMS(__half, __half); }
  if (dtype == 1 && kv_dtype == 2) { LAMP_PA_DIMS(__nv_bfloat16, __nv_fp8_e4m3); }
  if (dtype == 1 && kv_dtype == 3) { LAMP_PA_DIMS(__nv_bfloat16, __nv_fp8_e5m2); }
  if (dtype == 0 && kv_dtype == 2) { LAMP_PA_DIMS(float, __nv_fp8_e4m3); }
  if (dtype == 0 && kv_dtype == 3) { LAMP_PA_DIMS(float, __nv_fp8_e5m2); }
  if (dtype == 2 && kv_dtype == 2) { LAMP_PA_DIMS(__half, __nv_fp8_e4m3); }
  if (dtype == 2 && kv_dtype == 3) { LAMP_PA_DIMS(__half, __nv_fp8_e5m2); }
  if (dtype == 3 && kv_dtype == 5)
    return launch_any<double, double>(q, k, v, new_k, new_v, pt, ln, wn, out, batch,
                                      num_heads, num_kv_heads, head_dim, page_size,
                                      pages_per_seq, pool_rows, page_stride,
                                      page_offset, static_window, sm_scale, splits,
                                      stages, st);
#undef LAMP_PA_DIMS
#undef LAMP_PA_FIXED
  return cudaErrorInvalidValue;
}

const char* lamp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
