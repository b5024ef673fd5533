// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of lamp_tpu/ops/attention.py:
//   K1  _fwd_kernel (driven by _fwd)                 -> fwd_tc / fwd_f32
//   K2a _bwd_fused_kernel (driven by _bwd_fused)     -> dq_* then dkv_*
//   K2b _bwd_dq_kernel, K2c _bwd_dkv_kernel          -> dq_*, dkv_*
//   K3a/K3b _compact_{fwd,bwd}_kernel (compact_attention) compute the same
//   function on short sequences; here they are the same kernels.
//
// Layout: q, o, dq [B*H, Sq, d]; k, v, dk, dv [B*H, Skv, d]; lse, di
// [B*H, Sq] f32, all contiguous. d is any multiple of 8 up to 128; it runs
// in the smallest instance D of 32, 64 and 128 with D >= d: the columns
// past d read as 0 (TMA boxes past the tensor map's inner extent are
// zero-filled, cp.async copies past d are zero-filled) and stores stop at
// d. Nothing is padded in device memory. Types: float32, bfloat16 and
// float16 (the tensor-core kernels are templated on the 16-bit type).
//
// Visibility, in one place. A key c is visible to row r when
//  1. c lies in the row's key bounds [lo, hi) (key_bounds): c < min(Skv,
//     limit) for an optional per-row kv limit (limits[b * lim_bstride + r *
//     lim_rstride]: strides (1, 0) for a [B] tensor, (Sq, 1) for [B, Sq]);
//     if causal, c <= r + (Skv - Sq), and with a window w > 0, c > r +
//     (Skv - Sq) - w;
//  2. and, when segment ids are given ([B, Sq] and [B, Skv] int32), its id
//     equals the row's;
//  3. and, when a boolean mask is given, mask[b, h, r, c] is set. The mask
//     is read in place through its strides, 0 on a broadcast axis.
// (2) and (3) are classified once a forward call, by the tile_classes
// kernel, per block of 64 rows by 64 keys: kSkip (nothing visible), kFull
// (neither hides a pair) or kPartial. The map ([B or 1, H or 1, Sq / 64,
// Skv / 64] bytes) is kept for the backward. Every kernel walks its tiles
// in three classes: skipped (the map says kSkip, or the bounds leave no
// key: not loaded where the kernel chooses its tiles, no product), uniform
// (kFull and inside the bounds' band: no per-element test), and
// per-element (the bounds as two compares; ids and mask only in kPartial
// tiles). The tensor-core kernels have two instances, M = true when ids
// or a mask are given: the unmasked one compiles rule 1 alone, so that
// the class map's reads and the per-element code of rules 2-3 cost calls
// without them nothing (sharing one instance, they made the causal
// forward 1.8x slower and dkv 1.2x on an H100, in registers and code of
// the hot loop). Rows with no visible key give o = 0, lse = -inf and zero
// gradients (the TPU kernel gives the mean of V when a tile ran, because
// its NEG_INF is finite).
//
// What bounds it: tensor-core operations. The causal forward does
// 2 * B * H * S^2 * D FLOPs (two products over half the score matrix):
// 51.5 GFLOP at the training slice's B=2, H=12, S=4096, D=64, 52 us at the
// H100's 989 TFLOP/s bf16 dense rate, against 25 MB of q/k/v/o (7.5 us at
// 3.35 TB/s). Any backward needs 5 products (128.8 GFLOP, 130.3 us); the
// split one here does 7 (dq recomputes S and dP: 180.4 GFLOP, 182.4 us).
// At the flagship's B=8, S=384 the backward is bound by bytes: q, k, v, o,
// do read and dq, dk, dv written once, 37.7 MB, 11.3 us. Packed documents
// cut the work to the visible tiles, about sum(len^2) / 2 a row of B.
//
// Forward (FlashAttention-2 on mma.sync): one block of 4 warps per (b*h,
// 64-row q tile); each warp owns 16 query rows, keeps Q fragments, the f32
// output accumulator and the online-softmax max and sum in registers, and
// walks 64-key K/V tiles staged in shared memory by cp.async, the next
// visible tile in flight while this one is used; fragments come from
// shared memory by ldmatrix. Tiles above the causal diagonal, below the
// window band, past every row's kv limit or of class kSkip are not
// visited (the TPU kernel's skipped grid steps). P is rounded to v's type
// for P @ V, as p.astype(v.dtype) in the TPU kernel. The q tiles run
// last-first, so the long causal rows start first.
//
// 16-bit backward (wgmma, TMA and mbarriers; hopper.cuh): the split
// design, a dq kernel, then a dkv kernel. Each block is a producer
// warpgroup and two consumer warpgroups (setmaxnreg: 40 and 232 registers
// a thread). The producer's first warp streams tiles by TMA (3-D tensor
// maps [B*H, S, d], 128-byte swizzled, 64-byte at D = 32, zero-filled past
// a ragged end) into a ring of 4 stages, each completing on a `full`
// mbarrier and refilled after its `empty` mbarrier has the 256 consumer
// arrivals. The producer loads a tile unless the class map hides it from
// both consumers; producer and consumers compute that sequence from the
// same map bytes, so they agree on every stage. A consumer whose own half
// the map or the bounds hide retires the stage unused (after retiring the
// product it holds, so that a run of skipped tiles cannot starve the
// producer).
//  - dq: a block owns 128 rows (64 a consumer), Q and dO resident; it first
//    computes di = rowsum(o * do) in f32 for its rows from o and do and
//    writes it for dkv. Per K/V tile of 128 keys (64 at D=128): S = Q K^T
//    and dP = dO V^T (wgmma, A and B K-major from shared memory), p = exp2(s
//    scale log2e - lse log2e), dS = p (dP - di) scale rounded to q's type
//    as the register A of dQ += dS K (B = K read MN-major, the transpose
//    bit). Row blocks run last-first (long causal rows first). The kv ids
//    of a per-element tile are read from device memory (L1).
//  - dkv: a block owns 128 keys (64 a consumer), K and V resident. The
//    producer streams q tiles of 64 rows (32 at D=128) with each row's
//    lse log2e, di, visible key range [lo, hi) and segment id, loaded one
//    loaded tile ahead. Per tile: S^T = K Q^T and dP^T = V dO^T (K-major),
//    p^T rounded to do's type as the register A of dV += P^T dO, dS^T = p^T
//    (dP^T - di) scale rounded to q's type as the register A of dK += dS^T
//    Q (dO and Q MN-major). dK and dV stay in f32 registers to the block's
//    one store. Key blocks run first-first (key 0 sees the most rows).
//  - in both, a tile's register-A products run on while the next tile's S
//    and dP are issued; its stage is released when they are done. The
//    accumulator of m64nN holds, per 8-column chunk j, rows g and g + 8 at
//    columns 8j + 2t, 8j + 2t + 1, the layout of the A operand, so p and dS
//    become A operands by packing pairs (acc_to_a); exp2 is ex2.approx.ftz.
//  - numerics as _bwd_fused_kernel: f32 accumulation, the softmax in the
//    log2 domain, P rounded to do's type for dV, dS to q's type for dK
//    and dQ, rows without a visible key exactly 0. No atomics and no
//    partial-dq slab: every sum runs in a fixed order, so a call gives the
//    same bits every time.
//  - float32 inputs take scalar kernels (one thread per row or key, f32
//    FMAs, no tensor cores; dq_f32 computes di too): f32 is for checking,
//    not for speed.
//
// Resources (ptxas -v for sm_90a, on the build of this source): the
// backward kernels, 384 threads, report 168 registers (the launch bound;
// the consumers run at 232 after setmaxnreg); dynamic shared memory (with
// 1 KB for alignment) 161 KB (dq) and 97 KB (dkv) at D=64, 193 KB and 129
// KB at D=128, 81 KB and 49 KB at D=32, beside a few KB of static (the
// masked instances' class bytes and kv ids, dkv's row statistics).
// fwd_tc (128 threads, 45 / 85 / 25 KB at D = 64 / 128 / 32): the
// unmasked instance 130, 170 and 100 registers; the masked one is held to
// 168 at D=64 by its launch bound. The f32 kernels (64 threads) spill at
// D=64 and D=128. chip_smoke.py prints the whole table first.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;
using hopper::pack2;
using hopper::unpack2;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;  // fwd_tc: 4 warps of 16 rows
constexpr int kPad = 8;        // shared-memory row padding, 16-bit elements
constexpr int kBlock = 64;     // rows and keys of a class-map block

// classes of a 64 x 64 block under segment ids and the mask
constexpr unsigned char kSkip = 0, kFull = 1, kPartial = 2;

struct Problem {
  int heads, sq, skv, d;       // d: the true head dim (<= the instance's D)
  int causal, window, offset;  // offset = Skv - Sq aligns the diagonal
  const int* limits;           // per-row kv limits, or null
  int lim_bstride, lim_rstride;
  const int* q_ids;            // segment ids [B, Sq] and [B, Skv], or null
  const int* kv_ids;
  const unsigned char* mask;   // keep-mask through its strides, or null
  long long mask_b, mask_h, mask_r, mask_c;
  unsigned char* tiles;        // class map, or null (no ids, no mask)
  long long tile_b, tile_h;
  int tiles_q, tiles_k;
  float scale;
};

// Keys [0, limit) may be visible to this row; 0 for rows past Sq.
__device__ __forceinline__ int row_limit(const Problem& p, int b, int row) {
  if (row >= p.sq) return 0;
  int lim = p.skv;
  if (p.limits != nullptr)
    lim = min(lim, p.limits[(long long)b * p.lim_bstride +
                            (long long)row * p.lim_rstride]);
  return lim;
}

// rule 1 of the header: the kv limit, the causal diagonal and the window
__device__ __forceinline__ bool visible(const Problem& p, int row, int lim,
                                        int col) {
  if (col >= lim) return false;
  if (p.causal) {
    const int diag = row + p.offset;
    if (col > diag) return false;
    if (p.window > 0 && col <= diag - p.window) return false;
  }
  return true;
}

// The keys [lo, hi) that `row` sees under rule 1: visible() as two bounds,
// so that a masked tile costs two compares an element. hi = 0 for rows
// past Sq.
__device__ __forceinline__ int2 key_bounds(const Problem& p, int b, int row) {
  int lo = 0, hi = row_limit(p, b, row);
  if (p.causal) {
    const int diag = row + p.offset;
    hi = min(hi, diag + 1);
    if (p.window > 0) lo = diag - p.window + 1;
  }
  return make_int2(lo, hi);
}

// rule 3 at a (row, key) inside the tensors
__device__ __forceinline__ bool mask_keeps(const Problem& p, int b, int h,
                                           int row, int col) {
  return p.mask == nullptr ||
         p.mask[b * p.mask_b + h * p.mask_h + row * p.mask_r +
                col * p.mask_c] != 0;
}

// rules 2 and 3 at a (row, key) inside the tensors
__device__ __forceinline__ bool keep(const Problem& p, int b, int h, int row,
                                     int col) {
  if (p.q_ids != nullptr && p.q_ids[(long long)b * p.sq + row] !=
                                p.kv_ids[(long long)b * p.skv + col])
    return false;
  return mask_keeps(p, b, h, row, col);
}

// The class-map row of rows block qb (tiles_k bytes, one per 64-key
// block), or null past the last block (every span of it skips).
__device__ __forceinline__ const unsigned char* class_row(const Problem& p,
                                                          int b, int h,
                                                          int qb) {
  if (qb >= p.tiles_q) return nullptr;
  return p.tiles + b * p.tile_b + h * p.tile_h + (long long)qb * p.tiles_k;
}

// entries of the class map a block stages in shared memory (rows or keys
// up to 65536); a longer row is read in place
constexpr int kMaxTiles = 1024;

// The class of a row's keys [c0, c0 + cols) (c0 on a block edge): kSkip
// when every block of the span skips, kFull when every one is full, else
// kPartial. `row` holds n entries (null: skip); without ids and mask
// (p.tiles null) every span is full.
__device__ __forceinline__ int span_class(const unsigned char* row, int n,
                                          int c0, int cols) {
  if (row == nullptr) return kSkip;
  const int k1 = min(n, (c0 + cols + kBlock - 1) / kBlock);
  bool any = false, all = true;
  for (int kb = c0 / kBlock; kb < k1; ++kb) {
    const unsigned char c = row[kb];
    any |= c != kSkip;
    all &= c == kFull;
  }
  return !any ? kSkip : all ? kFull : kPartial;
}

// the f32 kernels read the map in place
__device__ __forceinline__ int span_class(const Problem& p, int b, int h,
                                          int qb, int c0, int cols) {
  if (p.tiles == nullptr) return kFull;
  return span_class(class_row(p, b, h, qb), p.tiles_k, c0, cols);
}

// Keys [lo, hi) that rows [r0, r0 + rows) can see under causal and window.
__device__ __forceinline__ void kv_range(const Problem& p, int r0, int rows,
                                         int* lo, int* hi) {
  *lo = 0;
  *hi = p.skv;
  if (p.causal) {
    *hi = min(p.skv, r0 + rows + p.offset);
    if (p.window > 0) *lo = max(0, r0 + p.offset - p.window + 1);
  }
}

// Rows [lo, hi) that can see some key of [c0, c0 + cols).
__device__ __forceinline__ void q_range(const Problem& p, int c0, int cols,
                                        int* lo, int* hi) {
  *lo = 0;
  *hi = p.sq;
  if (p.causal) {
    *lo = max(0, c0 - p.offset);
    if (p.window > 0) *hi = min(p.sq, c0 + cols - 1 - p.offset + p.window);
  }
}

// True when the bounds keep every (row, key) of the tile: no per-row
// limits, no ragged edge, and the tile lies inside the causal band.
__device__ __forceinline__ bool full_tile(const Problem& p, int r0, int rows,
                                          int c0, int cols) {
  if (p.limits != nullptr || r0 + rows > p.sq || c0 + cols > p.skv)
    return false;
  if (!p.causal) return true;
  return c0 + cols - 1 <= r0 + p.offset &&
         (p.window <= 0 || c0 > r0 + rows - 1 + p.offset - p.window);
}

// The class map: one thread per (64-row block, 64-key block) of one slab
// (b, h) of the map. Segment ids classify by their ranges, as the TPU
// kernel's tile skip does (disjoint: kSkip; one id throughout: kFull); the
// mask by its bytes (none set: kSkip; all set: kFull).
__global__ void tile_classes(Problem p, int map_heads) {
  const int b = blockIdx.y / map_heads, h = blockIdx.y % map_heads;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.tiles_q * p.tiles_k) return;
  const int qb = idx / p.tiles_k, kb = idx % p.tiles_k;
  const int r0 = qb * kBlock, r1 = min(p.sq, r0 + kBlock);
  const int c0 = kb * kBlock, c1 = min(p.skv, c0 + kBlock);
  unsigned char cls = kFull;
  if (p.q_ids != nullptr) {
    int qlo = INT_MAX, qhi = INT_MIN, klo = INT_MAX, khi = INT_MIN;
    for (int r = r0; r < r1; ++r) {
      const int id = p.q_ids[(long long)b * p.sq + r];
      qlo = min(qlo, id);
      qhi = max(qhi, id);
    }
    for (int c = c0; c < c1; ++c) {
      const int id = p.kv_ids[(long long)b * p.skv + c];
      klo = min(klo, id);
      khi = max(khi, id);
    }
    if (qhi < klo || khi < qlo)
      cls = kSkip;
    else if (!(qlo == qhi && klo == khi && qlo == klo))
      cls = kPartial;
  }
  if (cls != kSkip && p.mask != nullptr) {
    bool any = false, all = true;
    for (int r = r0; r < r1 && (all || !any); ++r) {
      const unsigned char* m =
          p.mask + b * p.mask_b + h * p.mask_h + r * p.mask_r;
      for (int c = c0; c < c1; ++c) {
        const bool set = m[c * p.mask_c] != 0;
        any |= set;
        all &= set;
      }
    }
    if (!any)
      cls = kSkip;
    else if (!all)
      cls = kPartial;
  }
  p.tiles[b * p.tile_b + h * p.tile_h + idx] = cls;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// 16-bit tensor-core building blocks (mma.sync m16n8k16, f32 accumulators).
// In a warp, lane = 4 * g + t. An A fragment (16 x 16) holds rows g and g + 8,
// columns 2t, 2t + 1, 2t + 8, 2t + 9; a B fragment (16 x 8) holds k = 2t,
// 2t + 1, 2t + 8, 2t + 9 of column g; a C fragment (16 x 8) holds rows g
// (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t and 2t + 1. Fragments
// come from shared memory by ldmatrix, four 8 x 8 matrices at a time; tiles
// come from device memory by cp.async, one tile ahead of the one in use.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value)
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment of rows row0.., columns k0.. of a row-major tile with row
// stride S
template <int S, typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* s, int row0,
                                       int k0, int lane) {
  ldsm_x4(a, s + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + k0 +
                 (lane >> 4) * 8);
}

// B fragments of the n-tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) at
// k0, for B[k][n] = s[n][k] (a tile stored [n][k])
template <int S, typename T>
__device__ __forceinline__ void load_b_nk(uint32_t* b, const T* s, int n0,
                                          int k0, int lane) {
  ldsm_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * S + k0 +
                 ((lane >> 3) & 1) * 8);
}

// the same for B[k][n] = s[k][n] (a tile stored [k][n])
template <int S, typename T>
__device__ __forceinline__ void load_b_kn(uint32_t* b, const T* s, int k0,
                                          int n0, int lane) {
  ldsm_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + n0 +
                       (lane >> 4) * 8);
}

// C fragments of 2 * N adjacent 16 x 8 tiles -> A fragments of N 16 x 16
// tiles (the score tile becomes the left operand of the next product).
template <int N, typename T>
__device__ __forceinline__ void c_to_a(uint32_t (*a)[4], float (*c)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i][0] = pack2<T>(c[2 * i][0], c[2 * i][1]);
    a[i][1] = pack2<T>(c[2 * i][2], c[2 * i][3]);
    a[i][2] = pack2<T>(c[2 * i + 1][0], c[2 * i + 1][1]);
    a[i][3] = pack2<T>(c[2 * i + 1][2], c[2 * i + 1][3]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + ROWS) of a [n, d] matrix into a padded shared tile of
// D columns, by cp.async; rows past n and columns past d are zero-filled
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile(T* s, const T* g, int row0, int n,
                                          int d) {
  constexpr int kChunks = D / 8;  // 16-byte copies per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n && c * 8 < d;
    cp_async16(s + r * (D + kPad) + c * 8,
               g + (in ? (long long)(row0 + r) * d + c * 8 : 0), in);
  }
}

// M: segment ids or a mask are given (the class map and rules 2-3 are
// compiled in); without them the loop is rule 1's alone
// The masked instance at D=64 is held to 168 registers, so that three
// blocks share an SM as the unmasked one's 130 allow: packed rows give
// many short blocks, whose latency the third block hides.
template <int D, typename T, bool M>
__global__ void __launch_bounds__(kThreads, M && D == 64 ? 3 : 1)
fwd_tc(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
       Problem p) {
  constexpr int BR = 64, BC = 64, S = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kv = qs + BR * S;  // two stages of [K tile, V tile]
  __shared__ int lim_max;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int qb = gridDim.x - 1 - blockIdx.x, r0 = qb * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long qbase = (long long)bh * p.sq * p.d;
  const long long kbase = (long long)bh * p.skv * p.d;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const int la = row_limit(p, b, ra), lb = row_limit(p, b, rb);

  if (tid == 0) lim_max = 0;
  load_tile<D, BR>(qs, q + qbase, r0, p.sq, p.d);
  cp_commit();
  // masked: this row block's class-map row in shared memory, the segment
  // ids of rows ra and rb, and each staged tile's kv ids (0 without ids)
  __shared__ unsigned char cls_s[M ? kMaxTiles : 1];
  __shared__ int kid_s[2][M ? BC : 1];
  // kv ids of keys [c, c + BC) into kid_s[st]; one id a thread
  auto stage_ids = [&](int st, int c) {
    if constexpr (M) {
      if (tid < BC)
        kid_s[st][tid] = p.q_ids != nullptr && c + tid < p.skv
                             ? p.kv_ids[(long long)b * p.skv + c + tid] : 0;
    }
  };
  const unsigned char* crow = nullptr;
  int qid_a = 0, qid_b = 0;
  int2 ba = make_int2(0, 0), bb = ba;
  if constexpr (M) {
    ba = key_bounds(p, b, ra);
    bb = key_bounds(p, b, rb);
    crow = class_row(p, b, h, qb);
    if (p.tiles_k <= kMaxTiles) {
      for (int i = tid; i < p.tiles_k; i += kThreads) cls_s[i] = crow[i];
      crow = cls_s;
    }
    if (p.q_ids != nullptr) {
      qid_a = ra < p.sq ? p.q_ids[(long long)b * p.sq + ra] : 0;
      qid_b = rb < p.sq ? p.q_ids[(long long)b * p.sq + rb] : 0;
    }
  }
  __syncthreads();
  atomicMax(&lim_max, max(la, lb));
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, BR, &lo, &hi);
  hi = min(hi, lim_max);
  // the first tile at or after c that the class map does not skip
  auto next = [&](int c) {
    if constexpr (M)
      while (c < hi && span_class(crow, p.tiles_k, c, BC) == kSkip) c += BC;
    return c;
  };
  int c0 = next((lo / BC) * BC);
  if (c0 < hi) {
    load_tile<D, BC>(kv, k + kbase, c0, p.skv, p.d);
    load_tile<D, BC>(kv + BC * S, v + kbase, c0, p.skv, p.d);
    stage_ids(0, c0);
  }
  cp_commit();
  cp_wait<1>();  // the Q tile
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<S>(qa[kk], qs, warp * 16, kk * 16, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const float sl2 = p.scale * kLog2e;

  for (int stage = 0; c0 < hi; stage ^= 1) {
    const int cn = next(c0 + BC);
    // the next tile's kv ids, stored once this stage's readers are done
    int kid_next = 0;
    if (cn < hi) {
      T* nxt = kv + (stage ^ 1) * 2 * BC * S;
      load_tile<D, BC>(nxt, k + kbase, cn, p.skv, p.d);
      load_tile<D, BC>(nxt + BC * S, v + kbase, cn, p.skv, p.d);
      if constexpr (M) {
        if (tid < BC && p.q_ids != nullptr && cn + tid < p.skv)
          kid_next = p.kv_ids[(long long)b * p.skv + cn + tid];
      }
    }
    cp_commit();
    cp_wait<1>();  // this tile
    __syncthreads();
    const T* ks = kv + stage * 2 * BC * S;
    const T* vs = ks + BC * S;
    float s[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BC / 8; j += 2) {
        uint32_t bf[4];
        load_b_nk<S>(bf, ks, j * 8, kk * 16, lane);
        mma<T>(s[j], qa[kk], bf[0], bf[1]);
        mma<T>(s[j + 1], qa[kk], bf[2], bf[3]);
      }
    }
    const bool partial = M && span_class(crow, p.tiles_k, c0, BC) != kFull;
    const bool full = !partial && full_tile(p, r0, BR, c0, BC);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + j * 8 + 2 * t + (e & 1);
        bool vis;
        if constexpr (M) {
          // rule 1 as the rows' key bounds (two compares), then rules 2
          // and 3 in partial tiles (ids 0 = 0 without ids)
          const int2 kb2 = e < 2 ? ba : bb;
          vis = full || (col >= kb2.x && col < kb2.y);
          if (partial) {
            vis = vis && (e < 2 ? qid_a : qid_b) ==
                             kid_s[stage][j * 8 + 2 * t + (e & 1)];
            if (p.mask != nullptr)
              vis = vis && mask_keeps(p, b, h, e < 2 ? ra : rb, col);
          }
        } else {
          vis = full || (e < 2 ? visible(p, ra, la, col)
                               : visible(p, rb, lb, col));
        }
        s[j][e] = vis ? s[j][e] * sl2 : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row with nothing visible so far keeps max -inf; exponentiate
    // against 0 there so that exp2(-inf) gives 0, never NaN
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mu_a);
      s[j][1] = exp2f(s[j][1] - mu_a);
      s[j][2] = exp2f(s[j][2] - mu_b);
      s[j][3] = exp2f(s[j][3] - mu_b);
      l_a += s[j][0] + s[j][1];
      l_b += s[j][2] + s[j][3];
    }
    uint32_t pa[BC / 16][4];
    c_to_a<BC / 16, T>(pa, s);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        load_b_kn<S>(bf, vs, kk * 16, n * 8, lane);
        mma<T>(acc[n], pa[kk], bf[0], bf[1]);
        mma<T>(acc[n + 1], pa[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
    if constexpr (M) {
      if (tid < BC) kid_s[stage ^ 1][tid] = kid_next;
    }
    c0 = cn;
  }
  cp_wait<0>();

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float ia = l_a == 0.f ? 0.f : 1.f / l_a;
  const float ib = l_b == 0.f ? 0.f : 1.f / l_b;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= p.d) break;
    if (ra < p.sq)
      *reinterpret_cast<uint32_t*>(o + qbase + (long long)ra * p.d + col) =
          pack2<T>(acc[n][0] * ia, acc[n][1] * ia);
    if (rb < p.sq)
      *reinterpret_cast<uint32_t*>(o + qbase + (long long)rb * p.d + col) =
          pack2<T>(acc[n][2] * ib, acc[n][3] * ib);
  }
  if (t == 0) {
    const long long lbase = (long long)bh * p.sq;
    if (ra < p.sq) lse[lbase + ra] = l_a == 0.f ? -INFINITY : (m_a + log2f(l_a)) * kLn2;
    if (rb < p.sq) lse[lbase + rb] = l_b == 0.f ? -INFINITY : (m_b + log2f(l_b)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// 16-bit backward on wgmma (hopper.cuh): one block of three warpgroups. The
// first is the producer: its first warp loads tiles by TMA into a ring of
// kStages stages, each completing on a `full` mbarrier, and waits on each
// stage's `empty` mbarrier before refilling it; its other warps idle. The
// two consumer warpgroups each own 64 rows (dq) or 64 keys (dkv) of the
// block's 128 and run every product by wgmma on the swizzled tiles.
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 384;  // a producer and two consumer warpgroups
constexpr int kStages = 4;
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 of the SM's 64K
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// the keys of a K/V tile the dq kernel streams (S and dP are m64nBC): 128
// at D=64 (8% faster at S=4096 than 64 on an H100) and at D=32, 64 at
// D=128 (the ring of 128-key tiles would not fit beside Q and dO)
__host__ __device__ constexpr int dq_kv_tile(int d) { return d == 128 ? 64 : 128; }
// the rows of a q tile the dkv kernel streams: 64, 32 at D=128
__host__ __device__ constexpr int dkv_q_tile(int d) { return d == 128 ? 32 : 64; }
// the swizzle, in bytes of a tile row's column block: 128 (64 columns),
// 64 (32 columns) at D=32
__host__ __device__ constexpr int swizzle_bytes(int d) { return d == 32 ? 64 : 128; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ int tile_count(int first, int hi, int step) {
  return first < hi ? (hi - first + step - 1) / step : 0;
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, results below 2^-126 flushed to 0; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dq for 128 query rows, and di = rowsum(o * do) for them (written to `di`
// for the dkv kernel, which runs after). Q and dO stay resident; the
// producer streams K and V tiles of BC keys. Per tile and consumer: S = Q K^T
// and dP = dO V^T (wgmma, A and B K-major), p = exp2(s scale log2e -
// lse log2e), dS = p (dP - di) scale rounded to T as the register A of
// dQ += dS K (B = K MN-major).
template <int D, typename T, bool M>
__global__ void __launch_bounds__(kBwdThreads, 1)
dq_tc(const __grid_constant__ CUtensorMap tm_q,
      const __grid_constant__ CUtensorMap tm_k,
      const __grid_constant__ CUtensorMap tm_v,
      const __grid_constant__ CUtensorMap tm_do, const T* __restrict__ o,
      const T* __restrict__ dout, const float* __restrict__ lse,
      float* __restrict__ di, T* __restrict__ dq, Problem p) {
  using namespace hopper;
  constexpr int BR = 128, BC = dq_kv_tile(D);
  constexpr int W = swizzle_bytes(D), C = W / 2;  // a column block
  constexpr int kHalf = 64 * D * 2;   // bytes of one consumer's Q (or dO) rows
  constexpr int kTile = BC * D * 2;   // bytes of a K (or V) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);  // [2 halves][D / C][64][C]
  unsigned char* dos = qs + 2 * kHalf;
  unsigned char* ring = dos + 2 * kHalf;    // kStages x [K tile, V tile]
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  __shared__ int lim_max[2];
  // masked: each streamed tile's class for the two 64-row halves, and the
  // kv ids of each stage's tile (0 without ids), written by the producer
  // warp's lanes before they arrive on the stage's `full` barrier
  __shared__ unsigned char tcls_s[2][M ? kMaxTiles : 1];
  __shared__ int kid_s[kStages][M ? BC : 1];

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;  // long causal rows first
  const int qb0 = r0 / kBlock;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], M ? 32 : 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
    lim_max[0] = lim_max[1] = 0;
  }
  __syncthreads();
  if (tid < BR) atomicMax(&lim_max[tid / 64], row_limit(p, b, r0 + tid));
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, BR, &lo, &hi);
  hi = min(hi, max(lim_max[0], lim_max[1]));
  const int first = (lo / BC) * BC;
  const int tiles = tile_count(first, hi, BC);
  // the class of tile i for the half hf: staged in shared memory by every
  // thread at once when the tiles fit, else read from the map in place
  const bool staged = M && tiles <= kMaxTiles;
  auto tile_class = [&](int hf, int i) -> int {
    if (staged) return tcls_s[hf][i];
    return span_class(class_row(p, b, h, qb0 + hf), p.tiles_k, first + i * BC,
                      BC);
  };
  if constexpr (M) {
    if (staged) {
      for (int i = tid; i < 2 * tiles; i += kBwdThreads)
        tcls_s[i / tiles][i % tiles] =
            span_class(class_row(p, b, h, qb0 + i / tiles), p.tiles_k,
                       first + (i % tiles) * BC, BC);
      __syncthreads();
    }
  }
  // a tile is loaded unless the class map hides its keys from both halves;
  // producer and consumers walk this same sequence
  auto loaded = [&](int i) {
    return !M || tile_class(0, i) != kSkip || tile_class(1, i) != kSkip;
  };

  if (tid < 128) {  // producer
    regs_dec<kProducerRegs>();
    // the first thread (masked: the first warp, for the kv ids)
    if (tid == 0 || (M && tid < 32)) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_tx(&q_full, 4 * kHalf);
        for (int hf = 0; hf < 2; ++hf)
          for (int cb = 0; cb < D / C; ++cb) {
            tma_load_3d(qs + hf * kHalf + cb * 64 * W, &tm_q, &q_full,
                        cb * C, r0 + 64 * hf, bh);
            tma_load_3d(dos + hf * kHalf + cb * 64 * W, &tm_do, &q_full,
                        cb * C, r0 + 64 * hf, bh);
          }
      }
      int n = 0;  // tiles loaded
      for (int i = 0; i < tiles; ++i) {
        const int c0 = first + i * BC;
        if (!loaded(i)) continue;
        const int st = n % kStages;
        mbar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
        ++n;
        if constexpr (M) {
          for (int u = lane; u < BC; u += 32)
            kid_s[st][u] = p.q_ids != nullptr && c0 + u < p.skv
                               ? p.kv_ids[(long long)b * p.skv + c0 + u] : 0;
        }
        if (lane == 0) {
          unsigned char* dst = ring + st * 2 * kTile;
          mbar_arrive_tx(&full[st], 2 * kTile);
          for (int cb = 0; cb < D / C; ++cb) {
            tma_load_3d(dst + cb * BC * W, &tm_k, &full[st], cb * C, c0, bh);
            tma_load_3d(dst + kTile + cb * BC * W, &tm_v, &full[st], cb * C,
                        c0, bh);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rw = r0 + 64 * wg;
    const int ra = rw + warp * 16 + g, rb = ra + 8;
    const int2 ba = key_bounds(p, b, ra), bb = key_bounds(p, b, rb);
    const long long lbase = (long long)bh * p.sq;
    const float lse_a = ra < p.sq ? lse[lbase + ra] * kLog2e : 0.f;
    const float lse_b = rb < p.sq ? lse[lbase + rb] * kLog2e : 0.f;
    // masked: the segment ids of rows ra and rb
    int qid_a = 0, qid_b = 0;
    if constexpr (M) {
      if (p.q_ids != nullptr) {
        qid_a = ra < p.sq ? p.q_ids[(long long)b * p.sq + ra] : 0;
        qid_b = rb < p.sq ? p.q_ids[(long long)b * p.sq + rb] : 0;
      }
    }
    // di of rows ra and rb: lane t sums columns [t D/4, (t + 1) D/4)
    float di_a = 0.f, di_b = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra;
      if (row >= p.sq) continue;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; c += 8) {
        const int col = t * (D / 4) + c;
        if (col >= p.d) break;
        const long long off = (lbase + row) * p.d + col;
        const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
        const T* o8 = reinterpret_cast<const T*>(&ov);
        const T* d8 = reinterpret_cast<const T*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = unpack2<T>(o8[2 * e], o8[2 * e + 1]);
          const float2 df = unpack2<T>(d8[2 * e], d8[2 * e + 1]);
          sum = fmaf(of.x, df.x, sum);
          sum = fmaf(of.y, df.y, sum);
        }
      }
      (half ? di_b : di_a) = sum;
    }
    di_a = quad_sum(di_a);
    di_b = quad_sum(di_b);
    if (t == 0) {
      if (ra < p.sq) di[lbase + ra] = di_a;
      if (rb < p.sq) di[lbase + rb] = di_b;
    }
    int wlo, whi;
    kv_range(p, rw, 64, &wlo, &whi);
    whi = min(whi, lim_max[wg]);
    const unsigned char* qh = qs + wg * kHalf;
    const unsigned char* doh = dos + wg * kHalf;
    const float sl2 = p.scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // dQ += dS K of one tile runs on while the next tile's S and dP are
    // issued; its stage is released once that product is done
    uint32_t dsa[BC / 16][4];
    int held = -1;  // the stage an in-flight dQ product reads, or -1
    int n = 0;      // tiles loaded, as the producer counts them
    mbar_wait(&q_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int c0 = first + i * BC;
      if (!loaded(i)) continue;
      const int st = n % kStages;
      mbar_wait(&full[st], (n / kStages) & 1);
      ++n;
      const int cls = M ? tile_class(wg, i) : kFull;
      if (cls == kSkip || !(c0 + BC > wlo && c0 < whi)) {
        // no key of the tile is visible to this warpgroup's rows: retire
        // the held product first, since the producer may be waiting for
        // that stage before it can fill the ones this warpgroup skips
        if (held >= 0) {
          wg_wait<0>();
          wg_keep(acc);
          wg_keep(dsa);
          mbar_arrive(&empty[held]);
          held = -1;
        }
        mbar_arrive(&empty[st]);
        continue;
      }
      const unsigned char* ks = ring + st * 2 * kTile;
      const unsigned char* vs = ks + kTile;
      float s[BC / 2], dp[BC / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BC, T>(s, desc_k<64, W>(qh, kk), desc_k<BC, W>(ks, kk),
                        kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BC, T>(dp, desc_k<64, W>(doh, kk), desc_k<BC, W>(vs, kk),
                        kk > 0);
      wg_commit();
      wg_wait<1>();  // S, and the previous tile's dQ product
      wg_keep(s);
      wg_keep(acc);
      wg_keep(dsa);
      if (held >= 0) mbar_arrive(&empty[held]);
      if (cls == kFull && full_tile(p, rw, 64, c0, BC)) {
#pragma unroll
        for (int i2 = 0; i2 < BC / 2; ++i2)
          s[i2] = fast_exp2(s[i2] * sl2 - ((i2 & 2) ? lse_b : lse_a));
      } else if (cls == kFull) {
#pragma unroll
        for (int i2 = 0; i2 < BC / 2; ++i2) {
          const int col = c0 + (i2 / 4) * 8 + 2 * t + (i2 & 1);
          const int2 kb2 = (i2 & 2) ? bb : ba;
          const float x = s[i2] * sl2 - ((i2 & 2) ? lse_b : lse_a);
          s[i2] = fast_exp2(col >= kb2.x && col < kb2.y ? x : -INFINITY);
        }
      } else if constexpr (M) {  // ids or mask hide some pairs: rules 1-3
        // the ids compare in registers against the stage's staged kv ids
        // (0 = 0 without ids); the mask's bytes are read where it is given
        const int* kid = kid_s[st];
        if (p.mask == nullptr) {
#pragma unroll
          for (int i2 = 0; i2 < BC / 2; ++i2) {
            const int cc = (i2 / 4) * 8 + 2 * t + (i2 & 1), col = c0 + cc;
            const int2 kb2 = (i2 & 2) ? bb : ba;
            const float x = s[i2] * sl2 - ((i2 & 2) ? lse_b : lse_a);
            const bool vis = col >= kb2.x && col < kb2.y &&
                             ((i2 & 2) ? qid_b : qid_a) == kid[cc];
            s[i2] = fast_exp2(vis ? x : -INFINITY);
          }
        } else {
#pragma unroll
          for (int i2 = 0; i2 < BC / 2; ++i2) {
            const int cc = (i2 / 4) * 8 + 2 * t + (i2 & 1), col = c0 + cc;
            const int row = (i2 & 2) ? rb : ra;
            const int2 kb2 = (i2 & 2) ? bb : ba;
            const float x = s[i2] * sl2 - ((i2 & 2) ? lse_b : lse_a);
            bool vis = col >= kb2.x && col < kb2.y &&
                       ((i2 & 2) ? qid_b : qid_a) == kid[cc];
            if (vis) vis = mask_keeps(p, b, h, row, col);
            s[i2] = fast_exp2(vis ? x : -INFINITY);
          }
        }
      }
      wg_wait<0>();  // dP
      wg_keep(dp);
#pragma unroll
      for (int i2 = 0; i2 < BC / 2; ++i2)
        dp[i2] = s[i2] * (dp[i2] - ((i2 & 2) ? di_b : di_a)) * p.scale;
      acc_to_a<BC, T>(dsa, dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        wgmma_rs<D, T>(acc, dsa[kk], desc_mn<BC, W>(ks, kk));
      wg_commit();
      held = st;
    }
    wg_wait<0>();
    wg_keep(acc);
    wg_keep(dsa);
    if (held >= 0) mbar_arrive(&empty[held]);
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      const int col = nn * 8 + 2 * t;
      if (col >= p.d) break;
      if (ra < p.sq)
        *reinterpret_cast<uint32_t*>(dq + (lbase + ra) * p.d + col) =
            pack2<T>(acc[4 * nn], acc[4 * nn + 1]);
      if (rb < p.sq)
        *reinterpret_cast<uint32_t*>(dq + (lbase + rb) * p.d + col) =
            pack2<T>(acc[4 * nn + 2], acc[4 * nn + 3]);
    }
  }
}

// dk and dv for 128 keys. K and V stay resident; the producer streams
// q tiles of BR rows (Q, dO, and each row's lse log2e, di, key bounds and
// segment id). Per tile and consumer: S^T = K Q^T and dP^T = V dO^T (wgmma,
// K-major), p^T rounded to T as the register A of dV += P^T dO, dS^T = p^T
// (dP^T - di) scale rounded to T as the register A of dK += dS^T Q (B = dO
// and Q, MN-major).
template <int D, typename T, bool M>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_tc(const __grid_constant__ CUtensorMap tm_q,
       const __grid_constant__ CUtensorMap tm_k,
       const __grid_constant__ CUtensorMap tm_v,
       const __grid_constant__ CUtensorMap tm_do,
       const float* __restrict__ lse, const float* __restrict__ di,
       T* __restrict__ dk, T* __restrict__ dv, Problem p) {
  using namespace hopper;
  constexpr int BC = 128, BR = dkv_q_tile(D);
  constexpr int W = swizzle_bytes(D), C = W / 2;  // a column block
  constexpr int kHalf = 64 * D * 2;  // bytes of one consumer's K (or V) rows
  constexpr int kTile = BR * D * 2;  // bytes of a Q (or dO) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);  // [2 halves][D / C][64][C]
  unsigned char* vs = ks + 2 * kHalf;
  unsigned char* ring = vs + 2 * kHalf;     // kStages x [Q tile, dO tile]
  // row statistics, read as float2, int2 and int4 by the consumers
  __shared__ __align__(16) float lse_s[kStages][BR], di_s[kStages][BR];
  __shared__ __align__(16) int2 keys_s[kStages][BR];  // visible keys [lo, hi)
  __shared__ __align__(16) int qid_s[kStages][BR];    // segment ids
  __shared__ __align__(8) uint64_t kv_full, full[kStages], empty[kStages];
  // masked: the class map's entries of every row block against the
  // block's two 64-key halves
  __shared__ unsigned char cls_s[M ? 2 : 1][M ? kMaxTiles : 1];

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int c0 = blockIdx.x * BC;  // key 0 walks the most q tiles: first
  const int tid = threadIdx.x;
  const long long lbase = (long long)bh * p.sq;
  int lo, hi;
  q_range(p, c0, BC, &lo, &hi);
  const int first = (lo / BR) * BR;
  const int tiles = tile_count(first, hi, BR);
  // a q tile is loaded unless the class map hides its rows from both
  // halves' keys; producer and consumers walk this same sequence
  const bool staged = M && p.tiles_q <= kMaxTiles;
  // the class of row block qb against the key half hf
  auto half_class = [&](int hf, int qb) -> int {
    if (staged) return cls_s[hf][qb];
    return span_class(p, b, h, qb, c0 + 64 * hf, 64);
  };
  auto loaded = [&](int r0) {
    return !M || half_class(0, r0 / kBlock) != kSkip ||
           half_class(1, r0 / kBlock) != kSkip;
  };
  if (tid == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  if constexpr (M) {
    if (staged)
      for (int i = tid; i < 2 * p.tiles_q; i += kBwdThreads) {
        const int hf = i / p.tiles_q, qb = i % p.tiles_q;
        cls_s[hf][qb] = span_class(p, b, h, qb, c0 + 64 * hf, 64);
      }
  }
  __syncthreads();

  if (tid < 128) {  // producer
    regs_dec<kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_tx(&kv_full, 4 * kHalf);
        for (int hf = 0; hf < 2; ++hf)
          for (int cb = 0; cb < D / C; ++cb) {
            tma_load_3d(ks + hf * kHalf + cb * 64 * W, &tm_k, &kv_full,
                        cb * C, c0 + 64 * hf, bh);
            tma_load_3d(vs + hf * kHalf + cb * 64 * W, &tm_v, &kv_full,
                        cb * C, c0 + 64 * hf, bh);
          }
      }
      // the row statistics of the next loaded tile, fetched while this
      // one waits
      float lse_r[BR / 32], di_r[BR / 32];
      int2 keys_r[BR / 32];
      int qid_r[BR / 32];
      auto fetch = [&](int r0) {
#pragma unroll
        for (int u = 0; u < BR / 32; ++u) {
          const int row = r0 + lane + 32 * u;
          const bool in = row < p.sq;
          lse_r[u] = in ? lse[lbase + row] * kLog2e : 0.f;
          di_r[u] = in ? di[lbase + row] : 0.f;
          keys_r[u] = key_bounds(p, b, row);
          if constexpr (M)
            qid_r[u] = in && p.q_ids != nullptr
                           ? p.q_ids[(long long)b * p.sq + row] : 0;
        }
      };
      auto next = [&](int i) {
        while (i < tiles && !loaded(first + i * BR)) ++i;
        return i;
      };
      int i = next(0);
      if (i < tiles) fetch(first + i * BR);
      for (int n = 0; i < tiles; ++n) {
        const int st = n % kStages, r0 = first + i * BR;
        mbar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < BR / 32; ++u) {
          lse_s[st][lane + 32 * u] = lse_r[u];
          di_s[st][lane + 32 * u] = di_r[u];
          keys_s[st][lane + 32 * u] = keys_r[u];
          if constexpr (M) qid_s[st][lane + 32 * u] = qid_r[u];
        }
        i = next(i + 1);
        if (i < tiles) fetch(first + i * BR);
        if (lane == 0) {
          unsigned char* dst = ring + st * 2 * kTile;
          mbar_arrive_tx(&full[st], 2 * kTile);
          for (int cb = 0; cb < D / C; ++cb) {
            tma_load_3d(dst + cb * BR * W, &tm_q, &full[st], cb * C, r0, bh);
            tma_load_3d(dst + kTile + cb * BR * W, &tm_do, &full[st],
                        cb * C, r0, bh);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int k0 = c0 + 64 * wg;
    const int ka = k0 + warp * 16 + g, kb = ka + 8;
    // the segment ids of keys ka and kb
    const int kid_a = M && p.q_ids != nullptr && ka < p.skv
                          ? p.kv_ids[(long long)b * p.skv + ka] : 0;
    const int kid_b = M && p.q_ids != nullptr && kb < p.skv
                          ? p.kv_ids[(long long)b * p.skv + kb] : 0;
    int wlo, whi;
    q_range(p, k0, 64, &wlo, &whi);
    if (k0 >= p.skv) whi = wlo;  // no key of this warpgroup exists
    const unsigned char* kh = ks + wg * kHalf;
    const unsigned char* vh = vs + wg * kHalf;
    const float sl2 = p.scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // dV += P^T dO and dK += dS^T Q of one tile run on while the next
    // tile's S^T and dP^T are issued; the stage is released once they are
    // done
    uint32_t pa[BR / 16][4], dsa[BR / 16][4];
    int held = -1;  // the stage in-flight dV and dK products read, or -1
    int n = 0;      // tiles loaded, as the producer counts them
    mbar_wait(&kv_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int r0 = first + i * BR;
      if (!loaded(r0)) continue;
      const int st = n % kStages;
      mbar_wait(&full[st], (n / kStages) & 1);
      ++n;
      const int cls = M ? half_class(wg, r0 / kBlock) : kFull;
      if (cls == kSkip || !(r0 + BR > wlo && r0 < whi)) {
        // no row of the tile sees a key of this warpgroup
        if (held >= 0) {  // as in dq_tc
          wg_wait<0>();
          wg_keep(dv_acc);
          wg_keep(dk_acc);
          wg_keep(pa);
          wg_keep(dsa);
          mbar_arrive(&empty[held]);
          held = -1;
        }
        mbar_arrive(&empty[st]);
        continue;
      }
      const unsigned char* qt = ring + st * 2 * kTile;
      const unsigned char* dot = qt + kTile;
      float s[BR / 2], dp[BR / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BR, T>(s, desc_k<64, W>(kh, kk), desc_k<BR, W>(qt, kk),
                        kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BR, T>(dp, desc_k<64, W>(vh, kk), desc_k<BR, W>(dot, kk),
                        kk > 0);
      wg_commit();
      // the row statistics of columns 8j + 2t and 8j + 2t + 1
      float2 lse2[BR / 8], di2[BR / 8];
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        lse2[j] = *reinterpret_cast<const float2*>(&lse_s[st][j * 8 + 2 * t]);
        di2[j] = *reinterpret_cast<const float2*>(&di_s[st][j * 8 + 2 * t]);
      }
      wg_wait<1>();  // S^T, and the previous tile's dV and dK products
      wg_keep(s);
      wg_keep(dv_acc);
      wg_keep(dk_acc);
      wg_keep(pa);
      wg_keep(dsa);
      if (held >= 0) mbar_arrive(&empty[held]);
      if (cls == kFull && full_tile(p, r0, BR, k0, 64)) {
#pragma unroll
        for (int i2 = 0; i2 < BR / 2; ++i2)
          s[i2] = fast_exp2(s[i2] * sl2 -
                            ((i2 & 1) ? lse2[i2 / 4].y : lse2[i2 / 4].x));
      } else if (cls == kFull) {
#pragma unroll
        for (int j = 0; j < BR / 8; ++j) {
          const int4 kb4 =
              *reinterpret_cast<const int4*>(&keys_s[st][j * 8 + 2 * t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = e < 2 ? ka : kb;
            const int lo = (e & 1) ? kb4.z : kb4.x;
            const int hi = (e & 1) ? kb4.w : kb4.y;
            const float x =
                s[4 * j + e] * sl2 - ((e & 1) ? lse2[j].y : lse2[j].x);
            s[4 * j + e] = fast_exp2(key >= lo && key < hi ? x : -INFINITY);
          }
        }
      } else if constexpr (M) {  // ids or mask hide some pairs: rules 1-3
        const bool masked = p.mask != nullptr;
#pragma unroll
        for (int j = 0; j < BR / 8; ++j) {
          const int4 kb4 =
              *reinterpret_cast<const int4*>(&keys_s[st][j * 8 + 2 * t]);
          const int2 qid2 =
              *reinterpret_cast<const int2*>(&qid_s[st][j * 8 + 2 * t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = e < 2 ? ka : kb;
            const int lo = (e & 1) ? kb4.z : kb4.x;
            const int hi = (e & 1) ? kb4.w : kb4.y;
            const int row = r0 + j * 8 + 2 * t + (e & 1);
            const float x =
                s[4 * j + e] * sl2 - ((e & 1) ? lse2[j].y : lse2[j].x);
            // ids 0 = 0 without ids; the mask's bytes where it is given
            bool vis = key >= lo && key < hi &&
                       ((e & 1) ? qid2.y : qid2.x) == (e < 2 ? kid_a : kid_b);
            if (masked && vis) vis = mask_keeps(p, b, h, row, key);
            s[4 * j + e] = fast_exp2(vis ? x : -INFINITY);
          }
        }
      }
      acc_to_a<BR, T>(pa, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        wgmma_rs<D, T>(dv_acc, pa[kk], desc_mn<BR, W>(dot, kk));
      wg_commit();
      wg_wait<1>();  // dP^T (dV may still run)
      wg_keep(dp);
#pragma unroll
      for (int i2 = 0; i2 < BR / 2; ++i2)
        dp[i2] = s[i2] * (dp[i2] - ((i2 & 1) ? di2[i2 / 4].y
                                              : di2[i2 / 4].x)) * p.scale;
      acc_to_a<BR, T>(dsa, dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        wgmma_rs<D, T>(dk_acc, dsa[kk], desc_mn<BR, W>(qt, kk));
      wg_commit();
      held = st;
    }
    wg_wait<0>();
    wg_keep(dv_acc);
    wg_keep(dk_acc);
    wg_keep(pa);
    wg_keep(dsa);
    if (held >= 0) mbar_arrive(&empty[held]);
    const long long kbase = (long long)bh * p.skv;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      const int col = nn * 8 + 2 * t;
      if (col >= p.d) break;
      if (ka < p.skv) {
        *reinterpret_cast<uint32_t*>(dk + (kbase + ka) * p.d + col) =
            pack2<T>(dk_acc[4 * nn], dk_acc[4 * nn + 1]);
        *reinterpret_cast<uint32_t*>(dv + (kbase + ka) * p.d + col) =
            pack2<T>(dv_acc[4 * nn], dv_acc[4 * nn + 1]);
      }
      if (kb < p.skv) {
        *reinterpret_cast<uint32_t*>(dk + (kbase + kb) * p.d + col) =
            pack2<T>(dk_acc[4 * nn + 2], dk_acc[4 * nn + 3]);
        *reinterpret_cast<uint32_t*>(dv + (kbase + kb) * p.d + col) =
            pack2<T>(dv_acc[4 * nn + 2], dv_acc[4 * nn + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: scalar kernels, one thread per query row (forward, dq) or per key
// (dkv), over tiles staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int kRows32 = 64;  // threads per block
constexpr int kTile32 = 32;  // staged rows per tile

// rows [row0, row0 + kTile32) of a [n, d] matrix, D columns, zero past n
// and d
template <int D>
__device__ __forceinline__ void stage32(float (*s)[D], const float* g, int row0,
                                        int n, int d) {
  for (int i = threadIdx.x; i < kTile32 * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    s[r][c] = row0 + r < n && c < d ? g[(long long)(row0 + r) * d + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kRows32)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ o,
        float* __restrict__ lse, Problem p) {
  __shared__ float ks[kTile32][D], vs[kTile32][D];
  __shared__ int lim_max;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int r0 = blockIdx.x * kRows32, row = r0 + threadIdx.x;
  const long long qbase = (long long)bh * p.sq * p.d;
  const long long kbase = (long long)bh * p.skv * p.d;
  const int lim = row_limit(p, b, row);
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < p.sq && d < p.d ? q[qbase + (long long)row * p.d + d] : 0.f;
    acc[d] = 0.f;
  }
  if (threadIdx.x == 0) lim_max = 0;
  __syncthreads();
  atomicMax(&lim_max, lim);
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, kRows32, &lo, &hi);
  hi = min(hi, lim_max);
  float m = -INFINITY, l = 0.f;
  for (int c0 = (lo / kTile32) * kTile32; c0 < hi; c0 += kTile32) {
    const int cls = span_class(p, b, h, r0 / kBlock, c0, kTile32);
    if (cls == kSkip) continue;
    stage32<D>(ks, k + kbase, c0, p.skv, p.d);
    stage32<D>(vs, v + kbase, c0, p.skv, p.d);
    __syncthreads();
    for (int j = 0; j < kTile32; ++j) {
      if (!visible(p, row, lim, c0 + j)) continue;
      if (cls != kFull && !keep(p, b, h, row, c0 + j)) continue;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      s *= p.scale;
      const float mn = fmaxf(m, s);
      const float alpha = expf(m - mn), pr = expf(s - mn);
      l = l * alpha + pr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pr, vs[j][d], acc[d] * alpha);
      m = mn;
    }
    __syncthreads();
  }
  if (row < p.sq) {
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < p.d) o[qbase + (long long)row * p.d + d] = acc[d] * inv;
    lse[(long long)bh * p.sq + row] = l == 0.f ? -INFINITY : m + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(kRows32)
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ o,
       const float* __restrict__ dout, const float* __restrict__ lse,
       float* __restrict__ di, float* __restrict__ dq, Problem p) {
  __shared__ float ks[kTile32][D], vs[kTile32][D];
  __shared__ int lim_max;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int r0 = blockIdx.x * kRows32, row = r0 + threadIdx.x;
  const long long qbase = (long long)bh * p.sq * p.d;
  const long long kbase = (long long)bh * p.skv * p.d;
  const int lim = row_limit(p, b, row);
  const bool in = row < p.sq;
  const float lse_r = in ? lse[(long long)bh * p.sq + row] : 0.f;
  float qr[D], dr[D], acc[D];
  float di_r = 0.f;  // rowsum(o * do), for this kernel and the dkv kernel
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool at = in && d < p.d;
    const long long idx = qbase + (long long)row * p.d + d;
    qr[d] = at ? q[idx] : 0.f;
    dr[d] = at ? dout[idx] : 0.f;
    if (at) di_r = fmaf(o[idx], dr[d], di_r);
    acc[d] = 0.f;
  }
  if (in) di[(long long)bh * p.sq + row] = di_r;
  if (threadIdx.x == 0) lim_max = 0;
  __syncthreads();
  atomicMax(&lim_max, lim);
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, kRows32, &lo, &hi);
  hi = min(hi, lim_max);
  for (int c0 = (lo / kTile32) * kTile32; c0 < hi; c0 += kTile32) {
    const int cls = span_class(p, b, h, r0 / kBlock, c0, kTile32);
    if (cls == kSkip) continue;
    stage32<D>(ks, k + kbase, c0, p.skv, p.d);
    stage32<D>(vs, v + kbase, c0, p.skv, p.d);
    __syncthreads();
    for (int j = 0; j < kTile32; ++j) {
      if (!visible(p, row, lim, c0 + j)) continue;
      if (cls != kFull && !keep(p, b, h, row, c0 + j)) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], ks[j][d], s);
        dp = fmaf(dr[d], vs[j][d], dp);
      }
      const float pr = expf(s * p.scale - lse_r);
      const float ds = pr * (dp - di_r) * p.scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
    __syncthreads();
  }
  if (in) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < p.d) dq[qbase + (long long)row * p.d + d] = acc[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kRows32)
dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ di,
        float* __restrict__ dk, float* __restrict__ dv, Problem p) {
  __shared__ float qs[kTile32][D], dos[kTile32][D];
  __shared__ float lse_s[kTile32], di_s[kTile32];
  __shared__ int lim_s[kTile32];
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int c0 = blockIdx.x * kRows32, key = c0 + threadIdx.x;
  const long long qbase = (long long)bh * p.sq * p.d;
  const long long kbase = (long long)bh * p.skv * p.d;
  const bool in = key < p.skv;
  float kr[D], vr[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool at = in && d < p.d;
    kr[d] = at ? k[kbase + (long long)key * p.d + d] : 0.f;
    vr[d] = at ? v[kbase + (long long)key * p.d + d] : 0.f;
    dk_acc[d] = dv_acc[d] = 0.f;
  }
  int lo, hi;
  q_range(p, c0, kRows32, &lo, &hi);
  for (int r0 = (lo / kTile32) * kTile32; r0 < hi; r0 += kTile32) {
    const int cls = span_class(p, b, h, r0 / kBlock, c0, kRows32);
    if (cls == kSkip) continue;
    stage32<D>(qs, q + qbase, r0, p.sq, p.d);
    stage32<D>(dos, dout + qbase, r0, p.sq, p.d);
    for (int i = threadIdx.x; i < kTile32; i += blockDim.x) {
      const int row = r0 + i;
      lse_s[i] = row < p.sq ? lse[(long long)bh * p.sq + row] : 0.f;
      di_s[i] = row < p.sq ? di[(long long)bh * p.sq + row] : 0.f;
      lim_s[i] = row_limit(p, b, row);
    }
    __syncthreads();
    for (int i = 0; i < kTile32; ++i) {
      if (!visible(p, r0 + i, lim_s[i], key)) continue;
      if (cls != kFull && !keep(p, b, h, r0 + i, key)) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[i][d], kr[d], s);
        dp = fmaf(dos[i][d], vr[d], dp);
      }
      const float pr = expf(s * p.scale - lse_s[i]);
      const float ds = pr * (dp - di_s[i]) * p.scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv_acc[d] = fmaf(pr, dos[i][d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, qs[i][d], dk_acc[d]);
      }
    }
    __syncthreads();
  }
  if (in) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d >= p.d) break;
      dk[kbase + (long long)key * p.d + d] = dk_acc[d];
      dv[kbase + (long long)key * p.d + d] = dv_acc[d];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
using Dim = std::integral_constant<int, D>;

// Calls f(T{}, Dim<D>{}) for the dtype code (0 float32, 1 bfloat16, 2
// float16) and the smallest instance D of 32, 64 and 128 that holds the
// head dim d (a multiple of 8 up to 128).
template <typename F>
int dispatch(int dtype, int d, F f) {
  if (d < 8 || d > 128 || d % 8 != 0) return cudaErrorInvalidValue;
  auto by_dim = [&](auto t) -> int {
    if (d <= 32) return f(t, Dim<32>{});
    if (d <= 64) return f(t, Dim<64>{});
    return f(t, Dim<128>{});
  };
  switch (dtype) {
    case 0: return by_dim(float{});
    case 1: return by_dim(bf16{});
    case 2: return by_dim(f16{});
  }
  return cudaErrorInvalidValue;
}

// bytes of `rows` padded rows of a 16-bit tile
template <int D>
int smem_tc(int rows) {
  return rows * (D + kPad) * 2;
}

// dynamic shared memory of the wgmma backward kernels, with 1 KB to align
// the swizzled tiles: resident tiles of 128 rows (Q and dO, or K and V)
// and kStages stages of two streamed tiles
template <int D>
int smem_dq() {
  return 1024 + 2 * 128 * D * 2 + kStages * 2 * dq_kv_tile(D) * D * 2;
}
template <int D>
int smem_dkv() {
  return 1024 + 2 * 128 * D * 2 + kStages * 2 * dkv_q_tile(D) * D * 2;
}

// what an entry point returns when a TMA map could not be encoded: this
// plus libcuda's CUresult (kMapError - 1: no encoder was found)
constexpr int kMapError = 10000;

// TMA maps of q, k, v and do ([bh, rows, d] of T) in boxes of D's column
// block by q_rows (q, do) or kv_rows (k, v); a tensor with no rows gets a
// map of one row, which no load reads. Returns 0 or kMapError + the
// failure.
template <typename T, int D>
int bwd_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
             const void* dout, int bh, int sq, int skv, int d, int q_rows,
             int kv_rows) {
  // libcuda's encoder needs the device's context current on this
  // thread, and autograd runs the backward on a thread of its own, where
  // nothing may have made it current yet
  cudaPointerAttributes at;
  if (cudaPointerGetAttributes(&at, q) != cudaSuccess ||
      cudaSetDevice(at.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  sq = sq > 0 ? sq : 1;
  skv = skv > 0 ? skv : 1;
  const void* base[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool kv = i == 1 || i == 2;
    const int rc = hopper::tile_map<T, swizzle_bytes(D)>(
        &m[i], base[i], bh, kv ? skv : sq, d, kv ? kv_rows : q_rows);
    if (rc != 0) return kMapError + rc;
  }
  return 0;
}

Problem make_problem(const void* limits, const void* q_ids,
                     const void* kv_ids, const void* mask, void* tiles,
                     long long mask_b, long long mask_h, long long mask_r,
                     long long mask_c, int map_batch, int map_heads,
                     int heads, int sq, int skv, int d, int lim_bstride,
                     int lim_rstride, int causal, int window,
                     float sm_scale) {
  Problem p;
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.causal = causal;
  p.window = causal ? window : 0;
  p.offset = causal ? skv - sq : 0;
  p.limits = static_cast<const int*>(limits);
  p.lim_bstride = lim_bstride;
  p.lim_rstride = lim_rstride;
  p.q_ids = static_cast<const int*>(q_ids);
  p.kv_ids = static_cast<const int*>(kv_ids);
  p.mask = static_cast<const unsigned char*>(mask);
  p.mask_b = mask_b;
  p.mask_h = mask_h;
  p.mask_r = mask_r;
  p.mask_c = mask_c;
  p.tiles_q = cdiv(sq, kBlock);
  p.tiles_k = cdiv(skv, kBlock);
  const bool classed = p.q_ids != nullptr || p.mask != nullptr;
  p.tiles = classed ? static_cast<unsigned char*>(tiles) : nullptr;
  p.tile_h = map_heads > 1 ? (long long)p.tiles_q * p.tiles_k : 0;
  p.tile_b = map_batch > 1 ? (long long)map_heads * p.tiles_q * p.tiles_k : 0;
  p.scale = sm_scale;
  return p;
}

}  // namespace

// Every entry point takes the tensors, then the visibility arguments
// (q_ids, kv_ids: segment ids [B, Sq] and [B, Skv] int32 or null; mask:
// one byte a (b, h, row, key) at b mask_b + h mask_h + row mask_r + key
// mask_c, or null; tiles: the class map [map_batch, map_heads, Sq / 64,
// Skv / 64] bytes, written by the forward and read by the backward), then
// the shape: bh, heads, sq, skv, head_dim (a multiple of 8 up to 128), the
// kv limits' strides, causal, window, sm_scale, the dtype (0 float32, 1
// bfloat16, 2 float16: q, k, v, o, do, dq, dk, dv alike) and the stream.
// Each returns the cudaError_t of its launch, or (the backward) kMapError +
// libcuda's CUresult when a TMA map was refused; the caller raises on
// non-zero.
#define LAMP_VIS_PARAMS                                                    \
  const void *q_ids, const void *kv_ids, const void *mask, void *tiles,    \
      long long mask_b, long long mask_h, long long mask_r,                \
      long long mask_c, int map_batch, int map_heads, int bh, int heads,   \
      int sq, int skv, int head_dim, int lim_bstride, int lim_rstride,     \
      int causal, int window, float sm_scale, int dtype, void *stream
#define LAMP_PROBLEM(limits)                                               \
  make_problem(limits, q_ids, kv_ids, mask, tiles, mask_b, mask_h, mask_r, \
               mask_c, map_batch, map_heads, heads, sq, skv, head_dim,     \
               lim_bstride, lim_rstride, causal, window, sm_scale)

extern "C" {

// writes the class map (when ids or a mask are given), then runs the
// forward
int lamp_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const void* limits, void* o, void* lse,
                             LAMP_VIS_PARAMS) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  const Problem p = LAMP_PROBLEM(limits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = p.tiles_q * p.tiles_k;
  if (p.tiles != nullptr && blocks > 0) {
    const cudaError_t err =
        launch(tile_classes, dim3(cdiv(blocks, 128), map_batch * map_heads),
               128, 0, st, p, map_heads);
    if (err != cudaSuccess) return err;
  }
  float* l = static_cast<float*>(lse);
  return dispatch(dtype, head_dim, [&](auto t, auto dim) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dim)::value;
    const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
            *vt = static_cast<const T*>(v);
    T* ot = static_cast<T*>(o);
    if constexpr (std::is_same<T, float>::value) {
      return launch(fwd_f32<D>, dim3(cdiv(sq, kRows32), bh), kRows32, 0, st,
                    qt, kt, vt, ot, l, p);
    } else {
      // a 64-row q tile and two stages of 64-row K and V tiles
      const dim3 grid(cdiv(sq, 64), bh);
      const int smem = smem_tc<D>(64 + 4 * 64);
      if (p.tiles != nullptr)
        return launch(fwd_tc<D, T, true>, grid, kThreads, smem, st, qt, kt,
                      vt, ot, l, p);
      return launch(fwd_tc<D, T, false>, grid, kThreads, smem, st, qt, kt,
                    vt, ot, l, p);
    }
  });
}

int lamp_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* di, const void* limits,
                                void* dq, LAMP_VIS_PARAMS) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  const Problem p = LAMP_PROBLEM(limits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(di);
  return dispatch(dtype, head_dim, [&](auto t, auto dim) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dim)::value;
    const T *ot = static_cast<const T*>(o), *dot = static_cast<const T*>(dout);
    T* out = static_cast<T*>(dq);
    if constexpr (std::is_same<T, float>::value) {
      return launch(dq_f32<D>, dim3(cdiv(sq, kRows32), bh), kRows32, 0, st,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), ot, dot, l, dd, out, p);
    } else {
      CUtensorMap m[4];
      const int rc = bwd_maps<T, D>(m, q, k, v, dout, bh, sq, skv, head_dim,
                                    64, dq_kv_tile(D));
      if (rc != 0) return rc;
      const dim3 grid(cdiv(sq, 128), bh);
      if (p.tiles != nullptr)
        return launch(dq_tc<D, T, true>, grid, kBwdThreads, smem_dq<D>(), st,
                      m[0], m[1], m[2], m[3], ot, dot, l, dd, out, p);
      return launch(dq_tc<D, T, false>, grid, kBwdThreads, smem_dq<D>(), st,
                    m[0], m[1], m[2], m[3], ot, dot, l, dd, out, p);
    }
  });
}

// di is the dq kernel's output: launch dq first
int lamp_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, const void* limits, void* dk,
                                 void* dv, LAMP_VIS_PARAMS) {
  if (bh == 0 || skv == 0) return cudaSuccess;
  const Problem p = LAMP_PROBLEM(limits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  return dispatch(dtype, head_dim, [&](auto t, auto dim) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dim)::value;
    T *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
    if constexpr (std::is_same<T, float>::value) {
      return launch(dkv_f32<D>, dim3(cdiv(skv, kRows32), bh), kRows32, 0, st,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), l, dd, dkt, dvt, p);
    } else {
      CUtensorMap m[4];
      const int rc = bwd_maps<T, D>(m, q, k, v, dout, bh, sq, skv, head_dim,
                                    dkv_q_tile(D), 64);
      if (rc != 0) return rc;
      const dim3 grid(cdiv(skv, 128), bh);
      if (p.tiles != nullptr)
        return launch(dkv_tc<D, T, true>, grid, kBwdThreads, smem_dkv<D>(),
                      st, m[0], m[1], m[2], m[3], l, dd, dkt, dvt, p);
      return launch(dkv_tc<D, T, false>, grid, kBwdThreads, smem_dkv<D>(),
                    st, m[0], m[1], m[2], m[3], l, dd, dkt, dvt, p);
    }
  });
}

}  // extern "C"
