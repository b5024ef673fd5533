// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of lamp_tpu/ops/attention.py:
//   K1  _fwd_kernel (driven by _fwd)                 -> fwd_wg (in
//       flash_forward.cu) / fwd_any (in flash_forward_any.cu)
//   K2a _bwd_fused_kernel (driven by _bwd_fused)     -> dq_* then dkv_*
//   K2b _bwd_dq_kernel, K2c _bwd_dkv_kernel          -> dq_*, dkv_*
//   K3a/K3b _compact_{fwd,bwd}_kernel (compact_attention) compute the same
//   function on short sequences; here they are the same kernels.
//
// Layout: q, o, dq [B*H, Sq, d]; k, v, dk, dv [B*H, Skv, d]; lse and di
// [B*H, Sq] f32 (f64 for float64 inputs), all contiguous. Every
// head dim d >= 1 and the types float32, bfloat16, float16 and float64 run
// on the card, with no upper limit on d:
//  - bfloat16 and float16 take the tensor-core kernels (templated on the
//    16-bit type), in the smallest instance D with D >= d: the columns
//    past d read as 0 (TMA boxes past the tensor map's inner extent are
//    zero-filled, cp.async copies past d are zero-filled) and stores stop
//    at d. The forward takes every d up to 256 in the wgmma kernel fwd_wg
//    (flash_forward.cu; D = 32, 64, 128, 192, 256): at d % 8 == 0 its
//    producer reads tiles by TMA, whose global strides must be multiples
//    of 16 bytes; a d that is not a multiple of 8 has rows only 8-, 4- or
//    2-byte aligned, and its producer copies them by 8- or 4-byte
//    cp.async, or 2-byte loads at an odd d, into the same layout.
//    The wgmma backward takes every d up to 256 too: dq_tc and dkv_tc here
//    up to 128 (128 rows resident; D = 32, 64, 128), dq_wide and dkv_wide
//    above (flash_backward_wide.cu; D = 192, 256); each by TMA at d % 8
//    == 0 and, at the other d (R, the ragged instances), by a producer
//    whose 128 threads copy the same tiles into the same layout as the
//    forward's (flash_common.cuh: copy_tile, copy_tile_odd).
//  - everything else (float32 and float64 at every d; the 16-bit types at
//    d > 256) takes fwd_any (flash_forward_any.cu) and dq_any, dkv_any
//    (flash_backward_any.cu): float64 on the FP64 tensor cores, the rest on
//    FFMA, with no limit on the head dim; float64 computes in double
//    there.
// Nothing is padded in device memory.
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
// 16-bit backward (wgmma, TMA and mbarriers; hopper.cuh): the split
// design, a dq kernel, then a dkv kernel. Each block is a producer
// warpgroup and two consumer warpgroups (setmaxnreg: 40 and 232 registers
// a thread). The producer's first warp streams tiles by TMA (3-D tensor
// maps [B*H, S, d], 128-byte swizzled, 64-byte at D = 32, zero-filled past
// a ragged end) into a ring of 4 stages, each completing on a `full`
// mbarrier and refilled after its `empty` mbarrier has the 256 consumer
// arrivals. R (d % 8 != 0: rows of 2d bytes, which TMA's 16-byte global
// strides cannot describe): all the producer's 128 threads copy each tile
// into the same 128-byte swizzle (64-byte at D = 32), by 8-byte cp.async
// pieces at d % 4 == 0 (a 200-byte row of d = 100: 25 pieces), 4-byte at
// other even d, and at an odd d by 4-byte loads of the tile's contiguous
// span and 2-byte stores; rows past S are zero-filled, and the columns d
// to D of every buffer are zeroed once before the loop. Each thread's
// copies arrive on the stage's `full` barrier (128 arrivals) by
// cp.async.mbarrier.arrive.noinc (a plain arrival after 2-byte stores);
// the kv ids (dq, under M) travel with them; dkv's row statistics are
// written by the first warp's lanes, which arrive once more after them
// (160 arrivals). A consumer fences the async proxy (fence.proxy.async)
// after each wait, before wgmma reads what the generic proxy wrote; the
// consumers are otherwise the TMA instances' code, di's prologue reads o
// and do by 8-, 4- or 2-byte loads (the rows' alignment), and an odd d's
// outputs are stored by 2-byte stores. The producer loads a tile unless the class map hides it from
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
//  - above head dim 128, dq_wide and dkv_wide (flash_backward_wide.cu)
//    keep this design with 64 rows or keys a consumer; float32 and float64
//    inputs take dq_any and dkv_any of flash_backward_any.cu (dq_any
//    computes di too).
//
// Resources (ptxas -v for sm_90a, on the build of this source): the
// backward kernels, 384 threads, report 168 registers (the launch bound;
// the consumers run at 232 and the producer at 40 after setmaxnreg), no
// spill, the ragged instances (R) alike; dynamic shared memory (with 1 KB
// for alignment) 161 KB (dq) and 97 KB (dkv) at D=64, 193 KB and 129 KB
// at D=128, 81 KB and 49 KB at D=32, beside a few KB of static (the
// masked instances' class bytes and kv ids, dkv's row statistics).
// fwd_wg: flash_forward.cu's note. dq_wide: 256 threads at D=256, 241
// registers (243 ragged; the masked instance 255, 16 bytes spilled, 8
// ragged), 384 at D=192, 168 (232 after setmaxnreg), no spill; dkv_wide:
// 384 threads, 168 (232), no spill; dynamic shared memory 193 KB (dq) and
// 209 KB (dkv) at both instances, beside 48 bytes to 4.9 KB of static.
// chip_smoke.py prints the whole table first.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace lamp_flash;

typedef __nv_bfloat16 bf16;
typedef __half f16;
using hopper::pack2;
using hopper::unpack2;

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

// ---------------------------------------------------------------------------
// 16-bit backward on wgmma (hopper.cuh): one block of three warpgroups. The
// first is the producer: its first warp loads tiles by TMA into a ring of
// kStages stages, each completing on a `full` mbarrier, and waits on each
// stage's `empty` mbarrier before refilling it; its other warps idle (R,
// the ragged producer: all its 128 threads copy by cp.async). The two
// consumer warpgroups each own 64 rows (dq) or 64 keys (dkv) of the
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
// dq for 128 query rows, and di = rowsum(o * do) for them (written to `di`
// for the dkv kernel, which runs after). Q and dO stay resident; the
// producer streams K and V tiles of BC keys. Per tile and consumer: S = Q K^T
// and dP = dO V^T (wgmma, A and B K-major), p = exp2(s scale log2e -
// lse log2e), dS = p (dP - di) scale rounded to T as the register A of
// dQ += dS K (B = K MN-major). R: d % 8 != 0, tiles copied from rg's rows
// by the ragged producer (the header note); the consumers are the same
// code.
template <int D, typename T, bool M, bool R>
__global__ void __launch_bounds__(kBwdThreads, 1)
dq_tc(const __grid_constant__ CUtensorMap tm_q,
      const __grid_constant__ CUtensorMap tm_k,
      const __grid_constant__ CUtensorMap tm_v,
      const __grid_constant__ CUtensorMap tm_do, const BwdRows<T> rg,
      const T* __restrict__ o, const T* __restrict__ dout,
      const float* __restrict__ lse, float* __restrict__ di,
      T* __restrict__ dq, Problem p) {
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
    // the ragged producer: an arrival from each of its threads
    mbar_init(&q_full, R ? 128 : 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], R ? 128 : M ? 32 : 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
    lim_max[0] = lim_max[1] = 0;
  }
  if constexpr (R) {  // the columns d..D that TMA would have read as 0
    for (int hf = 0; hf < 2; ++hf) {
      zero_tail<D, 64, W>(qs + hf * kHalf, p.d, tid, kBwdThreads);
      zero_tail<D, 64, W>(dos + hf * kHalf, p.d, tid, kBwdThreads);
    }
    for (int s = 0; s < 2 * kStages; ++s)
      zero_tail<D, BC, W>(ring + s * kTile, p.d, tid, kBwdThreads);
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

  if (tid < 128 && R) {  // the ragged producer: every thread copies
    regs_dec<kProducerRegs>();
    produce_dq<2, BC, kStages, W, M>(rg, p, b, bh, r0, first, tiles, loaded,
                                     qs, dos, kHalf, ring, kTile, &q_full,
                                     full, empty, &kid_s[0][0]);
  } else if (tid < 128) {  // producer
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
    // di of rows ra and rb: lane t sums columns [t D/4, (t + 1) D/4) (R:
    // row_dot's pieces, by the rows' alignment)
    float di_a = 0.f, di_b = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra;
      if (row >= p.sq) continue;
      if constexpr (R) {
        (half ? di_b : di_a) = row_dot(o, dout, (lbase + row) * p.d, p.d, t);
        continue;
      }
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
    wait_stage<R>(&q_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int c0 = first + i * BC;
      if (!loaded(i)) continue;
      const int st = n % kStages;
      wait_stage<R>(&full[st], (n / kStages) & 1);
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
      if constexpr (R) {  // at an odd d, 2-byte stores
        if (ra < p.sq)
          store_pair(dq, (lbase + ra) * p.d + col, col, p.d,
                     pack2<T>(acc[4 * nn], acc[4 * nn + 1]));
        if (rb < p.sq)
          store_pair(dq, (lbase + rb) * p.d + col, col, p.d,
                     pack2<T>(acc[4 * nn + 2], acc[4 * nn + 3]));
        continue;
      }
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
// and Q, MN-major). R: as in dq_tc.
template <int D, typename T, bool M, bool R>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_tc(const __grid_constant__ CUtensorMap tm_q,
       const __grid_constant__ CUtensorMap tm_k,
       const __grid_constant__ CUtensorMap tm_v,
       const __grid_constant__ CUtensorMap tm_do, const BwdRows<T> rg,
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
    mbar_init(&kv_full, R ? 128 : 1);
    for (int s = 0; s < kStages; ++s) {
      // the producer warp's lanes (R: every producer thread's copies, and
      // the first warp's lanes again after the row statistics)
      mbar_init(&full[s], R ? 128 + 32 : 32);
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
  if constexpr (R) {  // the columns d..D that TMA would have read as 0
    for (int hf = 0; hf < 2; ++hf) {
      zero_tail<D, 64, W>(ks + hf * kHalf, p.d, tid, kBwdThreads);
      zero_tail<D, 64, W>(vs + hf * kHalf, p.d, tid, kBwdThreads);
    }
    for (int s = 0; s < 2 * kStages; ++s)
      zero_tail<D, BR, W>(ring + s * kTile, p.d, tid, kBwdThreads);
  }
  __syncthreads();

  if (tid < 128 && R) {  // the ragged producer: every thread copies
    regs_dec<kProducerRegs>();
    produce_dkv<2, BR, kStages, W, M>(
        rg, p, b, bh, c0, first, tiles, loaded, lse, di, ks, vs, kHalf, ring,
        kTile, &kv_full, full, empty, &lse_s[0][0], &di_s[0][0],
        &keys_s[0][0], &qid_s[0][0]);
  } else if (tid < 128) {  // producer
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
    wait_stage<R>(&kv_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int r0 = first + i * BR;
      if (!loaded(r0)) continue;
      const int st = n % kStages;
      wait_stage<R>(&full[st], (n / kStages) & 1);
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
      if constexpr (R) {  // at an odd d, 2-byte stores
        if (ka < p.skv) {
          store_pair(dk, (kbase + ka) * p.d + col, col, p.d,
                     pack2<T>(dk_acc[4 * nn], dk_acc[4 * nn + 1]));
          store_pair(dv, (kbase + ka) * p.d + col, col, p.d,
                     pack2<T>(dv_acc[4 * nn], dv_acc[4 * nn + 1]));
        }
        if (kb < p.skv) {
          store_pair(dk, (kbase + kb) * p.d + col, col, p.d,
                     pack2<T>(dk_acc[4 * nn + 2], dk_acc[4 * nn + 3]));
          store_pair(dv, (kbase + kb) * p.d + col, col, p.d,
                     pack2<T>(dv_acc[4 * nn + 2], dv_acc[4 * nn + 3]));
        }
        continue;
      }
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
// launchers
// ---------------------------------------------------------------------------

template <int D>
using Dim = std::integral_constant<int, D>;

// Calls f(T{}, Dim<D>{}) for a 16-bit dtype code (1 bfloat16, 2 float16)
// and the smallest instance D of 32, 64 and 128 that holds the head dim d.
template <typename F>
int tc_dispatch(int dtype, int d, F f) {
  auto by_dim = [&](auto t) -> int {
    if (d <= 32) return f(t, Dim<32>{});
    if (d <= 64) return f(t, Dim<64>{});
    return f(t, Dim<128>{});
  };
  return dtype == 1 ? by_dim(bf16{}) : by_dim(f16{});
}

// The tensor-core kernels take the 16-bit types at head dims up to 256:
// the forward fwd_wg, the backward dq_tc/dkv_tc up to 128 (Q and dO, or K
// and V, resident for 128 rows) and dq_wide/dkv_wide above
// (flash_backward_wide.cu); each by TMA at rows of a multiple of 16 bytes
// (d % 8 == 0), else by the ragged producer's cp.async. Everything else
// runs in fwd_any (flash_forward_any.cu) and dq_any, dkv_any
// (flash_backward_any.cu).
bool tc_forward(int dtype, int d) { return (dtype == 1 || dtype == 2) && d <= 256; }

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

Problem make_problem(const void* limits, const void* q_ids,
                     const void* kv_ids, const void* mask, void* tiles,
                     long long mask_b, long long mask_h, long long mask_r,
                     long long mask_c, int map_batch, int map_heads,
                     int heads, int sq, int skv, int d, int lim_bstride,
                     int lim_rstride, int causal, int window,
                     double sm_scale) {
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
  p.scale = static_cast<float>(sm_scale);
  p.scale64 = sm_scale;
  return p;
}

}  // namespace

// Every entry point takes the tensors, then the visibility arguments
// (q_ids, kv_ids: segment ids [B, Sq] and [B, Skv] int32 or null; mask:
// one byte a (b, h, row, key) at b mask_b + h mask_h + row mask_r + key
// mask_c, or null; tiles: the class map [map_batch, map_heads, Sq / 64,
// Skv / 64] bytes, written by the forward and read by the backward), then
// the shape: bh, heads, sq, skv, head_dim (any d >= 1), the kv limits'
// strides, causal, window, sm_scale, the dtype (0 float32, 1 bfloat16, 2
// float16, 3 float64: q, k, v, o, do, dq, dk, dv alike) and the stream.
// Each returns the cudaError_t of its launch, or kMapError + libcuda's
// CUresult when a TMA map was refused; the caller raises on non-zero.
#define LAMP_VIS_PARAMS                                                    \
  const void *q_ids, const void *kv_ids, const void *mask, void *tiles,    \
      long long mask_b, long long mask_h, long long mask_r,                \
      long long mask_c, int map_batch, int map_heads, int bh, int heads,   \
      int sq, int skv, int head_dim, int lim_bstride, int lim_rstride,     \
      int causal, int window, double sm_scale, int dtype, void *stream
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
  if (head_dim <= 0) return cudaErrorInvalidValue;
  const Problem p = LAMP_PROBLEM(limits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = p.tiles_q * p.tiles_k;
  if (p.tiles != nullptr && blocks > 0) {
    const cudaError_t err =
        launch(tile_classes, dim3(cdiv(blocks, 128), map_batch * map_heads),
               128, 0, st, p, map_heads);
    if (err != cudaSuccess) return err;
  }
  if (!tc_forward(dtype, head_dim))
    return any_fwd(dtype, q, k, v, o, lse, p, bh, st);
  // wgmma (flash_forward.cu): tiles by TMA at rows of a multiple of 16
  // bytes (d % 8 == 0), by cp.async at the other head dims
  return wg_fwd(dtype, q, k, v, o, static_cast<float*>(lse), p, bh, st);
}

// di: rowsum(o * do), written here for the dkv kernel (f64 for float64
// inputs, as lse, else f32)
int lamp_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* di, const void* limits,
                                void* dq, LAMP_VIS_PARAMS) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  if (head_dim <= 0) return cudaErrorInvalidValue;
  const Problem p = LAMP_PROBLEM(limits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tc_forward(dtype, head_dim))
    return any_dq(dtype, q, k, v, o, dout, lse, di, dq, p, bh, st);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(di);
  if (head_dim > 128)
    return wide_dq(dtype, q, k, v, o, dout, l, dd, dq, p, bh, st);
  return tc_dispatch(dtype, head_dim, [&](auto t, auto dim) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dim)::value;
    const T *ot = static_cast<const T*>(o), *dot = static_cast<const T*>(dout);
    T* out = static_cast<T*>(dq);
    // d % 8 == 0: TMA maps; else the ragged producer's rows (no maps)
    const bool ragged = head_dim % 8 != 0;
    CUtensorMap m[4] = {};  // q, k, v, do
    BwdRows<T> rows{nullptr, nullptr, nullptr, nullptr};
    if (ragged) {
      rows = {static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), dot};
    } else {
      const int rc = tile_maps<T, D, 4>(
          m, {q, k, v, dout}, {sq, skv, skv, sq},
          {64, dq_kv_tile(D), dq_kv_tile(D), 64}, bh, head_dim);
      if (rc != 0) return rc;
    }
    const dim3 grid(cdiv(sq, 128), bh);
    auto go = [&](auto kernel) {
      return launch(kernel, grid, kBwdThreads, smem_dq<D>(), st, m[0], m[1],
                    m[2], m[3], rows, ot, dot, l, dd, out, p);
    };
    if (p.tiles != nullptr)
      return ragged ? go(dq_tc<D, T, true, true>) : go(dq_tc<D, T, true, false>);
    return ragged ? go(dq_tc<D, T, false, true>) : go(dq_tc<D, T, false, false>);
  });
}

// di is the dq kernel's output: launch dq first
int lamp_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, const void* limits, void* dk,
                                 void* dv, LAMP_VIS_PARAMS) {
  if (bh == 0 || skv == 0) return cudaSuccess;
  if (head_dim <= 0) return cudaErrorInvalidValue;
  const Problem p = LAMP_PROBLEM(limits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tc_forward(dtype, head_dim))
    return any_dkv(dtype, q, k, v, dout, lse, di, dk, dv, p, bh, st);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  if (head_dim > 128)
    return wide_dkv(dtype, q, k, v, dout, l, dd, dk, dv, p, bh, st);
  return tc_dispatch(dtype, head_dim, [&](auto t, auto dim) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dim)::value;
    T *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
    const bool ragged = head_dim % 8 != 0;
    CUtensorMap m[4] = {};  // q, k, v, do
    BwdRows<T> rows{nullptr, nullptr, nullptr, nullptr};
    if (ragged) {
      rows = {static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<const T*>(dout)};
    } else {
      const int rc = tile_maps<T, D, 4>(
          m, {q, k, v, dout}, {sq, skv, skv, sq},
          {dkv_q_tile(D), 64, 64, dkv_q_tile(D)}, bh, head_dim);
      if (rc != 0) return rc;
    }
    const dim3 grid(cdiv(skv, 128), bh);
    auto go = [&](auto kernel) {
      return launch(kernel, grid, kBwdThreads, smem_dkv<D>(), st, m[0], m[1],
                    m[2], m[3], rows, l, dd, dkt, dvt, p);
    };
    if (p.tiles != nullptr)
      return ragged ? go(dkv_tc<D, T, true, true>)
                    : go(dkv_tc<D, T, true, false>);
    return ragged ? go(dkv_tc<D, T, false, true>)
                  : go(dkv_tc<D, T, false, false>);
  });
}

}  // extern "C"
