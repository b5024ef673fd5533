// The flash-attention backward for Hopper (sm_90a) at the 16-bit head dims
// 129-256: dq_wide<D, T, M, R>, then dkv_wide<D, T, M, R>, on wgmma, TMA and
// mbarriers (hopper.cuh). D is 192 or 256, the smallest instance that
// holds the head dim d (columns past d read 0 and are not stored); T is
// bf16 or f16; M, as in every tensor-core kernel here, says whether
// segment ids or a mask are given; R that d is not a multiple of 8, whose
// tiles the producer's 128 threads copy by cp.async (flash_attention.cu's
// header note: the ragged producer; the consumers are the same). They
// replace the Pallas TPU kernels _bwd_dq_kernel and _bwd_dkv_kernel of
// lamp_tpu/ops/attention.py (K2b, K2c) for those calls; the entry points of
// flash_attention.cu route here (lamp_flash::wide_dq, wide_dkv). Layout,
// visibility and numerics are flash_attention.cu's header note, and so is
// the split design: dq runs first and writes di = rowsum(o do) for dkv; no
// atomics and no partial-dq slab, so two calls give the same bits; f32
// accumulation, P rounded to do's type for dV, dS to q's type for dK and
// dQ, rows with no visible key exactly 0.
//
// What bounds it: tensor-core operations. At B=2, H=8, S=2048, D=256,
// causal (33.6 M visible pairs), dq's 3 products (S, dP, dQ) are 51.6
// GFLOP, 52.1 us at the H100's 989 TFLOP/s bf16 dense rate, and dkv's 4
// (S^T, dP^T, dV, dK) 68.8 GFLOP, 69.5 us, against 16.8 MB of each of q,
// k, v, o, do, dq, dk, dv (each kernel moves 6 of them, 101 MB: 30 us at
// 3.35 TB/s). Any backward needs 5 products (86.9 us); the split design
// does 7.
//
// Design. Both kernels are a TMA producer warpgroup (its first warp loads,
// the rest idle) and consumer warpgroups that run every product by wgmma
// on 128-byte-swizzled tiles. A ring stage completes on its `full`
// mbarrier and is refilled after its `empty` mbarrier has one arrival from
// each consumer warp that reads it (release()).
//  - dq_wide: a block owns 64 NC query rows, Q and dO resident; NC = 1 at
//    D=256 (Q and dO take 64 KB, the f32 dQ 128 registers a thread, S and
//    dP 32 each: 256 threads, so ptxas may give a thread 255 registers and
//    no setmaxnreg is needed) and 2 at D=192 (96 KB, dQ 96 registers;
//    setmaxnreg 40 / 232). The producer streams 64-key K and V tiles
//    through 2 stages (64 KB a stage at D=256, 48 at 192). Per tile and
//    consumer: S = Q K^T and dP = dO V^T (m64n64, A and B K-major),
//    p = exp2(s scale log2e - lse log2e), dS = p (dP - di) scale rounded to
//    T as the register A of dQ += dS K (m64nD, K read MN-major). The next
//    tile's S and dP are issued while this tile's dQ product runs; its
//    stage is released when the product is done. di = rowsum(o do) is
//    computed first, in f32, and written for dkv.
//  - dkv_wide: a block owns 64 keys, K and V resident; the producer streams
//    64-row tiles of Q and dO, with each row's lse log2e, di, visible key
//    range and segment id, through 2 stages at D=256 (3 at 192). dK and dV
//    (2 x 64 x 256 f32) would take 256 registers a thread in one
//    warpgroup, so two consumers split the products, not the columns: the
//    first computes S^T = K Q^T, P^T (the visibility, exp2) and dV += P^T
//    dO; the second dP^T = V dO^T and, with P^T from the first through 16
//    KB of shared memory (f32, so that dS is taken from the unrounded p, as
//    in _bwd_dkv_kernel) behind two named barriers, dS^T = P^T (dP^T - di)
//    scale and dK += dS^T Q. So dkv does its 4 products, none twice (the
//    mma.sync backward this replaced split its output columns over two
//    blocks and computed S^T and dP^T in both: 6), and only the first
//    consumer tests
//    visibility. Each consumer's next score product is issued while its
//    register-A product runs.
//  - dq's row blocks run last-first (the long causal rows first), dkv's key
//    blocks first-first (key 0 sees the most rows).
//  - Visibility as in dq_tc and dkv_tc: rule 1 per element only in tiles
//    the bounds cut; under M a tile is loaded unless the class map hides it
//    (from every dq consumer's rows; dkv's one 64 x 64 block), its kv ids
//    staged beside it, ids and mask bytes tested only in partial tiles.
//
// Resources (ptxas -v for sm_90a): chip_smoke.py prints the build's table
// first, and flash_attention.cu's header note holds the figures.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace lamp_flash;

typedef __nv_bfloat16 bf16;
typedef __half f16;

// the keys of dq's K/V tiles and the rows of dkv's Q/dO tiles (S, dP and
// their transposes are m64n64)
constexpr int kTileRows = 64;
// the shared memory that tiles may take, beside the static and 1 KB to
// align them
constexpr int kSmemTiles = 220 * 1024;

// consumer warpgroups of 64 rows a dq block: 1 at D=256, 2 at D=192
__host__ __device__ constexpr int dq_consumers(int d) { return d > 192 ? 1 : 2; }

// stages of a ring: as many as fit beside the resident bytes, at most 4
__host__ __device__ constexpr int ring_stages(int resident, int stage) {
  return (kSmemTiles - resident) / stage < 4 ? (kSmemTiles - resident) / stage
                                             : 4;
}
// dq: Q and dO resident, stages of a K and a V tile
__host__ __device__ constexpr int dq_stages(int d) {
  return ring_stages(2 * 64 * dq_consumers(d) * d * 2, 2 * kTileRows * d * 2);
}
// dkv: K, V and the P^T exchange resident, stages of a Q and a dO tile
constexpr int kExchange = 64 * kTileRows * 4;  // P^T in f32
__host__ __device__ constexpr int dkv_stages(int d) {
  return ring_stages(2 * 64 * d * 2 + kExchange, 2 * kTileRows * d * 2);
}

// registers a thread after setmaxnreg with a producer and two consumer
// warpgroups: 128 x 40 + 256 x 232 of the SM's 64K
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// named barriers of dkv_wide's P^T exchange (0 is __syncthreads), each
// over its two consumer warpgroups
constexpr int kPFull = 1, kPFree = 2, kPairThreads = 256;
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kPairThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(kPairThreads) : "memory");
}

template <int D>
int smem_dq() {
  return 1024 + 2 * 64 * dq_consumers(D) * D * 2 +
         dq_stages(D) * 2 * kTileRows * D * 2;
}
template <int D>
int smem_dkv() {
  return 1024 + 2 * 64 * D * 2 + kExchange + dkv_stages(D) * 2 * kTileRows * D * 2;
}

template <int D, typename T, bool M, bool R>
__global__ void __launch_bounds__(128 * (dq_consumers(D) + 1), 1)
dq_wide(const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_do, const BwdRows<T> rg,
        const T* __restrict__ o, const T* __restrict__ dout,
        const float* __restrict__ lse, float* __restrict__ di,
        T* __restrict__ dq, Problem p) {
  using namespace hopper;
  constexpr int NC = dq_consumers(D), BR = 64 * NC, BC = kTileRows;
  constexpr int ST = dq_stages(D), kThreads = 128 * (NC + 1);
  static_assert(ST >= 2, "two stages of K and V at least");
  constexpr int W = 128, C = W / 2;  // a column block
  constexpr int kHalf = 64 * D * 2;  // bytes of one consumer's Q (or dO) rows
  constexpr int kTile = BC * D * 2;  // bytes of a K (or V) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);  // [NC parts][D / C][64][C]
  unsigned char* dos = qs + NC * kHalf;
  unsigned char* ring = dos + NC * kHalf;   // ST x [K tile, V tile]
  __shared__ __align__(8) uint64_t q_full, full[ST], empty[ST];
  __shared__ int lim_max[NC];
  // masked: each streamed tile's class for the consumers' 64-row parts,
  // and the kv ids of each stage's tile (0 without ids), written by the
  // producer warp's lanes before they arrive on the stage's `full` barrier
  __shared__ unsigned char tcls_s[NC][M ? kMaxTiles : 1];
  __shared__ int kid_s[ST][M ? BC : 1];

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;  // long causal rows first
  const int qb0 = r0 / kBlock;
  const int tid = threadIdx.x;
  if (tid == 0) {
    // the ragged producer: an arrival from each of its threads
    mbar_init(&q_full, R ? 128 : 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], R ? 128 : M ? 32 : 1);
      mbar_init(&empty[s], 4 * NC);
    }
    mbar_fence_init();
    for (int w = 0; w < NC; ++w) lim_max[w] = 0;
  }
  if constexpr (R) {  // the columns d..D that TMA would have read as 0
    for (int hf = 0; hf < NC; ++hf) {
      zero_tail<D, 64, W>(qs + hf * kHalf, p.d, tid, kThreads);
      zero_tail<D, 64, W>(dos + hf * kHalf, p.d, tid, kThreads);
    }
    for (int s = 0; s < 2 * ST; ++s)
      zero_tail<D, BC, W>(ring + s * kTile, p.d, tid, kThreads);
  }
  __syncthreads();
  if (tid < BR) atomicMax(&lim_max[tid / 64], row_limit(p, b, r0 + tid));
  __syncthreads();
  int lo, hi, lim = 0;
  kv_range(p, r0, BR, &lo, &hi);
  for (int w = 0; w < NC; ++w) lim = max(lim, lim_max[w]);
  hi = min(hi, lim);
  const int first = (lo / BC) * BC;
  const int tiles = tile_count(first, hi, BC);
  // the class of tile i for the consumer part hf: staged in shared memory
  // by every thread at once when the tiles fit, else read from the map in
  // place
  const bool staged = M && tiles <= kMaxTiles;
  auto tile_class = [&](int hf, int i) -> int {
    if (staged) return tcls_s[hf][i];
    return span_class(class_row(p, b, h, qb0 + hf), p.tiles_k, first + i * BC,
                      BC);
  };
  if constexpr (M) {
    if (staged) {
      for (int i = tid; i < NC * tiles; i += kThreads)
        tcls_s[i / tiles][i % tiles] =
            span_class(class_row(p, b, h, qb0 + i / tiles), p.tiles_k,
                       first + (i % tiles) * BC, BC);
      __syncthreads();
    }
  }
  // a tile is loaded unless the class map hides its keys from every
  // consumer's part; producer and consumers walk this same sequence
  auto loaded = [&](int i) {
    if constexpr (M) {
      for (int w = 0; w < NC; ++w)
        if (tile_class(w, i) != kSkip) return true;
      return false;
    }
    return true;
  };

  if (tid < 128 && R) {  // the ragged producer: every thread copies
    if constexpr (NC > 1) regs_dec<kProducerRegs>();
    produce_dq<NC, BC, ST, W, M>(rg, p, b, bh, r0, first, tiles, loaded, qs,
                                 dos, kHalf, ring, kTile, &q_full, full,
                                 empty, &kid_s[0][0]);
  } else if (tid < 128) {  // producer
    if constexpr (NC > 1) regs_dec<kProducerRegs>();
    // the first thread (masked: the first warp, for the kv ids)
    if (tid == 0 || (M && tid < 32)) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_tx(&q_full, 2 * NC * kHalf);
        for (int hf = 0; hf < NC; ++hf)
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
        const int st = n % ST;
        mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
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
    if constexpr (NC > 1) regs_inc<kConsumerRegs>();
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
      const int st = n % ST;
      wait_stage<R>(&full[st], (n / ST) & 1);
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
          release(&empty[held]);
          held = -1;
        }
        release(&empty[st]);
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
      if (held >= 0) release(&empty[held]);
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
        const bool masked = p.mask != nullptr;
#pragma unroll
        for (int i2 = 0; i2 < BC / 2; ++i2) {
          const int cc = (i2 / 4) * 8 + 2 * t + (i2 & 1), col = c0 + cc;
          const int2 kb2 = (i2 & 2) ? bb : ba;
          const float x = s[i2] * sl2 - ((i2 & 2) ? lse_b : lse_a);
          bool vis = col >= kb2.x && col < kb2.y &&
                     ((i2 & 2) ? qid_b : qid_a) == kid[cc];
          if (masked && vis) vis = mask_keeps(p, b, h, (i2 & 2) ? rb : ra, col);
          s[i2] = fast_exp2(vis ? x : -INFINITY);
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
    if (held >= 0) release(&empty[held]);
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

template <int D, typename T, bool M, bool R>
__global__ void __launch_bounds__(384, 1)
dkv_wide(const __grid_constant__ CUtensorMap tm_q,
         const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v,
         const __grid_constant__ CUtensorMap tm_do, const BwdRows<T> rg,
         const float* __restrict__ lse, const float* __restrict__ di,
         T* __restrict__ dk, T* __restrict__ dv, Problem p) {
  using namespace hopper;
  constexpr int BC = 64, BR = kTileRows, ST = dkv_stages(D);
  static_assert(ST >= 2, "two stages of Q and dO at least");
  constexpr int W = 128, C = W / 2;  // a column block
  constexpr int kKeys = BC * D * 2;  // bytes of K (or V)
  constexpr int kTile = BR * D * 2;  // bytes of a Q (or dO) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);  // [D / C][64][C]
  unsigned char* vs = ks + kKeys;
  // P^T of the tile in flight, f32, [BR / 2][128]: element i of consumer
  // thread l at i * 128 + l (the two consumers' accumulators share a layout)
  float* pex = reinterpret_cast<float*>(vs + kKeys);
  unsigned char* ring = vs + kKeys + kExchange;  // ST x [Q tile, dO tile]
  // row statistics, read as float2, int2 and int4 by the consumers
  __shared__ __align__(16) float lse_s[ST][BR], di_s[ST][BR];
  __shared__ __align__(16) int2 keys_s[ST][BR];  // visible keys [lo, hi)
  __shared__ __align__(16) int qid_s[ST][M ? BR : 1];  // segment ids
  __shared__ __align__(8) uint64_t kv_full, full[ST], empty[ST];
  // masked: the class map's entries of every row block against the keys
  __shared__ unsigned char cls_s[M ? kMaxTiles : 1];

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int c0 = blockIdx.x * BC;  // key 0 walks the most q tiles: first
  const int tid = threadIdx.x;
  const long long lbase = (long long)bh * p.sq;
  int lo, hi;
  q_range(p, c0, BC, &lo, &hi);
  const int first = (lo / BR) * BR;
  const int tiles = tile_count(first, hi, BR);
  const bool staged = M && p.tiles_q <= kMaxTiles;
  // the class of row block qb against the block's keys
  auto row_class = [&](int qb) -> int {
    if (staged) return cls_s[qb];
    return span_class(p, b, h, qb, c0, BC);
  };
  // a q tile is loaded unless the class map hides its rows from the keys;
  // producer and both consumers walk this same sequence
  auto loaded = [&](int r0) { return !M || row_class(r0 / kBlock) != kSkip; };
  if (tid == 0) {
    mbar_init(&kv_full, R ? 128 : 1);
    for (int s = 0; s < ST; ++s) {
      // the producer warp's lanes (R: every producer thread's copies, and
      // the first warp's lanes again after the row statistics)
      mbar_init(&full[s], R ? 128 + 32 : 32);
      mbar_init(&empty[s], 8);  // one a consumer warp
    }
    mbar_fence_init();
  }
  if constexpr (M) {
    if (staged)
      for (int qb = tid; qb < p.tiles_q; qb += 384)
        cls_s[qb] = span_class(p, b, h, qb, c0, BC);
  }
  if constexpr (R) {  // the columns d..D that TMA would have read as 0
    zero_tail<D, BC, W>(ks, p.d, tid, 384);
    zero_tail<D, BC, W>(vs, p.d, tid, 384);
    for (int s = 0; s < 2 * ST; ++s)
      zero_tail<D, BR, W>(ring + s * kTile, p.d, tid, 384);
  }
  __syncthreads();

  if (tid < 128 && R) {  // the ragged producer: every thread copies
    regs_dec<kProducerRegs>();
    produce_dkv<1, BR, ST, W, M>(
        rg, p, b, bh, c0, first, tiles, loaded, lse, di, ks, vs, kKeys, ring,
        kTile, &kv_full, full, empty, &lse_s[0][0], &di_s[0][0],
        &keys_s[0][0], &qid_s[0][0]);
  } else if (tid < 128) {  // producer
    regs_dec<kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_tx(&kv_full, 2 * kKeys);
        for (int cb = 0; cb < D / C; ++cb) {
          tma_load_3d(ks + cb * BC * W, &tm_k, &kv_full, cb * C, c0, bh);
          tma_load_3d(vs + cb * BC * W, &tm_v, &kv_full, cb * C, c0, bh);
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
        const int st = n % ST, r0 = first + i * BR;
        mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
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
  } else {  // consumers: 0 runs S^T, P^T and dV; 1 runs dP^T, dS^T and dK
    regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, lt = tid % 128;
    const int warp = lt / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int ka = c0 + warp * 16 + g, kb = ka + 8;
    // the segment ids of keys ka and kb
    const int kid_a = M && p.q_ids != nullptr && ka < p.skv
                          ? p.kv_ids[(long long)b * p.skv + ka] : 0;
    const int kid_b = M && p.q_ids != nullptr && kb < p.skv
                          ? p.kv_ids[(long long)b * p.skv + kb] : 0;
    const float sl2 = p.scale * kLog2e;
    // the score product's A: K (S^T = K Q^T) or V (dP^T = V dO^T)
    const unsigned char* mine = wg == 0 ? ks : vs;
    float acc[D / 2];  // dV or dK
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // P^T or dS^T as the register A of this consumer's output product,
    // which runs on while the next tile's score product is issued; the
    // stage is released once it is done
    uint32_t xa[BR / 16][4];
    int total = 0;  // loaded tiles: the exchange pairs each one
    for (int i = 0; i < tiles; ++i) total += loaded(first + i * BR);
    int held = -1;  // the stage an in-flight output product reads, or -1
    int n = 0;      // tiles loaded, as the producer counts them
    wait_stage<R>(&kv_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int r0 = first + i * BR;
      if (!loaded(r0)) continue;
      const int st = n % ST;
      wait_stage<R>(&full[st], (n / ST) & 1);
      const unsigned char* qt = ring + st * 2 * kTile;
      const unsigned char* dot = qt + kTile;
      float s[BR / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BR, T>(s, desc_k<64, W>(mine, kk),
                        desc_k<BR, W>(wg == 0 ? qt : dot, kk), kk > 0);
      wg_commit();
      // the row statistics of columns 8j + 2t and 8j + 2t + 1: lse log2e
      // (consumer 0) or di (consumer 1)
      const float* stat = wg == 0 ? lse_s[st] : di_s[st];
      float2 st2[BR / 8];
#pragma unroll
      for (int j = 0; j < BR / 8; ++j)
        st2[j] = *reinterpret_cast<const float2*>(&stat[j * 8 + 2 * t]);
      wg_wait<0>();  // the score product, and the previous output product
      wg_keep(s);
      wg_keep(acc);
      wg_keep(xa);
      if (held >= 0) release(&empty[held]);
      if (wg == 0) {  // P^T
        const int cls = M ? row_class(r0 / kBlock) : kFull;
        if (cls == kFull && full_tile(p, r0, BR, c0, BC)) {
#pragma unroll
          for (int i2 = 0; i2 < BR / 2; ++i2)
            s[i2] = fast_exp2(s[i2] * sl2 -
                              ((i2 & 1) ? st2[i2 / 4].y : st2[i2 / 4].x));
        } else if (cls == kFull) {
#pragma unroll
          for (int j = 0; j < BR / 8; ++j) {
            const int4 kb4 =
                *reinterpret_cast<const int4*>(&keys_s[st][j * 8 + 2 * t]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = e < 2 ? ka : kb;
              const int klo = (e & 1) ? kb4.z : kb4.x;
              const int khi = (e & 1) ? kb4.w : kb4.y;
              const float x =
                  s[4 * j + e] * sl2 - ((e & 1) ? st2[j].y : st2[j].x);
              s[4 * j + e] = fast_exp2(key >= klo && key < khi ? x : -INFINITY);
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
              const int klo = (e & 1) ? kb4.z : kb4.x;
              const int khi = (e & 1) ? kb4.w : kb4.y;
              const int row = r0 + j * 8 + 2 * t + (e & 1);
              const float x =
                  s[4 * j + e] * sl2 - ((e & 1) ? st2[j].y : st2[j].x);
              // ids 0 = 0 without ids; the mask's bytes where it is given
              bool vis = key >= klo && key < khi &&
                         ((e & 1) ? qid2.y : qid2.x) == (e < 2 ? kid_a : kid_b);
              if (masked && vis) vis = mask_keeps(p, b, h, row, key);
              s[4 * j + e] = fast_exp2(vis ? x : -INFINITY);
            }
          }
        }
        // P^T to the other consumer, once it has read the previous tile's
        if (n > 0) named_sync(kPFree);
#pragma unroll
        for (int i2 = 0; i2 < BR / 2; ++i2) pex[i2 * 128 + lt] = s[i2];
        named_arrive(kPFull);
      } else {  // dS^T = P^T (dP^T - di) scale, with this tile's P^T
        named_sync(kPFull);
        float pt[BR / 2];
#pragma unroll
        for (int i2 = 0; i2 < BR / 2; ++i2) pt[i2] = pex[i2 * 128 + lt];
        if (n + 1 < total) named_arrive(kPFree);
#pragma unroll
        for (int i2 = 0; i2 < BR / 2; ++i2)
          s[i2] = pt[i2] * (s[i2] - ((i2 & 1) ? st2[i2 / 4].y
                                               : st2[i2 / 4].x)) * p.scale;
      }
      // dV += P^T dO, or dK += dS^T Q (B MN-major)
      acc_to_a<BR, T>(xa, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        wgmma_rs<D, T>(acc, xa[kk], desc_mn<BR, W>(wg == 0 ? dot : qt, kk));
      wg_commit();
      held = st;
      ++n;
    }
    wg_wait<0>();
    wg_keep(acc);
    wg_keep(xa);
    if (held >= 0) release(&empty[held]);
    const long long kbase = (long long)bh * p.skv;
    T* out = wg == 0 ? dv : dk;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      const int col = nn * 8 + 2 * t;
      if (col >= p.d) break;
      if constexpr (R) {  // at an odd d, 2-byte stores
        if (ka < p.skv)
          store_pair(out, (kbase + ka) * p.d + col, col, p.d,
                     pack2<T>(acc[4 * nn], acc[4 * nn + 1]));
        if (kb < p.skv)
          store_pair(out, (kbase + kb) * p.d + col, col, p.d,
                     pack2<T>(acc[4 * nn + 2], acc[4 * nn + 3]));
        continue;
      }
      if (ka < p.skv)
        *reinterpret_cast<uint32_t*>(out + (kbase + ka) * p.d + col) =
            pack2<T>(acc[4 * nn], acc[4 * nn + 1]);
      if (kb < p.skv)
        *reinterpret_cast<uint32_t*>(out + (kbase + kb) * p.d + col) =
            pack2<T>(acc[4 * nn + 2], acc[4 * nn + 3]);
    }
  }
}

// d % 8 == 0: TMA maps; else the ragged producer's rows (no maps)
template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* di, void* dq,
              const Problem& p, int bh, cudaStream_t stream) {
  const bool ragged = p.d % 8 != 0;
  CUtensorMap m[4] = {};  // q, k, v, do
  BwdRows<T> rows{nullptr, nullptr, nullptr, nullptr};
  const T *ot = static_cast<const T*>(o), *dot = static_cast<const T*>(dout);
  if (ragged) {
    rows = {static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), dot};
  } else {
    const int rc = tile_maps<T, D, 4>(m, {q, k, v, dout},
                                      {p.sq, p.skv, p.skv, p.sq},
                                      {64, kTileRows, kTileRows, 64}, bh, p.d);
    if (rc != 0) return rc;
  }
  constexpr int NC = dq_consumers(D);
  const dim3 grid(cdiv(p.sq, 64 * NC), bh);
  T* out = static_cast<T*>(dq);
  auto go = [&](auto kernel) {
    return launch(kernel, grid, 128 * (NC + 1), smem_dq<D>(), stream, m[0],
                  m[1], m[2], m[3], rows, ot, dot, lse, di, out, p);
  };
  if (p.tiles != nullptr)
    return ragged ? go(dq_wide<D, T, true, true>)
                  : go(dq_wide<D, T, true, false>);
  return ragged ? go(dq_wide<D, T, false, true>)
                : go(dq_wide<D, T, false, false>);
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* di, void* dk, void* dv,
               const Problem& p, int bh, cudaStream_t stream) {
  const bool ragged = p.d % 8 != 0;
  CUtensorMap m[4] = {};  // q, k, v, do
  BwdRows<T> rows{nullptr, nullptr, nullptr, nullptr};
  if (ragged) {
    rows = {static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dout)};
  } else {
    const int rc = tile_maps<T, D, 4>(m, {q, k, v, dout},
                                      {p.sq, p.skv, p.skv, p.sq},
                                      {kTileRows, 64, 64, kTileRows}, bh, p.d);
    if (rc != 0) return rc;
  }
  const dim3 grid(cdiv(p.skv, 64), bh);
  T *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
  auto go = [&](auto kernel) {
    return launch(kernel, grid, 384, smem_dkv<D>(), stream, m[0], m[1], m[2],
                  m[3], rows, lse, di, dkt, dvt, p);
  };
  if (p.tiles != nullptr)
    return ragged ? go(dkv_wide<D, T, true, true>)
                  : go(dkv_wide<D, T, true, false>);
  return ragged ? go(dkv_wide<D, T, false, true>)
                : go(dkv_wide<D, T, false, false>);
}

// calls f(T{}, std::integral_constant<int, D>{}) for the dtype code (1
// bfloat16, 2 float16) and the instance D (192 or 256) of the head dim
template <typename F>
int wide_dispatch(int dtype, int d, F f) {
  if (d <= 128 || d > 256 || (dtype != 1 && dtype != 2))
    return cudaErrorInvalidValue;
  auto by_dim = [&](auto t) -> int {
    if (d <= 192) return f(t, std::integral_constant<int, 192>{});
    return f(t, std::integral_constant<int, 256>{});
  };
  return dtype == 1 ? by_dim(bf16{}) : by_dim(f16{});
}

}  // namespace

namespace lamp_flash {

int wide_dq(int dtype, const void* q, const void* k, const void* v,
            const void* o, const void* dout, const float* lse, float* di,
            void* dq, const Problem& p, int bh, cudaStream_t stream) {
  return wide_dispatch(dtype, p.d, [&](auto t, auto dim) -> int {
    return launch_dq<decltype(dim)::value, decltype(t)>(
        q, k, v, o, dout, lse, di, dq, p, bh, stream);
  });
}

int wide_dkv(int dtype, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* di, void* dk,
             void* dv, const Problem& p, int bh, cudaStream_t stream) {
  return wide_dispatch(dtype, p.d, [&](auto t, auto dim) -> int {
    return launch_dkv<decltype(dim)::value, decltype(t)>(
        q, k, v, dout, lse, di, dk, dv, p, bh, stream);
  });
}

}  // namespace lamp_flash
