// The flash-attention forward for Hopper (sm_90a) on wgmma: fwd_wg<D, T, M,
// R>, for bfloat16 and float16 at every head dim d <= 256. It replaces the
// Pallas TPU kernel _fwd_kernel of lamp_tpu/ops/attention.py (K1) for those
// calls; the entry point lamp_flash_attention_fwd (flash_attention.cu)
// routes here, and everything else to fwd_any. Layout, visibility and numerics are flash_attention.cu's header
// note: q, o [B*H, Sq, d], k, v [B*H, Skv, d], lse [B*H, Sq] f32 in natural
// log; f32 accumulation, P rounded to v's type for P V (p.astype(v.dtype)
// in the TPU kernel), rows with no visible key o = 0 and lse = -inf.
//
// What bounds it: tensor-core operations, 4 d FLOPs a visible (row, key)
// pair (S = Q K^T and O += P V): the causal training slice (B=2, H=12,
// S=4096, d=64) is 51.5 GFLOP, 52 us at the H100's 989 TFLOP/s bf16 dense
// rate, against 25 MB of q, k, v and o (7.5 us at 3.35 TB/s).
// FlashAttention-2 on mma.sync reached ~173 TFLOP/s there on an H100
// (700 W); this design follows
// FlashAttention-3's forward (Shah et al., arXiv 2407.08608) to feed the
// tensor cores from swizzled shared memory, without fragments loaded
// through the register file.
//
// Design. A block owns 64 NC query rows of one (b, h) and is NC + 1
// warpgroups (hopper.cuh):
//  - the producer (setmaxnreg down to 40, 24 with NC = 3): one thread
//    loads Q once and streams K and V tiles of BC keys by TMA (3-D maps
//    [B*H, S, d], 128-byte swizzled, 64-byte at D=32, zero-filled past d
//    and past S) into two rings of ST stages, K's and V's, each stage
//    completing on a `full` mbarrier and refilled once its `empty`
//    mbarrier has an arrival from each consumer warp (one a warp: 256
//    arrivals a thread serialize in shared memory). Under ids or a mask
//    (M) the producer warp's lanes stage each K tile's kv ids beside it.
//  - R (the ragged producer: d % 8 != 0, whose rows of 2d bytes TMA's
//    16-byte global strides cannot describe): the producer's 128 threads
//    copy the same tiles into the same swizzled layout by cp.async, 8 bytes
//    a piece at d % 4 == 0 (a 200-byte row of d = 100) and 4 bytes at
//    other even d, each thread one column of pieces down the rows; at an
//    odd d, whose rows lie 2-byte aligned, by 4-byte loads of the tile's
//    contiguous span, several in flight, and 2-byte stores; copies past
//    S are zero-filled, and the columns from d to D are zeroed once in
//    every buffer before the loop (16 bytes at a time), which no copy
//    overwrites. Each thread's
//    copies of a tile arrive on its `full` barrier (128 arrivals) through
//    cp.async.mbarrier.arrive.noinc (a plain arrival after the 2-byte
//    stores), the kv ids under M among them; a consumer fences the async
//    proxy (fence.proxy.async) after each wait, before wgmma reads what
//    the generic proxy wrote. The consumers are the same code. At NC = 3
//    the producer keeps 32 registers (128 x 32 + 384 x 160 = 64K) for its
//    address arithmetic.
//  - NC consumers (setmaxnreg up to 232, 160 with NC = 3) of 64 rows each.
//    Per tile: S = Q K^T (wgmma, A and B K-major from shared memory); the
//    visibility (below); an online softmax in the log2 domain by
//    ex2.approx (m, l per row, the maxima on the raw scores and sm_scale
//    log2(e) folded into the exponent's FMA when it is positive; O
//    rescaled by 2^(m_old - m_new)); P rounded to T and packed as the
//    register A operand (acc_to_a) of O += P V (wgmma, V read MN-major,
//    the transpose bit).
//  - overlap: tile j's S is issued together with tile j-1's P V, so that
//    the softmax of tile j can run while P V of tile j-1 is on the tensor
//    cores, and the consumers' streams interleave on the SM's four
//    schedulers. K's stage is released once its softmax is done, V's once
//    its product is. On an H100 a consumer's issue of its products stalls
//    until the tensor cores take them (a clock64 timeline of the loop,
//    scripts/exp_k1_variants.py: ~40% of its cycles at D=64), so the
//    tensor cores stay busy only while the other consumers have softmax
//    work: at D <= 64 a consumer's softmax (BC / 2 exponentials a thread
//    at the MUFU's 16 a cycle an SM) takes as long as its products, and NC
//    is 3 there, 2 above (three consumers: 13% faster at S=4096, D=64;
//    turns taken by named barriers, FlashAttention-3's ping-pong, gained
//    5% with two consumers and lost 9% with three, so there are none).
//  - BC is 128 keys up to D=128 and 64 above (O takes D / 2 registers a
//    thread, S BC / 2 and P BC / 4), and 64 in the masked instance with
//    three consumers (at 160 registers its partial tiles spilled 576
//    bytes at 128 keys, 40 at 64, at the same speed); ST as many stages of
//    K and V as fit beside Q in 220 KB, at most 4; instances D = 32, 64,
//    128, 192 and 256 hold every d up to 256 in the smallest D >= d
//    (columns past d read 0 and are not stored; at an odd d the output's
//    last column is stored alone).
//  - Visibility: rule 1 (key_bounds, full_tile) per element only in tiles
//    the bounds cut; under M the 64 x 64 class map is read per consumer's
//    64 rows: a tile is loaded unless the map hides it from every
//    consumer, a consumer whose rows it hides retires the stage unused
//    (after retiring the product it holds, so that a run of skipped tiles
//    cannot starve the producer), and ids and mask bytes are tested only
//    in partial tiles. The masked and unmasked instances are separate:
//    sharing one made the mma.sync forward 1.8x slower on an H100.
//  - Row blocks run last-first, so the long causal rows start first.
//
// Resources (ptxas -v for sm_90a): the launch bound, 168 registers (384
// threads; the consumers run at 232 after setmaxnreg) or 128 (512
// threads, NC = 3; 160), no spills but 40 bytes in the masked D=32 and
// D=64 instances; dynamic shared memory, with 1 KB for alignment, Q (64
// NC D 2 bytes) and ST stages of a K and a V tile: 153 KB at D=64 (89 KB
// masked), 161 KB at D=128, 193 KB at D=192 and D=256, 77 KB at D=32 (45
// KB masked); beside it up to 4.2 KB static (the masked instances' class
// bytes and staged kv ids). chip_smoke.py prints the build's table first.

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

// consumer warpgroups of 64 rows a block: 3 up to D=64, 2 above (the
// header's note)
__host__ __device__ constexpr int wg_consumers(int d) { return d <= 64 ? 3 : 2; }

// the keys of a K/V tile: 128; 64 above D=128 (registers), and in the
// masked instance with three consumers (at 160 registers a thread its
// partial tiles' tests spill at 128 keys)
__host__ __device__ constexpr int wg_kv_tile(int d, bool m) {
  return d > 128 || (m && wg_consumers(d) == 3) ? 64 : 128;
}

// registers a thread after setmaxnreg, within the SM's 64K: 128 x 40 + 256
// x 232 with two consumers, 128 x 24 + 384 x 160 with three (the ragged
// producer's cp.async addresses: 128 x 32 + 384 x 160)
__host__ __device__ constexpr int wg_producer_regs(int nc, bool r) {
  return nc == 3 ? (r ? 32 : 24) : 40;
}
__host__ __device__ constexpr int wg_consumer_regs(int nc) { return nc == 3 ? 160 : 232; }

// stages of each of the K and V rings: as many as fit beside Q in 220 KB,
// at most 4
__host__ __device__ constexpr int wg_stages(int d, bool m) {
  return (220 * 1024 - 64 * wg_consumers(d) * d * 2) /
                     (2 * wg_kv_tile(d, m) * d * 2) < 4
             ? (220 * 1024 - 64 * wg_consumers(d) * d * 2) /
                   (2 * wg_kv_tile(d, m) * d * 2)
             : 4;
}

// dynamic shared memory, with 1 KB to align the swizzled tiles
template <int D, bool M>
int smem_wg() {
  return 1024 + 64 * wg_consumers(D) * D * 2 +
         wg_stages(D, M) * 2 * wg_kv_tile(D, M) * D * 2;
}

// O += P V for one V tile of BC keys (P: BC / 16 register A operands), one
// committed wgmma group. O and P are pinned and fenced right here: a fence
// that ptxas inserts itself, in a branch, serializes every wgmma of the
// kernel (its C7520 warning).
template <int D, int BC, int W, typename T>
__device__ __forceinline__ void pv_product(float (&acc)[D / 2],
                                           uint32_t (&pa)[BC / 16][4],
                                           const unsigned char* vt) {
  hopper::wg_keep(acc);
  hopper::wg_keep(pa);
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk)
    hopper::wgmma_rs<D, T>(acc, pa[kk], hopper::desc_mn<BC, W>(vt, kk));
  hopper::wg_commit();
}

// the ragged producer's inputs: q, k, v as [B*H, S, d] rows (null in the
// TMA instances)
template <typename T>
struct Rows {
  const T *q, *k, *v;
};

template <int D, typename T, bool M, bool R>
__global__ void __launch_bounds__(128 * (wg_consumers(D) + 1), 1)
fwd_wg(const __grid_constant__ CUtensorMap tm_q,
       const __grid_constant__ CUtensorMap tm_k,
       const __grid_constant__ CUtensorMap tm_v, const Rows<T> rg,
       T* __restrict__ o, float* __restrict__ lse, Problem p) {
  using namespace hopper;
  constexpr int NC = wg_consumers(D), BR = 64 * NC;
  constexpr int BC = wg_kv_tile(D, M), ST = wg_stages(D, M);
  constexpr int kThreads = 128 * (NC + 1), kReleases = 4 * NC;
  static_assert(ST >= 2, "two stages of K and V at least");
  constexpr int W = swizzle_bytes(D), C = W / 2;  // a column block
  constexpr int kHalf = 64 * D * 2;  // bytes of one consumer's Q rows
  constexpr int kTile = BC * D * 2;  // bytes of a K (or V) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);  // [NC parts][D / C][64][C]
  unsigned char* ks = qs + NC * kHalf;      // ST K tiles [D / C][BC][C]
  unsigned char* vs = ks + ST * kTile;      // ST V tiles
  __shared__ __align__(8) uint64_t q_full, k_full[ST], k_empty[ST],
      v_full[ST], v_empty[ST];
  __shared__ int lim_max[NC];
  // masked: each streamed tile's class for the consumers' 64-row parts,
  // and the kv ids of each K stage's tile (0 without ids), written by the
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
      mbar_init(&k_full[s], R ? 128 : M ? 32 : 1);
      mbar_init(&k_empty[s], kReleases);
      mbar_init(&v_full[s], R ? 128 : 1);
      mbar_init(&v_empty[s], kReleases);
    }
    mbar_fence_init();
    for (int w = 0; w < NC; ++w) lim_max[w] = 0;
  }
  if constexpr (R) {
    // the columns from d to D of every row of Q and of every stage, which
    // TMA would have read as 0: each 16-byte chunk from the one holding
    // column d on, whole (the copies of the columns below d land after the
    // barrier below, and never write past d)
    const int c8 = p.d / 8, chunks = D / 8 - c8;
    constexpr int kQRows = NC * 64, kRows = kQRows + 2 * ST * BC;
    for (int i = tid; i < kRows * chunks; i += kThreads) {
      const int row = i / chunks, col = (c8 + i % chunks) * 8;
      const bool in_q = row < kQRows;
      const int r = in_q ? row % 64 : (row - kQRows) % BC;
      unsigned char* tile =
          in_q ? qs + (row / 64) * kHalf : ks + ((row - kQRows) / BC) * kTile;
      *reinterpret_cast<uint4*>(
          tile + (in_q ? swizzled<64, W>(r, col) : swizzled<BC, W>(r, col))) =
          make_uint4(0, 0, 0, 0);
    }
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
    regs_dec<wg_producer_regs(NC, R)>();
    // V elements a piece: 4 (8 bytes) at d % 4 == 0, 2 at other even d, 1
    auto produce = [&](auto piece) {
      constexpr int V = decltype(piece)::value;
      const Walk w = walk_of(tid, p.d, V);
      // a tile of `rows` rows from row0 of a [n, d] matrix g; this
      // thread's copies so far arrive on `bar` once landed
      auto copy = [&](unsigned char* tile, const T* g, int row0, int n,
                      auto rows) {
        constexpr int RS = decltype(rows)::value;
        if constexpr (V == 1)
          copy_tile_odd<RS, W, NC == 3 ? 4 : 8>(tile, g, row0, n, p.d, tid);
        else
          copy_tile<RS, W, V>(tile, g, row0, n, p.d, w);
      };
      auto arrive = [](uint64_t* bar) {
        if constexpr (V == 1)
          mbar_arrive(bar);
        else
          cp_async_arrive_noinc(bar);
      };
      for (int hf = 0; hf < NC; ++hf)
        copy(qs + hf * kHalf, rg.q + (long long)bh * p.sq * p.d, r0 + 64 * hf,
             p.sq, std::integral_constant<int, 64>{});
      arrive(&q_full);
      const T* kg = rg.k + (long long)bh * p.skv * p.d;
      const T* vg = rg.v + (long long)bh * p.skv * p.d;
      int n = 0;  // tiles loaded
      for (int i = 0; i < tiles; ++i) {
        const int c0 = first + i * BC;
        if (!loaded(i)) continue;
        const int st = n % ST;
        const uint32_t empty_phase = ((n / ST) & 1) ^ 1;
        ++n;
        mbar_wait(&k_empty[st], empty_phase);
        if constexpr (M) {  // the tile's kv ids (0 without ids), with K
          for (int u = tid; u < BC; u += 128) {
            const bool in = p.q_ids != nullptr && c0 + u < p.skv;
            const int* src = in ? p.kv_ids + (long long)b * p.skv + c0 + u
                                : reinterpret_cast<const int*>(kg);
            if constexpr (V == 1)
              kid_s[st][u] = in ? *src : 0;
            else
              cp_async_ca<4>(&kid_s[st][u], src, in);
          }
        }
        copy(ks + st * kTile, kg, c0, p.skv, std::integral_constant<int, BC>{});
        arrive(&k_full[st]);
        mbar_wait(&v_empty[st], empty_phase);
        copy(vs + st * kTile, vg, c0, p.skv, std::integral_constant<int, BC>{});
        arrive(&v_full[st]);
      }
    };
    if (p.d % 4 == 0)
      produce(std::integral_constant<int, 4>{});
    else if (p.d % 2 == 0)
      produce(std::integral_constant<int, 2>{});
    else
      produce(std::integral_constant<int, 1>{});
  } else if (tid < 128) {  // producer
    regs_dec<wg_producer_regs(NC, R)>();
    // the first thread (masked: the first warp, for the kv ids)
    if (tid == 0 || (M && tid < 32)) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_tx(&q_full, NC * kHalf);
        for (int hf = 0; hf < NC; ++hf)
          for (int cb = 0; cb < D / C; ++cb)
            tma_load_3d(qs + hf * kHalf + cb * 64 * W, &tm_q, &q_full, cb * C,
                        r0 + 64 * hf, bh);
      }
      int n = 0;  // tiles loaded
      for (int i = 0; i < tiles; ++i) {
        const int c0 = first + i * BC;
        if (!loaded(i)) continue;
        const int st = n % ST;
        const uint32_t empty_phase = ((n / ST) & 1) ^ 1;
        ++n;
        mbar_wait(&k_empty[st], empty_phase);
        if constexpr (M) {
          for (int u = lane; u < BC; u += 32)
            kid_s[st][u] = p.q_ids != nullptr && c0 + u < p.skv
                               ? p.kv_ids[(long long)b * p.skv + c0 + u] : 0;
        }
        if (lane == 0) {
          mbar_arrive_tx(&k_full[st], kTile);
          for (int cb = 0; cb < D / C; ++cb)
            tma_load_3d(ks + st * kTile + cb * BC * W, &tm_k, &k_full[st],
                        cb * C, c0, bh);
          mbar_wait(&v_empty[st], empty_phase);
          mbar_arrive_tx(&v_full[st], kTile);
          for (int cb = 0; cb < D / C; ++cb)
            tma_load_3d(vs + st * kTile + cb * BC * W, &tm_v, &v_full[st],
                        cb * C, c0, bh);
        } else {
          mbar_arrive(&k_full[st]);
        }
      }
    }
  } else {  // consumers
    regs_inc<wg_consumer_regs(NC)>();
    const int wg = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rw = r0 + 64 * wg;
    // a wait for a stage that wgmma reads: after the ragged producer's
    // generic-proxy writes, an async-proxy fence
    auto wait_tile = [](uint64_t* bar, uint32_t phase) {
      mbar_wait(bar, phase);
      if constexpr (R) fence_proxy_async();
    };
    const int ra = rw + warp * 16 + g, rb = ra + 8;
    const int2 ba = key_bounds(p, b, ra), bb = key_bounds(p, b, rb);
    // masked: the segment ids of rows ra and rb
    int qid_a = 0, qid_b = 0;
    if constexpr (M) {
      if (p.q_ids != nullptr) {
        qid_a = ra < p.sq ? p.q_ids[(long long)b * p.sq + ra] : 0;
        qid_b = rb < p.sq ? p.q_ids[(long long)b * p.sq + rb] : 0;
      }
    }
    int wlo, whi;
    kv_range(p, rw, 64, &wlo, &whi);
    whi = min(whi, lim_max[wg]);
    const unsigned char* qh = qs + wg * kHalf;
    // scores in the log2 domain are s sl2; with sl2 > 0 the row maxima are
    // taken on the raw scores and sl2 enters the exponent in one FMA (pre
    // = 1: no pass over the scores), else the scores are scaled first
    const float sl2 = p.scale * kLog2e;
    const bool fold = sl2 > 0.f;
    const float pre = fold ? 1.f : sl2, post = fold ? sl2 : 1.f;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    // P of the last computed tile, whose O += P V is issued with the next
    // tile's S (or when the loop ends, or before a skipped tile)
    uint32_t pa[BC / 16][4] = {};
    int held = -1;  // the V stage that P waits for, or -1
    uint32_t held_phase = 0;
    int n = 0;      // tiles loaded, as the producer counts them
    wait_tile(&q_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int c0 = first + i * BC;
      if (!loaded(i)) continue;
      const int st = n % ST;
      const uint32_t phase = (n / ST) & 1;
      ++n;
      const int cls = M ? tile_class(wg, i) : kFull;
      if (cls == kSkip || !(c0 + BC > wlo && c0 < whi)) {
        // no key of the tile is visible to this warpgroup's rows: retire
        // the held product first, since the producer may be waiting for
        // that stage before it can fill the ones this warpgroup skips
        if (held >= 0) {
          wait_tile(&v_full[held], held_phase);
          pv_product<D, BC, W, T>(acc, pa, vs + held * kTile);
          wg_wait<0>();
          wg_keep(acc);
          wg_keep(pa);
          release(&v_empty[held]);
          held = -1;
        }
        mbar_wait(&k_full[st], phase);
        release(&k_empty[st]);
        mbar_wait(&v_full[st], phase);
        release(&v_empty[st]);
        continue;
      }
      const unsigned char* kt = ks + st * kTile;
      float s[BC / 2];
      wait_tile(&k_full[st], phase);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BC, T>(s, desc_k<64, W>(qh, kk), desc_k<BC, W>(kt, kk),
                        kk > 0);
      wg_commit();
      const bool pending = held >= 0;
      if (pending) {
        wait_tile(&v_full[held], held_phase);
        pv_product<D, BC, W, T>(acc, pa, vs + held * kTile);
      }
      if (pending)
        wg_wait<1>();  // S (the previous tile's P V may still run)
      else
        wg_wait<0>();
      wg_keep(s);
      // the visibility: s pre, -inf where hidden
      if (cls == kFull && full_tile(p, rw, 64, c0, BC)) {
        if (!fold) {
#pragma unroll
          for (int i2 = 0; i2 < BC / 2; ++i2) s[i2] *= pre;
        }
      } else if (cls == kFull) {
#pragma unroll
        for (int i2 = 0; i2 < BC / 2; ++i2) {
          const int col = c0 + (i2 / 4) * 8 + 2 * t + (i2 & 1);
          const int2 kb2 = (i2 & 2) ? bb : ba;
          s[i2] = col >= kb2.x && col < kb2.y ? s[i2] * pre : -INFINITY;
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
          bool vis = col >= kb2.x && col < kb2.y &&
                     ((i2 & 2) ? qid_b : qid_a) == kid[cc];
          if (masked && vis) vis = mask_keeps(p, b, h, (i2 & 2) ? rb : ra, col);
          s[i2] = vis ? s[i2] * pre : -INFINITY;
        }
      }
      release(&k_empty[st]);  // K and its kv ids are read
      // the rows' maxima and sums in 4 partials each, short dependent chains
      float ma[4], mb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) ma[c] = mb[c] = -INFINITY;
#pragma unroll
      for (int i2 = 0; i2 < BC / 2; i2 += 4) {
        ma[(i2 / 4) % 4] = fmaxf(ma[(i2 / 4) % 4], fmaxf(s[i2], s[i2 + 1]));
        mb[(i2 / 4) % 4] = fmaxf(mb[(i2 / 4) % 4], fmaxf(s[i2 + 2], s[i2 + 3]));
      }
      // the new maxima in the log2 domain (post > 0 keeps the order)
      const float mn_a = fmaxf(
          m_a,
          quad_max(fmaxf(fmaxf(ma[0], ma[1]), fmaxf(ma[2], ma[3]))) * post);
      const float mn_b = fmaxf(
          m_b,
          quad_max(fmaxf(fmaxf(mb[0], mb[1]), fmaxf(mb[2], mb[3]))) * post);
      // a row with nothing visible so far keeps max -inf; exponentiate
      // against 0 there so that exp2(-inf) gives 0, never NaN
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = fast_exp2(m_a - mu_a), al_b = fast_exp2(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float ra4[4] = {}, rb4[4] = {};
#pragma unroll
      for (int i2 = 0; i2 < BC / 2; i2 += 4) {
        s[i2] = fast_exp2(fmaf(s[i2], post, -mu_a));
        s[i2 + 1] = fast_exp2(fmaf(s[i2 + 1], post, -mu_a));
        s[i2 + 2] = fast_exp2(fmaf(s[i2 + 2], post, -mu_b));
        s[i2 + 3] = fast_exp2(fmaf(s[i2 + 3], post, -mu_b));
        ra4[(i2 / 4) % 4] += s[i2] + s[i2 + 1];
        rb4[(i2 / 4) % 4] += s[i2 + 2] + s[i2 + 3];
      }
      const float rs_a = (ra4[0] + ra4[1]) + (ra4[2] + ra4[3]);
      const float rs_b = (rb4[0] + rb4[1]) + (rb4[2] + rb4[3]);
      if (pending) {
        wg_wait<0>();  // the previous tile's P V: O and P are free
        wg_keep(acc);
        wg_keep(pa);
        release(&v_empty[held]);
      }
      l_a = l_a * al_a + rs_a;
      l_b = l_b * al_b + rs_b;
#pragma unroll
      for (int i2 = 0; i2 < D / 2; i2 += 4) {
        acc[i2] *= al_a;
        acc[i2 + 1] *= al_a;
        acc[i2 + 2] *= al_b;
        acc[i2 + 3] *= al_b;
      }
      acc_to_a<BC, T>(pa, s);
      held = st;
      held_phase = phase;
    }
    if (held >= 0) {
      wait_tile(&v_full[held], held_phase);
      pv_product<D, BC, W, T>(acc, pa, vs + held * kTile);
      wg_wait<0>();
      wg_keep(acc);
      wg_keep(pa);
      release(&v_empty[held]);
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float ia = l_a == 0.f ? 0.f : 1.f / l_a;
    const float ib = l_b == 0.f ? 0.f : 1.f / l_b;
    const long long lbase = (long long)bh * p.sq;
    // pairs of columns by 4-byte stores; at an odd d by 2-byte stores,
    // the last column alone
    auto put = [&](long long i, int col, uint32_t pair) {
      if (!(p.d & 1)) {
        *reinterpret_cast<uint32_t*>(o + i) = pair;
      } else {
        unsigned short* os = reinterpret_cast<unsigned short*>(o + i);
        os[0] = pair & 0xffff;
        if (col + 1 < p.d) os[1] = pair >> 16;
      }
    };
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      const int col = nn * 8 + 2 * t;
      if (col >= p.d) break;
      if (ra < p.sq)
        put((lbase + ra) * p.d + col, col,
            pack2<T>(acc[4 * nn] * ia, acc[4 * nn + 1] * ia));
      if (rb < p.sq)
        put((lbase + rb) * p.d + col, col,
            pack2<T>(acc[4 * nn + 2] * ib, acc[4 * nn + 3] * ib));
    }
    if (t == 0) {
      if (ra < p.sq)
        lse[lbase + ra] = l_a == 0.f ? -INFINITY : (m_a + log2f(l_a)) * kLn2;
      if (rb < p.sq)
        lse[lbase + rb] = l_b == 0.f ? -INFINITY : (m_b + log2f(l_b)) * kLn2;
    }
  }
}

// d % 8 == 0: TMA maps; else the ragged producer's rows (no maps)
template <int D, typename T>
int launch_wg(const void* q, const void* k, const void* v, void* o,
              float* lse, const Problem& p, int bh, cudaStream_t stream) {
  const bool masked = p.tiles != nullptr, ragged = p.d % 8 != 0;
  const int bc = masked ? wg_kv_tile(D, true) : wg_kv_tile(D, false);
  CUtensorMap m[3] = {};
  Rows<T> rows{nullptr, nullptr, nullptr};
  if (ragged) {
    rows = {static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v)};
  } else {
    const int rc = tile_maps<T, D, 3>(m, {q, k, v}, {p.sq, p.skv, p.skv},
                                      {64, bc, bc}, bh, p.d);
    if (rc != 0) return rc;
  }
  constexpr int NC = wg_consumers(D);
  const dim3 grid(cdiv(p.sq, 64 * NC), bh);
  T* out = static_cast<T*>(o);
  auto go = [&](auto kernel, int smem) {
    return launch(kernel, grid, 128 * (NC + 1), smem, stream, m[0], m[1],
                  m[2], rows, out, lse, p);
  };
  if (masked)
    return ragged ? go(fwd_wg<D, T, true, true>, smem_wg<D, true>())
                  : go(fwd_wg<D, T, true, false>, smem_wg<D, true>());
  return ragged ? go(fwd_wg<D, T, false, true>, smem_wg<D, false>())
                : go(fwd_wg<D, T, false, false>, smem_wg<D, false>());
}

template <typename T>
int by_dim(int d, const void* q, const void* k, const void* v, void* o,
           float* lse, const Problem& p, int bh, cudaStream_t stream) {
  if (d <= 32) return launch_wg<32, T>(q, k, v, o, lse, p, bh, stream);
  if (d <= 64) return launch_wg<64, T>(q, k, v, o, lse, p, bh, stream);
  if (d <= 128) return launch_wg<128, T>(q, k, v, o, lse, p, bh, stream);
  if (d <= 192) return launch_wg<192, T>(q, k, v, o, lse, p, bh, stream);
  return launch_wg<256, T>(q, k, v, o, lse, p, bh, stream);
}

}  // namespace

namespace lamp_flash {

int wg_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, const Problem& p, int bh, cudaStream_t stream) {
  if (p.d > 256 || (dtype != 1 && dtype != 2)) return cudaErrorInvalidValue;
  return dtype == 1 ? by_dim<bf16>(p.d, q, k, v, o, lse, p, bh, stream)
                    : by_dim<f16>(p.d, q, k, v, o, lse, p, bh, stream);
}

}  // namespace lamp_flash
