// Flash attention backward for every head dim and float type: dq_any and
// dkv_any, the kernels of flash_attention.cu's backward entry points for
// the inputs its tensor-core kernels do not take (float32 and float64 at
// every head dim; bfloat16 and float16 above head dim 256).
//
// Replaces, with flash_attention.cu, the Pallas TPU kernels of
// lamp_tpu/ops/attention.py K2b _bwd_dq_kernel and K2c _bwd_dkv_kernel
// (and so K2a's and K3b's backward) for those inputs.
//
// The same function as the tensor-core kernels, with the visibility rules
// of flash_attention.cu's header (flash_common.cuh): double throughout for
// float64 (lse and di in double too), f32 accumulation for float32 and the
// 16-bit types; p rounded to do's type for dV and dS to q's type for dK and
// dQ; rows with no visible key give zero gradients. dq writes di =
// rowsum(o * do), which dkv reads. No atomics: each dQ row and each dK/dV
// key is owned by one block and summed in one fixed order, so two calls
// give the same bits.
//
// What bounds them: operations. At B=2, H=8, S=2048, D=100, causal, dq's 3
// and dkv's 4 products are 47 GFLOP, 701 us at the H100's 67 TFLOP/s
// (the FP64 tensor cores; the f32 FMA pipe's rate is the same number),
// against 52 MB of inputs and outputs (16 us at 3.35 TB/s).
//
// Design. A block is 8 warps (256 threads) that own 64 query rows (dq:
// Q and dO resident in shared memory) or 64 keys (dkv: K and V resident),
// loaded once, and walks tiles of BC keys (dq: K and V) or rows (dkv: Q
// and dO) staged by cp.async (16-byte copies where a row is a multiple of
// 16 bytes, else 8, 4, or 2-byte loads; never a padded copy): one buffer
// of 64 (float64 at D = 112: 32), or two of 16 (float64 at D = 128)
// (Layout). BC divides the class
// map's 64, so each tile has one class. The warps pair up: a pair owns 16
// rows (keys); its first warp computes S = Q K^T (dkv: S^T = K Q^T), the
// second dP = dO V^T (dP^T = V dO^T), so that neither holds both score
// tiles. Through shared memory each hands the other half of its tile, and
// each then finishes 8 rows: p = exp(s scale - lse) where visible, dS =
// p (dP - di) scale, both written back. Then dq's two warps each add dS K
// into half of the output columns, and dkv's first warp adds p^T dO into
// dV, its second dS^T Q into dK. The per-element visibility tests run
// only in tiles that the class map and the bounds do not show to be
// wholly visible.
//  - float64: every product is DMMA (mma.sync.m16n8k4 f64, the FP64
//    tensor cores: twice the FP64 FMA pipe's rate). A warp's S tile is 16
//    x BC, BC / 8 fragments of 16 x 8; a lane holds rows g, g + 8 and keys
//    8n + 2t, 8n + 2t + 1 (g = lane / 4, t = lane % 4). Staged rows are
//    padded by 4 doubles, so that the 8-byte fragment loads of a half-warp
//    (rows g, columns t; and for the output product's B, rows t, columns
//    g) fall on 16 different bank pairs.
//  - float32 and the 16-bit types: register-tiled FFMA. A lane holds 4
//    rows x 8 keys of its warp's score tile (ScoreFrag: the visibility and
//    exchange code serve both layouts) and reads 4 head-dim columns of a
//    row at once (a 16-byte load in f32): 12 loads a 128 multiply-adds; in
//    the output products a lane owns 4 rows x 4 adjacent columns of each
//    32-column group (OutCols). Rows are padded by 16 bytes. The products
//    stay in f32 (no TF32).
//  - head dims above 128 split the output columns over blockIdx.z in parts
//    of 128; each part walks the tiles once and, per tile, streams all of
//    the head dim through shared memory in 128-column chunks (its own part
//    last, which the output product then uses), so S and dP are computed
//    once per part: ceil(d / 128) times in all.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace lamp_flash;

constexpr int kBT = kAnyThreads;  // threads a block: 4 pairs of warps
constexpr int kBR = kAnyRows;     // rows (dq) or keys (dkv) a block owns

template <typename A>
__device__ __forceinline__ A warp_sum(A x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the block's tile shapes and shared-memory layout (bytes), for the host's
// launch and the kernel alike
template <typename T, int D, bool DKV>
struct Layout {
  using A = typename AccOf<T>::type;
  // the streamed tile's rows (dkv) or keys (dq), and its stages: 2, the
  // next tile loaded while this one is used, or 1, loaded after it.
  // One stage of 64 (float64 at D = 112: 32): twice the keys of two
  // stages in the same shared memory, 2-6% faster on an H100 than two
  // stages of half the keys, where the tiles' fixed costs outweigh the
  // exposed loads. float64 at D = 128 keeps two stages of 16: one of 32
  // does not fit (dkv: 240384 bytes), and one of 16 made dq 3.7% slower
  // on an H100 at B=2, H=8, S=2048, causal (dkv the same).
  static constexpr int BC =
      sizeof(T) == 8 ? (D > 112 ? 16 : D > 64 ? 32 : 64) : 64;
  static constexpr int NS = sizeof(T) == 8 && D > 112 ? 2 : 1;
  // a staged row's stride in elements: padded by 32 bytes for double, 16
  // for the rest; and the exchange rows' (p, dS) in A
  static constexpr int ST = D + (sizeof(T) == 8 ? 4 : 16 / sizeof(T));
  static constexpr int SX = BC + 4;
  static constexpr int kOwn = 2 * kBR * ST * sizeof(T);  // two resident tiles
  static constexpr int kStage = 2 * BC * ST * sizeof(T); // a stage: two tiles
  static constexpr int kX = (DKV ? 2 : 1) * kBR * SX * sizeof(A);  // p, dS
  // dkv, a stage's rows: lse, di (A; staged by cp.async) and the visible
  // keys [lo, hi) (int)
  static constexpr int kRows = DKV ? BC * (2 * sizeof(A) + 2 * sizeof(int)) : 0;
  static constexpr int kBytes = kOwn + NS * (kStage + kRows) + kX;
};

// The body of dq_any (DKV false) and dkv_any (DKV true) at instance D (32,
// 64 or 128: the head dim, or each part of a wider one). dq: out1 = dq, di
// written; dkv: out1 = dk, out2 = dv, di read, o unused.
template <typename T, int D, bool DKV>
__device__ __forceinline__ void bwd_any(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const typename AccOf<T>::type* __restrict__ lse,
    typename AccOf<T>::type* __restrict__ di, T* __restrict__ out1,
    T* __restrict__ out2, const Problem& p) {
  using A = typename AccOf<T>::type;
  using L = Layout<T, D, DKV>;
  using OC = OutCols<A, D, DKV>;
  using F = ScoreFrag<A, L::BC>;
  constexpr int BC = L::BC, ST = L::ST, SX = L::SX, RH = F::RH, KC = F::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* own = reinterpret_cast<T*>(smem_raw);                // [2][kBR][ST]
  T* stages = reinterpret_cast<T*>(smem_raw + L::kOwn);   // [NS][2][BC][ST]
  A* xs = reinterpret_cast<A*>(smem_raw + L::kOwn + L::NS * L::kStage);
  unsigned char* rows_raw = smem_raw + L::kOwn + L::NS * L::kStage + L::kX;
  __shared__ int lim_max;
  __shared__ A di_s[DKV ? 1 : kBR];

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int n_own = DKV ? p.skv : p.sq, n_str = DKV ? p.sq : p.skv;
  // dq's row blocks run last-first (long causal rows first), dkv's key
  // blocks first-first (key 0 sees the most rows)
  const int r0 = (DKV ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * kBR;
  const int parts = gridDim.z, part = blockIdx.z;
  const bool streamed = parts > 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pair = warp / 2, half = warp % 2;
  const int R = pair * 16;
  const long long qbase = (long long)bh * p.sq * p.d;
  const long long kbase = (long long)bh * p.skv * p.d;
  const long long lbase = (long long)bh * p.sq;
  const T* own1 = DKV ? k + kbase : q + qbase;
  const T* own2 = DKV ? v + kbase : dout + qbase;
  const T* str1 = DKV ? q + qbase : k + kbase;
  const T* str2 = DKV ? dout + qbase : v + kbase;
  const A scale = sizeof(A) == 8 ? A(p.scale64) : A(p.scale);

  // dq: di = rowsum(o * do) of the block's rows (warp w: rows 8w .. 8w +
  // 7), written once (by part 0) for dkv; the lane's rows' lse, di and key
  // bounds
  A lse_r[2][RH] = {}, di_r[2][RH] = {};
  int2 kb[2][RH] = {};
  int lo, hi;
  if constexpr (!DKV) {
    if (tid == 0) lim_max = 0;
    for (int i = 0; i < 8; ++i) {
      const int rr = warp * 8 + i, row = r0 + rr;
      A s = 0;
      if (row < p.sq)
        for (int c = lane; c < p.d; c += 32) {
          const long long idx = qbase + (long long)row * p.d + c;
          s = afma(to_acc(o[idx]), to_acc(dout[idx]), s);
        }
      s = warp_sum(s);
      if (lane == 0) {
        di_s[rr] = s;
        if (part == 0 && row < p.sq) di[lbase + row] = s;
      }
    }
    __syncthreads();
    if (tid < kBR) atomicMax(&lim_max, row_limit(p, b, r0 + tid));
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const int i = R + F::row(lane, m, r), row = r0 + i;
        lse_r[m][r] = row < p.sq ? lse[lbase + row] : A(0);
        di_r[m][r] = di_s[i];
        kb[m][r] = key_bounds(p, b, row);
      }
    kv_range(p, r0, kBR, &lo, &hi);
    hi = min(hi, lim_max);
  } else {
    q_range(p, r0, kBR, &lo, &hi);
  }

  // a streamed tile's class (one 64 x 64 block of the map holds it)
  auto class_of = [&](int c0) {
    return DKV ? span_class(p, b, h, c0 / kBlock, r0, kBR)
               : span_class(p, b, h, r0 / kBlock, c0, BC);
  };
  auto next_tile = [&](int c0) {
    while (c0 < hi && class_of(c0) == kSkip) c0 += BC;
    return c0;
  };
  auto load_own = [&](int ch) {
    load_rows<kBR, D, ST>(own, own1, r0, n_own, ch * D, p.d);
    load_rows<kBR, D, ST>(own + kBR * ST, own2, r0, n_own, ch * D, p.d);
  };
  // stage st: the two streamed tiles at c0, columns of chunk ch; dkv: and
  // (with_rows) the rows' lse, di and visible keys
  auto load_stage = [&](int st, int c0, int ch, bool with_rows) {
    T* s = stages + st * 2 * BC * ST;
    load_rows<BC, D, ST>(s, str1, c0, n_str, ch * D, p.d);
    load_rows<BC, D, ST>(s + BC * ST, str2, c0, n_str, ch * D, p.d);
    if constexpr (DKV) {
      if (with_rows && tid < BC) {
        A* ls = reinterpret_cast<A*>(rows_raw + st * L::kRows);
        int* bs = reinterpret_cast<int*>(ls + 2 * BC);
        const int row = c0 + tid;
        const bool in = row < p.sq;
        // by cp.async, so that no thread waits on them before the barrier
        cp_async_ca<sizeof(A)>(ls + tid, lse + (in ? lbase + row : 0), in);
        cp_async_ca<sizeof(A)>(ls + BC + tid, di + (in ? lbase + row : 0), in);
        const int2 kr = key_bounds(p, b, row);
        bs[tid] = kr.x;
        bs[BC + tid] = kr.y;
      }
    }
  };

  A acc[OC::RO][OC::NG][OC::E] = {};

  int c0 = next_tile((lo / BC) * BC), st = 0;
  if (!streamed) {
    load_own(0);
    if (c0 < hi) load_stage(0, c0, 0, true);
    cp_commit();
  }
  while (c0 < hi) {
    const int cn = next_tile(c0 + BC);
    // the first warp of a pair: S (dkv: S^T); the second: dP (dP^T)
    A sf[2][RH][KC][2] = {};
    for (int i = 0; i < parts; ++i) {
      const int ch = streamed ? (part + 1 + i) % parts : 0;
      if (streamed) {
        if (i > 0) __syncthreads();
        load_own(ch);
        load_stage(0, c0, ch, i == 0);
        cp_commit();
        cp_wait<0>();
      } else if constexpr (L::NS == 2) {
        if (cn < hi) load_stage(st ^ 1, cn, 0, true);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const T* s = stages + st * 2 * BC * ST;
      score_product<BC, ST>(sf, own + (half * kBR + R) * ST,
                            s + half * BC * ST, min(D, p.d - ch * D), lane);
    }

    const int cls = class_of(c0);
    const bool uniform =
        cls == kFull && (DKV ? full_tile(p, c0, BC, r0, kBR)
                             : full_tile(p, r0, kBR, c0, BC));
    const A* ls = reinterpret_cast<const A*>(rows_raw + st * L::kRows);
    const int* bs = reinterpret_cast<const int*>(ls + 2 * BC);
    A* xp = xs + R * SX;                            // p
    A* xd = xs + ((DKV ? kBR : 0) + R) * SX;        // dS (dq: in place of p)
    // Each warp of the pair finishes half of the rows: the first m = 0
    // (rows 0-7 of the pair's 16), the second m = 1. It hands the other
    // warp the scores of the other half through xp (the first warp S of m
    // = 1, the second dP of m = 0), and then holds both S and dP of its own.
#pragma unroll
    for (int r = 0; r < RH; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          xp[F::row(lane, 1 - half, r) * SX + F::key(lane, c, e)] =
              half == 0 ? sf[1][r][c][e] : sf[0][r][c][e];
    pair_sync(pair);
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const int i_own = R + F::row(lane, half, r);  // the row (dq) or key
      const A l_r = half == 0 ? lse_r[0][r] : lse_r[1][r];
      const A di_own = half == 0 ? di_r[0][r] : di_r[1][r];
      const int2 kb_r = half == 0 ? kb[0][r] : kb[1][r];
#pragma unroll
      for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = F::key(lane, c, e);  // the tile's row (dkv) or key
          A* xe = xp + (i_own - R) * SX + j;
          const A mine = half == 0 ? sf[0][r][c][e] : sf[1][r][c][e];
          const A other = *xe;
          const A sc = half == 0 ? mine : other;  // S (dkv: S^T)
          const A dp = half == 0 ? other : mine;  // dP (dP^T)
          bool vis = uniform;
          A l, d_i;
          if constexpr (DKV) {
            const int key = r0 + i_own, row = c0 + j;
            l = ls[j];
            d_i = ls[BC + j];
            if (!vis)
              vis = key >= bs[j] && key < bs[BC + j] &&
                    (cls == kFull || keep(p, b, h, row, key));
          } else {
            const int row = r0 + i_own, key = c0 + j;
            l = l_r;
            d_i = di_own;
            if (!vis)
              vis = key >= kb_r.x && key < kb_r.y &&
                    (cls == kFull || keep(p, b, h, row, key));
          }
          // p = exp(s scale - lse) where visible; dS = p (dP - di) scale
          const A pr = vis ? aexp(sc * scale - l) : A(0);
          const A ds = round_to<T>(pr * (dp - d_i) * scale);
          if constexpr (DKV) {
            *xe = pr;
            xd[(i_own - R) * SX + j] = ds;
          } else {
            *xe = ds;
          }
        }
    }
    pair_sync(pair);

    // dq: both warps, dQ += dS K into alternate column groups. dkv: the
    // first warp dV += p^T dO, the second dK += dS^T Q.
    const T* s = stages + st * 2 * BC * ST;
    if constexpr (DKV) {
      if (half == 0)
        out_product<T, D, BC, ST, SX, DKV, true>(acc, xp, s + BC * ST, half,
                                                 lane);
      else
        out_product<T, D, BC, ST, SX, DKV, false>(acc, xd, s, half, lane);
    } else {
      out_product<T, D, BC, ST, SX, DKV, false>(acc, xd, s, half, lane);
    }
    __syncthreads();
    if (!streamed) {
      if constexpr (L::NS == 2) {
        st ^= 1;
      } else if (cn < hi) {
        load_stage(0, cn, 0, true);
        cp_commit();
      }
    }
    c0 = cn;
  }
  cp_wait<0>();

  // dq: out1 = dQ; dkv: the first warp's dV into out2, the second's dK
  // into out1
  T* out = DKV ? (half == 0 ? out2 : out1) + kbase : out1 + qbase;
#pragma unroll
  for (int i = 0; i < OC::RO; ++i) {
    const int row = r0 + R + OC::row(lane, i, half);
    if (row >= n_own) continue;
#pragma unroll
    for (int j = 0; j < OC::NG; ++j)
#pragma unroll
      for (int e = 0; e < OC::E; ++e) {
        const int col = part * D + OC::col(lane, j, half, e);
        if (col < p.d) out[(long long)row * p.d + col] = from_acc<T>(acc[i][j][e]);
      }
  }
}

// float64 and the wide instances fill an SM with one block; the f32
// instances up to D = 64 take two
template <typename T, int D>
__host__ __device__ constexpr int blocks_per_sm() {
  return sizeof(T) == 4 && D <= 64 ? 2 : 1;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBT, blocks_per_sm<T, D>())
dq_any(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ o,
       const T* __restrict__ dout,
       const typename AccOf<T>::type* __restrict__ lse,
       typename AccOf<T>::type* __restrict__ di, T* __restrict__ dq,
       Problem p) {
  bwd_any<T, D, false>(q, k, v, o, dout, lse, di, dq, nullptr, p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBT, blocks_per_sm<T, D>())
dkv_any(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const typename AccOf<T>::type* __restrict__ lse,
        const typename AccOf<T>::type* __restrict__ di, T* __restrict__ dk,
        T* __restrict__ dv, Problem p) {
  bwd_any<T, D, true>(q, k, v, nullptr, dout, lse,
                      const_cast<typename AccOf<T>::type*>(di), dk, dv, p);
}

}  // namespace

namespace lamp_flash {

int any_dq(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const void* lse, void* di,
           void* dq, const Problem& p, int bh, cudaStream_t stream) {
  return any_dispatch(dtype, p.d, [&](auto t, auto dim) -> int {
    using T = decltype(t);
    using A = typename AccOf<T>::type;
    constexpr int D = decltype(dim)::value;
    return launch(dq_any<T, D>, dim3(cdiv(p.sq, kBR), bh, cdiv(p.d, D)), kBT,
                  Layout<T, D, false>::kBytes, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(o),
                  static_cast<const T*>(dout), static_cast<const A*>(lse),
                  static_cast<A*>(di), static_cast<T*>(dq), p);
  });
}

int any_dkv(int dtype, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* di, void* dk,
            void* dv, const Problem& p, int bh, cudaStream_t stream) {
  return any_dispatch(dtype, p.d, [&](auto t, auto dim) -> int {
    using T = decltype(t);
    using A = typename AccOf<T>::type;
    constexpr int D = decltype(dim)::value;
    return launch(dkv_any<T, D>, dim3(cdiv(p.skv, kBR), bh, cdiv(p.d, D)),
                  kBT, Layout<T, D, true>::kBytes, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const A*>(lse), static_cast<const A*>(di),
                  static_cast<T*>(dk), static_cast<T*>(dv), p);
  });
}

}  // namespace lamp_flash
