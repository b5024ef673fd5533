// Flash attention forward for every head dim and float type: fwd_any, the
// kernel of flash_attention.cu's forward entry point for the inputs its
// tensor-core kernels do not take (float32 and float64 at every head dim;
// bfloat16 and float16 above head dim 256). The backward's kernels for the
// same inputs, dq_any and dkv_any, are flash_backward_any.cu's.
//
// Replaces, with flash_attention.cu and flash_forward.cu, the Pallas TPU
// kernel of lamp_tpu/ops/attention.py K1 _fwd_kernel (:87; and so K3a) for
// those inputs.
//
// The same function as the tensor-core kernels, with the visibility rules
// of flash_attention.cu's header (flash_common.cuh): scores and softmax in
// f32 for float32 and the 16-bit types, double throughout for float64 (lse
// in double too; the JAX kernel's dots ask for f32 results even there); p
// rounded to v's type for P V; rows with no visible key give o = 0 and lse
// = -inf. No atomics on the output: each row is owned by one block and
// summed in one fixed order, so two calls give the same bits.
//
// What bounds it: operations. At B=2, H=8, S=2048, D=100, causal, the two
// products are 13.4 GFLOP, 200 us at the H100's 67 TFLOP/s (the FP64
// tensor cores; the f32 FMA pipe's rate is the same number), against 21 MB
// of inputs and outputs in f64 (6 us at 3.35 TB/s).
//
// Design. A block is 8 warps (256 threads) that own 64 query rows, one row
// of the class map: Q is loaded once into shared memory (load_rows: 16-,
// 8-, 4-byte cp.async or 2-byte loads, never a padded copy) and stays
// there; K and V stream through shared memory in tiles of BC keys (BC
// divides 64, so each tile has one class) in two stages: one block barrier
// a tile, after which the next tile's K and V load under this one's
// products (FwdLayout). The warps pair up: a pair owns 16 rows, and each warp of it
// computes S = Q K^T for half of the tile's keys. The pair combines the
// rows' maxima through shared memory, each warp writes its p, rounded to
// v's type, there, and each then adds P V over the whole tile into half of
// the output columns (flash_backward_any.cu's dq layout), so no score is
// computed twice and the output registers are split between the two. The
// per-element visibility tests run only in tiles that the class map and
// the bounds do not show to be wholly visible.
//  - float64: every product is DMMA (mma.sync.m16n8k4 f64, the FP64 tensor
//    cores: twice the FP64 FMA pipe's rate; dmma16), on rows padded by 4
//    doubles, so that the fragment loads fall on different banks.
//  - float32 and the 16-bit types: register-tiled FFMA in f32 (ScoreFrag,
//    OutCols), reading 16 bytes of a staged f32 row at once. The products
//    stay f32 (no TF32). The exponentials are exp2f, the scale folded into
//    the log2 e factor; float64's are exp.
//  - head dims above 128 split the output columns over blockIdx.z in parts
//    of 128; each part walks the tiles once and, per tile, streams Q and K
//    through shared memory in 128-column chunks (its own part last, with V
//    of its columns), so S is computed ceil(d / 128) times in all.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace lamp_flash;

// the block's tile shapes and shared-memory layout (bytes), for the host's
// launch and the kernel alike: Q resident, two stages of a K and a V tile
// of BC keys (the next tile loaded while this one is used), and the pairs'
// p rows (A)
template <typename T, int D>
struct FwdLayout {
  using A = typename AccOf<T>::type;
  // float64 above D = 64 takes tiles of 32 keys: two stages of 64 at D =
  // 128 need 237568 bytes, above the 232448 a block may have. Tiles of 128
  // keys in f32 (4 x 8 scores a lane, one block an SM) were 10% faster at
  // B=2, H=8, S=2048, D=64 on an H100 but 5% slower at the f32 flagship's
  // B=8, H=12, S=384 (scripts/exp_fwd_any_variants.py)
  static constexpr int BC = sizeof(T) == 8 && D > 64 ? 32 : 64;
  // a staged row's stride in elements: padded by 32 bytes for double, 16
  // for the rest; and the p rows' in A
  static constexpr int ST = D + (sizeof(T) == 8 ? 4 : 16 / sizeof(T));
  static constexpr int SX = BC + 4;
  static constexpr int kQ = kAnyRows * ST * sizeof(T);
  static constexpr int kStage = 2 * BC * ST * sizeof(T);
  static constexpr int kX = kAnyRows * SX * sizeof(A);
  static constexpr int kBytes = kQ + 2 * kStage + kX;
};

// float32 up to D = 64 fits two blocks an SM (104448 bytes of dynamic
// shared memory each at D = 64; one block an SM was 6.5% slower at the f32
// flagship's shape on an H100); the rest one
template <typename T, int D>
__host__ __device__ constexpr int fwd_blocks_per_sm() {
  return sizeof(T) == 4 && D <= 64 ? 2 : 1;
}

// the forward's exponential: 2^x in f32 (scores carry the factor log2 e),
// e^x in double; and lse = m + log(l) in natural units from the running max
// m and sum l
__device__ __forceinline__ float fexp(float x) { return exp2f(x); }
__device__ __forceinline__ double fexp(double x) { return exp(x); }
__device__ __forceinline__ float flse(float m, float l) {
  return (m + log2f(l)) * kLn2;
}
__device__ __forceinline__ double flse(double m, double l) {
  return m + log(l);
}

__device__ __forceinline__ float amax(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double amax(double x, double y) { return fmax(x, y); }

// over the lanes of a warp that hold the same score rows (ScoreFrag: lanes
// 4g .. 4g + 3 in DMMA's layout, 8q .. 8q + 7 in FFMA's)
template <typename A>
__device__ __forceinline__ A rows_max(A x) {
  constexpr int kLanes = sizeof(A) == 8 ? 4 : 8;
#pragma unroll
  for (int o = 1; o < kLanes; o *= 2)
    x = amax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <typename A>
__device__ __forceinline__ A rows_sum(A x) {
  constexpr int kLanes = sizeof(A) == 8 ? 4 : 8;
#pragma unroll
  for (int o = 1; o < kLanes; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// x at output row i of warp `half` (OutCols's rows) from a statistic held
// at ScoreFrag's rows [m][r]: the same rows, in another order
template <typename A, int D, int RH>
__device__ __forceinline__ A at_out_row(const A (&x)[2][RH], int i,
                                        int half) {
  using OC = OutCols<A, D, false>;
  if constexpr (sizeof(A) == 8) return x[i][0];  // rows g + 8i
  else if constexpr (OC::kRowSplit) return half == 0 ? x[0][i] : x[1][i];
  else return x[i / 2][i % 2];                   // rows q + 4i
}

template <typename T, int D>
__global__ void __launch_bounds__(kAnyThreads, fwd_blocks_per_sm<T, D>())
fwd_any(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o,
        typename AccOf<T>::type* __restrict__ lse, Problem p) {
  using A = typename AccOf<T>::type;
  using L = FwdLayout<T, D>;
  constexpr int BC = L::BC, BH = BC / 2, ST = L::ST, SX = L::SX;
  using F = ScoreFrag<A, BH>;  // a warp's half of the tile's keys
  using OC = OutCols<A, D, false>;
  constexpr int RH = F::RH, KC = F::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);                    // [64][ST]
  T* stages = reinterpret_cast<T*>(smem_raw + L::kQ);        // [2][2][BC][ST]
  A* xs = reinterpret_cast<A*>(smem_raw + L::kQ + 2 * L::kStage);
  __shared__ int lim_max;
  __shared__ A red[4][2][16];  // a pair's rows' maxima (sums), by warp

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  // row blocks run last-first: long causal rows first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kAnyRows;
  const int parts = gridDim.z, part = blockIdx.z;
  const bool streamed = parts > 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pair = warp / 2, half = warp % 2;
  const int R = pair * 16;
  const long long qbase = (long long)bh * p.sq * p.d;
  const long long kbase = (long long)bh * p.skv * p.d;
  // scores in the exponential's units: log2 in f32, natural in double
  const A sl = sizeof(A) == 8 ? A(p.scale64) : A(p.scale * kLog2e);
  // the lanes that hold a row's first keys write its statistics
  const bool writer = F::kbase(lane) == 0;

  if (tid == 0) lim_max = 0;
  __syncthreads();
  if (tid < kAnyRows) atomicMax(&lim_max, row_limit(p, b, r0 + tid));
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, kAnyRows, &lo, &hi);
  hi = min(hi, lim_max);

  // the lane's rows: their visible keys, running max and (the lane's
  // share of the) sum
  int2 kb[2][RH];
  A mr[2][RH], lr[2][RH];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      kb[m][r] = key_bounds(p, b, r0 + R + F::row(lane, m, r));
      mr[m][r] = -INFINITY;
      lr[m][r] = 0;
    }

  auto class_of = [&](int c0) {
    return span_class(p, b, h, r0 / kBlock, c0, BC);
  };
  auto next_tile = [&](int c0) {
    while (c0 < hi && class_of(c0) == kSkip) c0 += BC;
    return c0;
  };
  // stage st: K (and, with_v, V) of the tile at c0, columns of chunk ch
  auto load_stage = [&](int st, int c0, int ch, bool with_v) {
    T* s = stages + st * 2 * BC * ST;
    load_rows<BC, D, ST>(s, k + kbase, c0, p.skv, ch * D, p.d);
    if (with_v) load_rows<BC, D, ST>(s + BC * ST, v + kbase, c0, p.skv, ch * D, p.d);
  };

  A acc[OC::RO][OC::NG][OC::E] = {};

  int c0 = next_tile((lo / BC) * BC), st = 0;
  if (!streamed) {
    load_rows<kAnyRows, D, ST>(qs, q + qbase, r0, p.sq, 0, p.d);
    if (c0 < hi) load_stage(0, c0, 0, true);
    cp_commit();
  }
  while (c0 < hi) {
    const int cn = next_tile(c0 + BC), cur = st;  // cur: this tile's stage
    A sf[2][RH][KC][2] = {};
    for (int i = 0; i < parts; ++i) {
      const int ch = streamed ? (part + 1 + i) % parts : 0;
      if (streamed) {
        // each chunk of Q and K in turn through stage 0, the part's own
        // last (with V of the part's columns)
        __syncthreads();
        load_rows<kAnyRows, D, ST>(qs, q + qbase, r0, p.sq, ch * D, p.d);
        load_stage(0, c0, ch, i == parts - 1);
        cp_commit();
      }
      cp_wait<0>();
      __syncthreads();
      // this tile's stage is in, and every warp is past the last tile,
      // whose stage now takes the next one
      if (!streamed) {
        st ^= 1;
        if (cn < hi) load_stage(st, cn, 0, true);
        cp_commit();
      }
      score_product<BH, ST>(sf, qs + R * ST,
                            stages + (cur * 2 * BC + half * BH) * ST,
                            min(D, p.d - ch * D), lane);
    }

    // visibility, then the rows' maxima over the warp's keys
    const int cls = class_of(c0);
    const bool uniform = cls == kFull && full_tile(p, r0, kAnyRows, c0, BC);
    A* xp = xs + R * SX;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const int row = r0 + R + F::row(lane, m, r);
        A mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = c0 + half * BH + F::key(lane, c, e);
            const bool vis =
                uniform || (key >= kb[m][r].x && key < kb[m][r].y &&
                            (cls == kFull || keep(p, b, h, row, key)));
            sf[m][r][c][e] = vis ? sf[m][r][c][e] * sl : A(-INFINITY);
            mx = amax(mx, sf[m][r][c][e]);
          }
        mx = rows_max(mx);
        if (writer) red[pair][half][F::row(lane, m, r)] = mx;
      }
    pair_sync(pair);
    // the new maxima over both halves; p = e^(s - max) (2^ in f32) into
    // the pair's p rows, rounded to v's type; the accumulators rescaled
    A alpha[2][RH];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const int i = F::row(lane, m, r);
        const A mn = amax(mr[m][r], amax(red[pair][0][i], red[pair][1][i]));
        // a row with nothing visible so far keeps max -inf: exponentiate
        // against 0 there, so that e^-inf gives 0, never NaN
        const A mu = mn == A(-INFINITY) ? A(0) : mn;
        alpha[m][r] = fexp(mr[m][r] - mu);
        mr[m][r] = mn;
        A sum = 0;
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const A pr = fexp(sf[m][r][c][e] - mu);
            sum += pr;
            xp[i * SX + half * BH + F::key(lane, c, e)] = round_to<T>(pr);
          }
        lr[m][r] = lr[m][r] * alpha[m][r] + sum;
      }
#pragma unroll
    for (int i = 0; i < OC::RO; ++i) {
      const A a = at_out_row<A, D>(alpha, i, half);
#pragma unroll
      for (int j = 0; j < OC::NG; ++j)
#pragma unroll
        for (int e = 0; e < OC::E; ++e) acc[i][j][e] *= a;
    }
    pair_sync(pair);

    // o += P V into the warp's half of the output columns
    out_product<T, D, BC, ST, SX, false, false>(
        acc, xp, stages + (cur * 2 + 1) * BC * ST, half, lane);
    c0 = cn;
  }
  cp_wait<0>();

  // the rows' sums: over the lanes that share a row, then the pair's halves
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const A s = rows_sum(lr[m][r]);
      if (writer) red[pair][half][F::row(lane, m, r)] = s;
    }
  pair_sync(pair);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const int i = F::row(lane, m, r);
      lr[m][r] = red[pair][0][i] + red[pair][1][i];
    }

  T* out = o + qbase;
#pragma unroll
  for (int i = 0; i < OC::RO; ++i) {
    const int row = r0 + R + OC::row(lane, i, half);
    if (row >= p.sq) continue;
    const A l = at_out_row<A, D>(lr, i, half);
#pragma unroll
    for (int j = 0; j < OC::NG; ++j)
#pragma unroll
      for (int e = 0; e < OC::E; ++e) {
        const int col = part * D + OC::col(lane, j, half, e);
        if (col < p.d)
          out[(long long)row * p.d + col] =
              from_acc<T>(l == A(0) ? A(0) : acc[i][j][e] / l);
      }
  }
  if (part == 0 && half == 0 && writer) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const int row = r0 + R + F::row(lane, m, r);
        if (row < p.sq)
          lse[(long long)bh * p.sq + row] =
              lr[m][r] == A(0) ? A(-INFINITY) : flse(mr[m][r], lr[m][r]);
      }
  }
}

}  // namespace

namespace lamp_flash {

int any_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
            void* lse, const Problem& p, int bh, cudaStream_t stream) {
  return any_dispatch(dtype, p.d, [&](auto t, auto dim) -> int {
    using T = decltype(t);
    using A = typename AccOf<T>::type;
    constexpr int D = decltype(dim)::value;
    return launch(fwd_any<T, D>, dim3(cdiv(p.sq, kAnyRows), bh, cdiv(p.d, D)),
                  kAnyThreads, FwdLayout<T, D>::kBytes, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o),
                  static_cast<A*>(lse), p);
  });
}

}  // namespace lamp_flash
