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

constexpr int kBT = 256;     // threads a block: 4 pairs of warps
constexpr int kBR = 64;      // rows (dq) or keys (dkv) a block owns
constexpr int kWideD = 128;  // the widest instance; wider head dims split

// the accumulator type: double for float64, else f32
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

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

// rows [r0, r0 + ROWS) and columns [c0, c0 + D) of a [n, d] matrix into a
// staged tile (row stride ST) by cp.async of V bytes; rows past n and
// columns past d are zero-filled. V divides d's row bytes and c0's.
template <int V, int ROWS, int D, int ST, typename T>
__device__ __forceinline__ void copy_rows(T* s, const T* g, int r0, int n,
                                          int c0, int d) {
  constexpr int E = V / sizeof(T), kPer = D / E;
  for (int i = threadIdx.x; i < ROWS * kPer; i += kBT) {
    const int r = i / kPer, c = (i % kPer) * E;
    const bool in = r0 + r < n && c0 + c < d;
    const T* src = g + (in ? (long long)(r0 + r) * d + c0 + c : 0);
    if constexpr (V == 16) cp_async16(s + r * ST + c, src, in);
    else cp_async_ca<V>(s + r * ST + c, src, in);
  }
}

// copy_rows with the widest copy the rows' alignment allows: 16, 8 or 4
// bytes; a 16-bit type at an odd head dim is loaded 2 bytes at a time by
// plain loads (the stage written is not read before the next barrier)
template <int ROWS, int D, int ST, typename T>
__device__ __forceinline__ void load_rows(T* s, const T* g, int r0, int n,
                                          int c0, int d) {
  const int bytes = d * (int)sizeof(T);
  if (bytes % 16 == 0) {
    copy_rows<16, ROWS, D, ST>(s, g, r0, n, c0, d);
  } else if (bytes % 8 == 0) {
    copy_rows<8, ROWS, D, ST>(s, g, r0, n, c0, d);
  } else if constexpr (sizeof(T) <= 4) {
    if (bytes % 4 == 0) {
      copy_rows<4, ROWS, D, ST>(s, g, r0, n, c0, d);
    } else {
      const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
      unsigned short* ss = reinterpret_cast<unsigned short*>(s);
      for (int i = threadIdx.x; i < ROWS * D; i += kBT) {
        const int r = i / D, c = i % D;
        const bool in = r0 + r < n && c0 + c < d;
        ss[r * ST + c] = in ? gs[(long long)(r0 + r) * d + c0 + c] : 0;
      }
    }
  }
}

// four adjacent elements of a staged row as f32 (a 16-byte load in f32,
// 8 bytes for the 16-bit types)
__device__ __forceinline__ void load4(float (&x)[4], const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load4(float (&x)[4], const T* s) {
  const uint2 v = *reinterpret_cast<const uint2*>(s);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = to_acc(e[i]);
}

// c += a b on the FP64 tensor cores, a 16 x 4 (row), b 4 x 8 (col), c 16
// x 8: lane (g, t) holds c0, c1 at row g, columns 2t, 2t + 1 and c2, c3 at
// row g + 8; a0 = A[g][t], a1 = A[g + 8][t]; b = B[t][g]. m16n8k4 is a
// shape sm_90 added: two m8n8k4 (sm_80's) on the same fragments give the
// same bits in 1.4x the time on an H100 (both kernels, float64 at D = 64
// and 100; scripts/exp_any_variants.py).
__device__ __forceinline__ void dmma16(double& c0, double& c1, double& c2,
                                       double& c3, double a0, double a1,
                                       double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a0), "d"(a1), "d"(b));
}

// A lane's share of its warp's 16 x BC score tile: RH rows of each 8-row
// half m, at rows rbase + 8m + 4r (r < RH), and 2 KC keys, at key(c, e) =
// KS c + KE e + kbase (c < KC, e < 2). DMMA's accumulator fixes it for
// float64: rows g + 8m and keys 8c + 2t + e (g = lane / 4, t = lane % 4).
// FFMA takes 4 rows x 8 keys: rows q + 4 (2m + r) and keys 16c + 8e + u
// (q = lane / 8, u = lane % 8), so that a 4-column step loads 4 + 8 rows
// for 128 multiply-adds (2 + 16 for 128 in DMMA's layout) and the 8 lanes
// of a 16-byte load phase read 8 different rows of the padded tile.
template <typename A, int BC>
struct ScoreFrag {
  static constexpr bool kMma = sizeof(A) == 8;
  static constexpr int RH = kMma ? 1 : 2;
  static constexpr int KC = kMma ? BC / 8 : BC / 16;
  static constexpr int KS = kMma ? 8 : 16;
  static constexpr int KE = kMma ? 1 : 8;
  __device__ __forceinline__ static int rbase(int lane) {
    return kMma ? lane / 4 : lane / 8;
  }
  __device__ __forceinline__ static int kbase(int lane) {
    return kMma ? 2 * (lane % 4) : lane % 8;
  }
  __device__ __forceinline__ static int row(int lane, int m, int r) {
    return rbase(lane) + 8 * m + 4 * r;
  }
  __device__ __forceinline__ static int key(int lane, int c, int e) {
    return KS * c + KE * e + kbase(lane);
  }
};

// A warp's score tile, 16 x BC: sf[m][r][c][e] += sum_k a[row][k] *
// b[key][k] over k < kend (columns past kend up to the next multiple of 4
// are staged zeros), at ScoreFrag's rows and keys; a and b staged with row
// stride ST.
template <int BC, int ST>
__device__ __forceinline__ void score_product(double (&sf)[2][1][BC / 8][2],
                                              const double* a,
                                              const double* b, int kend,
                                              int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll 2
  for (int k0 = 0; k0 < kend; k0 += 4) {
    const double a0 = a[g * ST + k0 + t], a1 = a[(g + 8) * ST + k0 + t];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
      // the fragment's B[k][n] = b[n][k]: lane (g, t) holds b[8n + g][k0 + t]
      const double bb = b[(8 * n + g) * ST + k0 + t];
      dmma16(sf[0][0][n][0], sf[0][0][n][1], sf[1][0][n][0], sf[1][0][n][1],
             a0, a1, bb);
    }
  }
}
template <int BC, int ST, typename T>
__device__ __forceinline__ void score_product(float (&sf)[2][2][BC / 16][2],
                                              const T* a, const T* b,
                                              int kend, int lane) {
  using F = ScoreFrag<float, BC>;
#pragma unroll 2
  for (int k0 = 0; k0 < kend; k0 += 4) {
    float av[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) load4(av[m][r], a + F::row(lane, m, r) * ST + k0);
#pragma unroll
    for (int c = 0; c < F::KC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float bb[4];
        load4(bb, b + F::key(lane, c, e) * ST + k0);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              sf[m][r][c][e] = fmaf(av[m][r][k], bb[k], sf[m][r][c][e]);
      }
  }
}

// A lane's share of its warp's output rows and columns: RO rows at
// row(i, half) and NG groups of E adjacent columns, group j's at col(j, e).
// DMMA's accumulator fixes it for float64: rows g + 8i, columns 8 group +
// 2t + e of 8-column groups. FFMA takes rows q + 4i and columns 32 group
// + 4u + e (q = lane / 8, u = lane % 8): a 4-key step loads 4 + 4 NG rows
// for 64 NG multiply-adds. dkv's warps each take every group (one of dK,
// dV); dq's two split them: alternate groups, or at D = 32 (one FFMA
// group) the pair's rows, each warp its own 8.
template <typename A, int D, bool DKV>
struct OutCols {
  static constexpr bool kMma = sizeof(A) == 8;
  static constexpr int GW = kMma ? 8 : 32;      // columns of a group
  static constexpr bool kRowSplit = !kMma && !DKV && D == GW;
  static constexpr int RO = kMma ? 2 : kRowSplit ? 2 : 4;
  static constexpr int NG = DKV || kRowSplit ? D / GW : D / (2 * GW);
  static constexpr int E = kMma ? 2 : 4;
  __device__ __forceinline__ static int group(int j, int half) {
    return DKV || kRowSplit ? j : 2 * j + half;
  }
  __device__ __forceinline__ static int row(int lane, int i, int half) {
    if constexpr (kMma) return lane / 4 + 8 * i;
    else return lane / 8 + 4 * i + (kRowSplit ? 8 * half : 0);
  }
  __device__ __forceinline__ static int col(int lane, int j, int half, int e) {
    if constexpr (kMma) return GW * group(j, half) + 2 * (lane % 4) + e;
    else return GW * group(j, half) + 4 * (lane % 8) + e;
  }
};

// acc[i][j] += x[row i][:] . b[:][columns of group j] over the BC rows of
// b (x: a pair's exchange rows, row stride SX; b staged, row stride ST).
// Every group runs: columns past d are staged zeros (a test of the group
// against d inside the unrolled loop kept ptxas from hoisting the loads:
// f32 at D=100 took 1.3x as long). RP: x is p, rounded to T here.
template <typename T, int D, int BC, int ST, int SX, bool DKV, bool RP>
__device__ __forceinline__ void out_product(double (&acc)[2][OutCols<double, D, DKV>::NG][2],
                                            const double* x, const T* b,
                                            int half, int lane) {
  using OC = OutCols<double, D, DKV>;
  const int g = lane / 4, t = lane % 4;
#pragma unroll 2
  for (int k0 = 0; k0 < BC; k0 += 4) {
    const double a0 = x[g * SX + k0 + t], a1 = x[(g + 8) * SX + k0 + t];
#pragma unroll
    for (int i = 0; i < OC::NG; ++i) {
      // B[k][n] = b[k0 + k][8j + n]: lane (g, t) holds b[k0 + t][8j + g]
      const double bb = b[(k0 + t) * ST + 8 * OC::group(i, half) + g];
      dmma16(acc[0][i][0], acc[0][i][1], acc[1][i][0], acc[1][i][1], a0, a1,
             bb);
    }
  }
}
template <typename T, int D, int BC, int ST, int SX, bool DKV, bool RP>
__device__ __forceinline__ void out_product(
    float (&acc)[OutCols<float, D, DKV>::RO][OutCols<float, D, DKV>::NG][4],
    const float* x, const T* b, int half, int lane) {
  using OC = OutCols<float, D, DKV>;
#pragma unroll 2
  for (int k0 = 0; k0 < BC; k0 += 4) {
    float av[OC::RO][4];
#pragma unroll
    for (int i = 0; i < OC::RO; ++i) {
      load4(av[i], x + OC::row(lane, i, half) * SX + k0);
      if constexpr (RP) {
#pragma unroll
        for (int k = 0; k < 4; ++k) av[i][k] = round_to<T>(av[i][k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < OC::NG; ++j) {
        float bb[4];
        load4(bb, b + (k0 + k) * ST + OC::col(lane, j, half, 0));
#pragma unroll
        for (int i = 0; i < OC::RO; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] = fmaf(av[i][k], bb[e], acc[i][j][e]);
      }
    }
  }
}

// rows sync of a pair of warps (named barriers 1-4; 0 is __syncthreads)
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

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

template <int N>
using Dim = std::integral_constant<int, N>;

// calls f(T{}, Dim<D>{}) for the dtype code and head dim: D = 32, 64, 112
// (float64 only: f32's dq halves take multiples of 32) or 128 (and 128 for
// every wider d, split over blockIdx.z); the 16-bit types come here only
// above 256 and have the D = 128 instance alone
template <typename F>
int by_type(int dtype, int d, F f) {
  auto by_dim = [&](auto t) -> int {
    if constexpr (sizeof(t) == 2) {
      return f(t, Dim<kWideD>{});
    } else {
      if (d <= 32) return f(t, Dim<32>{});
      if (d <= 64) return f(t, Dim<64>{});
      if constexpr (sizeof(t) == 8) {
        if (d <= 112) return f(t, Dim<112>{});
      }
      return f(t, Dim<kWideD>{});
    }
  };
  switch (dtype) {
    case 0: return by_dim(float{});
    case 1: return by_dim(__nv_bfloat16{});
    case 2: return by_dim(__half{});
    case 3: return by_dim(double{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

namespace lamp_flash {

int any_dq(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const void* lse, void* di,
           void* dq, const Problem& p, int bh, cudaStream_t stream) {
  return by_type(dtype, p.d, [&](auto t, auto dim) -> int {
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
  return by_type(dtype, p.d, [&](auto t, auto dim) -> int {
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
