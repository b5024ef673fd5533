// What the flash-attention kernels share (flash_attention.cu: the
// backward's tensor-core kernels and the entry points;
// flash_forward.cu: the wgmma forward; flash_backward_wide.cu: the wgmma
// backward above head dim 128; flash_forward_any.cu and
// flash_backward_any.cu: the FP64-tensor-core / FFMA forward and backward
// for every head dim and float type): the problem's shape, the visibility
// rules of flash_attention.cu's header note, the launch helper, what the
// scalar kernels share (their block shape, staging and fragment layouts)
// and what the wgmma kernels share (their block shape, TMA maps, exp2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace lamp_flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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
  float scale;                 // sm_scale, for the f32 arithmetic
  double scale64;              // and for float64's
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// cp.async of 16 bytes (.cg) and of 8 or 4 bytes (.ca), zero-filled
// when not valid (hopper.cuh)
using hopper::cp_async16;
using hopper::cp_async_ca;
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the scalar kernels' arithmetic type A: f32, double for float64. T's
// values as A, A's rounded to T, and A's fma and exp.
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }

template <typename T, typename A>
__device__ __forceinline__ T from_acc(A x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return __float2bfloat16(x);
  else if constexpr (std::is_same<T, __half>::value) return __float2half(x);
  else return static_cast<T>(x);
}

// x rounded to T, as an accumulator value
template <typename T, typename A>
__device__ __forceinline__ A round_to(A x) {
  if constexpr (std::is_same<T, A>::value) return x;
  else return to_acc(from_acc<T>(x));
}

__device__ __forceinline__ float afma(float x, float y, float z) { return fmaf(x, y, z); }
__device__ __forceinline__ double afma(double x, double y, double z) { return fma(x, y, z); }
__device__ __forceinline__ float aexp(float x) { return expf(x); }
__device__ __forceinline__ double aexp(double x) { return exp(x); }

// launches `kernel`, opting into `smem` bytes of dynamic shared memory (a
// block's static and dynamic shared memory together past 48 KB need it);
// returns the launch's error
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the scalar kernels (flash_forward_any.cu's fwd_any, flash_backward_any.cu's
// dq_any and dkv_any): 8 warps in 4 pairs own 64 rows (or keys); operands
// staged by cp.async; float64 on the FP64 tensor cores (DMMA), the rest on
// register-tiled FFMA
// ---------------------------------------------------------------------------

constexpr int kAnyThreads = 256;  // threads a block: 4 pairs of warps
constexpr int kAnyRows = 64;      // rows (keys) a block owns: one class-map block
constexpr int kWideD = 128;       // the widest instance; wider head dims split

// the accumulator type: double for float64, else f32
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

// rows [r0, r0 + ROWS) and columns [c0, c0 + D) of a [n, d] matrix into a
// staged tile (row stride ST) by cp.async of V bytes; rows past n and
// columns past d are zero-filled. V divides d's row bytes and c0's.
template <int V, int ROWS, int D, int ST, typename T>
__device__ __forceinline__ void copy_rows(T* s, const T* g, int r0, int n,
                                          int c0, int d) {
  constexpr int E = V / sizeof(T), kPer = D / E;
  for (int i = threadIdx.x; i < ROWS * kPer; i += kAnyThreads) {
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
      for (int i = threadIdx.x; i < ROWS * D; i += kAnyThreads) {
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

// calls f(T{}, std::integral_constant<int, D>{}) for the dtype code and
// head dim: D = 32, 64, 112 (float64 only: f32's dq halves take multiples
// of 32) or 128 (and 128 for every wider d, split over blockIdx.z); the
// 16-bit types come here only above 256 and have the D = 128 instance alone
template <typename F>
int any_dispatch(int dtype, int d, F f) {
  auto by_dim = [&](auto t) -> int {
    if constexpr (sizeof(t) == 2) {
      return f(t, std::integral_constant<int, kWideD>{});
    } else {
      if (d <= 32) return f(t, std::integral_constant<int, 32>{});
      if (d <= 64) return f(t, std::integral_constant<int, 64>{});
      if constexpr (sizeof(t) == 8) {
        if (d <= 112) return f(t, std::integral_constant<int, 112>{});
      }
      return f(t, std::integral_constant<int, kWideD>{});
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

// ---------------------------------------------------------------------------
// the wgmma kernels (fwd_wg, dq_tc, dkv_tc, dq_wide, dkv_wide): a TMA
// producer warpgroup and consumer warpgroups of 64 rows (or keys) each
// ---------------------------------------------------------------------------

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

// A consumer warp retires a ring stage by one arrival (the stage's `empty`
// barrier counts one a consumer warp), after its lanes have read the
// stage: their products waited on, their kv ids read
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(bar);
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, results below 2^-126 flushed to 0; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// the ragged producers (fwd_wg, dq_tc, dkv_tc, dq_wide, dkv_wide with R:
// 16-bit head dims that are not a multiple of 8, whose rows of 2d bytes
// TMA's 16-byte global strides cannot describe): the producer warpgroup's
// 128 threads copy the tiles TMA would have loaded into the same swizzled
// layout, by cp.async pieces, or 2-byte stores at an odd d
// ---------------------------------------------------------------------------

// Where a producer thread's pieces of a row-major tile lie (V elements a
// piece, P = d / V of them a row): at P <= 128 the thread copies the piece
// at column c of the rows r, r + dr, ... (dr = 128 / P rows at once, dr P
// threads busy); above, the columns c and c + 128 V of every row. A thread
// with no piece has c >= d. The offsets inside a column stay fixed down
// the rows, so a piece costs a few instructions.
struct Walk {
  int r, c, dr;
};

__device__ __forceinline__ Walk walk_of(int tid, int d, int v) {
  const int per = d / v;
  if (per > 128) return Walk{0, tid * v, 1};
  const int rows = 128 / per;
  return tid < rows * per ? Walk{tid / per, (tid % per) * v, rows}
                          : Walk{0, d, 1};
}

// the byte of element (r, c) in a W-byte-swizzled tile of ROWS rows
template <int ROWS, int W>
__device__ __forceinline__ int swizzled(int r, int c) {
  constexpr int C = W / 2;  // columns of a column block
  const int byte = (c % C) * 2;
  const int swz = W == 128 ? r & 7 : (r >> 1) & 3;
  return (c / C) * ROWS * W + r * W + (((byte >> 4) ^ swz) << 4) + (byte & 15);
}

// Rows [row0, row0 + ROWS) of a [n, d] matrix g into a W-byte-swizzled tile
// of ROWS rows (TMA's layout, hopper.cuh) by 8- (V = 4) or 4-byte (V = 2)
// cp.async, the pieces that walk `w` gives this thread, zero-filled past n.
// Columns from d on are not written.
template <int ROWS, int W, int V, typename T>
__device__ __forceinline__ void copy_tile(unsigned char* tile, const T* g,
                                          int row0, int n, int d, Walk w) {
  for (int c = w.c; c < d; c += 128 * V) {
    for (int r = w.r; r < ROWS; r += w.dr) {
      const bool in = row0 + r < n;
      hopper::cp_async_ca<2 * V>(tile + swizzled<ROWS, W>(r, c),
                                 g + (in ? (long long)(row0 + r) * d + c : c),
                                 in);
    }
  }
}

// The same tile at an odd d, whose rows lie only 2-byte aligned: the rows
// [row0, row0 + ROWS) are one contiguous span of g, so the producer's 128
// threads load its 4-byte words in turn (NB words a thread in flight) and
// store each word's two elements where they belong by 2-byte stores;
// elements of rows past n are stored as 0, and a word that reaches past
// the span's valid elements is read by its valid halves alone.
template <int ROWS, int W, int NB, typename T>
__device__ __forceinline__ void copy_tile_odd(unsigned char* tile, const T* g,
                                              int row0, int n, int d,
                                              int tid) {
  const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
  const long long e0 = (long long)row0 * d, e1 = e0 + (long long)ROWS * d;
  const long long ev = min(e1, max(e0, (long long)n * d));
  // the first element of the 4-byte word that holds element e0
  const long long w0 = e0 - ((reinterpret_cast<uintptr_t>(gs + e0) >> 1) & 1);
  const int words = static_cast<int>((e1 - w0 + 1) / 2);
  // (row, column) of this thread's next word's first element (-1: the
  // element before the tile), and a step of 128 words, 256 elements
  const int rel = static_cast<int>(w0 - e0) + 2 * tid;
  int r = rel >= 0 ? rel / d : -1, c = rel >= 0 ? rel % d : d - 1;
  const int dr = 256 / d, dc = 256 % d;
  for (int k0 = tid; k0 < words; k0 += 128 * NB) {
    uint32_t x[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int k = k0 + 128 * i;
      const long long e = w0 + 2LL * k;
      x[i] = 0;
      if (k < words) {
        if (e >= e0 && e + 1 < ev) {
          x[i] = *reinterpret_cast<const uint32_t*>(gs + e);
        } else {
          if (e >= e0 && e < ev) x[i] = gs[e];
          if (e + 1 >= e0 && e + 1 < ev) x[i] |= uint32_t(gs[e + 1]) << 16;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (k0 + 128 * i < words) {
        int rr = r, cc = c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rr >= 0 && rr < ROWS)
            *reinterpret_cast<unsigned short*>(
                tile + swizzled<ROWS, W>(rr, cc)) = (x[i] >> (16 * h)) & 0xffff;
          if (++cc == d) cc = 0, ++rr;
        }
      }
      r += dr;
      c += dc;
      if (c >= d) c -= d, ++r;
    }
  }
}

// What the backward's ragged producers share with fwd_wg's (which keeps
// its own copy of the calls, as it was written).
//
// The columns from d to D of a W-byte-swizzled tile of ROWS rows, which
// TMA would have read as 0: each 16-byte chunk from the one holding column
// d on, whole, by the threads tid, tid + step, ... Run once a buffer,
// before a barrier: the copies of the columns below d land after it and
// never write past d.
template <int D, int ROWS, int W>
__device__ __forceinline__ void zero_tail(unsigned char* tile, int d, int tid,
                                          int step) {
  const int c8 = d / 8, chunks = D / 8 - c8;
  for (int i = tid; i < ROWS * chunks; i += step)
    *reinterpret_cast<uint4*>(
        tile + swizzled<ROWS, W>(i / chunks, (c8 + i % chunks) * 8)) =
        make_uint4(0, 0, 0, 0);
}

// the backward's inputs as [B*H, S, d] rows, for its ragged producers (null
// in the TMA instances)
template <typename T>
struct BwdRows {
  const T *q, *k, *v, *dout;
};

// Calls f(std::integral_constant<int, V>{}) with V the elements of a copy
// piece at head dim d: 4 (8 bytes) at d % 4 == 0, 2 (4 bytes) at other
// even d, 1 at an odd d (copy_tile_odd).
template <typename F>
__device__ __forceinline__ void by_piece(int d, F f) {
  if (d % 4 == 0)
    f(std::integral_constant<int, 4>{});
  else if (d % 2 == 0)
    f(std::integral_constant<int, 2>{});
  else
    f(std::integral_constant<int, 1>{});
}

// ROWS rows from row0 of a [n, d] matrix g into a W-byte-swizzled tile, by
// the pieces of V elements of this thread's walk w, or at V = 1 by
// copy_tile_odd (NB words a thread in flight)
template <int ROWS, int W, int V, int NB, typename T>
__device__ __forceinline__ void copy_ragged(unsigned char* tile, const T* g,
                                            int row0, int n, int d, Walk w,
                                            int tid) {
  if constexpr (V == 1)
    copy_tile_odd<ROWS, W, NB>(tile, g, row0, n, d, tid);
  else
    copy_tile<ROWS, W, V>(tile, g, row0, n, d, w);
}

// an arrival on `bar` once this thread's copies so far have landed: by
// cp.async.mbarrier.arrive.noinc, or after V = 1's plain stores a plain
// arrival (release)
template <int V>
__device__ __forceinline__ void arrive_copies(uint64_t* bar) {
  if constexpr (V == 1)
    hopper::mbar_arrive(bar);
  else
    hopper::cp_async_arrive_noinc(bar);
}

// Lane t's share of rowsum(o * do) over one row of d elements at element
// offset `off`: the pieces t, t + 4, ... of 4 (8-byte loads), 2 (4-byte)
// or 1 element, by the row's alignment, in f32.
template <typename T>
__device__ __forceinline__ float row_dot(const T* o, const T* dout,
                                         long long off, int d, int t) {
  float sum = 0.f;
  if (d % 4 == 0) {
    for (int c = 4 * t; c < d; c += 16) {
      const uint2 ov = *reinterpret_cast<const uint2*>(o + off + c);
      const uint2 dv = *reinterpret_cast<const uint2*>(dout + off + c);
      const T* o4 = reinterpret_cast<const T*>(&ov);
      const T* d4 = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 of = hopper::unpack2<T>(o4[2 * e], o4[2 * e + 1]);
        const float2 df = hopper::unpack2<T>(d4[2 * e], d4[2 * e + 1]);
        sum = fmaf(of.x, df.x, sum);
        sum = fmaf(of.y, df.y, sum);
      }
    }
  } else if (d % 2 == 0) {
    for (int c = 2 * t; c < d; c += 8) {
      const uint32_t ow = *reinterpret_cast<const uint32_t*>(o + off + c);
      const uint32_t dw = *reinterpret_cast<const uint32_t*>(dout + off + c);
      const T* o2 = reinterpret_cast<const T*>(&ow);
      const T* d2 = reinterpret_cast<const T*>(&dw);
      const float2 of = hopper::unpack2<T>(o2[0], o2[1]);
      const float2 df = hopper::unpack2<T>(d2[0], d2[1]);
      sum = fmaf(of.x, df.x, sum);
      sum = fmaf(of.y, df.y, sum);
    }
  } else {
    for (int c = t; c < d; c += 4) {
      const float2 of = hopper::unpack2<T>(o[off + c], o[off + c]);
      const float2 df = hopper::unpack2<T>(dout[off + c], dout[off + c]);
      sum = fmaf(of.x, df.x, sum);
    }
  }
  return sum;
}

// A consumer's wait for a stage that wgmma reads: after the ragged
// producer's generic-proxy writes (R), an async-proxy fence.
template <bool R>
__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t phase) {
  hopper::mbar_wait(bar, phase);
  if constexpr (R) hopper::fence_proxy_async();
}

// The ragged producer of the dq kernels (dq_tc, dq_wide), run by the
// producer warpgroup's 128 threads: the NC 64-row parts of Q and dO from
// row r0 (kHalf bytes a part), arriving on q_full; then each tile i <
// tiles that loaded(i) keeps, BC keys from first + i BC, into the ring's
// next stage st of ST ([K tile, V tile] of kTile bytes each; under M the
// tile's kv ids, 0 without ids, into kid[st BC ..]) once empty[st] has
// passed, arriving on full[st].
template <int NC, int BC, int ST, int W, bool M, typename T, typename L>
__device__ __forceinline__ void produce_dq(
    const BwdRows<T>& rg, const Problem& p, int b, int bh, int r0,
    int first, int tiles, L loaded, unsigned char* qs, unsigned char* dos,
    int kHalf, unsigned char* ring, int kTile, uint64_t* q_full,
    uint64_t* full, uint64_t* empty, int* kid) {
  const int tid = threadIdx.x;
  by_piece(p.d, [&](auto piece) {
    constexpr int V = decltype(piece)::value;
    const Walk w = walk_of(tid, p.d, V);
    const long long qoff = (long long)bh * p.sq * p.d;
    for (int hf = 0; hf < NC; ++hf) {
      copy_ragged<64, W, V, 8>(qs + hf * kHalf, rg.q + qoff, r0 + 64 * hf,
                               p.sq, p.d, w, tid);
      copy_ragged<64, W, V, 8>(dos + hf * kHalf, rg.dout + qoff,
                               r0 + 64 * hf, p.sq, p.d, w, tid);
    }
    arrive_copies<V>(q_full);
    const T* kg = rg.k + (long long)bh * p.skv * p.d;
    const T* vg = rg.v + (long long)bh * p.skv * p.d;
    int n = 0;  // tiles loaded
    for (int i = 0; i < tiles; ++i) {
      const int c0 = first + i * BC;
      if (!loaded(i)) continue;
      const int st = n % ST;
      hopper::mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
      ++n;
      if constexpr (M) {  // the tile's kv ids, with K
        for (int u = tid; u < BC; u += 128) {
          const bool in = p.q_ids != nullptr && c0 + u < p.skv;
          const int* src = in ? p.kv_ids + (long long)b * p.skv + c0 + u
                              : reinterpret_cast<const int*>(kg);
          if constexpr (V == 1)
            kid[st * BC + u] = in ? *src : 0;
          else
            cp_async_ca<4>(&kid[st * BC + u], src, in);
        }
      }
      unsigned char* dst = ring + st * 2 * kTile;
      copy_ragged<BC, W, V, 8>(dst, kg, c0, p.skv, p.d, w, tid);
      copy_ragged<BC, W, V, 8>(dst + kTile, vg, c0, p.skv, p.d, w, tid);
      arrive_copies<V>(&full[st]);
    }
  });
}

// The ragged producer of the dkv kernels (dkv_tc, dkv_wide), run by the
// producer warpgroup's 128 threads: the NH 64-key parts of K and V from
// key c0 (kHalf bytes a part), arriving on kv_full; then each q tile of BR
// rows from r0 = first + i BR (i < tiles) that loaded(r0) keeps into the
// ring's next stage st of ST ([Q tile, dO tile] of kTile bytes each) once
// empty[st] has passed, arriving on full[st]; the first warp's lanes then
// write the tile's row statistics (lse log2e, di, the visible keys [lo,
// hi) and, under M, the segment ids, at st BR ..) and arrive again, so
// that full[st] counts 128 + 32 arrivals. They fetch the statistics when
// they store them: fetched a tile ahead, as the TMA producers do, they
// spilled 12-60 bytes at 40 registers and gained nothing on an H100.
template <int NH, int BR, int ST, int W, bool M, typename T, typename L>
__device__ __forceinline__ void produce_dkv(
    const BwdRows<T>& rg, const Problem& p, int b, int bh, int c0,
    int first, int tiles, L loaded, const float* lse, const float* di,
    unsigned char* ks, unsigned char* vs, int kHalf, unsigned char* ring,
    int kTile, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    float* lse_s, float* di_s, int2* keys_s, int* qid_s) {
  const int tid = threadIdx.x;
  const long long lbase = (long long)bh * p.sq;
  by_piece(p.d, [&](auto piece) {
    constexpr int V = decltype(piece)::value;
    const Walk w = walk_of(tid, p.d, V);
    const long long koff = (long long)bh * p.skv * p.d;
    for (int hf = 0; hf < NH; ++hf) {
      copy_ragged<64, W, V, 8>(ks + hf * kHalf, rg.k + koff, c0 + 64 * hf,
                               p.skv, p.d, w, tid);
      copy_ragged<64, W, V, 8>(vs + hf * kHalf, rg.v + koff, c0 + 64 * hf,
                               p.skv, p.d, w, tid);
    }
    arrive_copies<V>(kv_full);
    const T* qg = rg.q + lbase * p.d;
    const T* dg = rg.dout + lbase * p.d;
    int n = 0;  // tiles loaded
    for (int i = 0; i < tiles; ++i) {
      const int r0 = first + i * BR;
      if (!loaded(r0)) continue;
      const int st = n % ST;
      hopper::mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
      ++n;
      unsigned char* dst = ring + st * 2 * kTile;
      copy_ragged<BR, W, V, 8>(dst, qg, r0, p.sq, p.d, w, tid);
      copy_ragged<BR, W, V, 8>(dst + kTile, dg, r0, p.sq, p.d, w, tid);
      arrive_copies<V>(&full[st]);
      if (tid < 32) {  // the row statistics
#pragma unroll
        for (int u = 0; u < BR / 32; ++u) {
          const int row = r0 + tid + 32 * u, at = st * BR + tid + 32 * u;
          const bool in = row < p.sq;
          lse_s[at] = in ? lse[lbase + row] * kLog2e : 0.f;
          di_s[at] = in ? di[lbase + row] : 0.f;
          keys_s[at] = key_bounds(p, b, row);
          if constexpr (M)
            qid_s[at] = in && p.q_ids != nullptr
                            ? p.q_ids[(long long)b * p.sq + row] : 0;
        }
        hopper::mbar_arrive(&full[st]);
      }
    }
  });
}

// The output columns col and col + 1 (col even, col < d) of a [rows, d]
// matrix at element i: one 4-byte store at an even d, 2-byte stores at an
// odd d, where col + 1 may lie past d.
template <typename T>
__device__ __forceinline__ void store_pair(T* out, long long i, int col, int d,
                                           uint32_t pair) {
  if (!(d & 1)) {
    *reinterpret_cast<uint32_t*>(out + i) = pair;
  } else {
    unsigned short* os = reinterpret_cast<unsigned short*>(out + i);
    os[0] = pair & 0xffff;
    if (col + 1 < d) os[1] = pair >> 16;
  }
}

// what an entry point returns when a TMA map could not be encoded: this
// plus libcuda's CUresult (kMapError - 1: no encoder was found)
constexpr int kMapError = 10000;

// TMA maps of N tensors [bh, rows[i], d] of T (bf16 or f16) in boxes of
// D's column block (swizzle_bytes) by box[i] rows; a tensor with no rows
// gets a map of one row, which no load reads. Binds the tensors' device
// first: libcuda's encoder needs its context current on this thread, and
// autograd runs the backward on a thread of its own, where nothing may
// have made it current yet. Returns 0, a cudaError_t, or kMapError + the
// encoder's failure.
template <typename T, int D, int N>
int tile_maps(CUtensorMap (&m)[N], const void* const (&base)[N],
              const int (&rows)[N], const int (&box)[N], int bh, int d) {
  cudaPointerAttributes at;
  if (cudaPointerGetAttributes(&at, base[0]) != cudaSuccess ||
      cudaSetDevice(at.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  for (int i = 0; i < N; ++i) {
    const int rc = hopper::tile_map<T, swizzle_bytes(D)>(
        &m[i], base[i], bh, rows[i] > 0 ? rows[i] : 1, d, box[i]);
    if (rc != 0) return kMapError + rc;
  }
  return 0;
}

}  // namespace lamp_flash

namespace lamp_flash {

// flash_forward.cu: the wgmma forward for bfloat16 (dtype 1) and float16
// (2) at every head dim d <= 256 (tiles by TMA at d % 8 == 0, by cp.async
// at the rest). Returns the launch's cudaError_t, or kMapError +
// libcuda's CUresult when a TMA map was refused.
int wg_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, const Problem& p, int bh, cudaStream_t stream);

// flash_backward_wide.cu: the wgmma backward, dq then dkv, for bfloat16
// (dtype 1) and float16 (2) at head dims 128 < d <= 256 (tiles by TMA at
// d % 8 == 0, by cp.async at the rest); the same returns as wg_fwd.
int wide_dq(int dtype, const void* q, const void* k, const void* v,
            const void* o, const void* dout, const float* lse, float* di,
            void* dq, const Problem& p, int bh, cudaStream_t stream);
int wide_dkv(int dtype, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* di, void* dk,
             void* dv, const Problem& p, int bh, cudaStream_t stream);

// flash_forward_any.cu (any_fwd) and flash_backward_any.cu (any_dq,
// any_dkv): the kernels for every head dim and the dtype codes 0 float32,
// 1 bfloat16, 2 float16 and 3 float64. Each returns the launch's
// cudaError_t. lse and di are f64 for float64 inputs, else f32.
int any_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
            void* lse, const Problem& p, int bh, cudaStream_t stream);
int any_dq(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const void* lse, void* di,
           void* dq, const Problem& p, int bh, cudaStream_t stream);
int any_dkv(int dtype, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* di, void* dk,
            void* dv, const Problem& p, int bh, cudaStream_t stream);

}  // namespace lamp_flash
