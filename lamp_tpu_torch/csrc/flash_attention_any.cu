// Flash attention forward for every head dim and float type: the scalar
// kernel fwd_any (no tensor cores) of flash_attention.cu's forward entry
// point. The backward's kernels for the same inputs, dq_any and dkv_any,
// are flash_backward_any.cu's.
//
// Replaces, with flash_attention.cu and flash_forward.cu, the Pallas TPU
// kernel of lamp_tpu/ops/attention.py K1 _fwd_kernel (and so K3a), for
// the inputs the tensor-core kernels do not take: float32 and float64 at
// every head dim; bfloat16 and float16 above head dim 256. The head dim d
// is a run-time value with no upper limit.
//
// The same function as the tensor-core kernels, with the visibility rules
// of flash_attention.cu's header (flash_common.cuh): f32 accumulation for
// the 16-bit types and f32 (A = float), double throughout for float64 (A =
// double; the JAX kernel's dots ask for f32 results even there); p rounded
// to v's type for P @ V; rows with no visible key give o = 0 and lse =
// -inf. lse is A: f32, f64 for float64.
//
// Design: a block of 128 threads owns 32 query rows and DO output columns
// (128; 64 for float64), and walks tiles of 32 keys. Four threads share a
// row: each holds 8 of the tile's 32 scores and DO / 4 output columns in
// registers. The score products run over the head dim in chunks of 32
// staged in shared memory, so nothing in a block grows with d; a head dim
// above DO splits the output columns over blockIdx.z, and each part
// recomputes the scores. Loads are plain element loads: any row stride,
// any alignment.
//
// What bounds it: not the card's limits but its own simplicity. The
// products run on the FMA units (67 TFLOP/s in f32 on an H100, against
// 989 on the tensor cores in bf16), with two shared-memory loads a
// multiply-add.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace lamp_flash;

constexpr int kAT = 128;  // threads a block
constexpr int kAR = 32;   // rows of a block
constexpr int kAC = 32;   // keys of a tile
constexpr int kAK = 32;   // head-dim chunk of the score products
constexpr int kAS = kAC / 4;  // scores a thread

// output columns of a block: its accumulators in registers
template <typename A>
__host__ __device__ constexpr int out_cols() {
  return sizeof(A) == 8 ? 64 : 128;
}

__device__ __forceinline__ float amax(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double amax(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ float alog(float x) { return logf(x); }
__device__ __forceinline__ double alog(double x) { return log(x); }

// over the four threads of a row (lanes 4r .. 4r + 3)
template <typename A>
__device__ __forceinline__ A row_max(A x) {
  x = amax(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return amax(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
template <typename A>
__device__ __forceinline__ A row_sum(A x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s[r][c] = g[(r0 + r) * d + c0 + c] for r < ROWS, c < COLS (row stride
// COLS + 1), as A; 0 past n rows or d columns. Every load of a thread is
// issued before its first store, so that their latencies overlap.
template <int ROWS, int COLS, typename A, typename T>
__device__ __forceinline__ void stage(A* s, const T* g, int r0, int n, int c0,
                                      int d) {
  static_assert(ROWS * COLS % kAT == 0, "whole rounds of the block");
  constexpr int kN = ROWS * COLS / kAT;
  A x[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int i = threadIdx.x + u * kAT, r = i / COLS, c = i % COLS;
    const bool in = r0 + r < n && c0 + c < d;
    x[u] = in ? to_acc(g[(long long)(r0 + r) * d + c0 + c]) : A(0);
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int i = threadIdx.x + u * kAT;
    s[(i / COLS) * (COLS + 1) + i % COLS] = x[u];
  }
}

template <typename T, typename A>
__global__ void __launch_bounds__(kAT)
fwd_any(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o, A* __restrict__ lse,
        Problem p) {
  constexpr int DO = out_cols<A>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* qs = reinterpret_cast<A*>(smem_raw);  // [kAR][kAK + 1]
  A* ks = qs + kAR * (kAK + 1);            // [kAC][kAK + 1]
  A* ps = ks + kAC * (kAK + 1);            // [kAR][kAC + 1]
  A* vs = ps + kAR * (kAC + 1);            // [kAC][DO + 1]
  __shared__ int lim_max;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int r0 = blockIdx.x * kAR, col0 = blockIdx.z * DO;
  const int tid = threadIdx.x, r = tid / 4, c4 = tid % 4, row = r0 + r;
  const long long qbase = (long long)bh * p.sq * p.d;
  const long long kbase = (long long)bh * p.skv * p.d;
  const int lim = row_limit(p, b, row);
  if (tid == 0) lim_max = 0;
  __syncthreads();
  atomicMax(&lim_max, lim);
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, kAR, &lo, &hi);
  hi = min(hi, lim_max);
  const A scale = sizeof(A) == 8 ? A(p.scale64) : A(p.scale);
  A acc[DO / 4];
#pragma unroll
  for (int i = 0; i < DO / 4; ++i) acc[i] = 0;
  A m = -INFINITY, l = 0;
  for (int c0 = (lo / kAC) * kAC; c0 < hi; c0 += kAC) {
    const int cls = span_class(p, b, h, r0 / kBlock, c0, kAC);
    if (cls == kSkip) continue;
    A s[kAS];
#pragma unroll
    for (int i = 0; i < kAS; ++i) s[i] = 0;
    for (int d0 = 0; d0 < p.d; d0 += kAK) {
      stage<kAR, kAK>(qs, q + qbase, r0, p.sq, d0, p.d);
      stage<kAC, kAK>(ks, k + kbase, c0, p.skv, d0, p.d);
      __syncthreads();
#pragma unroll 4
      for (int e = 0; e < kAK; ++e) {
        const A qe = qs[r * (kAK + 1) + e];
#pragma unroll
        for (int i = 0; i < kAS; ++i) s[i] = afma(qe, ks[(c4 + 4 * i) * (kAK + 1) + e], s[i]);
      }
      __syncthreads();
    }
    A mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kAS; ++i) {
      const int col = c0 + c4 + 4 * i;
      const bool vis = visible(p, row, lim, col) &&
                       (cls == kFull || keep(p, b, h, row, col));
      s[i] = vis ? s[i] * scale : A(-INFINITY);
      mx = amax(mx, s[i]);
    }
    const A mn = amax(m, row_max(mx));
    // a row with nothing visible so far keeps max -inf: exponentiate
    // against 0 there, so that exp(-inf) gives 0, never NaN
    const A mu = mn == A(-INFINITY) ? A(0) : mn;
    const A alpha = aexp(m - mu);
    A sum = 0;
#pragma unroll
    for (int i = 0; i < kAS; ++i) {
      const A pr = aexp(s[i] - mu);
      sum += pr;
      ps[r * (kAC + 1) + c4 + 4 * i] = round_to<T>(pr);
    }
    l = l * alpha + row_sum(sum);
    m = mn;
#pragma unroll
    for (int i = 0; i < DO / 4; ++i) acc[i] *= alpha;
    stage<kAC, DO>(vs, v + kbase, c0, p.skv, col0, p.d);
    __syncthreads();
    for (int j = 0; j < kAC; ++j) {
      const A pj = ps[r * (kAC + 1) + j];
#pragma unroll
      for (int i = 0; i < DO / 4; ++i) acc[i] = afma(pj, vs[j * (DO + 1) + c4 + 4 * i], acc[i]);
    }
    __syncthreads();
  }
  if (row < p.sq) {
    const A inv = l == A(0) ? A(0) : A(1) / l;
#pragma unroll
    for (int i = 0; i < DO / 4; ++i) {
      const int col = col0 + c4 + 4 * i;
      if (col < p.d) o[qbase + (long long)row * p.d + col] = from_acc<T>(acc[i] * inv);
    }
    if (blockIdx.z == 0 && c4 == 0)
      lse[(long long)bh * p.sq + row] = l == A(0) ? A(-INFINITY) : m + alog(l);
  }
}

template <typename A>
constexpr int smem_fwd() {
  return (2 * kAR * (kAK + 1) + kAR * (kAC + 1) + kAC * (out_cols<A>() + 1)) *
         sizeof(A);
}

// calls f(T{}, A{}) for the dtype code
template <typename F>
int by_type(int dtype, F f) {
  switch (dtype) {
    case 0: return f(float{}, float{});
    case 1: return f(__nv_bfloat16{}, float{});
    case 2: return f(__half{}, float{});
    case 3: return f(double{}, double{});
  }
  return cudaErrorInvalidValue;
}

template <typename A>
dim3 grid_of(int rows, int bh, int d) {
  return dim3(cdiv(rows, kAR), bh, cdiv(d, out_cols<A>()));
}

}  // namespace

namespace lamp_flash {

int any_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
            void* lse, const Problem& p, int bh, cudaStream_t stream) {
  return by_type(dtype, [&](auto t, auto a) -> int {
    using T = decltype(t);
    using A = decltype(a);
    return launch(fwd_any<T, A>, grid_of<A>(p.sq, bh, p.d), kAT, smem_fwd<A>(),
                  stream, static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o),
                  static_cast<A*>(lse), p);
  });
}

}  // namespace lamp_flash
