// What the flash-attention kernels share (flash_attention.cu: the
// backward's tensor-core kernels, the ragged forward and the entry points;
// flash_forward.cu: the wgmma forward; flash_attention_any.cu and
// flash_backward_any.cu: the scalar forward and the FP64-tensor-core /
// FFMA backward for every head dim and float type): the problem's shape, the
// visibility rules of flash_attention.cu's header note, the launch helper,
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

// cp.async of 16 bytes (cp.async.cg); src-size 0 zero-fills the 16 bytes
// without reading
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// cp.async of 8 or 4 bytes (cp.async.ca), zero-filled when not valid
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}
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
// the wgmma kernels (fwd_wg, dq_tc, dkv_tc): a TMA producer warpgroup and
// consumer warpgroups of 64 rows (or keys) each
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

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, results below 2^-126 flushed to 0; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// (2) at head dims d % 8 == 0, d <= 256. Returns the launch's cudaError_t,
// or kMapError + libcuda's CUresult when a TMA map was refused.
int wg_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, const Problem& p, int bh, cudaStream_t stream);

// flash_attention_any.cu (any_fwd) and flash_backward_any.cu (any_dq,
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
