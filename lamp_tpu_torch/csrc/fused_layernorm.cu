// Fused LayerNorm forward and backward over the last dimension, for Hopper
// (sm_90a).
//
// Replaces lamp_tpu/ops/fused_layernorm.py:_fwd_kernel (K5a) and
// _bwd_kernel (K5b). x [N, D] in f32 or bf16; weight and bias [D] f32 (the
// wrapper casts them); statistics in f32.
//
//   forward:  mu = sum(x) / D;  var = sum((x - mu)^2) / D;  rs = rsqrt(var + eps)
//             y = (x - mu) rs w (+ b) in x's dtype; mu, rs [N] f32 saved
//   backward: yhat = (x - mu) rs;  dyg = dy w
//             m1 = sum(dyg) / D;  m2 = sum(dyg yhat) / D  (the D folded in as
//             a multiplication by 1/D, as the TPU kernel does)
//             dx = rs (dyg - m1 - yhat m2) in x's dtype
//             dw = sum over rows of dy yhat;  db = sum over rows of dy  (f32)
//
// What bounds them: bytes. The forward reads x once and writes y (plus 8
// bytes a row), the backward reads x and dy and writes dx; a few flops per
// byte. The forward gives each row to one warp: a lane keeps up to 32 of its
// row's values in registers (the whole row for D <= 1024) and re-reads the
// rest from L1 for the three passes (mean, variance, output).
//
// The backward's dw and db are sums over rows. The TPU kernel carries them
// across its sequential grid in a revisited output block; here blocks run in
// no order, so each block owns a tile of rows and writes its tile's f32
// partial sums to a workspace [2, tiles, D], and a second kernel adds the
// partials of each column in tile order. Nothing is atomic, so the result is
// the same from run to run. In the first kernel, each warp computes the
// row means m1, m2 of its rows (warp reductions, into shared memory); then
// each thread owns columns and walks the tile's rows in order, writing dx
// and adding dy yhat and dy for its columns in registers. The tile's x and
// dy are read twice, the second time from L1/L2. The wrapper picks the rows
// per tile (about two tiles per SM, at most 256 rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 32;      // row values a lane keeps in registers
constexpr int kMaxTileRows = 256;
constexpr int kReduceCols = 32;  // columns of one reduction block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu_out,
                     float* __restrict__ rs_out, int n, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + (long long)row * d;
  T* yr = y + (long long)row * d;

  float c[kCache];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int col = lane + 32 * k;
    c[k] = col < d ? to_float(xr[col]) : 0.f;
    sum += c[k];
  }
  for (int col = lane + 32 * kCache; col < d; col += 32) sum += to_float(xr[col]);
  const float mu = __fdiv_rn(warp_sum(sum), (float)d);

  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const float t = c[k] - mu;
    if (lane + 32 * k < d) sq += t * t;
  }
  for (int col = lane + 32 * kCache; col < d; col += 32) {
    const float t = to_float(xr[col]) - mu;
    sq += t * t;
  }
  const float rs = rsqrtf(__fdiv_rn(warp_sum(sq), (float)d) + eps);

#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int col = lane + 32 * k;
    if (col < d) {
      float v = (c[k] - mu) * rs * w[col];
      if (b != nullptr) v += b[col];
      yr[col] = from_float<T>(v);
    }
  }
  for (int col = lane + 32 * kCache; col < d; col += 32) {
    float v = (to_float(xr[col]) - mu) * rs * w[col];
    if (b != nullptr) v += b[col];
    yr[col] = from_float<T>(v);
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rs_out[row] = rs;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ w, const float* __restrict__ mu,
                     const float* __restrict__ rs, T* __restrict__ dx, float* __restrict__ part_w,
                     float* __restrict__ part_b, int n, int d, int tile_rows) {
  __shared__ float s_mu[kMaxTileRows], s_rs[kMaxTileRows], s_m1[kMaxTileRows],
      s_m2[kMaxTileRows];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - r0);
  const float inv_d = 1.0f / (float)d;

  // the row means m1 = mean(dy w) and m2 = mean(dy w yhat), a warp a row
  for (int r = warp; r < rows; r += kWarps) {
    const long long off = (long long)(r0 + r) * d;
    const float mu_r = mu[r0 + r], rs_r = rs[r0 + r];
    float s1 = 0.f, s2 = 0.f;
    for (int col = lane; col < d; col += 32) {
      const float yhat = (to_float(x[off + col]) - mu_r) * rs_r;
      const float dyg = to_float(dy[off + col]) * w[col];
      s1 += dyg;
      s2 += dyg * yhat;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      s_mu[r] = mu_r;
      s_rs[r] = rs_r;
      s_m1[r] = s1 * inv_d;
      s_m2[r] = s2 * inv_d;
    }
  }
  __syncthreads();

  // dx, and the tile's column sums, rows in order
  for (int col = threadIdx.x; col < d; col += kThreads) {
    const float wc = w[col];
    float acc_w = 0.f, acc_b = 0.f;
    for (int r = 0; r < rows; ++r) {
      const long long i = (long long)(r0 + r) * d + col;
      const float dyv = to_float(dy[i]);
      const float yhat = (to_float(x[i]) - s_mu[r]) * s_rs[r];
      const float dyg = dyv * wc;
      dx[i] = from_float<T>(s_rs[r] * (dyg - s_m1[r] - yhat * s_m2[r]));
      acc_w += dyv * yhat;
      acc_b += dyv;
    }
    part_w[(long long)blockIdx.x * d + col] = acc_w;
    part_b[(long long)blockIdx.x * d + col] = acc_b;
  }
}

// dw, db [D]: the tiles' partials of each column added in tile order. A
// block takes 32 columns; warp k adds tiles k, k + 8, ... in order, and the
// eight warps' sums are added in warp order.
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_reduce_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                            float* __restrict__ dw, float* __restrict__ db, int tiles, int d) {
  __shared__ float s_w[kWarps][kReduceCols], s_b[kWarps][kReduceCols];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * kReduceCols + lane;
  float aw = 0.f, ab = 0.f;
  if (col < d) {
    for (int t = warp; t < tiles; t += kWarps) {
      aw += part_w[(long long)t * d + col];
      ab += part_b[(long long)t * d + col];
    }
  }
  s_w[warp][lane] = aw;
  s_b[warp][lane] = ab;
  __syncthreads();
  if (warp == 0 && col < d) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      sw += s_w[k][lane];
      sb += s_b[k][lane];
    }
    dw[col] = sw;
    db[col] = sb;
  }
}

template <typename T>
cudaError_t fwd(const void* x, const float* w, const float* b, void* y, float* mu, float* rs,
                int n, int d, float eps, cudaStream_t stream) {
  layernorm_fwd_kernel<T><<<(n + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), mu, rs, n, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* dy, const float* w, const float* mu, const float* rs,
                void* dx, float* dw, float* db, float* work, int n, int d, int tile_rows,
                cudaStream_t stream) {
  const int tiles = (n + tile_rows - 1) / tile_rows;
  float* part_w = work;
  float* part_b = work + (long long)tiles * d;
  layernorm_bwd_kernel<T><<<tiles, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), w, mu, rs, static_cast<T*>(dx),
      part_w, part_b, n, d, tile_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layernorm_bwd_reduce_kernel<<<(d + kReduceCols - 1) / kReduceCols, kThreads, 0, stream>>>(
      part_w, part_b, dw, db, tiles, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, d] contiguous (dtype 0 = float32, 1 = bfloat16); weight, bias [d]
// float32 (bias may be null) -> y [n, d] in x's dtype, mu and rstd [n]
// float32. Returns the cudaError_t of the launch.
int lamp_layernorm_fwd(const void* x, const void* weight, const void* bias, void* y, void* mu,
                       void* rstd, int n, int d, float eps, int dtype, void* stream) {
  if (n == 0 || d == 0) return cudaSuccess;
  if (n < 0 || d < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0) return fwd<float>(x, w, b, y, m, r, n, d, eps, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, w, b, y, m, r, n, d, eps, st);
  return cudaErrorInvalidValue;
}

// x, dy [n, d] contiguous in one dtype (0 = float32, 1 = bfloat16); weight
// [d], mu, rstd [n] float32 -> dx [n, d] in x's dtype, dweight and dbias
// [d] float32. workspace: 2 * ceil(n / tile_rows) * d float32;
// 1 <= tile_rows <= 256. Returns the cudaError_t of the first launch that
// failed.
int lamp_layernorm_bwd(const void* x, const void* dy, const void* weight, const void* mu,
                       const void* rstd, void* dx, void* dweight, void* dbias, void* workspace,
                       int n, int d, int tile_rows, int dtype, void* stream) {
  if (n < 0 || d < 0 || tile_rows < 1 || tile_rows > kMaxTileRows) return cudaErrorInvalidValue;
  if (d == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {  // no rows: the sums are 0
    cudaError_t err = cudaMemsetAsync(dweight, 0, sizeof(float) * d, st);
    return err != cudaSuccess ? err : cudaMemsetAsync(dbias, 0, sizeof(float) * d, st);
  }
  const float* w = static_cast<const float*>(weight);
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* dw = static_cast<float*>(dweight);
  float* db = static_cast<float*>(dbias);
  float* work = static_cast<float*>(workspace);
  if (dtype == 0) return bwd<float>(x, dy, w, m, r, dx, dw, db, work, n, d, tile_rows, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, dy, w, m, r, dx, dw, db, work, n, d, tile_rows, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
