// Fused LayerNorm forward and backward over the last dimension, for Hopper
// (sm_90a).
//
// Replaces lamp_tpu/ops/fused_layernorm.py:_fwd_kernel (K5a) and
// _bwd_kernel (K5b). x [N, D] in f32 or bf16; the forward reads weight and
// bias [D] in their own dtype (f32 or bf16), the backward weight as f32 (the
// wrapper casts it); statistics in f32.
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
// byte. Both take a grid of blocks over contiguous bands of rows
// (ops/fused_layernorm.py:_bwd_plan, _fwd_plan), a warp a row at a time; its
// lanes take 16-byte loads (8 bf16 or 4 f32: V values) at columns V lane +
// 32 V j, so a lane owns the same columns in every row.
//
// The forward keeps, for rows of up to a window (bf16 768 or 1024 columns,
// f32 768), the row as read in its registers, and w and b as floats,
// loaded once a warp for every row it takes; the next row's loads are
// issued before this row's two sums (mean, then variance: two dependent
// warp reductions), and y goes back with 16-byte stores. Wider rows go by
// windows of 32 V columns re-read from L1 or L2 for each of the three
// passes, w and b with them. Rows that are not 16-byte multiples, or not
// 16-byte aligned, take the same loop with one value a load.
//
// The backward reads x and dy once from memory. For D up to a window
// (bf16: 768 columns with the next row's loads in flight under this row's
// sums, else 1024; f32: 768) the row stays in its registers as read: m1
// and m2 come from warp shuffles, then dx is written with 16-byte stores,
// and the lane's dw and db partials for its columns stay in registers
// across every row the warp takes. A lane's row and partials take at most
// 96 registers, so that two blocks fit an SM. Rows that are not 16-byte
// multiples, or not 16-byte aligned, take the same loop with one value a
// load (windows of 768). Above a window the row goes in windows: a first
// pass takes every row's m1, m2 into a workspace, and each window re-reads
// its columns (from L1 or L2), so the kernel runs at every N and D.
//
// dw and db are sums over rows. The TPU kernel carries them across its
// sequential grid in a revisited output block; here the grid is persistent
// (two blocks an SM, one at most for every 8 rows:
// ops/fused_layernorm.py:_bwd_plan), each block over a contiguous band of
// rows (its warps taking rows w, w + 8, ...), and a block adds its warps'
// partials in warp order through shared memory into one row of a workspace
// [2, blocks, D]; a second kernel adds those in a fixed order. Nothing is
// atomic, so two calls give the same bits. The last block to finish adding
// the rows instead (a counter behind a fence) read 49.60 and 71.93 us a
// call against 12.54 and 18.36 with the second kernel, on the same grids,
// at [3072, 768] and [8192, 768] bf16 on an H100
// (scripts/exp_layernorm_variants.py): one block cannot pull a megabyte of
// partials fast.
//
// What bounds the backward: bytes (x and dy read, dx written; 4.24 us at
// [3072, 768] bf16, 11.29 at [8192, 768], at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pack.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceCols = 32;  // columns of one reduction block

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = v[e];
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

// V floats of w at p (16-byte loads for V > 1)
template <int V>
__device__ __forceinline__ void load_w(const float* p, float (&v)[V]) {
  if constexpr (V > 1) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(p + 4 * q);
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
    }
  } else {
    v[0] = *p;
  }
}

// V floats of a parameter (f32, or bf16 where `bf16`) at its column c
// (16-byte loads for V > 1; 8 bytes for V = 4 in bf16)
template <int V>
__device__ __forceinline__ void load_param(const void* p, bool bf16, int c, float (&v)[V]) {
  if (!bf16) {
    load_w<V>(static_cast<const float*>(p) + c, v);
    return;
  }
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + c;
  if constexpr (V == 8) {
    Pack<__nv_bfloat16, 8> a;
    a.load(q);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = a[e];
  } else if constexpr (V == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(q);
    v[0] = __uint_as_float(a.x << 16), v[1] = __uint_as_float(a.x & 0xFFFF0000u);
    v[2] = __uint_as_float(a.y << 16), v[3] = __uint_as_float(a.y & 0xFFFF0000u);
  } else {
    v[0] = __bfloat162float(*q);
  }
}

// x [n, d] T -> y [n, d] T, mu and rstd [n] f32; w [d] and b [d] (b may be
// null) f32 or bf16 (wb: bit 0 set where w is bf16, bit 1 where b is). Block
// b of `blocks` takes the rows [b n / blocks, (b + 1) n / blocks), its warp w
// the rows w, w + 8, ... of that band. For d <= W = 32 V CH, lane l holds the
// columns V l + 32 V j (j < CH): the row as read, w and b as floats (loaded
// once a warp), and with PF the next row, whose loads are issued before this
// row's sums. Wider rows go by windows of 32 V columns, each pass re-reading
// them (from L1 or L2), w and b with the last.
template <typename T, int V, int CH, bool PF>
__global__ void __launch_bounds__(kThreads, 2)
layernorm_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w,
                     const void* __restrict__ b, T* __restrict__ y, float* __restrict__ mu_out,
                     float* __restrict__ rs_out, int n, int d, float eps, int blocks, int wb) {
  constexpr int W = 32 * V * CH;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = (int)((long long)blockIdx.x * n / blocks);
  const int r1 = (int)((long long)(blockIdx.x + 1) * n / blocks);
  const bool w16 = wb & 1, b16 = wb & 2, bias = b != nullptr;
  const float fd = (float)d;

  if (d > W) {
    for (int r = r0 + warp; r < r1; r += kWarps) {
      const long long off = (long long)r * d;
      float s = 0.f;
      for (int c = V * lane; c < d; c += 32 * V) {
        Pack<T, V> p;
        p.load(x + off + c);
#pragma unroll
        for (int e = 0; e < V; ++e) s += p[e];
      }
      const float mu = __fdiv_rn(warp_sum(s), fd);
      float q = 0.f;
      for (int c = V * lane; c < d; c += 32 * V) {
        Pack<T, V> p;
        p.load(x + off + c);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float t = p[e] - mu;
          q += t * t;
        }
      }
      const float rs = rsqrtf(__fdiv_rn(warp_sum(q), fd) + eps);
      for (int c = V * lane; c < d; c += 32 * V) {
        Pack<T, V> p;
        p.load(x + off + c);
        float wv[V], bv[V], o[V];
        load_param<V>(w, w16, c, wv);
        if (bias) load_param<V>(b, b16, c, bv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = (p[e] - mu) * rs * wv[e];
          if (bias) o[e] += bv[e];
        }
        store_v<V>(y + off + c, o);
      }
      if (lane == 0) mu_out[r] = mu, rs_out[r] = rs;
    }
    return;
  }

  float wv[CH][V], bv[CH][V];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = V * lane + 32 * V * j;
#pragma unroll
    for (int e = 0; e < V; ++e) wv[j][e] = bv[j][e] = 0.f;
    if (c < d) {
      load_param<V>(w, w16, c, wv[j]);
      if (bias) load_param<V>(b, b16, c, bv[j]);
    }
  }
  Pack<T, V> xv[CH], xn[PF ? CH : 1];
  auto load_row = [&](Pack<T, V>* px, int r) {
    const long long off = (long long)r * d;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = V * lane + 32 * V * j;
      if (c < d)
        px[j].load(x + off + c);
      else
        px[j].zero();
    }
  };
  int r = r0 + warp;
  if (PF && r < r1) load_row(xv, r);
  for (; r < r1; r += kWarps) {
    if constexpr (PF) {
      if (r + kWarps < r1) load_row(xn, r + kWarps);
    } else {
      load_row(xv, r);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) s += xv[j][e];
    const float mu = __fdiv_rn(warp_sum(s), fd);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (V * lane + 32 * V * j < d)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float t = xv[j][e] - mu;
          q += t * t;
        }
    const float rs = rsqrtf(__fdiv_rn(warp_sum(q), fd) + eps);
    const long long off = (long long)r * d;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = V * lane + 32 * V * j;
      if (c < d) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = (xv[j][e] - mu) * rs * wv[j][e];
          if (bias) o[e] += bv[j][e];
        }
        store_v<V>(y + off + c, o);
      }
    }
    if (lane == 0) mu_out[r] = mu, rs_out[r] = rs;
    if constexpr (PF) {
#pragma unroll
      for (int j = 0; j < CH; ++j) xv[j] = xn[j];
    }
  }
}

// x, dy [n, d] T; block b of `blocks` takes the rows [b n / blocks, (b + 1)
// n / blocks), its warp w the rows w, w + 8, ... of that band. Lane l holds
// the columns c0 + V l + 32 V j (j < CH) of a window of W = 32 V CH columns
// starting at c0: CH chunks of V values, 96 registers or fewer of row and
// partials, so that two blocks fit an SM (bwd_launch picks CH: 3 or 4 x 8
// bf16, 6 x 4 f32, 24 x 1). PF: the next row's loads are issued before this
// row's sums (bf16 rows of up to 768 columns, where both rows fit the
// registers). part [2][blocks][d]: the block's dw, db partials; stats
// [2][n]: m1, m2 of each row, used where d > W. Dynamic shared memory:
// [kWarps][2][min(d, W)] floats.
template <typename T, int V, int CH, bool PF>
__global__ void __launch_bounds__(kThreads, 2)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ w, const float* __restrict__ mu,
                     const float* __restrict__ rs, T* __restrict__ dx, float* __restrict__ part,
                     float* __restrict__ stats, int n, int d, int blocks) {
  constexpr int W = 32 * V * CH;
  extern __shared__ float red[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = (int)((long long)blockIdx.x * n / blocks);
  const int r1 = (int)((long long)(blockIdx.x + 1) * n / blocks);
  const float inv_d = 1.0f / (float)d;
  const int windows = (d + W - 1) / W, span = min(d, W);

  if (windows > 1) {  // every row's m1 and m2 first, a full pass over the row
    for (int r = r0 + warp; r < r1; r += kWarps) {
      const long long off = (long long)r * d;
      const float mu_r = mu[r], rs_r = rs[r];
      float s1 = 0.f, s2 = 0.f;
      for (int c = V * lane; c < d; c += 32 * V) {
        Pack<T, V> xv, gv;
        float wv[V];
        xv.load(x + off + c);
        gv.load(dy + off + c);
        load_w<V>(w + c, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float dyg = gv[e] * wv[e];
          s1 += dyg;
          s2 += dyg * ((xv[e] - mu_r) * rs_r);
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) stats[r] = s1 * inv_d, stats[n + r] = s2 * inv_d;
    }
    __syncthreads();
  }

  for (int c0 = 0; c0 < d; c0 += W) {
    float pw[CH][V], pb[CH][V];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) pw[j][e] = pb[j][e] = 0.f;
    // row r's window as read, its mean and rstd (and with PF the next row's)
    Pack<T, V> xv[CH], gv[CH], xn[PF ? CH : 1], gn[PF ? CH : 1];
    float mu_r = 0.f, rs_r = 0.f, mu_n = 0.f, rs_n = 0.f;
    auto load_row = [&](Pack<T, V>* px, Pack<T, V>* pg, float& m, float& s, int r) {
      const long long off = (long long)r * d;
      m = mu[r], s = rs[r];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c = c0 + V * lane + 32 * V * j;
        if (c < d) {
          px[j].load(x + off + c);
          pg[j].load(dy + off + c);
        } else {
          px[j].zero();
          pg[j].zero();
        }
      }
    };
    int r = r0 + warp;
    if (PF && r < r1) load_row(xv, gv, mu_r, rs_r, r);
    for (; r < r1; r += kWarps) {
      if constexpr (PF) {
        if (r + kWarps < r1) load_row(xn, gn, mu_n, rs_n, r + kWarps);
      } else {
        load_row(xv, gv, mu_r, rs_r, r);
      }
      const long long off = (long long)r * d;
      float m1, m2;
      if (windows == 1) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int c = c0 + V * lane + 32 * V * j;
          if (c < d) {
            float wv[V];
            load_w<V>(w + c, wv);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float dyg = gv[j][e] * wv[e];
              s1 += dyg;
              s2 += dyg * ((xv[j][e] - mu_r) * rs_r);
            }
          }
        }
        m1 = warp_sum(s1) * inv_d;
        m2 = warp_sum(s2) * inv_d;
      } else {
        m1 = stats[r];
        m2 = stats[n + r];
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c = c0 + V * lane + 32 * V * j;
        if (c < d) {
          float wv[V], o[V];
          load_w<V>(w + c, wv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float g = gv[j][e], yhat = (xv[j][e] - mu_r) * rs_r;
            o[e] = rs_r * (g * wv[e] - m1 - yhat * m2);
            pw[j][e] += g * yhat;
            pb[j][e] += g;
          }
          store_v<V>(dx + off + c, o);
        }
      }
      if constexpr (PF) {
#pragma unroll
        for (int j = 0; j < CH; ++j) xv[j] = xn[j], gv[j] = gn[j];
        mu_r = mu_n, rs_r = rs_n;
      }
    }
    // the block's partials of the window: each warp's into shared memory,
    // then added in warp order
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = V * lane + 32 * V * j + e;
        if (c0 + i < d) {
          red[(2 * warp) * span + i] = pw[j][e];
          red[(2 * warp + 1) * span + i] = pb[j][e];
        }
      }
    __syncthreads();
    for (int i = threadIdx.x; i < span && c0 + i < d; i += kThreads) {
      float sw = 0.f, sb = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        sw += red[(2 * q) * span + i];
        sb += red[(2 * q + 1) * span + i];
      }
      part[(long long)blockIdx.x * d + c0 + i] = sw;
      part[((long long)blocks + blockIdx.x) * d + c0 + i] = sb;
    }
    __syncthreads();
  }
}

// dw, db [D]: the blocks' partials of each column added in a fixed order. A
// block of kReduceWarps warps takes 32 columns; warp k adds the partial
// rows k, k + kReduceWarps, ... in order, and the warps' sums are added in
// warp order.
constexpr int kReduceWarps = 32;
__global__ void __launch_bounds__(32 * kReduceWarps)
layernorm_bwd_reduce_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                            float* __restrict__ dw, float* __restrict__ db, int tiles, int d) {
  __shared__ float s_w[kReduceWarps][kReduceCols], s_b[kReduceWarps][kReduceCols];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * kReduceCols + lane;
  float aw = 0.f, ab = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int t = warp; t < tiles; t += kReduceWarps) {
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
    for (int k = 0; k < kReduceWarps; ++k) {
      sw += s_w[k][lane];
      sb += s_b[k][lane];
    }
    dw[col] = sw;
    db[col] = sb;
  }
}

template <typename T, int V, int CH, bool PF>
cudaError_t fwd(const void* x, const void* w, const void* b, void* y, float* mu, float* rs, int n,
                int d, float eps, int blocks, int wb, cudaStream_t stream) {
  layernorm_fwd_kernel<T, V, CH, PF><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), mu, rs, n, d, eps, blocks, wb);
  return cudaGetLastError();
}

// 16-byte loads where every row, w and b start 16-byte aligned (bf16: 3
// chunks a lane with the next row in flight up to 768 columns, else 4; f32:
// 6 with the next row), else one value a load (24 a lane)
template <typename T>
cudaError_t fwd_launch(const void* x, const void* w, const void* b, void* y, float* mu, float* rs,
                       int n, int d, float eps, int blocks, int wb, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec) {
    if constexpr (V == 8) {
      if (d <= 768) return fwd<T, V, 3, true>(x, w, b, y, mu, rs, n, d, eps, blocks, wb, stream);
      return fwd<T, V, 4, false>(x, w, b, y, mu, rs, n, d, eps, blocks, wb, stream);
    } else {
      return fwd<T, V, 6, true>(x, w, b, y, mu, rs, n, d, eps, blocks, wb, stream);
    }
  }
  return fwd<T, 1, 24, false>(x, w, b, y, mu, rs, n, d, eps, blocks, wb, stream);
}

template <typename T, int V, int CH, bool PF>
cudaError_t bwd(const void* x, const void* dy, const float* w, const float* mu, const float* rs,
                void* dx, float* dw, float* db, float* work, int n, int d, int blocks,
                cudaStream_t stream) {
  constexpr int W = 32 * V * CH;
  const int smem = 2 * kWarps * (d < W ? d : W) * 4;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      layernorm_bwd_kernel<T, V, CH, PF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * kWarps * W * 4);
  if (opt_in != cudaSuccess) return opt_in;
  float* part = work;
  float* stats = work + 2LL * blocks * d;
  layernorm_bwd_kernel<T, V, CH, PF><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), w, mu, rs, static_cast<T*>(dx), part,
      stats, n, d, blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layernorm_bwd_reduce_kernel<<<(d + kReduceCols - 1) / kReduceCols, 32 * kReduceWarps, 0,
                                stream>>>(part, part + (long long)blocks * d, dw, db, blocks, d);
  return cudaGetLastError();
}

// 16-byte loads where every row starts 16-byte aligned (bf16: 3 chunks a
// lane with the next row in flight up to 768 columns, else 4; f32: 6),
// else one value a load
template <typename T>
cudaError_t bwd_launch(const void* x, const void* dy, const float* w, const float* mu,
                       const float* rs, void* dx, float* dw, float* db, float* work, int n,
                       int d, int blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if constexpr (V == 8)
    if (vec && d <= 768)
      return bwd<T, V, 3, true>(x, dy, w, mu, rs, dx, dw, db, work, n, d, blocks, stream);
  if (vec)
    return bwd<T, V, V == 8 ? 4 : 6, false>(x, dy, w, mu, rs, dx, dw, db, work, n, d, blocks,
                                            stream);
  return bwd<T, 1, 24, false>(x, dy, w, mu, rs, dx, dw, db, work, n, d, blocks, stream);
}

}  // namespace

extern "C" {

// x [n, d] contiguous (dtype 0 = float32, 1 = bfloat16); weight and bias
// [d] in wdtype and bdtype (0 = float32, 1 = bfloat16; bias may be null) ->
// y [n, d] in x's dtype, mu and rstd [n] float32. blocks: the grid, 1 <=
// blocks <= max(n, 1), each over a contiguous band of rows. Returns the
// cudaError_t of the launch.
int lamp_layernorm_fwd(const void* x, const void* weight, const void* bias, void* y, void* mu,
                       void* rstd, int n, int d, float eps, int dtype, int wdtype, int bdtype,
                       int blocks, void* stream) {
  if (n < 0 || d < 0 || blocks < 1 || blocks > (n > 1 ? n : 1) || wdtype < 0 || wdtype > 1 ||
      bdtype < 0 || bdtype > 1)
    return cudaErrorInvalidValue;
  if (n == 0 || d == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  const int wb = wdtype | bdtype << 1;
  if (dtype == 0) return fwd_launch<float>(x, weight, bias, y, m, r, n, d, eps, blocks, wb, st);
  if (dtype == 1)
    return fwd_launch<__nv_bfloat16>(x, weight, bias, y, m, r, n, d, eps, blocks, wb, st);
  return cudaErrorInvalidValue;
}

// x, dy [n, d] contiguous in one dtype (0 = float32, 1 = bfloat16); weight
// [d], mu, rstd [n] float32 -> dx [n, d] in x's dtype, dweight and dbias
// [d] float32. blocks: the persistent grid, 1 <= blocks <= max(n, 1);
// workspace: 2 * blocks * d float32, and 2 * n more where d > 768.
// Returns the cudaError_t of the first launch that failed.
int lamp_layernorm_bwd(const void* x, const void* dy, const void* weight, const void* mu,
                       const void* rstd, void* dx, void* dweight, void* dbias, void* workspace,
                       int n, int d, int blocks, int dtype, void* stream) {
  if (n < 0 || d < 0 || blocks < 1 || blocks > (n > 1 ? n : 1)) return cudaErrorInvalidValue;
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
  if (dtype == 0) return bwd_launch<float>(x, dy, w, m, r, dx, dw, db, work, n, d, blocks, st);
  if (dtype == 1)
    return bwd_launch<__nv_bfloat16>(x, dy, w, m, r, dx, dw, db, work, n, d, blocks, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
