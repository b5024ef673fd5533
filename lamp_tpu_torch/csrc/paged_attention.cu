// Paged decode attention for Hopper (sm_90a).
//
// Replaces lamp_tpu/ops/paged_attention.py:_paged_kernel (the Pallas TPU
// kernel). One query token per sequence attends over its KV history, which
// lives in fixed-size pages of a shared pool, addressed through a page table.
//
// What bounds it: KV bytes read. One decode step reads, per layer,
// B x live tokens x 2 (K and V) x F x 2 bytes (bf16, F = H_kv * D) and does
// only ~2 * q_per_kv FLOPs per byte, far below the card's ~295 FLOP/byte
// ridge. The design therefore reads each K/V row from device memory exactly
// once per kv head, not once per query head: a block owns one (sequence,
// kv head) pair and scores every query head of the GQA group against each
// row it loads.
//
// fp8 pools (float8_e4m3fn or float8_e5m2, with a float32, bfloat16 or
// float16 q) halve those bytes against 16-bit pools. The kernels are
// templated on the pool's type, and every value converts to f32 exactly
// (each fp8 value is exact in bf16), which is the TPU kernel's upcast
// before its dots. q, the append rows and the output stay in q's dtype.
//
// Layout (the JAX package's, unchanged):
//   q          [B, H, D]
//   K/V pool   row (page p, slot s, kv head g) at p*page_stride + s*F + g*D;
//              the fused pool [P, 2, page, F] passes V = K + page*F and
//              page_stride = 2*page*F, split pools page_stride = page*F
//   page_table [B, pages_per_seq] int32, lengths [B] int32
//   windows    [B] int32 per-request limits (<= 0: none), or null
//   new_k/new_v [B, F] current token's K/V (append mode), or null
//   out        [B, H, D] in q's dtype
//   (q, new_k, new_v and out share one dtype T; the pools have type KV,
//   which is T or an fp8 type)
//
// Two kernels compute the same function.
//
// paged_attention_kernel<T, KV, D>, for D = 64 or 128 and at most 8 query
// heads per kv head (the serving slice's shapes): grid = B x H_kv, 128
// threads. Walk keys from the first token of the sliding-window band to
// lengths[b] in tiles of 128 tokens. Each tile:
//   A. one thread per token: resolve its page, score it against all q_per_kv
//      query heads (16-byte vector loads of the K row, scores in registers);
//   B. one warp per query head: tile max, online-softmax rescale (f32 m, l);
//   C. threads split D into element pairs and the tile's tokens into
//      interleaved subsets; each accumulates p * V for all query heads.
// Then the subsets are summed, the append_kv column is added as one more
// online-softmax step, and the result is divided by l.
//
// paged_attention_any<T, KV, A>, for every other head dim (any D, also
// odd), group (any number of query heads per kv head) and float64 (A, the
// accumulators' type, is double there and f32 otherwise): the same walk in
// tiles of 64 tokens, with everything that grows with D or the group in
// dynamic shared memory (opted in above 48 KB) instead of registers and
// static arrays. Per tile, the K rows are staged in shared memory segment
// by segment (at most 512 bytes of a row at a time), each row read from
// device memory once, by loads as wide as the head slice's alignment
// allows (cp.async of each 4-byte word when the head slice is 4-byte
// aligned, as a bf16 head of 100 at 8-byte offsets and an fp8 one at
// 4-byte offsets are; 2- or 1-byte copies at odd D); every (query head,
// token) score sums that row against q. Phase B is as above.
// Then the V rows are staged the same way and every (query head, column)
// of the output accumulates p * V over the tile's tokens in order, in A
// in shared memory: one sum a value, no split over token subsets, so the
// result does not depend on D. A block computes the query heads and
// output columns that fit in shared memory: up to 256 columns (more are
// split over blockIdx.z, and each part reads the K rows again) and every
// query head of the group while q_per_kv x (64 scores + a q segment + the
// output columns + 4) values of A and the staged rows fit in 227 KB (128
// query heads at D = 128 in f32 take 183,040 bytes); a larger group is
// split over blockIdx.z too. The usual shapes run in one part, reading
// each K/V row once.
// Rows with no valid key (length 0 and no append) give exactly 0.
//
// Not carried over from the TPU kernel: grouping G sequences per grid cell,
// single_pass, the cross-cell DMA parity counter and pages_per_block were
// devices for the TPU's sequential grid and its MXU; offsets are int64
// because (page_offset + page) * page_stride passes 2^31 elements at serving
// pool sizes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // one token per thread in phase A
constexpr int kTile = kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 8;  // query heads per kv head
constexpr int kNoWindow = 0x3FFFFFFF;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// fp8 pools: every e4m3 and e5m2 value converts to f32 exactly
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) { return static_cast<float>(x); }
__device__ __forceinline__ float2 load2(const __nv_fp8_e4m3* p) {
  return static_cast<float2>(*reinterpret_cast<const __nv_fp8x2_e4m3*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_fp8_e5m2* p) {
  return static_cast<float2>(*reinterpret_cast<const __nv_fp8x2_e5m2*>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v, const T* __restrict__ new_k,
                       const T* __restrict__ new_v,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       const int* __restrict__ windows, T* __restrict__ out,
                       int num_heads, int num_kv_heads, int page_size,
                       int pages_per_seq, long long page_stride,
                       long long page_offset, int static_window,
                       float sm_scale) {
  constexpr int kVec = 16 / sizeof(KV);     // elements per 16-byte load
  constexpr int kPairs = D / 2;             // phase C: element pairs of a row
  constexpr int kSub = kThreads / kPairs;   // phase C: token subsets

  __shared__ float q_s[kMaxQ][D];
  __shared__ float s_s[kMaxQ][kTile];       // scores, then probabilities
  __shared__ long long row_s[kTile];        // element offset of each K/V row
  __shared__ float red_s[kSub][kMaxQ][D];
  __shared__ float m_s[kMaxQ], l_s[kMaxQ], alpha_s[kMaxQ], snew_s[kMaxQ];

  const int b = blockIdx.x;
  const int g = blockIdx.y;  // kv head
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int qpk = num_heads / num_kv_heads;
  const int F = num_kv_heads * D;
  const bool append = new_k != nullptr;

  // key band [lo, hi): the tighter of the static and per-request windows;
  // in append mode the new token takes one place of the band
  const int len = lengths[b];
  const int hi = min(len, pages_per_seq * page_size);
  int w = kNoWindow;
  if (windows != nullptr && windows[b] > 0) w = windows[b];
  if (static_window > 0) w = min(w, static_window);
  const int w_old = append ? max(w - 1, 0) : w;
  const int lo = max(len - w_old, 0);

  const T* q_row = q + ((long long)b * num_heads + (long long)g * qpk) * D;
  for (int i = tid; i < qpk * D; i += kThreads) q_s[i / D][i % D] = to_float(q_row[i]);
  if (tid < kMaxQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int dp = tid % kPairs, sub = tid / kPairs;
  float acc[kMaxQ][2];
#pragma unroll
  for (int h = 0; h < kMaxQ; ++h) acc[h][0] = acc[h][1] = 0.f;
  __syncthreads();

  const int* table = page_table + (long long)b * pages_per_seq;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    // A: one thread per token scores it against every query head
    if (tid < n) {
      const int tok = t0 + tid;
      const long long phys = (long long)table[tok / page_size] + page_offset;
      const long long row =
          phys * page_stride + (long long)(tok % page_size) * F + (long long)g * D;
      row_s[tid] = row;
      const uint4* kr = reinterpret_cast<const uint4*>(k + row);
      float s[kMaxQ];
#pragma unroll
      for (int h = 0; h < kMaxQ; ++h) s[h] = 0.f;
#pragma unroll
      for (int c = 0; c < D / kVec; ++c) {
        const uint4 raw = __ldg(kr + c);
        const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float kf = to_float(e[j]);
#pragma unroll
          for (int h = 0; h < kMaxQ; ++h)
            if (h < qpk) s[h] = fmaf(q_s[h][c * kVec + j], kf, s[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < kMaxQ; ++h)
        if (h < qpk) s_s[h][tid] = s[h] * sm_scale;
    }
    __syncthreads();
    // B: one warp per query head: online-softmax update
    for (int h = warp; h < qpk; h += kWarps) {
      float x[kTile / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTile / 32; ++j) {
        const int i = lane + 32 * j;
        x[j] = i < n ? s_s[h][i] : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      mx = warp_max(mx);  // finite: every tile holds >= 1 key of the band
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTile / 32; ++j) {
        const int i = lane + 32 * j;
        const float p = i < n ? expf(x[j] - m_new) : 0.f;
        if (i < n) s_s[h][i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + sum;
        alpha_s[h] = alpha;
      }
    }
    __syncthreads();
    // C: o = o * alpha + p @ V, one element pair and one token subset each
#pragma unroll
    for (int h = 0; h < kMaxQ; ++h) {
      if (h < qpk) {
        acc[h][0] *= alpha_s[h];
        acc[h][1] *= alpha_s[h];
      }
    }
#pragma unroll 4
    for (int j = sub; j < n; j += kSub) {
      const float2 vv = load2(v + row_s[j] + 2 * dp);
#pragma unroll
      for (int h = 0; h < kMaxQ; ++h) {
        if (h < qpk) {
          const float p = s_s[h][j];
          acc[h][0] = fmaf(p, vv.x, acc[h][0]);
          acc[h][1] = fmaf(p, vv.y, acc[h][1]);
        }
      }
    }
    __syncthreads();  // s_s and row_s are rewritten by the next tile
  }

#pragma unroll
  for (int h = 0; h < kMaxQ; ++h) {
    if (h < qpk) {
      red_s[sub][h][2 * dp] = acc[h][0];
      red_s[sub][h][2 * dp + 1] = acc[h][1];
    }
  }
  const long long kv_row = (long long)b * F + (long long)g * D;
  if (append) {
    // the current token's score, one warp per query head
    for (int h = warp; h < qpk; h += kWarps) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += q_s[h][d] * to_float(new_k[kv_row + d]);
      part = warp_sum(part);
      if (lane == 0) snew_s[h] = part * sm_scale;
    }
  }
  __syncthreads();

  T* out_row = out + ((long long)b * num_heads + (long long)g * qpk) * D;
  for (int i = tid; i < qpk * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) o += red_s[s][h][d];
    float l = l_s[h];
    if (append) {
      // one more online-softmax column: always visible to its own query
      const float m = m_s[h], sn = snew_s[h];
      const float mf = fmaxf(m, sn);
      const float alpha = expf(m - mf), pn = expf(sn - mf);
      l = l * alpha + pn;
      o = o * alpha + pn * to_float(new_v[kv_row + d]);
    }
    store(out_row + i, l == 0.f ? 0.f : o / l);
  }
}

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* new_k,
                   const void* new_v, const int* page_table, const int* lengths,
                   const int* windows, void* out, int batch, int num_heads,
                   int num_kv_heads, int page_size, int pages_per_seq,
                   long long page_stride, long long page_offset, int static_window,
                   float sm_scale, cudaStream_t stream) {
  dim3 grid(batch, num_kv_heads);
  paged_attention_kernel<T, KV, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const T*>(new_k), static_cast<const T*>(new_v), page_table, lengths,
      windows, static_cast<T*>(out), num_heads, num_kv_heads, page_size, pages_per_seq,
      page_stride, page_offset, static_window, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// paged_attention_any: every head dim and every group (see the header)
// ---------------------------------------------------------------------------

// accumulator arithmetic: f32, or f64 for float64 inputs
template <typename A, typename X>
__device__ __forceinline__ A to_acc(X x) {
  if constexpr (std::is_same<X, double>::value) return x;
  else return to_float(x);
}
__device__ __forceinline__ float amax(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double amax(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ float afma(float x, float y, float z) { return fmaf(x, y, z); }
__device__ __forceinline__ double afma(double x, double y, double z) { return fma(x, y, z); }
__device__ __forceinline__ float aexp(float x) { return expf(x); }
__device__ __forceinline__ double aexp(double x) { return exp(x); }
__device__ __forceinline__ void store(double* p, double x) { *p = x; }

constexpr int kAnyTile = 64;  // tokens a tile
// the largest dynamic shared memory a block may opt into on an H100
constexpr int kSmemMax = 227 * 1024;

// One segment of `len` elements, from element d0 on, of the rows row_s[0 ..
// n) of `src` into `dst` (a row every rw 4-byte words); vb (4, 2 or 1
// bytes) divides the segment's bytes and its offset, which the host
// ensures. At vb = 4 every 4-byte word is one cp.async, all in flight at
// once (the rows' stride, an odd number of elements' widths that keeps
// phase A's reads of one row a thread free of bank conflicts, leaves
// 16-bit and 8-bit rows only 4-byte aligned); below, a plain copy of 2 or
// 1 bytes at a time.
template <typename KV>
__device__ __forceinline__ void stage_rows(uint32_t* dst, const KV* src,
                                           const long long* row_s, int n,
                                           int d0, int len, int vb, int rw) {
  const int bytes = len * static_cast<int>(sizeof(KV));
  if (vb == 4) {
    const int words = bytes / 4;
    for (int i = threadIdx.x; i < n * words; i += kThreads) {
      const int j = i / words, c = i % words;
      const uint32_t* g = reinterpret_cast<const uint32_t*>(src + row_s[j] + d0) + c;
      const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst + j * rw + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g));
    }
    asm volatile("cp.async.wait_all;\n" ::);
    return;
  }
  const int chunks = bytes / vb;
  unsigned char* db = reinterpret_cast<unsigned char*>(dst);
  for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
    const int j = i / chunks, c = i % chunks;
    const unsigned char* g =
        reinterpret_cast<const unsigned char*>(src + row_s[j] + d0) + c * vb;
    unsigned char* d = db + j * rw * 4 + c * vb;
    if (vb == 2)
      *reinterpret_cast<unsigned short*>(d) =
          __ldg(reinterpret_cast<const unsigned short*>(g));
    else
      *d = *g;
  }
}

// grid = B x H_kv x (passes * chunks): blockIdx.z picks the pass (qh query
// heads of the group) and the chunk (dout output columns).
// Dynamic shared memory, in this order: the tile's row offsets, scores [qh]
// [kAnyTile], q's segment [qh][seg], the output [qh][dout], m, l, alpha and
// the append score [qh] each, and the staged rows [kAnyTile][rw words].
template <typename T, typename KV, typename A>
__global__ void __launch_bounds__(kThreads)
paged_attention_any(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const T* __restrict__ new_k,
                    const T* __restrict__ new_v,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const int* __restrict__ windows, T* __restrict__ out,
                    int num_heads, int num_kv_heads, int D, int page_size,
                    int pages_per_seq, long long page_stride,
                    long long page_offset, int static_window, A sm_scale,
                    int qh, int chunks, int seg, int dout, int vb, int rw) {
  extern __shared__ __align__(16) unsigned char smem_any[];
  long long* row_s = reinterpret_cast<long long*>(smem_any);
  A* s_s = reinterpret_cast<A*>(row_s + kAnyTile);
  A* q_s = s_s + qh * kAnyTile;
  A* o_s = q_s + qh * seg;
  A* m_s = o_s + qh * dout;
  A* l_s = m_s + qh;
  A* alpha_s = l_s + qh;
  A* snew_s = alpha_s + qh;
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(snew_s + qh);

  const int b = blockIdx.x;
  const int g = blockIdx.y;  // kv head
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int qpk = num_heads / num_kv_heads;
  const int h0 = (blockIdx.z / chunks) * qh;     // first head of the pass
  const int nh = min(qh, qpk - h0);
  const int c0 = (blockIdx.z % chunks) * dout;   // first output column
  const int nc = min(dout, D - c0);
  const long long F = (long long)num_kv_heads * D;
  const bool append = new_k != nullptr;

  // key band [lo, hi), as paged_attention_kernel
  const int len = lengths[b];
  const int hi = min(len, pages_per_seq * page_size);
  int w = kNoWindow;
  if (windows != nullptr && windows[b] > 0) w = windows[b];
  if (static_window > 0) w = min(w, static_window);
  const int w_old = append ? max(w - 1, 0) : w;
  const int lo = max(len - w_old, 0);

  // the pass's query rows: head h of the pass at q_row + h * D
  const T* q_row = q + ((long long)b * num_heads + (long long)g * qpk + h0) * D;
  for (int i = tid; i < nh * nc; i += kThreads) o_s[(i / nc) * dout + i % nc] = A(0);
  for (int h = tid; h < nh; h += kThreads) {
    m_s[h] = A(-INFINITY);
    l_s[h] = A(0);
  }
  __syncthreads();

  const int* table = page_table + (long long)b * pages_per_seq;
  for (int t0 = lo; t0 < hi; t0 += kAnyTile) {
    const int n = min(kAnyTile, hi - t0);
    if (tid < n) {
      const int tok = t0 + tid;
      const long long phys = (long long)table[tok / page_size] + page_offset;
      row_s[tid] = phys * page_stride + (long long)(tok % page_size) * F +
                   (long long)g * D;
    }
    // A: scores of every (query head, token), D in segments of seg
    for (int d0 = 0; d0 < D; d0 += seg) {
      const int sl = min(seg, D - d0);
      __syncthreads();  // row_s written; the last segment's readers done
      stage_rows(rows_s, k, row_s, n, d0, sl, vb, rw);
      for (int i = tid; i < nh * sl; i += kThreads)
        q_s[(i / sl) * seg + i % sl] = to_acc<A>(q_row[(i / sl) * D + d0 + i % sl]);
      __syncthreads();
      for (int i = tid; i < nh * n; i += kThreads) {
        const int h = i / n, j = i % n;
        const KV* kr = reinterpret_cast<const KV*>(rows_s + j * rw);
        const A* qr = q_s + h * seg;
        A acc = 0;
        for (int e = 0; e < sl; ++e) acc = afma(qr[e], to_acc<A>(kr[e]), acc);
        A* s = s_s + h * kAnyTile + j;
        *s = d0 == 0 ? acc : *s + acc;
      }
    }
    __syncthreads();
    // B: one warp per query head: online-softmax update
    for (int h = warp; h < nh; h += kWarps) {
      A* sh = s_s + h * kAnyTile;
      A x[kAnyTile / 32];
      A mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kAnyTile / 32; ++j) {
        const int i = lane + 32 * j;
        x[j] = i < n ? sh[i] * sm_scale : A(-INFINITY);
        mx = amax(mx, x[j]);
      }
      mx = warp_max(mx);  // finite: every tile holds >= 1 key of the band
      const A m_old = m_s[h];
      const A m_new = amax(m_old, mx);
      const A alpha = aexp(m_old - m_new);  // 0 on the first tile
      A sum = 0;
#pragma unroll
      for (int j = 0; j < kAnyTile / 32; ++j) {
        const int i = lane + 32 * j;
        const A p = i < n ? aexp(x[j] - m_new) : A(0);
        if (i < n) sh[i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + sum;
        alpha_s[h] = alpha;
      }
    }
    // C: o = o * alpha + p @ V over this block's columns, one sum a value
    for (int d0 = c0; d0 < c0 + nc; d0 += seg) {
      const int sl = min(seg, c0 + nc - d0);
      __syncthreads();  // phase B done; the last segment's readers done
      stage_rows(rows_s, v, row_s, n, d0, sl, vb, rw);
      __syncthreads();
      for (int i = tid; i < nh * sl; i += kThreads) {
        const int h = i / sl, e = i % sl;
        const A* ph = s_s + h * kAnyTile;
        A* o = o_s + h * dout + (d0 - c0) + e;
        A acc = *o * alpha_s[h];
        for (int j = 0; j < n; ++j)
          acc = afma(ph[j], to_acc<A>(reinterpret_cast<const KV*>(rows_s + j * rw)[e]),
                     acc);
        *o = acc;
      }
    }
    __syncthreads();  // s_s, row_s and the rows are rewritten by the next tile
  }

  const long long kv_row = (long long)b * F + (long long)g * D;
  if (append) {
    // the current token's score over the whole head, one warp a query head
    for (int h = warp; h < nh; h += kWarps) {
      A part = 0;
      for (int d = lane; d < D; d += 32)
        part += to_acc<A>(q_row[(long long)h * D + d]) * to_acc<A>(new_k[kv_row + d]);
      part = warp_sum(part);
      if (lane == 0) snew_s[h] = part * sm_scale;
    }
  }
  __syncthreads();

  T* out_row = out + ((long long)b * num_heads + (long long)g * qpk + h0) * D;
  for (int i = tid; i < nh * nc; i += kThreads) {
    const int h = i / nc, d = c0 + i % nc;
    A o = o_s[h * dout + i % nc];
    A l = l_s[h];
    if (append) {
      // one more online-softmax column: always visible to its own query
      const A m = m_s[h], sn = snew_s[h];
      const A mf = amax(m, sn);
      const A alpha = aexp(m - mf), pn = aexp(sn - mf);
      l = l * alpha + pn;
      o = o * alpha + pn * to_acc<A>(new_v[kv_row + d]);
    }
    store(out_row + (long long)h * D + d, l == A(0) ? A(0) : o / l);
  }
}

// the largest of 4, 2 and 1 that divides x
int word_divisor(long long x) { return x % 4 == 0 ? 4 : x % 2 == 0 ? 2 : 1; }

template <typename T, typename KV>
cudaError_t launch_any(const void* q, const void* k, const void* v,
                       const void* new_k, const void* new_v,
                       const int* page_table, const int* lengths,
                       const int* windows, void* out, int batch, int num_heads,
                       int num_kv_heads, int D, int page_size,
                       int pages_per_seq, long long page_stride,
                       long long page_offset, int static_window,
                       double sm_scale, cudaStream_t stream) {
  // f32 accumulators, f64 for float64
  using A = typename std::conditional<std::is_same<T, double>::value, double,
                                      float>::type;
  const int sz = static_cast<int>(sizeof(KV));
  const int qpk = num_heads / num_kv_heads;
  // a row segment of at most 512 bytes, an output chunk of at most 256
  // columns; copies of the widest unit (4, 2 or 1 bytes) that every row
  // offset (a multiple of D elements), segment and chunk allow
  const int seg = D * sz <= 512 ? D : 512 / sz;
  const int dout = D < 256 ? D : 256;
  const int vb = std::min(word_divisor((long long)D * sz),
                          std::min(word_divisor((long long)seg * sz),
                                   word_divisor((long long)dout * sz)));
  // the row stride in 4-byte words: an odd number of elements' widths
  // (conflict-free row reads), each row aligned to its element (8 bytes
  // for float64)
  const int unit = sz == 8 ? 2 : 1;
  const int rw = unit * ((((seg * sz + 3) / 4 + unit - 1) / unit) | 1);
  const int fixed = kAnyTile * 8 + kAnyTile * rw * 4;
  const int per_head = (kAnyTile + seg + dout + 4) * static_cast<int>(sizeof(A));
  const int qh = std::min(qpk, (kSmemMax - fixed) / per_head);
  if (qh < 1) return cudaErrorInvalidValue;  // unreachable: seg, dout capped
  const int chunks = (D + dout - 1) / dout;
  const int passes = (qpk + qh - 1) / qh;
  const int smem = fixed + qh * per_head;
  auto kernel = paged_attention_any<T, KV, A>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(batch, num_kv_heads, passes * chunks);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const T*>(new_k), static_cast<const T*>(new_v), page_table, lengths,
      windows, static_cast<T*>(out), num_heads, num_kv_heads, D, page_size,
      pages_per_seq, page_stride, page_offset, static_window, static_cast<A>(sm_scale),
      qh, chunks,
      seg, dout, vb, rw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: q's (and new_k/new_v's and out's): 0 = float32, 1 = bfloat16,
// 2 = float16, 3 = float64. kv_dtype: the pools': 0 = float32, 1 =
// bfloat16, 4 = float16, 5 = float64 (each only with a q of the same
// dtype), 2 = float8_e4m3fn, 3 = float8_e5m2 (with a float32, bfloat16 or
// float16 q). float64 computes in double, in paged_attention_any. Any head_dim and any number of query
// heads per kv head: D = 64 or 128 with at most kMaxQ of them take
// paged_attention_kernel, everything else paged_attention_any.
// Returns the cudaError_t of the launch; the caller raises on non-zero.
int lamp_paged_attention(const void* q, const void* k, const void* v,
                         const void* new_k, const void* new_v, const void* page_table,
                         const void* lengths, const void* windows, void* out,
                         int batch, int num_heads, int num_kv_heads, int head_dim,
                         int page_size, int pages_per_seq, long long page_stride,
                         long long page_offset, int static_window, double sm_scale,
                         int dtype, int kv_dtype, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (num_kv_heads <= 0 || head_dim <= 0 || num_heads % num_kv_heads != 0)
    return cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  const int* wn = static_cast<const int*>(windows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fixed = num_heads / num_kv_heads <= kMaxQ;
#define LAMP_PA_LAUNCH(T, KV, D)                                                   \
  return launch<T, KV, D>(q, k, v, new_k, new_v, pt, ln, wn, out, batch, num_heads, \
                          num_kv_heads, page_size, pages_per_seq, page_stride,     \
                          page_offset, static_window, static_cast<float>(sm_scale), st)
#define LAMP_PA_DIMS(T, KV)                                                       \
  if (fixed && head_dim == 64) LAMP_PA_LAUNCH(T, KV, 64);                         \
  if (fixed && head_dim == 128) LAMP_PA_LAUNCH(T, KV, 128);                       \
  return launch_any<T, KV>(q, k, v, new_k, new_v, pt, ln, wn, out, batch,         \
                           num_heads, num_kv_heads, head_dim, page_size,          \
                           pages_per_seq, page_stride, page_offset, static_window, \
                           sm_scale, st)
  if (dtype == 1 && kv_dtype == 1) { LAMP_PA_DIMS(__nv_bfloat16, __nv_bfloat16); }
  if (dtype == 0 && kv_dtype == 0) { LAMP_PA_DIMS(float, float); }
  if (dtype == 2 && kv_dtype == 4) { LAMP_PA_DIMS(__half, __half); }
  if (dtype == 1 && kv_dtype == 2) { LAMP_PA_DIMS(__nv_bfloat16, __nv_fp8_e4m3); }
  if (dtype == 1 && kv_dtype == 3) { LAMP_PA_DIMS(__nv_bfloat16, __nv_fp8_e5m2); }
  if (dtype == 0 && kv_dtype == 2) { LAMP_PA_DIMS(float, __nv_fp8_e4m3); }
  if (dtype == 0 && kv_dtype == 3) { LAMP_PA_DIMS(float, __nv_fp8_e5m2); }
  if (dtype == 2 && kv_dtype == 2) { LAMP_PA_DIMS(__half, __nv_fp8_e4m3); }
  if (dtype == 2 && kv_dtype == 3) { LAMP_PA_DIMS(__half, __nv_fp8_e5m2); }
  if (dtype == 3 && kv_dtype == 5)
    return launch_any<double, double>(q, k, v, new_k, new_v, pt, ln, wn, out, batch,
                                      num_heads, num_kv_heads, head_dim, page_size,
                                      pages_per_seq, page_stride, page_offset,
                                      static_window, sm_scale, st);
#undef LAMP_PA_DIMS
#undef LAMP_PA_LAUNCH
  return cudaErrorInvalidValue;
}

const char* lamp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
