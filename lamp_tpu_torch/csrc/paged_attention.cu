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
// fp8 pools (float8_e4m3fn or float8_e5m2, with a bf16 or f32 q) halve those
// bytes against bf16. The kernel is templated on the pool's type: K rows
// come in by the same 16-byte loads (16 fp8 values each), V pairs by 2-byte
// loads, and every value converts to f32 exactly (each fp8 value is exact in
// bf16), which is the TPU kernel's upcast before its dots. q, the append
// rows and the output stay in q's dtype.
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
// Per block (grid = B x H_kv, 128 threads): walk keys from the first token of
// the sliding-window band to lengths[b] in tiles of 128 tokens. Each tile:
//   A. one thread per token: resolve its page, score it against all q_per_kv
//      query heads (16-byte vector loads of the K row);
//   B. one warp per query head: tile max, online-softmax rescale (f32 m, l);
//   C. threads split D into element pairs and the tile's tokens into
//      interleaved subsets; each accumulates p * V for all query heads.
// Then the subsets are summed, the append_kv column is added as one more
// online-softmax step, and the result is divided by l. Rows with no valid
// key (length 0 and no append) give exactly 0.
//
// Not carried over from the TPU kernel: grouping G sequences per grid cell,
// single_pass, the cross-cell DMA parity counter and pages_per_block were
// devices for the TPU's sequential grid and its MXU; offsets are int64
// because (page_offset + page) * page_stride passes 2^31 elements at serving
// pool sizes.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// dtype: q's (and new_k/new_v's and out's): 0 = float32, 1 = bfloat16.
// kv_dtype: the pools': 0 = float32, 1 = bfloat16 (each only with a q of the
// same dtype), 2 = float8_e4m3fn, 3 = float8_e5m2 (with either q dtype).
// Returns the cudaError_t of the launch; the caller raises on non-zero.
int lamp_paged_attention(const void* q, const void* k, const void* v,
                         const void* new_k, const void* new_v, const void* page_table,
                         const void* lengths, const void* windows, void* out,
                         int batch, int num_heads, int num_kv_heads, int head_dim,
                         int page_size, int pages_per_seq, long long page_stride,
                         long long page_offset, int static_window, float sm_scale,
                         int dtype, int kv_dtype, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      num_heads / num_kv_heads > kMaxQ)
    return cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  const int* wn = static_cast<const int*>(windows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAMP_PA_LAUNCH(T, KV, D)                                                   \
  return launch<T, KV, D>(q, k, v, new_k, new_v, pt, ln, wn, out, batch, num_heads, \
                          num_kv_heads, page_size, pages_per_seq, page_stride,     \
                          page_offset, static_window, sm_scale, st)
#define LAMP_PA_DIMS(T, KV)                          \
  if (head_dim == 64) LAMP_PA_LAUNCH(T, KV, 64);     \
  if (head_dim == 128) LAMP_PA_LAUNCH(T, KV, 128);   \
  return cudaErrorInvalidValue
  if (dtype == 1 && kv_dtype == 1) { LAMP_PA_DIMS(__nv_bfloat16, __nv_bfloat16); }
  if (dtype == 0 && kv_dtype == 0) { LAMP_PA_DIMS(float, float); }
  if (dtype == 1 && kv_dtype == 2) { LAMP_PA_DIMS(__nv_bfloat16, __nv_fp8_e4m3); }
  if (dtype == 1 && kv_dtype == 3) { LAMP_PA_DIMS(__nv_bfloat16, __nv_fp8_e5m2); }
  if (dtype == 0 && kv_dtype == 2) { LAMP_PA_DIMS(float, __nv_fp8_e4m3); }
  if (dtype == 0 && kv_dtype == 3) { LAMP_PA_DIMS(float, __nv_fp8_e5m2); }
#undef LAMP_PA_DIMS
#undef LAMP_PA_LAUNCH
  return cudaErrorInvalidValue;
}

const char* lamp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
