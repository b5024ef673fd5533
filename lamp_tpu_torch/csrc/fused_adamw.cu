// Fused AdamW update with stochastic rounding to bf16, for Hopper (sm_90a).
//
// Replaces lamp_tpu/ops/fused_adamw.py:_kernel (the Pallas TPU kernel behind
// fused_adamw_update and AdamWStochastic). Per element, in f32:
//   m   = b1 m + (1 - b1) g
//   v   = b2 v + ((1 - b2) g) g
//   upd = (lr (m / bc1)) / (sqrt(v / bc2) + eps) + (lr wd) p
//   p   = p - upd
// with bc1, bc2 = 1 - exp(f32(t) log b) computed once per step on the host
// and passed in, as are lr and lr wd in f32. Every operation is a separately
// rounded IEEE one (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), never a
// contraction into FMA, so that the plain PyTorch version
// (fused_adamw_update_reference: one tensor op per line) gives the same
// p, m and v bit for bit.
//
// Rounding: a bf16 parameter under stochastic=1 takes the f32 bit pattern
// plus the low 16 bits of a random word, truncated to its top 16 bits (what
// pltpu.stochastic_round does); otherwise bf16 and f16 round to nearest even
// and f32 is stored as it is. The random word of element i (its flat index
// in its tensor, 64-bit) under the tensor's seed at step t is
//   h(lo32(i) ^ h(hi32(i) ^ h(seed ^ h(t)))),
// h the lowbias32 integer hash of csrc/quantize_int8.cu. It depends on
// (seed, t, i) only, never on the tiling (the TPU kernel reseeds its PRNG
// per 1024-row block), so it is not the TPU's stream.
//
// What bounds it: bytes. A bf16 parameter moves 22 bytes (p, g, m, v read;
// p, m, v written) for ~25 flops. One launch updates a table of up to
// kMaxTensors tensors of one dtype, passed by value as the kernel's
// parameter block (a __grid_constant__ struct of 12 KB; CUDA 12.1+ takes up
// to 32 KB), so that an optimizer step over a model's 200-odd tensors is one
// launch and not one per tensor. Each thread updates one 16-byte vector of
// p (8 bf16/f16 or 4 f32) with vector loads of p, g, m and v; a block of 256
// threads covers 256 vectors of one tensor, and finds its tensor by a binary
// search over the table's first-block offsets. A tensor's tail, or a tensor
// not 16-byte aligned, takes the scalar path.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 256;

struct Entry {
  unsigned long long p, g, m, v;  // device pointers
  long long n;                    // elements
  unsigned seed;
  unsigned block0;  // first block of this tensor in the grid
};

struct Table {
  Entry e[kMaxTensors];
};

struct Scalars {
  float lr, lrwd, b1, c1, b2, c2, bc1, bc2, eps;
  unsigned step;
  int count;
  int stochastic;
};

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// the f32 update of one element; m and v in place, returns the new p
__device__ __forceinline__ float adamw(float p, float g, float& m, float& v, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.c1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.c2, g), g));
  const float step = __fmul_rn(s.lr, __fdiv_rn(m, s.bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
  const float upd = __fadd_rn(__fdiv_rn(step, den), __fmul_rn(s.lrwd, p));
  return __fsub_rn(p, upd);
}

template <typename T>
__device__ __forceinline__ T round_out(float x, uint32_t key, long long i, int stochastic);

template <>
__device__ __forceinline__ float round_out<float>(float x, uint32_t, long long, int) {
  return x;
}

template <>
__device__ __forceinline__ __half round_out<__half>(float x, uint32_t, long long, int) {
  return __float2half_rn(x);
}

template <>
__device__ __forceinline__ __nv_bfloat16 round_out<__nv_bfloat16>(float x, uint32_t key,
                                                                 long long i, int stochastic) {
  if (!stochastic) return __float2bfloat16_rn(x);
  const uint32_t word =
      lowbias32((uint32_t)i ^ lowbias32((uint32_t)((unsigned long long)i >> 32) ^ key));
  const uint32_t bits = __float_as_uint(x) + (word & 0xFFFFu);
  return __ushort_as_bfloat16((unsigned short)(bits >> 16));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const __grid_constant__ Table table, const Scalars s) {
  constexpr int V = 16 / sizeof(T);  // elements of p in one 16-byte vector
  // the tensor of this block: the last entry whose first block <= blockIdx.x
  int lo = 0, hi = s.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.e[mid].block0 <= blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const Entry& e = table.e[lo];
  const long long base = ((long long)(blockIdx.x - e.block0) * kThreads + threadIdx.x) * V;
  if (base >= e.n) return;
  T* p = reinterpret_cast<T*>(e.p);
  const T* g = reinterpret_cast<const T*>(e.g);
  float* m = reinterpret_cast<float*>(e.m);
  float* v = reinterpret_cast<float*>(e.v);
  const uint32_t key = lowbias32(e.seed ^ lowbias32(s.step));
  const bool aligned = ((e.p | e.g | e.m | e.v) & 15ull) == 0;

  if (aligned && base + V <= e.n) {
    uint4 praw = *reinterpret_cast<const uint4*>(p + base);
    const uint4 graw = __ldg(reinterpret_cast<const uint4*>(g + base));
    float mv[V], vv[V];
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 m4 = *reinterpret_cast<const float4*>(m + base + j);
      const float4 v4 = *reinterpret_cast<const float4*>(v + base + j);
      mv[j] = m4.x; mv[j + 1] = m4.y; mv[j + 2] = m4.z; mv[j + 3] = m4.w;
      vv[j] = v4.x; vv[j + 1] = v4.y; vv[j + 2] = v4.z; vv[j + 3] = v4.w;
    }
    T* pe = reinterpret_cast<T*>(&praw);
    const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float np = adamw(to_float(pe[j]), to_float(ge[j]), mv[j], vv[j], s);
      pe[j] = round_out<T>(np, key, base + j, s.stochastic);
    }
    *reinterpret_cast<uint4*>(p + base) = praw;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      *reinterpret_cast<float4*>(m + base + j) = make_float4(mv[j], mv[j + 1], mv[j + 2], mv[j + 3]);
      *reinterpret_cast<float4*>(v + base + j) = make_float4(vv[j], vv[j + 1], vv[j + 2], vv[j + 3]);
    }
  } else {
    const long long end = base + V < e.n ? base + V : e.n;
    for (long long i = base; i < end; ++i) {
      float mi = m[i], vi = v[i];
      const float np = adamw(to_float(p[i]), to_float(g[i]), mi, vi, s);
      p[i] = round_out<T>(np, key, i, s.stochastic);
      m[i] = mi;
      v[i] = vi;
    }
  }
}

template <typename T>
cudaError_t launch(const long long* rows, int count, const Scalars& sc, cudaStream_t stream) {
  constexpr long long kPerBlock = (long long)kThreads * (16 / sizeof(T));
  Table table;
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    const long long* r = rows + 6 * k;
    Entry& e = table.e[k];
    e.p = (unsigned long long)r[0];
    e.g = (unsigned long long)r[1];
    e.m = (unsigned long long)r[2];
    e.v = (unsigned long long)r[3];
    e.n = r[4];
    e.seed = (unsigned)r[5];
    e.block0 = (unsigned)blocks;
    if (e.n < 0) return cudaErrorInvalidValue;
    blocks += (e.n + kPerBlock - 1) / kPerBlock;
    if (blocks > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  }
  if (blocks == 0) return cudaSuccess;
  fused_adamw_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(table, sc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows: count x 6 int64 in host memory, one row per tensor: p, g, m, v
// (device pointers; p and g of dtype 0 = float32, 1 = bfloat16, 2 =
// float16, m and v float32, all contiguous), n (elements) and seed. Updates
// p, m and v in place in one launch. count <= 256. Returns the cudaError_t
// of the launch.
int lamp_fused_adamw(const long long* rows, int count, int dtype, float lr, float lrwd, float b1,
                     float c1, float b2, float c2, float bc1, float bc2, float eps,
                     unsigned int step, int stochastic, void* stream) {
  if (count == 0) return cudaSuccess;
  if (count < 0 || count > kMaxTensors) return cudaErrorInvalidValue;
  const Scalars sc{lr, lrwd, b1, c1, b2, c2, bc1, bc2, eps, step, count, stochastic};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(rows, count, sc, st);
  if (dtype == 1) return launch<__nv_bfloat16>(rows, count, sc, st);
  if (dtype == 2) return launch<__half>(rows, count, sc, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
