// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of lamp_tpu/ops/attention.py:
//   K1  _fwd_kernel (driven by _fwd)                 -> fwd_bf16 / fwd_f32
//   K2a _bwd_fused_kernel (driven by _bwd_fused)     -> dkv_* then dq_*
//   K2b _bwd_dq_kernel, K2c _bwd_dkv_kernel          -> dq_*, dkv_*
//   K3a/K3b _compact_{fwd,bwd}_kernel (compact_attention) compute the same
//   function on short sequences; here they are the same kernels.
//
// Layout: q, o, dq [B*H, Sq, D]; k, v, dk, dv [B*H, Skv, D]; lse, di
// [B*H, Sq] f32, all contiguous. Optional per-row kv limits: the limit of
// (batch b, row r) is limits[b * lim_bstride + r * lim_rstride] (strides
// (1, 0) for a [B] tensor, (Sq, 1) for [B, Sq]). A key c is visible to row r
// when c < min(Skv, limit) and, if causal, c <= r + (Skv - Sq) and, with a
// window w > 0, c > r + (Skv - Sq) - w. Rows with no visible key give o = 0,
// lse = -inf and zero gradients (the TPU kernel gives the mean of V when a
// tile ran, because its NEG_INF is finite).
//
// What bounds it: tensor-core operations. The causal forward does
// 2 * B * H * S^2 * D FLOPs (two products over half the score matrix):
// 51.5 GFLOP at the training slice's B=2, H=12, S=4096, D=64, 52 us at the
// H100's 989 TFLOP/s bf16 dense rate, against 25 MB of q/k/v/o (7.5 us at
// 3.35 TB/s). The backward needs 5 products' worth (128.8 GFLOP, 130 us).
//
// Design (FlashAttention-2 on mma.sync): bf16 operands with f32
// accumulation in m16n8k16 tensor-core products, as the TPU kernel's
// preferred_element_type=f32 dots; softmax statistics in f32.
//  - forward: one block of 4 warps per (b*h, 64-row q tile); each warp owns
//    16 query rows, keeps Q fragments, the f32 output accumulator and the
//    online-softmax max and sum in registers, and walks 64-key K/V tiles
//    staged in shared memory by cp.async, the next tile in flight while this
//    one is used; fragments come from shared memory by ldmatrix. Tiles
//    above the causal diagonal, below the window band or past every row's
//    kv limit are not visited (the TPU kernel's skipped grid steps), and
//    tiles wholly inside the band skip the per-element mask. P is rounded
//    to bf16 for P @ V, as p.astype(v.dtype) in the TPU kernel. The q tiles
//    run last-first, so the long causal rows start first.
//  - backward: the split design. A dkv kernel, one block per (b*h, 64-key
//    tile), walks the q tiles and accumulates dk and dv in registers; it
//    computes S^T = K Q^T and dP^T = V dO^T so that P^T and dS^T are already
//    A fragments of dV += P^T dO and dK += dS^T Q. A dq kernel, one block
//    per (b*h, 64-row q tile), walks the kv tiles. Both recompute
//    p = exp(s - lse); di = rowsum(o * do) comes in from outside, as in the
//    TPU package. This costs 7 products per tile pair against the fused
//    kernel's 5, but needs no partial-dq slab and no atomics, so it is
//    deterministic. P is rounded to do's dtype for dV and dS to q's dtype
//    for dK and dQ, as in _bwd_fused_kernel.
//  - float32 inputs take scalar kernels (one thread per row or key, f32
//    FMAs, no tensor cores): f32 is for checking, not for speed.
//  - ragged Sq and Skv are masked in the kernel: tile loads past the end
//    are zero-filled, rows and keys past the end are invisible, and stores
//    are guarded. Nothing is padded in device memory.
//
// Resources (ptxas -v for sm_90a), per block of 128 threads: fwd_bf16 134
// registers at D=64 and 178 at D=128, no spills, 45 / 85 KB of dynamic
// shared memory; dq_bf16 168 (8 bytes spilled) and 242, 54 / 68 KB;
// dkv_bf16 168 under its 3-blocks-per-SM bound (140 bytes spilled) and
// 244, 54 / 68 KB. The f32 kernels (64 threads) use 168-255 registers and
// spill, most at D=128, with 16-33 KB of static shared memory.
//
// Left for later: TMA loads and wgmma with warp-specialised producers,
// 128-row tiles, the fused one-pass backward, segment ids and arbitrary
// masks (the wrapper raises on those for CUDA tensors).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;  // bf16 kernels: 4 warps of 16 rows (or keys)
constexpr int kPad = 8;        // shared-memory row padding, bf16 elements

struct Problem {
  int heads, sq, skv;
  int causal, window, offset;  // offset = Skv - Sq aligns the diagonal
  const int* limits;           // per-row kv limits, or null
  int lim_bstride, lim_rstride;
  float scale;
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core building blocks (mma.sync m16n8k16, f32 accumulators).
// In a warp, lane = 4 * g + t. An A fragment (16 x 16) holds rows g and g + 8,
// columns 2t, 2t + 1, 2t + 8, 2t + 9; a B fragment (16 x 8) holds k = 2t,
// 2t + 1, 2t + 8, 2t + 9 of column g; a C fragment (16 x 8) holds rows g
// (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t and 2t + 1. Fragments
// come from shared memory by ldmatrix, four 8 x 8 matrices at a time; tiles
// come from device memory by cp.async, one tile ahead of the one in use.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment of rows row0.., columns k0.. of a row-major tile with row
// stride S
template <int S>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int row0,
                                       int k0, int lane) {
  ldsm_x4(a, s + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + k0 +
                 (lane >> 4) * 8);
}

// B fragments of the n-tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) at
// k0, for B[k][n] = s[n][k] (a tile stored [n][k])
template <int S>
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* s, int n0,
                                          int k0, int lane) {
  ldsm_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * S + k0 +
                 ((lane >> 3) & 1) * 8);
}

// the same for B[k][n] = s[k][n] (a tile stored [k][n])
template <int S>
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* s, int k0,
                                          int n0, int lane) {
  ldsm_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + n0 +
                       (lane >> 4) * 8);
}

// C fragments of 2 * N adjacent 16 x 8 tiles -> A fragments of N 16 x 16
// tiles (the score tile becomes the left operand of the next product).
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (*a)[4], float (*c)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i][0] = pack(c[2 * i][0], c[2 * i][1]);
    a[i][1] = pack(c[2 * i][2], c[2 * i][3]);
    a[i][2] = pack(c[2 * i + 1][0], c[2 * i + 1][1]);
    a[i][3] = pack(c[2 * i + 1][2], c[2 * i + 1][3]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + ROWS) of a [n, D] matrix into a padded shared tile, by
// cp.async; rows past n are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;  // 16-byte copies per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n;
    cp_async16(s + r * (D + kPad) + c * 8,
               g + (long long)(in ? row0 + r : 0) * D + c * 8, in);
  }
}

// True when every (row, key) of the tile is visible: no per-row limits, no
// ragged edge, and the tile lies inside the causal band. Such tiles skip
// the per-element mask.
__device__ __forceinline__ bool full_tile(const Problem& p, int r0, int rows,
                                          int c0, int cols) {
  if (p.limits != nullptr || r0 + rows > p.sq || c0 + cols > p.skv)
    return false;
  if (!p.causal) return true;
  return c0 + cols - 1 <= r0 + p.offset &&
         (p.window <= 0 || c0 > r0 + rows - 1 + p.offset - p.window);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, bf16* __restrict__ o,
         float* __restrict__ lse, Problem p) {
  constexpr int BR = 64, BC = 64, S = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kv = qs + BR * S;  // two stages of [K tile, V tile]
  __shared__ int lim_max;

  const int bh = blockIdx.y, b = bh / p.heads;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long qbase = (long long)bh * p.sq * D;
  const long long kbase = (long long)bh * p.skv * D;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const int la = row_limit(p, b, ra), lb = row_limit(p, b, rb);

  if (tid == 0) lim_max = 0;
  load_tile<D, BR>(qs, q + qbase, r0, p.sq);
  cp_commit();
  __syncthreads();
  atomicMax(&lim_max, max(la, lb));
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, BR, &lo, &hi);
  hi = min(hi, lim_max);
  const int first = (lo / BC) * BC;
  if (first < hi) {
    load_tile<D, BC>(kv, k + kbase, first, p.skv);
    load_tile<D, BC>(kv + BC * S, v + kbase, first, p.skv);
  }
  cp_commit();
  cp_wait<1>();  // the Q tile
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<S>(qa[kk], qs, warp * 16, kk * 16, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const float sl2 = p.scale * kLog2e;

  int stage = 0;
  for (int c0 = first; c0 < hi; c0 += BC, stage ^= 1) {
    if (c0 + BC < hi) {
      bf16* nxt = kv + (stage ^ 1) * 2 * BC * S;
      load_tile<D, BC>(nxt, k + kbase, c0 + BC, p.skv);
      load_tile<D, BC>(nxt + BC * S, v + kbase, c0 + BC, p.skv);
    }
    cp_commit();
    cp_wait<1>();  // this tile
    __syncthreads();
    const bf16* ks = kv + stage * 2 * BC * S;
    const bf16* vs = ks + BC * S;
    float s[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BC / 8; j += 2) {
        uint32_t bf[4];
        load_b_nk<S>(bf, ks, j * 8, kk * 16, lane);
        mma(s[j], qa[kk], bf[0], bf[1]);
        mma(s[j + 1], qa[kk], bf[2], bf[3]);
      }
    }
    const bool full = full_tile(p, r0, BR, c0, BC);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + j * 8 + 2 * t + (e & 1);
        const bool vis = full || (e < 2 ? visible(p, ra, la, col)
                                        : visible(p, rb, lb, col));
        s[j][e] = vis ? s[j][e] * sl2 : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row with nothing visible so far keeps max -inf; exponentiate
    // against 0 there so that exp2(-inf) gives 0, never NaN
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mu_a);
      s[j][1] = exp2f(s[j][1] - mu_a);
      s[j][2] = exp2f(s[j][2] - mu_b);
      s[j][3] = exp2f(s[j][3] - mu_b);
      l_a += s[j][0] + s[j][1];
      l_b += s[j][2] + s[j][3];
    }
    uint32_t pa[BC / 16][4];
    c_to_a<BC / 16>(pa, s);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        load_b_kn<S>(bf, vs, kk * 16, n * 8, lane);
        mma(acc[n], pa[kk], bf[0], bf[1]);
        mma(acc[n + 1], pa[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_wait<0>();

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float ia = l_a == 0.f ? 0.f : 1.f / l_a;
  const float ib = l_b == 0.f ? 0.f : 1.f / l_b;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < p.sq)
      *reinterpret_cast<uint32_t*>(o + qbase + (long long)ra * D + col) =
          pack(acc[n][0] * ia, acc[n][1] * ia);
    if (rb < p.sq)
      *reinterpret_cast<uint32_t*>(o + qbase + (long long)rb * D + col) =
          pack(acc[n][2] * ib, acc[n][3] * ib);
  }
  if (t == 0) {
    const long long lbase = (long long)bh * p.sq;
    if (ra < p.sq) lse[lbase + ra] = l_a == 0.f ? -INFINITY : (m_a + log2f(l_a)) * kLn2;
    if (rb < p.sq) lse[lbase + rb] = l_b == 0.f ? -INFINITY : (m_b + log2f(l_b)) * kLn2;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ di,
        bf16* __restrict__ dq, Problem p) {
  constexpr int BR = 64, BC = D == 64 ? 64 : 32, S = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BR * S;
  bf16* kv = dos + BR * S;  // two stages of [K tile, V tile]
  __shared__ int lim_max;

  const int bh = blockIdx.y, b = bh / p.heads;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long qbase = (long long)bh * p.sq * D;
  const long long kbase = (long long)bh * p.skv * D;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const int la = row_limit(p, b, ra), lb = row_limit(p, b, rb);
  const long long lbase = (long long)bh * p.sq;
  const float lse_a = ra < p.sq ? lse[lbase + ra] * kLog2e : 0.f;
  const float lse_b = rb < p.sq ? lse[lbase + rb] * kLog2e : 0.f;
  const float di_a = ra < p.sq ? di[lbase + ra] : 0.f;
  const float di_b = rb < p.sq ? di[lbase + rb] : 0.f;

  if (tid == 0) lim_max = 0;
  load_tile<D, BR>(qs, q + qbase, r0, p.sq);
  load_tile<D, BR>(dos, dout + qbase, r0, p.sq);
  cp_commit();
  __syncthreads();
  atomicMax(&lim_max, max(la, lb));
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, BR, &lo, &hi);
  hi = min(hi, lim_max);
  const int first = (lo / BC) * BC;
  if (first < hi) {
    load_tile<D, BC>(kv, k + kbase, first, p.skv);
    load_tile<D, BC>(kv + BC * S, v + kbase, first, p.skv);
  }
  cp_commit();
  cp_wait<1>();  // the Q and dO tiles
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<S>(qa[kk], qs, warp * 16, kk * 16, lane);
    load_a<S>(da[kk], dos, warp * 16, kk * 16, lane);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float sl2 = p.scale * kLog2e;

  int stage = 0;
  for (int c0 = first; c0 < hi; c0 += BC, stage ^= 1) {
    if (c0 + BC < hi) {
      bf16* nxt = kv + (stage ^ 1) * 2 * BC * S;
      load_tile<D, BC>(nxt, k + kbase, c0 + BC, p.skv);
      load_tile<D, BC>(nxt + BC * S, v + kbase, c0 + BC, p.skv);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* ks = kv + stage * 2 * BC * S;
    const bf16* vs = ks + BC * S;
    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BC / 8; j += 2) {
        uint32_t bf[4];
        load_b_nk<S>(bf, ks, j * 8, kk * 16, lane);
        mma(s[j], qa[kk], bf[0], bf[1]);
        mma(s[j + 1], qa[kk], bf[2], bf[3]);
        load_b_nk<S>(bf, vs, j * 8, kk * 16, lane);
        mma(dp[j], da[kk], bf[0], bf[1]);
        mma(dp[j + 1], da[kk], bf[2], bf[3]);
      }
    }
    const bool full = full_tile(p, r0, BR, c0, BC);
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + j * 8 + 2 * t + (e & 1);
        const bool top = e < 2;
        const bool vis = full || (top ? visible(p, ra, la, col)
                                      : visible(p, rb, lb, col));
        const float pr = vis ? exp2f(s[j][e] * sl2 - (top ? lse_a : lse_b)) : 0.f;
        s[j][e] = pr * (dp[j][e] - (top ? di_a : di_b)) * p.scale;  // ds
      }
    }
    uint32_t dsa[BC / 16][4];
    c_to_a<BC / 16>(dsa, s);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        load_b_kn<S>(bf, ks, kk * 16, n * 8, lane);
        mma(acc[n], dsa[kk], bf[0], bf[1]);
        mma(acc[n + 1], dsa[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < p.sq)
      *reinterpret_cast<uint32_t*>(dq + qbase + (long long)ra * D + col) =
          pack(acc[n][0], acc[n][1]);
    if (rb < p.sq)
      *reinterpret_cast<uint32_t*>(dq + qbase + (long long)rb * D + col) =
          pack(acc[n][2], acc[n][3]);
  }
}

// at D=64, 3 blocks per SM (at most 170 registers, a few bytes spilled) run
// faster on an H100 than the 2 that 188 unspilled registers allow (PERF.md)
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const bf16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ di,
         bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
  constexpr int BC = 64, BR = D == 64 ? 64 : 32, S = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BC * S;
  bf16* qdo = vs + BC * S;  // two stages of [Q tile, dO tile]
  __shared__ float lse_s[2][BR], di_s[2][BR];
  __shared__ int lim_s[2][BR];

  const int bh = blockIdx.y, b = bh / p.heads;
  const int c0 = blockIdx.x * BC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long qbase = (long long)bh * p.sq * D;
  const long long kbase = (long long)bh * p.skv * D;
  const long long lbase = (long long)bh * p.sq;
  const int ka = c0 + warp * 16 + g, kb = ka + 8;

  // the q tile r0 into stage st: Q and dO by cp.async, the row arrays by
  // plain stores (both are read after the next __syncthreads)
  auto load_rows = [&](int r0, int st) {
    bf16* dst = qdo + st * 2 * BR * S;
    load_tile<D, BR>(dst, q + qbase, r0, p.sq);
    load_tile<D, BR>(dst + BR * S, dout + qbase, r0, p.sq);
    for (int i = tid; i < BR; i += kThreads) {
      const int row = r0 + i;
      lse_s[st][i] = row < p.sq ? lse[lbase + row] * kLog2e : 0.f;
      di_s[st][i] = row < p.sq ? di[lbase + row] : 0.f;
      lim_s[st][i] = row_limit(p, b, row);
    }
  };

  load_tile<D, BC>(ks, k + kbase, c0, p.skv);
  load_tile<D, BC>(vs, v + kbase, c0, p.skv);
  int lo, hi;
  q_range(p, c0, BC, &lo, &hi);
  const int first = (lo / BR) * BR;
  if (first < hi) load_rows(first, 0);
  cp_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float sl2 = p.scale * kLog2e;

  int stage = 0;
  for (int r0 = first; r0 < hi; r0 += BR, stage ^= 1) {
    if (r0 + BR < hi) load_rows(r0 + BR, stage ^ 1);
    cp_commit();
    cp_wait<1>();  // K, V and this q tile
    __syncthreads();
    const bf16* qs = qdo + stage * 2 * BR * S;
    const bf16* dos = qs + BR * S;
    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys
    float st[BR / 8][4], dpt[BR / 8][4];
#pragma unroll
    for (int j = 0; j < BR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_k[4], a_v[4];
      load_a<S>(a_k, ks, warp * 16, kk * 16, lane);
      load_a<S>(a_v, vs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < BR / 8; j += 2) {
        uint32_t bf[4];
        load_b_nk<S>(bf, qs, j * 8, kk * 16, lane);
        mma(st[j], a_k, bf[0], bf[1]);
        mma(st[j + 1], a_k, bf[2], bf[3]);
        load_b_nk<S>(bf, dos, j * 8, kk * 16, lane);
        mma(dpt[j], a_v, bf[0], bf[1]);
        mma(dpt[j + 1], a_v, bf[2], bf[3]);
      }
    }
    const bool full = full_tile(p, r0, BR, c0, BC);
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = j * 8 + 2 * t + (e & 1);  // local q row
        const int key = e < 2 ? ka : kb;
        const bool vis = full || visible(p, r0 + i, lim_s[stage][i], key);
        const float pr = vis ? exp2f(st[j][e] * sl2 - lse_s[stage][i]) : 0.f;
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - di_s[stage][i]) * p.scale;  // ds^T
      }
    }
    uint32_t pta[BR / 16][4], dsa[BR / 16][4];
    c_to_a<BR / 16>(pta, st);
    c_to_a<BR / 16>(dsa, dpt);
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        load_b_kn<S>(bf, dos, kk * 16, n * 8, lane);
        mma(dv_acc[n], pta[kk], bf[0], bf[1]);
        mma(dv_acc[n + 1], pta[kk], bf[2], bf[3]);
        load_b_kn<S>(bf, qs, kk * 16, n * 8, lane);
        mma(dk_acc[n], dsa[kk], bf[0], bf[1]);
        mma(dk_acc[n + 1], dsa[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_wait<0>();  // no copy outlives the block, also when no tile ran

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ka < p.skv) {
      *reinterpret_cast<uint32_t*>(dk + kbase + (long long)ka * D + col) =
          pack(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<uint32_t*>(dv + kbase + (long long)ka * D + col) =
          pack(dv_acc[n][0], dv_acc[n][1]);
    }
    if (kb < p.skv) {
      *reinterpret_cast<uint32_t*>(dk + kbase + (long long)kb * D + col) =
          pack(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<uint32_t*>(dv + kbase + (long long)kb * D + col) =
          pack(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: scalar kernels, one thread per query row (forward, dq) or per key
// (dkv), over tiles staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int kRows32 = 64;  // threads per block
constexpr int kTile32 = 32;  // staged rows per tile

template <int D>
__device__ __forceinline__ void stage32(float (*s)[D], const float* g, int row0,
                                        int n) {
  for (int i = threadIdx.x; i < kTile32 * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    s[r][c] = row0 + r < n ? g[(long long)(row0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kRows32)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ o,
        float* __restrict__ lse, Problem p) {
  __shared__ float ks[kTile32][D], vs[kTile32][D];
  __shared__ int lim_max;
  const int bh = blockIdx.y, b = bh / p.heads;
  const int r0 = blockIdx.x * kRows32, row = r0 + threadIdx.x;
  const long long qbase = (long long)bh * p.sq * D;
  const long long kbase = (long long)bh * p.skv * D;
  const int lim = row_limit(p, b, row);
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < p.sq ? q[qbase + (long long)row * D + d] : 0.f;
    acc[d] = 0.f;
  }
  if (threadIdx.x == 0) lim_max = 0;
  __syncthreads();
  atomicMax(&lim_max, lim);
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, kRows32, &lo, &hi);
  hi = min(hi, lim_max);
  float m = -INFINITY, l = 0.f;
  for (int c0 = (lo / kTile32) * kTile32; c0 < hi; c0 += kTile32) {
    stage32<D>(ks, k + kbase, c0, p.skv);
    stage32<D>(vs, v + kbase, c0, p.skv);
    __syncthreads();
    for (int j = 0; j < kTile32; ++j) {
      if (!visible(p, row, lim, c0 + j)) continue;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      s *= p.scale;
      const float mn = fmaxf(m, s);
      const float alpha = expf(m - mn), pr = expf(s - mn);
      l = l * alpha + pr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pr, vs[j][d], acc[d] * alpha);
      m = mn;
    }
    __syncthreads();
  }
  if (row < p.sq) {
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) o[qbase + (long long)row * D + d] = acc[d] * inv;
    lse[(long long)bh * p.sq + row] = l == 0.f ? -INFINITY : m + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(kRows32)
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ di,
       float* __restrict__ dq, Problem p) {
  __shared__ float ks[kTile32][D], vs[kTile32][D];
  __shared__ int lim_max;
  const int bh = blockIdx.y, b = bh / p.heads;
  const int r0 = blockIdx.x * kRows32, row = r0 + threadIdx.x;
  const long long qbase = (long long)bh * p.sq * D;
  const long long kbase = (long long)bh * p.skv * D;
  const int lim = row_limit(p, b, row);
  const bool in = row < p.sq;
  const float lse_r = in ? lse[(long long)bh * p.sq + row] : 0.f;
  const float di_r = in ? di[(long long)bh * p.sq + row] : 0.f;
  float qr[D], dr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = in ? q[qbase + (long long)row * D + d] : 0.f;
    dr[d] = in ? dout[qbase + (long long)row * D + d] : 0.f;
    acc[d] = 0.f;
  }
  if (threadIdx.x == 0) lim_max = 0;
  __syncthreads();
  atomicMax(&lim_max, lim);
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, kRows32, &lo, &hi);
  hi = min(hi, lim_max);
  for (int c0 = (lo / kTile32) * kTile32; c0 < hi; c0 += kTile32) {
    stage32<D>(ks, k + kbase, c0, p.skv);
    stage32<D>(vs, v + kbase, c0, p.skv);
    __syncthreads();
    for (int j = 0; j < kTile32; ++j) {
      if (!visible(p, row, lim, c0 + j)) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], ks[j][d], s);
        dp = fmaf(dr[d], vs[j][d], dp);
      }
      const float pr = expf(s * p.scale - lse_r);
      const float ds = pr * (dp - di_r) * p.scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
    __syncthreads();
  }
  if (in) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[qbase + (long long)row * D + d] = acc[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kRows32)
dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ di,
        float* __restrict__ dk, float* __restrict__ dv, Problem p) {
  __shared__ float qs[kTile32][D], dos[kTile32][D];
  __shared__ float lse_s[kTile32], di_s[kTile32];
  __shared__ int lim_s[kTile32];
  const int bh = blockIdx.y, b = bh / p.heads;
  const int c0 = blockIdx.x * kRows32, key = c0 + threadIdx.x;
  const long long qbase = (long long)bh * p.sq * D;
  const long long kbase = (long long)bh * p.skv * D;
  const bool in = key < p.skv;
  float kr[D], vr[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = in ? k[kbase + (long long)key * D + d] : 0.f;
    vr[d] = in ? v[kbase + (long long)key * D + d] : 0.f;
    dk_acc[d] = dv_acc[d] = 0.f;
  }
  int lo, hi;
  q_range(p, c0, kRows32, &lo, &hi);
  for (int r0 = (lo / kTile32) * kTile32; r0 < hi; r0 += kTile32) {
    stage32<D>(qs, q + qbase, r0, p.sq);
    stage32<D>(dos, dout + qbase, r0, p.sq);
    for (int i = threadIdx.x; i < kTile32; i += blockDim.x) {
      const int row = r0 + i;
      lse_s[i] = row < p.sq ? lse[(long long)bh * p.sq + row] : 0.f;
      di_s[i] = row < p.sq ? di[(long long)bh * p.sq + row] : 0.f;
      lim_s[i] = row_limit(p, b, row);
    }
    __syncthreads();
    for (int i = 0; i < kTile32; ++i) {
      if (!visible(p, r0 + i, lim_s[i], key)) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[i][d], kr[d], s);
        dp = fmaf(dos[i][d], vr[d], dp);
      }
      const float pr = expf(s * p.scale - lse_s[i]);
      const float ds = pr * (dp - di_s[i]) * p.scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv_acc[d] = fmaf(pr, dos[i][d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, qs[i][d], dk_acc[d]);
      }
    }
    __syncthreads();
  }
  if (in) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[kbase + (long long)key * D + d] = dk_acc[d];
      dv[kbase + (long long)key * D + d] = dv_acc[d];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// bytes of `rows` padded rows of a bf16 tile
template <int D>
int smem_bf16(int rows) {
  return rows * (D + kPad) * (int)sizeof(bf16);
}

Problem make_problem(const void* limits, int heads, int sq, int skv,
                     int lim_bstride, int lim_rstride, int causal, int window,
                     float sm_scale) {
  Problem p;
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = causal ? window : 0;
  p.offset = causal ? skv - sq : 0;
  p.limits = static_cast<const int*>(limits);
  p.lim_bstride = lim_bstride;
  p.lim_rstride = lim_rstride;
  p.scale = sm_scale;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv alike);
// head_dim 64 or 128. Each returns the cudaError_t of its launch; the caller
// raises on non-zero.
int lamp_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const void* limits, void* o, void* lse, int bh,
                             int heads, int sq, int skv, int head_dim,
                             int lim_bstride, int lim_rstride, int causal,
                             int window, float sm_scale, int dtype,
                             void* stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  const Problem p = make_problem(limits, heads, sq, skv, lim_bstride,
                                 lim_rstride, causal, window, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    const dim3 grid(cdiv(sq, 64), bh);
    // a 64-row q tile and two stages of 64-row K and V tiles
    if (head_dim == 64)
      return launch(fwd_bf16<64>, grid, kThreads, smem_bf16<64>(64 + 4 * 64), st,
                    qb, kb, vb, static_cast<bf16*>(o), l, p);
    if (head_dim == 128)
      return launch(fwd_bf16<128>, grid, kThreads, smem_bf16<128>(64 + 4 * 64),
                    st, qb, kb, vb, static_cast<bf16*>(o), l, p);
  }
  if (dtype == 0) {
    const dim3 grid(cdiv(sq, kRows32), bh);
    if (head_dim == 64)
      return launch(fwd_f32<64>, grid, kRows32, 0, st, qf, kf, vf,
                    static_cast<float*>(o), l, p);
    if (head_dim == 128)
      return launch(fwd_f32<128>, grid, kRows32, 0, st, qf, kf, vf,
                    static_cast<float*>(o), l, p);
  }
  return cudaErrorInvalidValue;
}

int lamp_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, const void* limits, void* dq,
                                int bh, int heads, int sq, int skv,
                                int head_dim, int lim_bstride, int lim_rstride,
                                int causal, int window, float sm_scale,
                                int dtype, void* stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  const Problem p = make_problem(limits, heads, sq, skv, lim_bstride,
                                 lim_rstride, causal, window, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (dtype == 1) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(dout);
    bf16* out = static_cast<bf16*>(dq);
    const dim3 grid(cdiv(sq, 64), bh);
    // q and do tiles of 64 rows, two stages of k and v tiles of 64 (D=64)
    // or 32 (D=128) rows
    if (head_dim == 64)
      return launch(dq_bf16<64>, grid, kThreads, smem_bf16<64>(2 * 64 + 4 * 64),
                    st, qb, kb, vb, ob, l, d, out, p);
    if (head_dim == 128)
      return launch(dq_bf16<128>, grid, kThreads, smem_bf16<128>(2 * 64 + 4 * 32),
                    st, qb, kb, vb, ob, l, d, out, p);
  }
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *of = static_cast<const float*>(dout);
    float* out = static_cast<float*>(dq);
    const dim3 grid(cdiv(sq, kRows32), bh);
    if (head_dim == 64)
      return launch(dq_f32<64>, grid, kRows32, 0, st, qf, kf, vf, of, l, d, out, p);
    if (head_dim == 128)
      return launch(dq_f32<128>, grid, kRows32, 0, st, qf, kf, vf, of, l, d, out, p);
  }
  return cudaErrorInvalidValue;
}

int lamp_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, const void* limits, void* dk,
                                 void* dv, int bh, int heads, int sq, int skv,
                                 int head_dim, int lim_bstride,
                                 int lim_rstride, int causal, int window,
                                 float sm_scale, int dtype, void* stream) {
  if (bh == 0 || skv == 0) return cudaSuccess;
  const Problem p = make_problem(limits, heads, sq, skv, lim_bstride,
                                 lim_rstride, causal, window, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (dtype == 1) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(dout);
    bf16 *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
    const dim3 grid(cdiv(skv, 64), bh);
    // k and v tiles of 64 rows, two stages of q and do tiles of 64 (D=64)
    // or 32 (D=128) rows
    if (head_dim == 64)
      return launch(dkv_bf16<64>, grid, kThreads, smem_bf16<64>(2 * 64 + 4 * 64),
                    st, qb, kb, vb, ob, l, d, dkb, dvb, p);
    if (head_dim == 128)
      return launch(dkv_bf16<128>, grid, kThreads, smem_bf16<128>(2 * 64 + 4 * 32),
                    st, qb, kb, vb, ob, l, d, dkb, dvb, p);
  }
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *of = static_cast<const float*>(dout);
    float *dkf = static_cast<float*>(dk), *dvf = static_cast<float*>(dv);
    const dim3 grid(cdiv(skv, kRows32), bh);
    if (head_dim == 64)
      return launch(dkv_f32<64>, grid, kRows32, 0, st, qf, kf, vf, of, l, d, dkf,
                    dvf, p);
    if (head_dim == 128)
      return launch(dkv_f32<128>, grid, kRows32, 0, st, qf, kf, vf, of, l, d, dkf,
                    dvf, p);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
