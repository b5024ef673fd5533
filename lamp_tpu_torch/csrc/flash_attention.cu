// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of lamp_tpu/ops/attention.py:
//   K1  _fwd_kernel (driven by _fwd)                 -> fwd_bf16 / fwd_f32
//   K2a _bwd_fused_kernel (driven by _bwd_fused)     -> dq_* then dkv_*
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
// 3.35 TB/s). Any backward needs 5 products (128.8 GFLOP, 130.3 us); the
// split one here does 7 (dq recomputes S and dP: 180.4 GFLOP, 182.4 us).
// At the flagship's B=8, S=384 the backward is bound by bytes: q, k, v, o,
// do read and dq, dk, dv written once, 37.7 MB, 11.3 us.
//
// Forward (FlashAttention-2 on mma.sync): one block of 4 warps per (b*h,
// 64-row q tile); each warp owns 16 query rows, keeps Q fragments, the f32
// output accumulator and the online-softmax max and sum in registers, and
// walks 64-key K/V tiles staged in shared memory by cp.async, the next tile
// in flight while this one is used; fragments come from shared memory by
// ldmatrix. Tiles above the causal diagonal, below the window band or past
// every row's kv limit are not visited (the TPU kernel's skipped grid
// steps), and tiles wholly inside the band skip the per-element mask. P is
// rounded to bf16 for P @ V, as p.astype(v.dtype) in the TPU kernel. The q
// tiles run last-first, so the long causal rows start first.
//
// bf16 backward (wgmma, TMA and mbarriers; hopper.cuh): the split design,
// a dq kernel, then a dkv kernel. Each block is a producer warpgroup and
// two consumer warpgroups (setmaxnreg: 40 and 232 registers a thread).
// The producer's first warp streams tiles by TMA (3-D tensor maps [B*H, S,
// D], 128-byte swizzled, zero-filled past a ragged end) into a ring of 4
// stages, each completing on a `full` mbarrier and refilled after its
// `empty` mbarrier has the 256 consumer arrivals.
//  - dq: a block owns 128 rows (64 a consumer), Q and dO resident; it first
//    computes di = rowsum(o * do) in f32 for its rows from o and do and
//    writes it for dkv. Per K/V tile of 128 keys (64 at D=128): S = Q K^T
//    and dP = dO V^T (wgmma, A and B K-major from shared memory), p = exp2(s
//    scale log2e - lse log2e), dS = p (dP - di) scale rounded to bf16 as the
//    register A of dQ += dS K (B = K read MN-major, the transpose bit). Row
//    blocks run last-first (long causal rows first).
//  - dkv: a block owns 128 keys (64 a consumer), K and V resident. The
//    producer streams q tiles of 64 rows (32 at D=128) with each row's
//    lse log2e, di and visible key range [lo, hi), loaded one tile ahead.
//    Per tile: S^T = K Q^T and dP^T = V dO^T (K-major), p^T rounded to bf16
//    as the register A of dV += P^T dO, dS^T = p^T (dP^T - di) scale rounded
//    to bf16 as the register A of dK += dS^T Q (dO and Q MN-major). dK and dV
//    stay in f32 registers to the block's one store. Key blocks run
//    first-first (key 0 sees the most rows).
//  - in both, a tile's register-A products run on while the next tile's S
//    and dP are issued; its stage is released when they are done. The
//    accumulator of m64nN holds, per 8-column chunk j, rows g and g + 8 at
//    columns 8j + 2t, 8j + 2t + 1, the layout of the A operand, so p and dS
//    become A operands by packing pairs (acc_to_a). Visibility is two
//    compares an element against the row's key range, skipped in tiles
//    wholly inside the band (full_tile); exp2 is ex2.approx.ftz.
//  - numerics as _bwd_fused_kernel: f32 accumulation, the softmax in the
//    log2 domain, P rounded to do's dtype for dV, dS to q's dtype for dK
//    and dQ, rows without a visible key exactly 0. No atomics and no
//    partial-dq slab: every sum runs in a fixed order, so a call gives the
//    same bits every time.
//  - float32 inputs take scalar kernels (one thread per row or key, f32
//    FMAs, no tensor cores; dq_f32 computes di too): f32 is for checking,
//    not for speed.
//  - ragged Sq and Skv are masked in the kernel: tile loads past the end
//    are zero-filled, rows and keys past the end are invisible, and stores
//    are guarded. Nothing is padded in device memory.
//
// What the backward's design does about the old mma.sync kernels' limits:
// (1) every product is wgmma; (2) a block owns 128 rows or keys, each
// staged tile serves two warpgroups; (3) a producer warp keeps up to 4
// tiles in flight by TMA while the consumers compute, with no
// __syncthreads in the loop; (4) no spills (below); (5) the split's 7
// products stay (a fused kernel needs a dq slab or atomics); (6) di is
// computed in the dq kernel, not in PyTorch.
//
// Resources (ptxas -v for sm_90a): the backward kernels, 384 threads,
// report 168 registers (the launch bound; the consumers run at 232 after
// setmaxnreg) and no spills at D=64 and D=128; dynamic shared memory (with
// 1 KB for alignment) 161 KB (dq) and 97 KB (dkv) at D=64, 193 KB (dq)
// and 129 KB (dkv) at D=128, and 80 B (dq) or 4.2 KB (dkv, the row
// statistics) of static. fwd_bf16 (128 threads): 134 registers at D=64 and 178 at D=128,
// no spills, 45 / 85 KB. The f32 kernels (64 threads) use 168-255
// registers and spill, most at D=128, with 16-33 KB of static shared
// memory.
//
// Left for later: the forward on wgmma and TMA (it can reuse hopper.cuh),
// segment ids and arbitrary masks (the wrapper raises on those for CUDA
// tensors).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16 backward on wgmma (hopper.cuh): one block of three warpgroups. The
// first is the producer: its first warp loads tiles by TMA into a ring of
// kStages stages, each completing on a `full` mbarrier, and waits on each
// stage's `empty` mbarrier before refilling it; its other warps idle. The
// two consumer warpgroups each own 64 rows (dq) or 64 keys (dkv) of the
// block's 128 and run every product by wgmma on the swizzled tiles.
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 384;  // a producer and two consumer warpgroups
constexpr int kStages = 4;
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 of the SM's 64K
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// the keys of a K/V tile the dq kernel streams (S and dP are m64nBC): 128
// at D=64 (8% faster at S=4096 than 64 on an H100), 64 at D=128 (the ring
// of 128-key tiles would not fit beside Q and dO)
__host__ __device__ constexpr int dq_kv_tile(int d) { return d == 64 ? 128 : 64; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ int tile_count(int first, int hi, int step) {
  return first < hi ? (hi - first + step - 1) / step : 0;
}

// The keys [lo, hi) that `row` sees: visible() as two bounds, so that a
// masked tile costs two compares an element. hi = 0 for rows past Sq.
__device__ __forceinline__ int2 key_bounds(const Problem& p, int b, int row) {
  int lo = 0, hi = row_limit(p, b, row);
  if (p.causal) {
    const int diag = row + p.offset;
    hi = min(hi, diag + 1);
    if (p.window > 0) lo = diag - p.window + 1;
  }
  return make_int2(lo, hi);
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, results below 2^-126 flushed to 0; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dq for 128 query rows, and di = rowsum(o * do) for them (written to `di`
// for the dkv kernel, which runs after). Q and dO stay resident; the
// producer streams K and V tiles of BC keys. Per tile and consumer: S = Q K^T
// and dP = dO V^T (wgmma, A and B K-major), p = exp2(s scale log2e -
// lse log2e), dS = p (dP - di) scale rounded to bf16 as the register A of
// dQ += dS K (B = K MN-major).
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dq_bf16(const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_do, const bf16* __restrict__ o,
        const bf16* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ di, bf16* __restrict__ dq, Problem p) {
  using namespace hopper;
  constexpr int BR = 128, BC = dq_kv_tile(D);
  constexpr int kHalf = 64 * D * 2;   // bytes of one consumer's Q (or dO) rows
  constexpr int kTile = BC * D * 2;   // bytes of a K (or V) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);  // [2 halves][D / 64][64][64]
  unsigned char* dos = qs + 2 * kHalf;
  unsigned char* ring = dos + 2 * kHalf;    // kStages x [K tile, V tile]
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  __shared__ int lim_max[2];

  const int bh = blockIdx.y, b = bh / p.heads;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;  // long causal rows first
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
    lim_max[0] = lim_max[1] = 0;
  }
  __syncthreads();
  if (tid < BR) atomicMax(&lim_max[tid / 64], row_limit(p, b, r0 + tid));
  __syncthreads();
  int lo, hi;
  kv_range(p, r0, BR, &lo, &hi);
  hi = min(hi, max(lim_max[0], lim_max[1]));
  const int first = (lo / BC) * BC;
  const int tiles = tile_count(first, hi, BC);

  if (tid < 128) {  // producer
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_tx(&q_full, 4 * kHalf);
      for (int h = 0; h < 2; ++h)
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_3d(qs + h * kHalf + cb * 64 * 128, &tm_q, &q_full, cb * 64,
                      r0 + 64 * h, bh);
          tma_load_3d(dos + h * kHalf + cb * 64 * 128, &tm_do, &q_full,
                      cb * 64, r0 + 64 * h, bh);
        }
      for (int i = 0; i < tiles; ++i) {
        const int st = i % kStages, c0 = first + i * BC;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        unsigned char* dst = ring + st * 2 * kTile;
        mbar_arrive_tx(&full[st], 2 * kTile);
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_3d(dst + cb * BC * 128, &tm_k, &full[st], cb * 64, c0, bh);
          tma_load_3d(dst + kTile + cb * BC * 128, &tm_v, &full[st], cb * 64,
                      c0, bh);
        }
      }
    }
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rw = r0 + 64 * wg;
    const int ra = rw + warp * 16 + g, rb = ra + 8;
    const int2 ba = key_bounds(p, b, ra), bb = key_bounds(p, b, rb);
    const long long lbase = (long long)bh * p.sq;
    const float lse_a = ra < p.sq ? lse[lbase + ra] * kLog2e : 0.f;
    const float lse_b = rb < p.sq ? lse[lbase + rb] * kLog2e : 0.f;
    // di of rows ra and rb: lane t sums columns [t D/4, (t + 1) D/4)
    float di_a = 0.f, di_b = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra;
      if (row >= p.sq) continue;
      const long long off = (lbase + row) * D + t * (D / 4);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + off + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          sum = fmaf(of.x, df.x, sum);
          sum = fmaf(of.y, df.y, sum);
        }
      }
      (half ? di_b : di_a) = sum;
    }
    di_a = quad_sum(di_a);
    di_b = quad_sum(di_b);
    if (t == 0) {
      if (ra < p.sq) di[lbase + ra] = di_a;
      if (rb < p.sq) di[lbase + rb] = di_b;
    }
    int wlo, whi;
    kv_range(p, rw, 64, &wlo, &whi);
    whi = min(whi, lim_max[wg]);
    const unsigned char* qh = qs + wg * kHalf;
    const unsigned char* doh = dos + wg * kHalf;
    const float sl2 = p.scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // dQ += dS K of one tile runs on while the next tile's S and dP are
    // issued; its stage is released once that product is done
    uint32_t dsa[BC / 16][4];
    int held = -1;  // the stage an in-flight dQ product reads, or -1
    mbar_wait(&q_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int st = i % kStages, c0 = first + i * BC;
      mbar_wait(&full[st], (i / kStages) & 1);
      if (!(c0 + BC > wlo && c0 < whi)) {  // no key of the tile is visible
        // retire the held product first: the producer may be waiting for
        // that stage before it can fill the ones this warpgroup skips
        if (held >= 0) {
          wg_wait<0>();
          wg_keep(acc);
          wg_keep(dsa);
          mbar_arrive(&empty[held]);
          held = -1;
        }
        mbar_arrive(&empty[st]);
        continue;
      }
      const unsigned char* ks = ring + st * 2 * kTile;
      const unsigned char* vs = ks + kTile;
      float s[BC / 2], dp[BC / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BC>(s, desc_k<64>(qh, kk), desc_k<BC>(ks, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BC>(dp, desc_k<64>(doh, kk), desc_k<BC>(vs, kk), kk > 0);
      wg_commit();
      wg_wait<1>();  // S, and the previous tile's dQ product
      wg_keep(s);
      wg_keep(acc);
      wg_keep(dsa);
      if (held >= 0) mbar_arrive(&empty[held]);
      if (full_tile(p, rw, 64, c0, BC)) {
#pragma unroll
        for (int i2 = 0; i2 < BC / 2; ++i2)
          s[i2] = fast_exp2(s[i2] * sl2 - ((i2 & 2) ? lse_b : lse_a));
      } else {
#pragma unroll
        for (int i2 = 0; i2 < BC / 2; ++i2) {
          const int col = c0 + (i2 / 4) * 8 + 2 * t + (i2 & 1);
          const int2 kb2 = (i2 & 2) ? bb : ba;
          const float x = s[i2] * sl2 - ((i2 & 2) ? lse_b : lse_a);
          s[i2] = fast_exp2(col >= kb2.x && col < kb2.y ? x : -INFINITY);
        }
      }
      wg_wait<0>();  // dP
      wg_keep(dp);
#pragma unroll
      for (int i2 = 0; i2 < BC / 2; ++i2)
        dp[i2] = s[i2] * (dp[i2] - ((i2 & 2) ? di_b : di_a)) * p.scale;
      acc_to_a<BC>(dsa, dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        wgmma_rs<D>(acc, dsa[kk], desc_mn<BC>(ks, kk));
      wg_commit();
      held = st;
    }
    wg_wait<0>();
    wg_keep(acc);
    wg_keep(dsa);
    if (held >= 0) mbar_arrive(&empty[held]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (ra < p.sq)
        *reinterpret_cast<uint32_t*>(dq + (lbase + ra) * D + col) =
            pack_bf16(acc[4 * n], acc[4 * n + 1]);
      if (rb < p.sq)
        *reinterpret_cast<uint32_t*>(dq + (lbase + rb) * D + col) =
            pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

// dk and dv for 128 keys. K and V stay resident; the producer streams
// q tiles of BR rows (Q, dO, and each row's lse log2e, di and kv limit).
// Per tile and consumer: S^T = K Q^T and dP^T = V dO^T (wgmma, K-major),
// p^T rounded to bf16 as the register A of dV += P^T dO, dS^T = p^T (dP^T -
// di) scale rounded to bf16 as the register A of dK += dS^T Q (B = dO and
// Q, MN-major).
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
         const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v,
         const __grid_constant__ CUtensorMap tm_do,
         const float* __restrict__ lse, const float* __restrict__ di,
         bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
  using namespace hopper;
  constexpr int BC = 128, BR = D == 64 ? 64 : 32;
  constexpr int kHalf = 64 * D * 2;  // bytes of one consumer's K (or V) rows
  constexpr int kTile = BR * D * 2;  // bytes of a Q (or dO) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);  // [2 halves][D / 64][64][64]
  unsigned char* vs = ks + 2 * kHalf;
  unsigned char* ring = vs + 2 * kHalf;     // kStages x [Q tile, dO tile]
  // row statistics, read as float2 and int4 by the consumers
  __shared__ __align__(16) float lse_s[kStages][BR], di_s[kStages][BR];
  __shared__ __align__(16) int2 keys_s[kStages][BR];  // visible keys [lo, hi)
  __shared__ __align__(8) uint64_t kv_full, full[kStages], empty[kStages];

  const int bh = blockIdx.y, b = bh / p.heads;
  const int c0 = blockIdx.x * BC;  // key 0 walks the most q tiles: first
  const int tid = threadIdx.x;
  const long long lbase = (long long)bh * p.sq;
  int lo, hi;
  q_range(p, c0, BC, &lo, &hi);
  const int first = (lo / BR) * BR;
  const int tiles = tile_count(first, hi, BR);
  if (tid == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer
    regs_dec<kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_tx(&kv_full, 4 * kHalf);
        for (int h = 0; h < 2; ++h)
          for (int cb = 0; cb < D / 64; ++cb) {
            tma_load_3d(ks + h * kHalf + cb * 64 * 128, &tm_k, &kv_full,
                        cb * 64, c0 + 64 * h, bh);
            tma_load_3d(vs + h * kHalf + cb * 64 * 128, &tm_v, &kv_full,
                        cb * 64, c0 + 64 * h, bh);
          }
      }
      // the row statistics of the next tile, loaded while this one waits
      float lse_r[BR / 32], di_r[BR / 32];
      int2 keys_r[BR / 32];
      auto fetch = [&](int r0) {
#pragma unroll
        for (int u = 0; u < BR / 32; ++u) {
          const int row = r0 + lane + 32 * u;
          lse_r[u] = row < p.sq ? lse[lbase + row] * kLog2e : 0.f;
          di_r[u] = row < p.sq ? di[lbase + row] : 0.f;
          keys_r[u] = key_bounds(p, b, row);
        }
      };
      if (tiles > 0) fetch(first);
      for (int i = 0; i < tiles; ++i) {
        const int st = i % kStages, r0 = first + i * BR;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < BR / 32; ++u) {
          lse_s[st][lane + 32 * u] = lse_r[u];
          di_s[st][lane + 32 * u] = di_r[u];
          keys_s[st][lane + 32 * u] = keys_r[u];
        }
        if (i + 1 < tiles) fetch(r0 + BR);
        if (lane == 0) {
          unsigned char* dst = ring + st * 2 * kTile;
          mbar_arrive_tx(&full[st], 2 * kTile);
          for (int cb = 0; cb < D / 64; ++cb) {
            tma_load_3d(dst + cb * BR * 128, &tm_q, &full[st], cb * 64, r0,
                        bh);
            tma_load_3d(dst + kTile + cb * BR * 128, &tm_do, &full[st],
                        cb * 64, r0, bh);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int wg = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int k0 = c0 + 64 * wg;
    const int ka = k0 + warp * 16 + g, kb = ka + 8;
    int wlo, whi;
    q_range(p, k0, 64, &wlo, &whi);
    if (k0 >= p.skv) whi = wlo;  // no key of this warpgroup exists
    const unsigned char* kh = ks + wg * kHalf;
    const unsigned char* vh = vs + wg * kHalf;
    const float sl2 = p.scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // dV += P^T dO and dK += dS^T Q of one tile run on while the next
    // tile's S^T and dP^T are issued; the stage is released once they are
    // done
    uint32_t pa[BR / 16][4], dsa[BR / 16][4];
    int held = -1;  // the stage in-flight dV and dK products read, or -1
    mbar_wait(&kv_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int st = i % kStages, r0 = first + i * BR;
      mbar_wait(&full[st], (i / kStages) & 1);
      if (!(r0 + BR > wlo && r0 < whi)) {  // no row of the tile sees a key
        if (held >= 0) {  // as in dq_bf16
          wg_wait<0>();
          wg_keep(dv_acc);
          wg_keep(dk_acc);
          wg_keep(pa);
          wg_keep(dsa);
          mbar_arrive(&empty[held]);
          held = -1;
        }
        mbar_arrive(&empty[st]);
        continue;
      }
      const unsigned char* qt = ring + st * 2 * kTile;
      const unsigned char* dot = qt + kTile;
      float s[BR / 2], dp[BR / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BR>(s, desc_k<64>(kh, kk), desc_k<BR>(qt, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BR>(dp, desc_k<64>(vh, kk), desc_k<BR>(dot, kk), kk > 0);
      wg_commit();
      // the row statistics of columns 8j + 2t and 8j + 2t + 1
      float2 lse2[BR / 8], di2[BR / 8];
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        lse2[j] = *reinterpret_cast<const float2*>(&lse_s[st][j * 8 + 2 * t]);
        di2[j] = *reinterpret_cast<const float2*>(&di_s[st][j * 8 + 2 * t]);
      }
      wg_wait<1>();  // S^T, and the previous tile's dV and dK products
      wg_keep(s);
      wg_keep(dv_acc);
      wg_keep(dk_acc);
      wg_keep(pa);
      wg_keep(dsa);
      if (held >= 0) mbar_arrive(&empty[held]);
      if (full_tile(p, r0, BR, k0, 64)) {
#pragma unroll
        for (int i2 = 0; i2 < BR / 2; ++i2)
          s[i2] = fast_exp2(s[i2] * sl2 -
                            ((i2 & 1) ? lse2[i2 / 4].y : lse2[i2 / 4].x));
      } else {
#pragma unroll
        for (int j = 0; j < BR / 8; ++j) {
          const int4 kb4 =
              *reinterpret_cast<const int4*>(&keys_s[st][j * 8 + 2 * t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = e < 2 ? ka : kb;
            const int lo = (e & 1) ? kb4.z : kb4.x;
            const int hi = (e & 1) ? kb4.w : kb4.y;
            const float x =
                s[4 * j + e] * sl2 - ((e & 1) ? lse2[j].y : lse2[j].x);
            s[4 * j + e] = fast_exp2(key >= lo && key < hi ? x : -INFINITY);
          }
        }
      }
      acc_to_a<BR>(pa, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        wgmma_rs<D>(dv_acc, pa[kk], desc_mn<BR>(dot, kk));
      wg_commit();
      wg_wait<1>();  // dP^T (dV may still run)
      wg_keep(dp);
#pragma unroll
      for (int i2 = 0; i2 < BR / 2; ++i2)
        dp[i2] = s[i2] * (dp[i2] - ((i2 & 1) ? di2[i2 / 4].y
                                              : di2[i2 / 4].x)) * p.scale;
      acc_to_a<BR>(dsa, dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        wgmma_rs<D>(dk_acc, dsa[kk], desc_mn<BR>(qt, kk));
      wg_commit();
      held = st;
    }
    wg_wait<0>();
    wg_keep(dv_acc);
    wg_keep(dk_acc);
    wg_keep(pa);
    wg_keep(dsa);
    if (held >= 0) mbar_arrive(&empty[held]);
    const long long kbase = (long long)bh * p.skv;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (ka < p.skv) {
        *reinterpret_cast<uint32_t*>(dk + (kbase + ka) * D + col) =
            pack_bf16(dk_acc[4 * n], dk_acc[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(dv + (kbase + ka) * D + col) =
            pack_bf16(dv_acc[4 * n], dv_acc[4 * n + 1]);
      }
      if (kb < p.skv) {
        *reinterpret_cast<uint32_t*>(dk + (kbase + kb) * D + col) =
            pack_bf16(dk_acc[4 * n + 2], dk_acc[4 * n + 3]);
        *reinterpret_cast<uint32_t*>(dv + (kbase + kb) * D + col) =
            pack_bf16(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
      }
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
       const float* __restrict__ v, const float* __restrict__ o,
       const float* __restrict__ dout, const float* __restrict__ lse,
       float* __restrict__ di, float* __restrict__ dq, Problem p) {
  __shared__ float ks[kTile32][D], vs[kTile32][D];
  __shared__ int lim_max;
  const int bh = blockIdx.y, b = bh / p.heads;
  const int r0 = blockIdx.x * kRows32, row = r0 + threadIdx.x;
  const long long qbase = (long long)bh * p.sq * D;
  const long long kbase = (long long)bh * p.skv * D;
  const int lim = row_limit(p, b, row);
  const bool in = row < p.sq;
  const float lse_r = in ? lse[(long long)bh * p.sq + row] : 0.f;
  float qr[D], dr[D], acc[D];
  float di_r = 0.f;  // rowsum(o * do), for this kernel and the dkv kernel
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = in ? q[qbase + (long long)row * D + d] : 0.f;
    dr[d] = in ? dout[qbase + (long long)row * D + d] : 0.f;
    if (in) di_r = fmaf(o[qbase + (long long)row * D + d], dr[d], di_r);
    acc[d] = 0.f;
  }
  if (in) di[(long long)bh * p.sq + row] = di_r;
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

// dynamic shared memory of the wgmma backward kernels, with 1 KB to align
// the swizzled tiles: resident tiles of 128 rows (Q and dO, or K and V)
// and kStages stages of two streamed tiles
template <int D>
int smem_dq() {
  return 1024 + 2 * 128 * D * 2 + kStages * 2 * dq_kv_tile(D) * D * 2;
}
template <int D>
int smem_dkv() {
  return 1024 + 2 * 128 * D * 2 + kStages * 2 * (D == 64 ? 64 : 32) * D * 2;
}

// what an entry point returns when a TMA map could not be encoded: this
// plus libcuda's CUresult (kMapError - 1: no encoder was found)
constexpr int kMapError = 10000;

// TMA maps of q, k, v and do ([bh, rows, d] bf16) in boxes of 64 columns by
// q_rows (q, do) or kv_rows (k, v); a tensor with no rows gets a map of one
// row, which no load reads. Returns 0 or kMapError + the failure.
int bwd_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
             const void* dout, int bh, int sq, int skv, int d, int q_rows,
             int kv_rows) {
  // libcuda's encoder needs the device's context current on this
  // thread, and autograd runs the backward on a thread of its own, where
  // nothing may have made it current yet
  cudaPointerAttributes at;
  if (cudaPointerGetAttributes(&at, q) != cudaSuccess ||
      cudaSetDevice(at.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  sq = sq > 0 ? sq : 1;
  skv = skv > 0 ? skv : 1;
  const void* base[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool kv = i == 1 || i == 2;
    const int rc = hopper::bf16_tile_map(&m[i], base[i], bh, kv ? skv : sq, d,
                                         kv ? kv_rows : q_rows);
    if (rc != 0) return kMapError + rc;
  }
  return 0;
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
// head_dim 64 or 128. Each returns the cudaError_t of its launch, or (the
// backward) kMapError + libcuda's CUresult when a TMA map was refused;
// the caller raises on non-zero.
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
                                const void* o, const void* dout,
                                const void* lse, void* di, const void* limits,
                                void* dq, int bh, int heads, int sq, int skv,
                                int head_dim, int lim_bstride, int lim_rstride,
                                int causal, int window, float sm_scale,
                                int dtype, void* stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  const Problem p = make_problem(limits, heads, sq, skv, lim_bstride,
                                 lim_rstride, causal, window, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(di);
  if (dtype == 1) {
    const bf16 *ob = static_cast<const bf16*>(o),
               *dob = static_cast<const bf16*>(dout);
    bf16* out = static_cast<bf16*>(dq);
    CUtensorMap m[4];
    const int rc = bwd_maps(m, q, k, v, dout, bh, sq, skv, head_dim, 64,
                            dq_kv_tile(head_dim));
    if (rc != 0) return rc;
    const dim3 grid(cdiv(sq, 128), bh);
    if (head_dim == 64)
      return launch(dq_bf16<64>, grid, kBwdThreads, smem_dq<64>(), st, m[0],
                    m[1], m[2], m[3], ob, dob, l, d, out, p);
    if (head_dim == 128)
      return launch(dq_bf16<128>, grid, kBwdThreads, smem_dq<128>(), st, m[0],
                    m[1], m[2], m[3], ob, dob, l, d, out, p);
  }
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *of = static_cast<const float*>(o),
                *df = static_cast<const float*>(dout);
    float* out = static_cast<float*>(dq);
    const dim3 grid(cdiv(sq, kRows32), bh);
    if (head_dim == 64)
      return launch(dq_f32<64>, grid, kRows32, 0, st, qf, kf, vf, of, df, l, d,
                    out, p);
    if (head_dim == 128)
      return launch(dq_f32<128>, grid, kRows32, 0, st, qf, kf, vf, of, df, l,
                    d, out, p);
  }
  return cudaErrorInvalidValue;
}

// di is the dq kernel's output: launch dq first
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
    bf16 *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
    CUtensorMap m[4];
    const int rc = bwd_maps(m, q, k, v, dout, bh, sq, skv, head_dim,
                            head_dim == 64 ? 64 : 32, 64);
    if (rc != 0) return rc;
    const dim3 grid(cdiv(skv, 128), bh);
    if (head_dim == 64)
      return launch(dkv_bf16<64>, grid, kBwdThreads, smem_dkv<64>(), st, m[0],
                    m[1], m[2], m[3], l, d, dkb, dvb, p);
    if (head_dim == 128)
      return launch(dkv_bf16<128>, grid, kBwdThreads, smem_dkv<128>(), st,
                    m[0], m[1], m[2], m[3], l, d, dkb, dvb, p);
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
