// Int4 dequant-matmul for Hopper (sm_90a).
//
// Replaces lamp_tpu/ops/quantization.py:_int4_mm_kernel (the Pallas TPU
// kernel behind _int4_matmul_pallas). Computes
//   out[M, N] = x[M, K] @ dequant(packed[K/2, N], scales[K/g, N])
// with the weight nibble-packed in the HALF-SPLIT layout: packed row i holds
// weight row i in its low nibble and row i + K/2 in its high nibble, both
// offset-binary (stored v + 8, v in [-8, 7]). Group kk of the low half
// (rows [kk*g, (kk+1)*g)) is scaled by scales row kk, the same rows of the
// high half by row kk + K/(2g).
//
// Arithmetic (the TPU kernel's): per K-group, x in its own dtype times the
// exact integer codes, summed in f32; each group's partial product is scaled
// by its f32 scale row before it is added to the f32 output; the output is
// written once in out's dtype (f32 for the logits, bf16 for the layers).
//
// What bounds it: the packed weight bytes. Decode multiplies a few rows
// (M <= 64) by each weight, so the call reads K*N/2 bytes of weight and does
// 2*M FLOPs per weight element, far below the card's ridge; at the serving
// shapes (K=768, g=128) the 768 x 32000 logits matrix is 12.3 MB packed.
// The design reads each packed byte once per row tile and uses both of its
// nibbles (one load feeds the low-half and the high-half products), and
// never writes the dequantized weight to device memory.
//
// Design (tensor-core path: bf16 x, g a multiple of 16): a block of 4 warps
// owns a BM x 64 output tile (BM = 32 for up to 32 rows, the decode batch,
// else 64); warp w owns columns [16w, 16w+16) and every active 16-row tile.
// The TPU grid's sequential K axis becomes a loop inside the block over
// chunks of KC in {16, 32, 64} rows of the half (KC divides g), staged in
// shared memory by cp.async three chunks deep (two in flight while one is
// used): the x rows of the low half and of the high half ([BM, KC]
// bf16 each), the packed bytes ([KC, 64]) and the scale rows of the chunk's
// group ([2, 64] f32). Per k16 step each lane reads
// the 4 bytes of its B fragment and turns each nibble into bf16 exactly
// (0x4300 | v is 128 + v in bf16; minus 136 gives v - 8), which feeds two
// mma.sync m16n8k16 (f32 accumulators): one for the low half, one for the
// high half. At the end of each group the two partial sums are scaled by
// that group's scale rows and added to the output accumulators. Rows past M
// and columns past N are masked (zero-filled when staged, not stored); row
// tiles past M are skipped.
//
// Split-K: at decode shapes a layer's matrix gives few blocks (N=768: 12
// tiles on 132 SMs), and a block's time grows with the chunks it walks
// (~1 us each on an H100, mostly fixed cost per chunk), so the caller may
// divide the K-groups over `splits` blocks per tile. Each writes its f32
// partial tile to a workspace, and a second pass adds the splits in order
// and writes out's dtype: deterministic, no atomics.
//
// f32 x, or a group that is not a multiple of 16, takes a scalar kernel (one
// thread per column, 8 rows per block): a checking path, not a fast one.
//
// Left for later: wgmma with TMA, and the per-chunk fixed cost.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBN = 64;        // output columns per block, 16 per warp
constexpr int kStages = 3;     // chunks staged: 2 in flight beside the one in use
constexpr int kXPad = 8;       // bf16 elements of row padding (x tiles)
constexpr int kWPad = 16;      // bytes of row padding (packed tile)
constexpr int kWS = kBN + kWPad;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mma.sync m16n8k16, bf16 operands, f32 accumulators. In a warp, lane =
// 4 * g + t: an A fragment holds rows g, g + 8 and columns 2t, 2t + 1,
// 2t + 8, 2t + 9; a B fragment holds k = 2t, 2t + 1 (b0) and 2t + 8, 2t + 9
// (b1) of column g; a C fragment rows g (c0, c1) and g + 8 (c2, c3) at
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows row0.., columns k0.. of a row-major bf16 tile of row
// stride S, by ldmatrix
template <int S>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int row0, int k0,
                                       int lane) {
  const bf16* p = s + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + k0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// two 4-bit codes (offset-binary) -> a bf16 pair (v0 - 8, v1 - 8), exactly
__device__ __forceinline__ uint32_t dequant2(uint32_t v0, uint32_t v1) {
  uint32_t bits = 0x43004300u | v0 | (v1 << 16);
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&bits),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void store2(float* out, long long i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* out, long long i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* out, long long i, float a) { out[i] = a; }
__device__ __forceinline__ void store1(bf16* out, long long i, float a) {
  out[i] = __float2bfloat16(a);
}

// a warp's C fragments of a BM x 64 tile into dst [m, n], rows past m and
// columns past n masked
template <int MT, typename O>
__device__ __forceinline__ void store_tile(O* dst, const float (&acc)[MT][2][4], int m, int n,
                                           int m0, int n0, int rows, int warp, int lane) {
  const int g_row = lane >> 2, t2 = 2 * (lane & 3);
  const bool pairs = (n % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt * 16 >= rows) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + warp * 16 + nt * 8 + t2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mt * 16 + g_row + 8 * h;
        if (row >= m) continue;
        const long long i = (long long)row * n + col;
        const float a = acc[mt][nt][2 * h], b = acc[mt][nt][2 * h + 1];
        if (pairs && col + 1 < n) {
          store2(dst, i, a, b);
        } else {
          if (col < n) store1(dst, i, a);
          if (col + 1 < n) store1(dst, i + 1, b);
        }
      }
    }
  }
}

template <int KC, int BM>
struct Stage {
  bf16 x[2][BM][KC + kXPad];  // low-half and high-half x rows
  uint8_t w[KC][kWS];         // packed bytes
  float sc[2][kBN];           // the chunk's group's low and high scale rows
};

template <int KC, int BM, typename O>
__global__ void __launch_bounds__(kThreads)
int4_mm_tc(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
           const float* __restrict__ scales, O* __restrict__ out, float* __restrict__ part,
           int m, int k, int n, int group, int groups_per_split, bool vec) {
  constexpr int kXS = KC + kXPad;
  constexpr int kMT = BM / 16;  // 16-row tiles
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<KC, BM>* stage = reinterpret_cast<Stage<KC, BM>*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k2 = k / 2;
  const int n_kp = k2 / group;       // groups per half
  const int per_group = group / KC;  // chunks per group
  // this block's groups: all of them, or split z's range under split-K
  const int c0 = blockIdx.z * groups_per_split * per_group;
  const int n_chunks = min(n_kp, (blockIdx.z + 1) * groups_per_split) * per_group - c0;
  // rows staged and multiplied: whole 16-row tiles covering the valid rows
  const int rows = min(BM, ((m - m0 + 15) / 16) * 16);

  auto load = [&](int st, int c) {
    const int kb = c * KC;
    constexpr int kPieces = KC / 8;  // 16-byte pieces of an x row
    for (int i = tid; i < 2 * rows * kPieces; i += kThreads) {
      const int half = i / (rows * kPieces);
      const int r = (i / kPieces) % rows, p = i % kPieces;
      const bool in = m0 + r < m;
      const bf16* src = x + (long long)(in ? m0 + r : 0) * k + half * k2 + kb + p * 8;
      cp_async16(&stage[st].x[half][r][p * 8], src, in);
    }
    // the scale rows of the chunk's group, staged with it so that applying
    // them never waits on device memory
    const int kk = c / per_group;
    if (vec) {
      for (int i = tid; i < KC * (kBN / 16); i += kThreads) {
        const int r = i / (kBN / 16), p = i % (kBN / 16);
        const int col = n0 + p * 16;
        const bool in = col < n;
        cp_async16(&stage[st].w[r][p * 16],
                   packed + (long long)(kb + r) * n + (in ? col : 0), in);
      }
      if (tid < 2 * (kBN / 4)) {
        const int h = tid / (kBN / 4), p = tid % (kBN / 4);
        const int col = n0 + p * 4;
        const bool in = col < n;
        cp_async16(&stage[st].sc[h][p * 4],
                   scales + (long long)(kk + h * n_kp) * n + (in ? col : 0), in);
      }
    } else {
      for (int i = tid; i < KC * kBN; i += kThreads) {
        const int r = i / kBN, col = i % kBN;
        stage[st].w[r][col] = n0 + col < n ? packed[(long long)(kb + r) * n + n0 + col] : 0;
      }
      for (int i = tid; i < 2 * kBN; i += kThreads) {
        const int h = i / kBN, col = i % kBN;
        stage[st].sc[h][col] =
            n0 + col < n ? scales[(long long)(kk + h * n_kp) * n + n0 + col] : 0.f;
      }
    }
  };

  float acc[kMT][2][4], dlo[kMT][2][4], dhi[kMT][2][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = dlo[mt][nt][i] = dhi[mt][nt][i] = 0.f;

  const int g_row = lane >> 2, t2 = 2 * (lane & 3);
  // kStages - 1 chunks in flight ahead of the one in use; every iteration
  // commits one (possibly empty) group, so wait_group counts stay uniform
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_chunks) load(st, c0 + st);
    cp_commit();
  }
  for (int lc = 0; lc < n_chunks; ++lc) {
    if (lc + kStages - 1 < n_chunks)
      load((lc + kStages - 1) % kStages, c0 + lc + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    const int c = c0 + lc;
    const Stage<KC, BM>& s = stage[lc % kStages];
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t blo[2][2], bhi[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = warp * 16 + nt * 8 + g_row;
        const int kr = ks * 16 + t2;
        const uint32_t b00 = s.w[kr][col], b01 = s.w[kr + 1][col];
        const uint32_t b10 = s.w[kr + 8][col], b11 = s.w[kr + 9][col];
        blo[nt][0] = dequant2(b00 & 15u, b01 & 15u);
        blo[nt][1] = dequant2(b10 & 15u, b11 & 15u);
        bhi[nt][0] = dequant2(b00 >> 4, b01 >> 4);
        bhi[nt][1] = dequant2(b10 >> 4, b11 >> 4);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt * 16 < rows) {
          uint32_t a[4];
          load_a<kXS>(a, &s.x[0][0][0], mt * 16, ks * 16, lane);
          mma(dlo[mt][0], a, blo[0][0], blo[0][1]);
          mma(dlo[mt][1], a, blo[1][0], blo[1][1]);
          load_a<kXS>(a, &s.x[1][0][0], mt * 16, ks * 16, lane);
          mma(dhi[mt][0], a, bhi[0][0], bhi[0][1]);
          mma(dhi[mt][1], a, bhi[1][0], bhi[1][1]);
        }
      }
    }
    if ((c + 1) % per_group == 0) {
      // the group's partial products, scaled by its scale rows
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = warp * 16 + nt * 8 + t2;
        const float sl[2] = {s.sc[0][col], s.sc[0][col + 1]};
        const float sh[2] = {s.sc[1][col], s.sc[1][col + 1]};
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][nt][i] += dlo[mt][nt][i] * sl[i & 1] + dhi[mt][nt][i] * sh[i & 1];
            dlo[mt][nt][i] = dhi[mt][nt][i] = 0.f;
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled by a later iteration's load
  }

  // split-K: f32 partial sums of split z, added in order by
  // int4_mm_split_sum
  if (part != nullptr)
    store_tile(part + (long long)blockIdx.z * m * n, acc, m, n, m0, n0, rows, warp, lane);
  else
    store_tile(out, acc, m, n, m0, n0, rows, warp, lane);
}

template <typename O>
__global__ void int4_mm_split_sum(const float* __restrict__ part, O* __restrict__ out,
                                  long long mn, int splits) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float total = part[i];
  for (int z = 1; z < splits; ++z) total += part[z * mn + i];
  store1(out, i, total);
}

// scalar path: one thread per output column, kRowsS rows per block
constexpr int kRowsS = 8;

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
int4_mm_scalar(const T* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scales, O* __restrict__ out, int m, int k, int n,
               int group) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * kRowsS;
  if (col >= n) return;
  const int k2 = k / 2, n_kp = k2 / group;
  const int rows = min(kRowsS, m - m0);
  float acc[kRowsS];
#pragma unroll
  for (int r = 0; r < kRowsS; ++r) acc[r] = 0.f;
  for (int kk = 0; kk < n_kp; ++kk) {
    float dl[kRowsS], dh[kRowsS];
#pragma unroll
    for (int r = 0; r < kRowsS; ++r) dl[r] = dh[r] = 0.f;
    for (int j = 0; j < group; ++j) {
      const int kr = kk * group + j;
      const int byte = __ldg(packed + (long long)kr * n + col);
      const float lo = (float)((byte & 15) - 8), hi = (float)((byte >> 4) - 8);
#pragma unroll
      for (int r = 0; r < kRowsS; ++r) {
        if (r < rows) {
          const T* xr = x + (long long)(m0 + r) * k;
          dl[r] += to_float(xr[kr]) * lo;
          dh[r] += to_float(xr[k2 + kr]) * hi;
        }
      }
    }
    const float sl = __ldg(scales + (long long)kk * n + col);
    const float sh = __ldg(scales + (long long)(kk + n_kp) * n + col);
#pragma unroll
    for (int r = 0; r < kRowsS; ++r) acc[r] += dl[r] * sl + dh[r] * sh;
  }
#pragma unroll
  for (int r = 0; r < kRowsS; ++r)
    if (r < rows) store1(out, (long long)(m0 + r) * n + col, acc[r]);
}

template <int KC, int BM, typename O>
cudaError_t launch_tc(const void* x, const void* packed, const void* scales, void* out, int m,
                      int k, int n, int group, int splits, float* part, cudaStream_t stream) {
  constexpr int kSmem = kStages * sizeof(Stage<KC, BM>);
  // above 48 KB only as opted-in dynamic shared memory (set once)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      int4_mm_tc<KC, BM, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  // 16-byte copies of the packed rows and the scale rows
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  const int n_kp = k / 2 / group;
  const int per_split = (n_kp + splits - 1) / splits;
  if ((splits - 1) * per_split >= n_kp) return cudaErrorInvalidValue;  // an empty split
  dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM, splits);
  int4_mm_tc<KC, BM, O><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<O*>(out), splits > 1 ? part : nullptr,
      m, k, n, group, per_split, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)m * n;
  int4_mm_split_sum<O><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, static_cast<O*>(out), mn, splits);
  return cudaGetLastError();
}

template <int KC, typename O>
cudaError_t launch_tc_rows(const void* x, const void* packed, const void* scales, void* out,
                           int m, int k, int n, int group, int splits, float* part,
                           cudaStream_t stream) {
  // decode batches up to 32 rows take a 32-row tile: half the staged bytes
  return m <= 32
             ? launch_tc<KC, 32, O>(x, packed, scales, out, m, k, n, group, splits, part, stream)
             : launch_tc<KC, 64, O>(x, packed, scales, out, m, k, n, group, splits, part, stream);
}

template <typename T, typename O>
cudaError_t launch_scalar(const void* x, const void* packed, const void* scales, void* out,
                          int m, int k, int n, int group, cudaStream_t stream) {
  dim3 grid((n + kThreads - 1) / kThreads, (m + kRowsS - 1) / kRowsS);
  int4_mm_scalar<T, O><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<O*>(out), m, k, n, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [m, k] (x_dtype 0 = float32, 1 = bfloat16), packed [k/2, n] uint8,
// scales [k/group, n] float32, out [m, n] (out_dtype 0 = float32,
// 1 = bfloat16), all contiguous. splits > 1 (tensor-core path only) divides
// the K-groups over that many blocks per output tile, ceil(groups / splits)
// each, which write f32 partial sums into workspace [splits, m, n] for a
// second pass to add in order. The caller decides splits; a count that
// leaves a split empty, or splits > 1 on the scalar path, is refused.
// Returns the cudaError_t of the launches.
int lamp_int4_matmul(const void* x, const void* packed, const void* scales, void* out, int m,
                     int k, int n, int group, int x_dtype, int out_dtype, int splits,
                     void* workspace, void* stream) {
  if (m == 0 || n == 0) return cudaSuccess;
  if (m < 0 || n < 0 || k <= 0 || k % 2 || group <= 0 || (k / 2) % group)
    return cudaErrorInvalidValue;
  if (splits < 1 || (splits > 1 && workspace == nullptr)) return cudaErrorInvalidValue;
  float* part = static_cast<float*>(workspace);
  if (x_dtype < 0 || x_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && group % 16 == 0) {
    const int kc = group % 64 == 0 ? 64 : (group % 32 == 0 ? 32 : 16);
#define LAMP_I4_TC(KC)                                                                 \
  if (kc == KC)                                                                        \
    return out_dtype == 1                                                              \
               ? launch_tc_rows<KC, bf16>(x, packed, scales, out, m, k, n, group, splits,    \
                                          part, st)                                    \
               : launch_tc_rows<KC, float>(x, packed, scales, out, m, k, n, group, splits,   \
                                           part, st);
    LAMP_I4_TC(64)
    LAMP_I4_TC(32)
    LAMP_I4_TC(16)
#undef LAMP_I4_TC
  }
  if (splits != 1) return cudaErrorInvalidValue;
  if (x_dtype == 1)
    return out_dtype == 1 ? launch_scalar<bf16, bf16>(x, packed, scales, out, m, k, n, group, st)
                          : launch_scalar<bf16, float>(x, packed, scales, out, m, k, n, group, st);
  return out_dtype == 1 ? launch_scalar<float, bf16>(x, packed, scales, out, m, k, n, group, st)
                        : launch_scalar<float, float>(x, packed, scales, out, m, k, n, group, st);
}

}  // extern "C"
