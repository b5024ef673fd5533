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
// Arithmetic (the TPU kernel's): x in its own dtype times the exact integer
// codes, summed in f32 per K-group; each group's partial product is scaled
// by its f32 scale row before it is added to the f32 output; the output is
// written once in out's dtype (f32 for the logits, bf16 for the layers).
// A group cut between two blocks' K slices is scaled in each part:
// (a + b) s = a s + b s up to the rounding order.
//
// What bounds it: the packed weight bytes. Decode multiplies a few rows
// (M <= 64) by each weight, so a call reads K*N/2 bytes of weight and does
// 2*M operations per weight element, far below the card's ridge. At the
// serving shapes (K = 768 or 2048, g = 128, M = 32) a layer's matrix is
// 0.3-0.8 MB packed (bound 0.12-0.30 us at 3.35 TB/s) and the 768 x 32000
// logits matrix 12.3 MB (5.13 us): a layer's call is a chain of fixed
// latencies, each paid once a block.
//
// Decode kernel (int4_mm_decode: bf16 x, g a multiple of 16, M <= 64). The
// row-tiled kernel below, split over K for these rows, paid four costs many
// times over; what this design does about each:
//  1. A second launch and a round trip through device memory (partial
//     tiles written to a workspace for a second kernel to add). Here a call
//     is one launch with no workspace: where the output tiles are too few,
//     the K range is split over the blocks of a thread-block cluster (<= 8,
//     the portable size). Each block adds its warps' partials in its shared
//     memory and sends each share of the tile to the rank that owns it, by
//     st.async into that rank's shared memory (distributed shared memory),
//     completing on the owner's mbarrier; the owner adds the slots in rank
//     order and stores, so two calls give the same bits. No rank waits on
//     the whole cluster or reads another's memory.
//  2. Chunk-serial latency (chunks of <= 64 rows, two in flight, two block
//     barriers each). Here a block puts its whole K slice in flight at
//     once, as 16-byte cp.async pieces spread over its 256 threads, each
//     thread's pieces arriving on one mbarrier when they land
//     (cp.async.mbarrier.arrive.noinc): one DRAM latency a block. Bulk
//     copies of whole rows (cp.async.bulk) were slower on an H100: a warp
//     issues its lanes' bulk copies one after another. A slice that does
//     not fit (large K) goes in rounds of R rows through two stages, the
//     next round in flight under this one.
//  3. x staged again for every chunk and block. Here a block stages its K
//     slice of both halves' x rows once, beside the weight.
//  4. Byte-wise fragment reads. Here the operands are swapped: the weight's
//     16 output columns are the A operand of mma.sync m16n8k16 and x's rows
//     the 8-wide B. One ldmatrix.trans of the packed bytes (pairs of bytes
//     as b16 elements) gives each lane k = 2t, 2t+1 (and 2t+8, 2t+9) of
//     columns 2g and 2g+1; masks and shifts turn each 32-bit register into
//     the low-half and the high-half A fragments of both columns, so one
//     byte feeds both halves' products. A rows g and g+8 are columns 2g
//     and 2g+1 of the warp's 16. A step's fragments are all loaded before
//     its products.
// A block is 8 warps over BN (32, 64 or 128) output columns: BN/16 column
// groups, each taking 8/(BN/16) parts of the block's K slice. The caller
// (ops/quantization.py:_int4_plan) chooses BN, the cluster size and the
// round rows: about a block for every two SMs (more blocks in more ranks
// cost more in the cluster sum than they save), 128 columns where the
// 64-column tiles are many (the logits: x staged once per 128 columns).
// The plan's arithmetic is done on the host, and no copy loop divides by a
// value known only at run time. The kernel refuses a plan it cannot run.
// What a layer's call spends beside its launch, by a clock64 timeline of
// each block (scripts/exp_int4_variants.py): the barriers' setup, the
// copies' issue and landing, the products and the cluster sum, each a few
// hundred nanoseconds.
//
// Row-tiled kernel (int4_mm_tc: bf16 x, g a multiple of 16, M > 64, an LM
// forward's rows): a block of 4 warps owns a 64 x 64 output tile and walks
// the K range in chunks of KC in {16, 32, 64} rows staged by cp.async three
// deep. Its tiles fill the card, so it does not split K.
//
// f32 x, or a group that is not a multiple of 16, takes a scalar kernel (one
// thread per column, 8 rows per block): a checking path, not a fast one.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps (row-tiled and scalar kernels)
constexpr int kBN = 64;        // output columns per row-tiled block, 16 per warp
constexpr int kBM = 64;        // rows per row-tiled block
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

// the low nibbles of bytes 0 and 2 of (v >> shift) -> a bf16 pair of their
// values minus 8, exactly (0x4300 | c is 128 + c in bf16)
__device__ __forceinline__ uint32_t nibbles(uint32_t v, int shift) {
  uint32_t bits = ((v >> shift) & 0x000F000Fu) | 0x43004300u;
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
__device__ __forceinline__ void store4(float* out, long long i, float4 v) {
  *reinterpret_cast<float4*>(out + i) = v;
}
__device__ __forceinline__ void store4(bf16* out, long long i, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 bits = make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  *reinterpret_cast<uint2*>(out + i) = bits;
}

// ---------------------------------------------------------------------------
// Decode kernel: one launch, split-K over a cluster
// ---------------------------------------------------------------------------

using hopper::cluster_arrive_relaxed;
using hopper::cluster_wait;
using hopper::map_rank;
using hopper::st_async;

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on an H100
constexpr int kBarBytes = 128;    // the stages' mbarriers, then the stages

// Byte layout of one stage of a round of R packed rows, staged x rows
// mrows (a multiple of 8) and BN columns (after the stages, or the K
// parts' partial tiles where those are larger, comes `recv`, the cluster
// sum's [cluster][ceil(mrows BN / 4 / cluster)] float4s):
//   w   [R][BN + 16]             packed bytes, a row padded by 16 bytes so
//                                that ldmatrix's 8 rows lie in 8 bank groups
//   x   [2][mrows][2R + 16]      bytes: x's low-half and high-half columns
//                                of the round, bf16, rows padded alike
//   sc  [2][groups][BN]          f32 scale rows of the groups the round
//                                touches (low half, then high half)
// groups = (R + g - 17) / g + 1, the most a span of R rows starting at a
// multiple of 16 touches. ops/quantization.py:_int4_decode_smem repeats
// this arithmetic to choose R.
struct Layout {
  int rows, stages, x, sc, bytes, groups, recv;
  Layout() = default;
  __host__ __device__ Layout(int bn, int mrows, int k2, int g, int cluster, int round_rows) {
    const int steps = k2 / 16;
    const int slice = 16 * ((steps + cluster - 1) / cluster);  // the longest slice
    const int r = round_rows < slice ? round_rows : slice;
    rows = r;
    stages = r < slice ? 2 : 1;
    x = r * (bn + 16);
    sc = x + 2 * mrows * (2 * r + 16);
    groups = (r + g - 17) / g + 1;
    bytes = sc + 2 * groups * bn * 4;  // of a stage
    // the K parts' partial tiles [8 / (BN/16)][mrows][BN + 4] f32, over
    // the stages once every product is done
    const int red = (kDecWarps / (bn / 16)) * mrows * (bn + 4) * 4;
    recv = stages * bytes > red ? stages * bytes : red;
  }
  // the dynamic shared memory (bytes)
  __host__ __device__ int smem(int bn, int mrows, int cluster) const {
    const int share = (mrows * bn / 4 + cluster - 1) / cluster;
    return kBarBytes + recv + (cluster > 1 ? cluster * share * 16 : 0);
  }
};

// What a launch of the decode kernel needs beside its pointers, computed on
// the host so that no block divides by a value known only at run time
// before its copies are in flight.
struct Plan {
  int m, k, n, group;
  Layout lay;
  int share;                        // float4s of the tile each rank owns
  int bounds[kMaxCluster + 1];      // rank r's packed rows [bounds[r], bounds[r+1])
  bool vec;                         // weight and scale rows by 16-byte pieces
};

// x [m, k] bf16, packed [k/2, n], scales [k/g, n] f32, out [m, n]. Grid:
// ceil(n / BN) tiles x `cluster` blocks, a cluster per tile (the cluster's
// index is the tile's); rank r takes the 16-row steps [r T / c, (r + 1) T /
// c) of the T = k/32 steps of the half. NT: the 8-row tiles of x held
// (ceil(m / 8) <= NT). vec: n % 16 == 0 and packed, scales 16-byte aligned,
// so that weight and scale rows go by 16-byte cp.async (else plain loads).
template <int BN, int NT, typename O>
__global__ void __launch_bounds__(kDecThreads)
int4_mm_decode(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scales, O* __restrict__ out, const Plan pl) {
  constexpr int kGroupsC = BN / 16;           // column groups of 16
  constexpr int kParts = kDecWarps / kGroupsC;  // K parts per column group
  constexpr int kWS = BN + 16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // a stage's mbarrier each
  unsigned char* stages = smem + kBarBytes;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  uint32_t tile;
  asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(tile));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m = pl.m, k = pl.k, n = pl.n, group = pl.group, k2 = k / 2;
  const Layout lay = pl.lay;
  const bool vec = pl.vec;
  const int n0 = tile * BN;
  int row0 = 0, row1 = 0;  // selected, not indexed: the plan stays in registers
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r == rank) row0 = pl.bounds[r], row1 = pl.bounds[r + 1];
  }
  const int nt = (m + 7) / 8, mrows = 8 * nt;
  const int R = lay.rows, n_stages = lay.stages;
  const int wb = min(BN, n - n0);  // the tile's valid columns
  const int XS = 2 * R + 16;

  // the tile's float4s (valid rows), the share of them each rank owns in
  // the cluster's sum, and where that sum lands
  constexpr int kC4 = BN / 4;
  const int total4 = m * kC4, share = pl.share;
  float4* recv = reinterpret_cast<float4*>(stages + lay.recv);
  // put the round of rows [a, a + R) in flight into stage i: x's rows, the
  // packed rows and the scale rows of the groups the round touches, as
  // 16-byte cp.async pieces spread over the threads (the weight and scales
  // by plain loads unless vec). No integer division by a value known only
  // at run time inside the loops: each sits on the call's critical path.
  auto issue = [&](int a, int i) {
    unsigned char* st = stages + i * lay.bytes;
    const int rows = min(R, row1 - a), px = rows / 8;
    // piece (seg, q): x row seg % m of half seg / m, bytes [16 q, 16 q + 16)
    int seg = tid / px, q = tid - seg * px;
    const int dseg = kDecThreads / px, dq = kDecThreads - dseg * px;
    while (seg < 2 * m) {
      const int half = seg >= m, r = seg - half * m;
      cp_async16(st + lay.x + (half * mrows + r) * XS + q * 16,
                 x + (long long)r * k + half * k2 + a + q * 8, true);
      seg += dseg, q += dq;
      if (q >= px) q -= px, ++seg;
    }
    const int g0 = a / group, ng = (a + rows - 1) / group - g0 + 1, n_kp = k2 / group;
    if (vec) {
      constexpr int kWP = BN / 16, kSP = BN / 4;  // pieces of a packed, a scale row
      for (int c = tid; c < rows * kWP; c += kDecThreads) {
        const int r = c / kWP, p = c % kWP;
        if (p * 16 < wb)
          cp_async16(st + r * kWS + p * 16, packed + (long long)(a + r) * n + n0 + p * 16, true);
      }
      for (int c = tid; c < 2 * ng * kSP; c += kDecThreads) {
        const int sg = c / kSP, p = c % kSP, half = sg >= ng, gi = sg - half * ng;
        if (p * 4 < wb)
          cp_async16(st + lay.sc + (half * lay.groups + gi) * BN * 4 + p * 16,
                     scales + (long long)(g0 + gi + half * n_kp) * n + n0 + p * 4, true);
      }
    } else {
      for (int c = tid; c < rows * BN; c += kDecThreads) {
        const int r = c / BN, col = c % BN;
        st[r * kWS + col] = col < wb ? packed[(long long)(a + r) * n + n0 + col] : 0;
      }
      float* sc = reinterpret_cast<float*>(st + lay.sc);
      for (int c = tid; c < 2 * ng * BN; c += kDecThreads) {
        const int sg = c / BN, col = c % BN, half = sg >= ng, gi = sg - half * ng;
        sc[(half * lay.groups + gi) * BN + col] =
            col < wb ? scales[(long long)(g0 + gi + half * n_kp) * n + n0 + col] : 0.f;
      }
    }
  };
  // this thread's pieces so far arrive on stage i's mbarrier once landed
  auto arrive = [&](int i) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     smem_addr(&bar[i]))
                 : "memory");
  };
  // the first round goes out before anything else, so that setting up the
  // barriers overlaps its flight; then rounds through n_stages stages, the
  // next round in flight under this one
  issue(row0, 0);
  if (tid == 0) {
    // a stage's barrier: an arrival from each thread once its pieces land
    for (int i = 0; i < n_stages; ++i) hopper::mbar_init(&bar[i], kDecThreads);
    if (cs > 1) {  // bar[2]: every rank's share of this rank's elements
      hopper::mbar_init(&bar[2], 1);
      hopper::mbar_arrive_tx(&bar[2], cs * 16 * max(0, min(share, total4 - rank * share)));
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (cs > 1) cluster_arrive_relaxed();  // this rank's recv is ready
  arrive(0);
  if (n_stages == 2 && row0 + R < row1) {
    issue(row0 + R, 1);
    arrive(1);
  }

  const int cgp = warp % kGroupsC, part = warp / kGroupsC;
  const int g_row = lane >> 2, t = lane & 3;
  float acc[NT][4], dlo[NT][4], dhi[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = dlo[i][e] = dhi[i][e] = 0.f;

  for (int a = row0, j = 0; a < row1; a += R, ++j) {
    const unsigned char* st = stages + (j & 1) * lay.bytes;
    hopper::mbar_wait(&bar[j & 1], (j >> 1) & 1);
    if (!vec) __syncthreads();  // the plain loads of the weight and scales
    const int n_steps = min(R, row1 - a) / 16;
    const int s0 = part * n_steps / kParts, s1 = (part + 1) * n_steps / kParts;
    const float* sc = reinterpret_cast<const float*>(st + lay.sc);
    // add this warp's partial sums of group gi, scaled by its rows
    auto flush = [&](int gi) {
      const float2 sl = *reinterpret_cast<const float2*>(
          sc + gi * BN + cgp * 16 + 2 * g_row);
      const float2 sh = *reinterpret_cast<const float2*>(
          sc + (lay.groups + gi) * BN + cgp * 16 + 2 * g_row);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        // c0, c1: column 2g; c2, c3: column 2g + 1
        acc[i][0] += dlo[i][0] * sl.x + dhi[i][0] * sh.x;
        acc[i][1] += dlo[i][1] * sl.x + dhi[i][1] * sh.x;
        acc[i][2] += dlo[i][2] * sl.y + dhi[i][2] * sh.y;
        acc[i][3] += dlo[i][3] * sl.y + dhi[i][3] * sh.y;
#pragma unroll
        for (int e = 0; e < 4; ++e) dlo[i][e] = dhi[i][e] = 0.f;
      }
    };
    // lanes 0-15 address rows 0-15 of the step's packed rows at the warp's
    // 16 columns; lanes 0-7, 8-15, 16-23, 24-31 the x rows of the low half
    // k 0-7, k 8-15, then the high half's
    const uint32_t w_lane = smem_addr(st + (lane & 15) * kWS + cgp * 16);
    const uint32_t x_lane = smem_addr(
        st + lay.x + ((lane >> 4) * mrows + (lane & 7)) * XS + ((lane >> 3) & 1) * 16);
    // the group of step s0 and the step where the next one starts
    int gi = (a + 16 * s0) / group - a / group;
    int next = ((a / group + gi + 1) * group - a) / 16;
    for (int s = s0; s < s1; ++s) {
      if (s == next) {
        flush(gi++);
        next += group / 16;
      }
      // every fragment of the step first, then the products
      uint32_t w0, w1, b[NT][4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(w0), "=r"(w1)
                   : "r"(w_lane + s * 16 * kWS));
#pragma unroll
      for (int i = 0; i < NT; ++i)
        if (i < nt)
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(b[i][0]), "=r"(b[i][1]), "=r"(b[i][2]), "=r"(b[i][3])
                       : "r"(x_lane + i * 8 * XS + s * 32));
      const uint32_t alo[4] = {nibbles(w0, 0), nibbles(w0, 8), nibbles(w1, 0), nibbles(w1, 8)};
      const uint32_t ahi[4] = {nibbles(w0, 4), nibbles(w0, 12), nibbles(w1, 4),
                               nibbles(w1, 12)};
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i < nt) {
          mma(dlo[i], alo, b[i][0], b[i][1]);
          mma(dhi[i], ahi, b[i][2], b[i][3]);
        }
      }
    }
    if (s0 < s1) flush(gi);
    if (a + 2 * R < row1) {
      __syncthreads();  // every warp is done with this stage
      issue(a + 2 * R, j & 1);
      arrive(j & 1);
    }
  }

  // the block's partial tile: each K part's [mrows][BN] (over the stages),
  // then the parts added in order
  __syncthreads();
  constexpr int RS = BN + 4;
  float* red = reinterpret_cast<float*>(stages);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < nt) {
      float* r = red + (part * mrows + 8 * i + 2 * t) * RS + cgp * 16 + 2 * g_row;
      *reinterpret_cast<float2*>(r) = make_float2(acc[i][0], acc[i][2]);
      *reinterpret_cast<float2*>(r + RS) = make_float2(acc[i][1], acc[i][3]);
    }
  }
  __syncthreads();
  const bool vec4 = n % 4 == 0;
  auto put = [&](int e, float4 v) {  // element e (a float4) of the tile
    const int row = e / kC4, c = 4 * (e % kC4);
    const long long i = (long long)row * n + n0 + c;
    if (vec4 && c + 4 <= wb) {
      store4(out, i, v);
    } else {
      if (c < wb) store1(out, i, v.x);
      if (c + 1 < wb) store1(out, i + 1, v.y);
      if (c + 2 < wb) store1(out, i + 2, v.z);
      if (c + 3 < wb) store1(out, i + 3, v.w);
    }
  };
  // the cluster's sum: rank r owns the share [r S, (r + 1) S) of the
  // tile's float4s; every rank sends each share of its partial to its
  // owner's `recv` [cs][S] (slot = the sender's rank) by st.async, which
  // completes on the owner's mbarrier, and each owner, once every byte has
  // landed, adds its slots in rank order and stores. Nothing waits on the
  // whole cluster, and nothing is read across blocks.
  if (cs > 1) cluster_wait();  // every rank's recv and mbarrier exist
  for (int q = 0; q < cs; ++q) {
    const int base = q * share, count = min(share, total4 - base);
    const uint32_t slot = map_rank(smem_addr(recv + rank * share), q);
    const uint32_t owner_bar = map_rank(smem_addr(&bar[2]), q);
    for (int i = tid; i < count; i += kDecThreads) {
      const int e = base + i;
      const float4* p0 = reinterpret_cast<const float4*>(red + (e / kC4) * RS) + e % kC4;
      float4 v = *p0;
#pragma unroll
      for (int pq = 1; pq < kParts; ++pq) {
        const float4 u = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(p0) + pq * mrows * RS);
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      if (cs == 1)
        put(e, v);
      else
        st_async(slot + i * 16, v, owner_bar);
    }
  }
  if (cs == 1) return;
  hopper::mbar_wait(&bar[2], 0);
  for (int i = tid; i < share && rank * share + i < total4; i += kDecThreads) {
    float4 v = recv[i];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < cs) {
        const float4 u = recv[q * share + i];
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
    }
    put(rank * share + i, v);
  }
}

// ---------------------------------------------------------------------------
// Row-tiled kernel (M > 64)
// ---------------------------------------------------------------------------

// a warp's C fragments of a kBM x 64 tile into dst [m, n], rows past m and
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

template <int KC>
struct TileStage {
  bf16 x[2][kBM][KC + kXPad];  // low-half and high-half x rows
  uint8_t w[KC][kWS];          // packed bytes
  float sc[2][kBN];            // the chunk's group's low and high scale rows
};

template <int KC, typename O>
__global__ void __launch_bounds__(kThreads)
int4_mm_tc(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
           const float* __restrict__ scales, O* __restrict__ out, int m, int k, int n,
           int group, bool vec) {
  constexpr int kXS = KC + kXPad;
  constexpr int kMT = kBM / 16;  // 16-row tiles
  extern __shared__ __align__(128) unsigned char smem[];
  TileStage<KC>* stage = reinterpret_cast<TileStage<KC>*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k2 = k / 2;
  const int n_kp = k2 / group;       // groups per half
  const int per_group = group / KC;  // chunks per group
  const int n_chunks = n_kp * per_group;
  // rows staged and multiplied: whole 16-row tiles covering the valid rows
  const int rows = min(kBM, ((m - m0 + 15) / 16) * 16);

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
    if (st < n_chunks) load(st, st);
    cp_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (c + kStages - 1 < n_chunks) load((c + kStages - 1) % kStages, c + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    const TileStage<KC>& s = stage[c % kStages];
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
  store_tile(out, acc, m, n, m0, n0, rows, warp, lane);
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

template <int BN, int NT, typename O>
cudaError_t launch_decode(const void* x, const void* packed, const void* scales, void* out,
                          int m, int k, int n, int group, int cluster, int round_rows,
                          cudaStream_t stream) {
  const int mrows = 8 * ((m + 7) / 8), steps = k / 32;
  Plan pl;
  pl.m = m, pl.k = k, pl.n = n, pl.group = group;
  pl.lay = Layout(BN, mrows, k / 2, group, cluster, round_rows);
  const int smem = pl.lay.smem(BN, mrows, cluster);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  pl.share = (m * (BN / 4) + cluster - 1) / cluster;
  for (int r = 0; r <= cluster; ++r) pl.bounds[r] = 16 * (r * steps / cluster);
  pl.vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      int4_mm_decode<BN, NT, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return opt_in;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + BN - 1) / BN) * cluster);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int4_mm_decode<BN, NT, O>, static_cast<const bf16*>(x),
                            static_cast<const uint8_t*>(packed),
                            static_cast<const float*>(scales), static_cast<O*>(out), pl);
}

template <int BN, typename O>
cudaError_t launch_decode_rows(const void* x, const void* packed, const void* scales,
                               void* out, int m, int k, int n, int group, int cluster,
                               int round_rows, cudaStream_t stream) {
#define LAMP_I4_DEC(NT)                                                                    \
  return launch_decode<BN, NT, O>(x, packed, scales, out, m, k, n, group, cluster,         \
                                  round_rows, stream);
  if (m <= 8) LAMP_I4_DEC(1)
  if (m <= 16) LAMP_I4_DEC(2)
  if (m <= 32) LAMP_I4_DEC(4)
  LAMP_I4_DEC(8)
#undef LAMP_I4_DEC
}

template <int KC, typename O>
cudaError_t launch_tc(const void* x, const void* packed, const void* scales, void* out, int m,
                      int k, int n, int group, cudaStream_t stream) {
  constexpr int kSmem = kStages * sizeof(TileStage<KC>);
  // above 48 KB only as opted-in dynamic shared memory (set once)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      int4_mm_tc<KC, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  // 16-byte copies of the packed rows and the scale rows
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int4_mm_tc<KC, O><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<O*>(out), m, k, n, group, vec);
  return cudaGetLastError();
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
// 1 = bfloat16), all contiguous. The route follows from the inputs: bf16 x
// with group % 16 == 0 and m <= 64 takes the decode kernel, whose plan the
// caller gives (tile: BN of 32, 64 or 128; cluster: the blocks of 1-8 that
// split K for a tile; round_rows: packed rows staged at once, a multiple of
// 16); bf16 x with group % 16 == 0 and m > 64 the row-tiled kernel, f32 x
// or another group the scalar kernel, both with tile, cluster and
// round_rows 0. A plan for another route, or one the decode kernel cannot
// run (x not 16-byte aligned, more shared memory than a block has), is
// refused. Returns the cudaError_t of the launch.
int lamp_int4_matmul(const void* x, const void* packed, const void* scales, void* out, int m,
                     int k, int n, int group, int x_dtype, int out_dtype, int tile,
                     int cluster, int round_rows, void* stream) {
  if (m == 0 || n == 0) return cudaSuccess;
  if (m < 0 || n < 0 || k <= 0 || k % 2 || group <= 0 || (k / 2) % group)
    return cudaErrorInvalidValue;
  if (x_dtype < 0 || x_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = x_dtype == 1 && group % 16 == 0;
  if (tc && m <= 64) {
    if (cluster < 1 || cluster > 8 || cluster > k / 32 || round_rows < 16 ||
        round_rows % 16 || reinterpret_cast<uintptr_t>(x) % 16)
      return cudaErrorInvalidValue;
#define LAMP_I4_DEC_BN(BN)                                                                 \
  if (tile == BN)                                                                          \
    return out_dtype == 1 ? launch_decode_rows<BN, bf16>(x, packed, scales, out, m, k, n,  \
                                                         group, cluster, round_rows, st)   \
                          : launch_decode_rows<BN, float>(x, packed, scales, out, m, k, n, \
                                                          group, cluster, round_rows, st);
    LAMP_I4_DEC_BN(32)
    LAMP_I4_DEC_BN(64)
    LAMP_I4_DEC_BN(128)
#undef LAMP_I4_DEC_BN
    return cudaErrorInvalidValue;
  }
  if (tile != 0 || cluster != 0 || round_rows != 0) return cudaErrorInvalidValue;
  if (tc) {
    const int kc = group % 64 == 0 ? 64 : (group % 32 == 0 ? 32 : 16);
#define LAMP_I4_TC(KC)                                                             \
  if (kc == KC)                                                                    \
    return out_dtype == 1                                                          \
               ? launch_tc<KC, bf16>(x, packed, scales, out, m, k, n, group, st)   \
               : launch_tc<KC, float>(x, packed, scales, out, m, k, n, group, st);
    LAMP_I4_TC(64)
    LAMP_I4_TC(32)
    LAMP_I4_TC(16)
#undef LAMP_I4_TC
  }
  if (x_dtype == 1)
    return out_dtype == 1 ? launch_scalar<bf16, bf16>(x, packed, scales, out, m, k, n, group, st)
                          : launch_scalar<bf16, float>(x, packed, scales, out, m, k, n, group, st);
  return out_dtype == 1 ? launch_scalar<float, bf16>(x, packed, scales, out, m, k, n, group, st)
                        : launch_scalar<float, float>(x, packed, scales, out, m, k, n, group, st);
}

}  // extern "C"
