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
// Row-tiled kernel (int4_mm_tc: bf16 x, g a multiple of 16, M > 64: a
// speculative round's target chunk of B*k rows, an LM forward's rows). What
// bounds it: at 128 rows the bytes (a layer's matrix 0.3-0.8 MB packed, the
// 768 x 32000 logits 12.3 MB packed beside 16.4 MB of f32 output: 0.2-8.8
// us at 3.35 TB/s), at thousands of rows the products (2 M K N, 153 us for
// the logits at 3072 rows). Its design:
//  - The product is taken transposed, out^T = W^T x^T, on wgmma: the
//    dequantized weight is the register A operand (64 output columns a
//    consumer warpgroup) and x's rows the shared-memory B operand (K-major
//    as x lies, 64 or 128 rows: wgmma's N). One ldmatrix.trans of a step's
//    16 packed rows gives a lane both nibbles of its fragment's bytes, so
//    a byte is read once and feeds the low half's product and the high
//    half's; at M <= 256 a call reads each packed byte once.
//  - A producer warp keeps a ring of stages in flight by TMA (x's tiles and
//    the packed tile, swizzled as the consumers read them) and cp.async (the
//    scale rows), each on a stage's mbarrier.
//  - A pass is one half's products over one group's steps of a stage (8 at
//    most: 128 packed rows, 4 where a group is smaller), summed in f32 and
//    scaled by the group's scale row at its end, as the TPU kernel orders
//    it; the next pass's fragments are built while a pass's products run.
//    No pass divides: its descriptors are a base plus offsets.
//  - At 256 rows or fewer the tiles are too few for the card, so a
//    thread-block cluster splits K (at group boundaries where it can) and
//    sums its ranks' partial tiles by st.async into their owners' shared
//    memory, in rank order, as the decode kernel does; above, the grid is
//    persistent (a block an SM walking the tiles), so that one tile's
//    stores overlap the next one's loads.
// Where its time goes (scripts/exp_int4_tc_variants.py, its timelines and
// knock-outs): at 128 rows a layer's call is a chain of latencies (the
// block's setup and first stage, two passes, the cluster sum); at 3072
// rows the passes' products run near the tensor cores' rate for their N,
// and the scaling between passes and the re-reads of x (once per 128 output
// columns, through L2) take the rest.
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

constexpr int kThreads = 128;  // 4 warps (scalar kernel)

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

// the low nibbles of bytes 0 and 2 of (v >> shift) -> a bf16 pair of their
// values minus 8, exactly (0x4300 | c is 128 + c in bf16, 0x4308 is 136):
// one lop3 (mask and magic together) and one bf16x2 subtraction
__device__ __forceinline__ uint32_t nibbles(uint32_t v, int shift) {
  uint32_t bits;
  asm("lop3.b32 %0, %1, 0x000F000F, 0x43004300, 0xEA;\n" : "=r"(bits) : "r"(v >> shift));
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(bits), "r"(0x43084308u));
  return r;
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
// Row-tiled kernel (M > 64): wgmma, the dequantized weight as the register
// A operand
// ---------------------------------------------------------------------------

using hopper::sw_desc;

constexpr int kTcCols = 64;        // output columns of a consumer warpgroup (wgmma's M)
constexpr int kTcConsumers = 256;  // two consumer warpgroups a block
constexpr int kTcMaxStages = 4;
constexpr int kTcFull = 33;  // a stage's arrivals: 32 copy lanes and the TMA's
constexpr int kMapError = 10000;  // + libcuda's CUresult of a refused TMA map

// Byte layout of one stage of KC packed rows (64 or 128: KC / 16 steps) for
// a block of BN output columns over BM x rows, each part starting on a
// 1024-byte boundary:
//   x_lo [KC / 64][BM][64] bf16  x's low-half columns of the stage's rows,
//                         in column blocks of 64 (128-byte rows,
//                         128B-swizzled by TMA)
//   x_hi                  the high-half columns alike
//   w    [KC][BN]         packed bytes, a row's 16-byte chunk c at chunk
//                         c ^ tc_swizzle(row) (ldmatrix's 8 rows in 8 bank
//                         groups)
//   sc   [2][KC / 16 + 1][BN] f32  the scale rows of the groups the stage
//                         touches, low half then high half
__host__ __device__ constexpr int tc_slots(int kc) { return kc / 16 + 1; }
__host__ __device__ constexpr int tc_x_bytes(int bm, int kc) { return bm * kc * 2; }
__host__ __device__ constexpr int tc_stage_bytes(int bn, int bm, int kc) {
  return (2 * tc_x_bytes(bm, kc) + kc * bn + 2 * tc_slots(kc) * bn * 4 + 1023) / 1024 * 1024;
}
// the cluster sum's slots: [cluster][ceil(BM BN / 4 / cluster)] float4s
__host__ __device__ constexpr int tc_recv_bytes(int bn, int bm, int cluster) {
  return cluster > 1 ? cluster * ((bm * bn / 4 + cluster - 1) / cluster) * 16 : 0;
}

template <int W>
__device__ __forceinline__ int tc_swizzle(int r) {
  return W == 128 ? (r & 7) : ((r >> 1) & 3);
}

// D (m64nN, f32; N = 64 or 128) = (scale_d ? D : 0) + A B: A bf16 from
// registers, B bf16 from shared memory, K-major (x's rows, K contiguous),
// 128B-swizzled
template <int N>
__device__ __forceinline__ void wgmma_tc(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "m64n64k16 or m64n128k16");
  if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" LAMP_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : LAMP_ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" LAMP_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : LAMP_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void st_stream2(float* out, long long i, float a, float b) {
  asm volatile("st.global.cs.v2.f32 [%0], {%1, %2};\n" ::"l"(out + i), "f"(a), "f"(b)
               : "memory");
}
__device__ __forceinline__ void st_stream2(bf16* out, long long i, float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  asm volatile("st.global.cs.b32 [%0], %1;\n" ::"l"(out + i),
               "r"(*reinterpret_cast<uint32_t*>(&v))
               : "memory");
}

// What a launch of the row-tiled kernel needs beside its pointers.
struct TcPlan {
  int m, k, n, group;
  int steps;      // 16-row steps of a half (k / 32)
  int stages;     // the ring's stages
  int recv;       // byte offset of the cluster sum's slots, past the stages
  int col_tiles;  // tiles of BN columns
  int tiles;      // col_tiles x tiles of BM rows (the persistent walk's)
  bool tma_w;     // packed rows by TMA (else 4-byte cp.async pieces)
  bool vec_s;     // scale rows by 16-byte pieces (else 4-byte)
};

// x [m, k] bf16 (read by the TMA map tm_x in boxes of BM rows by 64
// columns), packed [k/2, n] (by tm_w in boxes of KC rows by BN columns,
// 64B- or 128B-swizzled, where n % 16 == 0 and packed is 16-byte aligned;
// else by 4-byte cp.async into the same layout), scales [k/g, n] f32, out
// [m, n]; n % 4 == 0. A block is two consumer warpgroups of WR x rows (64
// or 128) and a producer warpgroup (the last), whose first warp copies: the
// consumers split the tile's columns (RS false: BN = 128, BM = WR) or its
// rows (RS true: BN = 64, BM = 2 WR). A stage holds KC packed rows (KC /
// 16 steps of 16; 128 where the groups are whole multiples of 128 rows).
// Without a cluster the grid is persistent: block b takes the tiles b, b +
// gridDim.x, ... (column tiles fastest, so that the blocks at work share
// x's rows in L2), the ring of stages running on from one tile to the
// next, so that a tile's stores overlap the next one's loads. With a
// cluster (cs ranks), a cluster takes one tile (clusterid.x, blockIdx.y)
// and rank r the 16-row steps [r T / cs, (r + 1) T / cs) of the T = k/32
// steps of a half. The product is out^T = W^T x^T: warp q of a consumer
// holds the 16 output columns 16q.. of its warpgroup's 64 as wgmma's A rows
// (row g <- column 2g, row g + 8 <- column 2g + 1, so that one
// ldmatrix.trans of the packed bytes gives a lane both columns' codes at k
// = 2t, 2t + 1), and x's WR rows are wgmma's N.
template <bool RS, int WR, int KC, typename O>
__global__ void __launch_bounds__(kTcConsumers + 128, 1)
int4_mm_tc(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
           const uint8_t* __restrict__ packed, const float* __restrict__ scales,
           O* __restrict__ out, const TcPlan pl) {
  constexpr int BN = RS ? kTcCols : 2 * kTcCols;  // the block's output columns
  constexpr int BM = RS ? 2 * WR : WR;             // the block's x rows
  constexpr int kSteps = KC / 16;                  // steps a stage, and a pass's most
  constexpr int kSlots = tc_slots(KC);
  constexpr int kStage = tc_stage_bytes(BN, BM, KC), kX = tc_x_bytes(BM, KC);
  constexpr int kW = 2 * kX, kSc = kW + KC * BN;
  constexpr int kC4 = BN / 4;  // float4s of a tile row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[kTcMaxStages], empty[kTcMaxStages], recv_bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = pl.n, k2 = pl.k / 2, group = pl.group, S = pl.stages;
  const int s_begin = rank * pl.steps / cs, s_end = (rank + 1) * pl.steps / cs;
  const int n_st = (s_end - s_begin + kSteps - 1) / kSteps;  // stages a tile
  const bool producer = warp == kTcConsumers / 32;
  // the block's tiles: t0, t0 + dt, ... below pl.tiles (one with a cluster)
  int t0 = blockIdx.x, dt = gridDim.x;
  if (cs > 1) {
    uint32_t cid;
    asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(cid));
    t0 = blockIdx.y * pl.col_tiles + cid, dt = pl.tiles;
  }
  // with a cluster: the tile's float4s (valid rows), and the share of them
  // each rank owns in the cluster's sum
  const int total4 = min(BM, pl.m - (t0 / pl.col_tiles) * BM) * kC4;
  const int share = (total4 + cs - 1) / cs;

  // the producer warp's stage j (the tile's jt-th): x's two tiles and the
  // packed tile by TMA (lane 0; the packed tile by 4-byte cp.async over
  // the lanes where n % 16 != 0), the scale rows by cp.async over the
  // lanes, each lane's pieces arriving on the stage's barrier once landed
  auto load = [&](int j, int tile, int jt) {
    const int st = j % S, n_kp = k2 / group;
    const int n0 = (tile % pl.col_tiles) * BN, m0 = (tile / pl.col_tiles) * BM;
    if (j >= S) hopper::mbar_wait(&empty[st], ((j / S) - 1) & 1);
    unsigned char* sb = stages + st * kStage;
    const int r0 = 16 * (s_begin + kSteps * jt);  // the stage's first packed row
    if (lane == 0) {
      hopper::mbar_arrive_tx(&full[st], 2 * kX + (pl.tma_w ? KC * BN : 0));
#pragma unroll
      for (int c = 0; c < KC / 64; ++c) {
        hopper::tma_load_2d(sb + c * BM * 128, &tm_x, &full[st], r0 + 64 * c, m0);
        hopper::tma_load_2d(sb + kX + c * BM * 128, &tm_x, &full[st], k2 + r0 + 64 * c, m0);
      }
      if (pl.tma_w) hopper::tma_load_2d(sb + kW, &tm_w, &full[st], n0, r0);
    }
    if (!pl.tma_w) {  // rows past the half and columns past n zero-filled
      constexpr int kP = BN / 4;
      for (int c = lane; c < KC * kP; c += 32) {
        const int r = c / kP, p = c % kP, row = r0 + r, col = n0 + 4 * p;
        const bool in = row < k2 && col < n;
        hopper::cp_async_ca<4>(sb + kW + r * BN + 16 * ((p / 4) ^ tc_swizzle<BN>(r)) + 4 * (p % 4),
                               packed + (in ? (long long)row * n + col : 0), in);
      }
    }
    // the scale rows of the groups g0 .. g0 + ng - 1 that the stage's rows
    // touch, low half then high half
    const int g0 = r0 / group, ng = (min(r0 + KC, k2) - 1) / group - g0 + 1;
    float* sc = reinterpret_cast<float*>(sb + kSc);
    for (int h = 0; h < 2; ++h) {
      for (int gi = 0; gi < ng; ++gi) {
        const float* src = scales + (long long)(g0 + gi + h * n_kp) * n + n0;
        float* dst = sc + (h * kSlots + gi) * BN;
        if (pl.vec_s) {
          if (lane < BN / 4) cp_async16(dst + 4 * lane, src + 4 * lane, n0 + 4 * lane < n);
        } else {
          for (int p = lane; p < BN; p += 32) hopper::cp_async_ca<4>(dst + p, src + p, n0 + p < n);
        }
      }
    }
    hopper::cp_async_arrive_noinc(&full[st]);
  };

  // the producer's first lane fetches the TMA maps ahead of their first
  // use and sets up the barriers
  if (producer && lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x))
                 : "memory");
    if (pl.tma_w)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_w))
                   : "memory");
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(&full[i], kTcFull);
      hopper::mbar_init(&empty[i], kTcConsumers / 32);  // one a consumer warp
    }
    if (cs > 1) {  // every rank's share of this rank's elements
      hopper::mbar_init(&recv_bar, 1);
      hopper::mbar_arrive_tx(&recv_bar, cs * 16 * max(0, min(share, total4 - rank * share)));
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (cs > 1) cluster_arrive_relaxed();  // this rank's slots are ready

  if (warp >= kTcConsumers / 32) {
    // the producer warpgroup, of which the first warp copies; it gives
    // registers to the consumers
    hopper::regs_dec<40>();
    if (producer) {
      int j = 0;  // the ring's stage count, over the block's tiles
      for (int t = t0; t < pl.tiles; t += dt)
        for (int jt = 0; jt < n_st; ++jt, ++j) load(j, t, jt);
    }
    if (cs > 1) cluster_wait();
    return;
  }

  // a consumer warpgroup
  hopper::regs_inc<232>();
  const int wg = warp / 4, wq = warp % 4;
  const int cb = RS ? 0 : kTcCols * wg;  // its first column in the tile
  const int rb = RS ? WR * wg : 0;       // its first x row in the tile
  const int g_row = lane >> 2, t = lane & 3;
  const int chunk = (cb + 16 * wq) / 16;     // the warp's chunk of a packed row
  const int lrow = lane & 15;                // the row it addresses for ldmatrix
  const int col = cb + 16 * wq + 2 * g_row;  // its first column (of 2)
  if (t0 >= pl.tiles) return;  // a persistent block past the last tile

  // A pass: one half's products over the steps [s, e) of one stage (the
  // ring's j-th, in `slot`; the tile's jt-th), all in one group (the
  // stage's g-th): kSteps wgmma (a piece of fewer steps pads with zero
  // fragments over its first step's x columns, adding exact zeros for
  // finite x, so that no product is on a divergent path and ptxas keeps
  // them in flight together), summed in f32 in `part`, then scaled by the
  // group's scale row into `acc`. The next pass's fragments are built while
  // this pass's products run. Nothing here divides: the issue of a pass's
  // products is a few instructions each.
  struct Pass {
    int tile, jt, j, slot, phase;  // the stage: its tile, place, ring slot
    int n, gb;                     // its steps, the next group boundary in it
    int s, e, g, h;                // the piece's steps [s, e), group, half
  };
  const int gsteps = group / 16;  // steps a group
  auto enter = [&](Pass& p) {     // p at the first pass of its stage
    const int a0 = s_begin + kSteps * p.jt;
    p.n = min(kSteps, s_end - a0);
    p.gb = (a0 / gsteps + 1) * gsteps - a0;
    p.s = 0, p.e = min(p.n, p.gb), p.g = 0, p.h = 0;
  };
  // p to the next pass; false past the block's last. A new stage is waited
  // for here.
  auto advance = [&](Pass& p) {
    if (p.h == 0) {
      p.h = 1;
      return true;
    }
    p.h = 0;
    if (p.e < p.n) {
      p.s = p.e, p.gb += gsteps, ++p.g;
      p.e = min(p.n, p.gb);
      return true;
    }
    ++p.j;
    if (++p.slot == S) p.slot = 0, p.phase ^= 1;
    if (++p.jt == n_st) {
      p.jt = 0;
      p.tile += dt;
      if (p.tile >= pl.tiles) return false;
    }
    enter(p);
    hopper::mbar_wait(&full[p.slot], p.phase);
    return true;
  };
  // the A fragments of p's steps: one ldmatrix.trans of a step's 16 packed
  // rows at the warp's 16 columns gives a lane the bytes of k = 2t, 2t + 1
  // (w0) and 2t + 8, 2t + 9 (w1) of columns 2g, 2g + 1; half h's nibbles
  // become bf16 pairs. A step's rows start on a multiple of 16, so the
  // lane's swizzled chunk is the same in every step: its address is the
  // lane's base plus the step's offset, and padded steps read the piece's
  // first step and are zeroed by selects, not branches.
  const uint32_t w_lane = smem_addr(stages) + kW + lrow * BN + 16 * (chunk ^ tc_swizzle<BN>(lrow));
  auto build = [&](uint32_t (&af)[kSteps][4], const Pass& p) {
    const uint32_t w = w_lane + p.slot * kStage;
    const int sh = 4 * p.h;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const bool on = p.s + i < p.e;
      uint32_t w0, w1;
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(w0), "=r"(w1)
                   : "r"(w + (on ? p.s + i : p.s) * (16 * BN)));
      const uint32_t a0 = nibbles(w0, sh), a1 = nibbles(w0, 8 + sh);
      const uint32_t a2 = nibbles(w1, sh), a3 = nibbles(w1, 8 + sh);
      af[i][0] = on ? a0 : 0u;
      af[i][1] = on ? a1 : 0u;
      af[i][2] = on ? a2 : 0u;
      af[i][3] = on ? a3 : 0u;
    }
  };
  float acc[WR / 2], part[WR / 2];
  // x's 16-column slice of step i of p's stage: column block i / 4, byte
  // 32 (i % 4) of the warpgroup's rows; the descriptors are the pass's
  // first one plus each slice's offset (16-byte units)
  auto issue = [&](uint32_t (&af)[kSteps][4], const Pass& p) {
    const uint64_t d0 =
        sw_desc<128>(stages + p.slot * kStage + p.h * kX + rb * 128, 16, 1024);
    uint64_t desc[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const unsigned st = static_cast<unsigned>(p.s + i < p.e ? p.s + i : p.s);
      desc[i] = d0 + ((st >> 2) * (BM * 8) + 2 * (st & 3));
    }
    hopper::wg_keep(part);
    hopper::wg_keep(af);
    hopper::wg_fence();
#pragma unroll
    for (int i = 0; i < kSteps; ++i) wgmma_tc<WR>(part, af[i], desc[i], i > 0);
    hopper::wg_commit();
  };
  auto scale = [&](const Pass& p) {
    const float* sc = reinterpret_cast<const float*>(stages + p.slot * kStage + kSc);
    const float2 sv = *reinterpret_cast<const float2*>(sc + (p.h * kSlots + p.g) * BN + col);
#pragma unroll
    for (int i = 0; i < WR / 8; ++i) {
      acc[4 * i] += part[4 * i] * sv.x;
      acc[4 * i + 1] += part[4 * i + 1] * sv.x;
      acc[4 * i + 2] += part[4 * i + 2] * sv.y;
      acc[4 * i + 3] += part[4 * i + 3] * sv.y;
    }
  };
  // the tile's output: lane (g, t) holds, for each 8-row chunk i of its
  // warpgroup's rows, rows 8i + 2t (acc[4i], acc[4i + 2]) and 8i + 2t + 1
  // (acc[4i + 1], acc[4i + 3]) at columns 2g, 2g + 1 of its warp's 16
  auto finish = [&](int tile) {
    const int n0 = (tile % pl.col_tiles) * BN, m0 = (tile / pl.col_tiles) * BM;
    if (cs == 1) {
      // streaming stores: the output is written once and not read here
      if (n0 + col < n) {
#pragma unroll
        for (int i = 0; i < WR / 8; ++i) {
          const int row = m0 + rb + 8 * i + 2 * t;
          const long long o = (long long)row * n + n0 + col;
          if (row < pl.m) st_stream2(out, o, acc[4 * i], acc[4 * i + 2]);
          if (row + 1 < pl.m) st_stream2(out, o + n, acc[4 * i + 1], acc[4 * i + 3]);
        }
      }
      return;
    }
    // the cluster's sum (one tile a block): rank r owns the share [r S,
    // (r + 1) S) of the tile's float4s (a row's 4-column chunks, row after
    // row); lanes g and g ^ 1 swap a pair so that each holds a float4 of one
    // row (even g: row 8i + 2t, columns 2g..2g+3; odd g: row 8i + 2t + 1),
    // and every rank sends each of its float4s to the owner's slot for the
    // sender's rank, by st.async, which completes on the owner's barrier;
    // each owner, once every byte has landed, adds its slots in rank order
    // and stores, so two calls give the same bits
    cluster_wait();  // every rank's slots and barrier exist
    float4* recv = reinterpret_cast<float4*>(stages + pl.recv);
    const bool even = (g_row & 1) == 0;
#pragma unroll
    for (int i = 0; i < WR / 8; ++i) {
      const float s0 = even ? acc[4 * i + 1] : acc[4 * i];
      const float s1 = even ? acc[4 * i + 3] : acc[4 * i + 2];
      const float o0 = __shfl_xor_sync(0xffffffffu, s0, 4);
      const float o1 = __shfl_xor_sync(0xffffffffu, s1, 4);
      const float4 v = even ? make_float4(acc[4 * i], acc[4 * i + 2], o0, o1)
                            : make_float4(o0, o1, acc[4 * i + 1], acc[4 * i + 3]);
      const int row = rb + 8 * i + 2 * t + (even ? 0 : 1);
      const int e = row * kC4 + (even ? col : col - 2) / 4;
      if (e < total4) {
        const int q = e / share;
        st_async(map_rank(smem_addr(recv + rank * share + (e - q * share)), q), v,
                 map_rank(smem_addr(&recv_bar), q));
      }
    }
    hopper::mbar_wait(&recv_bar, 0);
    for (int i = tid; i < share && rank * share + i < total4; i += kTcConsumers) {
      float4 v = recv[i];
      for (int q = 1; q < cs; ++q) {
        const float4 u = recv[q * share + i];
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      const int e = rank * share + i, c = n0 + 4 * (e % kC4);
      if (c < n) store4(out, (long long)(m0 + e / kC4) * n + c, v);
    }
  };

#pragma unroll
  for (int i = 0; i < WR / 2; ++i) acc[i] = 0.f;
  Pass cur;
  cur.tile = t0, cur.jt = 0, cur.j = 0, cur.slot = 0, cur.phase = 0;
  enter(cur);
  uint32_t af0[kSteps][4], af1[kSteps][4];
  hopper::mbar_wait(&full[0], 0);
  build(af0, cur);
  // one pass: its products issued, the next pass's fragments built in
  // `next` meanwhile, its sum scaled into acc; the stage released after its
  // last pass, the tile stored after its last. The fragment buffers
  // alternate.
  auto step = [&](uint32_t (&af)[kSteps][4], uint32_t (&next)[kSteps][4]) {
    issue(af, cur);
    Pass nxt = cur;
    const bool more = advance(nxt);
    if (more) build(next, nxt);
    hopper::wg_wait<0>();
    hopper::wg_keep(part);
    hopper::wg_keep(af);
    scale(cur);
    if (!more || nxt.j != cur.j) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[cur.slot]);
    }
    if (!more || nxt.tile != cur.tile) {
      finish(cur.tile);
#pragma unroll
      for (int i = 0; i < WR / 2; ++i) acc[i] = 0.f;
    }
    cur = nxt;
    return more;
  };
  while (step(af0, af1) && step(af1, af0)) {
  }
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

// the card's SMs (the persistent grid's blocks), once a device
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

template <bool RS, int WR, int KC, typename O>
cudaError_t launch_tc(const void* x, const void* packed, const void* scales, void* out, int m,
                      int k, int n, int group, int cluster, cudaStream_t stream, int* map_rc) {
  constexpr int BN = RS ? kTcCols : 2 * kTcCols, BM = RS ? 2 * WR : WR;
  TcPlan pl;
  pl.m = m, pl.k = k, pl.n = n, pl.group = group, pl.steps = k / 32;
  if (cluster < 1 || cluster > kMaxCluster || cluster > pl.steps) return cudaErrorInvalidValue;
  const int stage = tc_stage_bytes(BN, BM, KC), recv = tc_recv_bytes(BN, BM, cluster);
  // 1 KB to align the stages, 1 KB for the static barriers
  pl.stages = (kMaxSmem - 2048 - recv) / stage;
  if (pl.stages > kTcMaxStages) pl.stages = kTcMaxStages;
  if (pl.stages < 2) return cudaErrorInvalidValue;
  pl.recv = pl.stages * stage;
  const int smem = 1024 + pl.recv + recv;
  pl.col_tiles = (n + BN - 1) / BN;
  pl.tiles = pl.col_tiles * ((m + BM - 1) / BM);
  pl.tma_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  pl.vec_s = reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  // the TMA maps; libcuda's encoder needs x's device current on this
  // thread: made so for the encode, and the caller's device restored
  CUtensorMap map_x, map_w = {};
  cudaPointerAttributes at;
  int current = 0;
  cudaError_t err = cudaPointerGetAttributes(&at, x);
  if (err == cudaSuccess) err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != at.device) err = cudaSetDevice(at.device);
  if (err != cudaSuccess) return err;
  *map_rc = hopper::row_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, m, k, 2LL * k, BM, 64,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (*map_rc == 0 && pl.tma_w)
    *map_rc = hopper::row_map(&map_w, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, k / 2, n, n, KC, BN,
                              BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  const int sms = sm_count();
  if (current != at.device) err = cudaSetDevice(current);
  if (*map_rc != 0) return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      int4_mm_tc<RS, WR, KC, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - 1024);
  if (opt_in != cudaSuccess) return opt_in;
  cudaLaunchConfig_t cfg = {};
  // without a cluster a persistent grid of a block an SM; with one, a
  // cluster a tile
  cfg.gridDim = cluster == 1 ? dim3(pl.tiles < sms ? pl.tiles : sms)
                             : dim3(pl.col_tiles * cluster, (m + BM - 1) / BM);
  cfg.blockDim = dim3(kTcConsumers + 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int4_mm_tc<RS, WR, KC, O>, map_x, map_w,
                            static_cast<const uint8_t*>(packed),
                            static_cast<const float*>(scales), static_cast<O*>(out), pl);
}

// the stage: 128 packed rows where a group is a whole multiple of 128 rows
// and two such stages fit beside the cluster's slots, else 64
template <bool RS, int WR, typename O>
cudaError_t launch_tc_kc(const void* x, const void* packed, const void* scales, void* out,
                         int m, int k, int n, int group, int cluster, cudaStream_t stream,
                         int* map_rc) {
  constexpr int BN = RS ? kTcCols : 2 * kTcCols, BM = RS ? 2 * WR : WR;
  if (group % 128 == 0 &&
      2 * tc_stage_bytes(BN, BM, 128) + tc_recv_bytes(BN, BM, cluster) <= kMaxSmem - 2048)
    return launch_tc<RS, WR, 128, O>(x, packed, scales, out, m, k, n, group, cluster, stream,
                                      map_rc);
  return launch_tc<RS, WR, 64, O>(x, packed, scales, out, m, k, n, group, cluster, stream,
                                   map_rc);
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
// 1 = bfloat16), all contiguous. The route follows from the inputs and the
// plan (tile, cluster, rows) the caller gives: bf16 x with group % 16 == 0
// and m <= 64 takes the decode kernel (tile: BN of 32, 64 or 128; cluster:
// the blocks of 1-8 that split K for a tile; rows: packed rows staged at
// once, a multiple of 16); bf16 x with group % 16 == 0, m > 64 and a plan
// the row-tiled kernel (tile: the block's output columns, 64 or 128;
// cluster: 1-8 blocks splitting K; rows: the block's x rows, 128, or 256
// with 64 columns), which takes n % 4 == 0, packed 4-byte and x 16-byte
// aligned; every other call, with tile, cluster and rows 0, the scalar
// kernel. A plan for another route, or one the kernel cannot run, is
// refused. Returns the cudaError_t of the launch, or kMapError + libcuda's
// CUresult when x's TMA map was refused.
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
  if (tc && (tile != 0 || cluster != 0 || round_rows != 0)) {
    if (n % 4 || reinterpret_cast<uintptr_t>(packed) % 4 || reinterpret_cast<uintptr_t>(x) % 16)
      return cudaErrorInvalidValue;
    int map_rc = 0;
    cudaError_t err = cudaErrorInvalidValue;
#define LAMP_I4_TC(RS, WR)                                                                  \
  err = out_dtype == 1                                                                      \
            ? launch_tc_kc<RS, WR, bf16>(x, packed, scales, out, m, k, n, group, cluster,   \
                                         st, &map_rc)                                       \
            : launch_tc_kc<RS, WR, float>(x, packed, scales, out, m, k, n, group, cluster,  \
                                          st, &map_rc);
    if (tile == 128 && round_rows == 128) {
      LAMP_I4_TC(false, 128)
    } else if (tile == 64 && round_rows == 128) {
      LAMP_I4_TC(true, 64)
    } else if (tile == 64 && round_rows == 256) {
      LAMP_I4_TC(true, 128)
    }
#undef LAMP_I4_TC
    return map_rc != 0 ? kMapError + map_rc : static_cast<int>(err);
  }
  if (tile != 0 || cluster != 0 || round_rows != 0) return cudaErrorInvalidValue;
  if (x_dtype == 1)
    return out_dtype == 1 ? launch_scalar<bf16, bf16>(x, packed, scales, out, m, k, n, group, st)
                          : launch_scalar<bf16, float>(x, packed, scales, out, m, k, n, group, st);
  return out_dtype == 1 ? launch_scalar<float, bf16>(x, packed, scales, out, m, k, n, group, st)
                        : launch_scalar<float, float>(x, packed, scales, out, m, k, n, group, st);
}

}  // extern "C"
