"""Experiment: the ragged 16-bit backward (dq_tc/dkv_tc and dq_wide/dkv_wide
with R: head dims that are not a multiple of 8, whose tiles the producer
warpgroup copies by cp.async) against edited copies of itself, on one CUDA
card.

Each variant is a few text edits of csrc/flash_attention.cu (the D=32,
64 and 128 instances) or csrc/flash_backward_wide.cu (D=192 and 256),
built by scripts/kernel_variants.py into lamp_tpu_torch/_build/variants/
and loaded beside the others (each source's variants in a build of their
own). Each runs dq then dkv on the same inputs (bf16, causal, B=2, H=8,
S=2048) at the head dims of its source: 12, 75 and 100 (flash_attention.cu)
or 130 and 250 (flash_backward_wide.cu), timed by CUDA events over
back-to-back calls, in turns: each round runs every variant once. Prints
each variant's median dq and dkv time and whether its dq, dk and dv equal
the unedited build's bit for bit (a knock-out computes something else),
and the spill lines of its build.

    python3 scripts/exp_ragged_bwd_variants.py [variant ...]   # from the root

Variant names as arguments build and time only those beside "as built".
"""

import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import kernel_variants  # noqa: E402
from lamp_tpu_torch.ops import attention as att  # noqa: E402

OUT = ROOT / "lamp_tpu_torch" / "_build" / "variants"

# The ragged producers live in flash_common.cuh (produce_dq, produce_dkv),
# which a variant of flash_attention.cu edits inlined in place of its
# #include; flash_backward_wide.cu's variants alike.
_HEADER = (ROOT / "lamp_tpu_torch" / "csrc" / "flash_common.cuh").read_text()
_INLINE = ('#include "flash_common.cuh"', _HEADER)

# the copies knocked out: the producer arrives on each stage without
# copying (the consumers compute on stale tiles): the copies' cost
_NO_COPIES = [_INLINE, ("copy_ragged<", "if (false) copy_ragged<")]

# The bulk-copy design (a design PERF.md §7 had listed as untried), in
# produce_dq and produce_dkv: a streamed tile whose rows lie whole inside
# the matrix and start 16-byte aligned is one contiguous span of ROWS 2d
# bytes, brought by one cp.async.bulk a matrix into a staging slot (kSlots
# slots after the ring, one mbarrier each, issued kSlots tiles ahead by
# the producer's first thread), then laid out into the ring stage's
# swizzle by the producer's 128 threads, who arrive on the stage's `full`
# barrier plainly and meet at named barrier 3 before the slot is
# refilled; other tiles take the pieces, and so do the resident tiles.
# Dynamic shared memory grows by kSlots x 2 spans (+ 32 bytes each).
_BULK_HELPERS = r"""
constexpr int kSlots = 1;

// cp.async.bulk: `bytes` (a multiple of 16) from global src to shared dst,
// both 16-byte aligned, completing on bar by transaction bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}
// rows [row0, row0 + ROWS) of a [n, d] matrix g lie inside it and start
// 16-byte aligned: one bulk copy
template <int ROWS, typename T>
__device__ __forceinline__ bool bulk_ok(const T* g, int row0, int n, int d) {
  return row0 + ROWS <= n &&
         (reinterpret_cast<uintptr_t>(g + (long long)row0 * d) & 15) == 0;
}
// a staged span of ROWS rows of d elements into the W-swizzled tile, the
// pieces of V elements of walk w (8-, 4- or 2-byte loads and stores)
template <int ROWS, int W, int V>
__device__ __forceinline__ void relayout(unsigned char* tile,
                                         const unsigned char* stg, int d,
                                         Walk w) {
  for (int c = w.c; c < d; c += 128 * V)
    for (int r = w.r; r < ROWS; r += w.dr) {
      const unsigned char* s = stg + ((long long)r * d + c) * 2;
      unsigned char* o = tile + swizzled<ROWS, W>(r, c);
      if constexpr (V == 4)
        *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(s);
      else if constexpr (V == 2)
        *reinterpret_cast<uint32_t*>(o) =
            *reinterpret_cast<const uint32_t*>(s);
      else
        *reinterpret_cast<unsigned short*>(o) =
            *reinterpret_cast<const unsigned short*>(s);
    }
}
// the same by 16-byte chunks: each destination chunk (8 columns of a row)
// from two aligned 16-byte loads funnel-shifted by the row's misalignment
// (2 r d mod 16 bytes), its columns past d zeroed; one 16-byte store
__device__ __forceinline__ uint4 shifted16(uint4 a, uint4 b, int s) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = s >> 2;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    x[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = (s & 2) ? __funnelshift_r(x[j], x[j + 1], 16) : x[j];
  return make_uint4(o[0], o[1], o[2], o[3]);
}
template <int ROWS, int W, int V>
__device__ __forceinline__ void relayout16(unsigned char* tile,
                                           const unsigned char* stg, int d,
                                           Walk) {
  const int nk = (d + 7) / 8;
  const Walk w = walk_of(threadIdx.x, nk * 8, 8);
  for (int c = w.c; c < d; c += 128 * 8)
    for (int r = w.r; r < ROWS; r += w.dr) {
      const int o = (r * d + c) * 2;
      const unsigned char* base = stg + (o & ~15);
      uint4 v = shifted16(*reinterpret_cast<const uint4*>(base),
                          *reinterpret_cast<const uint4*>(base + 16), o & 15);
      const int e = d - c;  // columns of the chunk inside d
      if (e < 8) {
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          u[j] = 2 * j + 2 <= e ? u[j] : 2 * j + 1 == e ? (u[j] & 0xffffu) : 0u;
      }
      *reinterpret_cast<uint4*>(tile + swizzled<ROWS, W>(r, c)) = v;
    }
}
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 3, 128;\n" ::: "memory");
}
// the staging slots' mbarriers, set up by the producer's first thread
template <int S>
__device__ __forceinline__ uint64_t* staging_bars() {
  __shared__ __align__(8) uint64_t sbar[S];
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) hopper::mbar_init(&sbar[s], 1);
    hopper::mbar_fence_init();
  }
  producer_sync();
  return sbar;
}

"""

# produce_dq's and produce_dkv's tile loops, and the bulk loops that take
# their place (ROW: the tile's first row; G0, G1: its two matrices; L: the
# loaded() argument; EXTRA: what the loop does after the copies)
_LOOP = """    int n = 0;  // tiles loaded
    for (int i = 0; i < tiles; ++i) {{
      const int {row} = first + i * {rows};
      if (!loaded({arg})) continue;
      const int st = n % ST;
      hopper::mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
      ++n;
"""
_BULK_LOOP = """    uint64_t* sbar = staging_bars<kSlots>();
    const int span = {rows} * p.d * 2 + 32;
    unsigned char* stg = ring + ST * 2 * kTile;
    auto ok = [&](int x0) {{
      return bulk_ok<{rows}>({g0}, x0, {n}, p.d) &&
             bulk_ok<{rows}>({g1}, x0, {n}, p.d);
    }};
    int ii = 0, jj = 0;
    auto issue = [&]() {{  // the first thread: the next loaded tile's spans
      while (ii < tiles && !loaded({arg_ii})) ++ii;
      if (ii >= tiles) return;
      const int x0 = first + ii * {rows}, s = jj % kSlots;
      if (ok(x0)) {{
        hopper::mbar_arrive_tx(&sbar[s], 2 * (span - 32));
        bulk_copy(stg + s * 2 * span, {g0} + (long long)x0 * p.d, span - 32,
                  &sbar[s]);
        bulk_copy(stg + s * 2 * span + span, {g1} + (long long)x0 * p.d,
                  span - 32, &sbar[s]);
      }} else {{
        hopper::mbar_arrive(&sbar[s]);
      }}
      ++ii;
      ++jj;
    }};
    if (tid == 0)
      for (int s = 0; s < kSlots; ++s) issue();
    int n = 0;  // tiles loaded
    for (int i = 0; i < tiles; ++i) {{
      const int {row} = first + i * {rows};
      if (!loaded({arg})) continue;
      const int st = n % ST, s = n % kSlots;
      hopper::mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
      hopper::mbar_wait(&sbar[s], (n / kSlots) & 1);
      ++n;
"""
_DQ_COPIES = """      if constexpr (M) {  // the tile's kv ids, with K
        for (int u = tid; u < BC; u += 128) {
          const bool in = p.q_ids != nullptr && c0 + u < p.skv;
          const int* src = in ? p.kv_ids + (long long)b * p.skv + c0 + u
                              : reinterpret_cast<const int*>(kg);
          if constexpr (V == 1)
            kid[st * BC + u] = in ? *src : 0;
          else
            cp_async_ca<4>(&kid[st * BC + u], src, in);
        }
      }
      unsigned char* dst = ring + st * 2 * kTile;
      copy_ragged<BC, W, V, 8>(dst, kg, c0, p.skv, p.d, w, tid);
      copy_ragged<BC, W, V, 8>(dst + kTile, vg, c0, p.skv, p.d, w, tid);
      arrive_copies<V>(&full[st]);
    }
"""
_DQ_BULK_COPIES = """      if constexpr (M) {
        for (int u = tid; u < BC; u += 128)
          kid[st * BC + u] = p.q_ids != nullptr && c0 + u < p.skv
                                 ? p.kv_ids[(long long)b * p.skv + c0 + u] : 0;
      }
      unsigned char* dst = ring + st * 2 * kTile;
      if (ok(c0)) {
        RELAYOUT<BC, W, V>(dst, stg + s * 2 * span, p.d, w);
        RELAYOUT<BC, W, V>(dst + kTile, stg + s * 2 * span + span, p.d, w);
        hopper::mbar_arrive(&full[st]);
      } else {
        copy_ragged<BC, W, V, 8>(dst, kg, c0, p.skv, p.d, w, tid);
        copy_ragged<BC, W, V, 8>(dst + kTile, vg, c0, p.skv, p.d, w, tid);
        arrive_copies<V>(&full[st]);
      }
      producer_sync();
      if (tid == 0) {
        hopper::fence_proxy_async();
        issue();
      }
    }
"""
_DKV_COPIES = """      unsigned char* dst = ring + st * 2 * kTile;
      copy_ragged<BR, W, V, 8>(dst, qg, r0, p.sq, p.d, w, tid);
      copy_ragged<BR, W, V, 8>(dst + kTile, dg, r0, p.sq, p.d, w, tid);
      arrive_copies<V>(&full[st]);
"""
_DKV_BULK_COPIES = """      unsigned char* dst = ring + st * 2 * kTile;
      if (ok(r0)) {
        RELAYOUT<BR, W, V>(dst, stg + s * 2 * span, p.d, w);
        RELAYOUT<BR, W, V>(dst + kTile, stg + s * 2 * span + span, p.d, w);
        hopper::mbar_arrive(&full[st]);
      } else {
        copy_ragged<BR, W, V, 8>(dst, qg, r0, p.sq, p.d, w, tid);
        copy_ragged<BR, W, V, 8>(dst + kTile, dg, r0, p.sq, p.d, w, tid);
        arrive_copies<V>(&full[st]);
      }
"""
# dkv's loop goes on to the row statistics; the slot is released after them
_DKV_TAIL = """        hopper::mbar_arrive(&full[st]);
      }
    }
  });
}
"""
_DKV_BULK_TAIL = """        hopper::mbar_arrive(&full[st]);
      }
      producer_sync();
      if (tid == 0) {
        hopper::fence_proxy_async();
        issue();
      }
    }
  });
}
"""


def _bulk(slots, stages=4, relayout="relayout"):
    dq = dict(row="c0", rows="BC", arg="i", arg_ii="ii", g0="kg", g1="vg",
              n="p.skv")
    dkv = dict(row="r0", rows="BR", arg="r0", arg_ii="first + ii * BR",
               g0="qg", g1="dg", n="p.sq")
    return [
        _INLINE,
        ("// The ragged producer of the dq kernels",
         _BULK_HELPERS.replace("kSlots = 1", f"kSlots = {slots}")
         + "// The ragged producer of the dq kernels"),
        ("constexpr int kStages = 4;", f"constexpr int kStages = {stages};"),
        (_LOOP.format(**dq) + _DQ_COPIES,
         _BULK_LOOP.format(**dq)
         + _DQ_BULK_COPIES.replace("RELAYOUT", relayout)),
        (_LOOP.format(**dkv) + _DKV_COPIES,
         _BULK_LOOP.format(**dkv)
         + _DKV_BULK_COPIES.replace("RELAYOUT", relayout)),
        (_DKV_TAIL, _DKV_BULK_TAIL),
        ("launch(kernel, grid, kBwdThreads, smem_dq<D>(), st,",
         "launch(kernel, grid, kBwdThreads, smem_dq<D>() +\n"
         "                    kSlots * 2 * (dq_kv_tile(D) * head_dim * 2 + 32),"
         " st,"),
        ("launch(kernel, grid, kBwdThreads, smem_dkv<D>(), st,",
         "launch(kernel, grid, kBwdThreads, smem_dkv<D>() +\n"
         "                    kSlots * 2 * (dkv_q_tile(D) * head_dim * 2 + 32),"
         " st,"),
    ]


# 16-byte pieces where a row allows them: at d % 8 == 4 every other row of
# the tile starts 16-byte aligned (parity from the tile's first element),
# so its first d - 4 columns go as 16-byte cp.async pieces, one 8-byte
# piece after them; the other rows, and every other d, as before
_PAIRS = r"""
template <int ROWS, int W, int V, int NB, typename T>
__device__ __forceinline__ void copy_ragged2(unsigned char* tile, const T* g,
                                             int row0, int n, int d, Walk w,
                                             int tid) {
  if constexpr (V == 4) {
    if (d % 8 == 4) {
      // rows r with r % 2 == par start 16-byte aligned
      const int par = static_cast<int>(
          (reinterpret_cast<uintptr_t>(g + (long long)row0 * d) >> 3) & 1);
      const Walk wa = walk_of(tid, d + 4, 8), wb = walk_of(tid, d, 4);
      for (int c = wa.c; c < d; c += 128 * 8)
        for (int a = wa.r; a < ROWS / 2; a += wa.dr) {
          const int r = 2 * a + par;
          const bool in = row0 + r < n;
          const T* src = g + (in ? (long long)(row0 + r) * d + c : c);
          if (c + 8 <= d)
            hopper::cp_async16(tile + swizzled<ROWS, W>(r, c), src, in);
          else
            hopper::cp_async_ca<8>(tile + swizzled<ROWS, W>(r, c), src, in);
        }
      for (int c = wb.c; c < d; c += 128 * 4)
        for (int a = wb.r; a < ROWS / 2; a += wb.dr) {
          const int r = 2 * a + 1 - par;
          const bool in = row0 + r < n;
          hopper::cp_async_ca<8>(tile + swizzled<ROWS, W>(r, c),
                                 g + (in ? (long long)(row0 + r) * d + c : c),
                                 in);
        }
      return;
    }
  }
  copy_ragged<ROWS, W, V, NB>(tile, g, row0, n, d, w, tid);
}

"""
_PAIRS_EDITS = [_INLINE, ("copy_ragged<", "copy_ragged2<"),
                ("// The ragged producer of the dq kernels",
                 _PAIRS + "// The ragged producer of the dq kernels")]

# (source, head dims, {name: [(text, replacement), ...]})
SOURCES = (
    ("flash_attention.cu", (12, 75, 100), {
        "as built": [],
        "no copies": _NO_COPIES,
        # the ring's stages (4 as built) of dq_tc's K/V and dkv_tc's Q/dO
        "2 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
        "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
        # bulk copies into staging slots (4 ring stages beside one slot; 3
        # beside two, which fit at D=128 only so)
        "bulk, 1 slot": _bulk(1),
        "bulk, 2 slots, 3 stages": _bulk(2, 3),
        "bulk, 16-byte relayout, 1 slot": _bulk(1, 4, "relayout16"),
        "bulk, 16-byte relayout, 2 slots, 3 stages": _bulk(2, 3, "relayout16"),
        "16-byte pieces on aligned rows": _PAIRS_EDITS,
    }),
    ("flash_backward_wide.cu", (130, 250), {
        "as built": [],
        "no copies": _NO_COPIES,
    }),
)
ROUNDS, CALLS = 5, 10


def time_source(source, dims, variants):
    t0 = time.perf_counter()
    libs, logs = kernel_variants.build(source, variants, OUT / source[:-3])
    print(f"{source}: {len(libs)} variants built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        for kernel in ("dq_", "dkv_"):
            for line in kernel_variants.spills(logs[name], kernel):
                print(f"  {name}: {kernel}{line}", flush=True)
    for d in dims:
        b, h, s = 2, 8, 2048
        scale = 1.0 / math.sqrt(d)
        q, k, v, do = chip_smoke.flash_inputs(b, h, s, s, d, torch.bfloat16,
                                              seed=1)
        o, lse = att._fwd_cuda(q, k, v, None, True, scale, None)
        di = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        grads = [torch.empty_like(x) for x in (q, k, v)]
        # no ids, no mask; then the shape
        args = (None, None, None, None, 0, 0, 0, 0, 1, 1, b * h, h, s, s, d,
                0, 0, 1, 0, scale, 1, torch.cuda.current_stream().cuda_stream)

        def dq(lib):
            rc = lib.lamp_flash_attention_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), di.data_ptr(), None,
                grads[0].data_ptr(), *args)
            assert rc == 0, rc

        def dkv(lib):
            rc = lib.lamp_flash_attention_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), None, grads[1].data_ptr(),
                grads[2].data_ptr(), *args)
            assert rc == 0, rc

        times = {name: ([], []) for name in libs}
        same = {}
        want = None
        for r in range(ROUNDS):
            for name, lib in libs.items():
                for fn, out in ((dq, times[name][0]), (dkv, times[name][1])):
                    fn(lib)  # dq first: dkv reads its di
                    out.append(chip_smoke.cuda_time_ms(lambda: fn(lib),
                                                       CALLS, warmup=1))
                if r == 0:
                    dq(lib)
                    dkv(lib)
                    torch.cuda.synchronize()
                    got = [x.clone() for x in grads]
                    want = want or got
                    same[name] = all(torch.equal(x, y)
                                     for x, y in zip(got, want))
        print(f"B={b} H={h} S={s} D={d} causal bf16, median of {ROUNDS} "
              f"rounds of {CALLS} calls:", flush=True)
        for name, (tq, tkv) in times.items():
            mq, mkv = sorted(tq)[ROUNDS // 2], sorted(tkv)[ROUNDS // 2]
            print(f"  {name:22} dq {mq * 1e3:7.1f} us  dkv {mkv * 1e3:7.1f} "
                  f"us  sum {(mq + mkv) * 1e3:7.1f} us  equal to as-built "
                  f"{same[name]}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_ragged_bwd_variants: needs a CUDA card")
    chosen = sys.argv[1:]
    known = {name for _, _, variants in SOURCES for name in variants}
    unknown = set(chosen) - known
    if unknown:
        raise SystemExit(f"exp_ragged_bwd_variants: unknown {sorted(unknown)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.cuda.get_device_name(0)} | {smi.strip()}", flush=True)
    for source, dims, variants in SOURCES:
        picked = {name: edits for name, edits in variants.items()
                  if not chosen or name in chosen or name == "as built"}
        if len(picked) > 1:
            time_source(source, dims, picked)


if __name__ == "__main__":
    main()
