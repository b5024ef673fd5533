"""Experiment: the forward for f32, f64 and 16-bit above 256 (fwd_any in
csrc/flash_forward_any.cu) against edited copies of itself, on one CUDA
card.

Each variant is flash_forward_any.cu with a few text edits (a knock-out,
or one design choice changed), built by scripts/kernel_variants.py into
lamp_tpu_torch/_build/fwd_any_variants/ and loaded beside the others. The
forward runs on the same inputs (causal) in float64 at head dims 64, 100
and 128 and in float32 at 64 and 100 (B=2, H=8, S=2048), at the f32
flagship's B=8, H=12, S=384, D=64, and in bfloat16 at D=320, timed by
CUDA events over back-to-back calls, in turns: each round runs every
variant once. Prints each variant's instances that ptxas reports with a
stack frame or spills, then its median time, the largest difference of
its o and lse from the unedited build's, relative to the largest value (0
when bit for bit; knock-outs are not), and its largest relative error of
o and of lse per 64-row block against the plain forward (f32; f64 for
float64), as chip_smoke.py's checks read it.

    python3 scripts/exp_fwd_any_variants.py     # from the repository root
    python3 scripts/exp_fwd_any_variants.py "no exp"      # one variant
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

OUT = ROOT / "lamp_tpu_torch" / "_build" / "fwd_any_variants"
SOURCE = "flash_forward_any.cu"

# name: [(text, replacement), ...] edits of flash_forward_any.cu
NO_LOADS = [("    load_rows<BC, D, ST>(s, k + kbase, c0, p.skv, ch * D, "
             "p.d);\n    if (with_v) load_rows<BC, D, ST>(s + BC * ST, v + "
             "kbase, c0, p.skv, ch * D, p.d);\n", "")]
NO_EXP = [("const A pr = fexp(sf[m][r][c][e] - mu);",
           "const A pr = sf[m][r][c][e] - mu;")]
NO_SCORES = [("min(D, p.d - ch * D), lane);", "0, lane);")]
NO_OUTPUT = [("    out_product<T, D, BC, ST, SX, false, false>(",
              "    if (false) out_product<T, D, BC, ST, SX, false, false>(")]
# 3xTF32 for the f32 (and 16-bit) products: each operand x split into
# big = tf32(x) and small = tf32(x - big), and a b taken as big big + big
# small + small big by mma.sync.m16n8k8.tf32 with f32 accumulation, in
# mma's fragment layout (ScoreFrag's and OutCols's float64 layouts: rows g
# and g + 8, columns 2t and 2t + 1); float64 keeps DMMA
TF32_CODE = r"""
__device__ __forceinline__ void split3(float x, uint32_t& big,
                                       uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c[0..3] (rows g, g, g + 8, g + 8; columns 2t, 2t + 1) += a b in 3xTF32
__device__ __forceinline__ void mma3(float& c0, float& c1, float& c2,
                                     float& c3, const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split3(b0, bb0, bs0);
  split3(b1, bb1, bs1);
  float c[4] = {c0, c1, c2, c3};
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
  c0 = c[0], c1 = c[1], c2 = c[2], c3 = c[3];
}
// the A fragment of rows g, g + 8 and columns k0 + t, k0 + t + 4 of x
// (row stride S), split
template <int S, typename T>
__device__ __forceinline__ void a_frag(uint32_t (&ab)[4], uint32_t (&as)[4],
                                       const T* x, int k0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const float a[4] = {to_acc(x[g * S + k0 + t]),
                      to_acc(x[(g + 8) * S + k0 + t]),
                      to_acc(x[g * S + k0 + t + 4]),
                      to_acc(x[(g + 8) * S + k0 + t + 4])};
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(a[i], ab[i], as[i]);
}
template <int BC, int ST, typename T>
__device__ __forceinline__ void score_tf32(float (&sf)[2][1][BC / 8][2],
                                           const T* a, const T* b, int kend,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
  for (int k0 = 0; k0 < kend; k0 += 8) {
    uint32_t ab[4], as[4];
    a_frag<ST>(ab, as, a, k0, lane);
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
      mma3(sf[0][0][n][0], sf[0][0][n][1], sf[1][0][n][0], sf[1][0][n][1],
           ab, as, to_acc(b[(8 * n + g) * ST + k0 + t]),
           to_acc(b[(8 * n + g) * ST + k0 + t + 4]));
  }
}
template <int BC, int ST>
__device__ __forceinline__ void score_tf32(double (&sf)[2][1][BC / 8][2],
                                           const double* a, const double* b,
                                           int kend, int lane) {
  score_product<BC, ST>(sf, a, b, kend, lane);
}
template <typename T, int D, int BC, int ST, int SX>
__device__ __forceinline__ void out_tf32(
    float (&acc)[2][OutCols<double, D, false>::NG][2], const float* x,
    const T* b, int half, int lane) {
  using OC = OutCols<double, D, false>;
  const int g = lane / 4, t = lane % 4;
  for (int k0 = 0; k0 < BC; k0 += 8) {
    uint32_t ab[4], as[4];
    a_frag<SX>(ab, as, x, k0, lane);
#pragma unroll
    for (int j = 0; j < OC::NG; ++j) {
      const int cb = 8 * OC::group(j, half) + g;
      mma3(acc[0][j][0], acc[0][j][1], acc[1][j][0], acc[1][j][1], ab, as,
           to_acc(b[(k0 + t) * ST + cb]), to_acc(b[(k0 + t + 4) * ST + cb]));
    }
  }
}
template <typename T, int D, int BC, int ST, int SX>
__device__ __forceinline__ void out_tf32(
    double (&acc)[2][OutCols<double, D, false>::NG][2], const double* x,
    const T* b, int half, int lane) {
  out_product<T, D, BC, ST, SX, false, false>(acc, x, b, half, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kAnyThreads, fwd_blocks_per_sm<T, D>())"""
KERNEL = ("template <typename T, int D>\n__global__ void __launch_bounds__("
          "kAnyThreads, fwd_blocks_per_sm<T, D>())")
TF32 = [(KERNEL, TF32_CODE.lstrip("\n")),
        ("  using F = ScoreFrag<A, BH>;",
         "  using F = ScoreFrag<double, BH>;"),
        ("  using OC = OutCols<A, D, false>;\n  constexpr int RH",
         "  using OC = OutCols<double, D, false>;\n  constexpr int RH"),
        ("  if constexpr (sizeof(A) == 8) return x[i][0];",
         "  if constexpr (true) return x[i][0];"),
        ("constexpr int kLanes = sizeof(A) == 8 ? 4 : 8;",
         "constexpr int kLanes = 4;"),
        ("score_product<BH, ST>(sf, qs + R * ST,",
         "score_tf32<BH, ST>(sf, qs + R * ST,"),
        ("    out_product<T, D, BC, ST, SX, false, false>(",
         "    out_tf32<T, D, BC, ST, SX>(")]
VARIANTS = {
    "as built": [],
    # knock-outs: where the time goes
    "no exp": NO_EXP,
    "no S products": NO_SCORES,
    "no output products": NO_OUTPUT,
    "no tile loads": NO_LOADS,
    "no tile loads, no work": NO_LOADS + NO_EXP + NO_SCORES + NO_OUTPUT,
    # design choices
    "f32 3xTF32": TF32,
    "f32 one block an SM": [("return sizeof(T) == 4 && D <= 64 ? 2 : 1;",
                             "return 1;")],
    # f32 up to D = 64 and 16-bit: 128-key tiles, 64 keys a warp, 4 x 8
    # scores a lane; one block an SM (f32 at D = 128 would need 270336
    # bytes)
    "f32 tiles of 128 keys": [
        ("static constexpr int BC = sizeof(T) == 8 && D > 64 ? 32 : 64;",
         "static constexpr int BC = sizeof(T) == 8 ? (D > 64 ? 32 : 64) : "
         "sizeof(T) == 4 && D > 64 ? 64 : 128;"),
        ("return sizeof(T) == 4 && D <= 64 ? 2 : 1;", "return 1;")],
    # the special-function unit's 2^x (ex2.approx.ftz, relative error about
    # 2^-22) for exp2f
    "f32 ex2.approx": [("return exp2f(x);", "return fast_exp2(x);")],
}
# (dtype, head dim, B, H, S), causal
SHAPES = ((torch.float64, 64, 2, 8, 2048), (torch.float64, 100, 2, 8, 2048),
          (torch.float64, 128, 2, 8, 2048), (torch.float32, 64, 2, 8, 2048),
          (torch.float32, 100, 2, 8, 2048), (torch.float32, 64, 8, 12, 384),
          (torch.bfloat16, 320, 2, 8, 2048))
ROUNDS, CALLS = 5, 5
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 3}


def build(names):
    """Compile "as built" and the variants ``names`` (all when empty) at
    once; returns {name: loaded library}. Prints each variant's fwd_any
    instances that have a stack frame or spills."""
    chosen = {name: edits for name, edits in VARIANTS.items()
              if name == "as built" or not names or name in names}
    libs, logs = kernel_variants.build(SOURCE, chosen, OUT)
    for name in chosen:
        print(f"{name}: instances with a stack frame or spills: "
              f"{kernel_variants.spills(logs[name], 'fwd_any')}", flush=True)
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_fwd_any_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.cuda.get_device_name(0)} | {smi.strip()}", flush=True)
    t0 = time.perf_counter()
    libs = build(sys.argv[1:])
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for dtype, d, b, h, s in SHAPES:
        scale = 1.0 / math.sqrt(d)
        q, k, v, _ = chip_smoke.flash_inputs(b, h, s, s, d, dtype, seed=1)
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.promote_types(
            dtype, torch.float32), device="cuda")
        # no kv limits, ids or mask; then the shape
        args = (None, o.data_ptr(), lse.data_ptr(), None, None, None, None,
                0, 0, 0, 0, 1, 1, b * h, h, s, s, d, 0, 0, 1, 0, scale,
                CODES[dtype], torch.cuda.current_stream().cuda_stream)

        def fwd(lib):
            rc = lib.lamp_flash_attention_fwd(q.data_ptr(), k.data_ptr(),
                                              v.data_ptr(), *args)
            assert rc == 0, rc

        acc = torch.promote_types(dtype, torch.float32)
        with torch.no_grad():
            want = att.flash_attention_reference(
                *(x.to(acc) for x in (q, k, v)), causal=True)
        times = {name: [] for name in libs}
        same, errs = {}, {}
        first = None
        for r in range(ROUNDS):
            for name, lib in libs.items():
                times[name].append(chip_smoke.cuda_time_ms(lambda: fwd(lib),
                                                           CALLS, warmup=1))
                if r == 0:
                    fwd(lib)
                    torch.cuda.synchronize()
                    got = (o.clone(), lse.clone())
                    first = first or got
                    same[name] = max(
                        float((x.to(acc) - y.to(acc)).abs().max()
                              / y.to(acc).abs().max())
                        for x, y in zip(got, first))
                    errs[name] = (chip_smoke.block_err(got[0], want[0]),
                                  chip_smoke.lse_block_err(got[1], want[1]))
        print(f"B={b} H={h} S={s} D={d} causal {str(dtype)[6:]}, median of "
              f"{ROUNDS} rounds of {CALLS} calls:", flush=True)
        for name, ts in times.items():
            ms = sorted(ts)[ROUNDS // 2]
            print(f"  {name:26} {ms * 1e3:9.1f} us  largest difference from "
                  f"as built {same[name]:.1e} (of the largest value); block "
                  f"error o {errs[name][0]:.1e} lse {errs[name][1]:.1e}",
                  flush=True)
        del q, k, v, o, lse, want


if __name__ == "__main__":
    main()
