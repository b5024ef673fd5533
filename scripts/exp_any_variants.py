"""Experiment: the backward for f32, f64 and 16-bit above 256 (dq_any,
dkv_any in csrc/flash_backward_any.cu) against edited copies of itself,
on one CUDA card.

Each variant is flash_backward_any.cu with a few text edits (a knock-out,
or one design choice changed), built by scripts/kernel_variants.py into
lamp_tpu_torch/_build/any_variants/ and loaded beside the others. dq then
dkv run on the same inputs (causal, B=2, H=8, S=2048) in float64 at head
dims 64, 100 and 128 and in float32 at 64 and 100, timed by CUDA events
over back-to-back calls (each takes milliseconds, far above a call's host
time), in turns: each round runs every variant once. Prints each variant's
instances that ptxas reports with a stack frame or spills, then its median
dq and dkv time and the largest difference of its dq, dk and dv from the
unedited build's, relative to the largest value (0 when bit for bit;
knock-outs are not).

    python3 scripts/exp_any_variants.py        # from the repository root
    python3 scripts/exp_any_variants.py "f64 one stage of 16"   # one variant
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

OUT = ROOT / "lamp_tpu_torch" / "_build" / "any_variants"
SOURCE = "flash_backward_any.cu"

# name: [(text, replacement), ...] edits of flash_backward_any.cu
NO_LOADS = [("    load_rows<BC, D, ST>(s, str1, c0, n_str, ch * D, p.d);\n"
             "    load_rows<BC, D, ST>(s + BC * ST, str2, c0, n_str, ch * D, "
             "p.d);\n", "")]
NO_EXP = [("vis ? aexp(sc * scale - l) : A(0)", "vis ? sc * scale - l : A(0)")]
NO_SCORES = [("k0 < kend; k0 += 4) {", "k0 < 0; k0 += 4) {")]
NO_OUTPUT = [("k0 < BC; k0 += 4) {", "k0 < 0; k0 += 4) {")]
M16 = ("  asm(\"mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
       "{%0, %1, %2, %3}, \"\n"
       "      \"{%4, %5}, {%6}, {%0, %1, %2, %3};\\n\"\n"
       "      : \"+d\"(c0), \"+d\"(c1), \"+d\"(c2), \"+d\"(c3)\n"
       "      : \"d\"(a0), \"d\"(a1), \"d\"(b));")
M8 = ("  asm(\"mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, "
      "{%2}, {%3}, {%0, %1};\\n\"\n"
      "      : \"+d\"(c0), \"+d\"(c1) : \"d\"(a0), \"d\"(b));\n"
      "  asm(\"mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, "
      "{%2}, {%3}, {%0, %1};\\n\"\n"
      "      : \"+d\"(c2), \"+d\"(c3) : \"d\"(a1), \"d\"(b));")
TILES = ("  static constexpr int BC =\n"
         "      sizeof(T) == 8 ? (D > 112 ? 16 : D > 64 ? 32 : 64) : 64;\n"
         "  static constexpr int NS = sizeof(T) == 8 && D > 112 ? 2 : 1;")
VARIANTS = {
    "as built": [],
    # knock-outs: where the time goes
    "no exp": NO_EXP,
    "no S/dP products": NO_SCORES,
    "no output products": NO_OUTPUT,
    "no tile loads": NO_LOADS,
    "no tile loads, no work": NO_LOADS + NO_EXP + NO_SCORES + NO_OUTPUT,
    # design choices
    # sm_80's DMMA shape: the m16n8k4 as two m8n8k4 on the same fragments
    "f64 two m8n8k4": [(M16, M8)],
    "f32 one block an SM": [("return sizeof(T) == 4 && D <= 64 ? 2 : 1;",
                             "return 1;")],
    "two stages of 32 (f64: 16)": [(TILES, (
        "  static constexpr int BC = sizeof(T) == 8 && D > 64 ? 16 : 32;\n"
        "  static constexpr int NS = 2;"))],
    # f64 at D = 128 (the one instance with two stages): one stage of 16
    # (one of 32 would need 240384 bytes of shared memory in dkv, above the
    # 232448 a block may have)
    "f64 one stage of 16": [(
        "  static constexpr int NS = sizeof(T) == 8 && D > 112 ? 2 : 1;",
        "  static constexpr int NS = 1;")],
}
# (dtype, head dim) at B=2, H=8, S=2048, causal
SHAPES = ((torch.float64, 64), (torch.float64, 100), (torch.float64, 128),
          (torch.float32, 64), (torch.float32, 100))
B, H, S = 2, 8, 2048
ROUNDS, CALLS = 5, 5


def build(names):
    """Compile "as built" and the variants ``names`` (all when empty) at
    once; returns {name: loaded library}. Prints each variant's dq_any and
    dkv_any instances that have a stack frame or spills."""
    chosen = {name: edits for name, edits in VARIANTS.items()
              if name == "as built" or not names or name in names}
    libs, logs = kernel_variants.build(SOURCE, chosen, OUT)
    for name in chosen:
        print(f"{name}: instances with a stack frame or spills: "
              f"{kernel_variants.spills(logs[name], '_any')}", flush=True)
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_any_variants: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.cuda.get_device_name(0)} | {smi.strip()}", flush=True)
    t0 = time.perf_counter()
    libs = build(sys.argv[1:])
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    codes = {torch.float32: 0, torch.float64: 3}
    for dtype, d in SHAPES:
        scale = 1.0 / math.sqrt(d)
        q, k, v, do = chip_smoke.flash_inputs(B, H, S, S, d, dtype, seed=1)
        o, lse = att._fwd_cuda(q, k, v, None, True, scale, None)
        di = torch.empty(q.shape[:3], dtype=lse.dtype, device="cuda")
        grads = [torch.empty_like(x) for x in (q, k, v)]
        # no ids, no mask; then the shape
        args = (None, None, None, None, 0, 0, 0, 0, 1, 1, B * H, H, S, S, d,
                0, 0, 1, 0, scale, codes[dtype],
                torch.cuda.current_stream().cuda_stream)

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
                    same[name] = max(
                        float((x - y).abs().max() / y.abs().max())
                        for x, y in zip(got, want))
        print(f"B={B} H={H} S={S} D={d} causal {str(dtype)[6:]}, median of "
              f"{ROUNDS} rounds of {CALLS} calls:", flush=True)
        for name, (tq, tkv) in times.items():
            mq, mkv = sorted(tq)[ROUNDS // 2], sorted(tkv)[ROUNDS // 2]
            print(f"  {name:26} dq {mq * 1e3:8.1f} us  dkv {mkv * 1e3:8.1f} "
                  f"us  sum {(mq + mkv) * 1e3:8.1f} us  largest difference from "
                  f"as built {same[name]:.1e} (of the largest value)",
                  flush=True)


if __name__ == "__main__":
    main()
