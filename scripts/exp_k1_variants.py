"""Experiment: the wgmma flash-attention forward (K1, fwd_wg in
csrc/flash_forward.cu) against edited copies of itself, on one CUDA card.

Each variant is csrc/flash_forward.cu with a few text edits (one design
choice changed), built by scripts/kernel_variants.py into
lamp_tpu_torch/_build/k1_variants/ and loaded beside the others. Each runs
the forward on the same inputs (causal) at the training slice's B=2, H=12,
S=4096, D=64 bf16 (also non-causal), the flagship's B=8, H=12, S=384,
phase 10's packed shapes (B=4, H=12, S=2048 with segment ids: the time
includes the class map's kernel) and B=2, H=8, S=2048 at head dims 128,
160 and 256, and at the ragged head dims 12, 75, 100 and 130 beside the
multiples of 8 of the same instances (16, 104, 136), timed by torch.profiler device time (chip_smoke.device_ms) in turns:
each round runs every variant once. Prints each variant's median time a
call, its largest block error against the plain f32 forward
(chip_smoke.block_err) and its largest difference from the unedited
build's output, and for the variant "timeline" the share of its consumers'
cycles in each stretch of the loop (clock64 marks, inserted by the edits);
first, for each source, how many of its kernels ptxas reports with
serialized wgmma instructions (warning C7520) and which fwd_wg kernels
have a stack frame or spills.

    python3 scripts/exp_k1_variants.py [variant ...] [--ragged]

(from the repository root; variant names build and time only those beside
"as built", --ragged only the ragged head dims and their neighbours)
"""

import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import kernel_variants  # noqa: E402
from lamp_tpu_torch.ops import attention as att  # noqa: E402

OUT = ROOT / "lamp_tpu_torch" / "_build" / "k1_variants"

# name: [(text, replacement), ...] edits of flash_forward.cu
NO_S = ("wgmma_ss<BC, T>(s, desc_k<64, W>(qh, kk), desc_k<BC, W>(kt, kk),\n"
        "                        kk > 0);", "s[kk] = 0.f;")
NO_PV = ("pv_product<D, BC, W, T>(acc, pa, vs + held * kTile);",
         "hopper::wg_commit();")
NO_EXP = ("fast_exp2(fmaf(s[i2", "(fmaf(s[i2")
# clock64 marks in the consumer loop: the first warp of each consumer adds
# the cycles spent in each stretch to a device counter, which the script
# reads before and after one call (lamp_prof_read)
SEGMENTS = ("wait K", "issue S, P V", "wait S", "softmax", "wait P V",
            "rescale, pack")
TIMELINE = [
    ("namespace {\n\nusing namespace lamp_flash;",
     "__device__ unsigned long long lamp_prof[8];\n"
     "extern \"C\" int lamp_prof_read(void* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, lamp_prof, sizeof(lamp_prof));\n"
     "}\n#define MARK(i) { const long long t_ = clock64(); pt[i] += t_ - tc; "
     "tc = t_; }\nnamespace {\n\nusing namespace lamp_flash;"),
    ("    int n = 0;      // tiles loaded, as the producer counts them",
     "    int n = 0;\n    unsigned long long pt[6] = {};\n"
     "    long long tc = clock64();"),
    ("      wait_tile(&k_full[st], phase);\n      wg_fence();",
     "      wait_tile(&k_full[st], phase);\n      MARK(0)\n      wg_fence();"),
    ("        pv_product<D, BC, W, T>(acc, pa, vs + held * kTile);\n      }\n"
     "      if (pending)",
     "        pv_product<D, BC, W, T>(acc, pa, vs + held * kTile);\n      }\n"
     "      MARK(1)\n      if (pending)"),
    ("      wg_keep(s);\n", "      wg_keep(s);\n      MARK(2)\n"),
    ("      if (pending) {\n        wg_wait<0>();",
     "      MARK(3)\n      if (pending) {\n        wg_wait<0>();"),
    ("      l_a = l_a * al_a + rs_a;", "      MARK(4)\n      l_a = l_a * al_a + rs_a;"),
    ("      held_phase = phase;\n", "      held_phase = phase;\n      MARK(5)\n"),
    ("    l_a = quad_sum(l_a);",
     "    if (lane == 0 && warp == 0)\n      for (int i = 0; i < 6; ++i) "
     "atomicAdd(&lamp_prof[i], pt[i]);\n    l_a = quad_sum(l_a);"),
]
VARIANTS = {
    "as built": [],
    "2 consumers": [("constexpr int wg_consumers(int d) { return d <= 64 ? 3 : 2; }",
                     "constexpr int wg_consumers(int d) { return 2; }")],
    "masked 128-key tiles": [
        ("return d > 128 || (m && wg_consumers(d) == 3) ? 64 : 128;",
         "return d > 128 ? 64 : 128;")],
    # knock-outs (wrong results; where the time goes): the exponentials,
    # both products, both products and the exponentials
    "no exp2": [NO_EXP],
    "no products": [NO_S, NO_PV],
    "skeleton": [NO_S, NO_PV, NO_EXP],
    "timeline": TIMELINE,
    # the ragged producer issues no copy (its arrivals stay): what its
    # copies cost the ragged head dims
    "ragged, no copies": [
        ("    for (int r = w.r; r < ROWS; r += w.dr) {",
         "    for (int r = ROWS; r < ROWS; r += w.dr) {"),
        ("  for (int k0 = tid; k0 < words; k0 += 128 * NB) {",
         "  for (int k0 = words; k0 < words; k0 += 128 * NB) {")],
}
# (name, B, H, S, D, packed segment ids, causal)
SHAPES = (("S=4096", 2, 12, 4096, 64, False, True),
          ("S=4096 non-causal", 2, 12, 4096, 64, False, False),
          ("S=384", 8, 12, 384, 64, False, True),
          ("packed", 4, 12, 2048, 64, True, True),
          ("D=128", 2, 8, 2048, 128, False, True),
          ("D=160", 2, 8, 2048, 160, False, True),
          ("D=256", 2, 8, 2048, 256, False, True),
          # the ragged producer (d % 8 != 0) beside the TMA one in the same
          # instances: D=32 (12, 16), 128 (75, 100, 104), 192 (130, 136)
          ("D=12", 2, 8, 2048, 12, False, True),
          ("D=16", 2, 8, 2048, 16, False, True),
          ("D=75", 2, 8, 2048, 75, False, True),
          ("D=100", 2, 8, 2048, 100, False, True),
          ("D=104", 2, 8, 2048, 104, False, True),
          ("D=130", 2, 8, 2048, 130, False, True),
          ("D=136", 2, 8, 2048, 136, False, True))
ROUNDS, CALLS = 3, 10


def build():
    """Compile every variant at once; returns {name: loaded library}. Prints,
    for each source, how many kernels ptxas reports with serialized wgmma
    instructions (C7520) and which fwd_wg kernels have a stack frame or
    spills."""
    libs, logs = kernel_variants.build("flash_forward.cu", VARIANTS, OUT)
    for key, log in logs.items():
        print(f"{key}: {log.count('C7520')} kernels with serialized wgmma; "
              f"fwd_wg with a stack frame or spills: "
              f"{kernel_variants.spills(log, 'fwd_wg')}", flush=True)
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_k1_variants: needs a CUDA card")
    global SHAPES, VARIANTS
    args = sys.argv[1:]
    if "--ragged" in args:  # the ragged shapes and their neighbours only
        SHAPES = tuple(x for x in SHAPES if x[4] in (12, 16, 75, 100, 104,
                                                      130, 136))
        args.remove("--ragged")
    unknown = set(args) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    if args:
        VARIANTS = {n: e for n, e in VARIANTS.items()
                    if n in args or n == "as built"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.cuda.get_device_name(0)} | {smi.strip()}", flush=True)
    t0 = time.perf_counter()
    libs = build()
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    packed = chip_smoke.packed_batch()["segment_ids"]
    for what, b, h, s, d, with_ids, causal in SHAPES:
        scale = 1.0 / math.sqrt(d)
        q, k, v, _ = chip_smoke.flash_inputs(b, h, s, s, d, torch.bfloat16,
                                             seed=1)
        ids = torch.as_tensor(np.asarray(packed), device="cuda") \
            if with_ids else None
        vis = att._Visibility(q, ids, None)
        vis.alloc_map(q, s)
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        args = (*vis.args(), b * h, h, s, s, d, 0, 0, int(causal), 0, scale, 1,
                torch.cuda.current_stream().cuda_stream)

        def fwd(lib):
            rc = lib.lamp_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(),
                lse.data_ptr(), *args)
            assert rc == 0, rc

        with torch.no_grad():
            want, _ = att.flash_attention_reference(
                q.float(), k.float(), v.float(), causal=causal,
                segment_ids=ids)
        times = {name: [] for name in libs}
        errs, diffs, first = {}, {}, None
        for r in range(ROUNDS):
            for name, lib in libs.items():
                times[name].append(sum(chip_smoke.device_ms(
                    lambda: fwd(lib), CALLS, warmup=1).values()))
                if r == 0:
                    fwd(lib)
                    torch.cuda.synchronize()
                    errs[name] = chip_smoke.block_err(o, want)
                    first = o.clone() if first is None else first
                    diffs[name] = float((o.float() - first.float()).abs().max())
        pairs = float(att._visible(q, k, causal=causal, window=None,
                                   kv_lengths=None, segment_ids=ids,
                                   mask=None).sum()) * (b * h if ids is None
                                                        else h)
        print(f"{what}: B={b} H={h} S={s} D={d} bf16, median of "
              f"{ROUNDS} rounds of {CALLS} calls:", flush=True)
        for name, ts in times.items():
            ms = sorted(ts)[ROUNDS // 2]
            print(f"  {name:16} {ms * 1e3:8.1f} us  "
                  f"{4 * d * pairs / ms / 1e9:6.1f} TFLOP/s  block error "
                  f"{errs[name]:.2e}  max |o - as built| {diffs[name]:.2e}",
                  flush=True)
        for name, lib in libs.items():
            if not hasattr(lib, "lamp_prof_read"):
                continue
            before, after = ((ctypes.c_ulonglong * 8)() for _ in range(2))
            lib.lamp_prof_read(before)
            fwd(lib)
            torch.cuda.synchronize()
            lib.lamp_prof_read(after)
            cycles = [a - b for a, b in zip(after, before)][:len(SEGMENTS)]
            total = sum(cycles) or 1
            print(f"  {name}: consumer cycles by stretch: " + ", ".join(
                f"{seg} {100 * c / total:.1f}%" for seg, c in
                zip(SEGMENTS, cycles)), flush=True)
        del q, k, v, o, want


if __name__ == "__main__":
    main()
