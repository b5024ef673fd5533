"""Experiment: the 16-bit backward above head dim 128 (dq_wide, dkv_wide)
against edited copies of itself, on one CUDA card.

Each variant is csrc/flash_backward_wide.cu with a few text edits (one
design choice changed, or one part of the work knocked out), built by
scripts/kernel_variants.py into lamp_tpu_torch/_build/variants/ and loaded
beside the others. Each runs dq then dkv on the same inputs (bf16, causal)
at B=2, H=8, S=2048 and head dims 160 (the D=192 instance), 192 and 256
(chip_smoke.py phase 12's attention), timed by CUDA events over
back-to-back calls (the kernels run 100-200 us, longer than a call's host
time), in turns: each round runs every variant once. Prints each
variant's median dq and dkv time and whether its dq, dk and dv equal the
unedited build's bit for bit (a knock-out computes something else).

    python3 scripts/exp_wide_variants.py [variant ...]   # from the root

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

# dkv with both consumers computing S^T (5 products, no exchange): the
# second issues its own S^T beside dP^T and takes P^T from it
_FIVE = [
    ("      float s[BR / 2];\n      wg_fence();",
     "      float s[BR / 2], pt[BR / 2];\n"
     "      if (wg == 1) {\n"
     "        wg_fence();\n"
     "        for (int kk = 0; kk < D / 16; ++kk)\n"
     "          wgmma_ss<BR, T>(pt, desc_k<64, W>(ks, kk),\n"
     "                          desc_k<BR, W>(qt, kk), kk > 0);\n"
     "        wg_commit();\n"
     "      }\n"
     "      wg_fence();"),
    ("        if (n > 0) named_sync(kPFree);\n#pragma unroll\n"
     "        for (int i2 = 0; i2 < BR / 2; ++i2) pex[i2 * 128 + lt] = s[i2];\n"
     "        named_arrive(kPFull);\n", ""),
    ("        named_sync(kPFull);\n        float pt[BR / 2];\n#pragma unroll\n"
     "        for (int i2 = 0; i2 < BR / 2; ++i2) pt[i2] = pex[i2 * 128 + lt];\n"
     "        if (n + 1 < total) named_arrive(kPFree);\n",
     "        wg_keep(pt);\n"
     "        for (int j = 0; j < BR / 8; ++j) {\n"
     "          const int4 kb4 =\n"
     "              *reinterpret_cast<const int4*>(&keys_s[st][j * 8 + 2 * t]);\n"
     "          const float2 l2 =\n"
     "              *reinterpret_cast<const float2*>(&lse_s[st][j * 8 + 2 * t]);\n"
     "          for (int e = 0; e < 4; ++e) {\n"
     "            const int key = e < 2 ? ka : kb;\n"
     "            const int klo = (e & 1) ? kb4.z : kb4.x;\n"
     "            const int khi = (e & 1) ? kb4.w : kb4.y;\n"
     "            const float x = pt[4 * j + e] * sl2 - ((e & 1) ? l2.y : l2.x);\n"
     "            pt[4 * j + e] = fast_exp2(key >= klo && key < khi ? x : -INFINITY);\n"
     "          }\n"
     "        }\n"),
]

# dq with two consumers of 64 rows at D=256 too, over 32-key K/V tiles
# (Q and dO of 128 rows take 128 KB; two 32 KB stages)
_DQ2 = [
    ("constexpr int dq_consumers(int d) { return d > 192 ? 1 : 2; }",
     "constexpr int dq_consumers(int d) { return 2; }"),
    ("BR = 64 * NC, BC = kTileRows;",
     "BR = 64 * NC, BC = D > 192 ? 32 : kTileRows;"),
    ("2 * 64 * dq_consumers(d) * d * 2, 2 * kTileRows * d * 2);",
     "2 * 64 * dq_consumers(d) * d * 2,\n"
     "                     2 * (d > 192 ? 32 : kTileRows) * d * 2);"),
    ("dq_stages(D) * 2 * kTileRows * D * 2;",
     "dq_stages(D) * 2 * (D > 192 ? 32 : kTileRows) * D * 2;"),
    ("{64, kTileRows, kTileRows, 64}, bh, p.d);",
     "{64, D > 192 ? 32 : kTileRows, D > 192 ? 32 : kTileRows, 64},\n"
     "      bh, p.d);"),
]

# name: [(text, replacement), ...] edits of flash_backward_wide.cu
VARIANTS = {
    "as built": [],
    "dkv 5 products": _FIVE,
    "dq 2 consumers at 256": _DQ2,
    # knock-outs: the part's time is what the sum loses without it
    "no exp2": [("fast_exp2(", "(")],
    "no score products": [("wgmma_ss<", "if (false) wgmma_ss<")],
    "no output products": [("wgmma_rs<D, T>(", "if (false) wgmma_rs<D, T>(")],
    "no tile loads": [("mbar_arrive_tx(&full[st], 2 * kTile);",
                       "mbar_arrive(&full[st]);"),
                      ("tma_load_3d(dst", "if (false) tma_load_3d(dst")],
    "no P^T exchange": [("named_sync(kPFull);", ""),
                        ("named_sync(kPFree);", ""),
                        ("named_arrive(kPFull);", ""),
                        ("named_arrive(kPFree);", "")],
}
# (B, H, S, D)
SHAPES = ((2, 8, 2048, 160), (2, 8, 2048, 192), (2, 8, 2048, 256))
ROUNDS, CALLS = 5, 10


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_wide_variants: needs a CUDA card")
    chosen = sys.argv[1:]
    unknown = set(chosen) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"exp_wide_variants: unknown {sorted(unknown)}")
    variants = {name: edits for name, edits in VARIANTS.items()
                if not chosen or name in chosen or name == "as built"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.cuda.get_device_name(0)} | {smi.strip()}", flush=True)
    t0 = time.perf_counter()
    libs, logs = kernel_variants.build("flash_backward_wide.cu", variants,
                                       OUT)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in libs:
        for kernel in ("dq_wide", "dkv_wide"):
            for line in kernel_variants.spills(logs[name], kernel):
                print(f"  {name}: {kernel}{line}", flush=True)
    for b, h, s, d in SHAPES:
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


if __name__ == "__main__":
    main()
