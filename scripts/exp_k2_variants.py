"""Experiment: the flash-attention backward (K2) against edited copies of
itself, on one CUDA card.

Each variant is csrc/flash_attention.cu with a few text edits (one design
choice changed), built by scripts/kernel_variants.py into
lamp_tpu_torch/_build/variants/ and loaded beside the others. Each runs dq
then dkv on the same inputs (bf16, causal) at the training slice's B=2,
H=12, S=4096, D=64, the flagship's B=8, H=12, S=384, D=64, and at
head_dim 32 (B=4, H=4, S=2048 and B=8, H=4, S=512), timed by CUDA events
over back-to-back calls (the kernels run 20-300 us, longer than a call's
host time), in turns: each round runs every variant once. Prints each
variant's median dq and dkv time and whether its dq, dk and dv equal the
unedited build's bit for bit.

    python3 scripts/exp_k2_variants.py        # from the repository root
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

# name: [(text, replacement), ...] edits of flash_attention.cu
# (the tile sizes of head_dim 32: dq's K/V tile, dkv's q tile)
VARIANTS = {
    "as built": [],
    "D32 dq 64 keys": [("int dq_kv_tile(int d) { return d == 128 ? 64 : 128; }",
                        "int dq_kv_tile(int d) { return d == 64 ? 128 : 64; }")],
    "D32 dkv 32 rows": [("int dkv_q_tile(int d) { return d == 128 ? 32 : 64; }",
                         "int dkv_q_tile(int d) { return d == 64 ? 64 : 32; }")],
    "D32 dkv 128 rows": [
        ("int dkv_q_tile(int d) { return d == 128 ? 32 : 64; }",
         "int dkv_q_tile(int d) { return d == 128 ? 32 : d == 32 ? 128 : 64; }")],
}
# (B, H, S, D)
SHAPES = ((2, 12, 4096, 64), (8, 12, 384, 64), (4, 4, 2048, 32),
          (8, 4, 512, 32))
ROUNDS, CALLS = 5, 10


def build():
    """Compile every variant at once; returns {name: loaded library}."""
    return kernel_variants.build("flash_attention.cu", VARIANTS, OUT)[0]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_k2_variants: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.cuda.get_device_name(0)} | {smi.strip()}", flush=True)
    t0 = time.perf_counter()
    libs = build()
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
                    torch.cuda.synchronize()
                    got = [x.clone() for x in grads]
                    want = want or got
                    same[name] = all(torch.equal(x, y)
                                     for x, y in zip(got, want))
        print(f"B={b} H={h} S={s} D={d} causal bf16, median of {ROUNDS} "
              f"rounds of {CALLS} calls:", flush=True)
        for name, (tq, tkv) in times.items():
            mq, mkv = sorted(tq)[ROUNDS // 2], sorted(tkv)[ROUNDS // 2]
            print(f"  {name:16} dq {mq * 1e3:7.1f} us  dkv {mkv * 1e3:7.1f} "
                  f"us  sum {(mq + mkv) * 1e3:7.1f} us  equal to as-built "
                  f"{same[name]}", flush=True)


if __name__ == "__main__":
    main()
