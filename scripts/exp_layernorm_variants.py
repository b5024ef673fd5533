"""Experiment: the fused LayerNorm backward (K5b) against edited copies of
itself and other launch plans, on one CUDA card, at chip_smoke.py's
K5_SHAPES in bf16.

    python3 scripts/exp_layernorm_variants.py [rounds]

Variants of ``csrc/fused_layernorm.cu`` (scripts/kernel_variants.py builds
each beside this tree's other sources):

- "as built": the blocks' partials [2, blocks, D] added by the second
  kernel (layernorm_bwd_reduce_kernel);
- "last block": no second kernel; each block adds one to a counter after a
  fence, and the block that finds every other one done adds the partials,
  its warps over rows in a fixed order, then in warp order (the counter, a
  __device__ word, is reset by that block).

Plans: the as-built source at rows a block of 8 (the wrapper's
_bwd_plan), 16, 32 and 64, at most two blocks an SM. Every case is timed by
CUDA events over the replay of a CUDA graph of 100 calls
(chip_smoke.graph_ms), in turns over ``rounds`` rounds (default 5), and
once by the profiler's device time of each kernel
(chip_smoke.device_ms), beside F.layer_norm's autograd backward (by the
profiler: autograd does not capture into a graph); each prints its median
and whether its dx, dw and db equal the as-built plan's bit for bit (the
plans and the last block differ from it in the order of the sums, so they
agree within K5_TOL instead, also printed).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import kernel_variants  # noqa: E402
from lamp_tpu_torch.ops import fused_layernorm as FL  # noqa: E402

OUT = ROOT / "lamp_tpu_torch" / "_build" / "variants_ln"

_LAST = [
    ("template <typename T, int V, int CH, bool PF>\n"
     "__global__ void __launch_bounds__(kThreads, 2)\nlayernorm_bwd_kernel(",
     "__device__ unsigned int g_ln_done = 0;\n"
     "template <typename T, int V, int CH, bool PF>\n"
     "__global__ void __launch_bounds__(kThreads, 2)\n"
     "layernorm_bwd_kernel(float* __restrict__ dw_out, float* __restrict__ db_out, "),
    ("      part[((long long)blocks + blockIdx.x) * d + c0 + i] = sb;\n"
     "    }\n    __syncthreads();\n  }\n}\n",
     "      part[((long long)blocks + blockIdx.x) * d + c0 + i] = sb;\n"
     "    }\n    __syncthreads();\n  }\n"
     "  __shared__ bool last;\n"
     "  __threadfence();\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) last = atomicAdd(&g_ln_done, 1u) == (unsigned)blocks - 1;\n"
     "  __syncthreads();\n  if (!last) return;\n  __threadfence();\n"
     "  float* sred = red;  // [kWarps][2][32]\n"
     "  for (int c0 = 0; c0 < d; c0 += 32) {\n"
     "    const int col = c0 + lane;\n    float aw = 0.f, ab = 0.f;\n"
     "    if (col < d) {\n#pragma unroll 8\n"
     "      for (int t = warp; t < blocks; t += kWarps) {\n"
     "        aw += part[(long long)t * d + col];\n"
     "        ab += part[((long long)blocks + t) * d + col];\n      }\n    }\n"
     "    sred[warp * 64 + lane] = aw;\n    sred[warp * 64 + 32 + lane] = ab;\n"
     "    __syncthreads();\n"
     "    if (warp == 0 && col < d) {\n      float sw = 0.f, sb = 0.f;\n"
     "      for (int q = 0; q < kWarps; ++q) sw += sred[q * 64 + lane], sb += sred[q * 64 + 32 + lane];\n"
     "      dw_out[col] = sw;\n      db_out[col] = sb;\n    }\n    __syncthreads();\n  }\n"
     "  if (threadIdx.x == 0) g_ln_done = 0;\n}\n"),
    ("  layernorm_bwd_kernel<T, V, CH, PF><<<blocks, kThreads, smem, stream>>>(\n",
     "  layernorm_bwd_kernel<T, V, CH, PF><<<blocks, kThreads, smem < 2048 ? 2048 : smem, "
     "stream>>>(dw, db, \n"),
    ("  layernorm_bwd_reduce_kernel<<<(d + kReduceCols - 1) / kReduceCols, 32 * kReduceWarps, 0,\n"
     "                                stream>>>(part, part + (long long)blocks * d, dw, db, blocks, d);\n",
     ""),
]

VARIANTS = {"as built": [], "last block": _LAST}
PLANS = (8, 16, 32, 64)  # rows a block


def call(lib, x, dy, w, mu, rs, blocks):
    n, d = x.shape
    dx = torch.empty_like(x)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty(d, dtype=torch.float32, device=x.device)
    work = torch.empty(2 * blocks * d + (2 * n if d > FL._HELD else 0),
                       dtype=torch.float32, device=x.device)
    rc = lib.lamp_layernorm_bwd(
        x.data_ptr(), dy.data_ptr(), w.data_ptr(), mu.data_ptr(),
        rs.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        work.data_ptr(), n, d, blocks, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: {rc}")
    return dx, dw, db


def main(rounds: int) -> int:
    import torch.nn.functional as F

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs, _ = kernel_variants.build("fused_layernorm.cu", VARIANTS, OUT)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, d in chip_smoke.K5_SHAPES:
        x = (torch.randn(n, d, generator=gen, device="cuda") * 3 + 1).bfloat16()
        w = (torch.randn(d, generator=gen, device="cuda") * 0.5 + 1).float()
        dy = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        _, mu, rs = FL.fused_layernorm_reference(x, w, None)
        cases = {}
        for rows in PLANS:
            blocks = max(1, min(2 * sms, -(-n // rows)))
            cases[f"as built, {rows} rows a block ({blocks})"] = (
                libs["as built"], blocks)
        blocks = FL._bwd_plan(n, sms)
        cases[f"last block ({blocks})"] = (libs["last block"], blocks)
        ref = call(libs["as built"], x, dy, w, mu, rs, blocks)
        want = FL.fused_layernorm_backward_reference(x, dy, w, mu, rs)
        times = {name: [] for name in cases}
        xl, wl = x.clone().requires_grad_(), w.bfloat16().requires_grad_()
        yl = F.layer_norm(xl, (d,), wl, None, 1e-5)
        for _ in range(rounds):
            for name, (lib, b) in cases.items():
                times[name].append(chip_smoke.graph_ms(
                    lambda i: call(lib, x, dy, w, mu, rs, b)))
        lib_ms = sum(chip_smoke.device_ms(lambda: torch.autograd.grad(
            yl, (xl, wl), dy, retain_graph=True), 50).values())
        print(f"[{n}, {d}] bf16 (medians of {rounds} rounds by graph, us a "
              f"call; F.layer_norm's autograd backward {lib_ms * 1e3:.2f} "
              f"us by the profiler):", flush=True)
        for name, ts in times.items():
            lib, blocks = cases[name]
            prof = chip_smoke.device_ms(
                lambda: call(lib, x, dy, w, mu, rs, blocks), 50)
            got = call(lib, x, dy, w, mu, rs, blocks)
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            errs = [chip_smoke.rel_err(g, r.to(g.dtype))
                    for g, r in zip(got, want)]
            print(f"  {name:36} {np.median(ts) * 1e3:8.2f}; profiler "
                  + ", ".join(f"{k.split('(')[0][-28:]} {v * 1e3:.2f}"
                              for k, v in prof.items())
                  + f"; bits as the wrapper's plan: {same}; error dx/dw/db "
                  + " ".join(f"{e:.1e}" for e in errs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 5))
