"""Experiment: the fused LayerNorm kernels (K5a forward, K5b backward)
against edited copies of themselves, other launch plans and another
checkout's source, on one CUDA card, at chip_smoke.py's K5_SHAPES in bf16.

    python3 scripts/exp_layernorm_variants.py [fwd|bwd] [rounds]
        [--parent FILE]

Variants of ``csrc/fused_layernorm.cu`` (scripts/kernel_variants.py builds
each beside this tree's other sources):

- "as built";
- "last block" (backward): no second kernel; each block adds one to a
  counter after a fence, and the block that finds every other one done adds
  the partials, its warps over rows in a fixed order, then in warp order
  (the counter, a __device__ word, is reset by that block);
- "no prefetch" (forward): the next row's loads no longer issued before
  this row's sums (bf16 rows of up to 768 columns, f32 rows);
- "w, b per row" (forward): w and b re-read (from L1) for every row
  instead of kept in registers across the warp's rows;
- "parent", where ``--parent`` names another checkout's
  ``csrc/fused_layernorm.cu``: its forward has the earlier C signature
  (f32 w and b, one row a warp, no grid argument), so its kernel is timed
  on f32 copies of w and b, and its call with the two casts to f32 that
  its wrapper made.

Forward (``fwd``): the as-built kernel at the wrapper's plan
(_plan: two blocks an SM, one for every 8 rows) and at 1, 2 and 4 rows
a warp (no cap on the grid), the variants at the wrapper's plan, the
parent, F.layer_norm; bf16 x, w and b with bias. Warm: one x, which with y
fits the 50 MB L2; cold: the calls cycle through copies of x that together
exceed it. Backward (``bwd``): the as-built source at rows a block of 8
(the wrapper's _plan), 16, 32 and 64, at most two blocks an SM, and
the last block, beside F.layer_norm's autograd backward (by the profiler:
autograd does not capture into a graph). Every case is timed by CUDA
events over the replay of a CUDA graph of 100 calls (chip_smoke.graph_ms),
in turns over ``rounds`` rounds (default 5), and once by the profiler's
device time of each kernel (chip_smoke.device_ms); each prints its median
and how its outputs compare with the as-built plan's (bit for bit, or
within K5_TOL where the order of the sums differs).
"""

import re
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
SOURCE = "fused_layernorm.cu"

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

_NO_PF = [("return fwd<T, V, 3, true>(", "return fwd<T, V, 3, false>("),
          ("return fwd<T, V, 6, true>(", "return fwd<T, V, 6, false>(")]
_WB_ROW = [("""        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = (xv[j][e] - mu) * rs * wv[j][e];""", """        float o[V];
        load_param<V>(w, w16, c, wv[j]);
        if (bias) load_param<V>(b, b16, c, bv[j]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = (xv[j][e] - mu) * rs * wv[j][e];""")]
VARIANTS = {"as built": [], "last block": _LAST, "no prefetch": _NO_PF,
            "w, b per row": _WB_ROW}
PLANS = (8, 16, 32, 64)  # rows a block (backward)
FWD_ROWS = (1, 2, 4)  # rows a warp (forward)
L2_BYTES = 50 << 20


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


def registers(log: str, kernel: str):
    """ptxas's 'Used N registers' of each instance of ``kernel`` in an nvcc
    log, in order."""
    lines, found = log.splitlines(), []
    for j, line in enumerate(lines):
        if kernel in line and "Compiling entry" in line:
            for nxt in lines[j + 1:j + 5]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    found.append(int(m.group(1)))
                    break
    return found


def fwd_call(lib, x, w, b, blocks, parent=False):
    n, d = x.shape
    y = torch.empty_like(x)
    mu = torch.empty(n, dtype=torch.float32, device=x.device)
    rs = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    if parent:  # x, f32 w, f32 b, y, mu, rstd, n, d, eps, dtype, stream
        rc = lib.lamp_layernorm_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                    y.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                                    n, d, 1e-5, 1, stream)
    else:
        rc = lib.lamp_layernorm_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rs.data_ptr(), n, d, 1e-5, 1,
            FL._KERNEL_DTYPES[w.dtype], FL._KERNEL_DTYPES[b.dtype], blocks,
            stream)
    if rc:
        raise RuntimeError(f"launch failed: {rc}")
    return y, mu, rs


def run_fwd(libs, rounds: int, sms: int) -> None:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, d in chip_smoke.K5_SHAPES:
        x = (torch.randn(n, d, generator=gen, device="cuda") * 3 + 1).bfloat16()
        w = (torch.randn(d, generator=gen, device="cuda") * 0.5 + 1).bfloat16()
        b = (torch.randn(d, generator=gen, device="cuda") * 0.1).bfloat16()
        w32, b32 = w.float(), b.float()
        xs = [x] + [x.clone() for _ in range(-(-L2_BYTES // x.nbytes))]
        plan = FL._plan(n, sms)
        lib = libs["as built"]
        cases = {f"as built, plan ({plan} blocks)":
                 lambda x: fwd_call(lib, x, w, b, plan)}
        for r in FWD_ROWS:
            blocks = -(-n // (8 * r))
            cases[f"as built, {r} row(s) a warp ({blocks})"] = (
                lambda x, blocks=blocks: fwd_call(lib, x, w, b, blocks))
        for name in ("no prefetch", "w, b per row"):
            cases[name] = (lambda x, lib=libs[name]:
                           fwd_call(lib, x, w, b, plan))
        if "parent" in libs:
            plib = libs["parent"]
            cases["parent kernel"] = (lambda x: fwd_call(
                plib, x, w32, b32, 0, parent=True))
            cases["parent call (two casts)"] = (lambda x: fwd_call(
                plib, x, w.float(), b.float(), 0, parent=True))
        cases["F.layer_norm"] = lambda x: F.layer_norm(x, (d,), w, b, 1e-5)
        times = {(name, cold): [] for name in cases for cold in (False, True)}
        for _ in range(rounds):
            for name, fn in cases.items():
                for cold in (False, True):
                    times[(name, cold)].append(chip_smoke.graph_ms(
                        lambda i, fn=fn, cold=cold:
                        fn(xs[i % len(xs)] if cold else x)))
        ref = fwd_call(lib, x, w, b, plan)
        want = FL.fused_layernorm_reference(x, w, b)
        bound = (4 * n * d + 4 * d + 8 * n) / chip_smoke.PEAK_BYTES * 1e3
        print(f"[{n}, {d}] bf16 forward (medians of {rounds} rounds by "
              f"graph, us a call, warm / cold; bound {bound * 1e3:.2f} us by "
              f"bytes):", flush=True)
        for name, fn in cases.items():
            prof = chip_smoke.device_ms(lambda: fn(x), 50)
            got = fn(x)
            if isinstance(got, tuple):
                same = all(torch.equal(g, r) for g, r in zip(got, ref))
                err = chip_smoke.rel_err(got[0], want[0])
                tail = f"; bits as the plan's: {same}; error y {err:.1e}"
            else:
                tail = f"; error y {chip_smoke.rel_err(got, want[0]):.1e}"
            warm, cold = (np.median(times[(name, c)]) for c in (False, True))
            print(f"  {name:34} {warm * 1e3:7.2f} / {cold * 1e3:7.2f}; "
                  "profiler " + ", ".join(
                      f"{k.split('(')[0][-26:]} {v * 1e3:.2f}"
                      for k, v in prof.items()) + tail, flush=True)


def run_bwd(libs, rounds: int, sms: int) -> None:
    import torch.nn.functional as F

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
        blocks = FL._plan(n, sms)
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
        print(f"[{n}, {d}] bf16 backward (medians of {rounds} rounds by "
              f"graph, us a call; F.layer_norm's autograd backward "
              f"{lib_ms * 1e3:.2f} us by the profiler):", flush=True)
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


def main(parts, rounds: int, parent) -> int:
    import ctypes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    variants = dict(VARIANTS)
    if parent:  # the whole source replaced by the other checkout's
        current = kernel_variants.SRC.joinpath(SOURCE).read_text()
        variants["parent"] = [(current, Path(parent).read_text())]
    libs, logs = kernel_variants.build(SOURCE, variants, OUT)
    for name in variants:
        print(f"  {name}: forward instances' registers "
              f"{registers(logs[name], 'layernorm_fwd_kernel')}", flush=True)
    if parent:
        fn = libs["parent"].lamp_layernorm_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if "fwd" in parts:
        run_fwd(libs, rounds, sms)
    if "bwd" in parts:
        run_bwd(libs, rounds, sms)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = args[i + 1]
        del args[i:i + 2]
    parts = [a for a in args if a in ("fwd", "bwd")] or ["fwd", "bwd"]
    nums = [a for a in args if a not in parts]
    sys.exit(main(parts, int(nums[0]) if nums else 5, parent))
