"""Experiment: K7's row-tiled kernel (int4_mm_tc, M > 64) against edited
copies of itself, on one CUDA card.

    python3 scripts/exp_int4_tc_variants.py [variant ...]

Each variant is ``csrc/int4_matmul.cu`` with a few text edits (one part of
the work knocked out, or one design choice changed; or the as-built kernel
under another launch plan, ``{"sms": N}``), built by
scripts/kernel_variants.py into lamp_tpu_torch/_build/variants/ beside
this tree's other sources and loaded beside the others; names given on the
command line build and time only those beside "as built". Every variant
runs the wrapper's launch plan (ops/quantization.py:_int4_plan) at the
serving configuration's matrices (chip_smoke.K7_SHAPES) at M = 128 (a
speculative round's target chunk: 32 sequences x k = 4) and qkv and the
logits at M = 3072 (an LM forward's rows), bf16 x, out bf16 (f32 for the
logits), timed by CUDA events over the replay of a CUDA graph of 20
back-to-back calls (chip_smoke.graph_ms) in turns: each round runs every
variant once. F.linear on the dequantized bf16 weight [N, K] is timed the
same way. Prints each variant's median at every shape, the sum over a
round's 61 calls at M = 128, each variant's largest relative error against
the plain version (a knock-out computes something else) and its ptxas
spill lines.
"""

import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import kernel_variants  # noqa: E402
from lamp_tpu_torch.ops import quantization as Q  # noqa: E402

OUT = ROOT / "lamp_tpu_torch" / "_build" / "variants"
ROUNDS = 3
CASES = [(name, k, n, per, 128) for name, k, n, per in chip_smoke.K7_SHAPES] \
    + [("qkv", 768, 1280, 0, 3072), ("logits", 768, 32000, 0, 3072)]

_TX = ("hopper::mbar_arrive_tx(&full[st], 2 * kX + (pl.tma_w ? KC * BN : "
       "0));")
VARIANTS = {
    "as built": [],
    # knock-outs: the part's time is what the call loses without it
    "no x copies": [
        (_TX, "hopper::mbar_arrive_tx(&full[st], pl.tma_w ? KC * BN : 0);"),
        ("        hopper::tma_load_2d(sb + c * BM * 128, &tm_x, &full[st], "
         "r0 + 64 * c, m0);\n", ""),
        ("        hopper::tma_load_2d(sb + kX + c * BM * 128, &tm_x, &full[st], "
         "k2 + r0 + 64 * c, m0);\n", "")],
    "no packed copies": [
        (_TX, "hopper::mbar_arrive_tx(&full[st], 2 * kX);"),
        ("if (pl.tma_w) hopper::tma_load_2d(sb + kW, &tm_w, &full[st], n0, "
         "r0);", "")],
    "no scale copies": [("for (int gi = 0; gi < ng; ++gi) {",
                         "for (int gi = 0; gi < 0; ++gi) {")],
    "no fragments": [
        ("    for (int i = 0; i < kSteps; ++i) {\n"
         "      const bool on = p.s + i < p.e;",
         "    for (int i = 0; i < kSteps; ++i) {\n"
         "      af[i][0] = af[i][1] = af[i][2] = af[i][3] = 0u;\n"
         "      continue;\n"
         "      const bool on = p.s + i < p.e;")],
    "no products": [("for (int i = 0; i < kSteps; ++i) wgmma_tc<WR>(",
                     "for (int i = 0; i < kSteps; ++i) if (false) wgmma_tc<WR>(")],
    "no scaling": [("    for (int i = 0; i < WR / 8; ++i) {\n"
                    "      acc[4 * i] += part[4 * i] * sv.x;",
                    "    for (int i = 0; i < 0; ++i) {\n"
                    "      acc[4 * i] += part[4 * i] * sv.x;")],
    # each pass's products issued twice (the sum is then wrong): whether a
    # pass's time follows its products' count
    "products twice": [
        ("    for (int i = 0; i < kSteps; ++i) wgmma_tc<WR>(part, af[i], desc[i], "
         "i > 0);\n",
         "    for (int i = 0; i < kSteps; ++i) wgmma_tc<WR>(part, af[i], desc[i], "
         "i > 0);\n    for (int i = 0; i < kSteps; ++i) wgmma_tc<WR>(part, "
         "af[i], desc[i], 1);\n")],
    # design choices
    "fragments after the wait": [
        ("    if (more) build(next, nxt);\n    hopper::wg_wait<0>();",
         "    hopper::wg_wait<0>();\n    if (more) build(next, nxt);")],
    "no setmaxnreg": [("    hopper::regs_dec<40>();", ""),
                      ("  hopper::regs_inc<232>();", "")],
    "2 stages": [("  pl.stages = (kMaxSmem - 2048 - recv) / stage;",
                  "  pl.stages = 2;")],
    # a timeline: thread 0 of each block (of the first 4096) writes the
    # global timer at its start (0), once the barriers are set up (1), once
    # the first stage has landed (2), when its products are done (3) and at
    # its end (4) into g_tc_marks, which lamp_tc_marks copies out
    "timeline": [
        ("namespace cg = cooperative_groups;",
         "namespace cg = cooperative_groups;\n"
         "__device__ unsigned long long g_tc_marks[4096][5];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n"
         "}\n"
         "#define TC_MARK(i) \\\n"
         "  if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < 4096) "
         "g_tc_marks[blockIdx.y * gridDim.x + blockIdx.x][i] = gtime()\n"),
        ("  cg::cluster_group cluster = cg::this_cluster();\n"
         "  const int cs = static_cast<int>(cluster.num_blocks());\n"
         "  const int rank = static_cast<int>(cluster.block_rank());\n"
         "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
         "  const int n = pl.n,",
         "  TC_MARK(0);\n"
         "  cg::cluster_group cluster = cg::this_cluster();\n"
         "  const int cs = static_cast<int>(cluster.num_blocks());\n"
         "  const int rank = static_cast<int>(cluster.block_rank());\n"
         "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
         "  const int n = pl.n,"),
        ("  if (cs > 1) cluster_arrive_relaxed();  // this rank's slots are "
         "ready\n",
         "  if (cs > 1) cluster_arrive_relaxed();  // this rank's slots are "
         "ready\n  TC_MARK(1);\n"),
        ("  hopper::mbar_wait(&full[0], 0);\n  build(af0, cur);",
         "  hopper::mbar_wait(&full[0], 0);\n  TC_MARK(2);\n"
         "  build(af0, cur);"),
        ("      finish(cur.tile);\n", "      TC_MARK(3);\n"
         "      finish(cur.tile);\n      TC_MARK(4);\n"),
        ("}  // extern \"C\"",
         "int lamp_tc_marks(void* host) {\n"
         "  return cudaMemcpyFromSymbol(host, g_tc_marks, sizeof(g_tc_marks));"
         "\n}\nint lamp_tc_marks_reset() {\n"
         "  static unsigned long long zero[4096][5] = {};\n"
         "  return cudaMemcpyToSymbol(g_tc_marks, zero, sizeof(zero));\n}\n\n"
         "}  // extern \"C\"")],
    # plans as if the card had other SM counts (the clusters' size at 256
    # rows or fewer), on the as-built kernel
    "sms 66": {"sms": 66},
    "sms 264": {"sms": 264},
    # the 65-128 row layers in 128-column tiles (two warpgroups of 64
    # columns by 128 rows) instead of 64 (two of 64 rows)
    "128-column tiles": {"sms": 132, "tile": 128},
    "even split": {"sms": 132, "even": True},
    # the first passes of a block in cycles (clock64, thread 0): before the
    # products' issue, after their wait, after the scaling, for passes 0-2
    "pass timeline": [
        ("namespace cg = cooperative_groups;",
         "namespace cg = cooperative_groups;\n"
         "__device__ long long g_tc_pass[4096][9];\n"
         "#define TC_PASS(i) \\\n"
         "  if (threadIdx.x == 0 && n_pass < 3 && blockIdx.y * gridDim.x + "
         "blockIdx.x < 4096) g_tc_pass[blockIdx.y * gridDim.x + blockIdx.x]"
         "[3 * n_pass + i] = clock64()\n"),
        ("  auto step = [&](uint32_t (&af)[kSteps][4], uint32_t (&next)"
         "[kSteps][4]) {\n    issue(af, cur);",
         "  int n_pass = 0;\n"
         "  auto step = [&](uint32_t (&af)[kSteps][4], uint32_t (&next)"
         "[kSteps][4]) {\n    TC_PASS(0);\n    issue(af, cur);"),
        ("    hopper::wg_keep(af);\n    scale(cur);\n",
         "    hopper::wg_keep(af);\n    TC_PASS(1);\n    scale(cur);\n"
         "    TC_PASS(2);\n    ++n_pass;\n"),
        ("}  // extern \"C\"",
         "int lamp_tc_pass(void* host) {\n"
         "  return cudaMemcpyFromSymbol(host, g_tc_pass, sizeof(g_tc_pass));\n"
         "}\n\n}  // extern \"C\"")],
    "not persistent": [
        ("cfg.gridDim = cluster == 1 ? dim3(pl.tiles < sms ? pl.tiles : sms)",
         "cfg.gridDim = cluster == 1 ? dim3(pl.tiles)")],
}


def replan(m, n, k2, g, sms, tile=None, even=False):
    """_tc_plan as if the card had ``sms`` SMs, with ``tile`` columns at
    65-128 rows where given, or with the clusters' even split."""
    tile0, cluster, rows = Q._tc_plan(min(m, 257), n, k2, g, sms)
    if m > 256 or (tile is None and not even):
        return tile0, cluster, rows
    tile = tile or tile0
    want = max(1, min(8, k2 // 16, -(-max(1, sms // 2) // -(-n // tile))))
    return tile, Q._even_cluster(k2 // 16, want), rows


def call(lib, x, p, s, out, g, plan):
    m, k = x.shape
    rc = lib.lamp_int4_matmul(
        x.data_ptr(), p.data_ptr(), s.data_ptr(), out.data_ptr(), m, k,
        p.shape[1], g, 1, 0 if out.dtype == torch.float32 else 1, *plan,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: {rc}")


def timeline(lib, inputs):
    """One call of each case with the timeline variant: per block, the
    microseconds of each stretch between marks (medians over the blocks,
    and the largest), the first and last block's start after the first's,
    and the call's span from the first start to the last end."""
    import numpy as np

    marks = np.zeros((4096, 5), np.uint64)
    for label, x, p, s, out, g, plans, *_ in inputs:
        plan = plans["timeline"]
        call(lib, x, p, s, out, g, plan)  # warm
        torch.cuda.synchronize()
        assert lib.lamp_tc_marks_reset() == 0
        call(lib, x, p, s, out, g, plan)
        torch.cuda.synchronize()
        assert lib.lamp_tc_marks(marks.ctypes.data) == 0
        used = marks[marks[:, 0] > 0].astype(np.float64)
        t0 = used[:, 0].min()
        d = np.diff(used, axis=1) / 1e3
        names = ("setup", "first stage landed", "products", "store/sum")
        print(f"  timeline {label} ({len(used)} blocks): " + ", ".join(
            f"{nm} {np.median(d[:, i]):.2f} (max {d[:, i].max():.2f})"
            for i, nm in enumerate(names))
            + f"; starts spread {(used[:, 0].max() - t0) / 1e3:.2f}, span "
            f"{(used[:, 4].max() - t0) / 1e3:.2f} us", flush=True)


def pass_timeline(lib, inputs, name):
    """One call of each case with the pass-timeline variant: the medians
    over the blocks of each of the first three passes' cycles from issue
    to the end of the wait, and of the scaling, and from one pass's end to
    the next one's issue."""
    import numpy as np

    marks = np.zeros((4096, 9), np.int64)
    for label, x, p, s, out, g, plans, *_ in inputs:
        call(lib, x, p, s, out, g, plans[name])
        torch.cuda.synchronize()
        assert lib.lamp_tc_pass(marks.ctypes.data) == 0
        used = marks[marks[:, 0] > 0]
        parts = []
        for i in range(3):
            w = np.median(used[:, 3 * i + 1] - used[:, 3 * i])
            sc = np.median(used[:, 3 * i + 2] - used[:, 3 * i + 1])
            gap = (np.median(used[:, 3 * i + 3] - used[:, 3 * i + 2])
                   if i < 2 else float("nan"))
            parts.append(f"pass {i}: issue to waited {w:.0f}, scaling "
                         f"{sc:.0f}, to the next issue {gap:.0f}")
        print(f"  cycles {label}: " + "; ".join(parts), flush=True)


def main(names) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("exp_int4_tc_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    variants = {n: e for n, e in VARIANTS.items()
                if not names or n in names or n == "as built"}
    plans = {n: e for n, e in variants.items() if isinstance(e, dict)}
    libs, logs = kernel_variants.build(
        "int4_matmul.cu", {n: e for n, e in variants.items()
                           if n not in plans}, OUT)
    for name in libs:
        for line in kernel_variants.spills(logs[name], "int4_mm_tc"):
            print(f"  {name}: {line}", flush=True)
    for name in plans:
        libs[name] = libs["as built"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = []
    for name, k, n, per, m in CASES:
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        g = Q.int4_group_size(k)
        p, s = Q.quantize_int4(w, group_size=g)
        od = torch.float32 if name == "logits" else torch.bfloat16
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        out = torch.empty(m, n, dtype=od, device=dev)
        plan = {v: replan(m, n, k // 2, g, **plans[v]) if v in plans
                else Q._int4_plan(m, n, k // 2, g, dev) for v in variants}
        want = Q.int4_matmul_reference(x, p, s).to(od)
        inputs.append((f"{name} M={m}", x, p, s, out, g, plan, want,
                       Q.dequantize_int4(p, s).t().contiguous(), per))
    errs = {v: 0.0 for v in variants}
    for v, lib in libs.items():
        for _, x, p, s, out, g, plan, want, _, _ in inputs:
            call(lib, x, p, s, out, g, plan[v])
            torch.cuda.synchronize()
            errs[v] = max(errs[v], chip_smoke.rel_err(out, want))
    times = {(v, c[0]): [] for v in list(variants) + ["F.linear"]
             for c in inputs}
    for _ in range(ROUNDS):
        for v, lib in libs.items():
            for label, x, p, s, out, g, plan, *_ in inputs:
                times[(v, label)].append(chip_smoke.graph_ms(
                    lambda i: call(lib, x, p, s, out, g, plan[v]), calls=20))
        for label, x, *rest in inputs:
            wd = rest[-2]
            times[("F.linear", label)].append(chip_smoke.graph_ms(
                lambda i: torch.nn.functional.linear(x, wd), calls=20))
    if "timeline" in libs:
        timeline(libs["timeline"], inputs)
    for v in libs:
        if v.startswith("pass timeline"):
            print(f"  {v}:", flush=True)
            pass_timeline(libs[v], inputs, v)
    for v in list(variants) + ["F.linear"]:
        med = {c[0]: statistics.median(times[(v, c[0])]) * 1e3
               for c in inputs}
        rnd = sum(med[c[0]] * c[-1] for c in inputs)
        print(f"{v:24} " + ", ".join(f"{k} {t:.2f}" for k, t in med.items())
              + f"; a round's 61 calls at M=128 {rnd:.1f} us"
              + (f"; error {errs[v]:.2e}" if v in errs else ""), flush=True)
    return 0


VARIANTS["pass timeline, products twice"] = (VARIANTS["pass timeline"]
                                             + VARIANTS["products twice"])
VARIANTS["pass timeline, no fragments"] = (VARIANTS["pass timeline"]
                                           + VARIANTS["no fragments"])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
