"""Experiment: the int4 dequant-matmul (K7) against edited copies of itself,
on one CUDA card, at the serving configuration's five decode shapes.

    python3 scripts/exp_int4_variants.py [--tree DIR] [variant ...]

Each variant is ``csrc/int4_matmul.cu`` with a few text edits (one part of
the work knocked out, or one design choice changed), built by
scripts/kernel_variants.py into lamp_tpu_torch/_build/variants/ beside
this tree's other sources and loaded beside the others. ``--tree DIR``
edits another checkout's copy of the source instead (``git archive
<commit> lamp_tpu_torch | tar -x -C DIR``): a source that still holds the
split-K second pass (``int4_mm_split_sum``, the row-tiled kernel before
the decode kernel) takes the ``ROW_TILED`` variants and its own C
signature, any other the ``DECODE`` variants of the cluster kernel
(``int4_mm_decode``).

Every variant runs x [32, K] bf16 (the decode batch) against each shape's
packed weight (K7_SHAPES of chip_smoke.py: qkv, wo, w1/w3, w2, logits;
out bf16, f32 for the logits), timed by CUDA events over the replay of a
CUDA graph of 100 back-to-back calls (chip_smoke.graph_ms), in turns:
each round runs every variant once. "warm" calls reuse one weight, which
then stays in the 50 MB L2 cache; "cold" calls cycle through copies of it
that together exceed the cache, as a decode step finds its weights.
F.linear on the dequantized bf16 weight [N, K] is timed the same way
beside it. Prints each variant's median at every shape, the sum over one
decode step's 61 calls, and each variant's largest relative error against
the plain version (a knock-out computes something else).
"""

import ctypes
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
from lamp_tpu_torch.ops import quantization as Q  # noqa: E402

OUT = ROOT / "lamp_tpu_torch" / "_build" / "variants"
ROUNDS = 5
COLD_BYTES = 64 << 20  # the copies a cold call cycles through, above L2

# edits of the row-tiled kernel (int4_mm_tc, split-K by a second pass);
# "splits" sets the call's K-splits instead of the wrapper's count
ROW_TILED = {
    "as built": [],
    "splits 1": {"splits": 1},
    # knock-outs: the part's time is what the call loses without it
    "no second pass": [("if (err != cudaSuccess || splits == 1) return err;",
                        "return err;")],
    "x staged once": [
        ("for (int i = tid; i < 2 * rows * kPieces; i += kThreads) {",
         "for (int i = tid; c == c0 && i < 2 * rows * kPieces; "
         "i += kThreads) {")],
    "kStages 4": [("constexpr int kStages = 3;",
                   "constexpr int kStages = 4;")],
    "kStages 6": [("constexpr int kStages = 3;",
                   "constexpr int kStages = 6;")],
    "no fragment reads": [
        ("const uint32_t b00 = s.w[kr][col], b01 = s.w[kr + 1][col];",
         "const uint32_t b00 = kr, b01 = col;"),
        ("const uint32_t b10 = s.w[kr + 8][col], b11 = s.w[kr + 9][col];",
         "const uint32_t b10 = col, b11 = kr;")],
    "no products": [("mma(d", "if (false) mma(d")],
}

# a timeline of the decode kernel: thread 0 of each block (of the first
# 1024) writes the global timer at its start and end and clock64 at each
# stretch's end into g_marks, which lamp_int4_marks copies out
_TIMELINE = [
    ("namespace cg = cooperative_groups;",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_marks[1024][10];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n"
     "#define MARK(i, v) \\\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 1024) "
     "g_marks[blockIdx.x][i] = (v)\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();",
     "  MARK(0, gtime());\n  MARK(1, clock64());\n"
     "  cg::cluster_group cluster = cg::this_cluster();"),
    ("  // put the round of rows",
     "  MARK(2, clock64());\n  // put the round of rows"),
    ("    issue(row0 + R, 1);\n    arrive(1);\n  }\n",
     "    issue(row0 + R, 1);\n    arrive(1);\n  }\n  MARK(3, clock64());\n"),
    ("    hopper::mbar_wait(&bar[j & 1], (j >> 1) & 1);",
     "    hopper::mbar_wait(&bar[j & 1], (j >> 1) & 1);\n"
     "    if (j == 0) MARK(4, clock64());"),
    ("  // the block's partial tile:",
     "  MARK(5, clock64());\n  // the block's partial tile:"),
    ("  __syncthreads();\n  const bool vec4 = n % 4 == 0;",
     "  __syncthreads();\n  MARK(6, clock64());\n"
     "  const bool vec4 = n % 4 == 0;"),
    ("  if (cs == 1) return;",
     "  if (cs == 1) {\n    MARK(7, clock64());\n    MARK(8, clock64());\n"
     "    MARK(9, gtime());\n    return;\n  }"),
    ("  hopper::mbar_wait(&bar[2], 0);\n", "  hopper::mbar_wait(&bar[2], 0);\n"
     "  MARK(7, clock64());\n"),
    ("    put(rank * share + i, v);\n  }\n}\n",
     "    put(rank * share + i, v);\n  }\n  MARK(8, clock64());\n"
     "  MARK(9, gtime());\n}\n"),
    ("}  // extern \"C\"",
     "int lamp_int4_marks(void* host) {\n"
     "  return cudaMemcpyFromSymbol(host, g_marks, sizeof(g_marks));\n"
     "}\n\n}  // extern \"C\""),
]
# the stretches of the timeline, between marks 1-8
STRETCHES = ("prologue", "copies issued, barriers set up", "copies landed",
             "products", "partials to smem", "partials sent, others' landed",
             "sum + store")

# edits of the cluster kernel (int4_mm_decode); "sms" plans the call as if
# the card had that many SMs (1: one block a 128-column tile, no cluster)
DECODE = {
    "as built": [],
    "sms 1": {"sms": 1},
    "sms 88": {"sms": 88},
    "sms 198": {"sms": 198},
    "sms 264": {"sms": 264},
    # knock-outs: the part's time is what the call loses without it
    "no weight loads": [("          cp_async16(st + r * kWS + p * 16,",
                         "          if (false) "
                         "cp_async16(st + r * kWS + p * 16,")],
    "no x loads": [("while (seg < 2 * m) {", "while (seg < 0) {")],
    "no cluster exchange": [
        ("if (cs > 1) cluster_arrive_relaxed();", ""),
        ("if (cs > 1) cluster_wait();", ""),
        ("        st_async(slot + i * 16, v, owner_bar);",
         "        put(e, v);"),
        ("  hopper::mbar_wait(&bar[2], 0);", "  return;")],
    # the launch alone: the kernel returns at once (with its cluster
    # dimension, then without)
    "empty kernel": [("  cg::cluster_group cluster = cg::this_cluster();",
                      "  if (pl.m > 0) return;\n"
                      "  cg::cluster_group cluster = cg::this_cluster();")],
    "empty, no cluster": [("  cg::cluster_group cluster = cg::this_cluster();",
                           "  if (pl.m > 0) return;\n"
                           "  cg::cluster_group cluster = "
                           "cg::this_cluster();"),
                          ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")],
    "no products": [("mma(d", "if (false) mma(d")],
    "timeline": _TIMELINE,
    # programmatic dependent launch: a call's blocks start as the previous
    # kernel's blocks end, prefetch their packed rows into L2, and wait for
    # that kernel's memory before any copy
    "pdl": [
        ("  cudaLaunchAttribute attr[1];", "  cudaLaunchAttribute attr[2];"),
        ("  cfg.numAttrs = 1;",
         "  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
         "  attr[1].val.programmaticStreamSerializationAllowed = 1;\n"
         "  cfg.numAttrs = 2;"),
        ("  issue(row0, 0);\n",
         "  for (int r = tid; r < min(R, row1 - row0); r += kDecThreads)\n"
         "    asm volatile(\"prefetch.global.L2 [%0];\\n\" ::\"l\"("
         "packed + (long long)(row0 + r) * n + n0));\n"
         "  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n"
         "  issue(row0, 0);\n")],
    # the launch, the setup and the first round's copies alone
    "loads only": [("  arrive(0);\n",
                    "  arrive(0);\n  if (m > 0) {\n"
                    "    hopper::mbar_wait(&bar[0], 0);\n"
                    "    if (cs > 1) cluster_wait();\n    return;\n  }\n")],
    # 16 warps a block: twice the K parts a column group
    "16 warps": [("constexpr int kDecWarps = 8;",
                  "constexpr int kDecWarps = 16;")],
}


def splits_row_tiled(m, n, n_kp):
    """The row-tiled kernel's K-splits as its wrapper (``_int4_splits``)
    chose them: fewer 64-column tiles than two a SM divide the groups over
    more blocks."""
    tiles = -(-n // 64) * -(-m // (32 if m <= 32 else 64))
    want = max(1, min(n_kp, 2 * torch.cuda.get_device_properties(0)
                      .multi_processor_count // tiles))
    per_split = -(-n_kp // want)
    return -(-n_kp // per_split)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_int4_variants: needs a CUDA card")
    args = sys.argv[1:]
    src = ROOT
    if args[:1] == ["--tree"]:
        src, args = Path(args[1]).resolve(), args[2:]
    text = (src / "lamp_tpu_torch" / "csrc" / "int4_matmul.cu").read_text()
    row_tiled = "int4_mm_split_sum" in text
    table = ROW_TILED if row_tiled else DECODE
    unknown = set(args) - set(table)
    if unknown:
        raise SystemExit(f"exp_int4_variants: unknown {sorted(unknown)}")
    chosen = {name: edits for name, edits in table.items()
              if not args or name in args or name == "as built"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.cuda.get_device_name(0)} | {smi.strip()}", flush=True)
    print(f"source {src / 'lamp_tpu_torch/csrc/int4_matmul.cu'} "
          f"({'row-tiled, split-K' if row_tiled else 'cluster'} kernel)",
          flush=True)
    t0 = time.perf_counter()
    sources = {name: e for name, e in chosen.items() if isinstance(e, list)}
    libs, logs = kernel_variants.build("int4_matmul.cu", sources, OUT, text)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        # the C signature of the source edited: (.., x and out dtypes,
        # splits, workspace, stream) before, (.., tile, cluster, round
        # rows, stream) since
        lib.lamp_int4_matmul.argtypes = (
            [ptr] * 4 + [i32] * 7 + [ptr, ptr] if row_tiled
            else [ptr] * 4 + [i32] * 9 + [ptr])
        for line in kernel_variants.spills(logs[name], "int4_mm"):
            print(f"  {name}: {line}", flush=True)
    for name, edits in chosen.items():
        if not isinstance(edits, list):
            libs[name] = libs["as built"]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    m = chip_smoke.DECODE_B
    rows = {name: {} for name in list(chosen) + ["F.linear"]}
    errs = {name: 0.0 for name in chosen}
    for shape, k, n, per_step in chip_smoke.K7_SHAPES:
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        g = Q.int4_group_size(k)
        p, s = Q.quantize_int4(w, group_size=g)
        od = torch.float32 if shape == "logits" else torch.bfloat16
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        want = Q.int4_matmul_reference(x, p, s)
        copies = max(1, min(chip_smoke.GRAPH_CALLS, -(-COLD_BYTES // (
            p.numel() + 4 * s.numel()))))
        weights = [(p, s)] + [(p.clone(), s.clone())
                              for _ in range(copies - 1)]
        out = torch.empty(m, n, dtype=od, device=dev)

        def caller(name):
            lib = libs[name]
            edits = chosen[name]
            if row_tiled:
                splits = (edits["splits"] if isinstance(edits, dict)
                          else splits_row_tiled(m, n, k // 2 // g))
                part = torch.empty(splits, m, n, dtype=torch.float32,
                                   device=dev)
                plan = (splits, part.data_ptr() if splits > 1 else None)
            elif isinstance(edits, dict):
                plan = Q._decode_plan(m, n, k // 2, g, edits["sms"])
            else:
                plan = Q._int4_plan(m, n, k // 2, g, dev)

            def call(i, cold):
                pi, si = weights[i % len(weights)] if cold else (p, s)
                rc = lib.lamp_int4_matmul(
                    x.data_ptr(), pi.data_ptr(), si.data_ptr(),
                    out.data_ptr(), m, k, n, g, 1,
                    1 if od == torch.bfloat16 else 0, *plan,
                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, (name, rc)

            call.keep = part if row_tiled else None  # the workspace lives
            return call

        calls = {name: caller(name) for name in chosen}
        for name, call in calls.items():
            call(0, False)
            torch.cuda.synchronize()
            err = chip_smoke.rel_err(out, want)
            if not err <= errs[name]:  # NaN too
                errs[name] = err
        w_deq = Q.dequantize_int4(p, s).t().contiguous()  # [N, K] bf16
        lin = [w_deq] + [w_deq.clone() for _ in range(max(0, min(
            chip_smoke.GRAPH_CALLS, -(-COLD_BYTES // (2 * k * n))) - 1))]
        times = {name: {"warm": [], "cold": []} for name in rows}
        for _ in range(ROUNDS):
            for name, call in calls.items():
                for mode in ("warm", "cold"):
                    times[name][mode].append(chip_smoke.graph_ms(
                        lambda i: call(i, mode == "cold")))
            for mode in ("warm", "cold"):
                times["F.linear"][mode].append(chip_smoke.graph_ms(
                    lambda i: torch.nn.functional.linear(
                        x, lin[i % len(lin)] if mode == "cold" else w_deq)))
        for name, t in times.items():
            rows[name][shape] = {mode: sorted(v)[ROUNDS // 2] * 1e3
                                 for mode, v in t.items()}
        for name, call in calls.items():
            if not hasattr(libs[name], "lamp_int4_marks"):
                continue
            call(0, True)
            torch.cuda.synchronize()
            marks = np.zeros((1024, 10), np.uint64)
            assert libs[name].lamp_int4_marks(marks.ctypes.data) == 0
            tile, cluster, _ = Q._int4_plan(m, n, k // 2, g, dev)
            b = marks[:min(1024, -(-n // tile) * cluster)].astype(np.int64)
            ns_per_cycle = np.median((b[:, 9] - b[:, 0]) / np.maximum(
                1, b[:, 8] - b[:, 1]))
            stretch = [np.median(b[:, i + 2] - b[:, i + 1]) * ns_per_cycle
                       for i in range(len(STRETCHES))]
            parts = "  ".join(f"{what} {ns:.0f}"
                              for what, ns in zip(STRETCHES, stretch))
            print(f"  {name} {shape}: {len(b)} blocks, starts spread over "
                  f"{b[:, 0].max() - b[:, 0].min()} ns, first start to last "
                  f"end {b[:, 9].max() - b[:, 0].min()} ns; median ns a "
                  f"block: {parts}", flush=True)
        del weights, lin, w_deq
        torch.cuda.empty_cache()
    per_step = {shape: calls for shape, _, _, calls in chip_smoke.K7_SHAPES}
    print(f"M={m}, us a call (median of {ROUNDS} rounds; each a graph of "
          f"{chip_smoke.GRAPH_CALLS} calls), warm / cold:", flush=True)
    for name, by_shape in rows.items():
        cells = "  ".join(f"{shape} {t['warm']:6.2f} / {t['cold']:6.2f}"
                          for shape, t in by_shape.items())
        step = {mode: sum(t[mode] * per_step[shape]
                          for shape, t in by_shape.items())
                for mode in ("warm", "cold")}
        err = "" if name == "F.linear" else f"  error {errs[name]:.2e}"
        print(f"  {name:18} {cells}  step {step['warm']:7.1f} / "
              f"{step['cold']:7.1f}{err}", flush=True)


if __name__ == "__main__":
    main()
