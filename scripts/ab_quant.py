"""A/B timing of the int4 dequant-matmul (K7) between two checkouts of the
port, on one CUDA card, in turns.

    git archive <commit> lamp_tpu_torch | tar -x -C <dir>
    python3 scripts/ab_quant.py <dir> [rounds] [decode|tc]

The two checkouts' packages share a name, so each measurement runs in a
process of its own that imports one tree's lamp_tpu_torch: both trees'
kernels first build at once (each into its own _build/), then every round
measures the other tree, this tree, this tree and the other tree again.
Each measurement calls the tree's own ``int4_matmul`` (its wrapper, its
launch plan) at the serving configuration's five decode shapes (qkv
768 x 1280, wo 768 x 768, w1/w3 768 x 2048, w2 2048 x 768, logits
768 x 32000; bf16 x, out bf16, f32 for the logits) at M = 1 and 32
(``decode``, the default: the decode kernel's rows) or M = 128 and 3072
(``tc``: a speculative round's target chunk and an LM forward's rows, the
row-tiled kernel's), and F.linear on the dequantized bf16 weight [N, K]
beside each (the same call
in both trees: a yardstick measured on the same card). A time is the
device time a call by CUDA events over the replay of a CUDA graph of 100
back-to-back calls, one weight (warm, in L2); the profiler's sum of the
same call's kernels over 50 eager calls is printed beside it. Prints each
measurement, the median of each side, the ratio of this tree's to the
other's, and the sum over 61 calls (a decode step's at M = 32, a
speculative round's target chunk at M = 128).
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (name, K, N, calls a decode step)
SHAPES = (("qkv", 768, 1280, 12), ("wo", 768, 768, 12),
          ("w1/w3", 768, 2048, 24), ("w2", 2048, 768, 12),
          ("logits", 768, 32000, 1))
ROWS = {"decode": (1, 32), "tc": (128, 3072)}
CALLS = 100


def worker(tree: str, build_only: bool, group: str = "decode") -> None:
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lamp_tpu_torch.ops import _build
    from lamp_tpu_torch.ops import quantization as Q

    assert Path(Q.__file__).resolve().is_relative_to(Path(tree).resolve())
    _build.build()
    if build_only:
        return
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def graph_us(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(CALLS):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(5):
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / CALLS)
        return sorted(times)[2]

    def profiler_us(fn, calls=50):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()) \
            / calls

    times, prof = {}, {}
    for name, k, n, _ in SHAPES:
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        p, s = Q.quantize_int4(w, group_size=Q.int4_group_size(k))
        od = torch.float32 if name == "logits" else torch.bfloat16
        w_deq = Q.dequantize_int4(p, s).t().contiguous()
        for m in ROWS[group]:
            x = torch.randn(m, k, generator=gen, device=dev).bfloat16()

            def k7():
                Q.int4_matmul(x, p, s, out_dtype=od)

            def lin():
                torch.nn.functional.linear(x, w_deq)

            for label, fn in ((f"K7 {name} M={m}", k7),
                              (f"F.linear {name} M={m}", lin)):
                times[label] = graph_us(fn)
                prof[label] = profiler_us(fn)
        del w_deq
    print("PROF " + json.dumps(prof), flush=True)
    print("AB " + json.dumps(times), flush=True)


def run(tree: str, build_only: bool = False, group: str = "decode"):
    cmd = [sys.executable, __file__, "--worker", tree, group] + (
        ["--build"] if build_only else [])
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)


def main() -> int:
    other = str(Path(sys.argv[1]).resolve())
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    group = sys.argv[3] if len(sys.argv) > 3 else "decode"
    summed = ROWS[group][1 if group == "decode" else 0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    builds = [run(t, build_only=True) for t in (other, str(ROOT))]
    for proc in builds:
        proc.communicate()
        if proc.returncode:
            raise SystemExit("a build failed")
    seen = {"other": [], "this": []}
    profs = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            proc = run(other if side == "other" else str(ROOT), group=group)
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"the {side} tree's worker failed")
            for line in out.splitlines():
                if line.startswith("AB "):
                    seen[side].append(json.loads(line[3:]))
                    print(side, line[3:], flush=True)
                if line.startswith("PROF "):
                    profs[side].append(json.loads(line[5:]))
    med = {side: {key: statistics.median(r[key] for r in runs)
                  for key in runs[0]} for side, runs in seen.items()}
    pmed = {side: {key: statistics.median(r[key] for r in runs)
                   for key in runs[0]} for side, runs in profs.items()}
    for key in med["this"]:
        a, b = med["other"][key], med["this"][key]
        print(f"{key:26} other {a:7.2f} us (profiler "
              f"{pmed['other'][key]:7.2f}), this {b:7.2f} us (profiler "
              f"{pmed['this'][key]:7.2f}), this / other {b / a:.3f}",
              flush=True)
    for side in ("other", "this"):
        for what in ("K7", "F.linear"):
            step = sum(med[side][f"{what} {name} M={summed}"] * calls
                       for name, _, _, calls in SHAPES)
            pstep = sum(pmed[side][f"{what} {name} M={summed}"] * calls
                        for name, _, _, calls in SHAPES)
            print(f"{side:5} {what:8} 61 calls at M={summed}: "
                  f"{step:7.1f} us (profiler {pstep:7.1f})", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2], "--build" in sys.argv, sys.argv[3])
        sys.exit(0)
    sys.exit(main())
