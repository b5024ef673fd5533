"""A/B timing of chip_smoke.py's phase 13 (OpenLLaMA-3B trained in bf16 at
context 2048, 2 rows a step) between two checkouts of the port, on one
CUDA card, in turns.

    python3 scripts/ab_openllama_train.py <dir> [rounds] [kernels]

<dir> holds another checkout's lamp_tpu_torch (for example this tree with
csrc/flash_attention.cu taken from a parent whose backward at head dims
not a multiple of 8 was dq_mma/dkv_mma). The two packages share a name,
so each run is a process of its own that imports one tree's package (and
this tree's chip_smoke.py); every round runs the other tree, this tree,
this tree and the other tree again. ``kernels`` names the other tree's
forward, dq and dkv kernels as the profiler shows them, separated by
";" (phase 13's profiled step must have run them; default: this tree's).
Prints each run's step time, tokens a second, peak memory and the
phase's checks, then the median step of each side.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(tree: str, kernels) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from lamp_tpu_torch import optim, train
    from lamp_tpu_torch import nn as torch_nn
    from lamp_tpu_torch.ops import _build
    from lamp_tpu_torch.ops import attention as att

    assert Path(att.__file__).resolve().is_relative_to(Path(tree).resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.library()
    out = cs.phase_openllama_train(torch_nn, optim, train, att,
                                   tuple(kernels) or cs.OPENLLAMA_KERNELS)
    print("AB " + json.dumps({k: out[k] for k in ("ms", "tok_s",
                                                    "peak_gib")}), flush=True)


def run(tree: str, kernels):
    proc = subprocess.run([sys.executable, __file__, "--worker", tree,
                           ";".join(kernels)], stdout=subprocess.PIPE,
                          text=True)
    print(proc.stdout, flush=True)
    if proc.returncode:
        raise SystemExit(f"the run of {tree} failed")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("AB "))
    return json.loads(line[3:])


def main() -> int:
    other = str(Path(sys.argv[1]).resolve())
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    kernels = sys.argv[3].split(";") if len(sys.argv) > 3 else []
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    seen = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            got = run(other if side == "other" else str(ROOT),
                      kernels if side == "other" else [])
            seen[side].append(got)
            print(side, json.dumps(got), flush=True)
    a = statistics.median(m["ms"] for m in seen["other"])
    b = statistics.median(m["ms"] for m in seen["this"])
    print(f"phase 13 step: other {a:.2f} ms, this {b:.2f} ms, this - other "
          f"{b - a:+.2f} ms ({100 * (b - a) / a:+.1f}%)", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2], [k for k in sys.argv[3].split(";") if k])
        sys.exit(0)
    sys.exit(main())
