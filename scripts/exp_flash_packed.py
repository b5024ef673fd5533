"""Experiment: where the flash-attention kernels spend their time on
packed documents, on one CUDA card.

Builds edited copies of csrc/flash_attention.cu (through
exp_k2_variants.build) and runs the forward (with its class map), dq and
dkv of each on the same packed inputs: chip_smoke.py's phase-10 batch
(B=4, H=12, S=2048, D=64, bf16, causal, segment ids of documents of
64-1024 tokens), timed by CUDA events over back-to-back calls, in turns.
Variants that change what is computed (a knock-out) say so; the others
must give the as-built bits.

    python3 scripts/exp_flash_packed.py        # from the repository root
"""

import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import exp_k2_variants  # noqa: E402

# name: [(text, replacement), ...] edits of flash_attention.cu
VARIANTS = {
    "as built": [],
    # knock-outs: partial tiles computed as full ones (wrong results)
    "no rules 2-3 in partial tiles": [
        ("const bool partial = M && span_class(crow, p.tiles_k, c0, BC) != kFull;",
         "const bool partial = false;"),
        # both backward kernels' partial-tile branches (text.replace
        # edits every occurrence)
        ("} else if constexpr (M) {  // ids or mask hide some pairs: rules 1-3",
         "} else if constexpr (false) {")],
    # knock-out: every tile in the causal band is visited (no class skip)
    "no skipped tiles": [
        ("    if constexpr (M)\n      while (c < hi && span_class(crow, p.tiles_k, c, BC) == kSkip) c += BC;",
         ""),
        ("        if (!loaded(i)) continue;", ""),
        ("      if (!loaded(i)) continue;", ""),
        ("        while (i < tiles && !loaded(first + i * BR)) ++i;", ""),
        ("      if (!loaded(r0)) continue;", "")],
}
ROUNDS, CALLS = 5, 10


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_flash_packed: needs a CUDA card")
    exp_k2_variants.VARIANTS = VARIANTS
    libs = exp_k2_variants.build()
    b, h, s, d = 4, 12, 2048, 64
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = chip_smoke.flash_inputs(b, h, s, s, d, torch.bfloat16,
                                          seed=1)
    ids = torch.as_tensor(chip_smoke.packed_batch()["segment_ids"],
                          device="cuda")
    print(f"{torch.cuda.get_device_name(0)}; B={b} H={h} S={s} D={d} bf16 "
          f"causal, packed ids; median of {ROUNDS} rounds of {CALLS} calls",
          flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    shape = (b * h, h, s, s, d, 0, 0, 1, 0, scale, 1, stream)
    runs = {}
    for name, lib in libs.items():
        tiles = torch.empty(b * 32 * 32, dtype=torch.uint8, device="cuda")
        vis = (ids.data_ptr(), ids.data_ptr(), None, tiles.data_ptr(),
               0, 0, 0, 0, b, 1)
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], device="cuda")
        di = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

        def fwd(lib=lib, vis=vis, o=o, lse=lse):
            assert lib.lamp_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(),
                lse.data_ptr(), *vis, *shape) == 0

        def dqk(lib=lib, vis=vis, o=o, lse=lse, di=di, dq=dq):
            assert lib.lamp_flash_attention_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), di.data_ptr(), None,
                dq.data_ptr(), *vis, *shape) == 0

        def dkv(lib=lib, vis=vis, lse=lse, di=di, dk=dk, dv=dv):
            assert lib.lamp_flash_attention_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), None, dk.data_ptr(),
                dv.data_ptr(), *vis, *shape) == 0

        fwd(), dqk(), dkv()
        torch.cuda.synchronize()
        runs[name] = ((fwd, dqk, dkv), (o.clone(), dq.clone(), dk.clone(),
                                        dv.clone()), ([], [], []))
    want = runs["as built"][1]
    for _ in range(ROUNDS):
        for name, (fns, _, times) in runs.items():
            for fn, out in zip(fns, times):
                out.append(chip_smoke.cuda_time_ms(fn, CALLS, warmup=1))
    for name, (_, got, times) in runs.items():
        med = [sorted(t)[ROUNDS // 2] * 1e3 for t in times]
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        print(f"  {name:30} fwd {med[0]:7.1f} us  dq {med[1]:7.1f} us  dkv "
              f"{med[2]:7.1f} us  equal to as-built {same}", flush=True)


if __name__ == "__main__":
    main()
