"""Run some of chip_smoke.py's checks on one CUDA card, for a quick first
call after a kernel change: the build (with ptxas's register and spill
lines), then the named parts only.

    python3 scripts/chip_phases.py [paged] [ragged] [ragged_bwd] [fwd]
        [flash] [wide] [any] [small] [train32] [openllama] [gemma]
        [openllama_train] [quant] [layouts] [spec]

paged: phase 2 (the paged-attention kernels: the fixed kernel's edges,
K6_WIDE's shapes and the key split's edges included, and the serving
decode call's timing); ragged: phase 4's checks of the ragged forward
(check_ragged_forward: head dims 12-250 that are not multiples of 8, the
wgmma forward's cp.async producer), then its timing at B=2, H=8, S=2048,
D=12, 75, 100 and 130 beside SDPA; ragged_bwd: phase 4's checks of the
ragged backward (check_ragged_backward: head dims 12-250 that are not
multiples of 8, the wgmma backward's cp.async producer), then its timing
at B=2, H=8, S=2048, D=12, 75, 100, 130 and 250 beside SDPA's backward;
fwd: phase 4's checks of the wgmma forward's edges
(check_flash_forward_edges) and its timing at S=4096, S=384 and the
packed shapes; flash: phase 4's head dims
and float64 (check_flash_head_dims, with the f32 checks and timing that
the scalar kernels and the tensor-core kernels share); wide: phase 4's
edges of dq_wide and dkv_wide (check_wide_backward), untimed, then their
timing at B=2, H=8, S=2048, D=160, 192 and 256; any: phase 4's
edges of fwd_any (check_any_forward), then of dq_any and dkv_any
(check_any_backward, with the f32 checks and the f32 flagship's shape),
untimed; small: the GPT models of SMALL_HEAD_MODELS; train32:
phase 5's f32 flagship; openllama: phase 11; gemma: phase 12;
openllama_train: phase 13 (OpenLLaMA-3B trained in bf16); quant:
phase 6 (K7 at every decode shape and edge and the row-tiled kernel's
rows, int8_matmul, K8), then phase 7's int4 server (launch counts, greedy
tokens, the steady decode and K7's share of a profiled step); layouts:
check_layouts (the wrappers given transposed views and offset slices,
against their contiguous copies, bit for bit); spec: phase 14
(speculative decoding on the int4 servers: the bf16 chunk against single
steps, the greedy run's checks and figures, a profiled round, the sampled
run). No argument runs them all.
Every check raises as in chip_smoke.py.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from lamp_tpu_torch import models, optim, train  # noqa: E402
from lamp_tpu_torch import nn as torch_nn  # noqa: E402
from lamp_tpu_torch.ops import _build  # noqa: E402
from lamp_tpu_torch.ops import attention as att  # noqa: E402
from lamp_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_reference)

PARTS = ("paged", "ragged", "ragged_bwd", "fwd", "flash", "wide", "any",
         "small", "train32", "openllama", "gemma", "openllama_train", "quant",
         "layouts", "spec")


def main(parts) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: needs a CUDA card")
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise SystemExit(f"chip_phases: unknown parts {sorted(unknown)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    if "paged" in parts:
        cs.phase_kernel(paged_attention, paged_attention_reference)

    def check(*args, **kw):
        return cs.check_flash(att, *args, **kw)[0]

    if "ragged" in parts:
        cs.check_ragged_forward(att)
        for d in (12, 75, 100, 130):
            cs.time_flash_case(att, 2, 8, 2048, d, torch.bfloat16)
    if "ragged_bwd" in parts:
        cs.check_ragged_backward(att, lambda name, d, dtype, *a, **kw: check(
            name, *a[:4], d, dtype, *a[4:], **kw))
        for d in (12, 75, 100, 130, 250):
            cs.time_flash_case(att, 2, 8, 2048, d, torch.bfloat16)
    if "fwd" in parts:
        cs.check_flash_forward_edges(att, check)
        cs.time_flash(att, 2, cs.LM_HEADS, 4096, 64)
        cs.time_flash(att, 8, cs.LM_HEADS, 384, 64)
        cs.time_flash(att, cs.PACK_BATCH, cs.LM_HEADS, cs.PACK_CTX, 64,
                      segment_ids=cs.packed_batch()["segment_ids"])
    if "flash" in parts:
        check("f32", 2, 4, 512, 512, 64, torch.float32, True,
              lengths=[0, 400])
        check("f32 head 128", 1, 4, 300, 400, 128, torch.float32, False)
        print(cs.check_flash_head_dims(att, check)[1], flush=True)
        cs.time_flash(att, 2, cs.LM_HEADS, 4096, 64)
    if "wide" in parts:
        cs.check_wide_backward(att, lambda name, d, dtype, *a, **kw: check(
            name, *a[:4], d, dtype, *a[4:], **kw))
        for d in (160, 192, 256):
            cs.time_flash_case(att, 2, 8, 2048, d, torch.bfloat16)
    if "any" in parts:
        cs.check_any_forward(att)
        check("flagship f32", 8, cs.LM_HEADS, 384, 384, 64, torch.float32,
              True)
        check("f32", 2, 4, 512, 512, 64, torch.float32, True,
              lengths=[0, 400])
        check("f32 head 128", 1, 4, 300, 400, 128, torch.float32, False)
        ids = np.sort(np.random.RandomState(3).randint(0, 4, (2, 512)), 1)
        cs.check_any_backward(
            att, lambda name, d, dtype, *a, **kw: check(
                name, *a[:4], d, dtype, *a[4:], **kw), ids)
    if "small" in parts:
        print(cs.check_small_heads(torch_nn, optim, train), flush=True)
    if "train32" in parts:
        cs.run_train_config(torch_nn, optim, train, att, cs.TRAIN_CONFIGS[2])
    if "openllama" in parts:
        print(cs.phase_openllama(torch_nn, models, paged_attention, att),
              flush=True)
    if "gemma" in parts:
        print(cs.phase_gemma(torch_nn, optim, train, att), flush=True)
    if "openllama_train" in parts:
        print(cs.phase_openllama_train(torch_nn, optim, train, att),
              flush=True)
    if "quant" in parts:
        from lamp_tpu_torch.ops import quantization as Q

        cs.phase_quant_kernels(Q)
        cs.serve_int4(cs.make_serving_model(torch_nn), models, Q,
                      paged_attention)
    if "layouts" in parts or "spec" in parts:
        from lamp_tpu_torch.ops import quantization as Q

        if "layouts" in parts:
            cs.check_layouts(att, paged_attention, Q)
        if "spec" in parts:
            print(cs.phase_speculative(torch_nn, models, Q, paged_attention),
                  flush=True)
    print("chip_phases: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or PARTS))
