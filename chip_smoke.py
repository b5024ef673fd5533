#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one GPU and check it.

    python3 chip_smoke.py              # from the repository root

Phases (every failure raises and exits non-zero; nothing is skipped):

1. Device and build: needs ``torch.cuda.is_available()``; prints the card's
   name and power limit; builds ``lamp_tpu_torch/csrc/*.cu`` with nvcc.
2. The paged-attention kernel against its plain PyTorch version at the
   serving slice's shapes (B=32, H=12, H_kv=4, D=64, 128-token pages, the
   12-layer stacked bf16 pool of 192 pages per layer), over edge lengths,
   append on/off and static / per-request windows; both are timed.
3. The slice at full width: a 12-block, 768-wide llama-style ModernLM
   (GQA 12/4 heads, SwiGLU 2048, vocab 32000, context 512, bf16, random
   weights from a seed) behind ModernBatchServer(total_pages=192) and
   ServingEngine(decode_steps=8, max_batch=32) serves 40 requests; the
   results, the page pool, the kernel's launch count and the greedy tokens
   (against a dense forward) are checked; then the steady decode rate of
   step_many(8) at B=32 is timed with CUDA events, and one more call is
   profiled (device busy share, top kernels).

The last lines are one JSON line on the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# phase 2: |kernel - plain| <= ATOL + RTOL * |plain|, the plain version in
# f32 on the same bf16 inputs; the kernel computes in f32 and rounds its
# output once to bf16 (relative 2^-9)
ATOL, RTOL = 1e-2, 4e-3
# phase 3: a greedy token must equal the dense forward's argmax wherever
# the dense top-1/top-2 logit margin exceeds this (bf16 model: the paged
# decode and the dense forward round activations at different places)
MARGIN = 0.05

# the slice's configuration (the JAX package's serving workload)
VOCAB, CTX, BLOCKS, DIM, HEADS, KV_HEADS = 32000, 512, 12, 768, 12, 4
PAGE, TOTAL_PAGES = 128, 192


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(paged_attention, paged_attention_reference):
    """The kernel against its plain version at the slice's shapes."""
    dev = torch.device("cuda")
    b, h, hkv, d, pps = 32, HEADS, KV_HEADS, DIM // HEADS, CTX // PAGE
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    pool = randn(BLOCKS * TOTAL_PAGES, 2, PAGE, hkv * d)
    pool32 = pool.float()
    q, new_k, new_v = randn(b, h, d), randn(b, hkv * d), randn(b, hkv * d)
    rng = np.random.RandomState(0)
    table = torch.as_tensor(np.stack([
        rng.choice(np.arange(1, TOTAL_PAGES), pps, replace=False)
        for _ in range(b)]).astype(np.int32), device=dev)
    edge = [0, 1, 127, 128, 129, 255, 511]
    lengths = torch.as_tensor(
        np.asarray(edge + list(rng.randint(0, pps * PAGE, b - len(edge))),
                   np.int32), device=dev)
    wins = torch.as_tensor(np.asarray(
        [0, 1, 2, 50, 100, 300, 0, 7] * (b // 8), np.int32), device=dev)
    offset = (BLOCKS - 1) * TOTAL_PAGES

    max_err = 0.0
    for append in (False, True):
        app = (new_k, new_v) if append else None
        app32 = (new_k.float(), new_v.float()) if append else None
        for window, windows in ((None, None), (100, None), (None, wins),
                                (100, wins)):
            kw = dict(num_kv_heads=hkv, window=window, windows=windows,
                      page_offset=offset)
            out = paged_attention(q, pool, None, table, lengths,
                                  append_kv=app, **kw)
            ref = paged_attention_reference(q.float(), pool32, None, table,
                                            lengths, append_kv=app32, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs()
            bad = err > ATOL + RTOL * ref.abs()
            if bad.any():
                raise AssertionError(
                    f"paged_attention append={append} window={window} "
                    f"windows={windows is not None}: {int(bad.sum())} "
                    f"elements off, max err {float(err.max()):.3e}")
            if not append and (out[lengths == 0] != 0).any():
                raise AssertionError("rows with no valid key are not 0")
            max_err = max(max_err, float(err.max()))
            print(f"  append={append!s:5} window={window!s:4} "
                  f"windows={windows is not None!s:5} max_abs_err "
                  f"{float(err.max()):.3e}")

    # the split K/V layout and the other instantiations (f32, head_dim
    # 128, 8 query heads per kv head), at small shapes
    k_split, v_split = pool[:, 0].contiguous(), pool[:, 1].contiguous()
    cases = [(q, k_split, v_split, hkv)]
    for dt, hd, nh, nkv in ((torch.float32, 64, 8, 2),
                            (torch.bfloat16, 128, 8, 1),
                            (torch.float32, 128, 4, 4)):
        small = torch.randn((64, 2, PAGE, nkv * hd), generator=gen,
                            device=dev).to(dt)
        cases.append((torch.randn((b, nh, hd), generator=gen,
                                  device=dev).to(dt), small, None, nkv))
    for qq, kp, vp, nkv in cases:
        tab = table % kp.shape[0]
        out = paged_attention(qq, kp, vp, tab, lengths, num_kv_heads=nkv,
                              windows=wins)
        ref = paged_attention_reference(
            qq.float(), kp.float(), None if vp is None else vp.float(), tab,
            lengths, num_kv_heads=nkv, windows=wins)
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        tol = ATOL if qq.dtype == torch.bfloat16 else 1e-4
        print(f"  {qq.dtype} head_dim={qq.shape[2]} heads={qq.shape[1]}/"
              f"{nkv} split={vp is not None} max_abs_err {err:.3e}")
        if err > tol * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"paged_attention instantiation: err {err}")

    # time both on the path's own call: append_kv, no window, last layer
    def kernel():
        paged_attention(q, pool, None, table, lengths, num_kv_heads=hkv,
                        append_kv=(new_k, new_v), page_offset=offset)

    def plain():
        paged_attention_reference(q, pool, None, table, lengths,
                                  num_kv_heads=hkv, append_kv=(new_k, new_v),
                                  page_offset=offset)

    ms = cuda_time_ms(kernel, 200)
    plain_ms = cuda_time_ms(plain, 50)
    live = int(lengths.sum()) + b
    gbs = live * 2 * hkv * d * 2 / (ms * 1e-3) / 1e9
    print(f"  kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us "
          f"({live} live tokens, {gbs:.0f} GB/s of K/V rows)")
    return max_err, ms, plain_ms


def profile_step(server):
    """torch.profiler over one steady step_many(8): the device's busy share
    of the wall time (a lower bound: tracing slows the host) and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.step_many(8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in device)
    print(f"  profile of one step_many(8): {wall_us:.0f} us wall, device "
          f"busy {busy:.0f} us ({100 * busy / wall_us:.1f}%), "
          f"{sum(e.count for e in device)} device ops; top kernels:")
    for e in device[:8]:
        print(f"    {100 * e.self_device_time_total / busy:5.1f}%  "
              f"{e.self_device_time_total:8.0f} us  x{e.count:<5} "
              f"{e.key[:90]}")


def phase_serving(torch_nn, models, paged_attention):
    """The slice through ServingEngine at full width, then its decode rate."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = torch_nn.ModernLM.init(
        vocab_size=VOCAB, context_length=CTX, num_blocks=BLOCKS,
        embed_dim=DIM, num_heads=HEADS, num_kv_heads=KV_HEADS,
        generator=gen, dtype=torch.bfloat16, device=dev)
    server = models.ModernBatchServer(model, page_size=PAGE,
                                      total_pages=TOTAL_PAGES)
    engine = models.ServingEngine(server, decode_steps=8, max_batch=32)
    rng = np.random.RandomState(0)
    greedy = {3, 13, 23, 33}
    prompts, max_tokens = {}, {}
    for i in range(40):
        rid = f"r{i}"
        prompts[rid] = rng.randint(0, VOCAB, 24 + i % 8).tolist()
        max_tokens[rid] = 32 + (64 * i) // 39
        params = (models.SamplingParams(max_tokens=max_tokens[rid])
                  if i in greedy else models.SamplingParams(
                      temperature=0.8, top_p=0.95,
                      max_tokens=max_tokens[rid]))
        engine.submit(prompts[rid], params, request_id=rid)
    free0 = len(server.free_pages)
    # the main path's run: the launch count covers exactly this
    paged_attention.launches = 0
    steps0 = server.steps_decoded
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    steps = server.steps_decoded - steps0
    emitted = sum(len(v) for v in results.values())
    print(f"  engine: 40 requests, {emitted} tokens, {steps} decode steps, "
          f"{launches} kernel launches, {wall:.2f} s wall")
    if launches == 0 or launches != BLOCKS * steps:
        raise AssertionError(f"{launches} launches for {steps} decode steps")
    if sorted(results) != sorted(prompts):
        raise AssertionError("missing results")
    for rid, toks in results.items():
        if len(toks) != max_tokens[rid] or not all(
                0 <= t < VOCAB for t in toks):
            raise AssertionError(f"{rid}: {len(toks)} tokens, want "
                                 f"{max_tokens[rid]} in [0, {VOCAB})")
    if len(server.free_pages) != free0 or server.seq_pages:
        raise AssertionError("the page pool did not return to its start")

    checked = total = 0
    min_margin_ok = float("inf")
    with torch.no_grad():
        for i in sorted(greedy):
            rid = f"r{i}"
            seq = prompts[rid] + results[rid]
            logits = model(torch.as_tensor([seq[:-1]], device=dev))[0]
            top = logits[len(prompts[rid]) - 1:].topk(2, dim=-1)
            margin = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
            argmax = top.indices[:, 0].cpu().numpy()
            for j, tok in enumerate(results[rid]):
                total += 1
                if margin[j] > MARGIN:
                    checked += 1
                    if tok != argmax[j]:
                        raise AssertionError(
                            f"{rid} token {j}: {tok} != dense argmax "
                            f"{argmax[j]} (margin {margin[j]:.3f})")
                    min_margin_ok = min(min_margin_ok, float(margin[j]))
    print(f"  greedy: {checked} of {total} tokens past the {MARGIN} margin "
          f"equal the dense argmax")
    if checked < total // 4:
        raise AssertionError("too few greedy tokens could be checked")

    # steady decode rate: 32 requests, step_many(8), CUDA events
    rng = np.random.RandomState(0)
    for i in range(32):
        server.add(f"s{i}", rng.randint(0, VOCAB, 24 + i % 8).tolist(),
                   models.SamplingParams(temperature=0.8))
    server.step_many(8)
    server.step_many(8)
    rounds = 5
    ms = cuda_time_ms(lambda: server.step_many(8), rounds, warmup=0)
    tok_s = 32 * 8 / (ms * 1e-3)
    print(f"  decode: step_many(8) at B=32 {ms:.2f} ms, "
          f"{ms / 8:.3f} ms/step, {tok_s:.1f} tok/s")
    profile_step(server)
    for i in range(32):
        server.remove(f"s{i}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    # f32 matmuls (the plain versions, the logits) stay f32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lamp_tpu_torch import models
    from lamp_tpu_torch import nn as torch_nn
    from lamp_tpu_torch.ops import _build
    from lamp_tpu_torch.ops.paged_attention import (paged_attention,
                                                    paged_attention_reference)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"phase 1: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    print("phase 2: paged_attention kernel vs plain", flush=True)
    max_err, ms, plain_ms = phase_kernel(paged_attention,
                                         paged_attention_reference)
    print("phase 3: serving slice at full width", flush=True)
    launches = phase_serving(torch_nn, models, paged_attention)

    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "lamp_tpu_torch/csrc/paged_attention.cu",
        "replaces": "lamp_tpu/ops/paged_attention.py:151",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
