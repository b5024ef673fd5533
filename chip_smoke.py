#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
check them.

    python3 chip_smoke.py              # from the repository root

Phases (every failure raises and exits non-zero; nothing is skipped):

1. Device and build: needs ``torch.cuda.is_available()``; prints the card's
   name and power limit; builds ``lamp_tpu_torch/csrc/*.cu`` with nvcc (one
   process per source, all at once).
2. The paged-attention kernel against its plain PyTorch version at the
   serving slice's shapes (B=32, H=12, H_kv=4, D=64, 128-token pages, the
   12-layer stacked bf16 pool of 192 pages per layer), over edge lengths,
   append on/off and static / per-request windows, on the bf16 pool and on
   the same values in an fp8 (e4m3fn) pool, e5m2 once; both pools' kernel
   and plain version are timed by profiler device time.
3. The serving slice at full width: a 12-block, 768-wide llama-style
   ModernLM (GQA 12/4 heads, SwiGLU 2048, vocab 32000, context 512, bf16,
   random weights from a seed) behind ModernBatchServer(total_pages=192)
   and ServingEngine(decode_steps=8, max_batch=32) serves 40 requests; the
   results, the page pool, the kernel's launch count and the greedy tokens
   (against a dense forward) are checked; then the steady decode rate of
   step_many(8) at B=32 is timed with CUDA events, and one more call is
   profiled (device busy share, top kernels).
4. The flash-attention kernels (forward, backward dkv and dq) against their
   plain versions (in f32) at the training slice's shapes (B=2, H=12,
   S=4096, D=64, bf16, causal) and the flagship's (B=8, S=384), and over
   kv lengths [B] (with a 0) and [B, Sq], a window, non-causal Sq != Skv,
   head_dim 128 and f32, by relative error per 64-row block, and a planted
   fault (one skipped kv tile) that each check must see; each kernel, its
   plain version and
   ``scaled_dot_product_attention`` (the library yardstick, timed only) are
   timed by their device time under torch.profiler, and the forward and
   forward + backward calls of all three by CUDA events.
5. The training slice at full width: a 12-block, 768-wide GPT
   LanguageModelModule (12 heads, MLP 3072, byte vocab 256, bf16 with f32
   AdamW masters, random weights from a seed) trains under the flagship
   configuration (ctx 384, batch 8 x 5 accumulation, the example's AdamW)
   and the long-context one (ctx 4096, batch 2): 2 warm-up steps, 5 timed
   steps (CUDA events; the kernels' launch counts are checked against 12
   layers x micro-batches x steps), 10 steps on one batch of SURVEY.md's
   bytes (the loss must fall), and one profiled step (device busy share,
   top kernels, no library attention kernel).
6. The int4 dequant-matmul kernel (K7) against its plain version at every
   decode matmul of the serving configuration (QKV 768x1280, out 768x768,
   SwiGLU 768x2048 and 2048x768, logits 768x32000) with M in {1, 7, 32, 64,
   3072}, bf16 and f32 x, bf16 and f32 out, by relative Frobenius error,
   with a planted fault (one K-group's scale row dropped) that each check
   must see; timed at B=32 by profiler device time beside its bound and
   F.linear on the dequantized bf16 weight. int8_matmul (torch._int_mm,
   zero rows padded below 17 rows) at the same shapes with M in {1, 7, 16,
   17, 32}: bit for bit against the same arithmetic with an exact f64
   product, and near x @ dequant(w). The stochastic int8 quantizer (K8, on
   no path of the port, driven here) at [3072, 768] and [3072, 3072] bf16,
   bit for bit against its plain version, the unbiasedness check of
   tests/test_quantization.py, and timed.
7. Quantized serving at full width, on phase 3's model and requests:
   ModernBatchServer(quantize_bits=4) through ServingEngine (lengths, the
   page pool, 61 K7 and 12 K6 launches per decode step, greedy tokens
   against a dense f32 forward of the dequantized model), then with
   kv_dtype=float8_e4m3fn (the same checks, greedy agreement with the bf16
   pool), then quantize_bits=8 (the same checks, no K7 launch, greedy
   tokens against a dense f32 forward through int8_matmul), then the steady
   step_many(8) at B=32 of int8, int4 and int4 + fp8 KV beside phase 3's
   bf16 (tok/s, device time and device ops per step).
8. The fused AdamW kernel (K4) against its plain version at all 220
   parameter shapes of the flagship GPT (85,565,952 parameters, one launch)
   and odd sizes, in bf16 with stochastic rounding, bf16 rounded to nearest
   and f32: new p, m and v bit for bit; the unbiasedness check (2^20 bf16
   parameters at 1.0, lr 1e-4: the mean within 5 sigma of 1 - 1e-4); timed
   over the flagship's tensors beside its bound, its plain version and the
   port's optim.AdamW step on the same tensors (no PyTorch call rounds
   stochastically). The fused LayerNorm kernels (K5, on no path of the
   port, driven here) at [3072, 768] and [8192, 768] (bf16 and f32, with
   and without bias), [15, 256], [8, 100] and [40, 8192]: y, dx, dw and db
   by relative Frobenius error, with a planted fault (one row tile's
   partial dropped from dw) that each check must see; timed beside
   F.layer_norm's forward and autograd backward.
9. The K4 path at full width (bench.py's fused-optimizer number): phase 5's
   flagship under AdamWStochastic(3e-4, weight_decay=0.01), bf16 without
   masters: the timed steps (K4 one launch a step, K1/K2 12 x 5 a step),
   finite losses, the loss falling on SURVEY.md's bytes, a profiled step,
   and the step, optimizer device time and peak memory beside phase 5's
   AdamW flagship.

The last lines are one JSON line on the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

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

# phase 4: per output (o, dq, dk, dv), the largest relative Frobenius error
# ||kernel - plain|| / ||plain|| over the 64-row blocks of each (b, h) slab,
# the plain version in f32 on the same inputs; a block where the plain
# version is 0 must be exactly 0. bf16: the kernels round o, p and ds to
# bf16 (as the TPU kernels do), a relative 2^-9 per term. f32: the kernels
# and the plain version differ in summation order only. Each limit lies
# between the sound kernels' readings and those of a planted fault (rows
# past Sq/4 skip one 64-key tile), which every check also reads and must
# see. On an H100: bf16 kernels read at most 4.7e-3 and the fault at least
# 0.32; f32 kernels 5.3e-7 and the fault 0.47.
FLASH_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
FLASH_BLOCK = 64

# the serving slice's configuration (the JAX package's serving workload)
VOCAB, CTX, BLOCKS, DIM, HEADS, KV_HEADS = 32000, 512, 12, 768, 12, 4
PAGE, TOTAL_PAGES = 128, 192

# the training slice: the JAX package's GPT LM (bench.py:109-130 flagship,
# bench.py:223-240 long context), full width
LM_VOCAB, LM_BLOCKS, LM_DIM, LM_HEADS = 256, 12, 768, 12
TRAIN_CONFIGS = (("flagship", 384, 8, 5), ("longctx", 4096, 2, 1))

# one H100 SXM's published dense bf16 rate and memory bandwidth
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12

# phase 6: K7 against its plain version (in f32, on the same inputs, then
# rounded to the kernel's output dtype) by relative Frobenius error
# ||kernel - plain|| / ||plain||. f32 out: both sum exact products of x
# and the integer codes in f32 and differ in summation order only; bf16
# out: each rounds its f32 sum once, so they differ where the two orders
# straddle a bf16 rounding boundary (one bf16 step, 2^-8 relative, in a
# few elements). A planted fault (the plain version with one K-group's
# scale row dropped) must read above the limit in every check.
K7_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# the serving configuration's decode matmuls: (name, K, N, calls per
# decode step); every one also at the rows of an LM forward (3072)
K7_SHAPES = (("qkv", 768, 1280, 12), ("wo", 768, 768, 12),
             ("w1/w3", 768, 2048, 24), ("w2", 2048, 768, 12),
             ("logits", 768, 32000, 1))
K7_ROWS = (1, 7, 32, 64, 3072)
DECODE_B = 32
# K8 at the rows of an LM forward, 768 and 3072 wide: bit for bit
K8_SHAPES = ((3072, 768), (3072, 3072))
# phase 7: an int4 greedy token must equal the argmax of a dense f32
# forward of the dequantized model (int4_server_reference) wherever its
# top-1/top-2 margin exceeds this (phase 3's 0.05 for rounding activations
# to bf16, doubled: the f32 dense forward does not round them at all)
QMARGIN = 0.1
# phase 6: int8_matmul against x @ dequant(w) in f32 by relative Frobenius
# error; they differ by x's per-row int8 rounding alone (half a step of
# absmax/127, ~0.75% relative RMS for Gaussian rows)
INT8_ROWS = (1, 7, 16, 17, 32)
INT8_TOL = 2e-2
# phase 7, int8: every decode matmul quantizes x per row, so the server's
# bf16 x and the f32 dense forward's x (relative 2^-9 apart) land on
# different int8 codes (one step, absmax/127) in some elements; the margin
# is QMARGIN x 2.5, and fewer tokens clear it (at least 1/8 must)
QMARGIN8 = 0.25


# phase 8: K4 is held bit for bit (p, m and v) at every parameter shape of
# the flagship and a few odd sizes, in bf16 stochastic, bf16 nearest and
# f32; the flagship has 220 tensors, 85,565,952 parameters
K4_FLAGSHIP = (220, 85_565_952)
K4_ODD = ((65,), (131073,), (3, 5, 7))
# K5 against its plain version (in f32 on the same inputs, then rounded to
# the output's dtype) by relative Frobenius error of y, dx, dw and db. f32:
# the two differ in summation order only (the row statistics, and dw, db
# over thousands of rows, ~1e-6 at most); bf16 outputs: each rounds its f32
# result once, so they differ by one bf16 step where the two orders
# straddle a rounding boundary, in a few elements. A planted fault (the
# plain dw with one row tile's partial dropped) must read above the limit
# in every check.
K5_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
K5_SHAPES = ((3072, 768), (8192, 768))  # B.T of a flagship micro-batch
K5_SMALL = ((15, 256), (8, 100), (40, 8192))


def _counted():
    """(name, wrapper, attribute) of every kernel launch counter."""
    from lamp_tpu_torch.ops import fused_layernorm as FL
    from lamp_tpu_torch.ops.attention import flash_attention
    from lamp_tpu_torch.ops.fused_adamw import fused_adamw_update
    from lamp_tpu_torch.ops.paged_attention import paged_attention
    from lamp_tpu_torch.ops.quantization import (int4_matmul,
                                                 quantize_int8_stochastic)

    return (("paged_attention", paged_attention, "launches"),
            ("flash_attention", flash_attention, "launches"),
            ("flash_attention_backward", flash_attention,
             "backward_launches"),
            ("int4_matmul", int4_matmul, "launches"),
            ("quantize_int8_stochastic", quantize_int8_stochastic,
             "launches"),
            ("fused_adamw", fused_adamw_update, "launches"),
            ("fused_layernorm_fwd", FL.fused_layernorm, "launches"),
            ("fused_layernorm_bwd", FL.fused_layernorm, "backward_launches"))


def reset_launch_counts():
    """Every kernel wrapper's launch count to 0, just before a main path."""
    for _, wrapper, attr in _counted():
        setattr(wrapper, attr, 0)


def launch_counts():
    """Every kernel wrapper's launch count, by name."""
    return {name: getattr(wrapper, attr) for name, wrapper, attr in _counted()}


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
    """The kernel against its plain version at the slice's shapes, on the
    bf16 pool and on the same values in an fp8 (e4m3) pool; e5m2 once."""
    dev = torch.device("cuda")
    b, h, hkv, d, pps = 32, HEADS, KV_HEADS, DIM // HEADS, CTX // PAGE
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    pool = randn(BLOCKS * TOTAL_PAGES, 2, PAGE, hkv * d)
    pool8 = pool.to(torch.float8_e4m3fn)
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

    def check(kv, append, window, windows, what):
        """One call against the plain version in f32 (which upcasts an fp8
        pool itself); returns the largest abs error."""
        app = (new_k, new_v) if append else None
        app32 = (new_k.float(), new_v.float()) if append else None
        kw = dict(num_kv_heads=hkv, window=window, windows=windows,
                  page_offset=offset)
        out = paged_attention(q, kv, None, table, lengths, append_kv=app,
                              **kw)
        ref = paged_attention_reference(
            q.float(), kv if kv.element_size() == 1 else kv.float(), None,
            table, lengths, append_kv=app32, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs()
        bad = err > ATOL + RTOL * ref.abs()
        if bad.any():
            raise AssertionError(
                f"paged_attention {what} append={append} window={window} "
                f"windows={windows is not None}: {int(bad.sum())} elements "
                f"off, max err {float(err.max()):.3e}")
        if not append and (out[lengths == 0] != 0).any():
            raise AssertionError("rows with no valid key are not 0")
        print(f"  {what:8} append={append!s:5} window={window!s:4} "
              f"windows={windows is not None!s:5} max_abs_err "
              f"{float(err.max()):.3e}")
        return float(err.max())

    max_err = {"bf16": 0.0, "fp8": 0.0}
    for what, kv in (("bf16", pool), ("fp8", pool8)):
        for append in (False, True):
            for window, windows in ((None, None), (100, None), (None, wins),
                                    (100, wins)):
                max_err[what] = max(max_err[what], check(
                    kv, append, window, windows,
                    what if what == "bf16" else "e4m3fn"))
    max_err["fp8"] = max(max_err["fp8"], check(
        pool.to(torch.float8_e5m2), True, 100, wins, "e5m2"))

    # the split K/V layout and the other instantiations (f32, head_dim
    # 128, 8 query heads per kv head, an fp8 pool with an f32 q), at small
    # shapes
    k_split, v_split = pool[:, 0].contiguous(), pool[:, 1].contiguous()
    cases = [(q, k_split, v_split, hkv)]
    for dt, hd, nh, nkv, pdt in (
            (torch.float32, 64, 8, 2, torch.float32),
            (torch.bfloat16, 128, 8, 1, torch.bfloat16),
            (torch.float32, 128, 4, 4, torch.float32),
            (torch.float32, 128, 8, 2, torch.float8_e4m3fn)):
        small = torch.randn((64, 2, PAGE, nkv * hd), generator=gen,
                            device=dev).to(pdt)
        cases.append((torch.randn((b, nh, hd), generator=gen,
                                  device=dev).to(dt), small, None, nkv))
    for qq, kp, vp, nkv in cases:
        tab = table % kp.shape[0]
        out = paged_attention(qq, kp, vp, tab, lengths, num_kv_heads=nkv,
                              windows=wins)
        ref = paged_attention_reference(
            qq.float(), kp if kp.element_size() == 1 else kp.float(),
            None if vp is None else vp.float(), tab, lengths,
            num_kv_heads=nkv, windows=wins)
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        tol = ATOL if qq.dtype == torch.bfloat16 else 1e-4
        print(f"  {qq.dtype} head_dim={qq.shape[2]} heads={qq.shape[1]}/"
              f"{nkv} pool {kp.dtype} split={vp is not None} max_abs_err "
              f"{err:.3e}")
        if err > tol * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"paged_attention instantiation: err {err}")

    # time both on the path's own call: append_kv, no window, last layer
    rows = {}
    for what, kv in (("bf16", pool), ("fp8", pool8)):
        def kernel():
            paged_attention(q, kv, None, table, lengths, num_kv_heads=hkv,
                            append_kv=(new_k, new_v), page_offset=offset)

        def plain():
            paged_attention_reference(q, kv, None, table, lengths,
                                      num_kv_heads=hkv,
                                      append_kv=(new_k, new_v),
                                      page_offset=offset)

        # device time by profiler; the wrapper's whole call (host launch
        # path included) by CUDA events over back-to-back calls, printed
        ms = _kernel_ms(device_ms(kernel, 50), "paged_attention_kernel")
        plain_ms = sum(device_ms(plain, 10).values())
        events_ms = cuda_time_ms(kernel, 200)
        live = int(lengths.sum()) + b
        kv_bytes = live * 2 * hkv * d * kv.element_size()
        gbs = kv_bytes / (ms * 1e-3) / 1e9
        # the least bytes of the call: each K/V row read once, q read and
        # the output written once, the page table and lengths read once
        nbytes = kv_bytes + 2 * q.numel() * 2 + (table.numel() + b) * 4
        bound_ms = max(nbytes / PEAK_BYTES,
                       4 * live * HEADS * d / PEAK_FLOPS) * 1e3
        print(f"  {what} pool: kernel {ms * 1e3:.2f} us (device), plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({live} live tokens, {gbs:.0f} GB/s of K/V rows); the "
              f"wrapper by CUDA events over back-to-back calls "
              f"{events_ms * 1e3:.2f} us")
        rows[what] = dict(max_abs_err=max_err[what], ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by="bytes",
                          library_ms=None)
    return rows


def device_events(prof):
    """The profile's kernels and copies on the device, without the device
    rows of user annotations (``Optimizer.step#AdamW.step`` spans its
    kernels and the gaps between them), which share a name with a host
    row."""
    events = prof.key_averages()
    host = {e.key for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in host]


def profile_step(server):
    """torch.profiler over one steady step_many(8): the device's busy share
    of the wall time (a lower bound: tracing slows the host) and the
    kernels that take the most device time. Returns (device time us,
    device ops) of the call."""
    with traced() as trace:
        t0 = time.perf_counter()
        server.step_many(8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = sorted(trace.events,
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in device)
    ops = sum(e.count for e in device)
    print(f"  profile of one step_many(8): {wall_us:.0f} us wall, device "
          f"busy {busy:.0f} us ({100 * busy / wall_us:.1f}%), "
          f"{ops} device ops; top kernels:")
    for e in device[:8]:
        print(f"    {100 * e.self_device_time_total / busy:5.1f}%  "
              f"{e.self_device_time_total:8.0f} us  x{e.count:<5} "
              f"{e.key[:90]}")
    return busy, ops


def serve_requests(models, server):
    """Phase 3's 40 requests (prompts of 24-31 tokens, 36 sampled, 4
    greedy, max_tokens 32-96) through ServingEngine(decode_steps=8,
    max_batch=32), with every launch count set to 0 just before the run.
    Checks each result's length and range and that the page pool returns
    to its start. Returns (prompts, results, greedy ids, decode steps)."""
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
    # the main path's run: the launch counts cover exactly this
    reset_launch_counts()
    steps0 = server.steps_decoded
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = server.steps_decoded - steps0
    emitted = sum(len(v) for v in results.values())
    print(f"  engine: 40 requests, {emitted} tokens, {steps} decode steps, "
          f"{wall:.2f} s wall")
    if sorted(results) != sorted(prompts):
        raise AssertionError("missing results")
    for rid, toks in results.items():
        if len(toks) != max_tokens[rid] or not all(
                0 <= t < VOCAB for t in toks):
            raise AssertionError(f"{rid}: {len(toks)} tokens, want "
                                 f"{max_tokens[rid]} in [0, {VOCAB})")
    if len(server.free_pages) != free0 or server.seq_pages:
        raise AssertionError("the page pool did not return to its start")
    return prompts, results, [f"r{i}" for i in sorted(greedy)], steps


def check_launches(name, launches, want):
    print(f"  {name}: {launches} launches, want {want}")
    if launches == 0 or launches != want:
        raise AssertionError(f"{name}: {launches} launches, want {want}")


def check_greedy(logits_of, prompts, results, greedy, margin, least=4):
    """Each greedy token against the argmax of ``logits_of(tokens, prompt
    length)`` ([T, V]) wherever its top-1/top-2 margin exceeds ``margin``;
    at least 1/``least`` of the tokens must be checked."""
    checked = total = 0
    with torch.no_grad():
        for rid in greedy:
            seq = prompts[rid] + results[rid]
            logits = logits_of(torch.as_tensor([seq[:-1]], device="cuda"),
                               len(prompts[rid]))
            top = logits[len(prompts[rid]) - 1:].topk(2, dim=-1)
            gap = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
            argmax = top.indices[:, 0].cpu().numpy()
            for j, tok in enumerate(results[rid]):
                total += 1
                if gap[j] > margin:
                    checked += 1
                    if tok != argmax[j]:
                        raise AssertionError(
                            f"{rid} token {j}: {tok} != dense argmax "
                            f"{argmax[j]} (margin {gap[j]:.3f})")
    print(f"  greedy: {checked} of {total} tokens past the {margin} margin "
          f"equal the dense argmax")
    if checked < total // least:
        raise AssertionError("too few greedy tokens could be checked")


def steady_decode(models, server, what):
    """Steady decode rate of 32 requests with step_many(8) (CUDA events over
    5 rounds after 2), then one profiled call. Returns tok/s, and the
    device time (us) and device ops per decode step of the profiled
    call."""
    rng = np.random.RandomState(0)
    for i in range(32):
        server.add(f"s{i}", rng.randint(0, VOCAB, 24 + i % 8).tolist(),
                   models.SamplingParams(temperature=0.8))
    server.step_many(8)
    server.step_many(8)
    ms = cuda_time_ms(lambda: server.step_many(8), 5, warmup=0)
    tok_s = 32 * 8 / (ms * 1e-3)
    print(f"  decode ({what}): step_many(8) at B=32 {ms:.2f} ms, "
          f"{ms / 8:.3f} ms/step, {tok_s:.1f} tok/s", flush=True)
    busy, ops = profile_step(server)
    for i in range(32):
        server.remove(f"s{i}")
    return dict(tok_s=tok_s, device_us_per_step=busy / 8,
                device_ops_per_step=ops / 8)


def make_serving_model(torch_nn):
    """The serving configuration's ModernLM, random weights from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return torch_nn.ModernLM.init(
        vocab_size=VOCAB, context_length=CTX, num_blocks=BLOCKS,
        embed_dim=DIM, num_heads=HEADS, num_kv_heads=KV_HEADS,
        generator=gen, dtype=torch.bfloat16, device="cuda")


def phase_serving(model, models, paged_attention):
    """The slice through ServingEngine at full width, then its decode rate.
    Returns K6's launches and the steady decode figures."""
    server = models.ModernBatchServer(model, page_size=PAGE,
                                      total_pages=TOTAL_PAGES)
    prompts, results, greedy, steps = serve_requests(models, server)
    launches = paged_attention.launches
    check_launches("paged_attention", launches, BLOCKS * steps)
    check_greedy(lambda t, _: model(t)[0], prompts, results, greedy, MARGIN)
    return launches, steady_decode(models, server, "bf16")


@contextlib.contextmanager
def traced():
    """torch.profiler (host and device) over the block, each end padded
    with 50 ms of idle host time; yields an object whose ``events`` are
    then the block's device rows (kernel name, ``self_device_time_total``
    in us, ``count`` of launches). On the H100 machine, traces without the
    padding and without device_ms's count rule read K6-fp8 at a fifth of
    its time and K4 below its bound."""
    from torch.profiler import ProfilerActivity, profile

    trace = types.SimpleNamespace(events=[])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        yield trace
        torch.cuda.synchronize()
        time.sleep(0.05)
    trace.events = device_events(prof)


def device_ms(fn, n: int, warmup: int = 2):
    """Device time per call of ``fn()``, by kernel name, from
    torch.profiler over ``n`` calls: ``{kernel: ms}``. The H100 machine's
    traces lose kernel records (a kernel launched once a call read 46-49
    launches of 50, and as few as 2 of 5) and carry strays from other
    traces, so each kernel counts as its mean time a launch times its
    launches a call: its count over ``n``, rounded, at least one (a stray
    counts once). A trace with no device time is taken again, up to three
    times."""
    for _ in range(warmup):
        fn()
    times = {}
    for attempt in range(3):
        with traced() as trace:
            for _ in range(n):
                fn()
        times = {e.key: e.self_device_time_total / e.count
                 * max(1, round(e.count / n)) / 1e3
                 for e in trace.events if e.self_device_time_total > 0}
        if times:
            return times
        print(f"  the profiler's trace held no device time (attempt "
              f"{attempt + 1}); tracing again", flush=True)
    return times


def _kernel_ms(times, name):
    found = [ms for key, ms in times.items() if name in key]
    if not found:
        raise AssertionError(f"no device time for {name}: {sorted(times)}")
    return sum(found)


def flash_inputs(b, h, sq, skv, d, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d), \
        randn(b, h, sq, d)


def block_err(got, want):
    """The largest ||got - want|| / ||want|| over the 64-row blocks of each
    (b, h) slab of [B, H, S, D] tensors; inf where want is 0 in a block
    and got is not."""
    pad = -want.shape[2] % FLASH_BLOCK

    def blocks(x):
        x = torch.nn.functional.pad(x.detach().float(), (0, 0, 0, pad))
        return x.reshape(x.shape[0], x.shape[1], -1, FLASH_BLOCK * x.shape[3])

    g, w = blocks(got), blocks(want)
    num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
    if (num[den == 0] != 0).any():
        return math.inf
    return float((num[den > 0] / den[den > 0]).max())


def planted_fault(sq, skv):
    """The visibility of a faulty kernel the checks must catch: rows past
    Sq/4 skip one 64-key tile (keys 512-575 at Skv=4096, 64-127 at 384)."""
    k0 = FLASH_BLOCK * max(1, skv // 512)
    keep = torch.ones(sq, skv, dtype=torch.bool, device="cuda")
    keep[sq // 4:, k0:k0 + FLASH_BLOCK] = False
    return keep


def check_flash(att, name, b, h, sq, skv, d, dtype, causal, window=None,
                lengths=None):
    """Kernels (forward through autograd, then backward) against the plain
    version in f32, by :func:`block_err`; the plain version under
    :func:`planted_fault` must read above the limit. Returns the max abs
    error of (o, dq, dkv), the largest block error and the smallest planted
    fault's reading."""
    q, k, v, do = flash_inputs(b, h, sq, skv, d, dtype)
    lens = None if lengths is None else torch.as_tensor(
        np.asarray(lengths, np.int32), device="cuda")
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    o = att.flash_attention(qq, kk, vv, causal=causal, window=window,
                            kv_lengths=lens)
    o.backward(do)
    torch.cuda.synchronize()
    kw = dict(causal=causal, window=att._check_window(window, causal, skv),
              kv_lengths=lens, sm_scale=1.0 / math.sqrt(d))
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))

    def plain(**fault):
        with torch.no_grad():
            ro, rlse = att.flash_attention_reference(q32, k32, v32, **kw,
                                                     **fault)
            return (ro,) + att._flash_backward_reference(
                q32, k32, v32, ro, rlse, do32, **kw, **fault)

    wants = plain()
    faults = plain(mask=planted_fault(sq, skv))
    errs, rels, planted = [], [], []
    tol = FLASH_TOL[dtype]
    for what, got, want, bad in zip(("o", "dq", "dk", "dv"),
                                    (o, qq.grad, kk.grad, vv.grad), wants,
                                    faults):
        rel, fault = block_err(got, want), block_err(bad, want)
        if not rel <= tol:
            raise AssertionError(f"flash {name} {what}: block error "
                                 f"{rel:.3e} > {tol:.0e}")
        if not fault > tol:
            raise AssertionError(f"flash {name} {what}: the planted fault "
                                 f"reads {fault:.3e}, within {tol:.0e}")
        errs.append(float((got.detach().float() - want).abs().max()))
        rels.append(rel)
        planted.append(fault)
    del wants, faults
    if lens is not None:  # rows with no key: exactly 0 out and 0 dq
        empty = (lens == 0) if lens.dim() == 2 else \
            (lens == 0)[:, None].expand(b, sq)
        rows = empty[:, None, :].expand(b, h, sq)
        if (o.detach()[rows] != 0).any() or (qq.grad[rows] != 0).any():
            raise AssertionError(f"flash {name}: rows with no key are not 0")
    print(f"  {name:14} B={b} H={h} Sq={sq} Skv={skv} D={d} "
          f"{str(dtype)[6:]:8} causal={causal!s:5} window={window} "
          f"lengths={'none' if lens is None else list(lens.shape)}:\n"
          f"    block error o/dq/dk/dv {' '.join(f'{e:.2e}' for e in rels)}; "
          f"planted fault {' '.join(f'{e:.2e}' for e in planted)}; "
          f"max abs err {' '.join(f'{e:.2e}' for e in errs)}", flush=True)
    return (errs[0], errs[1], max(errs[2], errs[3])), max(rels), min(planted)


def time_flash(att, b, h, s, d):
    """Device times (ms) of the three kernels, their plain versions and
    scaled_dot_product_attention at one causal bf16 shape, and each
    kernel's bound from the work these inputs need."""
    import torch.nn.functional as F

    q, k, v, do = flash_inputs(b, h, s, s, d, torch.bfloat16, seed=1)
    scale = 1.0 / math.sqrt(d)
    o, lse = att._fwd_cuda(q, k, v, None, True, scale, None)
    n = 20 if s <= 1024 else 5
    fwd = _kernel_ms(device_ms(
        lambda: att._fwd_cuda(q, k, v, None, True, scale, None), n),
        "fwd_bf16")
    bwd = device_ms(lambda: att._bwd_cuda(q, k, v, o, lse, do, None, True,
                                          scale, None), n)
    dq, dkv = _kernel_ms(bwd, "dq_bf16"), _kernel_ms(bwd, "dkv_bf16")
    plain = sum(device_ms(lambda: att.flash_attention_reference(
        q, k, v, causal=True), 2, warmup=1).values())
    plain_bwd = sum(device_ms(lambda: att._flash_backward_reference(
        q, k, v, o, lse, do, causal=True), 2, warmup=1).values())
    lib = sum(device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), n).values())
    ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = sum(device_ms(lambda: torch.autograd.grad(
        lo, (ql, kl, vl), do, retain_graph=True), n).values())
    # the work these inputs need: causal (row, key) pairs; each input read
    # once and each output written once (2-byte tensors, 4-byte lse and di)
    pairs = b * h * s * (s + 1) / 2
    t = b * h * s * d * 2
    rows = b * h * s * 4

    def bound(products, nbytes):
        fl, by = 2 * products * d * pairs / PEAK_FLOPS, nbytes / PEAK_BYTES
        return max(fl, by) * 1e3, ("operations" if fl >= by else "bytes")

    # whole calls by CUDA events (host launch time included, which can
    # exceed the device time at S=384): forward, and forward + backward
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(qg, kg, vg), (qg, kg, vg), do)

    def plain_fwd_bwd():
        po, plse = att.flash_attention_reference(q, k, v, causal=True)
        att._flash_backward_reference(q, k, v, po, plse, do, causal=True)

    events = [
        ("kernel", lambda: att.flash_attention(q, k, v, causal=True),
         fwd_bwd(lambda a, b_, c: att.flash_attention(a, b_, c, causal=True)),
         n),
        ("plain", lambda: att.flash_attention_reference(q, k, v, causal=True),
         plain_fwd_bwd, 2),
        ("library", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), fwd_bwd(
            lambda a, b_, c: F.scaled_dot_product_attention(
                a, b_, c, is_causal=True)), n)]
    print(f"  CUDA events, B={b} H={h} S={s}: " + "; ".join(
        f"{name} forward {cuda_time_ms(f, it, warmup=1) * 1e3:.1f} us, "
        f"forward+backward {cuda_time_ms(fb, it, warmup=1) * 1e3:.1f} us"
        for name, f, fb, it in events), flush=True)
    # the backward as a whole: dq and dkv against the plain backward and
    # SDPA's (each of dq, dk, dv), and the 5 products any backward needs
    # (the split design does 7: dq recomputes S and dP)
    backward = dict(ms=dq + dkv, plain_ms=plain_bwd, library_ms=lib_bwd,
                    bound=bound(5, 8 * t + 2 * rows))
    out = {
        "flash_attention_fwd": dict(ms=fwd, plain_ms=plain, library_ms=lib,
                                    bound=bound(2, 4 * t + rows)),
        "flash_attention_bwd_dq": dict(ms=dq, plain_ms=plain_bwd,
                                       library_ms=lib_bwd,
                                       bound=bound(3, 5 * t + 2 * rows),
                                       backward=backward),
        "flash_attention_bwd_dkv": dict(ms=dkv, plain_ms=plain_bwd,
                                        library_ms=lib_bwd,
                                        bound=bound(4, 6 * t + 2 * rows),
                                        backward=backward),
    }
    for name, r in list(out.items()) + [("backward (dq + dkv)", backward)]:
        print(f"  {name:24} B={b} H={h} S={s}: {r['ms'] * 1e3:9.1f} us, "
              f"bound {r['bound'][0] * 1e3:7.1f} us ({r['bound'][1]}), plain "
              f"{r['plain_ms'] * 1e3:9.1f} us, library "
              f"{r['library_ms'] * 1e3:7.1f} us", flush=True)
    print("  (the dq and dkv rows' plain and library times are of the whole "
          "backward)", flush=True)
    return out


def phase_flash(att):
    checks = {torch.bfloat16: [], torch.float32: []}

    def check(*args, **kw):
        result = check_flash(att, *args, **kw)
        checks[args[6]].append(result)
        return result[0]

    errs = [check("slice", 2, LM_HEADS, 4096, 4096, 64, torch.bfloat16, True),
            check("flagship", 8, LM_HEADS, 384, 384, 64, torch.bfloat16,
                  True)]
    rng = np.random.RandomState(0)
    check("lengths [B]", 4, LM_HEADS, 1000, 1000, 64, torch.bfloat16, True,
          lengths=[0, 1000, 777, 333])
    check("lengths [B,Sq]", 2, LM_HEADS, 1000, 1000, 64, torch.bfloat16,
          True, lengths=rng.randint(0, 1001, (2, 1000)))
    check("window", 2, LM_HEADS, 3000, 3000, 64, torch.bfloat16, True,
          window=1000)
    check("noncausal", 2, LM_HEADS, 700, 1100, 64, torch.bfloat16, False)
    check("head_dim 128", 2, 8, 1024, 1024, 128, torch.bfloat16, True,
          lengths=[1024, 555])
    check("f32", 2, 4, 512, 512, 64, torch.float32, True, lengths=[0, 400])
    check("f32 head 128", 1, 4, 300, 400, 128, torch.float32, False)
    for dtype, results in checks.items():
        print(f"  {str(dtype)[6:]}: largest block error "
              f"{max(r[1] for r in results):.3e}, limit "
              f"{FLASH_TOL[dtype]:.0e}, smallest planted fault "
              f"{min(r[2] for r in results):.3e}", flush=True)
    times = time_flash(att, 2, LM_HEADS, 4096, 64)
    time_flash(att, 8, LM_HEADS, 384, 64)  # printed: the flagship shape
    for i, name in enumerate(times):
        times[name]["max_abs_err"] = max(e[i] for e in errs)
    return times


def profile_train_step(step, state, batch):
    """torch.profiler over one train step: device busy share of the wall
    time, the top kernels, and the check that attention ran in the port's
    kernels and in no library attention kernel. Returns the names of the
    kernels that ran, joined."""
    with traced() as trace:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = sorted(trace.events,
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in device)
    print(f"  profile of one step: {wall_us:.0f} us wall, device busy "
          f"{busy:.0f} us ({100 * busy / wall_us:.1f}%), "
          f"{sum(e.count for e in device)} device ops; top kernels:")
    for e in device[:10]:
        print(f"    {100 * e.self_device_time_total / busy:5.1f}%  "
              f"{e.self_device_time_total:8.0f} us  x{e.count:<5} "
              f"{e.key[:90]}")
    names = " ".join(e.key for e in device)
    for ours in ("fwd_bf16", "dq_bf16", "dkv_bf16"):
        if ours not in names:
            raise AssertionError(f"the step ran no {ours} kernel")
    for library in ("flash_fwd", "flash_bwd", "fmha", "efficient_attention",
                    "cudnn"):
        if library in names:
            raise AssertionError(f"a library attention kernel ran: {library}")
    return names


def optimizer_device_ms(opt):
    """Device time (ms) of one ``opt.step()`` on the gradients it holds,
    by profiler over 20 calls (each updates the parameters again)."""
    times = device_ms(lambda: opt.step(), 20, warmup=1)
    if not times:
        raise AssertionError(f"no device time for {type(opt).__name__}.step")
    return sum(times.values())


def train_config(torch_nn, train, att, name, ctx, batch, accum, make_opt):
    """One training configuration at full width: 2 warm-up steps, 5 timed
    steps (CUDA events) whose launch counts are returned, 10 steps on one
    batch of SURVEY.md's bytes (the loss must fall), one profiled step and
    the optimizer's device time. ``make_opt(model)`` builds the
    optimizer."""
    dev = torch.device("cuda")
    text = np.frombuffer((Path(__file__).resolve().parent / "SURVEY.md")
                         .read_bytes(), np.uint8)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = torch_nn.LanguageModelModule.init(
        vocab_size=LM_VOCAB, context_length=ctx, num_blocks=LM_BLOCKS,
        embed_dim=LM_DIM, attention_heads=LM_HEADS, generator=gen,
        dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    opt = make_opt(model)

    def loss_fn(m, b, generator, train_mode):
        tokens, target = b
        logits = m(tokens, train=train_mode, generator=generator)
        return torch_nn.lm_loss(logits, target), tokens.shape[0]

    state = train.TrainState.init(model, opt)
    step = train.make_train_step(opt, loss_fn, accumulation_steps=accum)
    shape = (accum, batch, ctx) if accum > 1 else (batch, ctx)
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(rng.randint(0, LM_VOCAB, shape), device=dev)
    data = (tokens, torch.roll(tokens, -1, dims=-1))
    losses = []
    for _ in range(2):
        losses.append(step(state, data)[1][0])
    # the main path's run: the launch counts cover exactly these steps
    reset_launch_counts()
    steps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        losses.append(step(state, data)[1][0])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    launches = launch_counts()
    want = LM_BLOCKS * accum * steps
    got = (launches["flash_attention"],
           launches["flash_attention_backward"])
    if got != (want, want):
        raise AssertionError(f"{name}: launches {got}, want {want} each")
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError(f"{name}: a loss is not finite: {losses}")
    tok_s = accum * batch * ctx / (ms * 1e-3)
    flops_tok = 6 * n_params + 12 * LM_BLOCKS * LM_DIM * ctx
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {name}: ctx {ctx}, batch {batch} x {accum}, {n_params} "
          f"params, {type(opt).__name__}: {ms:.2f} ms/step, {tok_s:.1f} "
          f"train tok/s, {flops_tok / 1e6:.1f} MFLOP/token, "
          f"{100 * tok_s * flops_tok / PEAK_FLOPS:.2f}% of 989 TFLOP/s; "
          f"launches fwd {got[0]} bwd {got[1]} (12 x {accum} x {steps}); "
          f"peak memory {peak:.2f} GiB", flush=True)
    # one fixed batch of the repository's own text: the loss must fall
    need = int(np.prod(shape)) + 1
    chunk = np.resize(text, need).astype(np.int64)
    fixed = torch.as_tensor(chunk[:-1].reshape(shape), device=dev)
    fixed_target = torch.as_tensor(chunk[1:].reshape(shape), device=dev)
    text_losses = [step(state, (fixed, fixed_target))[1][0]
                   for _ in range(10)]
    first, last = float(text_losses[0]), float(text_losses[-1])
    print(f"  {name}: 10 steps on SURVEY.md bytes: loss {first:.4f} -> "
          f"{last:.4f}", flush=True)
    if not last < first:
        raise AssertionError(f"{name}: loss did not fall on fixed text")
    names = profile_train_step(step, state, data)
    opt_ms = optimizer_device_ms(opt)
    print(f"  {name}: one {type(opt).__name__} step {opt_ms * 1e3:.1f} us "
          f"of device time", flush=True)
    del model, opt, state
    return dict(ms=ms, tok_s=tok_s, peak_gib=peak, launches=launches,
                optimizer_ms=opt_ms, n_params=n_params, kernels=names)


def phase_train(torch_nn, optim, train, att):
    """Both training configurations at full width; returns the kernels'
    launches over the timed steps and the flagship's figures."""
    from lamp_tpu_torch.nn.module import param_tags

    launches = backward_launches = 0
    flagship = None
    for name, ctx, batch, accum in TRAIN_CONFIGS:
        if accum > 1:  # the example's optimizer (autoregressivelm.py:93-107)
            def make_opt(model):
                return optim.AdamW(
                    model.named_parameters(), 3e-4, beta2=0.95, clip=1.0,
                    weight_decay=lambda tag: 0.0 if (
                        "bias" in tag or "LayerNorm" in tag or "scale" in tag
                        or "Embedding" in tag) else 0.01,
                    tags=param_tags(model))
        else:  # bench.py:230
            def make_opt(model):
                return optim.AdamW(model.named_parameters(), 3e-4,
                                   weight_decay=0.01)
        run = train_config(torch_nn, train, att, name, ctx, batch, accum,
                           make_opt)
        launches += run["launches"]["flash_attention"]
        backward_launches += run["launches"]["flash_attention_backward"]
        if name == "flagship":
            flagship = run
    return launches, backward_launches, flagship


def rel_err(got, want):
    """||got - want|| / ||want|| in f32."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm())


def check_int8_matmul(Q, gen):
    """int8_matmul (torch._int_mm; below 17 rows padded with zero rows) at
    the decode shapes, x bf16 and out in the path's dtype: bit for bit
    against the same arithmetic with the int8 product taken in f64 (exact
    for these sums), and within INT8_TOL of x @ dequant(w) in f32."""
    worst = 0.0
    for name, k, n, _ in K7_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        wq, ws = Q.quantize_int8(w, axis=0)
        w_deq = Q.dequantize_int8(wq, ws)
        od = torch.float32 if name == "logits" else torch.bfloat16
        for m in INT8_ROWS:
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            got = Q.int8_matmul(x, wq, ws, out_dtype=od)
            xq, xs = Q.quantize_int8(x, axis=1)
            exact = (xq.double() @ wq.double()).float()
            if not torch.equal(got, (exact * xs * ws).to(od)):
                raise AssertionError(
                    f"int8_matmul {name} M={m}: differs from the exact "
                    f"int8 product")
            err = rel_err(got, x.float() @ w_deq)
            if not err <= INT8_TOL:
                raise AssertionError(f"int8_matmul {name} M={m}: error "
                                     f"{err:.3e} > {INT8_TOL:.0e}")
            worst = max(worst, err)
    print(f"  int8_matmul at M in {INT8_ROWS}: bit for bit equal to the "
          f"exact int8 product; largest relative error against x @ "
          f"dequant(w) {worst:.3e} (limit {INT8_TOL:.0e})", flush=True)


def phase_quant_kernels(Q):
    """K7 and K8 against their plain versions at the serving configuration's
    shapes, and their device times; returns the kernels-line figures."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    least_fault = math.inf
    path_err = 0.0
    per_call = {}
    for name, k, n, per_step in K7_SHAPES:
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        p, s = Q.quantize_int4(w, group_size=Q.int4_group_size(k))
        faulty = s.clone()
        faulty[1] = 0.0  # the planted fault: group 1's scale row dropped
        path_out = torch.float32 if name == "logits" else torch.bfloat16
        for m in K7_ROWS:
            combos = [(torch.bfloat16, torch.bfloat16),
                      (torch.bfloat16, torch.float32)]
            if m <= 64:
                combos.append((torch.float32, torch.float32))
            for xd, od in combos:
                x = torch.randn(m, k, generator=gen, device=dev).to(xd)
                got = Q.int4_matmul(x, p, s, out_dtype=od)
                want = Q.int4_matmul_reference(x, p, s).to(od)
                err = rel_err(got, want)
                fault = rel_err(
                    Q.int4_matmul_reference(x, p, faulty).to(od), want)
                if not bool(torch.isfinite(got).all()) or not err <= K7_TOL[od]:
                    raise AssertionError(
                        f"int4_matmul {name} M={m} x {xd} out {od}: error "
                        f"{err:.3e} > {K7_TOL[od]:.0e}")
                if not fault > K7_TOL[od]:
                    raise AssertionError(
                        f"int4_matmul {name} M={m}: the planted fault reads "
                        f"{fault:.3e}, within {K7_TOL[od]:.0e}")
                worst[od] = max(worst[od], err)
                least_fault = min(least_fault, fault)
                if m == DECODE_B and xd == torch.bfloat16 and od == path_out:
                    path_err = max(path_err, float(
                        (got.float() - want.float()).abs().max()))
        # device times at the decode batch, in the path's dtypes (the
        # kernel and, under split-K, its second pass)
        x = torch.randn(DECODE_B, k, generator=gen, device=dev).bfloat16()
        ms = _kernel_ms(device_ms(
            lambda: Q.int4_matmul(x, p, s, out_dtype=path_out), 50),
            "int4_mm")
        plain = sum(device_ms(lambda: Q.int4_matmul_reference(x, p, s).to(
            path_out), 10).values())
        w_deq = Q.dequantize_int4(p, s).t().contiguous()  # [N, K] bf16
        lib = sum(device_ms(lambda: torch.nn.functional.linear(x, w_deq),
                            50).values())
        xl = torch.randn(K7_ROWS[-1], k, generator=gen, device=dev).bfloat16()
        ms_large = _kernel_ms(device_ms(
            lambda: Q.int4_matmul(xl, p, s, out_dtype=path_out), 5),
            "int4_mm")
        # the wrapper's whole call, host launch path included
        events_ms = cuda_time_ms(
            lambda: Q.int4_matmul(x, p, s, out_dtype=path_out), 200)
        nbytes = (p.numel() + s.numel() * 4 + x.numel() * 2
                  + DECODE_B * n * (4 if path_out == torch.float32 else 2))
        by, fl = nbytes / PEAK_BYTES, 2 * DECODE_B * k * n / PEAK_FLOPS
        per_call[name] = dict(k=k, n=n, per_step=per_step, ms=ms,
                              plain_ms=plain, library_ms=lib,
                              bound_ms=max(by, fl) * 1e3,
                              bound_by="bytes" if by >= fl else "operations",
                              ms_m3072=ms_large, events_ms=events_ms)
        print(f"  int4_matmul {name:6} K={k} N={n}: M={DECODE_B} "
              f"{ms * 1e3:7.2f} us, bound {max(by, fl) * 1e6:6.2f} us, plain "
              f"{plain * 1e3:8.2f} us, F.linear on the dequantized bf16 "
              f"weight {lib * 1e3:6.2f} us; M={K7_ROWS[-1]} "
              f"{ms_large * 1e3:8.2f} us; the wrapper by CUDA events over "
              f"back-to-back calls {events_ms * 1e3:.2f} us", flush=True)
    print(f"  int4_matmul: largest relative error {worst[torch.float32]:.3e} "
          f"(f32 out, limit {K7_TOL[torch.float32]:.0e}), "
          f"{worst[torch.bfloat16]:.3e} (bf16 out, limit "
          f"{K7_TOL[torch.bfloat16]:.0e}); smallest planted fault "
          f"{least_fault:.3e}", flush=True)

    def step_total(key):
        return sum(c[key] * c["per_step"] for c in per_call.values())

    bound_by = {c["bound_by"] for c in per_call.values()}
    k7 = dict(max_abs_err=path_err, ms=step_total("ms"),
              plain_ms=step_total("plain_ms"),
              bound_ms=step_total("bound_ms"),
              bound_by="bytes" if bound_by == {"bytes"} else "operations",
              library_ms=step_total("library_ms"), per_call=per_call)
    calls = sum(c["per_step"] for c in per_call.values())
    print(f"  int4_matmul, one decode step's {calls} calls at "
          f"B={DECODE_B}: {k7['ms'] * 1e3:.1f} "
          f"us, bound {k7['bound_ms'] * 1e3:.1f} us, plain "
          f"{k7['plain_ms'] * 1e3:.1f} us, F.linear {k7['library_ms'] * 1e3:.1f}"
          f" us", flush=True)
    check_int8_matmul(Q, gen)

    # K8 is on no path of the port: this phase drives it directly, and its
    # launch count is this drive's
    reset_launch_counts()
    driven = {}
    for m, k in K8_SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        driven[(m, k)] = (x, Q.quantize_int8_stochastic(x, seed=1))
    anchor = torch.cat([torch.ones(512, 1, device=dev),
                        torch.full((512, 127), 0.3, device=dev)], dim=1)
    vals, scales = Q.quantize_int8_stochastic(anchor, seed=1)
    launches = Q.quantize_int8_stochastic.launches
    v = vals[:, 1:].cpu().numpy()
    mean = float((v.astype(np.float32) * scales.cpu().numpy()).mean())
    print(f"  quantize_int8_stochastic: payload 0.3 -> codes "
          f"{sorted(set(np.unique(v).tolist()))}, mean {mean:.6f}")
    if not set(np.unique(v).tolist()) <= {38, 39} or \
            abs(mean - 0.3) > 0.005 * 0.3:
        raise AssertionError("quantize_int8_stochastic is biased")
    k8 = None
    for (m, k), (x, (vals, scales)) in driven.items():
        rv, rs = Q.quantize_int8_stochastic_reference(x, seed=1)
        if not (torch.equal(vals, rv) and torch.equal(scales, rs)):
            raise AssertionError(
                f"quantize_int8_stochastic [{m}, {k}]: "
                f"{int((vals != rv).sum())} values and "
                f"{int((scales != rs).sum())} scales differ from the plain "
                f"version")
        ms = _kernel_ms(device_ms(
            lambda: Q.quantize_int8_stochastic(x, seed=2), 20),
            "quantize_int8_stochastic_kernel")
        plain = sum(device_ms(lambda: Q.quantize_int8_stochastic_reference(
            x, seed=2), 5).values())
        bound = (m * k * 2 + m * k + m * 4) / PEAK_BYTES * 1e3
        print(f"  quantize_int8_stochastic [{m}, {k}] bf16: bit for bit "
              f"equal to the plain version; {ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.2f} us (bytes), plain {plain * 1e3:.2f} us",
              flush=True)
        k8 = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound,
                  bound_by="bytes", library_ms=None, launches=launches,
                  shape=[m, k])
    return k7, k8


class _RowMix(torch.nn.Module):
    """A linear layer whose first ``split[0]`` rows (a prefilled prompt) go
    through the float weight and the rest (decode steps) through
    ``decode``, both in f32."""

    def __init__(self, weight, decode, split):
        super().__init__()
        self.weight, self.decode, self.split = weight, decode, split

    def forward(self, x):
        rows = torch.arange(x.shape[-2], device=x.device)[:, None]
        return torch.where(rows < self.split[0],
                           torch.nn.functional.linear(x, self.weight),
                           self.decode(x))


def quantized_server_reference(model, Q, bits):
    """``logits_of(tokens, n_prompt)`` -> [T, V] f32: a dense f32 forward
    of what ModernBatchServer(quantize_bits=bits) computes for one
    sequence: the prefilled rows (all prompt tokens but the last) through
    the float weights, as the server's prefill; every later row through
    each decode matmul's quantized weight (int4: x times its round trip;
    int8: int8_matmul, which also quantizes x per row), and the logits
    likewise through the tied logits matrix."""
    dense = copy.deepcopy(model).float()
    split = [0]

    def decode_matmul(wt):  # wt [in, out] f32, as the server packs it
        if bits == 8:
            q, s = Q.quantize_int8(wt, axis=0)
            return lambda x: Q.int8_matmul(x, q, s)
        p, s = Q.quantize_int4(wt, group_size=Q.int4_group_size(wt.shape[0]))
        deq = Q.dequantize_int4(p, s, dtype=torch.float32)
        return lambda x: x @ deq

    with torch.no_grad():
        for blk in dense.blocks:
            for owner, name in ((blk, "w_q"), (blk, "w_k"), (blk, "w_v"),
                                (blk, "w_o"), (blk.mlp, "w1"),
                                (blk.mlp, "w3"), (blk.mlp, "w2")):
                w = getattr(owner, name).weight.detach()
                setattr(owner, name, _RowMix(w, decode_matmul(w.T), split))
        logits = decode_matmul(dense.output_weight.detach().T)  # [D, V]

    def logits_of(tokens, n_prompt):
        split[0] = n_prompt - 1
        return logits(dense.hidden(tokens)[0])

    return logits_of


def phase_quant_serving(model, models, Q, paged_attention, decode_bf16):
    """Quantized serving at full width through ServingEngine: int4 (greedy
    tokens against the dequantized dense model), int4 with an fp8 KV pool,
    int8 (greedy tokens against a dense forward through int8_matmul); the
    steady decode of each beside bf16."""
    per_step = 5 * BLOCKS + 1  # K7 calls per decode step
    server = models.ModernBatchServer(model, page_size=PAGE,
                                      total_pages=TOTAL_PAGES,
                                      quantize_bits=4)
    prompts, results, greedy, steps = serve_requests(models, server)
    k7_launches = Q.int4_matmul.launches
    check_launches("int4_matmul", k7_launches, per_step * steps)
    check_launches("paged_attention", paged_attention.launches,
                   BLOCKS * steps)
    check_greedy(quantized_server_reference(model, Q, 4), prompts, results,
                 greedy, QMARGIN)
    torch.cuda.empty_cache()
    decode = {"bf16": decode_bf16,
              "int4": steady_decode(models, server, "int4")}
    del server

    server = models.ModernBatchServer(model, page_size=PAGE,
                                      total_pages=TOTAL_PAGES,
                                      quantize_bits=4,
                                      kv_dtype=torch.float8_e4m3fn)
    prompts8, results8, greedy8, steps8 = serve_requests(models, server)
    check_launches("int4_matmul (fp8 KV)", Q.int4_matmul.launches,
                   per_step * steps8)
    fp8_launches = paged_attention.launches
    check_launches("paged_attention (fp8 KV)", fp8_launches, BLOCKS * steps8)
    same = total = 0
    for rid in greedy:
        a, b = results[rid], results8[rid]
        same += sum(x == y for x, y in zip(a, b))
        total += len(a)
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        print(f"  {rid}: fp8 KV greedy tokens first differ from the bf16 "
              f"KV run at {first}")
    print(f"  greedy agreement, fp8 KV against bf16 KV (int4 weights): "
          f"{same} of {total} positions")
    decode["int4+fp8"] = steady_decode(models, server, "int4 + fp8 KV")
    del server

    server = models.ModernBatchServer(model, page_size=PAGE,
                                      total_pages=TOTAL_PAGES,
                                      quantize_bits=8)
    prompts, results, greedy, steps = serve_requests(models, server)
    if Q.int4_matmul.launches:
        raise AssertionError("the int8 server launched the int4 kernel")
    check_launches("paged_attention (int8)", paged_attention.launches,
                   BLOCKS * steps)
    check_greedy(quantized_server_reference(model, Q, 8), prompts, results,
                 greedy, QMARGIN8, least=8)
    torch.cuda.empty_cache()
    decode["int8"] = steady_decode(models, server, "int8")
    del server
    for what in ("bf16", "int8", "int4", "int4+fp8"):
        d = decode[what]
        print(f"  steady decode {what:9}: {d['tok_s']:.1f} tok/s; profiled "
              f"step {d['device_us_per_step']:.1f} us of device time, "
              f"{d['device_ops_per_step']:.1f} device ops", flush=True)
    return k7_launches, fp8_launches, decode


def _bits(x):
    """The bit pattern of a 2- or 4-byte float tensor, so that equality
    is bit for bit (signed zeros, NaNs)."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def flagship_shapes(torch_nn):
    """The parameter shapes of the flagship GPT, in named_parameters()
    order."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = torch_nn.LanguageModelModule.init(
        vocab_size=LM_VOCAB, context_length=TRAIN_CONFIGS[0][1],
        num_blocks=LM_BLOCKS, embed_dim=LM_DIM, attention_heads=LM_HEADS,
        generator=gen, dtype=torch.bfloat16, device="cuda")
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    got = (len(shapes), sum(math.prod(s) for s in shapes))
    if got != K4_FLAGSHIP:
        raise AssertionError(f"flagship parameters {got}, want {K4_FLAGSHIP}")
    return shapes


def adamw_inputs(shapes, dtype, gen):
    """Parameters, gradients and moments at ``shapes``, and a seed each."""
    def randn(s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    return ([randn(s).to(dtype) for s in shapes],
            [randn(s, 1e-2).to(dtype) for s in shapes],
            [randn(s, 1e-3) for s in shapes],
            [torch.rand(s, generator=gen, device="cuda") * 1e-5
             for s in shapes],
            [11 + i for i in range(len(shapes))])


ADAMW_KW = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


def check_adamw(FA, shapes, dtype, stochastic, gen):
    """One K4 call over every tensor of ``shapes`` (grouped into launches
    of up to 256) against the plain version on each tensor at step 7: new
    p, m and v bit for bit. Returns the launches and the new p."""
    ps, gs, ms, vs, seeds = adamw_inputs(shapes, dtype, gen)
    pk, mk, vk = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    before = FA.fused_adamw_update.launches
    FA._update_many(pk, gs, mk, vk, seeds, 7, stochastic=stochastic,
                    **ADAMW_KW)
    launched = FA.fused_adamw_update.launches - before
    torch.cuda.synchronize()
    differ = 0
    for i in range(len(shapes)):
        want = FA.fused_adamw_update_reference(
            ps[i], gs[i], ms[i], vs[i], 7, stochastic=stochastic,
            seed=seeds[i], **ADAMW_KW)
        for got, w in zip((pk[i], mk[i], vk[i]), want):
            differ += int((_bits(got) != _bits(w)).sum())
    what = f"{str(dtype)[6:]} {'stochastic' if stochastic else 'nearest'}"
    print(f"  fused_adamw {what:19}: {len(shapes)} tensors, "
          f"{sum(p.numel() for p in ps)} parameters, {launched} launch(es): "
          f"{differ} elements of p, m, v differ from the plain version",
          flush=True)
    if differ:
        raise AssertionError(f"fused_adamw {what}: {differ} elements differ "
                             f"from the plain version")
    return launched, pk


def phase_adamw_kernel(torch_nn, optim, FA):
    """K4 against its plain version at the flagship's 220 parameter shapes
    and odd sizes, bit for bit; the unbiasedness check; its device time
    over the flagship's tensors beside its bound, its plain version and the
    port's optim.AdamW step on the same tensors."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flag = flagship_shapes(torch_nn)
    shapes = flag + list(K4_ODD)
    _, sto = check_adamw(FA, shapes, torch.bfloat16, True, gen)
    gen.manual_seed(0)
    _, near = check_adamw(FA, shapes, torch.bfloat16, False, gen)
    moved = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(sto, near))
    print(f"  stochastic and nearest rounding differ in {moved} elements")
    if not moved:
        raise AssertionError("stochastic rounding changed nothing")
    del sto, near
    check_adamw(FA, shapes, torch.float32, False, gen)

    # unbiasedness: 2^20 bf16 parameters at 1.0, first step, lr 1e-4, no
    # decay; each moves by -1e-4 in f32, q = 1e-4 / 2^-8 of them to
    # 0.99609375 and the rest stay at 1.0
    n = 1 << 20
    results = {}
    for stochastic in (True, False):
        p = torch.ones(n, dtype=torch.bfloat16, device=dev)
        FA.fused_adamw_update(p, torch.ones_like(p),
                              torch.zeros(n, device=dev),
                              torch.zeros(n, device=dev), 1, lr=1e-4,
                              weight_decay=0.0, stochastic=stochastic, seed=3)
        results[stochastic] = p.double()
    q = 1e-4 / 2 ** -8
    sigma = 2 ** -8 * math.sqrt(q * (1 - q) / n)
    mean = float(results[True].mean())
    low = float((results[True] == 0.99609375).double().mean())
    print(f"  unbiasedness: stochastic mean {mean:.9f} (1 - 1e-4 = 0.9999, "
          f"sigma {sigma:.2e}, off by {abs(mean - 0.9999) / sigma:.2f} "
          f"sigma), {100 * low:.3f}% at 0.99609375 (q = {100 * q:.3f}%); "
          f"nearest: all 1.0 {bool((results[False] == 1.0).all())}",
          flush=True)
    if not abs(mean - 0.9999) < 5 * sigma or \
            not bool((results[False] == 1.0).all()):
        raise AssertionError("fused_adamw stochastic rounding is biased")

    # times over the flagship's tensors, bf16 with stochastic rounding (the
    # K4 path's configuration)
    ps, gs, ms, vs, seeds = adamw_inputs(flag, torch.bfloat16, gen)

    def kernel():
        FA._update_many(ps, gs, ms, vs, seeds, 1, stochastic=True,
                        **ADAMW_KW)

    def plain():
        for i in range(len(flag)):
            FA.fused_adamw_update_reference(ps[i], gs[i], ms[i], vs[i], 1,
                                            seed=seeds[i], **ADAMW_KW)

    k_ms = _kernel_ms(device_ms(kernel, 20), "fused_adamw_kernel")
    plain_ms = sum(device_ms(plain, 2, warmup=1).values())
    events_ms = cuda_time_ms(kernel, 20)
    numel = sum(p.numel() for p in ps)
    # bytes: p, g, m, v read (2 + 2 + 4 + 4), p, m, v written (2 + 4 + 4);
    # operations: 16 f32 operations an element (the random bits' integer
    # operations not counted) at the card's 67 TFLOP/s outside the tensor
    # cores
    by, fl = 22 * numel / PEAK_BYTES, 16 * numel / 67e12
    bound_ms = max(by, fl) * 1e3
    params = [torch.nn.Parameter(p) for p in ps]
    for p, g in zip(params, gs):
        p.grad = g
    adamw = optim.AdamW([(f"p{i}", p) for i, p in enumerate(params)], 3e-4,
                        weight_decay=0.01)
    replaced_ms = optimizer_device_ms(adamw)
    print(f"  fused_adamw over the flagship's {len(flag)} bf16 tensors "
          f"({numel} parameters): {k_ms * 1e3:.1f} us of device time, bound "
          f"{bound_ms * 1e3:.1f} us ({'bytes' if by >= fl else 'operations'}"
          f"), plain {plain_ms * 1e3:.1f} us, the port's optim.AdamW step "
          f"(f32 masters) {replaced_ms * 1e3:.1f} us; the wrapper's whole "
          f"call by CUDA events {events_ms * 1e3:.1f} us", flush=True)
    del params, adamw, ps, gs, ms, vs
    return dict(max_abs_err=0.0, ms=k_ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if by >= fl else "operations",
                library_ms=None, replaced_ms=replaced_ms)


def check_layernorm(FL, n, d, dtype, bias, gen):
    """fused_layernorm's forward and backward (autograd) against the plain
    versions at [n, d], by relative Frobenius error of y, dx, dw and db in
    their dtypes; the plain dw with one row tile's partial dropped must read
    above the limit. Returns ({output: max abs err}, largest relative
    error, the planted fault's reading)."""
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    x, w = randn(n, d, scale=3.0, shift=1.0), randn(d, scale=0.5, shift=1.0)
    b = randn(d, scale=0.1) if bias else None
    dy = randn(n, d)
    leaves = [t.clone().requires_grad_() for t in (x, w, b) if t is not None]
    y = FL.fused_layernorm(*leaves, *([] if bias else [None]))
    y.backward(dy)
    y_ref, mu, rs = FL.fused_layernorm_reference(x, w, b)
    dx_ref, dw_ref, db_ref = FL.fused_layernorm_backward_reference(
        x, dy, w, mu, rs)
    outs = [("y", y, y_ref), ("dx", leaves[0].grad, dx_ref),
            ("dw", leaves[1].grad, dw_ref.to(dtype))]
    if bias:
        outs.append(("db", leaves[2].grad, db_ref.to(dtype)))
    tol = K5_TOL[dtype]
    errs, rels = {}, []
    for what, got, want in outs:
        rel = rel_err(got, want)
        if not bool(torch.isfinite(got).all()) or not rel <= tol:
            raise AssertionError(f"fused_layernorm [{n}, {d}] {dtype} "
                                 f"{what}: error {rel:.3e} > {tol:.0e}")
        errs[what] = float((got.float() - want.float()).abs().max())
        rels.append(rel)
    rows = FL.tile_rows(n, dev)
    start = rows if n > rows else 0  # the second tile where there is one
    tile = slice(start, start + rows)
    yhat = (x.float() - mu[:, None]) * rs[:, None]
    faulty = dw_ref - (dy.float()[tile] * yhat[tile]).sum(0)
    fault = rel_err(faulty.to(dtype), dw_ref.to(dtype))
    if not fault > tol:
        raise AssertionError(f"fused_layernorm [{n}, {d}] {dtype}: the "
                             f"planted fault reads {fault:.3e}, within "
                             f"{tol:.0e}")
    print(f"  fused_layernorm [{n}, {d}] {str(dtype)[6:]:8} bias={bias!s:5}:"
          f" relative error y/dx/dw{'/db' if bias else ''} "
          f"{' '.join(f'{e:.2e}' for e in rels)}; planted fault "
          f"{fault:.2e} ({rows} rows a tile)", flush=True)
    return errs, max(rels), fault


def time_layernorm(FL, n, d, gen):
    """Device times (ms) of K5a and K5b (both its kernels) at [n, d] bf16
    with bias, their plain versions, F.layer_norm forward and its autograd
    backward, and the bounds."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    x = (torch.randn(n, d, generator=gen, device=dev) * 3 + 1).bfloat16()
    w = (torch.randn(d, generator=gen, device=dev) * 0.5 + 1).bfloat16()
    b = (torch.randn(d, generator=gen, device=dev) * 0.1).bfloat16()
    dy = torch.randn(n, d, generator=gen, device=dev).bfloat16()
    _, mu, rs = FL._fwd_cuda(x, w, b, 1e-5)
    fwd = _kernel_ms(device_ms(lambda: FL._fwd_cuda(x, w, b, 1e-5), 50),
                     "layernorm_fwd")
    bwd = _kernel_ms(device_ms(lambda: FL._bwd_cuda(x, dy, w, mu, rs), 50),
                     "layernorm_bwd")
    plain_fwd = sum(device_ms(lambda: FL.fused_layernorm_reference(x, w, b),
                              10).values())
    plain_bwd = sum(device_ms(lambda: FL.fused_layernorm_backward_reference(
        x, dy, w, mu, rs), 10).values())
    lib_fwd = sum(device_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-5),
                            50).values())
    xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))
    yl = F.layer_norm(xl, (d,), wl, bl, 1e-5)
    lib_bwd = sum(device_ms(lambda: torch.autograd.grad(
        yl, (xl, wl, bl), dy, retain_graph=True), 50).values())
    nd = n * d
    # bytes: forward x read, y written (2 bytes each), w and b read (f32),
    # mu and rstd written; backward x and dy read, dx written, w, mu and
    # rstd read, dw and db written. Operations: ~8 (forward) and ~12
    # (backward) f32 operations an element at 67 TFLOP/s
    bounds = {}
    for what, nbytes, ops in (("fwd", 4 * nd + 8 * d + 8 * n, 8 * nd),
                              ("bwd", 6 * nd + 12 * d + 8 * n, 12 * nd)):
        by, fl = nbytes / PEAK_BYTES, ops / 67e12
        bounds[what] = (max(by, fl) * 1e3,
                        "bytes" if by >= fl else "operations")
    out = {"fwd": dict(ms=fwd, plain_ms=plain_fwd, library_ms=lib_fwd,
                       bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1]),
           "bwd": dict(ms=bwd, plain_ms=plain_bwd, library_ms=lib_bwd,
                       bound_ms=bounds["bwd"][0], bound_by=bounds["bwd"][1])}
    for what, r in out.items():
        print(f"  fused_layernorm {what} [{n}, {d}] bf16: {r['ms'] * 1e3:.2f}"
              f" us, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
              f"plain {r['plain_ms'] * 1e3:.2f} us, F.layer_norm "
              f"{'forward' if what == 'fwd' else 'autograd backward'} "
              f"{r['library_ms'] * 1e3:.2f} us", flush=True)
    return out


def phase_layernorm_kernel(FL):
    """K5a and K5b against their plain versions at the flagship's [3072,
    768], the long context's [8192, 768] (bf16 and f32, with and without
    bias) and odd shapes; then their device times. K5 is on no path of
    the port: its launches are this drive's."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_launch_counts()
    cases = [(n, d, dtype, bias) for n, d in K5_SHAPES
             for dtype in (torch.bfloat16, torch.float32)
             for bias in (True, False)]
    cases += [(n, d, dtype, True) for n, d in K5_SMALL
              for dtype in (torch.bfloat16, torch.float32)]
    cases.append((8, 100, torch.float32, False))
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    least_fault = math.inf
    path_err = {"fwd": 0.0, "bwd": 0.0}
    for n, d, dtype, bias in cases:
        errs, rel, fault = check_layernorm(FL, n, d, dtype, bias, gen)
        worst[dtype] = max(worst[dtype], rel)
        least_fault = min(least_fault, fault)
        if (n, d) in K5_SHAPES and dtype == torch.bfloat16:
            path_err["fwd"] = max(path_err["fwd"], errs["y"])
            path_err["bwd"] = max(path_err["bwd"], *(
                v for k, v in errs.items() if k != "y"))
    launches = launch_counts()
    print(f"  fused_layernorm: largest relative error {worst[torch.float32]:.3e}"
          f" (f32, limit {K5_TOL[torch.float32]:.0e}), "
          f"{worst[torch.bfloat16]:.3e} (bf16, limit "
          f"{K5_TOL[torch.bfloat16]:.0e}); smallest planted fault "
          f"{least_fault:.3e}; {launches['fused_layernorm_fwd']} forward and "
          f"{launches['fused_layernorm_bwd']} backward launches", flush=True)
    times = {shape: time_layernorm(FL, *shape, gen) for shape in K5_SHAPES}
    rows = {}
    for what in ("fwd", "bwd"):
        row = dict(times[K5_SHAPES[0]][what], max_abs_err=path_err[what],
                   launches=launches[f"fused_layernorm_{what}"])
        row["per_shape"] = {f"{n}x{d}": times[(n, d)][what]
                            for n, d in K5_SHAPES[1:]}
        rows[what] = row
    return rows


def phase_adamw_train(torch_nn, train, att, FA, flagship):
    """The flagship GPT under AdamWStochastic(3e-4, weight_decay=0.01), as
    bench.py's fused-optimizer number: phase 5's steps and checks, K4's
    launch count, and the step, optimizer time and peak memory beside
    phase 5's AdamW flagship. Returns K4's launches over the timed
    steps."""
    name, ctx, batch, accum = TRAIN_CONFIGS[0]
    run = train_config(
        torch_nn, train, att, "flagship, AdamWStochastic", ctx, batch, accum,
        lambda model: FA.AdamWStochastic(model.named_parameters(), 3e-4,
                                         weight_decay=0.01))
    # a step launches K4 once per dtype for up to 256 tensors: the
    # flagship's 220 tensors are all bf16
    launches = run["launches"]["fused_adamw"]
    check_launches("fused_adamw", launches, 5)
    if "fused_adamw_kernel" not in run["kernels"]:
        raise AssertionError("the profiled step ran no fused_adamw kernel")
    for what, key, unit, scale in (
            ("step", "ms", "ms", 1.0), ("train tok/s", "tok_s", "", 1.0),
            ("optimizer device time", "optimizer_ms", "us", 1e3),
            ("peak memory", "peak_gib", "GiB", 1.0)):
        print(f"  {what}: AdamWStochastic {run[key] * scale:.2f} {unit}, "
              f"AdamW (phase 5) {flagship[key] * scale:.2f} {unit}",
              flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    # f32 matmuls (the plain versions, the logits) stay f32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lamp_tpu_torch import models, optim, train
    from lamp_tpu_torch import nn as torch_nn
    from lamp_tpu_torch.ops import _build
    from lamp_tpu_torch.ops import attention as att
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

    from lamp_tpu_torch.ops import quantization as Q

    print("phase 2: paged_attention kernel vs plain (bf16 and fp8 pools)",
          flush=True)
    paged = phase_kernel(paged_attention, paged_attention_reference)
    print("phase 3: serving slice at full width", flush=True)
    model = make_serving_model(torch_nn)
    paged["bf16"]["launches"], decode_bf16 = phase_serving(
        model, models, paged_attention)
    print("phase 4: flash attention kernels vs plain", flush=True)
    flash = phase_flash(att)
    print("phase 5: training slice at full width", flush=True)
    fwd_launches, bwd_launches, flagship = phase_train(torch_nn, optim,
                                                       train, att)
    print("phase 6: int4 matmul and stochastic int8 kernels vs plain",
          flush=True)
    k7, k8 = phase_quant_kernels(Q)
    print("phase 7: quantized serving at full width", flush=True)
    k7["launches"], paged["fp8"]["launches"], _ = phase_quant_serving(
        model, models, Q, paged_attention, decode_bf16)
    del model
    torch.cuda.empty_cache()
    from lamp_tpu_torch.ops import fused_adamw as FA
    from lamp_tpu_torch.ops import fused_layernorm as FL

    print("phase 8: fused AdamW (K4) and fused LayerNorm (K5) kernels vs "
          "plain", flush=True)
    k4 = phase_adamw_kernel(torch_nn, optim, FA)
    k5 = phase_layernorm_kernel(FL)
    print("phase 9: the flagship under AdamWStochastic at full width",
          flush=True)
    k4["launches"] = phase_adamw_train(torch_nn, train, att, FA, flagship)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    paged_src = dict(route="cuda",
                     source="lamp_tpu_torch/csrc/paged_attention.cu",
                     replaces="lamp_tpu/ops/paged_attention.py:151")
    rows = [{k: r[k] for k in keys} for r in (
        dict(name="paged_attention", **paged_src, **paged["bf16"]),
        dict(name="paged_attention_fp8", **paged_src, **paged["fp8"]))]
    replaces = {"flash_attention_fwd": "lamp_tpu/ops/attention.py:87",
                "flash_attention_bwd_dq": "lamp_tpu/ops/attention.py:297",
                "flash_attention_bwd_dkv": "lamp_tpu/ops/attention.py:365"}
    for name, r in flash.items():
        row = dict(
            name=name, route="cuda",
            source="lamp_tpu_torch/csrc/flash_attention.cu",
            replaces=replaces[name],
            launches=fwd_launches if name.endswith("fwd") else bwd_launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"])
        if "backward" in r:  # plain_ms and library_ms time dq, dk and dv
            bwd = r["backward"]
            row["backward"] = dict(
                note="plain_ms and library_ms of this row are of the whole "
                     "backward (dq, dk, dv); here the backward's totals",
                ms=bwd["ms"], bound_ms=bwd["bound"][0],
                plain_ms=bwd["plain_ms"], library_ms=bwd["library_ms"])
        rows.append(row)
    row = dict(name="int4_matmul", route="cuda",
               source="lamp_tpu_torch/csrc/int4_matmul.cu",
               replaces="lamp_tpu/ops/quantization.py:233", **k7)
    row = {k: row[k] for k in keys}
    row["note"] = ("ms, plain_ms, bound_ms and library_ms: the sum over one "
                   "decode step's 61 calls at B=32 (library: F.linear on the "
                   "dequantized bf16 weight); per_call: each shape")
    row["per_call"] = k7["per_call"]
    rows.append(row)
    row = dict(name="quantize_int8_stochastic", route="cuda",
               source="lamp_tpu_torch/csrc/quantize_int8.cu",
               replaces="lamp_tpu/ops/quantization.py:123", **k8)
    row = {k: row[k] for k in keys}
    row["note"] = (f"on no path of the port: launches are phase 6's direct "
                   f"drive; times at {k8['shape']} bf16")
    rows.append(row)
    row = dict(name="fused_adamw", route="cuda",
               source="lamp_tpu_torch/csrc/fused_adamw.cu",
               replaces="lamp_tpu/ops/fused_adamw.py:30", **k4)
    row = {k: row[k] for k in keys}
    row["note"] = ("launches: phase 9's 5 timed steps, one launch a step; "
                   "times: one call over the flagship's 220 bf16 tensors "
                   "(85,565,952 parameters) with stochastic rounding; no "
                   "PyTorch call rounds stochastically (library_ms null); "
                   "replaced_ms: the port's optim.AdamW step (f32 masters) "
                   "on the same tensors")
    row["replaced_ms"] = k4["replaced_ms"]
    rows.append(row)
    for what, line in (("fwd", 46), ("bwd", 61)):
        row = dict(name=f"fused_layernorm_{what}", route="cuda",
                   source="lamp_tpu_torch/csrc/fused_layernorm.cu",
                   replaces=f"lamp_tpu/ops/fused_layernorm.py:{line}",
                   **k5[what])
        row = {k: row[k] for k in keys}
        row["note"] = (
            "on no path of the port: launches are phase 8's direct drive; "
            "times at [3072, 768] bf16 with bias (per_shape: [8192, 768]); "
            "library: F.layer_norm " + ("forward" if what == "fwd" else
                                        "autograd backward (dx, dw, db)"))
        row["per_shape"] = k5[what]["per_shape"]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
