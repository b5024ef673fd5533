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
   the same values in an fp8 (e4m3fn) pool, e5m2 once; then the fixed
   kernel (paged_attention_fixed) at its own edges (check_paged_fixed:
   K6_FIXED's q / pool pairs, layouts, groups and pages of 16 tokens over
   lengths 0, 1, 15-17, 127-129, 511 and the split's boundaries, windows
   whose band starts inside a 16-key box, append on and off; two calls bit
   for bit; a dropped box and a dropped split must read above the limit);
   both pools' kernel and plain version are timed by profiler device time,
   and phase 3's decode call (serving_decode_call: lengths 56-95, the
   calls taking 4 page tables x 12 layers in turns, cold) by CUDA events
   over a CUDA graph, on the bf16 and e4m3 pools. Then the general
   kernel (every head dim and group) at K6_WIDE's shapes, each at B=32 and
   the same lengths and windows, with and without append: head dims 80
   and 96, OpenLLaMA-3B's layer (32 / 32 heads, head_dim 100) in bf16, f16
   and on e4m3 and e5m2 pools, Gemma-2B's (8 / 1 heads, head_dim 256),
   Llama-3.1-405B's (128 / 8 heads, 16 a kv head), MQA at 32 query heads,
   an odd head dim, D=320 and 128 query heads at D=256 (the kernel's
   narrow-copy and split paths); each timed beside its bound and plain
   version. Then the general kernel's key split (check_paged_split): every
   such case over lengths at the split's edges, windows whose band starts
   inside a split, append on and off, and OpenLLaMA-3B's layer over pages
   of 16 tokens; two calls bit for bit, and a planted fault (one split's
   keys hidden) above the limit.
3. The serving slice at full width: a 12-block, 768-wide llama-style
   ModernLM (GQA 12/4 heads, SwiGLU 2048, vocab 32000, context 512, bf16,
   random weights from a seed) behind ModernBatchServer(total_pages=192)
   and ServingEngine(decode_steps=8, max_batch=32) serves 40 requests; the
   results, the page pool, the kernel's launch count and the greedy tokens
   (against a dense forward) are checked; then the steady decode rate of
   step_many(8) at B=32 is timed with CUDA events, and one more call is
   profiled (device busy share, top kernels).
4. The flash-attention kernels (forward, backward dq and dkv) against their
   plain versions (in f32) at the training slice's shapes (B=2, H=12,
   S=4096, D=64, bf16, causal) and the flagship's (B=8, S=384), and over
   kv lengths [B] (with a 0) and [B, Sq], a window, non-causal Sq != Skv,
   head_dim 128, f32 and the edges of the forward's and backward's 128-row
   and 128-key blocks (S=4160, lengths [2, 129, 4095], a window of 100,
   head_dim 128 at S=1000, per-row lengths that differ between a block's
   halves); the wgmma forward's (fwd_wg) edges: S=127 and 129, head dims
   72, 136, 192, 200 and 256 in bf16 and f16, causal with kv lengths and
   with segment ids, and a window of 100 at head_dim 192; then
   segment ids (phase 10's packed batch, a (q_ids, kv_ids) pair with Sq !=
   Skv, unsorted ids), masks (prefix-LM [B, 1, Sq, Skv], per-head
   block-sparse [B, H, Sq, Skv] with runs of more than 4 skipped tiles,
   [1, 1, Sq, Skv], a mask composed with kv lengths and ids), head dims 32,
   16 and 96 in bf16 and f32, and float16 at D=64 and 128; by relative
   error per 64-row block, and a planted fault (one skipped kv tile) that
   each check must see; two backward calls must agree bit for bit (also
   with packed ids); each kernel, its plain version and
   ``scaled_dot_product_attention`` (the library yardstick, timed only;
   with the equivalent boolean ``attn_mask`` at the packed shapes) are
   timed by their device time under torch.profiler at S=4096, S=384 and
   phase 10's packed shapes (the backward's kernels also as TFLOP/s,
   share of the 5-product bound and ratio to SDPA's backward), and the
   forward and forward + backward calls of all three by CUDA events. Then
   GPT LanguageModelModules at examples/bert.py's width (128 wide, 4
   heads: head_dim 32) and examples/translation.py's (64 wide, 4 heads:
   head_dim 16) take 3 training steps each on the kernels. Then the head
   dims the backward's instances of 32, 64 and 128 do not hold: 12, 100,
   160 and 256 in bf16 (causal with kv lengths, and with segment ids: the
   ragged forward and backward at 12 and 100, fwd_wg's D=192 and 256
   instances) and 75; the ragged forward's edges
   (check_ragged_forward: head dims 12, 75, 100, 102, 130 and 250 in bf16
   and f16 over kv lengths, [B, Sq] lengths with empty rows, Sq != Skv, a
   window, ids, a mask, rows 63-129 and phase 11's shape, o and lse per
   64-row block with a planted fault, two calls bit for bit); the ragged
   backward's edges (check_ragged_backward: dq_tc/dkv_tc and dq_wide/
   dkv_wide with the cp.async producer at head dims 12, 75, 100, 102, 130
   and 250 in bf16 and f16 over kv lengths [2, 65, 2047, 0], [B, Sq]
   lengths with empty rows, Sq != Skv, ids and a mask, then in bf16 a
   window, S = 63-129 and phase 13's shape, o, dq, dk and dv per 64-row
   block with a planted fault, two backward calls bit for bit with and
   without ids); then the edges of dq_any and dkv_any (the
   backward for f32, f64 and 16-bit above 256: 64-row blocks, 64-, 32- or
   16-row tiles, 128-column parts above 128): float64 at head dims 8, 64,
   100, 128, 136 and 200 (limit 1e-10), f32 at 64, 100 and 320 and bf16 at
   320, each causal with kv lengths [2, 65, 2047], causal with Sq != Skv,
   with segment ids and with a mask, a window once, head dims 75, 102 and
   257-300 whose rows take 8-, 4- or 2-byte copies, and two backward calls
   bit for bit in f64, f32 and bf16 at 320; each by the same checks and
   planted fault; then the edges of fwd_any (check_any_forward: o and lse
   per 64-row block, limits 1e-10 in f64, 1e-5 in f32, o 1e-2 and lse 1e-5
   in bf16, with the planted fault; rows 63, 65, 127 and 129, [B, Sq]
   lengths with empty rows inside a block, Sq = 1, Sq != Skv, a window,
   ids, a mask, head dims 8-320 in f64 and f32 and 257/320 in bf16, two
   forward calls bit for bit); the edges of dq_wide and dkv_wide (the
   16-bit backward at multiples of 8 above 128; check_wide_backward: head
   dims 136, 160, 192, 200 and 256 in bf16 and f16 with kv lengths [2, 65,
   2047, 0], [B, Sq] lengths with empty rows, Sq != Skv, ids and a mask,
   S = 63-129 and a window at 160 and 256, phase 12's shape, two backward
   calls bit for bit with and without ids); the 16-bit head dims 12, 75,
   100, 130, 160, 192, 250, 256 and 320, f64 and f32 at 64 and 100 timed
   at B=2, H=8, S=2048, and
   f32 at the f32 flagship's B=8, H=12, S=384, D=64, beside their bound,
   their plain version and SDPA at the same head dim and dtype (each
   profiler reading held against CUDA events of the same calls); GPT
   models at head_dim 100 and 256, and one in f32, take 3 training steps
   each.
5. The training slice at full width: a 12-block, 768-wide GPT
   LanguageModelModule (12 heads, MLP 3072, byte vocab 256, bf16 with f32
   AdamW masters, random weights from a seed) trains under the flagship
   configuration (ctx 384, batch 8 x 5 accumulation, the example's AdamW)
   and the long-context one (ctx 4096, batch 2): 2 warm-up steps, 5 timed
   steps (CUDA events; the kernels' launch counts are checked against 12
   layers x micro-batches x steps), 10 steps on one batch of SURVEY.md's
   bytes (the loss must fall), and one profiled step (device busy share,
   top kernels, the attention kernels' shares, no library attention
   kernel). Then the flagship in float32 (examples/autoregressivelm.py
   --no-bf16: f32 parameters, no masters), whose attention runs fwd_any,
   dq_any and dkv_any: its first loss against the same model and batch
   through plain attention, and the same steps, checks and profile.
6. The int4 dequant-matmul kernel (K7) against its plain version at every
   decode matmul of the serving configuration (QKV 768x1280, out 768x768,
   SwiGLU 768x2048 and 2048x768, logits 768x32000) with M in {1, 7, 32, 64,
   65, 128, 160, 257, 3072}, bf16 x (f32 x up to 64), bf16 and f32 out, by
   relative Frobenius error, with a planted fault (one K-group's scale row
   dropped) that each check must see, and two calls equal bit for bit (the
   decode kernel int4_mm_decode at M <= 64, the row-tiled int4_mm_tc
   above); the same at K7_EDGES (a ragged N of 1000 over an uneven
   cluster, K=8192 in rounds, groups of 32). Timed at B=32 by CUDA events
   over a CUDA graph of 100 calls (warm, and cold: copies of the weight
   beyond L2), the profiler's sum held against it, beside its bound and
   F.linear on the dequantized bf16 weight timed alike; a call must launch
   int4_mm_decode alone and allocate nothing beside its output. The same
   for int4_mm_tc at M=128 (phase 14's chunk) at every shape and at
   M=3072 for qkv and the logits, and for int4_mm_scalar (f32 x, beside
   F.linear in f32) at B=32. int8_matmul (torch._int_mm,
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
   bf16 (tok/s, device time and device ops per step, K7's share).
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
10. Packed-document training at full width: phase 3's ModernLM at context
   2048, bf16 with f32 AdamW masters, 4 rows a step of documents of
   64-1024 random tokens packed by ``data.pack_documents``, through
   ``ModernLM.loss`` (segment ids into K1/K2, per-document RoPE, the fused
   cross-entropy): the first loss against plain attention, 2 warm-up and
   5 timed steps (CUDA events, train tok/s, K1/K2 launches 12 a step),
   finite losses, the loss falling over 10 steps on one batch, a profiled
   step (no library attention kernel) and peak memory beside the scores
   ``mha_reference`` would keep.
11. OpenLLaMA-3B serving at full width: hidden 3200, 32 heads (head_dim
   100, no GQA), 26 layers, SwiGLU 8640, vocab 32000, untied head, bf16,
   random weights from a seed, behind ModernBatchServer(total_pages=192)
   and ServingEngine with phase 3's 40 requests: exact lengths, the page
   pool back at its start, K6 (the general kernel) launched 26 times a
   decode step, greedy tokens against the dense ModernLM forward on the
   card (K1's ragged instance at head_dim 100, its launches counted); the
   steady decode rate and a profiled step (device time, ops and K6's
   share), then the steady decode on an e4m3 KV pool (K6-fp8 at 100-byte
   head slices, its launches counted).
12. Training at Gemma-2B's widths: a ModernLM of 18 blocks, 2048 wide, 8
   query heads over 1 kv head (head_dim 256), SwiGLU 16384, vocab 256000,
   tied (2.51 B parameters, random weights from a seed; the JAX package's
   ModernLM, not Gemma: SwiGLU, plain RMSNorm, no embedding scale), bf16
   with f32 AdamW masters, 2 rows of 2048 seeded tokens a step, plain
   causal, through ModernLM.loss: the first loss against plain attention,
   2 warm-up and 5 timed steps (fwd_wg's D=256 instance, dq_wide and
   dkv_wide 18 launches each a step), the loss falling over 10 steps on
   one batch, a profiled step (busy share, attention shares, no library
   attention kernel) and the peak memory.
13. Training OpenLLaMA-3B: phase 11's model (26 x 3200, 32 heads of
   head_dim 100, SwiGLU 8640, vocab 32000, untied; 3.43 B parameters,
   random weights from a seed), bf16 with f32 AdamW masters (3e-4, weight
   decay 0.01), 2 rows of 2048 seeded tokens a step, plain causal,
   through ModernLM.loss: the first loss against plain attention, 2
   warm-up and 5 timed steps (the ragged forward and backward instances at
   D=128, 26 launches each a step), the loss falling over 10 steps on one
   batch, a profiled step (busy share, attention shares, no library
   attention kernel) and the peak memory.
14. Speculative decoding at full width: phase 3's model as the target and
   its first 3 blocks (draft_view, the same tensors) as the draft, both
   behind ModernBatchServer(quantize_bits=4) in SpeculativeDecoder(k=4);
   phase 3's first 32 prompts, greedy, every round over all 32 until each
   has emitted 64 tokens: 1 to 4 tokens a round, int4_mm_tc launched 61
   times a round (the target's chunk of 128 rows), the draft's
   int4_mm_decode and K6 launches, the greedy tokens against the dense f32
   forward of the dequantized target past phase 7's margin, the pools back
   at their start; tokens a round, tok/s and a profiled round (device
   time, ops, int4_mm_tc's share). Before it, in bf16, one advance_chunk's
   logits against the same 4 tokens fed one step at a time (relative
   error); after it, a sampled run at temperature 1.0.

After phase 6, check_layouts holds flash_attention (forward and backward),
paged_attention and int4_matmul given transposed views and offset slices
against their contiguous copies, bit for bit.

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
# see. On an H100: bf16 kernels read at most 5.4e-3 and the fault at least
# 0.30; f32 kernels 5.4e-7 and the fault 0.47. f16: the kernels round o, p
# and ds to f16, a relative 2^-11 per term, 8 times finer than bf16's, so
# its limit is bf16's over 5 (the sums keep some headroom).
# float64: the kernels compute in double, as the plain version does; they
# differ in summation order only (~1e-15 relative), far below the limit.
FLASH_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5,
             torch.float64: 1e-10}
FLASH_BLOCK = 64

# the serving slice's configuration (the JAX package's serving workload)
VOCAB, CTX, BLOCKS, DIM, HEADS, KV_HEADS = 32000, 512, 12, 768, 12, 4
PAGE, TOTAL_PAGES = 128, 192

# the training slice: the JAX package's GPT LM (bench.py:109-130 flagship,
# bench.py:223-240 long context), full width
LM_VOCAB, LM_BLOCKS, LM_DIM, LM_HEADS = 256, 12, 768, 12
TRAIN_CONFIGS = (("flagship", 384, 8, 5, torch.bfloat16),
                 ("longctx", 4096, 2, 1, torch.bfloat16),
                 ("flagship f32", 384, 8, 5, torch.float32))
# the kernels a training step's attention runs, by parameter dtype
TRAIN_KERNELS = {torch.bfloat16: ("fwd_wg", "dq_tc", "dkv_tc"),
                 torch.float32: ("fwd_any", "dq_any", "dkv_any")}

# phase 10: packed-document training of the serving configuration's
# ModernLM (bench.py:322-326) at context 2048, 4 rows a step, documents of
# 64-1024 tokens
PACK_CTX, PACK_BATCH, PACK_DOC_LENS = 2048, 4, (64, 1024)

# phase 11: OpenLLaMA-3B (openlm-research/open_llama_3b and _v2, a
# LlamaForCausalLM): hidden 3200, 32 heads and 32 kv heads (head_dim 100),
# 26 layers, SwiGLU 8640, vocab 32000, 2048 positions, RMSNorm eps 1e-6,
# untied head, RoPE base 10000; bf16, random weights from seed 0; nothing
# cut. Served with phase 3's pages, pool and requests.
OL_CTX, OL_BLOCKS, OL_DIM, OL_HEADS, OL_MLP = 2048, 26, 3200, 32, 8640
OL_HEAD_DIM = OL_DIM // OL_HEADS

# phase 13: the same model (3.43 B parameters, nothing cut) trained in bf16
# with f32 AdamW masters (3e-4, weight decay 0.01) at context 2048, 2 rows
# of seeded tokens a step, plain causal, through ModernLM.loss: the 16-bit
# attention at head_dim 100, whose backward is the ragged one
# (dq_tc/dkv_tc<128, bf16, false, true>)
OPENLLAMA_TRAIN_ROWS = 2
# the attention kernels of its step, as the profiler names their instances
OPENLLAMA_KERNELS = ("fwd_wg<128, __nv_bfloat16, false, true>",
                     "dq_tc<128, __nv_bfloat16, false, true>",
                     "dkv_tc<128, __nv_bfloat16, false, true>")

# phase 12: a ModernLM at Gemma-2B's widths (google/gemma-2b config.json:
# hidden_size 2048, 8 attention heads over 1 kv head of head_dim 256, 18
# layers, intermediate_size 16384, vocab_size 256000, tied embeddings,
# rms_norm_eps 1e-6, rope_theta 10000), trained in bf16 with f32 AdamW
# masters at context 2048, 2 rows of seeded tokens a step, plain causal
# (no segment ids: the unmasked kernel instances). It is the JAX package's
# ModernLM at those widths, not Gemma: SwiGLU where Gemma has GeGLU, plain
# RMSNorm where Gemma scales by (1 + w), no sqrt(d) embedding scale.
# Nothing is cut: 2.51 B parameters, random weights from seed 0.
GEMMA = dict(vocab_size=256000, num_blocks=18, embed_dim=2048, num_heads=8,
             num_kv_heads=1, mlp_hidden=16384, tied=True, norm_eps=1e-6,
             rope_base=10000.0)
GEMMA_CTX, GEMMA_ROWS = 2048, 2
# the attention kernels of its step: fwd_wg's D=256 instance, then dq_wide
# and dkv_wide
GEMMA_KERNELS = ("fwd_wg", "dq_wide", "dkv_wide")

# one H100 SXM's published dense bf16 rate and memory bandwidth
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# its peak rate for the operations of the scalar kernels: f32 outside the
# tensor cores (the data sheet's non-tensor FP32 rate), and f64 (its FP64
# tensor-core rate, the card's highest for the type)
PEAK_FLOPS_F32 = PEAK_FLOPS_F64 = 67e12

# phase 2: K6 beyond the serving slice's head dim 64 and 8 query heads per
# kv head (the general kernel, paged_attention_any): (name, heads, kv
# heads, head_dim, q dtype, pool dtype), each at phase 2's B=32, lengths
# and windows over a pool of TOTAL_PAGES pages. OpenLLaMA-3B's layer (32 /
# 32 heads, head_dim 100; phase 11) in bf16, f16, f64 and on both fp8
# pools, head dims 80 and 96 at the serving slice's GQA, the OpenLLaMA
# layer at head_dim 128 (the fixed-head_dim kernel, for comparison per
# byte), Gemma-2B's (8 query heads over 1 kv head, head_dim 256), Llama-3.1-405B's
# attention layer (128 / 8 heads: 16 a kv head, head_dim 128) and MQA with
# 32 query heads.
K6_WIDE = (
    ("d80", 12, 4, 80, torch.bfloat16, torch.bfloat16),
    ("d96", 12, 4, 96, torch.bfloat16, torch.bfloat16),
    ("openllama d100", 32, 32, 100, torch.bfloat16, torch.bfloat16),
    # the same layer at head_dim 128, which the fixed-head_dim kernel
    # (head_dim 64 or 128) takes: K6 per byte at D=100 (the general
    # kernel) against D=128
    ("d128 32/32", 32, 32, 128, torch.bfloat16, torch.bfloat16),
    ("openllama d100 f16", 32, 32, 100, torch.float16, torch.float16),
    ("openllama d100 e4m3", 32, 32, 100, torch.bfloat16,
     torch.float8_e4m3fn),
    ("openllama d100 e5m2", 32, 32, 100, torch.float16, torch.float8_e5m2),
    ("gemma d256", 8, 1, 256, torch.bfloat16, torch.bfloat16),
    ("405B 128/8", 128, 8, 128, torch.bfloat16, torch.bfloat16),
    ("MQA 32/1", 32, 1, 128, torch.bfloat16, torch.bfloat16),
    ("openllama d100 f64", 32, 32, 100, torch.float64, torch.float64),
    # the general kernel's other paths: rows staged 2 or 1 bytes at a time
    # (an odd head dim), output columns split over blocks (D > 256) and a
    # group split over blocks (128 query heads of 256 past 227 KB)
    ("d75 odd", 4, 2, 75, torch.bfloat16, torch.bfloat16),
    ("d75 odd e4m3", 4, 2, 75, torch.bfloat16, torch.float8_e4m3fn),
    ("d320 2/1", 2, 1, 320, torch.bfloat16, torch.bfloat16),
    ("128/1 d256", 128, 1, 256, torch.bfloat16, torch.bfloat16),
)
# float64 computes in double in the kernel and in its plain version: they
# differ in summation order only
K6_TOL_F64 = 1e-10
# f32 q: the fixed kernel computes in f32 (FFMA, no TF32) as the plain
# version does; they differ in summation order and exp2 only
K6_TOL_F32 = 1e-4

# phase 2: K6's fixed kernel (paged_attention_fixed: head_dim 64 or 128, at
# most 8 query heads a kv head) at its own edges (check_paged_fixed): (name,
# heads, kv heads, head_dim, q dtype, pool dtype, layout, page size), each
# at phase 2's B=32 and CTX / PAGE pages a sequence (CTX / 16 of 16
# tokens) over lengths 0, 1, 15-17, 127-129, 511 and the split's
# boundaries +- 1; every q / pool pair the kernel takes, fused and split
# pools, groups of 1, 3, 4 and 8, one block and a cluster of two
K6_FIXED = (
    ("serving d64", 12, 4, 64, torch.bfloat16, torch.bfloat16, "fused", PAGE),
    ("serving d64 e4m3", 12, 4, 64, torch.bfloat16, torch.float8_e4m3fn,
     "fused", PAGE),
    ("serving d64 e5m2", 12, 4, 64, torch.bfloat16, torch.float8_e5m2,
     "split", PAGE),
    ("serving d64 pages of 16", 12, 4, 64, torch.bfloat16, torch.bfloat16,
     "fused", 16),
    ("d64 f16", 12, 4, 64, torch.float16, torch.float16, "split", PAGE),
    ("d64 f16 e4m3", 8, 2, 64, torch.float16, torch.float8_e4m3fn, "fused",
     PAGE),
    ("d64 f32", 12, 4, 64, torch.float32, torch.float32, "fused", PAGE),
    ("d64 f32 e4m3", 8, 2, 64, torch.float32, torch.float8_e4m3fn, "split",
     PAGE),
    ("d64 mha", 4, 4, 64, torch.bfloat16, torch.bfloat16, "split", PAGE),
    # one kv head: the plan's 4 splits are a cluster of 2 blocks
    ("d64 3/1 e4m3", 3, 1, 64, torch.bfloat16, torch.float8_e4m3fn, "fused",
     PAGE),
    ("d128 group 8", 16, 2, 128, torch.bfloat16, torch.bfloat16, "fused",
     PAGE),
    ("d128 group 8 e4m3", 16, 2, 128, torch.bfloat16, torch.float8_e4m3fn,
     "split", PAGE),
    ("d128 f16 e5m2", 8, 1, 128, torch.float16, torch.float8_e5m2, "fused",
     PAGE),
    ("d128 f32", 8, 2, 128, torch.float32, torch.float32, "split", PAGE),
    ("d128 f32 e5m2", 4, 4, 128, torch.float32, torch.float8_e5m2, "fused",
     PAGE),
)


def openllama_decode_call(gen, rng, batch: int = 32):
    """Phase 11's decode call of K6's general kernel, as a step makes it:
    OpenLLaMA-3B's layer (32 / 32 heads of 100, bf16) over a layer-stacked
    pool of OL_BLOCKS x TOTAL_PAGES pages of PAGE tokens, OL_CTX / PAGE
    pages a sequence, lengths of 56-95 tokens (phase 11's), append_kv.
    Returns (q, pool, kv heads, (new_k, new_v), table, lengths, offsets):
    ``offsets`` holds each layer's page_offset, so that calls taking them
    in turn read each layer's rows from device memory, as a step's do
    (one layer's ~31 MB would stay in the 50 MB L2 across calls)."""
    dev = torch.device("cuda")
    pool = torch.randn((OL_BLOCKS * TOTAL_PAGES, 2, PAGE, OL_DIM),
                       generator=gen, device=dev, dtype=torch.bfloat16)
    pps = OL_CTX // PAGE
    table = torch.as_tensor(np.stack([
        rng.choice(np.arange(1, TOTAL_PAGES), pps, replace=False)
        for _ in range(batch)]).astype(np.int32), device=dev)
    lengths = torch.as_tensor(rng.randint(56, 96, batch).astype(np.int32),
                              device=dev)
    q = torch.randn((batch, OL_HEADS, OL_DIM // OL_HEADS), generator=gen,
                    device=dev, dtype=torch.bfloat16)
    new = tuple(torch.randn((batch, OL_DIM), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
    offsets = [layer * TOTAL_PAGES for layer in range(OL_BLOCKS)]
    return q, pool, OL_HEADS, new, table, lengths, offsets

def serving_decode_call(gen, rng, pool_dtype=torch.bfloat16, batch: int = 32,
                        tables: int = 4):
    """Phase 3's decode call of K6's fixed kernel, as a steady step makes
    it: the serving slice's layer (12 / 4 heads of 64, bf16 q) over its
    layer-stacked pool of BLOCKS x TOTAL_PAGES pages of PAGE tokens (bf16,
    or ``pool_dtype``: the same values in fp8), CTX / PAGE pages a
    sequence, lengths of 56-95 tokens (phase 3's steady decode: prompts of
    24-31 tokens, the timed and profiled steps 16-64 tokens on), append_kv,
    no window. Each of ``tables`` page tables gives every sequence its own
    live page (the tables' live pages disjoint) and the trash page 0 for
    the pages the server has not handed out, as ModernBatchServer's tables
    do. Returns (q, pool, kv heads, (new_k, new_v), tables, lengths,
    offsets): call i takes decode_turn(i, tables, offsets), so that calls
    in turn read tables x BLOCKS layers' rows (~118 MB, past the 50 MB
    L2) from device memory, as a step's calls find them (one layer's rows
    would stay in L2 across calls)."""
    dev = torch.device("cuda")
    d = DIM // HEADS
    pool = torch.randn((BLOCKS * TOTAL_PAGES, 2, PAGE, KV_HEADS * d),
                       generator=gen, device=dev,
                       dtype=torch.bfloat16).to(pool_dtype)
    live = rng.choice(np.arange(1, TOTAL_PAGES), tables * batch,
                      replace=False).reshape(tables, batch)
    out = []
    for t in range(tables):
        table = np.zeros((batch, CTX // PAGE), np.int32)
        table[:, 0] = live[t]
        out.append(torch.as_tensor(table, device=dev))
    lengths = torch.as_tensor(rng.randint(56, 96, batch).astype(np.int32),
                              device=dev)
    q = torch.randn((batch, HEADS, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    new = tuple(torch.randn((batch, KV_HEADS * d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
    offsets = [layer * TOTAL_PAGES for layer in range(BLOCKS)]
    return q, pool, KV_HEADS, new, out, lengths, offsets


def decode_turn(i, tables, offsets):
    """The (page table, page_offset) of call i of a decode-call timing:
    ``tables`` one table or a list of them, each in turn, then the next
    layer's offset."""
    if torch.is_tensor(tables):
        return tables, offsets[i % len(offsets)]
    return tables[i % len(tables)], offsets[(i // len(tables)) % len(offsets)]


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
K7_ROWS = (1, 7, 32, 64, 65, 128, 160, 257, 3072)
DECODE_B = 32
# the row-tiled kernel's rows on phase 14's path (32 sequences x k = 4) and
# of an LM forward
SPEC_ROWS = 128
LM_ROWS = 3072
# the decode kernel's edges, checked untimed at every decode row: (name, K,
# N, group) of a ragged N (1000: not a multiple of any tile, not of 16, so
# the weight and scales go by plain loads) over an uneven cluster (24 steps
# over 5 ranks), a K whose slices take rounds through two stages (8192),
# and groups of 32 (four groups in a 64-row slice)
K7_EDGES = (("n1000", 768, 1000, 128), ("k8192", 8192, 1024, 128),
            ("g32", 768, 1280, 32))
# two calls of the decode kernel (M <= 64) or the row-tiled kernel equal bit
# for bit at these rows
K7_BITS_ROWS = (1, 32, 64, 65, 128, 160, 257, 3072)
# a cold call cycles through copies of its weight that together exceed
# the 50 MB L2 cache, as a decode step finds its weights
COLD_BYTES = 64 << 20
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
            ("int4_mm_tc", int4_matmul, "tc_launches"),
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


GRAPH_CALLS = 100


def graph_ms(fn, calls: int = GRAPH_CALLS, reps: int = 5) -> float:
    """Device time a call of ``fn(i)`` (i = 0 .. calls - 1), by CUDA events
    over the replay of a CUDA graph of ``calls`` back-to-back calls,
    captured after a warm-up on a side stream: the median of ``reps``
    replays. Calls of a few us are timed without the host's launches,
    which events over eager calls time instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return sorted(times)[reps // 2]


def host_us(fn, calls: int = 200, burst: int = 10,
            queued: bool = False) -> float:
    """The host's time a call of ``fn(i)`` (i = 0 .. calls - 1), by its
    clock: bursts of ``burst`` eager calls, each after the card has drained
    the last, so that no call waits on a full launch queue (a decode step's
    calls find the card idle: the step is host-bound). ``queued``: the
    calls in one burst behind a kernel that sleeps ~0.1 s, all of them in
    the launch queue at once."""
    total = 0.0
    for i0 in range(0, calls, calls if queued else burst):
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for i in range(i0, min(calls, i0 + (calls if queued else burst))):
            fn(i)
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / calls * 1e6


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

    fixed = check_paged_fixed(paged_attention, paged_attention_reference,
                              gen)
    wide = check_paged_wide(paged_attention, paged_attention_reference,
                            table, lengths, wins, gen)
    split = check_paged_split(paged_attention, paged_attention_reference,
                              table, gen)

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
        ms = _kernel_ms(device_ms(kernel, 50), "paged_attention_fixed")
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
    del pool, pool8
    torch.cuda.empty_cache()
    # phase 3's decode call, cold: calls in turn over 4 tables x 12 layers
    for what, pdt in (("bf16", torch.bfloat16),
                      ("fp8", torch.float8_e4m3fn)):
        rng = np.random.RandomState(7)
        dq, dpool, dhkv, dnew, tables, dlens, offsets = serving_decode_call(
            gen, rng, pdt)

        def call(i=0):
            tab, off = decode_turn(i, tables, offsets)
            return paged_attention(dq, dpool, None, tab, dlens,
                                   num_kv_heads=dhkv, append_kv=dnew,
                                   page_offset=off)

        ref = paged_attention_reference(
            dq.float(), dpool if dpool.element_size() == 1 else dpool.float(),
            None, tables[0], dlens, num_kv_heads=dhkv,
            append_kv=tuple(x.float() for x in dnew))
        e = (call().float() - ref).abs()
        if (e > ATOL + RTOL * ref.abs()).any():
            raise AssertionError(f"serving decode call ({what}): max err "
                                 f"{float(e.max()):.3e}")
        call_ms = graph_ms(call)
        live = int(dlens.sum())
        nbytes = live * 2 * dhkv * d * dpool.element_size() + \
            (2 * dq.numel() + 2 * dnew[0].numel()) * 2 + \
            (tables[0].numel() + b) * 4
        call_bound = max(nbytes / PEAK_BYTES,
                         4 * (live + b) * HEADS * d / PEAK_FLOPS) * 1e3
        print(f"  serving decode call ({what} pool, lengths 56-95, 4 tables "
              f"x 12 layers in turns, cold): {call_ms * 1e3:.2f} us a call "
              f"(CUDA events over a graph), bound {call_bound * 1e3:.2f} us",
              flush=True)
        rows[what]["decode_call_ms"] = call_ms
        rows[what]["decode_call_bound_ms"] = call_bound
        del dpool
    rows["bf16"]["fixed_edges"] = {k: dict(splits=v[0], max_abs_err=v[1],
                                           planted_fault=v[2])
                                   for k, v in fixed.items()}
    rows["any"] = wide["openllama d100"]
    rows["any_fp8"] = wide["openllama d100 e4m3"]
    rows["any"]["per_case"] = {k: {x: r[x] for x in (
        "ms", "plain_ms", "bound_ms", "max_abs_err")} for k, r in wide.items()}
    for k, (splits, err, fault) in split.items():
        rows["any"]["per_case"].setdefault(k, {}).update(
            splits=splits, split_edges_max_abs_err=err,
            split_edges_planted_fault=fault)
    return rows


def check_paged_wide(paged_attention, paged_attention_reference, table,
                     lengths, wins, gen):
    """The kernel at K6_WIDE's head dims, groups and dtypes against its
    plain version (in f32) at phase 2's B=32, lengths and windows, with and
    without append_kv; each timed on the decode's own call (append_kv, no
    window) beside its bound and plain version. Returns {name: figures}."""
    dev = torch.device("cuda")
    b = lengths.shape[0]
    out = {}
    for name, h, hkv, d, qdt, pdt in K6_WIDE:
        def randn(*shape, dtype):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        pool = randn(TOTAL_PAGES, 2, PAGE, hkv * d, dtype=pdt)
        q = randn(b, h, d, dtype=qdt)
        new = (randn(b, hkv * d, dtype=qdt), randn(b, hkv * d, dtype=qdt))
        fp8 = pool.element_size() == 1
        acc = torch.promote_types(qdt, torch.float32)
        err = 0.0
        for app, window, windows in ((None, None, None), (new, 100, wins)):
            out_k = paged_attention(q, pool, None, table, lengths,
                                    num_kv_heads=hkv, window=window,
                                    windows=windows, append_kv=app)
            ref = paged_attention_reference(
                q.to(acc), pool if fp8 else pool.to(acc), None, table,
                lengths, num_kv_heads=hkv, window=window, windows=windows,
                append_kv=None if app is None else tuple(
                    x.to(acc) for x in app))
            torch.cuda.synchronize()
            e = (out_k.to(acc) - ref).abs()
            bad = e > (K6_TOL_F64 if qdt == torch.float64 else
                       ATOL + RTOL * ref.abs())
            if bad.any():
                raise AssertionError(
                    f"paged_attention {name} append={app is not None}: "
                    f"{int(bad.sum())} elements off, max err "
                    f"{float(e.max()):.3e}")
            if app is None and (out_k[lengths == 0] != 0).any():
                raise AssertionError(f"{name}: rows with no key are not 0")
            err = max(err, float(e.max()))

        def kernel():
            paged_attention(q, pool, None, table, lengths, num_kv_heads=hkv,
                            append_kv=new)

        def plain():
            paged_attention_reference(q, pool, None, table, lengths,
                                      num_kv_heads=hkv, append_kv=new)

        ms = _kernel_ms(device_ms(kernel, 20), "paged_attention")
        plain_ms = sum(device_ms(plain, 3).values())
        live = int(lengths.sum()) + b
        kv_bytes = live * 2 * hkv * d * pool.element_size()
        nbytes = kv_bytes + 2 * q.numel() * q.element_size() + \
            (table.numel() + b) * 4
        peak = PEAK_FLOPS_F64 if qdt == torch.float64 else PEAK_FLOPS
        bound_ms = max(nbytes / PEAK_BYTES, 4 * live * h * d / peak) * 1e3
        print(f"  {name:20} H={h}/{hkv} D={d} q {str(qdt)[6:]} pool "
              f"{str(pdt)[6:]}: max_abs_err {err:.3e}; kernel "
              f"{ms * 1e3:.2f} us (device), plain {plain_ms * 1e3:.2f} us, "
              f"bound {bound_ms * 1e3:.2f} us ({live} live tokens, "
              f"{kv_bytes / (ms * 1e-3) / 1e9:.0f} GB/s of K/V rows)",
              flush=True)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes",
                         library_ms=None)
        del pool
    return out


def paged_plain_without(q, pool, table, lengths, hkv, drop, window=None,
                        windows=None, append_kv=None):
    """The plain version (f32; f64 for float64) with the pool keys [drop[0],
    drop[1]) of every sequence hidden: a kernel that lost one split's
    partial. Follows paged_attention_reference (fused pool, append as key
    position lengths[b])."""
    from lamp_tpu_torch.ops.paged_attention import (NEG_INF,
                                                    _effective_window)

    acc = torch.promote_types(q.dtype, torch.float32)
    b, h, d = q.shape
    page, pps = pool.shape[2], table.shape[1]
    kp, vp = pool[:, 0].to(acc), pool[:, 1].to(acc)  # fp8: exact
    idx = table.long()
    k = kp[idx].reshape(b, pps * page, hkv, d)
    v = vp[idx].reshape(b, pps * page, hkv, d)
    eff = lengths.long()
    pos = torch.arange(pps * page, device=q.device)
    hidden = (pos >= drop[0]) & (pos < drop[1])
    if append_kv is not None:
        rows = torch.arange(b, device=q.device)
        at = torch.clamp(eff, max=pps * page - 1)
        k[rows, at] = append_kv[0].to(acc).reshape(b, hkv, d)
        v[rows, at] = append_kv[1].to(acc).reshape(b, hkv, d)
        eff = eff + 1
        hidden = hidden[None] & (pos[None] != at[:, None])
    else:
        hidden = hidden[None].expand(b, -1)
    k = k.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    v = v.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.to(acc), k) / math.sqrt(d)
    keep = (pos[None, None] < eff[:, None, None]) & ~hidden[:, None]
    w_eff = _effective_window(window, windows, b, q.device)
    if w_eff is not None:
        keep = keep & (pos[None, None] >= eff[:, None, None]
                       - w_eff.long()[:, None, None])
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1) * keep.any(-1, keepdim=True)
    return torch.einsum("bhk,bhkd->bhd", p, v)


def check_paged_fixed(paged_attention, paged_attention_reference, gen):
    """paged_attention_fixed (head_dim 64 or 128, at most 8 query heads a kv
    head) at every K6_FIXED case against its plain version (f32): lengths
    0, 1, 15-17 (a box's edge), 127-129 (a page's), 511 (the table's end),
    and each boundary of the plan's split +- 1; append on and off; no
    window, per-request windows (their bands mostly start inside a 16-row
    box) and those with a static window of 37. Each call at phase 2's
    limits (K6_TOL_F32 relative to max(1, |plain|) for f32 q), rows with no
    key exactly 0, twice bit for bit, and two planted faults above the
    limit: the plain version with one box's keys (16-31) hidden, and with
    the second rank's pages hidden (the first page without a split).
    Returns {case: (splits, largest abs error, smallest fault)}."""
    from lamp_tpu_torch.ops.paged_attention import _paged_plan, _split_pages

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b = 32
    out = {}
    for name, h, hkv, d, qdt, pdt, layout, page in K6_FIXED:
        pps = CTX // page
        total = TOTAL_PAGES * PAGE // page
        rng = np.random.RandomState(11)
        table = torch.as_tensor(np.stack([
            rng.choice(np.arange(1, total), pps, replace=False)
            for _ in range(b)]).astype(np.int32), device=dev)
        splits, _ = _paged_plan(b, hkv, h // hkv, d, pps, sms)
        ranges = _split_pages(pps, splits)
        edges = [0, 1, 15, 16, 17, 127, 128, 129, pps * page - 1]
        for lo, _ in ranges[1:]:
            edges += [lo * page - 1, lo * page, lo * page + 1]
        lens = np.asarray(edges + list(rng.randint(
            0, pps * page, b - len(edges))), np.int32)
        lengths = torch.as_tensor(lens, device=dev)
        wins = torch.as_tensor(np.asarray(
            [0, 23, 0, 100, 7, 300, 0, 41] * (b // 8), np.int32), device=dev)
        pool = torch.randn((total, 2, page, hkv * d), generator=gen,
                           device=dev).to(pdt)
        k_pool, v_pool = (pool, None) if layout == "fused" else (
            pool[:, 0].contiguous(), pool[:, 1].contiguous())
        q = torch.randn((b, h, d), generator=gen, device=dev).to(qdt)
        new = tuple(torch.randn((b, hkv * d), generator=gen,
                                device=dev).to(qdt) for _ in range(2))
        acc = torch.promote_types(qdt, torch.float32)
        drops = [(16, 32), (ranges[1][0] * page, ranges[1][1] * page)
                 if splits > 1 else (0, page)]
        err, fault_min = 0.0, math.inf
        for app in (None, new):
            for window, windows in ((None, None), (None, wins), (37, wins)):
                kw = dict(num_kv_heads=hkv, window=window, windows=windows,
                          append_kv=app)
                got = paged_attention(q, k_pool, v_pool, table, lengths, **kw)
                again = paged_attention(q, k_pool, v_pool, table, lengths,
                                        **kw)
                app32 = None if app is None else tuple(x.to(acc)
                                                       for x in app)
                ref = paged_attention_reference(
                    q.to(acc), pool if pool.element_size() == 1 else
                    pool.to(acc), None, table, lengths, num_kv_heads=hkv,
                    window=window, windows=windows, append_kv=app32)
                faults = [paged_plain_without(
                    q, pool, table, lengths, hkv, drop, window=window,
                    windows=windows, append_kv=app) for drop in drops]
                torch.cuda.synchronize()
                what = (f"paged_attention {name} splits={splits} "
                        f"append={app is not None} window={window} "
                        f"windows={windows is not None}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: two calls differ")
                limit = (K6_TOL_F32 * torch.clamp(ref.abs(), min=1.0)
                         if qdt == torch.float32 else ATOL + RTOL * ref.abs())
                e = (got.to(acc) - ref).abs()
                if (e > limit).any():
                    raise AssertionError(
                        f"{what}: {int((e > limit).sum())} elements off, "
                        f"max err {float(e.max()):.3e}")
                if app is None and (got[lengths == 0] != 0).any():
                    raise AssertionError(f"{what}: rows with no key are not 0")
                for drop, bad in zip(drops, faults):
                    fe = (bad - ref).abs()
                    if not (fe > limit).any():
                        raise AssertionError(
                            f"{what}: the planted fault (keys {drop} "
                            f"hidden) reads within the limit")
                    fault_min = min(fault_min, float(fe.max()))
                err = max(err, float(e.max()))
        print(f"  fixed edges {name:24} H={h}/{hkv} D={d} q "
              f"{str(qdt)[6:]} pool {str(pdt)[6:]} {layout} page {page} "
              f"splits={splits}: max_abs_err {err:.3e}, planted faults "
              f"{fault_min:.3e}; two calls equal", flush=True)
        out[name] = (splits, err, fault_min)
        del pool, k_pool, v_pool
    return out


def check_paged_split(paged_attention, paged_attention_reference, table,
                      gen):
    """Both kernels over their key split's edges, at every K6_WIDE case
    (the fixed kernel's d128 32/32 too), the serving slice's layer (12 / 4
    heads of 64) and d128 32/32 on bf16 and e4m3 pools (the fixed kernel,
    whose cluster of the plan's splits interleaves 16-key boxes, so the
    page boundaries are lengths at its boxes' edges; phase 2's B=32, 4
    pages of 128 tokens a sequence; and
    OpenLLaMA-3B's layer over 32 pages of 16 tokens): lengths
    0 and 1, each split boundary (the plan's ranks of `per` pages) - 1, at
    and + 1, and the table's end; per-request windows whose band starts
    inside a split, beside none; append on and off. Each call against the
    plain version (f32; float64 at K6_TOL_F64) at phase 2's limits, twice
    bit for bit, and the plain version with one split's keys hidden (the
    second rank's pages, or the first page without a split) must read above
    the limit. Returns {case: (splits, largest abs error, smallest
    fault)}."""
    from lamp_tpu_torch.ops.paged_attention import _paged_plan, _split_pages

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    # and OpenLLaMA-3B's layer over pages of 16 tokens, 32 a sequence: a
    # tile of several pages
    rng = np.random.RandomState(6)
    table16 = torch.as_tensor(np.stack([
        rng.choice(np.arange(1, 32 * 33), 32, replace=False)
        for _ in range(table.shape[0])]).astype(np.int32), device=dev)
    fixed = (("serving d64", 12, 4, 64, torch.bfloat16, torch.bfloat16),
             ("serving d64 e4m3", 12, 4, 64, torch.bfloat16,
              torch.float8_e4m3fn),
             ("d128 32/32 e4m3", 32, 32, 128, torch.bfloat16,
              torch.float8_e4m3fn))
    cases = [(c, table, PAGE, TOTAL_PAGES) for c in K6_WIDE + fixed] + [(
        ("openllama d100 page 16", 32, 32, 100, torch.bfloat16,
         torch.bfloat16), table16, 16, 32 * 33)]
    for (name, h, hkv, d, qdt, pdt), table, page, total in cases:
        b, pps = table.shape
        splits, stages = _paged_plan(b, hkv, h // hkv, d, pps, sms)
        ranges = _split_pages(pps, splits)
        edges = [0, 1, pps * page - 1]
        for lo, _ in ranges[1:]:
            edges += [lo * page - 1, lo * page, lo * page + 1]
        rng = np.random.RandomState(5)
        lens = np.asarray(edges + list(rng.randint(
            0, pps * page, b - len(edges))), np.int32)
        lengths = torch.as_tensor(lens, device=dev)
        # a band [len - w, len) that starts inside the split before the one
        # holding the row's last key, or none
        first = ranges[1][0] * page if splits > 1 else page
        wins = np.where(np.arange(b) % 2 == 0, 0,
                        np.maximum(1, lens - first + 17)).astype(np.int32)
        windows = torch.as_tensor(wins, device=dev)
        pool = torch.randn((total, 2, page, hkv * d), generator=gen,
                           device=dev).to(pdt)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(qdt)
        new = tuple(torch.randn((b, hkv * d), generator=gen,
                                device=dev).to(qdt) for _ in range(2))
        acc = torch.promote_types(qdt, torch.float32)
        drop = (ranges[1][0] * page, ranges[1][1] * page) if splits > 1 \
            else (0, page)
        err, fault_min = 0.0, math.inf
        for app in (None, new):
            for win in (None, windows):
                kw = dict(num_kv_heads=hkv, windows=win, append_kv=app)
                got = paged_attention(q, pool, None, table, lengths, **kw)
                again = paged_attention(q, pool, None, table, lengths, **kw)
                app32 = None if app is None else tuple(x.to(acc)
                                                       for x in app)
                ref = paged_attention_reference(
                    q.to(acc), pool if pool.element_size() == 1 else
                    pool.to(acc), None, table, lengths, num_kv_heads=hkv,
                    windows=win, append_kv=app32)
                bad = paged_plain_without(q, pool, table, lengths, hkv, drop,
                                          windows=win, append_kv=app)
                torch.cuda.synchronize()
                what = (f"paged_attention {name} splits={splits} "
                        f"append={app is not None} windows="
                        f"{win is not None}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: two calls differ")
                limit = (K6_TOL_F64 if qdt == torch.float64 else
                         ATOL + RTOL * ref.abs())
                e = (got.to(acc) - ref).abs()
                if (e > limit).any():
                    raise AssertionError(
                        f"{what}: {int((e > limit).sum())} elements off, "
                        f"max err {float(e.max()):.3e}")
                if app is None and (got[lengths == 0] != 0).any():
                    raise AssertionError(f"{what}: rows with no key are not 0")
                fe = (bad - ref).abs()
                if not (fe > limit).any():
                    raise AssertionError(f"{what}: the planted fault (keys "
                                         f"{drop} hidden) reads within the "
                                         f"limit")
                err = max(err, float(e.max()))
                fault_min = min(fault_min, float(fe.max()))
        print(f"  split edges {name:20} splits={splits} (pages a rank "
              f"{ranges[0][1]}), stages={stages}: max_abs_err {err:.3e}, "
              f"planted fault "
              f"{fault_min:.3e}; two calls equal", flush=True)
        out[name] = (splits, err, fault_min)
        del pool
    return out

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
    device ops, K6's device time us, K7's device time us) of the call."""
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
    k6 = sum(e.self_device_time_total for e in device
             if "paged_attention" in e.key)
    k7 = sum(e.self_device_time_total for e in device if "int4_mm" in e.key)
    print(f"  K6 (paged_attention) {k6:.0f} us, {100 * k6 / busy:.1f}% of "
          f"the device time" + (f"; K7 (int4_mm) {k7:.0f} us, "
                                f"{100 * k7 / busy:.1f}%" if k7 else ""))
    return busy, ops, k6, k7


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
    busy, ops, k6, k7 = profile_step(server)
    for i in range(32):
        server.remove(f"s{i}")
    return dict(tok_s=tok_s, device_us_per_step=busy / 8,
                device_ops_per_step=ops / 8, k6_share=k6 / busy,
                k7_share=k7 / busy)


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


def phase_openllama(torch_nn, models, paged_attention, att):
    """OpenLLaMA-3B at full width behind ModernBatchServer(total_pages=192)
    and ServingEngine: phase 3's 40 requests (K6 launches 26 a decode step,
    the pool back at its start, exact lengths), the greedy tokens against
    the dense ModernLM forward on the card (K1 at head_dim 100, its
    launches counted), the steady decode rate and a profiled step (K6's
    share), then a steady decode under kv_dtype=float8_e4m3fn (K6-fp8 at
    100-byte head slices). Returns the launches and figures."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = torch_nn.ModernLM.init(
        vocab_size=VOCAB, context_length=OL_CTX, num_blocks=OL_BLOCKS,
        embed_dim=OL_DIM, num_heads=OL_HEADS, num_kv_heads=OL_HEADS,
        mlp_hidden=OL_MLP, tied=False, rope_base=10000.0, norm_eps=1e-6,
        generator=gen, dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    server = models.ModernBatchServer(model, page_size=PAGE,
                                      total_pages=TOTAL_PAGES)
    print(f"  OpenLLaMA-3B: {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16), head_dim "
          f"{server.head_dim}, untied head; KV pool "
          f"{server.kv_pages.numel() * 2 / 1e9:.2f} GB", flush=True)
    prompts, results, greedy, steps = serve_requests(models, server)
    k6 = paged_attention.launches
    check_launches("paged_attention", k6, OL_BLOCKS * steps)
    # the dense forward that checks the greedy tokens runs K1 at head_dim
    # 100 (the ragged instance): its launches, counted from 0
    reset_launch_counts()
    check_greedy(lambda t, _: model(t)[0], prompts, results, greedy, MARGIN)
    k1 = att.flash_attention.launches
    check_launches("flash_attention (dense check)", k1,
                   OL_BLOCKS * len(greedy))
    decode = steady_decode(models, server, "bf16, OpenLLaMA-3B")
    del server
    torch.cuda.empty_cache()
    server8 = models.ModernBatchServer(model, page_size=PAGE,
                                       total_pages=TOTAL_PAGES,
                                       kv_dtype=torch.float8_e4m3fn)
    reset_launch_counts()
    steps0 = server8.steps_decoded
    decode8 = steady_decode(models, server8, "fp8 KV, OpenLLaMA-3B")
    steps8 = server8.steps_decoded - steps0
    k6_fp8 = paged_attention.launches
    check_launches("paged_attention (fp8 pool)", k6_fp8, OL_BLOCKS * steps8)
    if server8.seq_pages or len(server8.free_pages) != TOTAL_PAGES - 1:
        raise AssertionError("fp8: the page pool did not return to its start")
    print(f"  OpenLLaMA-3B decode: bf16 {decode['tok_s']:.1f} tok/s, "
          f"{decode['device_us_per_step']:.1f} us and "
          f"{decode['device_ops_per_step']:.1f} device ops a step, K6 "
          f"{100 * decode['k6_share']:.1f}% of it; fp8 KV "
          f"{decode8['tok_s']:.1f} tok/s, "
          f"{decode8['device_us_per_step']:.1f} us a step, K6 "
          f"{100 * decode8['k6_share']:.1f}%", flush=True)
    del server8, model
    torch.cuda.empty_cache()
    return dict(k6=k6, k6_fp8=k6_fp8, k1=k1, decode=decode, decode8=decode8)


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


def checked_device_ms(fn, n: int, what: str):
    """:func:`device_ms` of ``fn()``, held against the same calls timed by
    CUDA events (:func:`cuda_time_ms`): a trace whose kernels sum to less
    than 0.8 of the events' time per call lost records and is taken again,
    up to twice. Prints both figures; returns the last trace's times."""
    events = cuda_time_ms(fn, n, warmup=1)
    for attempt in range(3):
        times = device_ms(fn, n)
        total = sum(times.values())
        agree = total >= 0.8 * events
        print(f"  {what}: profiler {total * 1e3:.1f} us a call, CUDA "
              f"events {events * 1e3:.1f} us"
              + ("" if agree else f" (below 0.8 x events, trace "
                 f"{attempt + 1} of 3)"), flush=True)
        if agree:
            break
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
        x = torch.nn.functional.pad(x.detach().double(), (0, 0, 0, pad))
        return x.reshape(x.shape[0], x.shape[1], -1, FLASH_BLOCK * x.shape[3])

    g, w = blocks(got), blocks(want)
    num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
    if (num[den == 0] != 0).any():
        return math.inf
    return float((num[den > 0] / den[den > 0]).max())


def planted_fault(sq, skv, window=None, keep=None):
    """The visibility of a faulty kernel the checks must catch: rows past
    Sq/4 skip one 64-key tile (keys 512-575 at Skv=4096, 64-127 at 384,
    0-63 when Skv <= 64).
    Under a window too narrow for those rows to reach that tile, they skip
    the first tile past row Sq/4's diagonal instead. Under segment ids or a
    mask (``keep``: the visibility, [B or 1, H or 1, Sq, Skv]) they skip the
    64-key tile where those rows see the most keys."""
    k0 = FLASH_BLOCK * max(1, skv // 512)
    if k0 >= skv:  # one key block: the rows lose every key of it
        k0 = 0
    diag = sq // 4 + skv - sq
    if keep is not None:
        seen = keep[:, :, sq // 4:].sum(dim=(0, 1, 2))
        seen = torch.nn.functional.pad(seen, (0, -skv % FLASH_BLOCK))
        k0 = FLASH_BLOCK * int(seen.reshape(-1, FLASH_BLOCK).sum(1).argmax())
    elif window is not None and k0 + FLASH_BLOCK + window <= diag:
        k0 = -(-diag // FLASH_BLOCK) * FLASH_BLOCK
    fault = torch.ones(sq, skv, dtype=torch.bool, device="cuda")
    fault[sq // 4:, k0:k0 + FLASH_BLOCK] = False
    return fault


def check_flash(att, name, b, h, sq, skv, d, dtype, causal, window=None,
                lengths=None, segment_ids=None, mask=None):
    """Kernels (forward through autograd, then backward) against the plain
    version in f32 (f64 for float64 inputs), by :func:`block_err`; the
    plain version under
    :func:`planted_fault` must read above the limit. ``segment_ids`` (a
    [B, S] array or a pair of them) and ``mask`` (a boolean tensor on the
    card) go to both. Returns the max abs error of (o, dq, dkv), the
    largest block error and the smallest planted fault's reading."""
    q, k, v, do = flash_inputs(b, h, sq, skv, d, dtype)
    lens = None if lengths is None else torch.as_tensor(
        np.asarray(lengths, np.int32), device="cuda")
    ids = None
    if segment_ids is not None:
        ids = tuple(torch.as_tensor(np.asarray(x), device="cuda")
                    for x in segment_ids) if isinstance(segment_ids, tuple) \
            else torch.as_tensor(np.asarray(segment_ids), device="cuda")
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    o = att.flash_attention(qq, kk, vv, causal=causal, window=window,
                            kv_lengths=lens, segment_ids=ids, mask=mask)
    o.backward(do)
    torch.cuda.synchronize()
    kw = dict(causal=causal, window=att._check_window(window, causal, skv),
              kv_lengths=lens, sm_scale=1.0 / math.sqrt(d), segment_ids=ids)
    acc = torch.promote_types(dtype, torch.float32)
    q32, k32, v32, do32 = (x.to(acc) for x in (q, k, v, do))

    def plain(fault=None):
        m = mask if fault is None else (fault if mask is None
                                         else mask & fault)
        with torch.no_grad():
            ro, rlse = att.flash_attention_reference(q32, k32, v32, **kw,
                                                     mask=m)
            return (ro,) + att._flash_backward_reference(
                q32, k32, v32, ro, rlse, do32, **kw, mask=m)

    wants = plain()
    keep = None
    if ids is not None or mask is not None:
        keep = att._visible(q32, k32, causal=causal, window=kw["window"],
                            kv_lengths=lens, segment_ids=ids, mask=mask)
    faults = plain(planted_fault(sq, skv, window, keep))
    del keep
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
        errs.append(float((got.detach().to(acc) - want).abs().max()))
        rels.append(rel)
        planted.append(fault)
    del wants, faults
    if lens is not None:  # rows with no key: exactly 0 out and 0 dq
        empty = (lens == 0) if lens.dim() == 2 else \
            (lens == 0)[:, None].expand(b, sq)
        rows = empty[:, None, :].expand(b, h, sq)
        if (o.detach()[rows] != 0).any() or (qq.grad[rows] != 0).any():
            raise AssertionError(f"flash {name}: rows with no key are not 0")
    extra = ("" if ids is None else " ids") + \
        ("" if mask is None else f" mask {list(mask.shape)}")
    print(f"  {name:14} B={b} H={h} Sq={sq} Skv={skv} D={d} "
          f"{str(dtype)[6:]:8} causal={causal!s:5} window={window} "
          f"lengths={'none' if lens is None else list(lens.shape)}{extra}:\n"
          f"    block error o/dq/dk/dv {' '.join(f'{e:.2e}' for e in rels)}; "
          f"planted fault {' '.join(f'{e:.2e}' for e in planted)}; "
          f"max abs err {' '.join(f'{e:.2e}' for e in errs)}", flush=True)
    return (errs[0], errs[1], max(errs[2], errs[3])), max(rels), min(planted)


def time_flash(att, b, h, s, d, segment_ids=None):
    """Device times (ms) of the three kernels, their plain versions and
    scaled_dot_product_attention at one causal bf16 shape (with
    ``segment_ids``, a [B, S] array: packed documents, and SDPA given the
    equivalent boolean ``attn_mask``), and each kernel's bound from the
    work these inputs need."""
    import torch.nn.functional as F

    q, k, v, do = flash_inputs(b, h, s, s, d, torch.bfloat16, seed=1)
    scale = 1.0 / math.sqrt(d)
    ids = None if segment_ids is None else torch.as_tensor(
        np.asarray(segment_ids), device="cuda")
    kw = dict(causal=True, segment_ids=ids)
    vis = att._Visibility(q, ids, None)
    o, lse = att._fwd_cuda(q, k, v, None, True, scale, None, vis)
    n = 20 if s <= 1024 else 5
    fwd_times = device_ms(
        lambda: att._fwd_cuda(q, k, v, None, True, scale, None, vis), n)
    # with ids the forward's call also writes the class map
    classes = 0.0 if ids is None else _kernel_ms(fwd_times, "tile_classes")
    fwd = _kernel_ms(fwd_times, "fwd_wg") + classes
    bwd = device_ms(lambda: att._bwd_cuda(q, k, v, o, lse, do, None, True,
                                          scale, None, vis), n)
    dq, dkv = _kernel_ms(bwd, "dq_tc"), _kernel_ms(bwd, "dkv_tc")
    plain = sum(device_ms(lambda: att.flash_attention_reference(
        q, k, v, **kw), 2, warmup=1).values())
    plain_bwd = sum(device_ms(lambda: att._flash_backward_reference(
        q, k, v, o, lse, do, **kw), 2, warmup=1).values())
    # SDPA: is_causal, or the boolean mask of causal and equal ids
    keep = att._visible(q, k, causal=True, window=None, kv_lengths=None,
                        segment_ids=ids, mask=None)
    sdpa = dict(is_causal=True) if ids is None else dict(attn_mask=keep)
    lib = sum(device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, **sdpa), n).values())
    ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl, **sdpa)
    lib_bwd = sum(device_ms(lambda: torch.autograd.grad(
        lo, (ql, kl, vl), do, retain_graph=True), n).values())
    # the work these inputs need: visible (row, key) pairs (causal, and
    # equal ids); each input read once and each output written once
    # (2-byte tensors, 4-byte lse and di and ids; di is the dq kernel's
    # output and the dkv kernel's input, and no input or output of the
    # backward as a whole)
    pairs = float(keep.sum()) * (h if keep.shape[1] == 1 else 1) * (
        b if keep.shape[0] == 1 else 1)
    del keep
    t = b * h * s * d * 2
    rows = b * h * s * 4 + (0 if ids is None else b * s * 4)

    def bound(products, nbytes):
        fl, by = 2 * products * d * pairs / PEAK_FLOPS, nbytes / PEAK_BYTES
        return max(fl, by) * 1e3, ("operations" if fl >= by else "bytes")

    # whole calls by CUDA events (host launch time included, which can
    # exceed the device time at S=384): forward, and forward + backward
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(qg, kg, vg), (qg, kg, vg), do)

    def plain_fwd_bwd():
        po, plse = att.flash_attention_reference(q, k, v, **kw)
        att._flash_backward_reference(q, k, v, po, plse, do, **kw)

    events = [
        ("kernel", lambda: att.flash_attention(q, k, v, **kw),
         fwd_bwd(lambda a, b_, c: att.flash_attention(a, b_, c, **kw)), n),
        ("plain", lambda: att.flash_attention_reference(q, k, v, **kw),
         plain_fwd_bwd, 2),
        ("library", lambda: F.scaled_dot_product_attention(q, k, v, **sdpa),
         fwd_bwd(lambda a, b_, c: F.scaled_dot_product_attention(
             a, b_, c, **sdpa)), n)]
    what = f"B={b} H={h} S={s}" + ("" if ids is None else " packed")
    if ids is not None:
        print(f"  tile_classes (the class map, in the forward's time) {what}: "
              f"{classes * 1e3:.1f} us", flush=True)
    print(f"  CUDA events, {what}: " + "; ".join(
        f"{name} forward {cuda_time_ms(f, it, warmup=1) * 1e3:.1f} us, "
        f"forward+backward {cuda_time_ms(fb, it, warmup=1) * 1e3:.1f} us"
        for name, f, fb, it in events), flush=True)
    # the backward as a whole: dq and dkv against the plain backward and
    # SDPA's (each of dq, dk, dv), and the 5 products any backward needs
    # (the split design does 7: dq recomputes S and dP)
    backward = dict(ms=dq + dkv, plain_ms=plain_bwd, library_ms=lib_bwd,
                    bound=bound(5, 8 * t + rows))
    out = {
        "flash_attention_fwd": dict(ms=fwd, plain_ms=plain, library_ms=lib,
                                    bound=bound(2, 4 * t + rows)),
        "flash_attention_bwd_dq": dict(ms=dq, plain_ms=plain_bwd,
                                       library_ms=lib_bwd,
                                       bound=bound(3, 6 * t + 2 * rows),
                                       backward=backward),
        "flash_attention_bwd_dkv": dict(ms=dkv, plain_ms=plain_bwd,
                                        library_ms=lib_bwd,
                                        bound=bound(4, 6 * t + 2 * rows),
                                        backward=backward),
    }
    for name, r in list(out.items()) + [("backward (dq + dkv)", backward)]:
        print(f"  {name:24} {what}: {r['ms'] * 1e3:9.1f} us, "
              f"bound {r['bound'][0] * 1e3:7.1f} us ({r['bound'][1]}), plain "
              f"{r['plain_ms'] * 1e3:9.1f} us, library "
              f"{r['library_ms'] * 1e3:7.1f} us", flush=True)
    print("  (the dq and dkv rows' plain and library times are of the whole "
          "backward)", flush=True)
    # the backward's kernels on the work they do (dq 3 products, dkv 4,
    # together 7: dq recomputes S and dP), against the 5 products any
    # backward needs, and against SDPA's backward in this run
    five = bound(5, 8 * t + rows)[0]
    for name, ms, products in (("dq", dq, 3), ("dkv", dkv, 4),
                               ("backward", dq + dkv, 7)):
        print(f"  {name:8} {what}: "
              f"{2 * products * d * pairs / ms / 1e9:6.1f} "
              f"TFLOP/s on its {products} products, "
              f"{100 * five / ms:5.1f}% of the 5-product bound "
              f"({five * 1e3:.1f} us), {ms / lib_bwd:.3f}x SDPA's backward "
              f"({lib_bwd * 1e3:.1f} us)", flush=True)
    return out


def time_flash_case(att, b, h, s, d, dtype):
    """Device times (ms) of the forward, dq and dkv kernels at one causal
    shape of any head dim and dtype, whichever instance runs it (the
    kernel's name is printed), beside their bounds from the work these
    inputs need, the plain versions and scaled_dot_product_attention at the
    same shape and dtype (forward, and its autograd backward). Returns
    {kernel: figures}; the dq and dkv rows' plain and library times are of
    the whole backward."""
    import torch.nn.functional as F

    q, k, v, do = flash_inputs(b, h, s, s, d, dtype, seed=1)
    scale = 1.0 / math.sqrt(d)
    o, lse = att._fwd_cuda(q, k, v, None, True, scale, None)
    n = 5
    what = f"B={b} H={h} S={s} D={d} {str(dtype)[6:]}"
    fwd_times = checked_device_ms(
        lambda: att._fwd_cuda(q, k, v, None, True, scale, None), n,
        f"forward {what}")
    bwd_times = checked_device_ms(lambda: att._bwd_cuda(
        q, k, v, o, lse, do, None, True, scale, None), n, f"backward {what}")
    names = [key for key in list(fwd_times) + list(bwd_times)
             if "fwd_" in key or "dq_" in key or "dkv_" in key]
    fwd = _kernel_ms(fwd_times, "fwd_")
    dq, dkv = _kernel_ms(bwd_times, "dq_"), _kernel_ms(bwd_times, "dkv_")
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
    # the work: the causal pairs; each input read once and each output
    # written once (lse and di in f32, f64 for float64)
    pairs = b * h * s * (s + 1) / 2
    t = b * h * s * d * q.element_size()
    rows = b * h * s * lse.element_size()
    peak = {torch.float32: PEAK_FLOPS_F32,
            torch.float64: PEAK_FLOPS_F64}.get(dtype, PEAK_FLOPS)

    def bound(products, nbytes):
        fl, by = 2 * products * d * pairs / peak, nbytes / PEAK_BYTES
        return max(fl, by) * 1e3, ("operations" if fl >= by else "bytes")

    out = {"fwd": dict(ms=fwd, plain_ms=plain, library_ms=lib,
                       bound=bound(2, 4 * t + rows)),
           "dq": dict(ms=dq, plain_ms=plain_bwd, library_ms=lib_bwd,
                      bound=bound(3, 6 * t + 2 * rows)),
           "dkv": dict(ms=dkv, plain_ms=plain_bwd, library_ms=lib_bwd,
                       bound=bound(4, 6 * t + 2 * rows))}
    print(f"  timing {what}: kernels {sorted(set(names))}", flush=True)
    for name, r in out.items():
        print(f"  {name:4} {what}: {r['ms'] * 1e3:9.1f} us, bound "
              f"{r['bound'][0] * 1e3:7.1f} us ({r['bound'][1]}), plain "
              f"{r['plain_ms'] * 1e3:9.1f} us, SDPA {r['library_ms'] * 1e3:7.1f}"
              f" us{'' if name == 'fwd' else ' (plain, SDPA: whole backward)'}",
              flush=True)
    # the backward as a whole against the 5 products any backward needs
    # (dq and dkv do 7: dq recomputes S and dP)
    five = bound(5, 8 * t + 2 * rows)
    print(f"  bwd  {what}: dq + dkv {(dq + dkv) * 1e3:9.1f} us, bound (5 "
          f"products) {five[0] * 1e3:7.1f} us ({five[1]}), SDPA's backward "
          f"{lib_bwd * 1e3:7.1f} us", flush=True)
    return out


def flash_instance(d, dtype, part):
    """The kernel family that runs a head dim and dtype (the entry points'
    routing in csrc/flash_attention.cu): part is "fwd", "dq" or "dkv"."""
    if dtype in (torch.bfloat16, torch.float16) and d <= 256:
        if d % 8:
            return f"{part}_ragged"
        if part == "fwd":
            return "fwd_wg"
        return f"{part}_wide" if d > 128 else f"{part}_tc"
    return f"{part}_any"


# phase 4: the head dims of dq_any and dkv_any's edges (64-row blocks; 64-,
# 32- or 16-row tiles; instances of 32, 64, 112 (float64) and 128 columns,
# and 128-column parts above 128), by dtype
ANY_HEAD_DIMS = ((torch.float64, (8, 64, 100, 128, 136, 200)),
                 (torch.float32, (64, 100, 320)),
                 (torch.bfloat16, (320,)))


def check_flash_head_dims(att, check):
    """Head dims the instances of 32, 64 and 128 do not hold (12, 75 and
    100: not a multiple of 8; 160 and 256: above 128) in bf16, causal and
    with segment ids; then the edges of dq_any and dkv_any (ANY_HEAD_DIMS),
    each causal with kv lengths that cut tiles, causal with Sq != Skv, with
    segment ids and with a mask, a window once, and two backward calls bit
    for bit; each by the checks of check_flash; then the tensor-core head
    dims and f64 and f32 at 64 and 100 timed at B=2, H=8, S=2048. Returns
    the times by (head dim, dtype) and the largest abs error of each
    kernel family that ran (flash_instance)."""
    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    s = 1000
    ids = np.sort(np.random.RandomState(3).randint(0, 4, (2, s)), 1)
    errs = {}

    def run(name, d, dtype, *args, **kw):
        e = check(name, *args[:4], d, dtype, *args[4:], **kw)
        for part, err in zip(("fwd", "dq", "dkv"), e):
            key = flash_instance(d, dtype, part)
            errs[key] = max(errs.get(key, 0.0), err)

    for d in (12, 100, 160, 256):
        run(f"head_dim {d}", d, bf16, 2, 4, s, s, True, lengths=[1000, 555])
        run(f"head_dim {d} ids", d, bf16, 2, 4, s, s, True, segment_ids=ids)
    # an odd head dim (2-byte copies, stores of single elements)
    run("head_dim 75", 75, bf16, 2, 4, s, s, True, lengths=[1000, 555])
    errs["fwd_ragged"] = max(errs["fwd_ragged"], check_ragged_forward(att))
    check_ragged_backward(att, run)
    check_wide_backward(att, run)
    check_any_backward(att, run, ids)
    check_any_forward(att)
    # (head dim, dtype, B, H, S): B=2, H=8, S=2048, and phase 5's f32
    # flagship's own shape
    times = {(d, dt, 2, 8, 2048): time_flash_case(att, 2, 8, 2048, d, dt)
             for d, dt in ((12, bf16), (75, bf16), (100, bf16), (130, bf16),
                           (250, bf16), (160, bf16), (192, bf16),
                           (256, bf16), (320, bf16), (64, f64), (100, f64),
                           (64, f32), (100, f32))}
    times[64, f32, 8, LM_HEADS, 384] = time_flash_case(att, 8, LM_HEADS, 384,
                                                       64, f32)
    return times, errs


# phase 4: the head dims of dq_wide and dkv_wide (16-bit multiples of 8
# above 128): 136-192 in the D=192 instance, 200 and 256 in D=256
WIDE_HEAD_DIMS = (136, 160, 192, 200, 256)


def check_wide_backward(att, run):
    """The edges of dq_wide and dkv_wide (dq blocks of 64 rows at D=256 and
    128 at D=192, dkv blocks of 64 keys, 64-key and 64-row tiles) at
    WIDE_HEAD_DIMS in bf16 and f16, each by ``run(name, d, dtype, b, h,
    sq, skv, causal, **kw)`` (check_flash's checks): causal with kv
    lengths [2, 65, 2047] and a 0; [B, Sq] lengths with rows of length 0
    inside 64-row blocks that keep visible rows; Sq != Skv; segment ids;
    a [B, 1, Sq, Skv] mask. Then at 160 and 256 in bf16: S = 63, 65, 127
    and 129, non-causal and causal over the 64-key multiple above S (a
    last key block of one key, seen by one row, would compare dk's
    rounding noise), and a window of 100; phase 12's own shape (B=2, H=8,
    S=2048, D=256); two backward calls bit for bit at 192 and 256 with and
    without ids. (Head dims 130 and 250, not multiples of 8, are
    check_ragged_backward's.)"""
    bf16, f16 = torch.bfloat16, torch.float16
    rng = np.random.RandomState(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    s = 700
    lens = rng.randint(2, s + 1, (2, s))
    lens[:, 10:20] = 0  # inside the first 64-row block
    lens[1, 300:360] = 0  # across two blocks
    ids = np.sort(rng.randint(0, 4, (2, 1000)), 1)
    sq, skv = 300, 700
    mask = torch.rand(2, 1, sq, skv, generator=gen, device="cuda") < 0.8
    mask[..., torch.arange(sq), torch.arange(sq) + skv - sq] = True
    for d in WIDE_HEAD_DIMS:
        for dtype in (bf16, f16):
            name = f"wide {str(dtype)[6:]} head {d}"
            run(f"{name} lengths", d, dtype, 4, 2, 2048, 2048, True,
                lengths=[2, 65, 2047, 0])
            run(f"{name} lengths [B,Sq]", d, dtype, 2, 2, s, s, True,
                lengths=lens)
            run(f"{name} Sq!=Skv", d, dtype, 2, 2, sq, skv, True)
            run(f"{name} ids", d, dtype, 2, 2, s, s, True,
                segment_ids=ids[:, :s])
            run(f"{name} mask", d, dtype, 2, 2, sq, skv, True, mask=mask)
    for d in (160, 256):
        for n in (63, 65, 127, 129):
            run(f"wide head {d} S={n}", d, bf16, 2, 4, n, n, False)
            run(f"wide head {d} Sq={n} causal", d, bf16, 2, 4, n,
                -(-n // 64) * 64, True)
        run(f"wide head {d} window 100", d, bf16, 2, 4, 1000, 1000, True,
            window=100)
    run("wide path shape", 256, bf16, 2, 8, 2048, 2048, True)
    for d in (192, 256):
        check_deterministic(att, 2, 4, 1000, d)
        check_deterministic(att, 2, 4, 1000, d, segment_ids=ids)


def check_ragged_backward(att, run):
    """The edges of the ragged backward (dq_tc/dkv_tc<D, T, M, true> up to
    head dim 128, dq_wide/dkv_wide<D, T, M, true> above: the wgmma
    kernels fed by the cp.async producer) at RAGGED_HEAD_DIMS in bf16 and
    f16, each by ``run(name, d, dtype, b, h, sq, skv, causal, **kw)``
    (check_flash's checks: o, dq, dk and dv per 64-row block at
    FLASH_TOL, each case with its planted fault above the limit, rows
    with no key exactly 0): causal with kv lengths [2, 65, 2047] and a 0;
    [B, Sq] lengths with rows of length 0 inside 64-row blocks that keep
    visible rows; Sq != Skv; segment ids; a [B, 1, Sq, Skv] mask. Then in
    bf16: a window of 100 at every head dim, and at 12, 75, 100 and 250
    S = 63, 65, 127 and 129, non-causal and causal over the 64-key multiple
    above S (the 128-row dq blocks and 128-key dkv blocks cut); phase 13's
    own shape (B=2, H=32, S=2048, D=100); and two backward calls bit for
    bit at 12, 75, 100 and 250, with and without ids."""
    bf16, f16 = torch.bfloat16, torch.float16
    rng = np.random.RandomState(11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    s = 700
    lens = rng.randint(2, s + 1, (2, s))
    lens[:, 10:20] = 0  # inside the first 64-row block
    lens[1, 300:360] = 0  # across two blocks
    ids = np.sort(rng.randint(0, 4, (2, 1000)), 1)
    sq, skv = 300, 700
    mask = torch.rand(2, 1, sq, skv, generator=gen, device="cuda") < 0.8
    mask[..., torch.arange(sq), torch.arange(sq) + skv - sq] = True
    for d in RAGGED_HEAD_DIMS:
        for dtype in (bf16, f16):
            name = f"ragged {str(dtype)[6:]} head {d}"
            run(f"{name} lengths", d, dtype, 4, 2, 2048, 2048, True,
                lengths=[2, 65, 2047, 0])
            run(f"{name} lengths [B,Sq]", d, dtype, 2, 2, s, s, True,
                lengths=lens)
            run(f"{name} Sq!=Skv", d, dtype, 2, 2, sq, skv, True)
            run(f"{name} ids", d, dtype, 2, 2, s, s, True,
                segment_ids=ids[:, :s])
            run(f"{name} mask", d, dtype, 2, 2, sq, skv, True, mask=mask)
        run(f"ragged head {d} window 100", d, bf16, 2, 4, 1000, 1000, True,
            window=100)
    for d in (12, 75, 100, 250):
        for n in (63, 65, 127, 129):
            run(f"ragged head {d} S={n}", d, bf16, 2, 4, n, n, False)
            run(f"ragged head {d} Sq={n} causal", d, bf16, 2, 4, n,
                -(-n // 64) * 64, True)
    run("ragged path shape", OL_HEAD_DIM, bf16, OPENLLAMA_TRAIN_ROWS,
        OL_HEADS, OL_CTX, OL_CTX, True)
    for d in (12, 75, 100, 250):
        check_deterministic(att, 2, 4, 1000, d)
        check_deterministic(att, 2, 4, 1000, d, segment_ids=ids)


def check_any_backward(att, run, ids):
    """The edges of dq_any and dkv_any at ANY_HEAD_DIMS, each by
    ``run(name, d, dtype, b, h, sq, skv, causal, **kw)`` (check_flash's
    checks): kv lengths that end a 64-key block after 2 and 1 keys and one
    short of 2048; Sq != Skv, whose causal offset cuts the tiles; segment
    ids (``ids``, [2, >= 512]); a [B, 1, Sq, Skv] mask with every row
    keeping its diagonal key; a window once; head dims whose rows take
    8-, 4- and 2-byte copies; then two backward calls bit for bit in f64,
    f32 and bf16 at head dim 320."""
    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    s = 1000
    gen = torch.Generator(device="cuda").manual_seed(5)
    sq, skv = 300, 700
    mask = (torch.rand(2, 1, sq, skv, generator=gen, device="cuda") < 0.8)
    mask[..., torch.arange(sq), torch.arange(sq) + skv - sq] = True
    for dtype, dims in ANY_HEAD_DIMS:
        for d in dims:
            name = f"{str(dtype)[6:]} head {d}"
            run(f"{name} lengths", d, dtype, 3, 2, 2048, 2048, True,
                lengths=[2, 65, 2047])
            run(f"{name} Sq!=Skv", d, dtype, 2, 2, sq, skv, True)
            run(f"{name} ids", d, dtype, 2, 2, 512, 512, True,
                segment_ids=ids[:, :512])
            run(f"{name} mask", d, dtype, 2, 2, sq, skv, True, mask=mask)
    run("f64 head 100 window", 100, f64, 2, 2, s, s, True, window=100)
    # rows that are not a multiple of 16 bytes: staged by 8-, 4- or (an odd
    # 16-bit head dim) 2-byte copies
    for d, dtype in ((75, f64), (75, f32), (102, f32), (300, bf16),
                     (258, bf16), (257, bf16)):
        run(f"{str(dtype)[6:]} head {d} narrow", d, dtype, 2, 2, s, s, True,
            lengths=[1000, 555])
    for d, dtype in ((100, f64), (64, f32), (320, bf16)):
        check_deterministic(att, 2, 4, s, d, dtype=dtype)


def lse_block_err(got, want):
    """:func:`block_err` of lse [B, H, S]: a row whose plain lse is -inf
    (no visible key) must be -inf in ``got`` too (else inf), and the rest
    compare per 64-row block."""
    empty = want == -math.inf
    if not torch.equal(got == -math.inf, empty):
        return math.inf
    return block_err(got.masked_fill(empty, 0)[..., None],
                     want.masked_fill(empty, 0)[..., None])


def check_any_forward(att):
    """The edges of the forward for f32, f64 and 16-bit above 256 (fwd_any:
    blocks of 64 rows, tiles of 64 or 32 keys, instances of 32, 64, 112
    (float64) and 128 columns, 128-column parts above 128): o and lse of
    the kernel against the plain version (f32; f64 for float64) by
    :func:`block_err` per 64-row block, and the plain version under
    :func:`planted_fault`, which must read above the limits. o is held to
    FLASH_TOL; lse to 1e-10 in float64 and 1e-5 otherwise: the kernel and
    the plain version compute it in f32 from the same inputs in every
    other dtype, so bf16's looser limit for o (p rounded to bf16) does not
    apply. Cases, in f64 and f32: rows 63, 65, 127 and 129, which cut the
    64-row block; [B, Sq] kv lengths with rows of length 0 inside blocks
    that have visible rows; Sq = 1 and Sq != Skv; a window; segment ids and
    a [B, 1, Sq, Skv] mask; head dims 8 to 320 with kv lengths (and 257 and
    320 in bf16); then two forward calls bit for bit in f64, f32 and bf16
    at head dim 320."""
    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    rng = np.random.RandomState(6)
    gen = torch.Generator(device="cuda").manual_seed(6)
    lens = rng.randint(1, 301, (2, 300))
    lens[:, 10:20] = 0  # zero-length rows inside the first 64-row block
    lens[1, 200:260] = 0
    ids = np.sort(rng.randint(0, 4, (2, 512)), 1)
    mask = torch.rand(2, 1, 300, 700, generator=gen, device="cuda") < 0.8
    mask[..., torch.arange(300), torch.arange(300) + 400] = True
    # (name, b, h, sq, skv, d, causal, keyword arguments)
    cases = [(f"rows {n}", 2, 3, n, 384, 64, True, {})
             for n in (63, 65, 127, 129)]
    cases += [("lengths [B,Sq]", 2, 3, 300, 300, 100, True,
               dict(lengths=lens)),
              ("Sq=1", 2, 3, 1, 1000, 64, True, {}),
              ("Sq!=Skv", 2, 3, 300, 700, 100, True, {}),
              ("window", 2, 2, 1000, 1000, 100, True, dict(window=100)),
              ("ids", 2, 2, 512, 512, 64, True, dict(segment_ids=ids)),
              ("mask", 2, 2, 300, 700, 100, True, dict(mask=mask))]
    cases += [(f"head {d}", 2, 2, 600, 600, d, True,
               dict(lengths=[600, 333]))
              for d in (8, 64, 100, 112, 128, 129, 136, 256, 257, 320)]
    runs = [(dtype, case) for dtype in (f64, f32) for case in cases]
    runs += [(bf16, case) for case in cases if case[5] in (257, 320)
             and case[0].startswith("head")]
    worst = {}
    for dtype, (name, b, h, sq, skv, d, causal, kw) in runs:
        q, k, v, _ = flash_inputs(b, h, sq, skv, d, dtype)
        lengths = kw.get("lengths")
        lim = None if lengths is None else torch.as_tensor(
            np.asarray(lengths, np.int32), device="cuda")
        seg = kw.get("segment_ids")
        seg = None if seg is None else torch.as_tensor(seg, device="cuda")
        m = kw.get("mask")
        window = att._check_window(kw.get("window"), causal, skv)
        scale = 1.0 / math.sqrt(d)
        o, lse = att._fwd_cuda(q, k, v, lim, causal, scale, window,
                               att._Visibility(q, seg, m))
        acc = torch.promote_types(dtype, torch.float32)
        ref = dict(causal=causal, window=window, kv_lengths=lim,
                   sm_scale=scale, segment_ids=seg)
        qa, ka, va = (x.to(acc) for x in (q, k, v))
        with torch.no_grad():
            want = att.flash_attention_reference(qa, ka, va, **ref, mask=m)
            keep = None if seg is None and m is None else att._visible(
                qa, ka, **{x: ref[x] for x in ("causal", "window",
                                               "kv_lengths", "segment_ids")},
                mask=m)
            fault = planted_fault(sq, skv, kw.get("window"), keep)
            bad = att.flash_attention_reference(
                qa, ka, va, **ref, mask=fault if m is None else m & fault)
        tols = (FLASH_TOL[dtype], FLASH_TOL[torch.float64 if dtype == f64
                                            else torch.float32])
        errs = (block_err(o, want[0]), lse_block_err(lse, want[1]))
        faults = (block_err(bad[0], want[0]), lse_block_err(bad[1], want[1]))
        label = (f"{str(dtype)[6:]} {name} (B={b} H={h} Sq={sq} Skv={skv} "
                 f"D={d})")
        for what, err, fe, tol in zip(("o", "lse"), errs, faults, tols):
            if not err <= tol:
                raise AssertionError(f"fwd_any {label} {what}: block error "
                                     f"{err:.3e} > {tol:.0e}")
            if not fe > tol:
                raise AssertionError(f"fwd_any {label} {what}: the planted "
                                     f"fault reads {fe:.3e}, within {tol:.0e}")
        empty = want[1] == -math.inf
        if (o[empty] != 0).any():
            raise AssertionError(f"fwd_any {label}: rows with no key are "
                                 f"not 0")
        w = worst.setdefault(dtype, [0.0, 0.0, math.inf])
        w[0], w[1] = max(w[0], errs[0]), max(w[1], errs[1])
        w[2] = min(w[2], *faults)
        print(f"  fwd_any {label}: block error o {errs[0]:.2e} lse "
              f"{errs[1]:.2e}; planted fault {faults[0]:.2e} "
              f"{faults[1]:.2e}; rows with no key {int(empty.sum())}",
              flush=True)
    for dtype, (eo, el, fe) in worst.items():
        print(f"  fwd_any {str(dtype)[6:]}: largest block error o {eo:.3e}, "
              f"lse {el:.3e}; smallest planted fault {fe:.3e}", flush=True)
    for dtype in (f64, f32, bf16):
        q, k, v, _ = flash_inputs(2, 4, 1000, 1000, 320, dtype, seed=2)
        first, second = (att._fwd_cuda(q, k, v, None, True, 320 ** -0.5, None)
                         for _ in range(2))
        for what, x, y in zip(("o", "lse"), first, second):
            if not torch.equal(x, y):
                raise AssertionError(f"fwd_any {str(dtype)[6:]}: {what} "
                                     f"differs between two calls")
        print(f"  determinism    B=2 H=4 S=1000 D=320 {str(dtype)[6:]}: two "
              f"forward calls give equal o and lse", flush=True)


# phase 4: the ragged head dims (d % 8 != 0) of the wgmma forward's
# cp.async producer: 8-byte pieces (12, 100), 4-byte ones (102, 130, 250),
# 2-byte loads (75); instances D = 32 (12), 128 (75, 100, 102), 192 (130)
# and 256 (250)
RAGGED_HEAD_DIMS = (12, 75, 100, 102, 130, 250)


def check_ragged_forward(att):
    """The edges of the ragged forward (fwd_wg<D, T, M, true>, tiles copied
    by cp.async) at RAGGED_HEAD_DIMS in bf16 and f16: o and lse of the
    kernel against the plain version in f32 by :func:`block_err` per 64-row
    block, o at FLASH_TOL and lse at 1e-5 (both compute it in f32 from the
    same inputs), and the plain version under :func:`planted_fault`, which
    must read above both limits; every case also twice, bit for bit (a
    stage read before its copies land, or without the proxy fence, differs
    between calls). Cases: kv lengths [2, 65, 2047, 0] at S=2048; [B, Sq]
    lengths with rows of length 0 inside blocks that have visible rows;
    Sq != Skv; rows 63, 65, 127 and 129 (a block of 128 or 192 rows cut);
    a window of 100; segment ids and a [B, 1, Sq, Skv] mask (the masked
    instance); and the path's shape, phase 11's dense check (B=1, H=32,
    S=127). Returns the largest abs error of o."""
    bf16, f16 = torch.bfloat16, torch.float16
    rng = np.random.RandomState(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lens = rng.randint(1, 301, (2, 300))
    lens[:, 10:20] = 0  # zero-length rows inside the first 64-row block
    lens[1, 200:260] = 0
    ids = np.sort(rng.randint(0, 4, (2, 512)), 1)
    mask = torch.rand(2, 1, 300, 700, generator=gen, device="cuda") < 0.8
    mask[..., torch.arange(300), torch.arange(300) + 400] = True
    # (name, b, h, sq, skv, causal, keyword arguments)
    cases = [("lengths [B]", 4, 2, 2048, 2048, True,
              dict(lengths=[2, 65, 2047, 0])),
             ("lengths [B,Sq]", 2, 3, 300, 300, True, dict(lengths=lens)),
             ("Sq!=Skv", 2, 3, 300, 700, True, {}),
             ("window", 2, 2, 1000, 1000, True, dict(window=100)),
             ("ids", 2, 2, 512, 512, True, dict(segment_ids=ids)),
             ("mask", 2, 2, 300, 700, True, dict(mask=mask)),
             ("path", 1, OL_HEADS, 127, 127, True, {})]
    cases += [(f"rows {n}", 2, 3, n, n, True, {}) for n in (63, 65, 127, 129)]
    worst = [0.0, 0.0, math.inf, 0.0]  # o, lse, smallest fault, abs err
    for d in RAGGED_HEAD_DIMS:
        for dtype in (bf16, f16):
            for name, b, h, sq, skv, causal, kw in cases:
                q, k, v, _ = flash_inputs(b, h, sq, skv, d, dtype)
                lengths = kw.get("lengths")
                lim = None if lengths is None else torch.as_tensor(
                    np.asarray(lengths, np.int32), device="cuda")
                seg = kw.get("segment_ids")
                seg = None if seg is None else torch.as_tensor(
                    seg, device="cuda")
                m = kw.get("mask")
                window = att._check_window(kw.get("window"), causal, skv)
                scale = 1.0 / math.sqrt(d)
                vis = att._Visibility(q, seg, m)
                o, lse = att._fwd_cuda(q, k, v, lim, causal, scale, window,
                                       vis)
                o2, lse2 = att._fwd_cuda(q, k, v, lim, causal, scale, window,
                                         vis)
                ref = dict(causal=causal, window=window, kv_lengths=lim,
                           sm_scale=scale, segment_ids=seg)
                qa, ka, va = (x.float() for x in (q, k, v))
                with torch.no_grad():
                    want = att.flash_attention_reference(qa, ka, va, **ref,
                                                         mask=m)
                    keep = None if seg is None and m is None else \
                        att._visible(qa, ka, **{x: ref[x] for x in (
                            "causal", "window", "kv_lengths",
                            "segment_ids")}, mask=m)
                    fault = planted_fault(sq, skv, kw.get("window"), keep)
                    bad = att.flash_attention_reference(
                        qa, ka, va, **ref,
                        mask=fault if m is None else m & fault)
                label = (f"{str(dtype)[6:]} D={d} {name} (B={b} H={h} "
                         f"Sq={sq} Skv={skv})")
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                    raise AssertionError(f"fwd_ragged {label}: two calls "
                                         f"differ")
                errs = (block_err(o, want[0]), lse_block_err(lse, want[1]))
                faults = (block_err(bad[0], want[0]),
                          lse_block_err(bad[1], want[1]))
                for what, err, fe, tol in zip(("o", "lse"), errs, faults,
                                              (FLASH_TOL[dtype], 1e-5)):
                    if not err <= tol:
                        raise AssertionError(
                            f"fwd_ragged {label} {what}: block error "
                            f"{err:.3e} > {tol:.0e}")
                    if not fe > tol:
                        raise AssertionError(
                            f"fwd_ragged {label} {what}: the planted fault "
                            f"reads {fe:.3e}, within {tol:.0e}")
                empty = want[1] == -math.inf
                if (o[empty] != 0).any():
                    raise AssertionError(f"fwd_ragged {label}: rows with no "
                                         f"key are not 0")
                worst[0] = max(worst[0], errs[0])
                worst[1] = max(worst[1], errs[1])
                worst[2] = min(worst[2], *faults)
                worst[3] = max(worst[3], float(
                    (o.float() - want[0]).abs().max()))
            print(f"  fwd_ragged D={d} {str(dtype)[6:]}: {len(cases)} cases "
                  f"pass, two calls equal in each", flush=True)
    print(f"  fwd_ragged: largest block error o {worst[0]:.3e}, lse "
          f"{worst[1]:.3e}; smallest planted fault {worst[2]:.3e}",
          flush=True)
    return worst[3]

# the wgmma forward's instances past 128: head dims that are multiples of 8
# in D=128 (72), D=192 (136, 192) and D=256 (200, 256)
WG_HEAD_DIMS = (72, 136, 192, 200, 256)


def check_flash_forward_edges(att, check):
    """The edges of the wgmma forward (fwd_wg): its 128-row blocks at 127
    and 129 rows (S=4160 and the lengths that differ between a block's
    64-row halves are phase 4's earlier checks), its instances at
    WG_HEAD_DIMS in bf16 and f16, causal with kv lengths (the unmasked
    instance) and with segment ids (the masked one), and a window of 100
    at head_dim 192. 129 rows run non-causal, and causal over 192 keys:
    causal at S=129, key 128 is seen by row 128 alone, and dk's block of
    that one key compares rounding noise (as a row with one visible key;
    see phase 4's "lengths edges")."""
    bf16, f16 = torch.bfloat16, torch.float16
    check("S=127", 2, LM_HEADS, 127, 127, 64, bf16, True)
    check("S=129", 2, LM_HEADS, 129, 129, 64, bf16, False)
    check("Sq=129 Skv=192", 2, LM_HEADS, 129, 192, 64, bf16, True)
    s = 1000
    ids = np.sort(np.random.RandomState(4).randint(0, 4, (2, s)), 1)
    for d in WG_HEAD_DIMS:
        for dtype in (bf16, f16):
            name = f"head_dim {d} {str(dtype)[6:]}"
            check(name, 2, 4, s, s, d, dtype, True, lengths=[1000, 555])
            check(f"{name} ids", 2, 4, s, s, d, dtype, True, segment_ids=ids)
    check("head_dim 192 window 100", 2, 4, 2000, 2000, 192, bf16, True,
          window=100)


def check_deterministic(att, b, h, s, d, segment_ids=None,
                        dtype=torch.bfloat16):
    """Two backward calls on the same inputs give the same bits."""
    q, k, v, do = flash_inputs(b, h, s, s, d, dtype, seed=2)
    scale = 1.0 / math.sqrt(d)
    ids = None if segment_ids is None else torch.as_tensor(
        np.asarray(segment_ids), device="cuda")
    vis = att._Visibility(q, ids, None)
    o, lse = att._fwd_cuda(q, k, v, None, True, scale, None, vis)
    first, second = (att._bwd_cuda(q, k, v, o, lse, do, None, True, scale,
                                   None, vis) for _ in range(2))
    for what, x, y in zip(("dq", "dk", "dv"), first, second):
        if not torch.equal(x, y):
            raise AssertionError(f"flash backward: {what} differs between "
                                 f"two calls on the same inputs")
    print(f"  determinism    B={b} H={h} S={s} D={d} {str(dtype)[6:]}"
          f"{'' if ids is None else ' packed ids'}: two backward calls "
          f"give equal dq, dk and dv", flush=True)


def packed_batch(seed=0):
    """Phase 10's batch: documents of uniform length PACK_DOC_LENS with
    token ids uniform over the vocabulary, from a numpy seed, packed by the
    port's pack_documents into rows of PACK_CTX; the first PACK_BATCH rows,
    a dict of int32 arrays (tokens, targets, segment_ids, positions)."""
    from lamp_tpu_torch.data import pack_documents

    rng = np.random.RandomState(seed)
    lo, hi = PACK_DOC_LENS
    docs = [rng.randint(0, VOCAB, rng.randint(lo, hi + 1))
            for _ in range(8 * PACK_BATCH)]
    packed = pack_documents(docs, PACK_CTX)
    return {key: a[:PACK_BATCH] for key, a in packed.items()}


def check_flash_branches(att, check):
    """The branches the TPU kernels take beyond causal, window and kv
    lengths: segment ids (packed, a pair with Sq != Skv, unsorted), masks
    (prefix-LM broadcast over heads, per-head block-sparse with runs of
    more than kStages skipped tiles, [1, 1, Sq, Skv], composed with
    lengths and ids), head dims 32, 16 and 96, float16, and a segmented
    backward twice, bit for bit."""
    dev = "cuda"
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    rng = np.random.RandomState(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    packed = packed_batch()["segment_ids"]
    check("packed ids", PACK_BATCH, LM_HEADS, PACK_CTX, PACK_CTX, 64, bf16,
          True, segment_ids=packed)
    check("ids pair", 2, 4, 700, 1100, 64, bf16, False,
          segment_ids=(np.sort(rng.randint(0, 6, (2, 700)), 1),
                       np.sort(rng.randint(0, 6, (2, 1100)), 1)))
    check("unsorted ids", 2, 4, 1000, 1000, 64, bf16, True,
          segment_ids=rng.randint(0, 3, (2, 1000)))
    s = 1000
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    prefix = torch.tensor([300, 650], device=dev)[:, None, None, None]
    check("prefix-LM mask", 2, 4, s, s, 64, bf16, False,
          mask=(cols < prefix) | (cols <= rows))  # [B, 1, S, S]
    # per head, the even 64-row blocks see their own diagonal block of
    # 256, 512 or 768 keys, the odd ones every key: a 128-row dq block's
    # halves then skip and compute different runs of tiles (up to 11
    # skipped 128-key tiles in a row, more than the ring's 4 stages)
    s = 2048
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    heads = []
    for hh in range(4):
        blk = 256 * (1 + hh % 3)
        heads.append(((rows // 64) % 2 == 1) | (rows // blk == cols // blk))
    check("block-sparse", 2, 4, s, s, 64, bf16, False,
          mask=torch.stack(heads)[None].expand(2, 4, s, s).contiguous())
    s = 777
    eye = torch.eye(s, dtype=torch.bool, device=dev)
    check("mask [1,1]", 2, 4, s, s, 64, bf16, True,
          mask=((torch.rand(s, s, generator=gen, device=dev) < 0.75)
                | eye)[None, None])
    s = 1000
    eye = torch.eye(s, dtype=torch.bool, device=dev)
    composed = dict(
        lengths=[900, 1000], segment_ids=np.sort(rng.randint(0, 6, (2, s)), 1),
        mask=(torch.rand(2, 1, s, s, generator=gen, device=dev) < 0.9) | eye)
    check("composed", 2, 4, s, s, 64, bf16, True, **composed)
    ids = np.sort(rng.randint(0, 4, (2, s)), 1)
    for d in (32, 16, 96):
        check(f"head_dim {d}", 2, 4, s, s, d, bf16, True, lengths=[1000, 555])
        check(f"head_dim {d} ids", 2, 4, s, s, d, bf16, True, segment_ids=ids)
        check(f"f32 head {d}", 1, 4, 300, 400, d, f32, False)
        check(f"f32 head {d} ids", 2, 4, 512, 512, d, f32, True,
              segment_ids=ids[:, :512])
    check("head_dim 96 window", 2, 4, s, s, 96, bf16, True, window=300)
    check("f32 composed", 2, 4, s, s, 64, f32, True, **composed)
    check("f16", 2, LM_HEADS, 2048, 2048, 64, f16, True)
    check("f16 head 128", 2, 8, s, s, 128, f16, True, lengths=[1000, 555])
    check("f16 ids", 2, 4, s, s, 64, f16, True, segment_ids=ids)
    check("f16 head 32 mask", 2, 4, s, s, 32, f16, True,
          mask=composed["mask"])
    check_deterministic(att, PACK_BATCH, LM_HEADS, PACK_CTX, 64,
                        segment_ids=packed)
    return packed


def phase_flash(att):
    checks = {torch.bfloat16: [], torch.float16: [], torch.float32: [],
              torch.float64: []}

    def check(*args, **kw):
        result = check_flash(att, *args, **kw)
        checks[args[6]].append(result)
        return result[0]

    errs = [check("slice", 2, LM_HEADS, 4096, 4096, 64, torch.bfloat16, True),
            check("flagship", 8, LM_HEADS, 384, 384, 64, torch.bfloat16,
                  True),
            # phase 5's f32 flagship shape: fwd_any, dq_any and dkv_any
            check("flagship f32", 8, LM_HEADS, 384, 384, 64, torch.float32,
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
    # the edges of the backward's 128-row and 128-key blocks
    check("S=4160", 1, LM_HEADS, 4160, 4160, 64, torch.bfloat16, True)
    # a row with one visible key has dq = 0 and adds 0 to dk in exact
    # arithmetic (o = v, so di = dP): kernel and plain version both return
    # rounding noise there, which no relative error can compare, so the
    # smallest length held here is 2
    check("lengths edges", 3, 4, 4096, 4096, 64, torch.bfloat16, True,
          lengths=[2, 129, 4095])
    check("window 100", 2, 4, 2000, 2000, 64, torch.bfloat16, True,
          window=100)
    check("head_dim 128 S=1000", 2, 4, 1000, 1000, 128, torch.bfloat16,
          True, lengths=[1000, 0])
    # per-row lengths that differ between the two halves of a 128-row dq
    # block: one warpgroup's rows see a few keys, the other's all of them,
    # so one skips many tiles the other computes
    rows = np.arange(1000)
    check("lengths halves", 2, 4, 1000, 1000, 64, torch.bfloat16, True,
          lengths=np.stack([np.where(rows % 128 < 64, 2 + rows % 5, 1000),
                            np.where(rows % 128 < 64, 1000, 2 + rows % 5)]))
    check_deterministic(att, 2, LM_HEADS, 4096, 64)
    check_flash_forward_edges(att, check)
    packed = check_flash_branches(att, check)
    wide = check_flash_head_dims(att, check)
    for dtype, results in checks.items():
        print(f"  {str(dtype)[6:]}: largest block error "
              f"{max(r[1] for r in results):.3e}, limit "
              f"{FLASH_TOL[dtype]:.0e}, smallest planted fault "
              f"{min(r[2] for r in results):.3e}", flush=True)
    times = time_flash(att, 2, LM_HEADS, 4096, 64)
    time_flash(att, 8, LM_HEADS, 384, 64)  # printed: the flagship shape
    # phase 10's packed shapes
    packed_times = time_flash(att, PACK_BATCH, LM_HEADS, PACK_CTX, 64,
                              segment_ids=packed)
    for i, name in enumerate(times):
        times[name]["max_abs_err"] = max(e[i] for e in errs)
        times[name]["packed"] = packed_times[name]
    return times, wide


def profile_train_step(step, state, batch,
                       ours=TRAIN_KERNELS[torch.bfloat16]):
    """torch.profiler over one train step: device busy share of the wall
    time, the top kernels, and the check that attention ran in the port's
    kernels ``ours`` (forward, dq, dkv) and in no library attention kernel.
    Returns the names of the kernels that ran, joined."""
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
    for kernel in ours:
        if kernel not in names:
            raise AssertionError(f"the step ran no {kernel} kernel")
    shares = {kernel: sum(e.self_device_time_total for e in device
                          if kernel in e.key) for kernel in ours}
    print("  attention kernels' device time: " + ", ".join(
        f"{kernel} {us:.0f} us ({100 * us / busy:.1f}%)"
        for kernel, us in shares.items()) + f"; K2 (dq + dkv) "
        f"{100 * (shares[ours[1]] + shares[ours[2]]) / busy:.1f}% of "
        f"the busy time", flush=True)
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


def train_config(torch_nn, train, att, name, ctx, batch, accum, make_opt,
                 dtype=torch.bfloat16):
    """One training configuration at full width, its parameters in
    ``dtype``: 2 warm-up steps, 5 timed steps (CUDA events) whose launch
    counts are returned, 10 steps on one batch of SURVEY.md's bytes (the
    loss must fall), one profiled step and the optimizer's device time.
    ``make_opt(model)`` builds the optimizer. In float32 the first loss is
    checked against the same model and batch through plain attention
    (mha_reference, the whole score matrix)."""
    from lamp_tpu_torch.nn import transformer

    dev = torch.device("cuda")
    text = np.frombuffer((Path(__file__).resolve().parent / "SURVEY.md")
                         .read_bytes(), np.uint8)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = torch_nn.LanguageModelModule.init(
        vocab_size=LM_VOCAB, context_length=ctx, num_blocks=LM_BLOCKS,
        embed_dim=LM_DIM, attention_heads=LM_HEADS, generator=gen,
        dtype=dtype, device=dev)
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
    if dtype == torch.float32:
        # the first micro-batch's loss through the kernels and through
        # plain attention: both in f32, apart by summation order only
        first = (data[0][0], data[1][0]) if accum > 1 else data
        with torch.no_grad():
            got = float(loss_fn(model, first, None, False)[0])
            kernel = transformer.flash_attention
            transformer.flash_attention = (
                lambda q, k, v, **kw: att.mha_reference(
                    q, k, v, causal=kw["causal"]))
            try:
                want = float(loss_fn(model, first, None, False)[0])
            finally:
                transformer.flash_attention = kernel
        print(f"  {name}: first loss {got:.6f}, with plain attention "
              f"{want:.6f} (|diff| {abs(got - want):.2e}, limit 1e-4)",
              flush=True)
        if not abs(got - want) <= 1e-4:
            raise AssertionError(f"{name}: loss {got} against plain {want}")
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
    names = profile_train_step(step, state, data, TRAIN_KERNELS[dtype])
    opt_ms = optimizer_device_ms(opt)
    print(f"  {name}: one {type(opt).__name__} step {opt_ms * 1e3:.1f} us "
          f"of device time", flush=True)
    del model, opt, state
    return dict(ms=ms, tok_s=tok_s, peak_gib=peak, launches=launches,
                optimizer_ms=opt_ms, n_params=n_params, kernels=names)


def run_train_config(torch_nn, optim, train, att, config):
    """One of TRAIN_CONFIGS through train_config, with the example's AdamW
    (autoregressivelm.py:93-107) under accumulation, else bench.py:230's."""
    from lamp_tpu_torch.nn.module import param_tags

    name, ctx, batch, accum, dtype = config
    if accum > 1:
        def make_opt(model):
            return optim.AdamW(
                model.named_parameters(), 3e-4, beta2=0.95, clip=1.0,
                weight_decay=lambda tag: 0.0 if (
                    "bias" in tag or "LayerNorm" in tag or "scale" in tag
                    or "Embedding" in tag) else 0.01,
                tags=param_tags(model))
    else:
        def make_opt(model):
            return optim.AdamW(model.named_parameters(), 3e-4,
                               weight_decay=0.01)
    return train_config(torch_nn, train, att, name, ctx, batch, accum,
                        make_opt, dtype)


def phase_train(torch_nn, optim, train, att):
    """Every training configuration at full width; returns the kernels'
    launches over the timed steps by parameter dtype ({dtype: (forward,
    backward)}) and the bf16 flagship's figures."""
    launches = {}
    flagship = None
    for config in TRAIN_CONFIGS:
        run = run_train_config(torch_nn, optim, train, att, config)
        dtype = config[-1]
        fwd, bwd = launches.get(dtype, (0, 0))
        launches[dtype] = (fwd + run["launches"]["flash_attention"],
                           bwd + run["launches"]["flash_attention_backward"])
        if config[0] == "flagship":
            flagship = run
    return launches, flagship


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


def check_int4(Q, name, k, n, g, rows, gen, path_out):
    """K7 against its plain version at one weight shape: every row count of
    ``rows`` in bf16 x (bf16 and f32 out) and, at M <= 64, f32 x; each
    within K7_TOL, a planted dropped scale row above it, and at
    K7_BITS_ROWS two calls (of int4_mm_decode at M <= 64, of int4_mm_tc
    above) equal bit for bit. Returns
    the packed weight, its scales, the largest error by out dtype, the
    smallest planted fault, and the largest absolute error at M=DECODE_B in
    the path's dtypes."""
    dev = torch.device("cuda")
    w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
    p, s = Q.quantize_int4(w, group_size=g)
    faulty = s.clone()
    faulty[1] = 0.0  # the planted fault: group 1's scale row dropped
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    least_fault = math.inf
    path_err = 0.0
    for m in rows:
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
            if m in K7_BITS_ROWS and xd == torch.bfloat16 and not \
                    torch.equal(_bits(got), _bits(Q.int4_matmul(
                        x, p, s, out_dtype=od))):
                raise AssertionError(f"int4_matmul {name} M={m} out {od}: "
                                     f"two calls differ")
            worst[od] = max(worst[od], err)
            least_fault = min(least_fault, fault)
            if m == DECODE_B and xd == torch.bfloat16 and od == path_out:
                path_err = max(path_err, float(
                    (got.float() - want.float()).abs().max()))
    return p, s, worst, least_fault, path_err


def graph_checked(fn, name, what, calls=50):
    """The device time a call of ``fn(i)`` by CUDA events over a CUDA
    graph's replay (:func:`graph_ms`), held against the profiler's sum of
    the kernels whose names hold ``name`` (every kernel for ``name`` None)
    over ``calls`` eager calls: a trace reading below 0.8 of the graph's
    time lost records and is taken again, up to twice. Prints both;
    returns (graph ms, profiler ms, the trace's times by kernel)."""
    ms = graph_ms(fn)
    for attempt in range(3):
        times = device_ms(lambda: fn(0), calls)
        prof = _kernel_ms(times, name) if name else sum(times.values())
        agree = prof >= 0.8 * ms
        print(f"  {what}: graph {ms * 1e3:.2f} us a call, profiler "
              f"{prof * 1e3:.2f} us ({prof / ms:.3f})"
              + ("" if agree else f", below 0.8 (trace {attempt + 1} of 3)"),
              flush=True)
        if agree:
            break
    return ms, prof, times


def time_int4_route(Q, name, p, s, x, path_out, kernel, w_lib):
    """One K7 route's call int4_matmul(x, p, s) timed by graph_checked (the
    trace must hold ``kernel`` and no other int4 kernel), with a call's
    allocations beside its output (none allowed), its bound (bytes: x,
    the packed weight, its scales and the output once; operations: 2 M K
    N at the tensor cores' bf16 rate, or at the f32 rate outside them for
    f32 x), its plain version and F.linear(x, w_lib) timed alike. Returns
    the figures."""
    m, k = x.shape
    n = p.shape[1]
    ms, prof, times = graph_checked(
        lambda i: Q.int4_matmul(x, p, s, out_dtype=path_out), "int4_mm",
        f"int4_matmul {name} M={m}")
    names = sorted(key for key in times if "int4_mm" in key)
    if not names or any(kernel not in key for key in names):
        raise AssertionError(f"int4_matmul {name} M={m}: kernels {names}, "
                             f"want {kernel} alone")
    # one allocation a call, its output's (a count of the caching
    # allocator's requests: a reused cached block can be larger than the
    # request, so bytes would not say it)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    y = Q.int4_matmul(x, p, s, out_dtype=path_out)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    if allocs != 1:
        raise AssertionError(f"int4_matmul {name} M={m}: a call made "
                             f"{allocs} allocations, want its output's")
    del y
    plain = sum(device_ms(lambda: Q.int4_matmul_reference(x, p, s).to(
        path_out), 3).values())
    lib, lib_prof, _ = graph_checked(
        lambda i: torch.nn.functional.linear(x, w_lib), None,
        f"F.linear {name} M={m}")
    nbytes = (p.numel() + s.numel() * 4 + x.numel() * x.element_size()
              + m * n * (4 if path_out == torch.float32 else 2))
    rate = PEAK_FLOPS if x.dtype == torch.bfloat16 else PEAK_FLOPS_F32
    by, fl = nbytes / PEAK_BYTES, 2 * m * k * n / rate
    g = k // s.shape[0]
    plan = (list(Q._int4_plan(m, n, k // 2, g, x.device))
            if kernel != "int4_mm_scalar" else [0, 0, 0])
    print(f"  int4_matmul {name:6} M={m}: {kernel} {ms * 1e3:8.2f} us, "
          f"bound {max(by, fl) * 1e6:7.2f} us "
          f"({'bytes' if by >= fl else 'operations'}), plain "
          f"{plain * 1e3:9.2f} us, F.linear {lib * 1e3:7.2f} us "
          f"({ms / lib:.2f}x); plan {plan}", flush=True)
    return dict(ms=ms, profiler_ms=prof, plain_ms=plain, library_ms=lib,
                library_profiler_ms=lib_prof, bound_ms=max(by, fl) * 1e3,
                bound_by="bytes" if by >= fl else "operations", plan=plan)


def phase_quant_kernels(Q):
    """K7 and K8 against their plain versions at the serving configuration's
    shapes and K7's edges, and their device times; returns the
    kernels-line figures."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    least_fault = math.inf
    path_err = 0.0
    per_call = {}
    for name, k, n, g in K7_EDGES:
        _, _, w_edge, f_edge, _ = check_int4(Q, name, k, n, g, K7_ROWS,
                                             gen, torch.bfloat16)
        print(f"  int4_matmul {name} K={k} N={n} g={g}: M in {K7_ROWS} "
              f"within the limits (largest {max(w_edge.values()):.3e}), "
              f"planted fault at least {f_edge:.3e}, two calls bit for bit "
              f"at M in {K7_BITS_ROWS}; plans (tile, cluster, rows) "
              f"{Q._int4_plan(DECODE_B, n, k // 2, g, dev)} at M="
              f"{DECODE_B}, {Q._int4_plan(SPEC_ROWS, n, k // 2, g, dev)} at "
              f"M={SPEC_ROWS}", flush=True)
        for od in worst:
            worst[od] = max(worst[od], w_edge[od])
        least_fault = min(least_fault, f_edge)
    for name, k, n, per_step in K7_SHAPES:
        path_out = torch.float32 if name == "logits" else torch.bfloat16
        p, s, w_shape, f_shape, e_shape = check_int4(
            Q, name, k, n, Q.int4_group_size(k), K7_ROWS, gen, path_out)
        for od in worst:
            worst[od] = max(worst[od], w_shape[od])
        least_fault = min(least_fault, f_shape)
        path_err = max(path_err, e_shape)
        # device times at the decode batch, in the path's dtypes: by CUDA
        # events over a graph of back-to-back calls, warm (one weight, held
        # in L2) and cold (copies beyond L2), the profiler held against it
        x = torch.randn(DECODE_B, k, generator=gen, device=dev).bfloat16()
        copies = max(1, min(GRAPH_CALLS, -(-COLD_BYTES // (
            p.numel() + 4 * s.numel()))))
        weights = [(p, s)] + [(p.clone(), s.clone())
                              for _ in range(copies - 1)]
        w_deq = Q.dequantize_int4(p, s).t().contiguous()  # [N, K] bf16
        dec = time_int4_route(Q, name, p, s, x, path_out, "int4_mm_decode",
                              w_deq)
        ms, prof, plain, lib = (dec[key] for key in (
            "ms", "profiler_ms", "plain_ms", "library_ms"))
        ms_cold = graph_ms(lambda i: Q.int4_matmul(
            x, *weights[i % copies], out_dtype=path_out))
        lin = [w_deq] + [w_deq.clone() for _ in range(max(0, min(
            GRAPH_CALLS, -(-COLD_BYTES // (2 * k * n))) - 1))]
        lib_cold = graph_ms(lambda i: torch.nn.functional.linear(
            x, lin[i % len(lin)]))
        # the row-tiled kernel (int4_mm_tc) at phase 14's rows, and qkv and
        # the logits at an LM forward's
        tc = {SPEC_ROWS: time_int4_route(
            Q, name, p, s, torch.randn(SPEC_ROWS, k, generator=gen,
                                       device=dev).bfloat16(),
            path_out, "int4_mm_tc", w_deq)}
        if name in ("qkv", "logits"):
            tc[LM_ROWS] = time_int4_route(
                Q, name, p, s, torch.randn(LM_ROWS, k, generator=gen,
                                           device=dev).bfloat16(),
                path_out, "int4_mm_tc", w_deq)
        # the scalar kernel (f32 x) at the decode batch, beside F.linear in
        # f32 on the dequantized f32 weight
        scalar = time_int4_route(
            Q, name, p, s, x.float(), torch.float32, "int4_mm_scalar",
            Q.dequantize_int4(p, s, dtype=torch.float32).t().contiguous())
        # the wrapper's whole call, host launch path included
        events_ms = cuda_time_ms(
            lambda: Q.int4_matmul(x, p, s, out_dtype=path_out), 200)
        per_call[name] = dict(k=k, n=n, per_step=per_step, ms=ms,
                              profiler_ms=prof, cold_ms=ms_cold,
                              plain_ms=plain, library_ms=lib,
                              library_profiler_ms=dec["library_profiler_ms"],
                              library_cold_ms=lib_cold,
                              bound_ms=dec["bound_ms"],
                              bound_by=dec["bound_by"], events_ms=events_ms,
                              plan=dec["plan"],
                              tc={f"M={m}": t for m, t in tc.items()},
                              scalar_f32=scalar)
        print(f"  int4_matmul {name:6} K={k} N={n}: M={DECODE_B} "
              f"{ms * 1e3:7.2f} us (cold {ms_cold * 1e3:.2f}), F.linear "
              f"cold {lib_cold * 1e3:.2f} us; the wrapper by CUDA events "
              f"over back-to-back calls {events_ms * 1e3:.2f} us",
              flush=True)
        del weights, lin, w_deq
        torch.cuda.empty_cache()
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
    # a speculative round's target chunk: the same 61 calls at M=128
    k7["tc_round"] = {key: sum(c["tc"][f"M={SPEC_ROWS}"][key] * c["per_step"]
                               for c in per_call.values())
                      for key in ("ms", "plain_ms", "bound_ms",
                                  "library_ms")}
    print(f"  int4_mm_tc, a speculative round's {calls} calls at "
          f"M={SPEC_ROWS}: {k7['tc_round']['ms'] * 1e3:.1f} us, bound "
          f"{k7['tc_round']['bound_ms'] * 1e3:.1f} us, plain "
          f"{k7['tc_round']['plain_ms'] * 1e3:.1f} us, F.linear "
          f"{k7['tc_round']['library_ms'] * 1e3:.1f} us", flush=True)
    print(f"  int4_matmul, one decode step's {calls} calls at "
          f"B={DECODE_B}: {k7['ms'] * 1e3:.1f} us (profiler "
          f"{step_total('profiler_ms') * 1e3:.1f}, cold "
          f"{step_total('cold_ms') * 1e3:.1f}), bound "
          f"{k7['bound_ms'] * 1e3:.1f} us, plain "
          f"{k7['plain_ms'] * 1e3:.1f} us, F.linear {k7['library_ms'] * 1e3:.1f}"
          f" us (cold {step_total('library_cold_ms') * 1e3:.1f}); the "
          f"wrappers by CUDA events {step_total('events_ms') * 1e3:.1f} us",
          flush=True)
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


K7_PER_STEP = 5 * BLOCKS + 1  # K7 calls per decode step


def serve_int4(model, models, Q, paged_attention):
    """ModernBatchServer(quantize_bits=4) through ServingEngine at full
    width: K7 and K6 launch counts, greedy tokens against the dequantized
    dense model, then the steady decode. Returns (results, greedy ids, K7
    launches, the steady decode's figures)."""
    server = models.ModernBatchServer(model, page_size=PAGE,
                                      total_pages=TOTAL_PAGES,
                                      quantize_bits=4)
    prompts, results, greedy, steps = serve_requests(models, server)
    k7_launches = Q.int4_matmul.launches
    check_launches("int4_matmul", k7_launches, K7_PER_STEP * steps)
    check_launches("paged_attention", paged_attention.launches,
                   BLOCKS * steps)
    check_greedy(quantized_server_reference(model, Q, 4), prompts, results,
                 greedy, QMARGIN)
    torch.cuda.empty_cache()
    decode = steady_decode(models, server, "int4")
    print(f"  steady decode int4: profiled step "
          f"{decode['device_us_per_step']:.1f} us of device time, K7 "
          f"{100 * decode['k7_share']:.1f}% of it", flush=True)
    return results, greedy, k7_launches, decode


def phase_quant_serving(model, models, Q, paged_attention, decode_bf16):
    """Quantized serving at full width through ServingEngine: int4 (greedy
    tokens against the dequantized dense model), int4 with an fp8 KV pool,
    int8 (greedy tokens against a dense forward through int8_matmul); the
    steady decode of each beside bf16."""
    per_step = K7_PER_STEP
    results, greedy, k7_launches, decode_int4 = serve_int4(
        model, models, Q, paged_attention)
    decode = {"bf16": decode_bf16, "int4": decode_int4}

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
              f"{d['device_ops_per_step']:.1f} device ops"
              + (f", K7 {100 * d['k7_share']:.1f}%" if d["k7_share"] else ""),
              flush=True)
    return k7_launches, fp8_launches, decode


# phase 14: speculative decoding on the int4 servers: phase 3's model as
# the target, its first SPEC_DRAFT_BLOCKS blocks (draft_view) as the draft,
# k = SPEC_K, SPEC_BATCH of phase 3's requests (its prompts), greedy, each
# until it has emitted SPEC_TOKENS; then a sampled run at temperature 1.0
SPEC_K, SPEC_DRAFT_BLOCKS, SPEC_BATCH, SPEC_TOKENS = 4, 3, 32, 64
SPEC_SAMPLED_TOKENS = 16
# phase 14, bf16: one advance_chunk's logits against the same tokens fed one
# decode step at a time, by relative Frobenius error. The two run the same
# arithmetic on the same bf16 weights and differ only where bf16 rounds:
# the chunk's K/V rows are read back from the pool where a step injects
# them, and the products run over B*m rows instead of B (other GEMM tilings
# and sum orders), each a relative 2^-9 per rounding, over 12 layers
CHUNK_TOL = 2e-2


def check_layouts(att, paged_attention, Q):
    """The wrappers take any layout: flash_attention (forward and
    backward), paged_attention (q and append_kv) and int4_matmul (x, on
    both kernels' routes) given transposed views and offset slices (2 bytes
    past a 16-byte boundary) give the bits of their contiguous copies."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    def same(what, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(_bits(g.contiguous()), _bits(w.contiguous())):
                raise AssertionError(f"{what}: output {i} differs from the "
                                     f"contiguous copy's")

    # flash attention: q, k, v as [B, S, H, D] projections viewed as
    # [B, H, S, D], and as offset slices, causal, bf16, forward and backward
    b, h, sq, d = 2, LM_HEADS, 200, 64

    def bhsd():
        return torch.randn(b, sq, h, d, generator=gen, device=dev
                           ).bfloat16().transpose(1, 2)

    q, k, v = bhsd(), bhsd(), bhsd()
    do = torch.randn(b, h, sq, d, generator=gen, device=dev).bfloat16()

    def flash(*qkv):
        leaves = [t.detach().requires_grad_() for t in qkv]
        o = att.flash_attention(*leaves, causal=True)
        o.backward(do)
        return [o] + [t.grad for t in leaves]

    want = flash(*(t.contiguous() for t in (q, k, v)))
    same("flash_attention, transposed q, k, v", flash(q, k, v), want)
    same("flash_attention, offset q, k, v",
         flash(*(offset(t.contiguous()) for t in (q, k, v))), want)
    # paged attention at the serving slice's shapes: q [B, H, D] a view of
    # [H, B, D], the appended K/V column slices of a fused projection
    hd, pages = DIM // HEADS, 4
    nkv = KV_HEADS * hd
    pool = torch.randn(8 * pages + 1, 2, PAGE, nkv, generator=gen,
                       device=dev).bfloat16()
    table = torch.arange(1, 8 * pages + 1, device=dev, dtype=torch.int32
                         ).reshape(8, pages)
    lengths = torch.randint(0, pages * PAGE, (8,), generator=gen,
                            device=dev, dtype=torch.int32)
    qt = torch.randn(HEADS, 8, hd, generator=gen, device=dev).bfloat16(
        ).transpose(0, 1)
    fused = torch.randn(8, 3 * nkv, generator=gen, device=dev).bfloat16()
    kn, vn = fused[:, nkv:2 * nkv], fused[:, 2 * nkv:]

    def paged(q, kn, vn):
        return [paged_attention(q, pool, None, table, lengths,
                                num_kv_heads=KV_HEADS, append_kv=(kn, vn))]

    want = paged(qt.contiguous(), kn.contiguous(), vn.contiguous())
    same("paged_attention, transposed q and sliced append_kv",
         paged(qt, kn, vn), want)
    same("paged_attention, offset q and append_kv",
         paged(*(offset(t.contiguous()) for t in (qt, kn, vn))), want)
    # int4_matmul on the decode and the row-tiled routes
    w = torch.randn(DIM, 1280, generator=gen, device=dev) * DIM ** -0.5
    p, sc = Q.quantize_int4(w, group_size=Q.int4_group_size(DIM))
    for m in (DECODE_B, SPEC_ROWS):
        xt = torch.randn(DIM, m, generator=gen, device=dev).bfloat16().t()
        want = [Q.int4_matmul(xt.contiguous(), p, sc)]
        same(f"int4_matmul M={m}, transposed x", [Q.int4_matmul(xt, p, sc)],
             want)
        same(f"int4_matmul M={m}, offset x",
             [Q.int4_matmul(offset(xt.contiguous()), p, sc)], want)
    print("  layouts: flash_attention (forward and backward), "
          "paged_attention and int4_matmul (M=32, 128) given transposed "
          "views and offset slices give their contiguous copies' bits",
          flush=True)


def spec_prompts():
    """Phase 3's first SPEC_BATCH prompts (24-31 tokens)."""
    rng = np.random.RandomState(0)
    return {f"r{i}": rng.randint(0, VOCAB, 24 + i % 8).tolist()
            for i in range(SPEC_BATCH)}


def run_speculative(spec, prompts, tokens):
    """Every prompt through ``spec`` until each request has emitted
    ``tokens``, the whole batch in every round (so that each target chunk
    has SPEC_BATCH x k rows), every launch count set to 0 just before.
    Checks that 1 to k tokens come out a round. Returns (the emitted
    tokens, rounds, rounds x sequences that accepted every proposal, wall
    seconds)."""
    for rid, p in prompts.items():
        spec.add(rid, p)
    out = {rid: [] for rid in prompts}
    rounds = full = 0
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while min(len(v) for v in out.values()) < tokens:
        for rid, toks in spec.step().items():
            if not 1 <= len(toks) <= spec.k or not all(
                    0 <= t < VOCAB for t in toks):
                raise AssertionError(f"{rid}: a round emitted {toks}")
            full += len(toks) == spec.k
            out[rid] += toks
        rounds += 1
    torch.cuda.synchronize()
    return out, rounds, full, time.perf_counter() - t0


def phase_speculative(torch_nn, models, Q, paged_attention):
    """Phase 14: speculative decoding at full width on the int4 servers
    (greedy, then sampled), and a bf16 chunk against single steps.
    Returns the figures."""
    import functools

    model = make_serving_model(torch_nn)
    draft = models.draft_view(model, SPEC_DRAFT_BLOCKS)
    prompts = spec_prompts()
    ids = list(prompts)
    # bf16: one chunk against the same tokens one step at a time
    servers = [models.ModernBatchServer(model, page_size=PAGE,
                                        total_pages=TOTAL_PAGES)
               for _ in range(2)]
    for server in servers:
        for rid, p in prompts.items():
            server.add(rid, p)
    toks = np.random.RandomState(1).randint(0, VOCAB, (SPEC_BATCH, SPEC_K))
    chunk = servers[0].advance_chunk(ids, toks)
    steps = torch.stack([servers[1]._advance(ids, torch.as_tensor(
        toks[:, j], device="cuda")) for j in range(SPEC_K)], dim=1)
    chunk_err = rel_err(chunk, steps)
    print(f"  bf16 advance_chunk of {SPEC_BATCH} x {SPEC_K} tokens against "
          f"{SPEC_K} single steps: relative error {chunk_err:.3e} (limit "
          f"{CHUNK_TOL:.0e})", flush=True)
    if not chunk_err <= CHUNK_TOL:
        raise AssertionError("the chunk's logits differ from the steps'")
    del servers, chunk, steps
    torch.cuda.empty_cache()

    int4 = functools.partial(models.ModernBatchServer, quantize_bits=4)
    spec = models.SpeculativeDecoder(model, draft, k=SPEC_K,
                                     server_cls=int4, page_size=PAGE,
                                     total_pages=TOTAL_PAGES)
    free0 = (len(spec.target.free_pages), len(spec.draft.free_pages))
    out, rounds, full, wall = run_speculative(spec, prompts, SPEC_TOKENS)
    counts = launch_counts()
    emitted = sum(len(v) for v in out.values())
    draft_calls = (SPEC_K - 1) * rounds + full  # the draft's decode steps
    tc_launches = counts["int4_mm_tc"]
    check_launches("int4_mm_tc (the target's chunks)", tc_launches,
                   K7_PER_STEP * rounds)
    check_launches("int4_mm_decode (the draft's steps)",
                   counts["int4_matmul"] - tc_launches,
                   (5 * SPEC_DRAFT_BLOCKS + 1) * draft_calls)
    check_launches("paged_attention", counts["paged_attention"],
                   BLOCKS * rounds + SPEC_DRAFT_BLOCKS * draft_calls)
    per_seq = emitted / (rounds * SPEC_BATCH)
    print(f"  greedy: {rounds} rounds, {emitted} tokens emitted in "
          f"{wall:.2f} s ({emitted / wall:.1f} tok/s), {per_seq:.3f} a "
          f"sequence a round ({per_seq - 1:.3f} accepted proposals), every "
          f"proposal accepted in {full} of {rounds * SPEC_BATCH}",
          flush=True)
    results = {rid: v[:SPEC_TOKENS] for rid, v in out.items()}
    check_greedy(quantized_server_reference(model, Q, 4), prompts, results,
                 ids, QMARGIN)
    with traced() as trace:
        spec.step()
    busy = sum(e.self_device_time_total for e in trace.events)
    ops = sum(e.count for e in trace.events)
    tc_us = sum(e.self_device_time_total for e in trace.events
                if "int4_mm_tc" in e.key)
    print(f"  a profiled round: {busy:.1f} us of device time, {ops} device "
          f"ops, int4_mm_tc {tc_us:.1f} us ({100 * tc_us / busy:.1f}%)",
          flush=True)
    for rid in ids:
        spec.remove(rid)
    if (len(spec.target.free_pages), len(spec.draft.free_pages)) != free0:
        raise AssertionError("a page pool did not return to its start")
    del spec
    torch.cuda.empty_cache()

    spec = models.SpeculativeDecoder(model, draft, k=SPEC_K,
                                     server_cls=int4, page_size=PAGE,
                                     total_pages=TOTAL_PAGES,
                                     temperature=1.0, seed=1)
    free0 = (len(spec.target.free_pages), len(spec.draft.free_pages))
    out_s, rounds_s, _, wall_s = run_speculative(spec, prompts,
                                                 SPEC_SAMPLED_TOKENS)
    for rid in ids:
        spec.remove(rid)
    if (len(spec.target.free_pages), len(spec.draft.free_pages)) != free0:
        raise AssertionError("a page pool did not return to its start "
                             "(sampled)")
    emitted_s = sum(len(v) for v in out_s.values())
    print(f"  sampled (temperature 1.0): {rounds_s} rounds, {emitted_s} "
          f"tokens in {wall_s:.2f} s, {emitted_s / (rounds_s * SPEC_BATCH):.3f}"
          f" a sequence a round; the pools back at their start", flush=True)
    return dict(rounds=rounds, emitted=emitted, tok_s=emitted / wall,
                per_seq_round=per_seq, tc_launches=tc_launches,
                round_device_us=busy, round_ops=ops,
                tc_share=tc_us / busy, chunk_err=chunk_err)


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
    name, ctx, batch, accum, _ = TRAIN_CONFIGS[0]
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


# phase 4: MultiheadAttention at the head dims of the JAX package's other
# examples: (name, width, heads, blocks, vocab, context), bert.py's
# defaults (head_dim 32) and translation.py's (head_dim 16); then head dims
# the instances of 32, 64 and 128 do not hold: 100 (OpenLLaMA-3B's, not a
# multiple of 8: the ragged forward) and 256 (Gemma's: the D=256 forward),
# both with the mma.sync backward; and a model in f32, the dtype of the JAX
# package's CPU tests (the scalar kernels)
SMALL_HEAD_MODELS = (("bert width", 128, 4, 4, 8192, 128),
                     ("translation width", 64, 4, 2, 32, 64),
                     ("head_dim 100", 400, 4, 2, 256, 256),
                     ("head_dim 256", 512, 2, 2, 256, 256),
                     ("f32, head_dim 64", 256, 4, 2, 256, 256))


def check_small_heads(torch_nn, optim, train):
    """A GPT LanguageModelModule at each SMALL_HEAD_MODELS width takes 3
    training steps on the card (bf16 with f32 AdamW masters; the last in
    f32): finite losses, and each step's blocks launch the flash-attention
    kernels (their head dims ran on CPU only before). Returns the
    (forward, backward) launches by model."""
    dev = torch.device("cuda")
    by_model = {}
    for name, dim, heads, blocks, vocab, ctx in SMALL_HEAD_MODELS:
        dtype = torch.float32 if name.startswith("f32") else torch.bfloat16
        gen = torch.Generator(device=dev).manual_seed(0)
        model = torch_nn.LanguageModelModule.init(
            vocab_size=vocab, context_length=ctx, num_blocks=blocks,
            embed_dim=dim, attention_heads=heads, generator=gen,
            dtype=dtype, device=dev)
        opt = optim.AdamW(model.named_parameters(), 1e-3)

        def loss_fn(m, b, generator, train_mode):
            logits = m(b[0], train=train_mode, generator=generator)
            return torch_nn.lm_loss(logits, b[1]), b[0].shape[0]

        step = train.make_train_step(opt, loss_fn)
        state = train.TrainState.init(model, opt)
        rng = np.random.RandomState(0)
        tokens = torch.as_tensor(rng.randint(0, vocab, (8, ctx)), device=dev)
        batch = (tokens, torch.roll(tokens, -1, dims=-1))
        reset_launch_counts()
        losses = [float(step(state, batch)[1][0]) for _ in range(3)]
        launches = launch_counts()
        got = (launches["flash_attention"],
               launches["flash_attention_backward"])
        if got != (3 * blocks, 3 * blocks):
            raise AssertionError(f"{name}: launches {got}, want "
                                 f"{3 * blocks} each")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: a loss is not finite: {losses}")
        print(f"  {name}: {dim} wide, {heads} heads (head_dim "
              f"{dim // heads}), {blocks} blocks, ctx {ctx}: 3 steps, "
              f"losses {' '.join(f'{x:.4f}' for x in losses)}; launches "
              f"fwd {got[0]} bwd {got[1]}", flush=True)
        by_model[name] = got
        del model, opt, state
    return by_model


def phase_packed(torch_nn, optim, train, att):
    """Packed-document ModernLM training at full width: the serving
    configuration's model (12 blocks, 768 wide, 12/4 heads, SwiGLU 2048,
    vocab 32000, tied) at context 2048, bf16 with f32 AdamW masters, 4
    packed rows a step through ModernLM.loss (segment ids to the flash
    kernels, per-document RoPE positions, the fused cross-entropy). Checks
    the first loss against the same model with plain attention, then runs
    2 warm-up and 5 timed steps (CUDA events; K1/K2 launches 12 a step),
    10 steps on one batch (the loss must fall) and one profiled step, and
    prints peak memory beside the f32 scores mha_reference would keep.
    Returns the timed steps' launches and figures."""
    from lamp_tpu_torch.nn import modern

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = torch_nn.ModernLM.init(
        vocab_size=VOCAB, context_length=PACK_CTX, num_blocks=BLOCKS,
        embed_dim=DIM, num_heads=HEADS, num_kv_heads=KV_HEADS,
        generator=gen, dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    opt = optim.AdamW(model.named_parameters(), 3e-4, weight_decay=0.01)
    state = train.TrainState.init(model, opt)
    step = train.make_train_step(opt, train.packed_lm_loss)

    def to_batch(p):
        return (torch.as_tensor(p["tokens"], device=dev).long(),
                torch.as_tensor(p["targets"], device=dev).long(),
                torch.as_tensor(p["segment_ids"], device=dev),
                torch.as_tensor(p["positions"], device=dev).long())

    batches = [to_batch(packed_batch(seed)) for seed in range(7)]
    tokens = PACK_BATCH * PACK_CTX
    targets = int((batches[0][1] != -100).sum())
    # the first loss against the same weights with plain attention (the
    # whole score matrix, mha_reference): the kernels' path is right
    with torch.no_grad():
        got = float(model.loss(*batches[0][:2], segment_ids=batches[0][2],
                               positions=batches[0][3]))
        kernel = modern.flash_attention
        modern.flash_attention = (
            lambda q, k, v, **kw: att.mha_reference(q, k, v, **kw))
        try:
            want = float(model.loss(*batches[0][:2],
                                    segment_ids=batches[0][2],
                                    positions=batches[0][3]))
        finally:
            modern.flash_attention = kernel
    print(f"  packed: first loss {got:.5f}, with plain attention "
          f"{want:.5f} (|diff| {abs(got - want):.2e}, limit 2e-2: bf16 "
          f"activations rounded at other places)", flush=True)
    if not abs(got - want) <= 2e-2:
        raise AssertionError(f"packed: loss {got} against plain {want}")
    losses = [step(state, b)[1][0] for b in batches[:2]]
    # the main path's run: the launch counts cover exactly these steps
    reset_launch_counts()
    steps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches[2:2 + steps]:
        losses.append(step(state, b)[1][0])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    launches = launch_counts()
    got = (launches["flash_attention"], launches["flash_attention_backward"])
    if got != (BLOCKS * steps, BLOCKS * steps):
        raise AssertionError(f"packed: launches {got}, want "
                             f"{BLOCKS * steps} each")
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError(f"packed: a loss is not finite: {losses}")
    tok_s = tokens / (ms * 1e-3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    scores = PACK_BATCH * HEADS * PACK_CTX ** 2 * 4 * BLOCKS / 2**30
    print(f"  packed: ctx {PACK_CTX}, {PACK_BATCH} rows ({tokens} tokens, "
          f"{targets} with a target), {n_params} params, AdamW: "
          f"{ms:.2f} ms/step, {tok_s:.1f} train tok/s; launches fwd "
          f"{got[0]} bwd {got[1]} (12 x {steps}); peak memory {peak:.2f} "
          f"GiB (mha_reference would keep {scores:.2f} GiB of f32 scores "
          f"[B, H, T, T] for the backward alone)", flush=True)
    fixed = [step(state, batches[0])[1][0] for _ in range(10)]
    first, last = float(fixed[0]), float(fixed[-1])
    print(f"  packed: 10 steps on one batch: loss {first:.4f} -> "
          f"{last:.4f}", flush=True)
    if not last < first:
        raise AssertionError("packed: loss did not fall on one batch")
    profile_train_step(step, state, batches[1])
    del model, opt, state
    return dict(ms=ms, tok_s=tok_s, peak_gib=peak, launches=launches)


def train_at_width(label, config, rows, ours, torch_nn, optim, train, att):
    """A ModernLM of ``config`` (ModernLM.init's keywords: context_length,
    widths, heads) trained in bf16 with f32 AdamW masters (3e-4, weight
    decay 0.01), ``rows`` rows of seeded tokens a step through
    ModernLM.loss (the fused cross-entropy) and plain causal attention:
    the first loss against the same weights with plain attention (within
    2e-2), 2 warm-up and 5 timed steps (CUDA events; the forward and the
    backward launched once a block a step), finite losses, the loss
    falling over 10 steps on one batch, a profiled step (device busy
    share, the attention kernels ``ours``' shares, no library attention
    kernel) and the peak memory. Prints under ``label``; returns the timed
    steps' launches and figures."""
    from lamp_tpu_torch.nn import modern

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = torch_nn.ModernLM.init(generator=gen, dtype=torch.bfloat16,
                                   device=dev, **config)
    n_params = sum(p.numel() for p in model.parameters())
    opt = optim.AdamW(model.named_parameters(), 3e-4, weight_decay=0.01)
    state = train.TrainState.init(model, opt)

    def loss_fn(m, batch, generator, train_mode):
        return m.loss(batch[0], batch[1]), batch[1].numel()

    step = train.make_train_step(opt, loss_fn)
    ctx, vocab = config["context_length"], config["vocab_size"]

    def batch_of(seed):
        rng = np.random.RandomState(seed)
        tokens = torch.as_tensor(rng.randint(0, vocab, (rows, ctx + 1)),
                                 device=dev)
        return tokens[:, :-1], tokens[:, 1:]

    batches = [batch_of(seed) for seed in range(7)]
    blocks = config["num_blocks"]
    # the first loss against the same weights with plain attention (the
    # whole score matrix, mha_reference): the kernels' path is right
    with torch.no_grad():
        got = float(model.loss(*batches[0]))
        kernel = modern.flash_attention
        modern.flash_attention = (
            lambda q, k, v, **kw: att.mha_reference(q, k, v, **kw))
        try:
            want = float(model.loss(*batches[0]))
        finally:
            modern.flash_attention = kernel
    print(f"  {label}: first loss {got:.5f}, with plain attention "
          f"{want:.5f} (|diff| {abs(got - want):.2e}, limit 2e-2: bf16 "
          f"activations rounded at other places)", flush=True)
    if not abs(got - want) <= 2e-2:
        raise AssertionError(f"{label}: loss {got} against plain {want}")
    losses = [step(state, b)[1][0] for b in batches[:2]]
    # the main path's run: the launch counts cover exactly these steps
    reset_launch_counts()
    steps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches[2:2 + steps]:
        losses.append(step(state, b)[1][0])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    launches = launch_counts()
    got = (launches["flash_attention"], launches["flash_attention_backward"])
    if got != (blocks * steps, blocks * steps):
        raise AssertionError(f"{label}: launches {got}, want "
                             f"{blocks * steps} each")
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    tok_s = rows * ctx / (ms * 1e-3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    heads, kv_heads = config["num_heads"], config["num_kv_heads"]
    print(f"  {label}: {blocks} x {config['embed_dim']}, {heads}/{kv_heads} "
          f"heads of {config['embed_dim'] // heads}, SwiGLU "
          f"{config['mlp_hidden']}, vocab {vocab}, {n_params} params, ctx "
          f"{ctx}, {rows} rows: {ms:.2f} ms/step, {tok_s:.1f} train tok/s, "
          f"{100 * tok_s * 6 * n_params / PEAK_FLOPS:.1f}% of 989 TFLOP/s "
          f"by 6 N; launches fwd {got[0]} bwd {got[1]} ({blocks} x "
          f"{steps}); peak memory {peak:.2f} GiB", flush=True)
    fixed = [step(state, batches[0])[1][0] for _ in range(10)]
    first, last = float(fixed[0]), float(fixed[-1])
    print(f"  {label}: 10 steps on one batch: loss {first:.4f} -> "
          f"{last:.4f}", flush=True)
    if not last < first:
        raise AssertionError(f"{label}: loss did not fall on one batch")
    profile_train_step(step, state, batches[1], ours)
    del model, opt, state
    torch.cuda.empty_cache()
    return dict(ms=ms, tok_s=tok_s, peak_gib=peak, launches=launches)


def phase_gemma(torch_nn, optim, train, att):
    """Phase 12: a ModernLM at Gemma-2B's widths (GEMMA) trained at
    context GEMMA_CTX, GEMMA_ROWS rows a step (train_at_width): fwd_wg's
    D=256 instance, dq_wide and dkv_wide."""
    return train_at_width("gemma widths",
                          dict(GEMMA, context_length=GEMMA_CTX), GEMMA_ROWS,
                          GEMMA_KERNELS, torch_nn, optim, train, att)


def phase_openllama_train(torch_nn, optim, train, att,
                          ours=OPENLLAMA_KERNELS):
    """Phase 13: OpenLLaMA-3B at full width (phase 11's model: 26 x 3200,
    32 heads of 100, SwiGLU 8640, vocab 32000, untied) trained at context
    OL_CTX, OPENLLAMA_TRAIN_ROWS rows a step (train_at_width), after the
    check that head_dim 100 routes to the ragged instances; ``ours``: the
    kernels its profiled step must have run."""
    for part in ("fwd", "dq", "dkv"):
        got = flash_instance(OL_HEAD_DIM, torch.bfloat16, part)
        if got != f"{part}_ragged":
            raise AssertionError(f"openllama train: head_dim {OL_HEAD_DIM} "
                                 f"routes {part} to {got}")
    config = dict(vocab_size=VOCAB, context_length=OL_CTX,
                  num_blocks=OL_BLOCKS, embed_dim=OL_DIM, num_heads=OL_HEADS,
                  num_kv_heads=OL_HEADS, mlp_hidden=OL_MLP, tied=False,
                  rope_base=10000.0, norm_eps=1e-6)
    return train_at_width("openllama train", config, OPENLLAMA_TRAIN_ROWS,
                          ours, torch_nn, optim, train, att)


def kernel_line(source, kernel):
    """``csrc/<source>:<line>`` of the line that opens ``kernel``'s
    definition (its name followed by its parameter list)."""
    path = Path(__file__).resolve().parent / "lamp_tpu_torch" / "csrc" / source
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if line.startswith(f"{kernel}("):
            return f"lamp_tpu_torch/csrc/{source}:{i}"
    raise AssertionError(f"no definition of {kernel} in {source}")


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
    flash, flash_wide = phase_flash(att)
    small_by_model = check_small_heads(torch_nn, optim, train)
    print("phase 5: training slice at full width", flush=True)
    train_launches, flagship = phase_train(torch_nn, optim, train, att)
    fwd_launches, bwd_launches = train_launches[torch.bfloat16]
    print("phase 6: int4 matmul and stochastic int8 kernels vs plain",
          flush=True)
    k7, k8 = phase_quant_kernels(Q)
    check_layouts(att, paged_attention, Q)
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
    print("phase 10: packed-document ModernLM training at full width",
          flush=True)
    packed = phase_packed(torch_nn, optim, train, att)
    print("phase 11: OpenLLaMA-3B serving at full width (head_dim 100)",
          flush=True)
    openllama = phase_openllama(torch_nn, models, paged_attention, att)
    print("phase 12: a ModernLM at Gemma-2B's widths (head_dim 256) "
          "trained in bf16 at context 2048", flush=True)
    gemma = phase_gemma(torch_nn, optim, train, att)
    print("phase 13: OpenLLaMA-3B (head_dim 100) trained in bf16 at context "
          "2048", flush=True)
    ol_train = phase_openllama_train(torch_nn, optim, train, att)
    print("phase 14: speculative decoding on the int4 servers at full "
          "width", flush=True)
    spec = phase_speculative(torch_nn, models, Q, paged_attention)
    k7["launches"] += spec["tc_launches"]
    # the tensor-core instances' launches: phase 5, phase 10 and the bert-
    # and translation-width models; the head_dim 100 and 256 models run
    # the new instances (the ragged forward at 100, the scalar kernels)
    tc_models = [small_by_model[m] for m in ("bert width",
                                             "translation width")]
    fwd_launches += sum(g[0] for g in tc_models) + \
        packed["launches"]["flash_attention"]
    bwd_launches += sum(g[1] for g in tc_models) + \
        packed["launches"]["flash_attention_backward"]
    # the new instances' launches (flash_instance): the ragged forward runs
    # the head_dim 100 GPT, phase 11's dense check and phase 13, the D=256
    # forward the head_dim 256 GPT and phase 12, the ragged backward the
    # head_dim 100 GPT and phase 13, the wide backward phase 12 (the
    # head_dim 256 GPT's are in the note), and the scalar kernels phase 5's
    # f32 flagship (the small f32 GPT's are in the note)
    d100, d256, f32 = (small_by_model[m] for m in (
        "head_dim 100", "head_dim 256", "f32, head_dim 64"))
    f32_fwd, f32_bwd = train_launches[torch.float32]
    g_fwd, g_bwd = (gemma["launches"][k] for k in (
        "flash_attention", "flash_attention_backward"))
    o_fwd, o_bwd = (ol_train["launches"][k] for k in (
        "flash_attention", "flash_attention_backward"))
    wide_launches = {"fwd_ragged": openllama["k1"] + d100[0] + o_fwd,
                     "fwd_wg": d256[0] + g_fwd, "dq_ragged": d100[1] + o_bwd,
                     "dkv_ragged": d100[1] + o_bwd, "dq_wide": g_bwd,
                     "dkv_wide": g_bwd, "fwd_any": f32_fwd,
                     "dq_any": f32_bwd, "dkv_any": f32_bwd}

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    paged_src = dict(route="cuda",
                     source="lamp_tpu_torch/csrc/paged_attention.cu",
                     replaces="lamp_tpu/ops/paged_attention.py:151")
    paged["any"]["launches"] = openllama["k6"]
    paged["any_fp8"]["launches"] = openllama["k6_fp8"]
    rows = [{k: r[k] for k in keys} for r in (
        dict(name="paged_attention", **paged_src, **paged["bf16"]),
        dict(name="paged_attention_fp8", **paged_src, **paged["fp8"]),
        dict(name="paged_attention_any", **paged_src, **paged["any"]),
        dict(name="paged_attention_any_fp8", **paged_src,
             **paged["any_fp8"]))]
    rows[0]["note"] = (
        "paged_attention_fixed (head_dim 64 or 128, at most 8 query heads a "
        "kv head: 16-key boxes of K and V by TMA into each warp's ring, the "
        "first page's boxes before the length is known, split-KV over a "
        "thread-block cluster summed through distributed shared memory, "
        "mma.sync products for 16-bit q): times at phase 2's call (B=32, "
        "lengths up to 511); decode_call_ms: phase 3's decode call (lengths "
        "56-95, 4 tables x 12 layers in turns, cold) by CUDA events over a "
        "graph; launches: phase 3's 40 requests; fixed_edges: "
        "check_paged_fixed")
    rows[1]["note"] = ("the same on an e4m3 pool; launches: phase 7's fp8-KV "
                       "requests")
    for i, what in ((0, "bf16"), (1, "fp8")):
        for key in ("decode_call_ms", "decode_call_bound_ms", "fixed_edges"):
            if key in paged[what]:
                rows[i][key] = paged[what][key]
    rows[2]["note"] = (
        "paged_attention_any (every head dim and group; split-KV over a "
        "thread-block cluster summed through distributed shared memory; "
        "K/V rows by TMA boxes of 16 rows where the pool's rows are 16-byte "
        "strided, else cp.async pieces; a ring of 1 stage, 2 at 64 or more "
        "query heads a kv head; V written over K once a tile is scored): "
        "times at OpenLLaMA-3B's layer (B=32, 32/32 "
        "heads, head_dim 100, bf16); launches: phase 11's 40 requests; "
        "per_case: phase 2's K6_WIDE, with each case's splits and its "
        "split-edge check")
    rows[2]["per_case"] = paged["any"]["per_case"]
    rows[3]["note"] = ("the same on an e4m3 pool (100-byte head slices); "
                       "launches: phase 11's fp8-pool steady decode")
    replaces = {"flash_attention_fwd": "lamp_tpu/ops/attention.py:87",
                "flash_attention_bwd_dq": "lamp_tpu/ops/attention.py:297",
                "flash_attention_bwd_dkv": "lamp_tpu/ops/attention.py:365"}
    for name, r in flash.items():
        row = dict(
            name=name, route="cuda",
            source="lamp_tpu_torch/csrc/" + ("flash_forward.cu" if name.endswith(
                "fwd") else "flash_attention.cu"),
            replaces=replaces[name],
            launches=fwd_launches if name.endswith("fwd") else bwd_launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"])
        pk = r["packed"]
        row["packed"] = dict(
            note="phase 10's shapes (B=4, H=12, S=2048, D=64, bf16, causal, "
                 "packed segment ids); library: SDPA with the equivalent "
                 "boolean attn_mask; launches: phase 10's 5 timed steps",
            ms=pk["ms"], plain_ms=pk["plain_ms"], bound_ms=pk["bound"][0],
            bound_by=pk["bound"][1], library_ms=pk["library_ms"],
            launches=packed["launches"][
                "flash_attention" if name.endswith("fwd")
                else "flash_attention_backward"])
        if "backward" in r:  # plain_ms and library_ms time dq, dk and dv
            bwd = r["backward"]
            row["backward"] = dict(
                note="plain_ms and library_ms of this row are of the whole "
                     "backward (dq, dk, dv); here the backward's totals",
                ms=bwd["ms"], bound_ms=bwd["bound"][0],
                plain_ms=bwd["plain_ms"], library_ms=bwd["library_ms"])
        rows.append(row)
    # the new flash instances, each timed at one shape of B=2, H=8, S=2048,
    # causal (per_shape: every shape of check_flash_head_dims it ran)
    flash_times, flash_errs = flash_wide
    bf16, f64 = torch.bfloat16, torch.float64
    wide = (2, 8, 2048)
    for key, src, line, shape, note in (
            ("fwd_ragged", "flash_forward.cu", 87, (100, bf16, *wide),
             "fwd_wg<D, T, M, true> (16-bit head dims not a multiple of 8: "
             "the wgmma consumers fed by a cp.async producer; per_shape "
             "holds D=12, 75, 130 and 250): launches are phase 11's dense "
             "check, the head_dim 100 GPT and phase 13's 5 timed steps"),
            ("fwd_wg", "flash_forward.cu", 87, (256, bf16, *wide),
             "fwd_wg<D, T, M> at head dims 129-256 (D=192 and 256; "
             "flash_attention_fwd is its D=64 instance): launches are the "
             "head_dim 256 GPT and phase 12's 5 timed steps"),
            ("dq_ragged", "flash_attention.cu", 297, (100, bf16, *wide),
             f"dq_tc<D, T, M, true> ({kernel_line('flash_attention.cu', 'dq_tc')}"
             f"; 16-bit head dims up to 128 that are not a multiple of 8) "
             f"and dq_wide<D, T, M, true> "
             f"({kernel_line('flash_backward_wide.cu', 'dq_wide')}; 129-255): "
             "the wgmma consumers fed by a cp.async producer; launches are "
             "phase 13's 5 timed steps and the head_dim 100 GPT's backward "
             "calls; per_shape holds D=12, 75, 130 and 250"),
            ("dkv_ragged", "flash_attention.cu", 365, (100, bf16, *wide),
             f"dkv_tc<D, T, M, true> "
             f"({kernel_line('flash_attention.cu', 'dkv_tc')}) and "
             f"dkv_wide<D, T, M, true> "
             f"({kernel_line('flash_backward_wide.cu', 'dkv_wide')}): as "
             "dq_ragged"),
            ("dq_wide", "flash_backward_wide.cu", 297, (256, bf16, *wide),
             "dq_wide<D, T, M> (wgmma; 16-bit head dims 129-256 that are "
             "multiples of 8, D=192 and 256): launches are phase 12's 5 "
             "timed steps (the head_dim 256 GPT of phase 4 launched it "
             f"{d256[1]} times more); per_shape holds D=160 (the D=192 "
             "instance) and 192"),
            ("dkv_wide", "flash_backward_wide.cu", 365, (256, bf16, *wide),
             "dkv_wide<D, T, M>: as dq_wide"),
            ("fwd_any", "flash_forward_any.cu", 87, (100, f64, *wide),
             "fwd_any (f32 and f64 at every head dim, 16-bit above 256; DMMA "
             "in f64, FFMA in f32): launches are phase 5's f32 flagship's 5 "
             "timed steps (the small f32 GPT of phase 4 launched it "
             f"{f32[0]} times more); per_shape holds that flagship's own "
             "shape (B=8, H=12, S=384, D=64, f32) and bf16 at D=320"),
            ("dq_any", "flash_backward_any.cu", 297, (100, f64, *wide),
             "dq_any (as fwd_any; DMMA in f64, FFMA in f32): launches are "
             "phase 5's f32 flagship's backward calls in its 5 timed steps "
             f"(the small f32 GPT of phase 4 launched it {f32[1]} times "
             "more)"),
            ("dkv_any", "flash_backward_any.cu", 365, (100, f64, *wide),
             "dkv_any: as dq_any")):
        part = key.split("_")[0]
        r = flash_times[shape][part]
        row = dict(name=f"flash_attention_{key}", route="cuda",
                   source=f"lamp_tpu_torch/csrc/{src}",
                   replaces=f"lamp_tpu/ops/attention.py:{line}",
                   launches=wide_launches[key],
                   max_abs_err=flash_errs[key], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                   bound_by=r["bound"][1], library_ms=r["library_ms"])
        row["note"] = (f"times at head_dim {shape[0]} {str(shape[1])[6:]} "
                       f"B=2 H=8 S=2048; "
                       f"{note}" + ("" if part == "fwd" else
                                    "; plain_ms and library_ms of the whole "
                                    "backward"))
        row["per_shape"] = {
            f"head_dim {dd} {str(dt)[6:]}" + ("" if (bb, hh, ss) == wide else
                                              f" B={bb} H={hh} S={ss}"): {
                k: t[part][k] for k in ("ms", "plain_ms", "library_ms")}
            | {"bound_ms": t[part]["bound"][0]}
            for (dd, dt, bb, hh, ss), t in flash_times.items()
            if flash_instance(dd, dt, part) == key}
        rows.append(row)
    row = dict(name="int4_matmul", route="cuda",
               source="lamp_tpu_torch/csrc/int4_matmul.cu",
               replaces="lamp_tpu/ops/quantization.py:233", **k7)
    row = {k: row[k] for k in keys}
    row["note"] = ("ms, plain_ms, bound_ms and library_ms: the sum over one "
                   "decode step's 61 calls at B=32 (int4_mm_decode; "
                   "library: F.linear on the dequantized bf16 weight); ms "
                   "and library_ms by CUDA events over a CUDA graph of 100 "
                   "calls on one weight; launches: phase 7's int4 requests "
                   "and phase 14's int4_mm_tc launches; tc_round: the same "
                   "sums over a speculative round's 61 calls at M=128 "
                   "(int4_mm_tc); per_call: each shape, with the profiler's "
                   "sum, cold times (copies beyond L2), the wrapper's eager "
                   "time, the launch plan, int4_mm_tc at M=128 (and 3072 "
                   "for qkv and the logits) and int4_mm_scalar (f32 x, "
                   "beside F.linear in f32) at M=32")
    row["per_call"] = k7["per_call"]
    row["tc_round"] = k7["tc_round"]
    row["speculative"] = {key: spec[key] for key in (
        "rounds", "emitted", "tok_s", "per_seq_round", "tc_launches",
        "round_device_us", "round_ops", "tc_share", "chunk_err")}
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
