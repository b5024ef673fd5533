"""Chunked decode, rewind and speculative decoding: lamp_tpu_torch's
against lamp_tpu's.

The models are test_torch_serving's ModernLM (64 wide, 4 heads over 2 kv
heads, vocab 61, context 64), made by lamp_tpu from a seeded key and
bridged into the port: 1 block for the chunk and rewind cases (the JAX
server's compile of a chunk, with its kernels in interpret mode, takes
half the time of 2 blocks'), 2 blocks as the speculative target, whose
first block is the draft. Everything runs in f32 on CPU (the JAX server's
paged kernel and int4 kernel in interpret mode, the port's through their
plain versions), with 8-token pages. Tolerances: logits at atol 1e-4 (f32 products summed in other
orders; the quantized servers quantize the same f32 weights into the same
bytes on both sides); page tables, free lists and tokens exactly equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import ops as jops
from lamp_tpu.models.serving import ModernBatchServer as JaxServer
from lamp_tpu.models.serving import SpeculativeDecoder as JaxSpec
from lamp_tpu.models.serving import draft_view as jax_draft_view
from lamp_tpu.ops.attention import dot_product_attention as jax_dpa
from lamp_tpu_torch.bridge import load_modern_lm
from lamp_tpu_torch.models import (ModernBatchServer, SpeculativeDecoder,
                                   draft_view)
from lamp_tpu_torch.ops import attention as tatt
from lamp_tpu_torch.ops import quantization as tq

from .test_torch_modern import jax_modern_lm, jax_params
from .test_torch_serving import ATOL, PAGE, _same_pages

PROMPTS = {"a": [3, 1, 4, 1, 5, 9], "b": [2, 7], "c": list(range(10, 21))}
IDS = list(PROMPTS)


# One server pair (JAX, port) per configuration for the whole module: a JAX
# server compiles its calls once per instance, and that compile is most of
# a case's time. Every test removes what it added, and both servers of a
# pair see the same calls, so their page tables and free lists stay equal.
def _servers(bits=None, windowed=False, blocks=1):
    """A JAX server and a port server over one model of ``blocks`` blocks
    (layer windows of 4 and 6 tokens where ``windowed``), 32 pages."""
    window = [4, 6][:blocks] if windowed else None
    jm = jax_modern_lm(num_blocks=blocks, window=window)
    tm = load_modern_lm(jax_params(jm), window=window, device="cpu")
    kw = dict(page_size=PAGE, total_pages=32, quantize_bits=bits)
    return JaxServer(jm, **kw), ModernBatchServer(tm, **kw)


@functools.lru_cache(maxsize=None)
def _pair(bits=None, windowed=False, blocks=1):
    return _servers(bits, windowed, blocks)


@functools.lru_cache(maxsize=None)
def _draft_pair(bits=None):
    """Servers of the speculative target's first block (draft_view: no
    copy)."""
    js, ts = _pair(bits, blocks=2)
    kw = dict(page_size=PAGE, total_pages=ts.total_pages,
              quantize_bits=bits)
    return (JaxServer(jax_draft_view(js.model, 1), **kw),
            ModernBatchServer(draft_view(ts.model, 1), **kw))


def _add(servers, window=None):
    for s in servers:
        for rid, p in PROMPTS.items():
            s.add(rid, p, window=window if rid == "a" else None)


def _clear(servers):
    for s in servers:
        for rid in list(s.seq_pages):
            s.remove(rid)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("bits,window", [(None, None), (4, None), (8, None),
                                         (None, 5)])
def test_advance_chunk_logits_match_jax(bits, window):
    """Two chunks of 4 tokens (sequence "a" crosses into its second page,
    "c" into its third) under quantize_bits None / 4 / 8, and with a layer
    window of 4 plus a request window of 5 on "a": logits [B, m, V] at
    atol 1e-4, the same page tables, free lists and released pages. With
    the windows, "c"'s first page goes back to the pool before the second
    chunk, and a rewind whose band would reach it raises on both sides."""
    js, ts = _pair(bits, window is not None)
    try:
        _add((js, ts), window=window)
        rng = np.random.RandomState(0)
        for _ in range(2):
            toks = rng.randint(0, 61, (3, 4))
            want = js.advance_chunk(IDS, toks)
            got = ts.advance_chunk(IDS, toks)
            assert got.shape == (3, 4, 61) and got.dtype == torch.float32
            _close(got, want)
            _same_pages(js, ts)
            assert ts.seq_released == js.seq_released
        if window is not None:
            assert ts.seq_released["c"] == 1
            for s in (js, ts):
                with pytest.raises(RuntimeError, match="released by the"):
                    s.rewind("c", 12)
    finally:
        _clear((js, ts))


def test_chunk_equals_single_steps():
    """A chunk of m tokens against the same m tokens fed one decode step at
    a time, on two port servers of the 2-block model: the same logits (f32:
    the products differ in summation order only, atol 1e-5) and the same
    pages."""
    a = _servers(blocks=2)[1]
    b = _servers(blocks=2)[1]
    _add((a, b))
    toks = np.random.RandomState(1).randint(0, 61, (3, 5))
    chunk = a.advance_chunk(IDS, toks)
    steps = torch.stack([b._advance(IDS, torch.as_tensor(toks[:, j]))
                         for j in range(5)], dim=1)
    _close(chunk, steps.numpy(), atol=1e-5)
    assert a.seq_pages == b.seq_pages and a.seq_len == b.seq_len


def test_rewind_then_advance_matches_a_server_that_never_saw_the_tokens():
    """rewind drops the last tokens' K/V and returns the pages past the new
    length: after a chunk of 4, rewinding 3 and taking a chunk of 4 more
    equals a server that took only the first token and then those 4
    (logits at 1e-5, pages equal), and matches JAX's rewind (logits at
    1e-4, page tables and free lists equal)."""
    js, ts = _pair()
    fresh = _servers()[1]
    try:
        _add((js, ts, fresh))
        toks = np.random.RandomState(2).randint(0, 61, (3, 8))
        js.advance_chunk(IDS, toks[:, :4])
        ts.advance_chunk(IDS, toks[:, :4])
        fresh._advance(IDS, torch.as_tensor(toks[:, 0]))
        for s in IDS:
            js.rewind(s, 3)
            ts.rewind(s, 3)
        _same_pages(js, ts)
        assert ts.seq_pages == fresh.seq_pages
        assert ts.seq_len == fresh.seq_len
        want = js.advance_chunk(IDS, toks[:, 4:])
        got = ts.advance_chunk(IDS, toks[:, 4:])
        _close(got, want)
        _close(got, fresh.advance_chunk(IDS, toks[:, 4:]).numpy(), atol=1e-5)
        _same_pages(js, ts)
    finally:
        _clear((js, ts))


def _spec_pair(temperature, bits=None):
    """JAX's and the port's SpeculativeDecoder (k=4, seed 5) over the
    module's servers: the 2-block target and its first block as the
    draft."""
    pairs = (_pair(bits, blocks=2), _draft_pair(bits))
    out = []
    for side, cls in ((0, JaxSpec), (1, SpeculativeDecoder)):
        servers = iter([pairs[0][side], pairs[1][side]])
        out.append(cls(pairs[0][side].model, pairs[1][side].model, k=4,
                       page_size=PAGE, total_pages=32,
                       temperature=temperature, seed=5,
                       server_cls=lambda model, **kw: next(servers)))
    return out


def _run(spec, rounds):
    for rid, p in PROMPTS.items():
        spec.add(rid, p)
    out = {rid: [] for rid in PROMPTS}
    per_round = []
    for _ in range(rounds):
        got = spec.step()
        per_round.append({rid: len(t) for rid, t in got.items()})
        for rid, t in got.items():
            out[rid] += t
    return out, per_round


def test_speculative_greedy_matches_jax_and_target_only_decoding():
    """The draft is the target's first block (draft_view: the target's own
    tensors). Four greedy rounds: the emitted tokens equal JAX's, 1 to k a
    round, and each stream equals target-only greedy decoding; both pools
    return to their start after remove()."""
    jspec, tspec = _spec_pair(0.0)
    assert tspec.draft.model.token_embedding is \
        tspec.target.model.token_embedding
    assert tspec.draft.model.blocks[0] is tspec.target.model.blocks[0]
    free = (len(tspec.target.free_pages), len(tspec.draft.free_pages))
    try:
        want, _ = _run(jspec, 4)
        got, per_round = _run(tspec, 4)
        assert got == want
        assert all(1 <= n <= 4 for r in per_round for n in r.values())
        _same_pages(jspec.target, tspec.target)
        _same_pages(jspec.draft, tspec.draft)
    finally:
        for spec in (jspec, tspec):
            for rid in list(spec.active):
                spec.remove(rid)
    assert (len(tspec.target.free_pages), len(tspec.draft.free_pages)) \
        == free
    plain = _servers(blocks=2)[1]
    _add((plain,))
    streams = {rid: [] for rid in PROMPTS}
    while min(len(v) for v in streams.values()) < max(
            len(v) for v in got.values()):
        for rid, t in plain.step().items():
            streams[rid].append(t)
    for rid, toks in got.items():
        assert streams[rid][:len(toks)] == toks


def test_speculative_sampled_matches_jax():
    """temperature 1.0 with the same seed: the emitted tokens equal JAX's.
    Both classes draw from the same numpy generator (np.random.default_rng
    (seed)), in the same order, over f64 softmaxes of f32 logits that agree
    to ~1e-6, so every uniform draw and every categorical draw lands on the
    same token (a draw within ~1e-6 of a category boundary would be needed
    to split them)."""
    jspec, tspec = _spec_pair(1.0)
    try:
        want, _ = _run(jspec, 4)
        got, per_round = _run(tspec, 4)
    finally:
        for spec in (jspec, tspec):
            for rid in list(spec.active):
                spec.remove(rid)
    assert got == want
    assert all(1 <= n <= 4 for r in per_round for n in r.values())
    assert all(0 <= t < 61 for v in got.values() for t in v)


# (M, K, N): rows of the row-tiled route (M > 64), kernel-eligible for the
# JAX kernel (N % 128, g % 32)
@pytest.mark.parametrize("m,k,n", [(65, 256, 128), (128, 256, 256),
                                   (160, 512, 128)])
def test_int4_matmul_reference_matches_jax_at_chunk_rows(m, k, n):
    rng = np.random.RandomState(6)
    w = rng.randn(k, n).astype(np.float32)
    jp, js = jops.quantize_int4(jnp.asarray(w),
                                group_size=jops.int4_group_size(k))
    x = rng.randn(m, k).astype(np.float32)
    want = jops.int4_matmul(jnp.asarray(x, jnp.bfloat16), jp, js,
                            out_dtype=jnp.float32, interpret=True)
    got = tq.int4_matmul(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(np.array(jp)),
                         torch.from_numpy(np.array(js)),
                         out_dtype=torch.float32)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# the int4 decode path's shapes at phase 14's 128 rows and at 160, 257 and
# 3072, and K7's edges: (M, N, K/2, g)
@pytest.mark.parametrize("m,n,k2,g", [
    (128, 1280, 384, 128), (128, 768, 384, 128), (128, 2048, 384, 128),
    (128, 768, 1024, 128), (128, 32000, 384, 128), (160, 1280, 384, 128),
    (65, 1000, 384, 128), (128, 1280, 384, 32), (128, 1024, 4096, 128),
    (257, 1280, 384, 128), (3072, 32000, 384, 128)])
def test_tc_plan_splits_k_once_and_fills_the_card(monkeypatch, m, n, k2, g):
    """The row-tiled kernel's plan (ops/quantization.py:_tc_plan): 128 x 128
    tiles above 256 rows, unsplit; 64 columns by 256 rows at 129-256 (each
    packed byte read once a call); 128 or 64 columns by 128 rows below. The
    cluster's ranks each take at least one 16-row step and together cover
    K once; at 256 rows or fewer they split at group boundaries when a
    divisor of the half's groups lies within a factor 2 below the aim of a
    block for every two SMs."""
    monkeypatch.setattr(tq, "_sm_count", lambda index: 132)
    tile, cluster, rows = tq._int4_plan(m, n, k2, g, torch.device("cuda", 0))
    assert (tile, rows) in ((128, 128), (64, 128), (64, 256))
    assert rows == (256 if 128 < m <= 256 else 128)
    steps = k2 // 16
    assert 1 <= cluster <= min(8, steps)
    bounds = [r * steps // cluster for r in range(cluster + 1)]
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    if m > 256:
        assert (tile, cluster) == (128, 1)
        return
    want = min(8, steps, -(-66 // -(-n // tile)))
    assert cluster <= want
    if (k2 // g) % cluster == 0:  # every rank's range starts on a group
        assert all(b * 16 % g == 0 for b in bounds)
    assert 2 * cluster >= want or cluster == tq._even_cluster(steps, want)


@pytest.mark.parametrize("implementation", [None, "xla", "compact", "flash"])
def test_dot_product_attention_implementation_matches_jax(implementation):
    """Every implementation= value the JAX router takes gives mha_reference's
    result on CPU tensors, causal with a window, at atol 1e-5."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 3, 40, 16).astype(np.float32) for _ in range(3))
    want = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, window=9, implementation=implementation)
    got = tatt.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=9, implementation=implementation)
    _close(got, want, atol=1e-5)


def test_aligned16_copies_only_what_the_kernels_cannot_read():
    """The wrappers' layout repair: a contiguous, 16-byte aligned tensor is
    passed through as it is; a transposed view and a view 2 bytes past an
    aligned start become fresh contiguous, aligned copies of the same
    values."""
    x = torch.arange(64, dtype=torch.bfloat16).reshape(8, 8)
    assert tatt.aligned16(x) is x
    for view in (x.t(), torch.arange(65, dtype=torch.bfloat16)[1:].view(8, 8)):
        got = tatt.aligned16(view)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, view)


def test_dot_product_attention_rejects_an_unknown_implementation():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="implementation"):
        tatt.dot_product_attention(q, q, q, implementation="triton")
