"""The serving slice: lamp_tpu_torch's ModernBatchServer and ServingEngine
against lamp_tpu's, on one model.

A 2-block, 64-wide, 4-head / 2-kv-head ModernLM (vocab 61, context 64) is
made by lamp_tpu from a seeded key and bridged into the port; both servers
use 8-token pages. Everything runs in f32 on CPU (the JAX server's paged
kernel in interpret mode, the port's through its plain version).
Tolerance: logits at atol 1e-4; page tables, free lists and greedy tokens
exactly equal. The quantized servers (``quantize_bits`` 8 and 4) quantize
the same f32 weights into the same bytes on both sides, so they are held to
the same tolerance; the fp8-pool server to the one stated at its test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu.models.sampling import SamplingParams as JaxParams
from lamp_tpu.models.serving import ModernBatchServer as JaxServer
from lamp_tpu.models.serving import ServingEngine as JaxEngine
from lamp_tpu_torch.bridge import load_modern_lm
from lamp_tpu_torch.models import (ModernBatchServer, SamplingParams,
                                   ServingEngine)

from .test_torch_modern import jax_modern_lm, jax_params

ATOL = 1e-4
PAGE = 8


def _servers(window=None, total_pages=32, quantize_bits=None, fp8=False):
    jm = jax_modern_lm(window=window)
    tm = load_modern_lm(jax_params(jm), window=window, device="cpu")
    kw = dict(page_size=PAGE, total_pages=total_pages,
              quantize_bits=quantize_bits)
    return (JaxServer(jm, **kw,
                      kv_dtype=jnp.float8_e4m3fn if fp8 else None),
            ModernBatchServer(tm, **kw,
                              kv_dtype=torch.float8_e4m3fn if fp8 else None))


def _same_pages(js, ts):
    assert ts.seq_pages == js.seq_pages
    assert ts.seq_len == js.seq_len
    assert ts.free_pages == js.free_pages


def _advance_both(js, ts, atol=ATOL):
    """Prefill two requests, then 5 decode steps ("a" crosses into its
    second page); logits compared at ``atol`` at every step."""
    for s in (js, ts):
        s.add("a", [3, 1, 4, 1, 5, 9])   # 5 prefill rows: page 0 of "a"
        s.add("b", [2, 7])
    _same_pages(js, ts)
    toks = [9, 7]
    for _ in range(5):  # "a" reaches position 10: its second page
        want = js._advance(["a", "b"], jnp.asarray(toks, jnp.int32))
        got = ts._advance(["a", "b"], torch.tensor(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0)
        toks = [int(t) for t in np.asarray(want).argmax(-1)]
    assert len(ts.seq_pages["a"]) == 2
    _same_pages(js, ts)


def test_advance_logits_match_jax_across_page_boundary():
    _advance_both(*_servers())


def test_page_tables_and_free_lists_match_jax_after_adds_and_removes():
    js, ts = _servers(total_pages=12)
    prompts = {"a": list(range(1, 12)), "b": [4, 2], "c": list(range(20, 37))}
    for s in (js, ts):
        for rid, p in prompts.items():
            s.add(rid, p)
    _same_pages(js, ts)
    assert ts.step() == js.step()
    for s in (js, ts):
        s.remove("b")
        s.add("d", [5] * 9)
    _same_pages(js, ts)
    assert ts.step() == js.step()
    for s in (js, ts):
        s.remove("a")
        s.remove("c")
    _same_pages(js, ts)
    assert ts.available_pages == len(js.free_pages)


def test_step_many_greedy_tokens_match_jax():
    js, ts = _servers()
    for s in (js, ts):
        s.add("a", [1, 2, 3, 4, 5, 6, 7])
        s.add("b", [9, 8])
        s.add("c", [11, 12, 13, 14])
    for _ in range(2):
        assert ts.step_many(4) == js.step_many(4)
    _same_pages(js, ts)
    assert ts.last_token == js.last_token


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_advance_logits_match_jax(bits):
    """quantize_bits: every decode matmul on packed weights (int8 through
    torch._int_mm, int4 through int4_matmul's plain version), the same
    bytes as the JAX server's; prefill on the float weights."""
    js, ts = _servers(quantize_bits=bits)
    vals, scales = ts._extras[0][0]
    want_vals, want_scales = js._extras[0][0]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))
    assert vals.dtype == (torch.uint8 if bits == 4 else torch.int8)
    assert ts._extras[5][0].shape == np.asarray(js._extras[5][0]).shape
    _advance_both(js, ts)


def test_quantized_int4_greedy_engine_matches_jax():
    _greedy_engines_match(*_servers(quantize_bits=4))


def test_fp8_kv_pool_matches_jax():
    """kv_dtype=float8_e4m3fn: K/V rows are rounded to fp8 when written and
    upcast when read. After prefill the pools agree byte for byte (page 0,
    where the JAX server's padded prefill rows land, excepted). In decode
    the JAX kernel rounds p and the appended K/V rows to bf16 before its
    dots when the pool is fp8 (lamp_tpu/ops/paged_attention.py:353-358,
    :383-386, :404-406), where its plain reference and the port keep q's
    dtype (f32 here): a relative 2^-9 per term, which also carries a few
    K/V values across an fp8 rounding boundary (an fp8 step is 2^-3 of the
    value). So the decode logits are held at atol 5e-3, not 1e-4."""
    js, ts = _servers(fp8=True)
    assert ts.kv_pages.dtype == torch.float8_e4m3fn
    for s in (js, ts):
        s.add("a", [3, 1, 4, 1, 5, 9])
        s.add("b", [2, 7])
    layers = len(ts.model.blocks)
    got = ts.kv_pages.view(torch.uint8).numpy().reshape(
        layers, ts.total_pages, -1)
    want = np.asarray(js.kv_pages).view(np.uint8).reshape(got.shape)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    toks = [9, 7]
    for _ in range(5):
        want = js._advance(["a", "b"], jnp.asarray(toks, jnp.int32))
        got = ts._advance(["a", "b"], torch.tensor(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3,
                                   rtol=0)
        toks = [int(t) for t in np.asarray(want).argmax(-1)]
    _same_pages(js, ts)


def test_greedy_engine_matches_jax_engine():
    """6 requests through max_batch=3: joins, leaves, staggered budgets and
    a stop token (token 4 ends request q3 in the middle of a chunk)."""
    _greedy_engines_match(*_servers())


def _greedy_engines_match(js, ts):
    prompts = [[1, 2, 3], [7, 8], [4, 4, 4, 4, 4], [9], [10, 20, 30, 40],
               [5, 6]]
    budgets = [5, 9, 3, 12, 6, 8]
    engines = (JaxEngine(js, decode_steps=4, max_batch=3),
               ServingEngine(ts, decode_steps=4, max_batch=3))
    for eng, params in zip(engines, (JaxParams, SamplingParams)):
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            eng.submit(p, params(max_tokens=n, stop_tokens=(4,)),
                       request_id=f"q{i}")
    want = engines[0].run()
    got = engines[1].run()
    assert got == want
    assert len(got["q3"]) < budgets[3]
    assert len(ts.free_pages) == ts.total_pages - 1 and not ts.seq_pages


def test_windowed_release_matches_jax():
    """Per-layer windows (4, 6) plus a per-request window 5 on one request:
    every layer is windowed, so pages below the band go back to the pool
    mid-generation; the port releases the same pages and emits the same
    tokens."""
    js, ts = _servers(window=[4, 6])
    for s in (js, ts):
        s.add("w", list(range(1, 11)), window=5)
        s.add("x", [3, 5, 7])
    for _ in range(3):
        assert ts.step_many(4) == js.step_many(4)
        _same_pages(js, ts)
        assert ts.seq_released == js.seq_released
    assert ts.seq_released["w"] >= 1 and -1 in ts.seq_pages["w"]
    assert ts.step() == js.step()


def test_unported_features_raise():
    _, ts = _servers()
    engine = ServingEngine(ts)
    with pytest.raises(ValueError, match="unknown constraint"):
        engine.submit([1, 2], constraint="json")
    with pytest.raises(ValueError, match="unknown adapter"):
        ts.add("l", [1, 2], adapter="a")
    with pytest.raises(ValueError, match="unknown adapter"):
        engine.submit([1, 2], adapter="a")
    with pytest.raises(NotImplementedError):
        ModernBatchServer(ts.model, page_size=PAGE, total_pages=4,
                          mesh=object())
    with pytest.raises(ValueError, match="quantize_bits"):
        ModernBatchServer(ts.model, page_size=PAGE, total_pages=4,
                          quantize_bits=2)


def test_sampled_engine_cancel_and_pool():
    """Sampled requests (top-k / top-p / min-p, logprobs) run to their
    budgets with valid tokens; a cancelled request frees its pages."""
    _, ts = _servers()
    engine = ServingEngine(ts, decode_steps=4, max_batch=4)
    engine.submit([1], SamplingParams(max_tokens=40), request_id="gone")
    specs = [dict(temperature=0.8, top_p=0.9), dict(temperature=1.0, top_k=5),
             dict(temperature=0.5, min_p=0.1, logprobs=True), dict()]
    for i, kw in enumerate(specs):
        engine.submit([i + 1, i + 2, i + 3], SamplingParams(max_tokens=6, **kw),
                      request_id=f"s{i}")
    engine.step()  # "gone" and s0-s2 in flight, s3 queued
    assert "gone" in ts.seq_pages and engine.cancel("gone")
    assert "gone" not in ts.seq_pages and not engine.cancel("gone")
    results = engine.run()
    assert "gone" not in results
    assert all(len(results[f"s{i}"]) == 6 for i in range(4))
    assert all(0 <= t < 61 for r in results.values() for t in r)
    assert len(engine.result_logprobs["s2"]) == 6
    assert all(lp <= 0 for lp in engine.result_logprobs["s2"])
    assert len(ts.free_pages) == ts.total_pages - 1


def _openllama_servers():
    """OpenLLaMA-3B's shape (openlm-research/open_llama_3b: no GQA, head_dim
    100, SwiGLU 2.7x the width, untied head) cut to 2 blocks of width 200:
    2 heads of head_dim 100, SwiGLU 540, vocab 256; made by lamp_tpu and
    bridged, as _servers."""
    jm = jax_modern_lm(vocab_size=256, embed_dim=200, num_heads=2,
                       num_kv_heads=2, mlp_hidden=540, tied=False)
    tm = load_modern_lm(jax_params(jm), device="cpu")
    assert tm.lm_head is not None and tm.rope_cos.shape[1] == 50
    kw = dict(page_size=PAGE, total_pages=32)
    return jm, JaxServer(jm, **kw), ModernBatchServer(tm, **kw)


@pytest.mark.parametrize("what", ["forward", "advance", "engine"])
def test_openllama_shape_matches_jax(what):
    """The OpenLLaMA-shaped model: the dense forward's logits, the decode
    step's logits (through the paged attention's plain version at head_dim
    100) and greedy ServingEngine tokens against the JAX package's."""
    jm, js, ts = _openllama_servers()
    assert ts.head_dim == 100
    if what == "forward":
        toks = np.random.RandomState(4).randint(0, 256, (2, 12))
        want, _ = jm.forward(jnp.asarray(toks, jnp.int32))
        with torch.no_grad():
            got = ts.model(torch.from_numpy(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    elif what == "advance":
        _advance_both(js, ts)
    else:
        prompts = [[1, 2, 3], [70, 80], [200, 4, 4, 9, 4], [9], [255, 0]]
        budgets = [5, 9, 3, 12, 6]
        engines = (JaxEngine(js, decode_steps=4, max_batch=3),
                   ServingEngine(ts, decode_steps=4, max_batch=3))
        for eng, params in zip(engines, (JaxParams, SamplingParams)):
            for i, (p, n) in enumerate(zip(prompts, budgets)):
                eng.submit(p, params(max_tokens=n), request_id=f"q{i}")
        want = engines[0].run()
        got = engines[1].run()
        assert got == want
        assert [len(got[f"q{i}"]) for i in range(5)] == budgets
        assert len(ts.free_pages) == ts.total_pages - 1 and not ts.seq_pages
