"""The GPT serving path: lamp_tpu_torch's BatchServer over a
LanguageModelModule against lamp_tpu's, through step, step_many,
advance_chunk, rewind, the prefix cache, penalties, a constraint,
ServingEngine and SpeculativeDecoder (tests/test_serving.py's GPT cases).

A 2-block, 32-wide, 4-head GPT (head_dim 8, vocab 61, context 48, biases)
is made by lamp_tpu from a seeded key and bridged into the port; both
servers use 8-token pages. Everything runs in f32 on CPU (the JAX server's
paged kernel in interpret mode, the port's through its plain version).
One JAX/port server pair per configuration serves the module (a JAX server
compiles its calls once per instance); :func:`_clear` removes every
sequence and resets both allocators and penalty caches alike.

Tolerances: logits at atol 1e-5 (f32 products summed in other orders; the
two servers read 1e-7 apart); 5e-3 on an e4m3 pool, as
test_torch_serving's fp8 test states; the paged logits against the dense
forward at 1e-4. Page tables, free lists, refcounts, hashes, hit counters,
penalty counts and greedy tokens exactly equal. Sampled tokens come from a
torch.Generator and agree with JAX's in distribution only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lamp_tpu.nn as jnn
from lamp_tpu.models import constrained as jax_constrained
from lamp_tpu.models.sampling import SamplingParams as JaxParams
from lamp_tpu.models.serving import BatchServer as JaxServer
from lamp_tpu.models.serving import ServingEngine as JaxEngine
from lamp_tpu.models.serving import SpeculativeDecoder as JaxSpec
from lamp_tpu_torch.models import (BatchServer, LoRADraftSpeculativeDecoder,
                                   SamplingParams, ServingEngine,
                                   SpeculativeDecoder, draft_view)
from lamp_tpu_torch.models.constrained import TokenDFA, byte_vocab

from .test_torch_modern import jax_params
from .test_torch_prefix_cache import _same_pages as _same_cache
from .test_torch_serving import _same_pages
from .test_torch_serving_controls import _same_counts
from .test_torch_transformer import jax_lm, torch_lm

ATOL = 1e-5
PAGE, TOTAL, CTX, HEADS, VOCAB = 8, 32, 48, 4, 61
PHONE, EOS = r"[0-9]{3}-[0-9]{4}", 0


@functools.lru_cache(maxsize=None)
def _models(bias=True):
    """The JAX GPT and its port (``bias=False``: the same model with
    biasless linears, as the bridge also builds)."""
    jm = jax_lm(context_length=CTX, attention_heads=HEADS)
    if not bias:
        jm = jm.replace(encoder=jnn.TransformerEncoder.init(
            2, 32, 32, HEADS, key=jax.random.PRNGKey(5), causal=True,
            bias=False))
    return jm, torch_lm(jm, heads=HEADS)


@functools.lru_cache(maxsize=None)
def _pair(fp8=False, bias=True):
    """A JAX and a port BatchServer over one model (an e4m3 pool where
    ``fp8``), the phone constraint registered on both."""
    jm, tm = _models(bias)
    kw = dict(page_size=PAGE, total_pages=TOTAL)
    js = JaxServer(jm, **kw, kv_dtype=jnp.float8_e4m3fn if fp8 else None)
    ts = BatchServer(tm, **kw, kv_dtype=torch.float8_e4m3fn if fp8 else None)
    js.register_constraint("phone", jax_constrained.TokenDFA.compile(
        PHONE, jax_constrained.byte_vocab(VOCAB), eos_token=EOS))
    ts.register_constraint("phone", TokenDFA.compile(
        PHONE, byte_vocab(VOCAB), eos_token=EOS))
    return js, ts


def _clear(usable=TOTAL - 1, prefix=False, **kw):
    """The pair emptied, ``usable`` pages free (ids 1..usable), the prefix
    cache on where ``prefix`` (both servers read the flag at each call,
    so one pair, compiled once, serves both settings)."""
    js, ts = _pair(**kw)
    for s in (js, ts):
        s.enable_prefix_cache = prefix
        for rid in list(s.seq_pages):
            s.remove(rid)
        s.free_pages[:] = range(usable, 0, -1)
        for state in (s._page_refs, s._lru, s._hash_to_page, s._page_hash):
            state.clear()
        s.cache_hit_tokens = s.cache_miss_tokens = 0
        s._pen_cache = None
    return js, ts


def _advance(js, ts, ids, toks, atol=ATOL):
    want = js._advance(ids, jnp.asarray(toks, jnp.int32))
    got = ts._advance(ids, torch.tensor(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)
    _same_pages(js, ts)
    return [int(t) for t in np.asarray(want).argmax(-1)]


def _add_two(js, ts):
    for s in (js, ts):
        s.add("a", [3, 1, 4, 1, 5, 9])   # 5 prefill rows: page 0 of "a"
        s.add("b", [2, 7])
    _same_pages(js, ts)


def _advance_both(js, ts, atol=ATOL):
    """Two requests, then 5 steps ("a" crosses into its second page)."""
    _add_two(js, ts)
    toks = [9, 7]
    for _ in range(5):
        toks = _advance(js, ts, ["a", "b"], toks, atol)
    assert len(ts.seq_pages["a"]) == 2


def test_extras_and_introspection_match_jax():
    """The fused QKV weight (the transpose of JAX's [D, 3·H·hd]) and bias,
    the f32 embedding copy, and the pool's shape."""
    js, ts = _clear()
    wqkv, bqkv, lmh = ts._extras
    jw, jb = js._extras
    np.testing.assert_array_equal(wqkv[1].numpy(), np.asarray(jw[1]).T)
    np.testing.assert_array_equal(bqkv[1].numpy(), np.asarray(jb[1]))
    assert lmh.dtype == torch.float32 and lmh.shape == (VOCAB, 32)
    assert (ts.layers, ts.heads, ts.kv_heads, ts.head_dim) == \
        (js.layers, js.heads, js.kv_heads, js.head_dim) == (2, 4, 4, 8)
    assert ts._windows == js._windows == (None, None)
    assert tuple(ts.kv_pages.shape) == js.kv_pages.shape


def test_advance_logits_match_jax_and_the_full_forward():
    js, ts = _clear()
    prompt = [1, 5, 2, 9, 11, 3]
    for s in (js, ts):
        s.add("a", prompt)
    _advance(js, ts, ["a"], [prompt[-1]])
    js.remove("a")
    ts.remove("a")
    ts.add("a", prompt)
    got = ts._advance(["a"], torch.tensor([prompt[-1]]))
    with torch.no_grad():
        full = ts.model(torch.tensor([prompt]))
    np.testing.assert_allclose(got[0].numpy(), full[0, -1].numpy(),
                               atol=1e-4, rtol=0)
    ts.remove("a")
    _advance_both(js, ts)


def test_batch_matches_single():
    """Two interleaved requests decode the same greedy tokens as each run
    alone (no cross-request leakage through the shared pool)."""
    _, tm = _models()

    def single(prompt):
        s = BatchServer(tm, page_size=PAGE, total_pages=TOTAL)
        s.add("x", prompt)
        return [s.step()["x"] for _ in range(5)]

    _, ts = _clear()
    ts.add("a", [1, 2, 3, 4])
    ts.add("b", [9, 8, 7])
    both = [ts.step() for _ in range(5)]
    assert [o["a"] for o in both] == single([1, 2, 3, 4])
    assert [o["b"] for o in both] == single([9, 8, 7])


def test_join_leave_and_page_reuse_match_jax():
    js, ts = _clear(usable=11)
    prompts = {"a": list(range(1, 12)), "b": [4, 2], "c": list(range(20, 37))}
    for s in (js, ts):
        for rid, p in prompts.items():
            s.add(rid, p)
    _same_pages(js, ts)
    assert ts.step() == js.step()
    pages_a = len(ts.seq_pages["a"])
    free_before = len(ts.free_pages)
    for s in (js, ts):
        s.remove("a")
        s.add("d", [5] * 9)
    # "a"'s pages back, then one page for "d"'s 8 prefill rows
    assert len(ts.free_pages) == free_before + pages_a - 1
    _same_pages(js, ts)
    assert ts.step() == js.step()
    for s in (js, ts):
        for rid in ("b", "c", "d"):
            s.remove(rid)
    _same_pages(js, ts)
    assert ts.available_pages == len(js.free_pages) == 11


@pytest.mark.parametrize("prompt", [[1, 5, 2, 9], list(range(1, 8))],
                         ids=["within_page", "across_pages"])
def test_chunk_equals_sequential_and_jax(prompt):
    """advance_chunk over m tokens equals m single advances (logits and
    lengths), and the JAX server's chunk; the second prompt's chunk opens
    a new page in its middle."""
    js, ts = _clear()
    chunk = [prompt[-1], 9, 10, 11, 12]
    for s in (js, ts):
        s.add("a", prompt)
        s.add("s", prompt)
    got = ts.advance_chunk(["a"], [chunk])[0]
    want = js.advance_chunk(["a"], np.asarray([chunk], np.int32))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    seq = [ts._advance(["s"], torch.tensor([t]))[0] for t in chunk]
    for j, ref in enumerate(seq):
        np.testing.assert_allclose(got[j].numpy(), ref.numpy(), atol=ATOL,
                                   rtol=0, err_msg=f"position {j}")
    assert ts.seq_len["a"] == ts.seq_len["s"] == len(prompt) - 1 + 5
    assert len(ts.seq_pages["a"]) == -(-ts.seq_len["a"] // PAGE)


def test_rewind_matches_jax():
    js, ts = _clear()
    for s in (js, ts):
        s.add("a", [1, 2, 3])
        s.advance_chunk(["a"], np.asarray([[3, 4, 5, 6, 7]], np.int32))
        s.rewind("a", 4)
    assert ts.seq_len["a"] == 3
    _same_pages(js, ts)
    assert ts.step() == js.step()
    _same_pages(js, ts)


def test_step_many_matches_sequential_steps_and_jax():
    js, ts = _clear()
    prompts = {"a": [1, 2, 3, 4, 5, 6, 7], "b": [9, 8], "c": [11, 12, 13]}
    for s in (js, ts):
        for rid, p in prompts.items():
            s.add(rid, p)
    many = ts.step_many(4)
    assert many == js.step_many(4)
    _same_pages(js, ts)
    _, tm = _models()
    seq = BatchServer(tm, page_size=PAGE, total_pages=TOTAL)
    for rid, p in prompts.items():
        seq.add(rid, p)
    steps = [seq.step() for _ in range(4)]
    assert {rid: [o[rid] for o in steps] for rid in prompts} == many


def test_per_request_params():
    """A greedy request beside sampled ones (top-k, top-p with logprobs)
    keeps JAX's greedy tokens; the sampled ones stay in the vocabulary and
    record their logprobs."""
    js, ts = _clear()
    specs = {"g": dict(), "k": dict(temperature=1.0, top_k=5),
             "p": dict(temperature=0.7, top_p=0.9, logprobs=True)}
    for s, params in ((js, JaxParams), (ts, SamplingParams)):
        for i, (rid, kw) in enumerate(specs.items()):
            s.add(rid, [i + 1, i + 2, i + 3], params(**kw))
    for _ in range(2):
        want, got = js.step_many(2), ts.step_many(2)
        assert got["g"] == want["g"]
        assert all(0 <= t < VOCAB for r in got.values() for t in r)
    assert len(ts.seq_logprobs["p"]) == 4
    assert all(lp <= 0 for lp in ts.seq_logprobs["p"])


def test_penalty_counts_match_jax():
    """Greedy requests under presence and repetition + frequency penalties
    beside a plain one, through step and step_many as one leaves: tokens,
    pages and the [B, V] count stacks equal JAX's after each call."""
    js, ts = _clear()
    specs = {"pres": dict(presence_penalty=1000.0),
             "rep": dict(repetition_penalty=1.3, frequency_penalty=0.5),
             "none": dict()}
    for s, params in ((js, JaxParams), (ts, SamplingParams)):
        for rid, kw in specs.items():
            s.add(rid, [3, 1, 4, 1, 5], params(**kw))
    for fn in (lambda s: s.step(), lambda s: s.step_many(2),
               lambda s: s.remove("rep"), lambda s: s.step_many(2)):
        assert fn(ts) == fn(js)
        _same_pages(js, ts)
        _same_counts(js, ts)
    assert ts._pen_cache[0] == ("pres", "none")


def test_constraint_matches_jax():
    """The phone-number DFA masks a greedy request (EOS after a complete
    match), beside an unconstrained one: tokens and automaton states equal
    JAX's, and the constrained output matches the pattern."""
    js, ts = _clear()
    for s in (js, ts):
        s.add("c", [1, 2, 3], constraint="phone")
        s.add("f", [4, 5])
    out = {"c": [], "f": []}
    for _ in range(2):
        got = ts.step_many(4)
        assert got == js.step_many(4)
        assert ts.seq_cstate == js.seq_cstate
        for rid, toks in got.items():
            out[rid] += toks
    text = bytes(out["c"][:8])
    assert text[:3].isdigit() and text[3:4] == b"-" and text[4:].isdigit()


def test_fp8_pool_matches_jax():
    """kv_dtype=float8_e4m3fn: the decode logits at atol 5e-3 (the JAX
    kernel rounds p and the appended rows to bf16 over fp8 pools, the port
    keeps q's dtype; see test_torch_serving's fp8 test)."""
    js, ts = _clear(fp8=True)
    assert ts.kv_pages.dtype == torch.float8_e4m3fn
    _advance_both(js, ts, atol=5e-3)


def test_request_window_releases_pages_as_jax():
    """A per-request window of 5 on a GPT (no layer windows): every layer
    is windowed, so pages below the band go back to the pool as the
    request decodes, the same pages as JAX's."""
    js, ts = _clear()
    for s in (js, ts):
        s.add("w", list(range(1, 11)), window=5)
        s.add("x", [3, 5, 7])
    for _ in range(3):
        assert ts.step_many(4) == js.step_many(4)
        _same_pages(js, ts)
        assert ts.seq_released == js.seq_released
    assert ts.seq_released["w"] >= 1 and -1 in ts.seq_pages["w"]


def test_prefix_cache_matches_jax():
    """A full hit, a partial hit (its tail prefilled through the GPT's
    chunk path) and a miss: hits, refcounts, the LRU, hashes, tables and
    the next tokens equal JAX's; the hit's logits equal the cold
    request's."""
    js, ts = _clear(prefix=True)
    prompt = list(range(1, 18))           # 16 KV rows: 2 full pages
    for s in (js, ts):
        s.add("cold", prompt)
    _same_cache(js, ts)
    for s in (js, ts):
        s.add("hit", prompt)
        s.add("part", prompt[:9] + [30, 31, 32, 33, 34])
        s.add("miss", [40, 41, 42])
    _same_cache(js, ts)
    assert ts.cache_hit_tokens == 16 + 8
    for s in (js, ts):
        s.remove("miss")
    ids = ["cold", "hit", "part"]
    toks = [prompt[-1], prompt[-1], 34]
    logits = ts._advance(ids, torch.tensor(toks))
    np.testing.assert_allclose(logits[1].numpy(), logits[0].numpy(),
                               atol=ATOL, rtol=0)
    js._advance(ids, jnp.asarray(toks, jnp.int32))
    _same_cache(js, ts)
    assert ts.step() == js.step()
    for s in (js, ts):
        for rid in ids:
            s.remove(rid)
    _same_cache(js, ts)


def test_greedy_engine_matches_jax_engine():
    """6 requests through max_batch=3: joins, leaves, staggered budgets, a
    stop token, and one budget that runs to the context's end."""
    js, ts = _clear()
    prompts = [[1, 2, 3], [7, 8], [4, 4, 4, 4, 4], [9], [10, 20, 30, 40],
               list(range(1, 41))]
    budgets = [5, 9, 3, 12, 6, 64]
    engines = (JaxEngine(js, decode_steps=4, max_batch=3),
               ServingEngine(ts, decode_steps=4, max_batch=3))
    for eng, params in zip(engines, (JaxParams, SamplingParams)):
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            eng.submit(p, params(max_tokens=n, stop_tokens=(60,)),
                       request_id=f"q{i}")
    want = engines[0].run()
    assert engines[1].run() == want
    assert len(want["q5"]) <= CTX - 40 + 1
    assert len(ts.free_pages) == TOTAL - 1 and not ts.seq_pages


def _spec_models():
    """The target (the module's model) and a 1-block, 16-wide, 2-head
    draft from another key (tests/test_serving.py's), JAX and port."""
    jm, tm = _models()
    jd = jax_lm(context_length=CTX, num_blocks=1, embed_dim=16,
                attention_heads=2, seed=7)
    return jm, tm, jd, torch_lm(jd, heads=2)


def test_speculative_greedy_matches_jax_and_target_only_decoding():
    """k = 3 with a disagreeing draft (rejections and corrections): round
    for round the JAX decoder's tokens; with it and with the target as its
    own draft (every proposal accepted), target-only greedy decoding."""
    jm, tm, jd, td = _spec_models()
    prompt, n = [1, 5, 2, 9], 10
    plain = BatchServer(tm, page_size=PAGE, total_pages=64)
    plain.add("x", prompt)
    expected = plain.step_many(n)["x"]
    jspec = JaxSpec(jm, jd, k=3, page_size=PAGE, total_pages=64)
    jspec.add("x", prompt)
    for tdraft in (td, tm):
        spec = SpeculativeDecoder(tm, tdraft, k=3, page_size=PAGE,
                                  total_pages=64)
        assert type(spec.target) is BatchServer
        spec.add("x", prompt)
        got = []
        while len(got) < n:
            out = spec.step()
            if tdraft is td:
                assert out == jspec.step()
            assert 1 <= len(out["x"]) <= 3
            assert tdraft is td or len(out["x"]) == 3
            got += out["x"]
        assert got[:n] == expected
        spec.remove("x")
        assert len(spec.target.free_pages) == len(spec.draft.free_pages) \
            == 63


def test_speculative_sampling_mode():
    """temperature > 0: 1 to k tokens a round, both servers' lengths kept
    in step."""
    _, tm, _, td = _spec_models()
    spec = SpeculativeDecoder(tm, td, k=3, page_size=PAGE, total_pages=64,
                              temperature=0.8, seed=1)
    spec.add("x", [1, 5, 2, 9])
    total = 0
    for _ in range(4):
        before = spec.target.seq_len["x"]
        assert spec.draft.seq_len["x"] == before
        toks = spec.step()["x"]
        assert 1 <= len(toks) <= 3 and all(0 <= t < VOCAB for t in toks)
        assert spec.target.seq_len["x"] == spec.draft.seq_len["x"] \
            == before + len(toks)
        total += len(toks)
    assert total >= 4


def test_biasless_gpt_matches_jax():
    """A GPT whose linears have no bias: no fused bias; the decode step's
    logits against the JAX model's dense forward at each position of a
    sequence (1e-4, as the full-forward check above), and a chunk against
    single steps."""
    jm, tm = _models(bias=False)
    ts = BatchServer(tm, page_size=PAGE, total_pages=TOTAL)
    assert ts._extras[1] is None
    assert tm.encoder.blocks[0].attention.w_o.bias is None
    seq = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    full, _ = jm.forward(jnp.asarray([seq], jnp.int32))
    ts.add("a", seq[:3])
    ts.add("c", seq[:3])
    for t in range(2, len(seq)):
        got = ts._advance(["a"], torch.tensor([seq[t]]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(full[0, t]),
                                   atol=1e-4, rtol=0, err_msg=f"pos {t}")
    chunk = ts.advance_chunk(["c"], [seq[2:]])[0]
    np.testing.assert_allclose(chunk.numpy(), np.asarray(full[0, 2:]),
                               atol=1e-4, rtol=0)


def test_unsupported_requests_raise_as_in_jax():
    """quantize_bits raises ValueError and an adapter NotImplementedError
    on the GPT server, as on JAX's (before any state changes);
    LoRA-draft speculation and draft_view refuse a GPT."""
    jm, tm = _models()
    for cls, model in ((JaxServer, jm), (BatchServer, tm)):
        with pytest.raises(ValueError, match="ModernBatchServer"):
            cls(model, page_size=PAGE, total_pages=4, quantize_bits=4)
    js, ts = _clear()
    for s in (js, ts):
        with pytest.raises(NotImplementedError, match="LoRA"):
            s.add("l", [1, 2], adapter="a")
    assert "l" not in ts.seq_pages
    with pytest.raises(NotImplementedError, match="LoRA"):
        ServingEngine(ts).submit([1, 2], adapter="a")
    with pytest.raises(NotImplementedError):
        LoRADraftSpeculativeDecoder(tm, tm)
    with pytest.raises(AttributeError):
        draft_view(tm, 1)
    ts.add("c", list(range(CTX)))
    ts.step()  # the last position, CTX - 1
    with pytest.raises(RuntimeError, match="context_length"):
        ts.step()
    ts.remove("c")
