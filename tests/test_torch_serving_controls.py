"""Per-request controls on the serving path: sampling penalties, multi-LoRA
adapters and LoRADraftSpeculativeDecoder of lamp_tpu_torch against
lamp_tpu's.

The model is test_torch_serving's (2 blocks, 64 wide, 4 / 2 heads, vocab
61, context 64, f32), made by lamp_tpu from a seeded key and bridged into
the port; 8-token pages, everything on CPU (the JAX server's paged kernel
in interpret mode, the port's through its plain version). Adapters are
``lamp_tpu.nn.lora_inject``-ed copies with B drawn from a seeded key (B
starts at zero), bridged with ``load_modern_lm``.

One JAX/port server pair per configuration serves the module (a JAX server
compiles its calls once per instance); :func:`_clear` removes every
sequence and resets both allocators and penalty caches alike.

Tolerances: logits at atol 1e-4 (f32 products summed in other orders; the
int4 servers quantize the same f32 weights into the same bytes); page
tables, free lists, hashes, hit counters, penalty counts and greedy tokens
exactly equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lamp_tpu.nn as jnn
from lamp_tpu.models.sampling import SamplingParams as JaxParams
from lamp_tpu.models.serving import LoRADraftSpeculativeDecoder as JaxLoRADraft
from lamp_tpu.models.serving import ModernBatchServer as JaxServer
from lamp_tpu.models.serving import ServingEngine as JaxEngine
from lamp_tpu.models.serving import draft_view as jax_draft_view
from lamp_tpu.nn.lora import LoRALinear as JaxLoRALinear
from lamp_tpu.nn.lora import _map_linears
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch.bridge import load_modern_lm
from lamp_tpu_torch.models import (LoRADraftSpeculativeDecoder,
                                   ModernBatchServer, SamplingParams,
                                   ServingEngine, draft_view)

from .test_torch_modern import jax_modern_lm, jax_params
from .test_torch_serving import ATOL, PAGE, _same_pages

TOTAL = 64
PROMPT = [1, 5, 2, 9, 11]
# the adapters of tests/test_serving.py's multi-LoRA cases
ADAPTERS = {"a1": (3, 1, lambda p: p.endswith(("w_q", "w_v"))),
            "a2": (5, 2, lambda p: "mlp" in p or p.endswith("w_o"))}


def jax_adapter(base, rank, seed, match=None, alpha=None):
    """lora_inject with B drawn at 0.3 x normal, so the adapter changes
    the outputs (tests/test_serving.py's ``_random_adapter``)."""
    tuned = jnn.lora_inject(base, rank=rank, key=jax.random.PRNGKey(seed),
                            match=match, alpha=alpha)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 100), 256))

    def visit(path, node):
        if type(node) is JaxLoRALinear:
            return node.replace(lora_b=0.3 * jax.random.normal(
                next(keys), node.lora_b.shape, node.lora_b.dtype))
        return None

    return _map_linears(tuned, visit, ())


@functools.lru_cache(maxsize=None)
def _models():
    """The JAX model, its port, and each adapter as (JAX, port) models."""
    jm = jax_modern_lm()
    tm = load_modern_lm(jax_params(jm), device="cpu")
    ads = {}
    for name, (rank, seed, match) in ADAPTERS.items():
        ja = jax_adapter(jm, rank, seed, match)
        ads[name] = (ja, load_modern_lm(jax_params(ja), device="cpu"))
    return jm, tm, ads


@functools.lru_cache(maxsize=None)
def _pair(bits=None):
    """A JAX and a port ModernBatchServer over one model, prefix cache on,
    ADAPTERS registered (int4 weights where ``bits``). The cases keep to
    batches of 3 and ``step_many(2)``, so that the JAX server compiles
    few shapes."""
    jm, tm, ads = _models()
    kw = dict(page_size=PAGE, total_pages=TOTAL, quantize_bits=bits,
              enable_prefix_cache=True)
    js, ts = JaxServer(jm, **kw), ModernBatchServer(tm, **kw)
    for name, (ja, ta) in ads.items():
        js.register_adapter(name, ja)
        ts.register_adapter(name, ta)
    return js, ts


def _clear(bits=None):
    js, ts = _pair(bits)
    for s in (js, ts):
        for rid in list(s.seq_pages):
            s.remove(rid)
        s.free_pages[:] = range(TOTAL - 1, 0, -1)
        for state in (s._page_refs, s._lru, s._hash_to_page, s._page_hash):
            state.clear()
        s.cache_hit_tokens = s.cache_miss_tokens = 0
        s._pen_cache = None
    return js, ts


def _same_counts(js, ts):
    """The penalty caches: the batch's ids, counts and prompt masks."""
    jc, tc = js._pen_cache, ts._pen_cache
    assert (jc is None) == (tc is None)
    if jc is None:
        return
    assert tc[0] == jc[0]
    np.testing.assert_array_equal(tc[1].numpy(), np.asarray(jc[1]))
    np.testing.assert_array_equal(tc[2].numpy(), np.asarray(jc[2]))


PENALTIES = {"pres": dict(presence_penalty=1000.0),
             "rep": dict(repetition_penalty=1.3, frequency_penalty=0.5),
             "mix": dict(presence_penalty=0.7, frequency_penalty=0.3,
                         repetition_penalty=0.8),
             "none": dict()}


def test_penalties_step_and_step_many_match_jax():
    """Greedy requests under presence, repetition + frequency and mixed
    penalties beside a plain one, through step and step_many while
    requests join and leave: the tokens, the pages and the [B, V] count
    stacks equal JAX's after every call. A fork's counts restart at zero
    (it is marked dirty) while its parent keeps its own, as in the JAX
    server. A presence penalty of 1000 makes every token of its request
    distinct."""
    js, ts = _clear()
    prompts = {"pres": [3, 1, 4, 1, 5], "rep": [9, 2, 6], "mix": [5, 3, 5],
               "none": [7, 7, 7, 2]}

    def add(rid):
        js.add(rid, prompts[rid], JaxParams(**PENALTIES[rid]))
        ts.add(rid, prompts[rid], SamplingParams(**PENALTIES[rid]))

    for rid in ("pres", "rep", "none"):
        add(rid)
    emitted = {}

    def call(fn):
        want, got = fn(js), fn(ts)
        assert got == want
        for rid, t in got.items():
            emitted.setdefault(rid, []).extend(
                t if isinstance(t, list) else [t])
        _same_pages(js, ts)
        _same_counts(js, ts)

    call(lambda s: s.step())
    call(lambda s: s.step_many(2))
    for s in (js, ts):
        s.remove("rep")                     # leaves: survivors gathered
    add("mix")                              # joins: a zeroed row
    call(lambda s: s.step_many(2))
    call(lambda s: s.step())
    assert ts._pen_cache[0] == ("pres", "none", "mix")
    for s in (js, ts):
        s.remove("none")
        s.fork("pres", "pres2")
    call(lambda s: s.step())
    counts = ts._pen_cache[1]
    assert [int(c.sum()) for c in counts] == [7, 4, 1]  # pres, mix, pres2
    call(lambda s: s.step_many(2))
    assert len(emitted["pres"]) == 9 == len(set(emitted["pres"]))


def test_mixed_adapter_batch_matches_jax():
    """One batch of base + two adapters (ranks 3 and 5, on q/v and on
    o/MLP): ``_advance`` and ``advance_chunk`` logits against the JAX
    server's (tests/test_serving.py's multi-LoRA case); an adapter's
    prompt prefills through the chunk path on both sides, and the page
    tables stay equal."""
    js, ts = _clear()
    for s in (js, ts):
        s.add("rb", PROMPT)
        s.add("r1", PROMPT, adapter="a1")
        s.add("r2", PROMPT, adapter="a2")
    _same_pages(js, ts)
    assert ts.seq_adapter == js.seq_adapter == {"rb": 0, "r1": 1, "r2": 2}
    ids = ["rb", "r1", "r2"]
    want = js._advance(ids, jnp.asarray([7, 7, 7], jnp.int32))
    got = ts._advance(ids, torch.tensor([7, 7, 7]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert np.abs(np.asarray(want[0] - want[1])).max() > 1e-2
    chunk = np.asarray([[3, 8], [3, 8], [3, 8]], np.int32)
    want_c = js.advance_chunk(ids, chunk)
    got_c = ts.advance_chunk(ids, chunk)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=ATOL,
                               rtol=0)
    _same_pages(js, ts)
    assert ts.step_many(2) == js.step_many(2)


def test_port_adapter_equals_its_merged_model():
    """An adapter made by the port's own lora_inject (A from a torch
    Generator) serves the same greedy tokens as a server over its
    ``lora_merge``d model."""
    _, tm, _ = _models()
    gen = torch.Generator().manual_seed(3)
    tuned = tnn.lora_inject(tm, rank=4, generator=gen, alpha=8.0)
    with torch.no_grad():
        for m in tuned.modules():
            if type(m) is tnn.LoRALinear:
                m.lora_b.normal_(0.0, 0.3, generator=gen)
    server = ModernBatchServer(tm, page_size=PAGE, total_pages=32)
    server.register_adapter("t", tuned)
    merged = ModernBatchServer(tnn.lora_merge(tuned), page_size=PAGE,
                               total_pages=32)
    server.add("x", PROMPT, adapter="t")
    merged.add("x", PROMPT)
    assert server.step_many(6) == merged.step_many(6)


def test_prefix_cache_is_partitioned_by_adapter():
    """The same prompt under the base and under an adapter shares no page;
    the same adapter hits (tests/test_serving.py's partition case). The
    salts, hashes, pages and counters equal JAX's."""
    js, ts = _clear()
    prompt = list(range(1, 18))  # 16 KV rows: 2 full pages
    for rid, adapter in (("b0", None), ("b1", "a1"), ("b2", "a1"),
                         ("b3", "a2"), ("b4", None)):
        for s in (js, ts):
            s.add(rid, prompt, adapter=adapter)
        _same_pages(js, ts)
        assert ts._hash_to_page == js._hash_to_page
        assert ts._page_refs == js._page_refs
        assert (ts.cache_hit_tokens, ts.cache_miss_tokens) == \
            (js.cache_hit_tokens, js.cache_miss_tokens)
    assert ts.seq_pages["b1"][:2] != ts.seq_pages["b0"][:2]
    assert ts.seq_pages["b2"][:2] == ts.seq_pages["b1"][:2]
    assert ts.seq_pages["b4"][:2] == ts.seq_pages["b0"][:2]
    assert ts.cache_hit_tokens == 32
    for s in (js, ts):
        s.remove("b0")
        s.remove("b4")
    assert ts.step_many(2) == js.step_many(2)
    _same_pages(js, ts)
    assert ts._page_refs == js._page_refs


def test_engine_with_adapters_penalties_and_fanout():
    """ServingEngine with an adapter request, a penalised one and a base
    one (greedy): tokens equal the JAX engine's. A fan-out's branches keep
    the parent's adapter and penalties; unknown adapters raise early."""
    js, ts = _clear()
    engines = (JaxEngine(js, decode_steps=2),
               ServingEngine(ts, decode_steps=2))
    for eng, P in zip(engines, (JaxParams, SamplingParams)):
        eng.submit([1, 2, 3], P(max_tokens=6), request_id="x", adapter="a2")
        eng.submit([1, 2, 3], P(max_tokens=7, presence_penalty=2.0),
                   request_id="y", adapter="a1")
        eng.submit([4, 5], P(max_tokens=5), request_id="z")
    want = engines[0].run()
    assert engines[1].run() == want
    assert [len(want[r]) for r in "xyz"] == [6, 7, 5]
    eng = engines[1]
    eng.submit([1, 2, 3], SamplingParams(temperature=0.8, max_tokens=4,
                                         frequency_penalty=0.5),
               request_id="f", adapter="a1", n=2)
    eng.step()
    assert {ts.seq_adapter[("f", i)] for i in range(2)} == {1}
    assert all(ts.seq_params[("f", i)].frequency_penalty == 0.5
               for i in range(2))
    res = eng.run()
    assert [len(b) for b in res["f"]] == [4, 4]
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit([1, 2], adapter="nope")
    with pytest.raises(ValueError, match="unknown adapter"):
        ts.add("n", [1, 2], adapter="nope")
    assert "n" not in ts.seq_pages and "n" not in ts.seq_adapter


def test_register_adapter_rejects_unservable_projections():
    """An adapter on an untied lm_head cannot be served (only the block
    projections are); a name registers once."""
    jm = jax_modern_lm(tied=False)
    tm = load_modern_lm(jax_params(jm), device="cpu")
    tuned = tnn.lora_inject(tm, rank=2,
                            generator=torch.Generator().manual_seed(1))
    server = ModernBatchServer(tm, page_size=PAGE, total_pages=32)
    with pytest.raises(ValueError, match="not servable"):
        server.register_adapter("bad", tuned)
    ok = tnn.lora_inject(tm, rank=2, generator=torch.Generator(),
                         match=lambda p: p.startswith("blocks"))
    server.register_adapter("ok", ok)
    with pytest.raises(ValueError, match="duplicate"):
        server.register_adapter("ok", ok)


def test_int4_adapters_match_jax():
    """quantize_bits=4 with adapters: the delta beside the int4 products.
    The adapters' prompts prefill through the int4 chunk path; the
    mixed batch's _advance logits and greedy step_many tokens equal JAX's
    int4 server's."""
    js, ts = _clear(bits=4)
    for s in (js, ts):
        s.add("rb", PROMPT)
        s.add("r1", PROMPT, adapter="a1")
        s.add("r2", [4, 4, 2], adapter="a2")
    ids = ["rb", "r1", "r2"]
    want = js._advance(ids, jnp.asarray([7, 3, 1], jnp.int32))
    got = ts._advance(ids, torch.tensor([7, 3, 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert ts.step_many(2) == js.step_many(2)
    _same_pages(js, ts)


@functools.lru_cache(maxsize=None)
def _lora_drafts():
    """A 3-block target and a 1-block LoRA draft (rank 2, B random), as
    tests/test_serving.py's LoRA-draft case: (JAX target, JAX draft, port
    target, port draft)."""
    jm = jax_modern_lm(num_blocks=3)
    jd = jax_adapter(jax_draft_view(jm, 1), 2, 1)
    return (jm, jd, load_modern_lm(jax_params(jm), device="cpu"),
            load_modern_lm(jax_params(jd), device="cpu"))


def test_lora_draft_speculative_matches_jax_and_target_greedy():
    """LoRA-draft speculation (k = 3): the emitted greedy stream equals
    target-only greedy decoding and the JAX decoder's, round for round;
    the draft's decode weights are the target's tensors."""
    jm, jd, tm, td = _lora_drafts()
    prompt, n_tokens = [1, 4, 7, 2, 9], 12
    plain = ModernBatchServer(tm, page_size=PAGE, total_pages=TOTAL)
    plain.add("x", prompt)
    expected = plain.step_many(n_tokens)["x"]
    jspec = JaxLoRADraft(jm, jd, k=3, page_size=PAGE, total_pages=TOTAL)
    spec = LoRADraftSpeculativeDecoder(tm, td, k=3, page_size=PAGE,
                                       total_pages=TOTAL)
    for s in (jspec, spec):
        s.add("x", prompt)
    assert spec.draft.seq_adapter["x"] == 1
    got = []
    while len(got) < n_tokens:
        out = spec.step()
        assert out == jspec.step()
        got.extend(out["x"])
    assert got[:n_tokens] == expected
    te, de = spec.target._extras, spec.draft._extras
    for t_group, d_group in zip(te[:-1], de[:-1]):
        assert len(d_group) == 1
        assert d_group[0] is t_group[0]
        assert d_group[0].data_ptr() == t_group[0].data_ptr()
    assert de[-1] is te[-1]
    spec.remove("x")
    assert len(spec.draft.free_pages) == TOTAL - 1


@pytest.mark.parametrize("bits", [None, 4])
def test_lora_draft_full_depth_shares_the_target(bits):
    """The draft's decode weights are the target's tensors, the packed
    int4 pairs included. Unquantized, a full-depth draft whose B is zero
    is the target, so every proposal is accepted; under int4 (where the
    target prefills with the float weights and the draft's adapter prompt
    through the int4 chunk path) the stream still equals target-only
    greedy decoding."""
    _, _, tm, _ = _lora_drafts()
    lora = tnn.lora_inject(draft_view(tm, 3), rank=2,
                           generator=torch.Generator().manual_seed(4))
    spec = LoRADraftSpeculativeDecoder(tm, lora, k=4, page_size=PAGE,
                                       total_pages=TOTAL, quantize_bits=bits)
    te, de = spec.target._extras, spec.draft._extras
    for t_group, d_group in zip(te[:-1], de[:-1]):
        for t_w, d_w in zip(t_group, d_group):
            assert d_w is t_w
    assert de[-1] is te[-1]
    prompt = [1, 4, 7, 2, 9]
    plain = ModernBatchServer(tm, page_size=PAGE, total_pages=TOTAL,
                              quantize_bits=bits)
    plain.add("x", prompt)
    expected = plain.step_many(12)["x"]
    spec.add("x", prompt)
    got = []
    for _ in range(3):
        out = spec.step()["x"]
        assert bits or len(out) == 4
        got += out
    assert got == expected[:len(got)]


def test_lora_draft_total_pages_sizes_the_draft_pool_as_jax():
    """draft_total_pages sizes the draft server's pool (the target keeps
    total_pages), as in the JAX decoder: both servers' page counts, pools
    and free lists equal JAX's, before and after a request."""
    jm, jd, tm, td = _lora_drafts()
    kw = dict(k=3, page_size=PAGE, total_pages=TOTAL, draft_total_pages=12)
    jspec, spec = JaxLoRADraft(jm, jd, **kw), \
        LoRADraftSpeculativeDecoder(tm, td, **kw)
    for s in (jspec, spec):
        s.add("x", [1, 4, 7, 2, 9])
    assert spec.step() == jspec.step()
    for got, want in ((spec.target, jspec.target), (spec.draft, jspec.draft)):
        assert got.total_pages == want.total_pages
        assert tuple(got.kv_pages.shape) == want.kv_pages.shape
        _same_pages(want, got)
    assert (spec.target.total_pages, spec.draft.total_pages) == (TOTAL, 12)


def test_lora_draft_validation():
    """A draft deeper than the target raises ValueError; a GPT target
    NotImplementedError (tests/test_serving.py's validation case)."""
    _, _, tm, td = _lora_drafts()
    deep = load_modern_lm(jax_params(jax_modern_lm(num_blocks=4)),
                          device="cpu")
    lora_deep = tnn.lora_inject(deep, rank=2, generator=torch.Generator())
    with pytest.raises(ValueError, match="blocks"):
        LoRADraftSpeculativeDecoder(tm, lora_deep, page_size=PAGE,
                                    total_pages=TOTAL)
    gpt = tnn.LanguageModelModule.init(
        vocab_size=23, context_length=32, num_blocks=2, embed_dim=32,
        attention_heads=4, generator=torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError):
        LoRADraftSpeculativeDecoder(gpt, td)
