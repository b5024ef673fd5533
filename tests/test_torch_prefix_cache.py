"""Shared KV pages: the prefix cache, copy-on-write, fork, n/best_of
fan-out and beam search of lamp_tpu_torch against lamp_tpu's.

The model is test_torch_serving's (2 blocks, 64 wide, 4 / 2 heads, vocab
61, context 64, f32), made by lamp_tpu from a seeded key and bridged into
the port; 8-token pages, everything on CPU (the JAX server's paged kernel
in interpret mode, the port's through its plain version).

One server pair (JAX, port) per configuration serves the whole module: a
JAX server compiles its calls once per instance, and that compile is most
of a case's time. Each test starts from :func:`_fresh`, which removes every
sequence and empties both allocators alike (free list, refcounts, LRU, hash
map, counters), to ``usable`` pages where a JAX test cuts its pool (7
usable pages stand for ``total_pages=8``: the same page ids 1-7).

Tolerances: logits at atol 1e-4 (f32 products summed in other orders;
5e-3 on the fp8 pool, as test_torch_serving's fp8 test states); page
tables, free lists, refcounts, LRU order, hash map, hit and miss counters,
greedy tokens and beam tokens exactly equal; beam scores within 1e-5. The
sampled fan-out branches agree with JAX's in structure (admission, page
tables, branch counts and lengths), not in tokens: the port draws from a
``torch.Generator``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu.models.sampling import SamplingParams as JaxParams
from lamp_tpu.models.serving import BeamSearchDecoder as JaxBeams
from lamp_tpu.models.serving import ModernBatchServer as JaxServer
from lamp_tpu.models.serving import ServingEngine as JaxEngine
from lamp_tpu.models.serving import SpeculativeDecoder as JaxSpec
from lamp_tpu.models.serving import draft_view as jax_draft_view
from lamp_tpu_torch.bridge import load_modern_lm
from lamp_tpu_torch.models import (BeamSearchDecoder, ModernBatchServer,
                                   SamplingParams, ServingEngine,
                                   SpeculativeDecoder, draft_view)

from .test_torch_modern import jax_modern_lm, jax_params
from .test_torch_serving import ATOL, PAGE
from .test_torch_serving import _same_pages as _same_tables

TOTAL = 64
PROMPT = list(range(1, 18))  # 16 KV rows: exactly 2 full pages


@functools.lru_cache(maxsize=None)
def _pair(fp8=False):
    """A JAX and a port ModernBatchServer over one model, prefix cache on,
    64 pages (an e4m3 pool where ``fp8``)."""
    jm = jax_modern_lm()
    tm = load_modern_lm(jax_params(jm), device="cpu")
    kw = dict(page_size=PAGE, total_pages=TOTAL, enable_prefix_cache=True)
    return (JaxServer(jm, **kw, kv_dtype=jnp.float8_e4m3fn if fp8 else None),
            ModernBatchServer(tm, **kw, kv_dtype=torch.float8_e4m3fn
                              if fp8 else None))


def _fresh(fp8=False, usable=TOTAL - 1):
    js, ts = _pair(fp8)
    for s in (js, ts):
        for rid in list(s.seq_pages):
            s.remove(rid)
        s.free_pages[:] = range(usable, 0, -1)
        for state in (s._page_refs, s._lru, s._hash_to_page, s._page_hash):
            state.clear()
        s.cache_hit_tokens = s.cache_miss_tokens = 0
    ts.cow_copies = 0
    return js, ts


def _same_pages(js, ts):
    """test_torch_serving's page tables, lengths and free lists, and the
    prefix cache's refcounts, LRU order, hash map and counters."""
    _same_tables(js, ts)
    assert ts._page_refs == js._page_refs
    assert list(ts._lru) == list(js._lru)
    assert ts._hash_to_page == js._hash_to_page
    assert ts._page_hash == js._page_hash
    assert (ts.cache_hit_tokens, ts.cache_miss_tokens) == \
        (js.cache_hit_tokens, js.cache_miss_tokens)
    assert ts.available_pages == js.available_pages


def _both(js, ts, fn):
    """``fn(server)`` on the JAX server, then on the port's; the pages must
    agree after."""
    fn(js)
    fn(ts)
    _same_pages(js, ts)


def _advance(js, ts, ids, toks, atol=ATOL):
    """One ``_advance`` of both servers: logits at ``atol``, pages equal."""
    want = js._advance(ids, jnp.asarray(toks, jnp.int32))
    got = ts._advance(ids, torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)
    _same_pages(js, ts)
    return got


def _uncached(ts, prompt, steps):
    """Greedy tokens of a port server without the prefix cache."""
    plain = ModernBatchServer(ts.model, page_size=PAGE, total_pages=32)
    plain.add("r", prompt)
    return [plain.step()["r"] for _ in range(steps)]


def test_full_and_partial_hit_match_jax():
    """Shared prompt prefixes reuse physical pages; a partial hit prefills
    its tail as one chunk. The caches, page tables and greedy tokens equal
    JAX's after every add and step, and the tokens equal an uncached
    server's."""
    js, ts = _fresh()
    prompts = {"a": PROMPT, "b": PROMPT[:-1] + [9],  # full hit
               "c": PROMPT[:16] + [4, 7, 6]}         # 2 pages + 2 rows
    for rid, p in prompts.items():
        _both(js, ts, lambda s: s.add(rid, p))
    assert (ts.cache_hit_tokens, ts.cache_miss_tokens) == (32, 16 + 2)
    assert ts.seq_pages["a"][:2] == ts.seq_pages["b"][:2] \
        == ts.seq_pages["c"][:2]
    assert ts._page_refs[ts.seq_pages["a"][0]] == 3
    out = []
    for _ in range(4):
        want = js.step()
        got = ts.step()
        assert got == want
        _same_pages(js, ts)
        out.append(got)
    for rid, p in prompts.items():
        assert [o[rid] for o in out] == _uncached(ts, p, 4)
    for rid in prompts:
        _both(js, ts, lambda s: s.remove(rid))
    assert len(ts._lru) == 2 and ts.cow_copies == 0


def test_cache_survives_removal_and_evicts_under_pressure():
    """A removed request's full pages stay cached on the LRU, a later hit
    takes them back, and allocation pressure reclaims them (least recently
    used first, with their hash entries) in a pool of 7 pages."""
    js, ts = _fresh(usable=7)
    _both(js, ts, lambda s: s.add("a", PROMPT))
    assert ts.step() == js.step()
    _both(js, ts, lambda s: s.remove("a"))
    assert len(ts._lru) == 2
    _both(js, ts, lambda s: s.add("b", PROMPT))  # a hit from the LRU
    assert ts.cache_hit_tokens == 16 and not ts._lru
    _both(js, ts, lambda s: s.remove("b"))
    _both(js, ts, lambda s: s.add("c", list(range(30, 47))))
    _both(js, ts, lambda s: s.add("d", [2] * 9))
    assert ts.step() == js.step()
    _same_pages(js, ts)
    assert not ts.free_pages and len(ts._lru) == 2
    first = next(iter(ts._lru))  # the prompt's first page, used longest ago
    first_hash = ts._page_hash[first]
    _both(js, ts, lambda s: s.add("e", [5] * 9))  # reclaims it
    assert ts.seq_pages["e"] == [first] and len(ts._lru) == 1
    assert first_hash not in ts._hash_to_page
    for rid in "cde":
        _both(js, ts, lambda s: s.remove(rid))
    assert ts.available_pages == 7
    # the prompt's first page is no longer cached: a miss, not a stale hit
    _both(js, ts, lambda s: s.add("f", PROMPT))
    assert ts.cache_hit_tokens == 16


def test_copy_on_write_on_rewind():
    """Rewinding into a shared page and advancing copies the page: the
    other sequence's cached KV is untouched and decodes as before."""
    js, ts = _fresh()
    for rid in "ab":
        _both(js, ts, lambda s: s.add(rid, PROMPT))
    shared = ts.seq_pages["b"][1]
    _both(js, ts, lambda s: s.rewind("b", 1))
    _advance(js, ts, ["b"], [3])
    assert ts.seq_pages["b"][1] != shared and ts.seq_pages["a"][1] == shared
    assert ts._page_refs[shared] == 1 and ts.cow_copies == 1
    got = []
    for _ in range(4):
        want = js.step()
        got.append(ts.step())
        assert got[-1] == want
    assert [g["a"] for g in got] == _uncached(ts, PROMPT, 4)


def test_fork_shares_pages_and_cow_diverges():
    """A fork takes no page; parent and child then diverge, the first write
    into their shared tail page copying it, and each decodes as a fresh
    prefill of its own history (held against JAX's logits and a plain
    port server's)."""
    js, ts = _fresh()
    prompt = [1, 4, 7, 2, 9]
    _both(js, ts, lambda s: s.add("a", prompt))
    assert ts.step() == js.step()
    free = ts.available_pages
    _both(js, ts, lambda s: s.fork("a", "b"))
    assert ts.available_pages == free and ts.seq_pages["a"] == \
        ts.seq_pages["b"]
    got = [_advance(js, ts, [rid], [t])
           for rid, t in (("a", 11), ("b", 13), ("a", 17), ("b", 19))]
    assert ts.cow_copies == 1
    ref = ModernBatchServer(ts.model, page_size=PAGE, total_pages=32)
    ref.add("x", prompt + [11])
    ref.add("y", prompt + [13])
    want = [ref._advance([rid], torch.tensor([t]))
            for rid, t in (("x", 11), ("y", 13), ("x", 17), ("y", 19))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=0)
    for rid in "ab":
        _both(js, ts, lambda s: s.remove(rid))
    assert not ts.seq_pages and ts.available_pages == TOTAL - 1


def test_fork_and_beams_need_the_prefix_cache():
    plain = ModernBatchServer(_pair()[1].model, page_size=PAGE,
                              total_pages=8)
    plain.add("a", [1, 2, 3])
    with pytest.raises(RuntimeError, match="prefix_cache"):
        plain.fork("a", "b")
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        BeamSearchDecoder(plain)
    _, ts = _fresh()
    ts.add("a", [1, 2, 3])
    with pytest.raises(ValueError, match="duplicate"):
        ts.fork("a", "a")
    with pytest.raises(KeyError, match="unknown"):
        ts.fork("z", "b")
    with pytest.raises(ValueError, match="beams"):
        BeamSearchDecoder(ts, beams=0)


def _beams(js, ts, prompt, **kw):
    """Both decoders' hypotheses for one prompt: tokens exact, scores within
    1e-5, the pages equal after."""
    decode = kw.pop("decode")
    want = JaxBeams(js, **kw).decode(prompt, **decode)
    got = BeamSearchDecoder(ts, **kw).decode(prompt, **decode)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([sc for _, sc in got], [sc for _, sc in want],
                               atol=1e-5, rtol=0)
    _same_pages(js, ts)
    assert not ts.seq_pages
    return got


def test_beam_width1_is_greedy():
    js, ts = _fresh()
    prompt = [1, 4, 7, 2]
    hyps = _beams(js, ts, prompt, beams=1, length_penalty=0.0,
                  decode=dict(max_tokens=6))
    assert len(hyps) == 1 and hyps[0][0] == _uncached(ts, prompt, 6)
    assert ts.available_pages == TOTAL - 1 and ts.cow_copies == 0


def _seq_logprob(ts, prompt, tokens):
    srv = ModernBatchServer(ts.model, page_size=PAGE, total_pages=32)
    srv.add("s", prompt)
    total, feed = 0.0, prompt[-1]
    for t in tokens:
        logits = srv._advance(["s"], torch.tensor([feed]))
        total += float(torch.log_softmax(logits, -1)[0, t])
        feed = t
    return total


def test_beam_hypotheses_and_scores_match_jax():
    """Width 4 over 5 steps: JAX's hypotheses, sorted best first, distinct,
    each score the model's own logprob of its tokens, the best at least
    greedy's; the beams' forks copied their shared tail pages."""
    js, ts = _fresh()
    prompt = [3, 11, 5]
    hyps = _beams(js, ts, prompt, beams=4, length_penalty=0.0,
                  decode=dict(max_tokens=5))
    scores = [sc for _, sc in hyps]
    assert len(hyps) == 4 and scores == sorted(scores, reverse=True)
    assert len({tuple(t) for t, _ in hyps}) == 4
    for tokens, score in hyps:
        np.testing.assert_allclose(score, _seq_logprob(ts, prompt, tokens),
                                   atol=1e-4, rtol=1e-4)
    greedy = _uncached(ts, prompt, 5)
    assert scores[0] >= _seq_logprob(ts, prompt, greedy) - 1e-5
    assert ts.cow_copies > 0


def test_beam_stop_tokens_and_early_stopping():
    js, ts = _fresh()
    prompt = [1, 4, 7, 2]
    stop = _uncached(ts, prompt, 2)[1]  # greedy's second token
    hyps = _beams(js, ts, prompt, beams=3,
                  decode=dict(max_tokens=10, stop_tokens=(stop,)))
    assert 1 <= len(hyps) <= 3
    assert all(stop not in tokens for tokens, _ in hyps)


def _engines(usable=TOTAL - 1, **kw):
    js, ts = _fresh(usable=usable)
    streams = ([], [])
    engines = tuple(cls(s, decode_steps=4, on_token=lambda rid, t, o=out:
                        o.append((rid, t)), **kw)
                    for cls, s, out in ((JaxEngine, js, streams[0]),
                                        (ServingEngine, ts, streams[1])))
    return js, ts, engines, streams


def _run_engines(js, ts, engines):
    """Both engines step by step: the same requests admitted, the same
    page tables, and the same requests finishing at every step."""
    while engines[1].pending or ts.seq_pages:
        want = engines[0].step()
        got = engines[1].step()
        assert got.keys() == want.keys()
        _same_pages(js, ts)
        assert [e[0] for e in engines[1].pending] == \
            [e[0] for e in engines[0].pending]
    assert not engines[0].pending and not js.seq_pages
    return engines[1].results


def test_fanout_n_matches_jax_in_structure():
    """n=3 sampled branches: a list of 3 token lists, streamed under (rid,
    i), beside a plain request; admission and pages as JAX's; the pool
    returns."""
    js, ts, engines, streams = _engines()
    for eng, params in zip(engines, (JaxParams, SamplingParams)):
        eng.submit([1, 2, 3], params(max_tokens=8, temperature=3.0),
                   request_id="a", n=3)
        eng.submit([4, 5], params(max_tokens=4), request_id="b")
    res = _run_engines(js, ts, engines)
    assert len(res["a"]) == 3 and [len(b) for b in res["a"]] == [8] * 3
    assert len({tuple(b) for b in res["a"]}) > 1
    assert res["b"] == engines[0].results["b"]  # greedy: the same tokens
    for i in range(3):
        assert [t for r, t in streams[1] if r == ("a", i)] == res["a"][i]
    assert [r for r, _ in streams[1]] == [r for r, _ in streams[0]]
    assert "a" not in engines[1].result_logprobs
    assert ts.available_pages == TOTAL - 1


def test_fanout_in_a_small_pool():
    """Four branches that fit two at a time (5 usable pages) drain in JAX's
    order, with no false stall."""
    js, ts, engines, _ = _engines(usable=5)
    for eng, params in zip(engines, (JaxParams, SamplingParams)):
        eng.submit([1, 2, 3, 4], params(max_tokens=6, temperature=1.0),
                   request_id="a", n=4)
    res = _run_engines(js, ts, engines)
    assert [len(b) for b in res["a"]] == [6] * 4


def test_best_of_ranks_by_summed_logprob():
    """best_of keeps the branches of highest summed logprob, best first;
    with n=1 the result is a plain token list and the logprobs stay hidden
    unless asked for."""
    js, ts, engines, _ = _engines()
    for eng, params in zip(engines, (JaxParams, SamplingParams)):
        eng.submit([1, 2, 3], params(max_tokens=6, temperature=2.0,
                                     logprobs=True),
                   request_id="a", n=2, best_of=3)
        eng.submit([1, 2, 3], params(max_tokens=6, temperature=2.0),
                   request_id="b", n=1, best_of=4)
    res = _run_engines(js, ts, engines)
    lps = engines[1].result_logprobs["a"]
    assert len(res["a"]) == 2
    assert [len(lp) for lp in lps] == [len(b) for b in res["a"]] == [6, 6]
    sums = [sum(lp) for lp in lps]
    assert sums == sorted(sums, reverse=True)
    assert all(lp <= 0 for lp in lps[0])
    assert len(res["b"]) == 6 and isinstance(res["b"][0], int)
    assert "b" not in engines[1].result_logprobs


def test_fanout_validation_and_cancel():
    """The same refusals as JAX's; cancelling a fan-out parent cancels
    every branch and frees their pages."""
    _, ts = _fresh()
    for eng, params in ((JaxEngine(_pair()[0]), JaxParams),
                        (ServingEngine(ts), SamplingParams)):
        with pytest.raises(ValueError, match="temperature"):
            eng.submit([1, 2], params(max_tokens=4), n=2)
        with pytest.raises(ValueError, match="best_of"):
            eng.submit([1, 2], params(max_tokens=4, temperature=1.0), n=3,
                       best_of=2)
        with pytest.raises(ValueError, match="n must"):
            eng.submit([1, 2], params(max_tokens=4), n=0)
    eng = ServingEngine(ts, decode_steps=4, max_batch=2)
    eng.submit([1, 2, 3], SamplingParams(max_tokens=8, temperature=1.0),
               request_id="a", n=3)
    eng.step()  # two branches in flight, one queued
    assert len(ts.seq_pages) == 2 and len(eng.pending) == 1
    assert eng.cancel("a") and not eng.cancel("a")
    assert not ts.seq_pages and not eng.pending and not eng._fan
    assert ts.available_pages == TOTAL - 1 and eng.run() == {}


def test_fp8_pool_copy_on_write():
    """An e4m3 pool's page copied on write through its uint8 view: the
    copy holds the shared page's bytes in every layer (the rows it keeps
    equal JAX's copy byte for byte), and both sequences decode as JAX's
    (logits at 5e-3, see the module's note)."""
    js, ts = _fresh(fp8=True)
    for rid in "ab":
        _both(js, ts, lambda s: s.add(rid, PROMPT))
    shared = ts.seq_pages["b"][1]
    _both(js, ts, lambda s: s.rewind("b", 2))
    _advance(js, ts, ["b"], [3], atol=5e-3)
    new = ts.seq_pages["b"][1]
    assert new != shared and ts.cow_copies == 1
    layers, p = len(ts.model.blocks), ts.total_pages
    got = ts.kv_pages.view(torch.uint8).numpy().reshape(layers, p, 2, PAGE,
                                                        -1)
    want = np.asarray(js.kv_pages).view(np.uint8).reshape(got.shape)
    # slots 0-5 were copied; slot 6 was written after the copy
    np.testing.assert_array_equal(got[:, new, :, :6], got[:, shared, :, :6])
    np.testing.assert_array_equal(got[:, new, :, :6], want[:, new, :, :6])
    for _ in range(3):
        _advance(js, ts, ["a", "b"], [5, 7], atol=5e-3)


def test_request_window_salts_the_cache():
    """A request window changes the K/V of every later layer, so the cache
    keeps windowed prompts apart (the salt "0:<window>"): only the same
    window hits."""
    js, ts = _fresh()
    for rid, window, hits in (("w5", 5, 0), ("none", None, 0),
                              ("w5b", 5, 16), ("w6", 6, 16)):
        _both(js, ts, lambda s: s.add(rid, PROMPT, window=window))
        assert ts.cache_hit_tokens == hits
    assert len(ts._hash_to_page) == 6  # w5, none and w6: 2 pages each
    assert ts.seq_pages["w5b"][:2] == ts.seq_pages["w5"][:2]
    for _ in range(2):
        assert ts.step() == js.step()
        _same_pages(js, ts)


def test_speculative_decoding_over_prefix_cache_servers():
    """SpeculativeDecoder on prefix-cache servers (target: the 2-block
    model; draft: its first block), over a full and a partial hit. After
    two rounds, "b" rewinds into its shared prompt page on both servers,
    so the next round's writes copy it. Greedy tokens, page tables and
    caches equal JAX's throughout; the pools return."""
    js, ts = _pair()
    jspec = JaxSpec(js.model, jax_draft_view(js.model, 1), k=4,
                    page_size=PAGE, total_pages=32,
                    server_cls=functools.partial(JaxServer,
                                                 enable_prefix_cache=True))
    tspec = SpeculativeDecoder(
        ts.model, draft_view(ts.model, 1), k=4, page_size=PAGE,
        total_pages=32, server_cls=functools.partial(
            ModernBatchServer, enable_prefix_cache=True))
    prompts = {"a": PROMPT, "b": PROMPT, "c": PROMPT[:16] + [4, 7, 6]}

    def same():
        for side in ("target", "draft"):
            _same_pages(getattr(jspec, side), getattr(tspec, side))

    for rid, p in prompts.items():
        jspec.add(rid, p)
        tspec.add(rid, p)
    same()
    assert tspec.target.cache_hit_tokens == 32
    for rnd in range(4):
        if rnd == 2:
            for spec in (jspec, tspec):
                for server in (spec.target, spec.draft):
                    server.rewind("b", server.seq_len["b"] - 13)
                    server.last_token["b"] = 3
            same()
        assert tspec.step() == jspec.step()
        same()
    assert tspec.target.cow_copies == 1 and tspec.draft.cow_copies == 1
    for rid in prompts:
        jspec.remove(rid)
        tspec.remove(rid)
    same()
    assert tspec.target.available_pages == 31
