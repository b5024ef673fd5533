"""Constrained decoding: lamp_tpu_torch.models.constrained (the port's copy
of the regex -> DFA compiler and the token lift) and the serving path's
masked sampling against lamp_tpu's.

The compiler's tables and accepting sets must equal JAX's exactly, over
tests/test_constrained.py's regex cases, its multibyte vocabulary and JSON
at depths 2 and 3. The serving model is tests/test_constrained.py's shape
(a byte-vocabulary ModernLM: vocab 256, context 128, 2 blocks, 32 wide,
4 / 2 heads, f32), made by lamp_tpu from a seeded key and bridged, behind
one JAX/port server pair with 8-token pages on CPU. Greedy tokens, page
tables and automaton states must be exactly equal.
"""

import functools
import json

import numpy as np
import pytest

from lamp_tpu.models import constrained as jax_constrained
from lamp_tpu.models.sampling import SamplingParams as JaxParams
from lamp_tpu.models.serving import ModernBatchServer as JaxServer
from lamp_tpu.models.serving import ServingEngine as JaxEngine
from lamp_tpu_torch.bridge import load_modern_lm
from lamp_tpu_torch.models import (ModernBatchServer, SamplingParams,
                                   ServingEngine)
from lamp_tpu_torch.models.constrained import (RegexError, TokenDFA,
                                               byte_vocab, json_value_regex)

from .test_constrained import CASES
from .test_torch_modern import jax_modern_lm, jax_params
from .test_torch_serving import _same_pages

EOS = 0
PHONE = r"[0-9]{3}-[0-9]{4}"
MULTIBYTE = [b"a", b"b", b"ab", b"ba", b"abab", b"", b"x"]

PATTERNS = ([(p, byte_vocab(), None) for p, _ in CASES]
            + [(r"(ab)+", MULTIBYTE, 5), (PHONE, byte_vocab(), EOS)]
            + [(json_value_regex(max_depth=d), byte_vocab(), eos)
               for d, eos in ((2, None), (3, EOS))]
            + [(json_value_regex(max_depth=2, root="object"), byte_vocab(),
                None)])


@pytest.mark.parametrize("pattern,vocab,eos", PATTERNS,
                         ids=[f"p{i}" for i in range(len(PATTERNS))])
def test_compiled_tables_match_jax(pattern, vocab, eos):
    got = TokenDFA.compile(pattern, vocab, eos_token=eos)
    want = jax_constrained.TokenDFA.compile(pattern, vocab, eos_token=eos)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    assert got.start == want.start


def test_json_value_regex_and_byte_vocab_match_jax():
    for d in (1, 2, 3, 4):
        for root in ("value", "object", "array"):
            assert json_value_regex(d, root=root) == \
                jax_constrained.json_value_regex(d, root=root)
    assert byte_vocab(100) == jax_constrained.byte_vocab(100)


@pytest.mark.parametrize("bad", ["(ab", "a[b", "a{2", "*a", "a|)", "a{3,1}",
                                 "x\\"])
def test_regex_errors_match_jax(bad):
    with pytest.raises(jax_constrained.RegexError):
        jax_constrained.TokenDFA.compile(bad, jax_constrained.byte_vocab())
    with pytest.raises(RegexError):
        TokenDFA.compile(bad, byte_vocab())


@functools.lru_cache(maxsize=None)
def _pair():
    """A JAX and a port server over one byte-vocabulary model, each with
    the phone and JSON (depth 2) constraints registered."""
    jm = jax_modern_lm(vocab_size=256, context_length=128, embed_dim=32)
    tm = load_modern_lm(jax_params(jm), device="cpu")
    kw = dict(page_size=8, total_pages=64)
    js, ts = JaxServer(jm, **kw), ModernBatchServer(tm, **kw)
    for name, pattern in (("phone", PHONE),
                          ("json", json_value_regex(max_depth=2))):
        js.register_constraint(name, jax_constrained.TokenDFA.compile(
            pattern, jax_constrained.byte_vocab(), eos_token=EOS))
        ts.register_constraint(name, TokenDFA.compile(
            pattern, byte_vocab(), eos_token=EOS))
    return js, ts


def _clear():
    js, ts = _pair()
    for s in (js, ts):
        for rid in list(s.seq_pages):
            s.remove(rid)
        s.free_pages[:] = range(63, 0, -1)
    return js, ts


def test_constrained_step_and_step_many_match_jax():
    """A phone-number request, a JSON request and an unconstrained one in
    one greedy batch: step, then step_many, token for token against JAX;
    the stacked table, the offsets and each request's automaton state
    equal JAX's after every call; the phone output is a full match
    followed by EOS only."""
    js, ts = _clear()
    np.testing.assert_array_equal(ts._ctable_dev.numpy(), js._ctable_host)
    assert ts._c_offsets == js._c_offsets
    for s in (js, ts):
        s.add("p", [104, 105], constraint="phone")
        s.add("j", [123], constraint="json")
        s.add("u", [104, 105])
    out = {rid: [] for rid in "pju"}
    for call in [lambda s: {r: [t] for r, t in s.step().items()}] * 2 + \
            [lambda s: s.step_many(4)] * 2:
        want = call(js)
        assert call(ts) == want
        assert ts.seq_cstate == js.seq_cstate
        _same_pages(js, ts)
        for rid, toks in want.items():
            out[rid] += toks
    dfa = ts._constraints["phone"]
    assert dfa.match(out["p"][:9]) and set(out["p"][8:]) == {EOS}
    assert "u" not in ts.seq_cstate


def test_engine_json_mode():
    """JSON mode through ServingEngine, greedy (token for token against
    the JAX engine) and sampled at temperature 1.0 over seeds: every
    output walks the table without a dead state, and an output that ended
    at EOS parses with json.loads."""
    js, ts = _clear()
    engines = (JaxEngine(js, decode_steps=4),
               ServingEngine(ts, decode_steps=4))
    for eng, P in zip(engines, (JaxParams, SamplingParams)):
        eng.submit([104], P(max_tokens=24, stop_tokens=(EOS,)),
                   request_id="g", constraint="json")
    want = engines[0].run()
    assert engines[1].run() == want
    dfa = ts._constraints["json"]
    for seed in (3, 7, 11):
        ts.generator.manual_seed(seed)
        eng = ServingEngine(ts, decode_steps=4)
        eng.submit([104], SamplingParams(temperature=1.0, max_tokens=40,
                                         stop_tokens=(EOS,)),
                   request_id="j", constraint="json")
        toks = eng.run()["j"]
        st = dfa.start
        for t in toks:
            st = int(dfa.table[st, t])
            assert st >= 0
        if len(toks) < 40:  # stopped at EOS: a complete match
            json.loads(bytes(toks))
    assert not ts.seq_pages and len(ts.free_pages) == 63


def test_unknown_and_invalid_constraints_raise():
    """An unknown constraint raises ValueError in add and submit (before
    any state changes); a duplicate name or another vocabulary cannot be
    registered."""
    _, ts = _clear()
    with pytest.raises(ValueError, match="unknown constraint"):
        ts.add("a", [1, 2], constraint="nope")
    assert "a" not in ts.seq_pages and "a" not in ts.seq_cstate
    with pytest.raises(ValueError, match="unknown constraint"):
        ServingEngine(ts).submit([1, 2], constraint="nope")
    with pytest.raises(ValueError, match="duplicate"):
        ts.register_constraint("phone", TokenDFA.compile(PHONE, byte_vocab()))
    with pytest.raises(ValueError, match="vocab"):
        ts.register_constraint("q", TokenDFA.compile(PHONE, byte_vocab(128)))
