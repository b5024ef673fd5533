"""KV-cached generation: lamp_tpu_torch.models.generate against
lamp_tpu.models.generate.

A 2-block, 32-wide, 4-head GPT LanguageModelModule (vocab 61, context 24)
is made by lamp_tpu from a seeded key and bridged into the port; the same
numpy tokens go through both packages' init_cache / decode_step / prefill /
generate, on CPU in f32. Tolerance: logits and the cache's K/V at atol 1e-5
(f32 products summed in another order); lengths and greedy tokens exactly
equal. Sampled tokens come from a torch.Generator, so they agree with the
JAX function's in distribution only: the sampled case checks their range
and that a seed reproduces them.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu_torch.models import (KVCache, decode_step, generate,
                                   init_cache, prefill)

from .test_torch_transformer import jax_lm, torch_lm

# the module: lamp_tpu.models' own ``generate`` attribute is the function
jgen = importlib.import_module("lamp_tpu.models.generate")

ATOL = 1e-5
CTX, HEADS, VOCAB = 24, 4, 61


def _models():
    jm = jax_lm(context_length=CTX, attention_heads=HEADS)
    return jm, torch_lm(jm, heads=HEADS)


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_init_cache_matches_jax():
    jm, tm = _models()
    want = jgen.init_cache(jm, 3)
    got = init_cache(tm, 3)
    assert isinstance(got, KVCache)
    assert got.k.shape == want.k.shape == (2, 3, HEADS, CTX, 32 // HEADS)
    assert got.k.dtype == torch.float32 and got.k.device.type == "cpu"
    assert int(got.length) == int(want.length) == 0
    assert init_cache(tm, 1, dtype=torch.bfloat16).v.dtype == torch.bfloat16


def test_decode_step_logits_and_cache_match_jax():
    """8 steps of 2 sequences: the logits, both caches and the length after
    each step."""
    jm, tm = _models()
    toks = _tokens(2, 8)
    jc, tc = jgen.init_cache(jm, 2), init_cache(tm, 2)
    for t in range(8):
        want, jc = jgen.decode_step(jm, jc, jnp.asarray(toks[:, t],
                                                        jnp.int32))
        got, tc = decode_step(tm, tc, torch.from_numpy(toks[:, t]))
        assert got.dtype == torch.float32 and got.shape == (2, VOCAB)
        _close(got, want)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        assert int(tc.length) == int(jc.length) == t + 1


def test_prefill_last_logits_match_jax():
    jm, tm = _models()
    toks = _tokens(3, 7, seed=1)
    want, jc = jgen.prefill(jm, jgen.init_cache(jm, 3),
                            jnp.asarray(toks, jnp.int32))
    got, tc = prefill(tm, init_cache(tm, 3), torch.from_numpy(toks))
    _close(got, want)
    _close(tc.k, jc.k)
    assert int(tc.length) == 7


def test_prefill_matches_the_full_forward():
    """The cached path's last logits equal the dense forward's at the
    prompt's last position (both packages' dense forward agree at 1e-4,
    tests/test_torch_transformer.py)."""
    _, tm = _models()
    toks = torch.from_numpy(_tokens(2, 9, seed=2))
    got, _ = prefill(tm, init_cache(tm, 2), toks)
    with torch.no_grad():
        full = tm(toks)
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("prefix_shape", [(5,), (2, 5)])
def test_generate_greedy_matches_jax(prefix_shape):
    jm, tm = _models()
    prefix = _tokens(1, int(np.prod(prefix_shape)), seed=3).reshape(
        prefix_shape)
    want = jgen.generate(jm, prefix, 12, temperature=0.0)
    got = generate(tm, prefix, 12, temperature=0.0)
    assert got.shape == want.shape == (
        1 if len(prefix_shape) == 1 else 2, 12)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_sampled_is_in_vocab_and_reproducible():
    _, tm = _models()
    prefix = _tokens(3, 4, seed=4)

    def run(seed):
        return generate(tm, prefix, 10, temperature=0.8,
                        generator=torch.Generator().manual_seed(seed))

    a = run(0)
    assert a.shape == (3, 10) and a.min() >= 0 and a.max() < VOCAB
    np.testing.assert_array_equal(a, run(0))
    assert not np.array_equal(a, run(1))
    np.testing.assert_array_equal(generate(tm, prefix, 10, temperature=0.8),
                                  a)  # the default generator: seed 0


def test_generate_past_the_context_raises():
    jm, tm = _models()
    prefix = _tokens(1, 20, seed=5)
    with pytest.raises(AssertionError, match="context"):
        jgen.generate(jm, prefix, 5, temperature=0.0)
    with pytest.raises(AssertionError, match="context"):
        generate(tm, prefix, 5, temperature=0.0)
    assert generate(tm, prefix, 4, temperature=0.0).shape == (1, 4)


def test_vocab_size_matches_jax():
    jm, tm = _models()
    assert tm.vocab_size == jm.vocab_size == VOCAB
