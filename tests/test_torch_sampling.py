"""Port parity: lamp_tpu_torch.models.sampling against lamp_tpu's.

The same numpy logits go through both. Filters, penalties and greedy
decoding (with logprobs) are deterministic and must agree: filter masks and
greedy tokens exactly, logprobs at atol 1e-5 (f32 logsumexp in another
order). Random draws come from a torch.Generator in the port and a
jax.random key in the reference, so sampled tokens are held to the softmax
distribution instead (a frequency check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu.models import sampling as jax_sampling
from lamp_tpu_torch.models import sampling

V = 300


def _logits(b, seed=0):
    """Distinct values per row, so top-k never meets a tie."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(V) for _ in range(b)]).astype(
        np.float32) * 0.03 + rng.randn(b, 1).astype(np.float32)


def test_apply_filters_matches_jax():
    logits = _logits(6)
    top_k = np.array([0, 5, 40, 0, 3, 0], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.3, 1.0, 1.0], np.float32)
    min_p = np.array([0.0, 0.0, 0.2, 0.0, 0.5, 0.0], np.float32)
    want = jax_sampling._apply_filters(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p),
        jnp.asarray(min_p))
    got = sampling._apply_filters(
        torch.from_numpy(logits), torch.from_numpy(top_k),
        torch.from_numpy(top_p), torch.from_numpy(min_p))
    want = np.asarray(want)
    # the same survivors, and survivors keep their logits
    np.testing.assert_array_equal(got.numpy() > -1e30, want > -1e30)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == torch.from_numpy(logits[0])).all()  # every filter off


@pytest.mark.parametrize("which", ["top_k", "top_p", "min_p"])
def test_apply_filters_single_filter_matches_jax(which):
    logits = _logits(4, seed=1)
    args = {"top_k": np.array([1, 7, 0, 100], np.int32),
            "top_p": np.array([0.8, 0.2, 1.0, 0.99], np.float32),
            "min_p": np.array([0.1, 0.0, 0.9, 0.3], np.float32)}
    kw = {k: (args[k] if k == which else None) for k in args}
    want = jax_sampling._apply_filters(
        jnp.asarray(logits),
        *(None if kw[k] is None else jnp.asarray(kw[k])
          for k in ("top_k", "top_p", "min_p")))
    got = sampling._apply_filters(
        torch.from_numpy(logits),
        *(None if kw[k] is None else torch.from_numpy(kw[k])
          for k in ("top_k", "top_p", "min_p")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_penalties_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, V).astype(np.float32)
    counts = rng.randint(0, 3, (3, V)).astype(np.int32)
    pmask = rng.rand(3, V) < 0.1
    pres = np.array([0.0, 0.5, 1.0], np.float32)
    freq = np.array([0.2, 0.0, 0.3], np.float32)
    rep = np.array([1.0, 1.3, 0.7], np.float32)
    want = jax_sampling.apply_penalties(
        *(jnp.asarray(a) for a in (logits, counts, pmask, pres, freq, rep)))
    got = sampling.apply_penalties(
        *(torch.from_numpy(a) for a in (logits, counts, pmask, pres, freq,
                                        rep)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_greedy_sample_tokens_with_logprobs_matches_jax():
    logits = _logits(5, seed=3)
    allowed = np.where(np.random.RandomState(4).rand(5, V) < 0.5, 1, -1
                       ).astype(np.int32)
    for rows in (None, allowed):
        want_t, want_lp = jax_sampling.sample_tokens(
            jnp.asarray(logits), jax.random.PRNGKey(0), None,
            allowed_rows=None if rows is None else jnp.asarray(rows),
            return_logprobs=True)
        got_t, got_lp = sampling.sample_tokens(
            torch.from_numpy(logits), torch.Generator(), None,
            allowed_rows=None if rows is None else torch.from_numpy(rows),
            return_logprobs=True)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                                   atol=1e-5, rtol=0)
    # temperature-0 rows of a mixed batch decode greedily
    temps = np.array([0.0, 1.0, 0.0, 2.0, 0.0], np.float32)
    got = sampling.sample_tokens(torch.from_numpy(logits),
                                 torch.Generator().manual_seed(1),
                                 torch.from_numpy(temps))
    greedy = logits.argmax(-1)
    assert (got.numpy()[temps == 0] == greedy[temps == 0]).all()


@pytest.mark.parametrize("filtered", [False, True])
def test_sampled_token_frequencies_follow_softmax(filtered):
    """20,000 draws of one 6-token row at temperature 0.7 (with top_p 0.8:
    the nucleus, renormalized) land within 4 standard errors of the
    reference distribution."""
    logits = np.array([[1.0, 0.5, 0.2, 0.0, -0.5, -2.0]], np.float32)
    n = 20000
    temp = torch.full((n,), 0.7)
    top_p = torch.full((n,), 0.8) if filtered else None
    got = sampling.sample_tokens(
        torch.from_numpy(np.repeat(logits, n, 0)),
        torch.Generator().manual_seed(0), temp, top_p=top_p)
    freq = np.bincount(got.numpy(), minlength=6) / n
    p = np.exp(logits[0] / 0.7)
    p /= p.sum()
    if filtered:  # the JAX filter decides the nucleus
        keep = np.asarray(jax_sampling._apply_filters(
            jnp.asarray(logits / 0.7), None, jnp.asarray([0.8], jnp.float32)
        ))[0] > -1e30
        p = np.where(keep, p, 0.0)
        p /= p.sum()
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 4 * se + 1e-12), (freq, p)


def test_sampling_params_validation_matches_jax():
    for bad in (dict(temperature=-1), dict(top_p=0.0), dict(min_p=1.0),
                dict(top_k=-1), dict(max_tokens=0),
                dict(repetition_penalty=0.0)):
        with pytest.raises(ValueError):
            sampling.SamplingParams(**bad)
        with pytest.raises(ValueError):
            jax_sampling.SamplingParams(**bad)
    sp = sampling.SamplingParams(presence_penalty=0.5)
    assert sp.has_penalties and not sampling.SamplingParams().has_penalties
    assert [f.name for f in sampling.SamplingParams.__dataclass_fields__
            .values()] == list(jax_sampling.SamplingParams
                               .__dataclass_fields__)
