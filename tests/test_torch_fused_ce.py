"""Port parity: lamp_tpu_torch.ops.fused_ce against lamp_tpu.ops.fused_ce.

The same numpy inputs go through JAX's chunked ``lax.scan`` (under its
``custom_vjp``) and the port's chunked ``autograd.Function``; the loss and
the gradients of x and the weight are compared. All f32 on CPU; the two
sum the logits' softmax in other orders. Tolerances: rtol 1e-5 on the loss
(a mean of ~1e2 terms of ~4) and atol 1e-6 on gradients (entries of
p - onehot over the non-ignored rows, each ~1e-2, summed over <= 100
rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu.ops import fused_ce as jce
from lamp_tpu_torch.ops import fused_ce as tce


def _inputs(n, d, v, ignored, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = (0.3 * rng.randn(v, d)).astype(np.float32)
    t = rng.randint(0, v, n).astype(np.int32)
    t[rng.rand(n) < ignored] = -100
    return x, w, t


# (name, rows, width, vocab, share of ignored targets, row_chunk, reduction)
CASES = [
    ("mean_chunk_divides", 64, 16, 50, 0.0, 16, "mean"),
    ("mean_ragged_chunk", 70, 16, 50, 0.2, 24, "mean"),
    ("mean_default_chunk", 90, 8, 33, 0.3, None, "mean"),
    ("sum_ragged_chunk", 45, 12, 40, 0.25, 7, "sum"),
    ("none_ragged_chunk", 45, 12, 40, 0.25, 13, "none"),
    ("all_ignored", 20, 8, 10, 1.0, 6, "mean"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fused_linear_cross_entropy_matches_jax(case):
    _, n, d, v, ignored, chunk, reduction = case
    x, w, t = _inputs(n, d, v, ignored)
    up = np.random.RandomState(1).randn(n).astype(np.float32)

    def jloss(x, w):
        out = jce.fused_linear_cross_entropy(
            x, w, jnp.asarray(t), reduction=reduction, row_chunk=chunk)
        return jnp.sum(out * jnp.asarray(up)) if reduction == "none" else out

    want, (wdx, wdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    out = tce.fused_linear_cross_entropy(tx, tw, torch.from_numpy(t),
                                         reduction=reduction, row_chunk=chunk)
    got = (out * torch.from_numpy(up)).sum() if reduction == "none" else out
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wdx), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(wdw), atol=1e-6,
                               rtol=0)


def test_fused_lm_loss_matches_jax_and_plain_cross_entropy():
    """[B, T, D] hidden states: JAX's fused_lm_loss, and the plain mean
    cross-entropy of materialized logits over the non-ignored targets."""
    rng = np.random.RandomState(2)
    h = rng.randn(3, 20, 16).astype(np.float32)
    w = (0.3 * rng.randn(37, 16)).astype(np.float32)
    t = rng.randint(0, 37, (3, 20)).astype(np.int32)
    t[:, -3:] = -100
    want = jce.fused_lm_loss(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                             row_chunk=11)
    got = tce.fused_lm_loss(torch.from_numpy(h), torch.from_numpy(w),
                            torch.from_numpy(t), row_chunk=11)
    plain = torch.nn.functional.cross_entropy(
        torch.from_numpy(h @ w.T).reshape(60, 37),
        torch.from_numpy(t).long().reshape(60), ignore_index=-100)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(plain), rtol=1e-5)
    with pytest.raises(ValueError, match="reduction"):
        tce.fused_linear_cross_entropy(torch.zeros(4, 2), torch.zeros(3, 2),
                                       torch.zeros(4), reduction="max")
