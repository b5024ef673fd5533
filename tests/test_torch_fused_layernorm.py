"""Port parity: lamp_tpu_torch.ops.fused_layernorm (K5's plain versions,
which CPU tensors take, under its autograd.Function) against
lamp_tpu.ops.fused_layernorm run in interpret mode, at the shapes of
tests/test_fused_layernorm.py.

Inputs are made with numpy. Tolerances, as the JAX tests use: the forward
within atol 1e-5 in f32 and one bf16 step of the output in bf16 (both
compute in f32 and round once; sums taken in another order can land on the
other side of a rounding boundary); gradients within 1e-4 of the largest
gradient. Where the JAX op takes its jnp path (15 rows; D = 100), the port
takes its one rule, the kernel's arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu.ops.fused_layernorm import fused_layernorm as jax_ln
from lamp_tpu_torch.ops import fused_layernorm as tfl


def _inputs(shape, seed, bias=True):
    rng = np.random.RandomState(seed)
    d = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = (rng.randn(d) * 0.5 + 1).astype(np.float32)
    b = (rng.randn(d) * 0.1).astype(np.float32) if bias else None
    return x, g, b


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype, grad=False):
    if a is None:
        return None
    return torch.tensor(a).to(dtype).requires_grad_(grad)


def _bf16_step(x):
    """One bf16 step (ulp) at each element of ``x``."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("shape,dtype,bias", [
    ((8, 48, 256), "float32", True), ((8, 48, 256), "bfloat16", True),
    ((16, 128), "float32", False), ((40, 128), "float32", True),
    ((3, 5, 256), "float32", True), ((8, 100), "float32", False),
    ((8, 100), "bfloat16", True)])
def test_forward_matches_jax(shape, dtype, bias):
    x, g, b = _inputs(shape, seed=shape[0], bias=bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_ln(_jax(x, jdt), _jax(g, jdt), _jax(b, jdt), 1e-5,
                             True).astype(jnp.float32))
    got = tfl.fused_layernorm(_torch(x, tdt), _torch(g, tdt), _torch(b, tdt))
    assert got.dtype == tdt and got.shape == shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert np.all(np.abs(got - want) <= _bf16_step(want))


def _grads(fn, x, g, b, dy):
    y = fn(x, g, b)
    return torch.autograd.grad(y, [t for t in (x, g, b) if t is not None],
                               dy)


@pytest.mark.parametrize("shape,bias", [((4, 24, 256), True),
                                        ((40, 128), True),
                                        ((3, 5, 256), True),
                                        ((8, 100), False)])
def test_gradients_match_jax(shape, bias):
    """Gradients of x, weight and bias against the JAX custom_vjp (40 rows:
    the JAX kernel's 8-row blocks accumulate dw and db over 5 grid cells;
    15 rows and D = 100: its jnp path, differentiated by JAX)."""
    x, g, b = _inputs(shape, seed=7, bias=bias)
    dy = np.random.RandomState(8).randn(*shape).astype(np.float32)
    argnums = (0, 1, 2) if bias else (0, 1)

    def jloss(x_, g_, b_):
        return jnp.sum(jax_ln(x_, g_, b_, 1e-5, True) * jnp.asarray(dy))

    jargs = [_jax(a, jnp.float32) for a in (x, g, b)]
    want = jax.grad(lambda *a: jloss(*a, *([] if bias else [None])),
                    argnums=argnums)(*[a for a in jargs if a is not None])
    targs = [_torch(a, torch.float32, grad=True) for a in (x, g, b)]
    got = _grads(tfl.fused_layernorm, *targs, torch.tensor(dy))
    assert len(got) == len(want)
    for t, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(t.numpy() / scale, w / scale, atol=1e-4,
                                   rtol=0)


def test_bf16_gradients_keep_the_parameters_dtypes():
    """dx in x's dtype, dw and db in the parameters' (here bf16 and f32),
    within one bf16 step of the JAX op's; mu and rstd are saved in f32."""
    x, g, b = _inputs((8, 48, 256), seed=3)
    dy = np.random.RandomState(4).randn(8, 48, 256).astype(np.float32)
    xt = _torch(x, torch.bfloat16, grad=True)
    gt = _torch(g, torch.bfloat16, grad=True)
    bt = _torch(b, torch.float32, grad=True)
    y = tfl.fused_layernorm(xt, gt, bt)
    assert [t.dtype for t in y.grad_fn.saved_tensors[2:]] == [torch.float32] * 2
    dx, dg, db = torch.autograd.grad(y, (xt, gt, bt), torch.tensor(dy).to(
        torch.bfloat16))
    assert (dx.dtype, dg.dtype, db.dtype) == (torch.bfloat16, torch.bfloat16,
                                              torch.float32)
    want = jax.grad(
        lambda x_, g_, b_: jnp.sum(jax_ln(x_, g_, b_, 1e-5, True).astype(
            jnp.float32) * jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32)),
        argnums=(0, 1, 2))(_jax(x, jnp.bfloat16), _jax(g, jnp.bfloat16),
                           _jax(b, jnp.float32))
    for t, w in zip((dx, dg, db), want):
        w = np.asarray(w.astype(jnp.float32))
        scale = float(np.abs(w).max())
        err = np.abs(t.float().numpy() - w) / scale
        assert err.max() <= 2 ** -7, err.max()


def test_plain_versions_follow_the_kernels():
    """The forward's saved statistics and the backward's sums over rows,
    against float64 arithmetic on the same inputs."""
    x, g, b = _inputs((40, 128), seed=9)
    dy = np.random.RandomState(10).randn(40, 128)
    y, mu, rs = tfl.fused_layernorm_reference(torch.tensor(x),
                                              torch.tensor(g),
                                              torch.tensor(b))
    x64 = x.astype(np.float64)
    mu64 = x64.mean(1)
    rs64 = 1 / np.sqrt(x64.var(1) + 1e-5)
    np.testing.assert_allclose(mu.numpy(), mu64, rtol=1e-6)
    np.testing.assert_allclose(rs.numpy(), rs64, rtol=1e-6)
    dx, dw, db = tfl.fused_layernorm_backward_reference(
        torch.tensor(x), torch.tensor(dy).float(), torch.tensor(g), mu, rs)
    yhat = (x64 - mu64[:, None]) * rs64[:, None]
    np.testing.assert_allclose(dw.numpy(), (dy * yhat).sum(0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(db.numpy(), dy.sum(0), rtol=1e-5, atol=1e-5)
    assert tfl.fused_layernorm.launches == 0  # CPU: the plain versions
    with pytest.raises(ValueError, match="weight"):
        tfl.fused_layernorm(torch.tensor(x), torch.tensor(g[:5]), None)
