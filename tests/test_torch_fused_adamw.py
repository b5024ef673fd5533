"""Port parity: lamp_tpu_torch.ops.fused_adamw (K4's plain version, which
CPU tensors take, and AdamWStochastic) and the AdamW flags debias /
mixed_precision against lamp_tpu.

The same numpy parameters, gradients and moments go through both packages;
the JAX kernel runs in interpret mode. Tolerances:

- f32 parameters: p, m and v after 3 steps within rtol 1e-6 of each
  element, or 1e-6 of the tensor's largest magnitude. The port does the JAX
  kernel's f32 operations in its order, but XLA's CPU interpreter contracts
  each ``b x + c y`` into one FMA (and its exp of the bias corrections may
  differ from the host's in the last bit), so an element differs by about
  an ulp of its terms, which is large relative to a result near 0 (m
  cancels);
- bf16 parameters rounded to nearest, one step from the same inputs: in
  both packages p is bit for bit the round-to-nearest-even of the f32
  result on f32 copies of the inputs, and the two agree bit for bit except
  where their f32 results (the FMA above) straddle a bf16 rounding
  boundary: at most 1e-3 of the elements, and there by one bf16 step;
- bf16 under stochastic rounding: no JAX CPU run exists
  (``pltpu.prng_seed`` has no interpret lowering), so each element must be
  one of the two bf16 neighbours of the JAX f32 result on f32 copies of the
  same inputs, and the mean over 2^20 elements within 5 sigma of the exact
  update;
- optimizers over several steps: 1e-5, as tests/test_fused_adamw.py holds
  the JAX kernel against optim.AdamW; bf16 AdamW parameters without masters
  within one bf16 rounding (2^-7 relative);
- a 10-step f32 GPT run through make_train_step: losses within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import nn as jnn
from lamp_tpu import optim as joptim
from lamp_tpu import train as jtrain
from lamp_tpu.ops import fused_adamw as jfa
from lamp_tpu_torch import bridge
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch import optim as toptim
from lamp_tpu_torch import train as ttrain
from lamp_tpu_torch.ops import fused_adamw as tfa

from .test_torch_modern import jax_params
from .test_torch_transformer import jax_lm, torch_lm

HYPER = dict(lr=1e-2, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01)


def _inputs(shape, seed, step=1):
    rng = np.random.RandomState(seed)
    p = rng.randn(*shape).astype(np.float32)
    g = [(rng.randn(*shape) * (1 + s)).astype(np.float32)
         for s in range(step)]
    m = (rng.randn(*shape) * 0.1).astype(np.float32)
    v = (rng.rand(*shape) * 0.01).astype(np.float32)
    return p, g, m, v


def _jax_steps(p, grads, m, v, dtype, stochastic=False):
    p, m, v = jnp.asarray(p, dtype), jnp.asarray(m), jnp.asarray(v)
    for t, g in enumerate(grads, start=1):
        p, m, v = jfa.fused_adamw_update(
            p, jnp.asarray(g, dtype), m, v, jnp.int32(t), **HYPER,
            stochastic=stochastic, interpret=True)
    return p, m, v


def _torch_steps(p, grads, m, v, dtype, stochastic=False, seed=0):
    p = torch.tensor(p).to(dtype)
    m, v = torch.tensor(m), torch.tensor(v)
    for t, g in enumerate(grads, start=1):
        out = tfa.fused_adamw_update(p, torch.tensor(g).to(dtype), m, v, t,
                                     **HYPER, stochastic=stochastic,
                                     seed=seed)
        assert out[0] is p and out[1] is m and out[2] is v  # in place
    return p, m, v


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy()
    return x.astype(np.int64) & 0xFFFF


@pytest.mark.parametrize("shape", [(33, 7), (5,), (13, 5), (1100, 128)])
def test_update_matches_jax_f32(shape):
    """(1100, 128) is more than one of the JAX kernel's 131072-element
    blocks."""
    p, g, m, v = _inputs(shape, seed=len(shape) + shape[0], step=3)
    jp, jm, jv = _jax_steps(p, g, m, v, jnp.float32)
    tp, tm, tv = _torch_steps(p, g, m, v, torch.float32)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert tfa.fused_adamw_update.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("shape", [(33, 7), (1100, 128)])
@pytest.mark.parametrize("step", [1, 3])
def test_update_bf16_nearest_matches_jax_bitwise(shape, step):
    p, g, m, v = _inputs(shape, seed=step, step=1)
    p = torch.tensor(p).bfloat16().float().numpy()  # exactly bf16 values
    g = torch.tensor(g[0]).bfloat16().float().numpy()

    def jax_step(dtype):
        return jfa.fused_adamw_update(
            jnp.asarray(p, dtype), jnp.asarray(g, dtype), jnp.asarray(m),
            jnp.asarray(v), jnp.int32(step), **HYPER, stochastic=False,
            interpret=True)

    jp, jm, jv = jax_step(jnp.bfloat16)
    tp, tm, tv = (torch.tensor(p).bfloat16(), torch.tensor(m),
                  torch.tensor(v))
    tfa.fused_adamw_update(tp, torch.tensor(g).bfloat16(), tm, tv, step,
                           **HYPER, stochastic=False)
    t32 = torch.tensor(p)
    tfa.fused_adamw_update(t32, torch.tensor(g), torch.tensor(m),
                           torch.tensor(v), step, **HYPER, stochastic=False)
    j32 = torch.tensor(np.asarray(jax_step(jnp.float32)[0]))
    got, want = _bf16_bits(tp), _bf16_bits(np.asarray(jp).view(np.int16))
    np.testing.assert_array_equal(got, _bf16_bits(t32.bfloat16()))
    np.testing.assert_array_equal(want, _bf16_bits(j32.bfloat16()))
    diff = np.abs(got - want)
    assert diff.max() <= 1 and diff.mean() <= 1e-3, (diff.sum(), diff.size)
    for got, want in ((tm, jm), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_stochastic_rounding_brackets_the_f32_update():
    shape = (64, 96)
    p, g, m, v = _inputs(shape, seed=2)
    p = torch.tensor(p).bfloat16().float().numpy()  # exactly bf16 values
    g = [torch.tensor(g[0]).bfloat16().float().numpy()]
    exact, _, _ = _jax_steps(p, g, m, v, jnp.float32)
    exact = torch.tensor(np.asarray(exact))
    low = (exact.view(torch.int32).numpy().astype(np.int64) >> 16) & 0xFFFF
    on_grid = (exact.view(torch.int32).numpy() & 0xFFFF) == 0
    got = _bf16_bits(_torch_steps(p, g, m, v, torch.bfloat16,
                                  stochastic=True, seed=7)[0])
    # truncation (toward 0) or one bf16 step away from 0; exact values stay
    assert np.all((got == low) | ((got == low + 1) & ~on_grid))
    assert 0 < np.mean(got == low + 1) < 1
    again = _bf16_bits(_torch_steps(p, g, m, v, torch.bfloat16,
                                    stochastic=True, seed=7)[0])
    np.testing.assert_array_equal(got, again)  # same seed and step
    other = _bf16_bits(_torch_steps(p, g, m, v, torch.bfloat16,
                                    stochastic=True, seed=8)[0])
    assert np.any(got != other)
    # the next step draws other bits
    assert not torch.equal(tfa._random_words(7, 1, got.size, "cpu"),
                           tfa._random_words(7, 2, got.size, "cpu"))


def test_stochastic_rounding_is_unbiased():
    """2^20 bf16 parameters at 1.0, first step, lr 1e-4, no decay: each
    moves by -1e-4 in f32. Round-to-nearest leaves every one at 1.0; the
    stochastic mean is within 5 sigma of 1 - 1e-4, where sigma = 2^-8
    sqrt(q (1 - q) / 2^20) ~ 6.0e-7 and q = 1e-4 / 2^-8 ~ 2.6% of the
    elements go to 0.99609375."""
    n = 1 << 20
    p = torch.ones(n, dtype=torch.bfloat16)
    g = torch.ones(n, dtype=torch.bfloat16)
    kw = dict(lr=1e-4, weight_decay=0.0, seed=3)
    zeros = torch.zeros(n)
    near = tfa.fused_adamw_update_reference(p, g, zeros, zeros, 1,
                                            stochastic=False, **kw)[0]
    assert torch.all(near == 1.0)
    out = tfa.fused_adamw_update_reference(p, g, zeros, zeros, 1, **kw)[0]
    vals = set(torch.unique(out.float()).tolist())
    assert vals == {0.99609375, 1.0}
    q = 1e-4 / 2 ** -8
    sigma = 2 ** -8 * np.sqrt(q * (1 - q) / n)
    mean = float(out.double().mean())
    assert abs(mean - (1 - 1e-4)) < 5 * sigma, (mean, sigma)


def _opt_dict():
    # tests/test_fused_adamw.py:14-17
    rng = np.random.RandomState(0)
    p = {"w": rng.randn(33, 7).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)}
    g = {"w": rng.randn(33, 7).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)}
    return p, g


def test_adamw_stochastic_matches_jax_and_adamw_without_masters():
    p, g = _opt_dict()
    jopt = jfa.AdamWStochastic(1e-2, weight_decay=0.01)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(a)) for k, a in p.items()}
    topt = tfa.AdamWStochastic(tp, 1e-2, weight_decay=0.01)
    ap = {k: torch.nn.Parameter(torch.tensor(a)) for k, a in p.items()}
    aopt = toptim.AdamW(ap, 1e-2, weight_decay=0.01, mixed_precision=False)
    for _ in range(3):
        jp, jstate = jopt.step(jp, {k: jnp.asarray(a) for k, a in g.items()},
                               jstate)
        for params in (tp, ap):
            for k, t in params.items():
                t.grad = torch.tensor(g[k])
        topt.step()
        aopt.step()
    assert topt.param_groups[0]["step"] == int(jstate["step"]) == 3
    for k in p:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ap[k].detach().numpy(),
                                   tp[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        for part in ("mt", "vt"):
            np.testing.assert_allclose(topt.state[tp[k]][part].numpy(),
                                       np.asarray(jstate[part][k]),
                                       rtol=1e-6)
        assert set(topt.state[tp[k]]) == {"mt", "vt"}  # no master


@pytest.mark.parametrize("debias,mixed_precision",
                         [(False, True), (True, False), (False, False)])
def test_adamw_flags_match_jax(debias, mixed_precision):
    rng = np.random.RandomState(4)
    shapes = {"w": (6, 5), "b": (5,), "scale": (4,)}
    dtypes = {"w": "bfloat16", "b": "float32", "scale": "bfloat16"}
    init = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    jp = {n: jnp.asarray(a, getattr(jnp, dtypes[n])) for n, a in init.items()}
    jopt = joptim.AdamW(1e-2, beta2=0.95, weight_decay=0.02, debias=debias,
                        mixed_precision=mixed_precision)
    jstate = jopt.init(jp)
    tp = {n: torch.nn.Parameter(torch.tensor(a).to(getattr(torch, dtypes[n])))
          for n, a in init.items()}
    topt = toptim.AdamW(tp, 1e-2, beta2=0.95, weight_decay=0.02,
                        debias=debias, mixed_precision=mixed_precision)
    for step in range(3):
        g = {n: (rng.randn(*s) * (1 + step)).astype(np.float32)
             for n, s in shapes.items()}
        jp, jstate = jopt.step(
            jp, {n: jnp.asarray(a, jp[n].dtype) for n, a in g.items()},
            jstate)
        for n, t in tp.items():
            t.grad = torch.tensor(g[n]).to(t.dtype)
        topt.step()
    for n, t in tp.items():
        st = topt.state[t]
        for part in ("mt", "vt"):
            np.testing.assert_allclose(st[part].numpy(),
                                       np.asarray(jstate[part][n]),
                                       rtol=1e-5, atol=1e-7)
        if dtypes[n] == "bfloat16" and mixed_precision:
            np.testing.assert_allclose(st["master"].numpy(),
                                       np.asarray(jstate["master"][n]),
                                       rtol=1e-5, atol=1e-7)
        else:
            assert st["master"] is None
        assert t.dtype == getattr(torch, dtypes[n])
        np.testing.assert_allclose(
            t.detach().float().numpy(), np.asarray(jp[n].astype(jnp.float32)),
            rtol=2 ** -7 if dtypes[n] == "bfloat16" else 1e-5, atol=1e-7)
    if not mixed_precision:
        assert jstate["master"] is None


def test_train_with_adamw_stochastic_matches_jax():
    """A 2-block, 64-wide f32 GPT from bridged weights takes 10 steps of
    make_train_step under AdamWStochastic in both packages; then the JAX
    optimizer state, bridged into the port's optimizer, equals it and one
    more step from it agrees."""
    steps, batch, ctx, vocab = 10, 3, 16, 61
    jm = jax_lm(embed_dim=64)
    tm = torch_lm(jm)
    jopt = jfa.AdamWStochastic(3e-3, weight_decay=0.01)
    topt = tfa.AdamWStochastic(tm.named_parameters(), 3e-3, weight_decay=0.01)

    def jloss(m, b, key, train):
        logits, nm = m.forward(b[0], key=key, train=train)
        return (jnn.lm_loss(logits, b[1]),
                jnp.asarray(b[0].shape[0], jnp.float32), nm)

    def tloss(m, b, generator, train):
        return tnn.lm_loss(m(b[0], train=train), b[1]), b[0].shape[0]

    jstate = jtrain.TrainState.init(jm, jopt)
    jstep = jax.jit(jtrain.make_train_step(jopt, jloss))
    tstate = ttrain.TrainState.init(tm, topt)
    tstep = ttrain.make_train_step(topt, tloss)
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(steps + 1):
        toks = rng.randint(0, vocab, (batch, ctx)).astype(np.int32)
        batches.append((toks, np.roll(toks, -1, axis=1)))
    want, got = [], []
    for toks, target in batches[:steps]:
        jstate, (jl, _) = jstep(jstate, (jnp.asarray(toks),
                                         jnp.asarray(target)),
                                jax.random.PRNGKey(0))
        tstate, (tl, _) = tstep(tstate, (torch.tensor(toks).long(),
                                         torch.tensor(target).long()))
        want.append(float(jl))
        got.append(float(tl))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[-1] < want[0]

    # the JAX state carried across equals the port's own
    js = jstate.opt_state
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, tnn.Linear)}
    own = {part: {n: topt.state[p][part].clone()
                  for n, p in tm.named_parameters()} for part in ("mt", "vt")}
    bridge.load_adamw_state({"step": int(js["step"]),
                             "mt": jax_params(js["mt"]),
                             "vt": jax_params(js["vt"])}, topt, tm)
    assert topt.param_groups[0]["step"] == steps
    jmt = jax_params(js["mt"])
    for n, p in tm.named_parameters():
        w = jmt[n].T if n in linear else jmt[n]
        np.testing.assert_array_equal(topt.state[p]["mt"].numpy(), w)
        np.testing.assert_allclose(own["mt"][n].numpy(), w, rtol=1e-3,
                                   atol=1e-6, err_msg=n)
    toks, target = batches[steps]
    jstate, (jl, _) = jstep(jstate, (jnp.asarray(toks), jnp.asarray(target)),
                            jax.random.PRNGKey(0))
    tstate, (tl, _) = tstep(tstate, (torch.tensor(toks).long(),
                                     torch.tensor(target).long()))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    with pytest.raises(KeyError, match="master"):
        bridge.load_adamw_state({"step": 1, "mt": jax_params(js["mt"]),
                                 "vt": jax_params(js["vt"]),
                                 "master": {"extra": np.zeros(1)}}, topt, tm)


def test_load_adamw_state_without_masters():
    """AdamW(mixed_precision=False) stores master None in both packages."""
    jm = jax_lm(dtype=jnp.bfloat16)
    jparams = jnn.partition_params(jm)[0]
    jopt = joptim.AdamW(1e-2, mixed_precision=False)
    jstate = jopt.init(jparams)
    flat, tree = jax.tree_util.tree_flatten(jparams)
    rng = np.random.RandomState(1)
    jparams, jstate = jax.jit(jopt.step)(
        jparams, tree.unflatten([jnp.asarray(rng.randn(*x.shape), x.dtype)
                                 for x in flat]), jstate)
    tm = torch_lm(jparams, dtype=torch.bfloat16)
    topt = toptim.AdamW(tm.named_parameters(), 1e-2, mixed_precision=False)
    assert jstate["master"] is None
    bridge.load_adamw_state({"step": int(jstate["step"]),
                             "mt": jax_params(jstate["mt"]),
                             "vt": jax_params(jstate["vt"]),
                             "master": jstate["master"]}, topt, tm)
    vt = jax_params(jstate["vt"])
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, tnn.Linear)}
    assert topt.param_groups[0]["step"] == 1
    for n, p in tm.named_parameters():
        assert topt.state[p]["master"] is None
        w = vt[n].T if n in linear else vt[n]
        np.testing.assert_array_equal(topt.state[p]["vt"].numpy(), w)
