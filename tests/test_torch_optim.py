"""Port parity: lamp_tpu_torch.optim (AdamW, global-norm clip,
cosine_with_warmup) against lamp_tpu.optim.

The same numpy parameters and gradients go through both packages. AdamW's
f32 state (masters, moments) and f32 parameters agree within rtol 1e-5 /
atol 1e-7 after 3 steps (the same f32 operations, some fused differently);
bf16 parameters, cast from those masters, within one bf16 rounding (one
ulp, 2^-7 relative). Clip: rtol 1e-6; the schedule is the same Python
arithmetic in both (rel 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import nn as jnn
from lamp_tpu import optim as joptim
from lamp_tpu_torch import bridge
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch import optim as toptim

from .test_torch_modern import jax_params
from .test_torch_transformer import jax_lm, torch_lm

RTOL, ATOL = 1e-5, 1e-7

SHAPES = {"w": (6, 5), "b": (5,), "emb": (7, 3), "scale": (4,)}
DTYPES = {"w": "bfloat16", "b": "float32", "emb": "float32",
          "scale": "bfloat16"}
TAGS = {"w": "Linear.weight", "b": "Linear.bias", "emb": "Embedding.weight",
        "scale": "TransformerEncoderBlock.scale"}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return {n: (rng.randn(*s) * (1 + step)).astype(np.float32)
            for n, s in SHAPES.items()}


def _decay(tag):
    return 0.0 if ("bias" in tag or "scale" in tag or "Embedding" in tag) \
        else 0.05


@pytest.mark.parametrize("weight_decay", ["float", "dict", "callable"])
@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
def test_adamw_matches_jax(weight_decay, clip):
    wd = {"float": 0.02,
          "dict": {"default": 0.03, "Linear.bias": 0.0,
                   "TransformerEncoderBlock.scale": 0.1},
          "callable": _decay}[weight_decay]
    lr = {"default": 1e-2, "Embedding.weight": 3e-2}
    init = _params()
    jp = {n: jnp.asarray(a, getattr(jnp, DTYPES[n])) for n, a in init.items()}
    jopt = joptim.AdamW(lr, beta2=0.95, weight_decay=wd, clip=clip,
                        tags=dict(TAGS))
    jstate = jopt.init(jp)
    tp = {n: torch.nn.Parameter(torch.tensor(a).to(getattr(torch, DTYPES[n])))
          for n, a in init.items()}
    topt = toptim.AdamW(tp, lr, beta2=0.95, weight_decay=wd, clip=clip,
                        tags=dict(TAGS))
    for step in range(3):
        g = _grads(step)
        factor = [1.0, 0.5, 0.25][step]
        jp, jstate = jopt.step(
            jp, {n: jnp.asarray(a, jp[n].dtype) for n, a in g.items()},
            jstate, factor)
        for n, p in tp.items():
            p.grad = torch.tensor(g[n]).to(p.dtype)
        topt.step(lr_factor=factor)
    assert topt.param_groups[0]["step"] == int(jstate["step"]) == 3
    for n, p in tp.items():
        st = topt.state[p]
        for part in ("mt", "vt"):
            np.testing.assert_allclose(st[part].numpy(),
                                       np.asarray(jstate[part][n]),
                                       rtol=RTOL, atol=ATOL, err_msg=part)
        if DTYPES[n] == "bfloat16":
            np.testing.assert_allclose(st["master"].numpy(),
                                       np.asarray(jstate["master"][n]),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(
                p.detach().float().numpy(),
                np.asarray(jp[n].astype(jnp.float32)), rtol=2 ** -7, atol=0)
        else:
            assert st["master"] is None and jstate["master"][n] is None
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                       rtol=RTOL, atol=ATOL)


def test_adamw_runs_of_parameters_give_the_same_bits(monkeypatch):
    """AdamW's step over runs of at most _STEP_ELEMENTS elements (here 20:
    "w", 30 elements, alone, the rest one at a time) gives the bits of one
    run over every parameter, with per-tag learning rates and decay and
    the global clip."""
    from lamp_tpu_torch.optim import optimizers

    def run(limit):
        monkeypatch.setattr(optimizers, "_STEP_ELEMENTS", limit)
        tp = {n: torch.nn.Parameter(
            torch.tensor(a).to(getattr(torch, DTYPES[n])))
            for n, a in _params().items()}
        opt = toptim.AdamW(tp, {"default": 1e-2, "Embedding.weight": 3e-2},
                           weight_decay=_decay, clip=1.0, tags=dict(TAGS))
        for step in range(3):
            for n, p in tp.items():
                p.grad = torch.tensor(_grads(step)[n]).to(p.dtype)
            opt.step(lr_factor=[1.0, 0.5, 0.25][step])
        return [t for p in tp.values() for t in (p.detach(), *(
            x for x in opt.state[p].values() if x is not None))]

    assert [list(r) for r in optimizers._runs(
        [torch.zeros(n) for n in (30, 5, 21, 4, 6)], 20)] == [
            [0], [1], [2], [3, 4]]
    one, several = run(1 << 28), run(20)
    assert all(torch.equal(x, y) for x, y in zip(one, several))


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _grads(0)
    jt = {n: jnp.asarray(a, getattr(jnp, DTYPES[n])) for n, a in g.items()}
    want, jnorm = joptim.clip_by_global_norm(jt, max_norm)
    tt = [torch.tensor(a).to(getattr(torch, DTYPES[n])) for n, a in g.items()]
    got, norm = toptim.clip_by_global_norm(tt, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(toptim.global_norm(tt)), float(jnorm),
                               rtol=1e-6)
    for t, n in zip(got, g):
        assert t.dtype == getattr(torch, DTYPES[n])
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(want[n].astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-7)
    assert float(toptim.global_norm([])) == 0.0


@pytest.mark.parametrize("warmup,total,min_factor",
                         [(5, 30, 0.1), (0, 10, 0.0), (8, 8, 0.2)])
def test_cosine_with_warmup_matches_jax(warmup, total, min_factor):
    from lamp_tpu.optim import schedules as js

    from lamp_tpu_torch.optim import schedules as ts
    j = js.cosine_with_warmup(warmup, total, min_factor)
    t = ts.cosine_with_warmup(warmup, total, min_factor)
    for step in range(total + 5):
        assert t(t.init_state, step, None)[1] == pytest.approx(
            j(j.init_state, step, None)[1], rel=1e-12)


def test_resolve_hyper_follows_tags():
    tags = {"a": "Linear.weight", "b": "Linear.bias", "c": "LayerNorm.weight"}
    assert toptim.resolve_hyper(0.5, tags) == {"a": 0.5, "b": 0.5, "c": 0.5}
    assert toptim.resolve_hyper({"default": 1.0, "Linear.bias": 2.0}, tags) \
        == {"a": 1.0, "b": 2.0, "c": 1.0}
    assert toptim.resolve_hyper({"Linear.bias": 2.0}, tags)["a"] == 0.0
    assert toptim.resolve_hyper(lambda t: len(t), tags)["c"] == 16.0


def test_load_adamw_state_resumes_from_jax_state():
    """Both packages take 2 steps of the tiny GPT apart, the JAX state is
    carried across, and one more step from it agrees."""
    jm = jax_lm()
    jparams = jnn.partition_params(jm)[0]
    tags = jnn.param_tags(jparams)
    jopt = joptim.AdamW(1e-2, beta2=0.95, weight_decay=0.01, tags=tags)
    jstate = jopt.init(jparams)
    rng = np.random.RandomState(3)
    flat, tree = jax.tree_util.tree_flatten(jparams)

    def grads():
        return tree.unflatten([jnp.asarray(rng.randn(*x.shape), jnp.float32)
                               for x in flat])

    for _ in range(2):
        jparams, jstate = jopt.step(jparams, grads(), jstate)
    tm = torch_lm(jparams)
    topt = toptim.AdamW(tm.named_parameters(), 1e-2, beta2=0.95,
                        weight_decay=0.01, tags=tnn.param_tags(tm))
    bridge.load_adamw_state(
        {"step": int(jstate["step"]), "mt": jax_params(jstate["mt"]),
         "vt": jax_params(jstate["vt"]), "master": {}}, topt, tm)
    g = grads()
    jparams, jstate = jopt.step(jparams, g, jstate)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, tnn.Linear)}
    jg = jax_params(g)
    for name, p in tm.named_parameters():
        p.grad = torch.tensor(jg[name].T if name in linear else jg[name])
    topt.step()
    want = jax_params(jparams)
    for name, p in tm.named_parameters():
        w = want[name].T if name in linear else want[name]
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    with pytest.raises(KeyError, match="final_norm.bias"):
        mt = jax_params(jstate["mt"])
        del mt["final_norm.bias"]
        bridge.load_adamw_state({"step": 3, "mt": mt, "vt": mt, "master": {}},
                                topt, tm)
