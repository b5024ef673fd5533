"""Mixture-of-experts: lamp_tpu_torch.nn.moe and the MoE branch of
ModernLM against lamp_tpu's.

Weights are made by the JAX modules from a seeded key and carried across
(the bridge for a ModernLM; the stacked expert tensors keep the JAX
layout, untransposed); inputs are made with numpy. Everything runs in f32.
Tolerance: atol 1e-5 on outputs, balancing losses and gradients (sums of
a few dozen f32 products taken in another order); losses of the model
within rtol 1e-5, and 5 AdamW steps within rtol 1e-4 per step, as
test_torch_train.py holds its f32 steps. The checkpoint cases hold the
files' leaves exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import io as jio
from lamp_tpu import nn as jnn
from lamp_tpu import optim as joptim
from lamp_tpu import train as jtrain
from lamp_tpu.nn.module import combine
from lamp_tpu_torch import bridge
from lamp_tpu_torch import io as tio
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch import optim as toptim
from lamp_tpu_torch import train as ttrain

from .test_torch_checkpoint import (_assert_leaves_equal, _jax_leaves,
                                    _port_leaves)
from .test_torch_modern import jax_params

ATOL = 1e-5
D, H, E, T = 16, 24, 4, 13

# name: (dispatch, capacity_factor, group_size). "capacity" has room for
# every slot; "capacity_drops" drops slots (C = 2 a group of 5) and pads
# the trailing group (13 tokens in 3 groups of 5); "capacity_padded" pads
# without dropping
DISPATCHES = {
    "dense": ("dense", 1.25, 0),
    "sorted": ("sorted", 1.25, 0),
    "capacity": ("capacity", 4.0, 0),
    "capacity_drops": ("capacity", 0.75, 5),
    "capacity_padded": ("capacity", 4.0, 5),
}


def _jax_moe(cls, case, seed=0):
    dispatch, cf, gs = DISPATCHES[case]
    return getattr(jnn, cls).init(D, H, E, key=jax.random.PRNGKey(seed),
                                  top_k=2, dispatch=dispatch,
                                  capacity_factor=cf, group_size=gs)


def _port_moe(jm, case):
    dispatch, cf, gs = DISPATCHES[case]
    p = {k: torch.from_numpy(np.array(v)) for k, v in jax_params(jm).items()}
    kw = dict(top_k=2, dispatch=dispatch, capacity_factor=cf, group_size=gs)
    if isinstance(jm, jnn.SwiGLUMoE):
        return tnn.SwiGLUMoE(p["w_gate"], p["w1"], p["w3"], p["w2"], **kw)
    return tnn.MoEMLP(p["w_gate"], p["w1"], p["b1"], p["w2"], p["b2"], **kw)


@pytest.mark.parametrize("case", sorted(DISPATCHES))
@pytest.mark.parametrize("cls", ["SwiGLUMoE", "MoEMLP"])
def test_moe_outputs_balancing_loss_and_grads_match_jax(cls, case):
    """Each dispatch: the output, load_balancing_loss and the gradients of
    sum(y * r) + 0.1 * aux with respect to every parameter and x."""
    jm = _jax_moe(cls, case)
    if cls == "MoEMLP":  # nonzero biases, so that their gradients show
        rng = np.random.RandomState(3)
        jm = jm.replace(b1=jnp.asarray(rng.randn(E, H).astype(np.float32)),
                        b2=jnp.asarray(rng.randn(E, D).astype(np.float32)))
    tm = _port_moe(jm, case)
    rng = np.random.RandomState(1)
    x = rng.randn(T, D).astype(np.float32)
    r = rng.randn(T, D).astype(np.float32)
    params, rest = jnn.partition_params(jm)

    def jobj(ps, xx):
        m = combine(ps, rest)
        y, _ = m.forward(xx)
        return jnp.sum(y * r) + 0.1 * m.load_balancing_loss(xx), y

    (_, want_y), (gp, gx) = jax.value_and_grad(
        jobj, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt)
    aux = tm.load_balancing_loss(xt)
    ((y * torch.from_numpy(r)).sum() + 0.1 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()),
                               float(jm.load_balancing_loss(jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL,
                               rtol=0)
    grads = jax_params(gp)
    for name, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), grads[name], atol=ATOL,
                                   rtol=0, err_msg=name)
    if DISPATCHES[case][0] == "capacity":
        assert (int(tm.dropped) > 0) == (case == "capacity_drops")


def test_dispatches_agree_without_drops():
    """dense, sorted and capacity (with room for every slot) compute the
    same function in the port, as in JAX."""
    jm = _jax_moe("SwiGLUMoE", "dense")
    x = torch.from_numpy(np.random.RandomState(2).randn(T, D)
                         .astype(np.float32))
    with torch.no_grad():
        ys = [_port_moe(jm, c)(x) for c in ("dense", "sorted", "capacity")]
    for y in ys[1:]:
        np.testing.assert_allclose(y.numpy(), ys[0].numpy(), atol=ATOL,
                                   rtol=0)


def test_moe_init_refuses_what_jax_refuses():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="dispatch"):
        tnn.SwiGLUMoE.init(D, H, E, generator=g, dispatch="ragged",
                           device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        tnn.SwiGLUMoE.init(D, H, E, generator=g, top_k=5, device="cpu")
    m = tnn.MoEMLP.init(D, H, E, generator=g, device="cpu")
    assert tnn.param_tags(m) == {"w_gate": "MoEMLP.gate", "w1": "MoEMLP.w1",
                                 "b1": "MoEMLP.bias", "w2": "MoEMLP.w2",
                                 "b2": "MoEMLP.bias"}
    # kaiming over the fan-in, as the JAX init
    assert abs(float(m.w1.detach().std()) - (2.0 / D) ** 0.5) < 0.05


def _jax_moe_lm(dispatch="dense", seed=0, **kw):
    cfg = dict(vocab_size=61, context_length=16, num_blocks=2, embed_dim=32,
               num_heads=4, num_kv_heads=2, mlp_hidden=24, moe_experts=E,
               moe_top_k=2, moe_dispatch=dispatch, moe_capacity_factor=4.0)
    cfg.update(kw)
    return jnn.ModernLM.init(key=jax.random.PRNGKey(seed), **cfg)


def _port_moe_lm(jm, dispatch="dense"):
    return bridge.load_modern_lm(jax_params(jm), device="cpu",
                                 moe_dispatch=dispatch,
                                 moe_capacity_factor=4.0)


@pytest.mark.parametrize("dispatch", ["dense", "sorted", "capacity"])
def test_moe_modern_lm_forward_loss_and_grads_match_jax(dispatch):
    """A MoE ModernLM (2 blocks, 4 experts, top-2): logits, and
    loss(moe_aux_coef=0.01) with every parameter's gradient."""
    jm = _jax_moe_lm(dispatch)
    tm = _port_moe_lm(jm, dispatch)
    assert isinstance(tm.blocks[1].mlp, tnn.SwiGLUMoE)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 61, (2, 16)).astype(np.int32)
    tgt = np.roll(toks, -1, axis=1)
    want, _ = jm.forward(jnp.asarray(toks))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    params, rest = jnn.partition_params(jm)
    wl, wg = jax.value_and_grad(lambda ps: combine(ps, rest).loss(
        jnp.asarray(toks), jnp.asarray(tgt), moe_aux_coef=0.01))(params)
    _, aux = jm.hidden(jnp.asarray(toks), with_aux=True)
    _, taux = tm.hidden(torch.from_numpy(toks).long(), with_aux=True)
    np.testing.assert_allclose(float(taux), float(aux), atol=ATOL)
    assert float(aux) > 0
    tl = tm.loss(torch.from_numpy(toks).long(), torch.from_numpy(tgt).long(),
                 moe_aux_coef=0.01)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(wl), rtol=1e-5)
    grads = jax_params(wg)
    linear = {f"{n}.weight" for n, mod in tm.named_modules()
              if isinstance(mod, tnn.Linear)}
    for name, prm in tm.named_parameters():
        w = grads[name].T if name in linear else grads[name]
        np.testing.assert_allclose(prm.grad.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)


def test_moe_modern_lm_train_steps_match_jax():
    """5 AdamW steps (3e-3, weight decay 0.01) through
    loss(moe_aux_coef=0.01) on the same rows, f32: per-step losses within
    rtol 1e-4, then every parameter within atol 1e-4."""
    jm = _jax_moe_lm("sorted", seed=1)
    tm = _port_moe_lm(jm, "sorted")

    def jloss(m, batch, key, train):
        return (m.loss(batch[0], batch[1], moe_aux_coef=0.01),
                jnp.float32(batch[1].size), m)

    jopt = joptim.AdamW(3e-3, weight_decay=0.01)
    jstep = jax.jit(jtrain.make_train_step(jopt, jloss))
    jstate = jtrain.TrainState.init(jm, jopt)
    topt = toptim.AdamW(tm.named_parameters(), 3e-3, weight_decay=0.01)
    tstate = ttrain.TrainState.init(tm, topt)
    tstep = ttrain.make_train_step(
        topt, lambda m, b, generator, train: (
            m.loss(b[0], b[1], moe_aux_coef=0.01), b[1].numel()))
    key = jax.random.PRNGKey(0)
    rng = np.random.RandomState(5)
    for _ in range(5):
        rows = rng.randint(0, 61, (2, 17)).astype(np.int32)
        batch = (rows[:, :-1], rows[:, 1:])
        jstate, (jl, _) = jstep(jstate, tuple(map(jnp.asarray, batch)), key)
        tstate, (tl, _) = tstep(tstate, tuple(torch.from_numpy(x).long()
                                              for x in batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    want = jax_params(jstate.model)
    for e in bridge.jax_entries(tm):
        if e.view is not None:
            np.testing.assert_allclose(e.view.numpy(), want[e.path],
                                       atol=1e-4, rtol=0, err_msg=e.path)


def _moe_opt_state(jm):
    """A JAX MoE ModernLM after two AdamW steps, its bridged port copy
    and the port's AdamW after the same steps."""
    def jloss(m, batch, key, train):
        return (m.loss(batch[0], batch[1], moe_aux_coef=0.01),
                jnp.float32(1.0), m)

    jopt = joptim.AdamW(3e-3, weight_decay=0.01)
    jstep = jax.jit(jtrain.make_train_step(jopt, jloss))
    jstate = jtrain.TrainState.init(jm, jopt)
    rng = np.random.RandomState(6)
    for _ in range(2):
        rows = rng.randint(0, 61, (2, 17)).astype(np.int32)
        jstate, _ = jstep(jstate, (jnp.asarray(rows[:, :-1]),
                                   jnp.asarray(rows[:, 1:])),
                          jax.random.PRNGKey(0))
    return jopt, jstate


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_moe_loop_state_crosses_the_checkpoint_files(direction, tmp_path):
    """A MoE ModernLM and its AdamW state in the JAX package's loop-state
    file, written by one package and read by the other: every leaf exact
    (the expert stacks in their JAX layout, the optimizer's moments in the
    model's flatten order)."""
    jm = _jax_moe_lm(seed=2)
    jopt, jstate = _moe_opt_state(jm)
    path = str(tmp_path / "ck")
    if direction == "jax_to_port":
        jio.save_loop_state(path, model=jstate.model,
                            optimizer_state=jstate.opt_state, epoch=2)
        tm = _port_moe_lm(_jax_moe_lm(seed=3))
        topt = toptim.AdamW(tm.named_parameters(), 3e-3, weight_decay=0.01)
        tio.load_loop_state(path, model_template=tm,
                            optimizer_state_template=topt)
        got_model, got_opt = _port_leaves(tm, topt)
        _assert_leaves_equal(got_model, _jax_leaves(jstate.model))
        _assert_leaves_equal(got_opt, _jax_leaves(jstate.opt_state))
        return
    tm = _port_moe_lm(jstate.model)
    topt = toptim.AdamW(tm.named_parameters(), 3e-3, weight_decay=0.01)
    os_ = jstate.opt_state
    bridge.load_adamw_state(
        {"step": int(os_["step"]), "mt": jax_params(os_["mt"]),
         "vt": jax_params(os_["vt"]), "master": {}}, topt, tm)
    tio.save_loop_state(path, model=tm, optimizer_state=topt, epoch=2)
    template = jtrain.TrainState.init(_jax_moe_lm(seed=3), jopt)
    loaded, meta = jio.load_loop_state(
        path, model_template=template.model,
        optimizer_state_template=template.opt_state)
    assert meta["epoch"] == 2
    want_model, want_opt = _port_leaves(tm, topt)
    _assert_leaves_equal(_jax_leaves(loaded["model"]), want_model)
    _assert_leaves_equal(_jax_leaves(loaded["optimizer_state"]), want_opt)
    _assert_leaves_equal(_jax_leaves(loaded["model"]),
                         _jax_leaves(jstate.model))
