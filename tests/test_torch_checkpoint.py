"""lamp_tpu_torch.io.checkpoint against lamp_tpu.io.checkpoint: the same
files, in both directions.

A JAX checkpoint holds no names: its leaves come in jax.tree_util's flatten
order and the loader takes the structure from a template, so the port must
write and read exactly the JAX leaves in that order (dataclass field order
in a module, sorted keys in a dict, ``None`` leaves for absent biases, a
tied ``lm_head`` and the buffers' places in the optimizer state). The
models are small and not square (embed 32, attention 48 wide, MLP 128), so
that a missing transpose cannot load silently.

Tolerances: every leaf read from the other package's file is equal to what
that package wrote (exact). One training step from the loaded state agrees
with the JAX step as ``test_torch_train.py`` holds them: losses within rtol
1e-4 and parameters within atol 1e-4 in f32; losses within rtol 2e-2 and
f32 masters within atol 5e-3 in bf16 (the frameworks round bf16
activations at different places); under ``AdamWStochastic`` (on
f32 parameters, which round to nearest in both) as in f32. The key bias,
whose true gradient is 0, follows rounding noise with Adam steps of up to
~1.5 learning rates (early in the run, with the bias corrections), which
may point either way in the two packages: it is held to 3 learning rates.
"""

import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import io as jio
from lamp_tpu import nn as jnn
from lamp_tpu import optim as joptim
from lamp_tpu import train as jtrain
from lamp_tpu.ops.fused_adamw import AdamWStochastic as JAdamWStochastic
from lamp_tpu_torch import bridge
from lamp_tpu_torch import io as tio
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch import optim as toptim
from lamp_tpu_torch import train as ttrain
from lamp_tpu_torch.ops import AdamWStochastic as TAdamWStochastic

from .test_torch_modern import jax_params

VOCAB, CTX = 61, 16


def _decay(tag):
    return 0.0 if ("bias" in tag or "LayerNorm" in tag or "scale" in tag
                   or "Embedding" in tag) else 0.01


def _jax_gpt(dtype, seed):
    return jnn.LanguageModelModule.init(
        vocab_size=VOCAB, context_length=CTX, num_blocks=1, embed_dim=32,
        attention_heads=2, attention_hidden=48, mlp_hidden=128, dtype=dtype,
        key=jax.random.PRNGKey(seed))


def _jax_modern(tied, seed):
    return jnn.ModernLM.init(
        vocab_size=VOCAB, context_length=CTX, num_blocks=1, embed_dim=32,
        num_heads=2, num_kv_heads=1, mlp_hidden=128, tied=tied,
        key=jax.random.PRNGKey(seed))


def _port_model(jm):
    if isinstance(jm, jnn.ModernLM):
        return bridge.load_modern_lm(jax_params(jm), device="cpu")
    dtype = (torch.bfloat16 if jm.token_embedding.weight.dtype == jnp.bfloat16
             else torch.float32)
    return bridge.load_language_model(jax_params(jm), num_heads=2,
                                      device="cpu", dtype=dtype)


# name: (JAX model maker, stochastic optimizer?)
CASES = {
    "gpt_f32": (lambda seed: _jax_gpt(jnp.float32, seed), False),
    "gpt_bf16": (lambda seed: _jax_gpt(jnp.bfloat16, seed), False),
    "modern_tied": (lambda seed: _jax_modern(True, seed), False),
    "modern_untied": (lambda seed: _jax_modern(False, seed), False),
    # f32: the JAX kernel's stochastic rounding (pltpu.prng_seed) has no
    # CPU lowering, and f32 parameters round to nearest in both packages
    "gpt_f32_stochastic": (lambda seed: _jax_gpt(jnp.float32, seed), True),
}


@functools.lru_cache(maxsize=None)
def _jax_opt_step(case):
    """The case's JAX optimizer and its jitted train step, built once (a
    step traces the Pallas attention in interpret mode)."""
    make, stochastic = CASES[case]
    if stochastic:
        opt = JAdamWStochastic(3e-3, weight_decay=0.01)
    else:
        params = jnn.partition_params(make(0))[0]
        opt = joptim.AdamW(3e-3, beta2=0.95, clip=1.0, weight_decay=_decay,
                           tags=jnn.param_tags(params))
    return opt, jax.jit(jtrain.make_train_step(opt, _jax_loss))


def _port_opt(tm, stochastic):
    if stochastic:
        return TAdamWStochastic(tm.named_parameters(), 3e-3,
                                weight_decay=0.01)
    return toptim.AdamW(tm.named_parameters(), 3e-3, beta2=0.95, clip=1.0,
                        weight_decay=_decay, tags=tnn.param_tags(tm))


def _jax_loss(m, batch, key, train):
    tokens, target = batch
    if isinstance(m, jnn.ModernLM):
        return m.loss(tokens, target), jnp.float32(tokens.shape[0]), m
    logits, nm = m.forward(tokens, key=key, train=train)
    return jnn.lm_loss(logits, target), jnp.float32(tokens.shape[0]), nm


def _port_loss(m, batch, generator, train):
    tokens, target = batch
    if isinstance(m, tnn.ModernLM):
        return m.loss(tokens, target), tokens.shape[0]
    return tnn.lm_loss(m(tokens, train=train), target), tokens.shape[0]


def _batch(i):
    rng = np.random.RandomState(i)
    toks = rng.randint(0, VOCAB, (3, CTX)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _jax_step(state, case, i):
    toks, target = _batch(i)
    return _jax_opt_step(case)[1](
        state, (jnp.asarray(toks), jnp.asarray(target)),
        jax.random.PRNGKey(0))


def _port_step(state, opt, i):
    toks, target = _batch(i)
    return ttrain.make_train_step(opt, _port_loss)(
        state, (torch.from_numpy(toks).long(),
                torch.from_numpy(target).long()))


def _jax_leaves(tree):
    """A JAX tree's leaves in flatten order: f32 numpy (bf16 widened
    exactly), other arrays as they are, or None."""
    out = []
    for leaf in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: x is None):
        if leaf is None:
            out.append(None)
        else:
            a = np.asarray(leaf)
            out.append(a.astype(np.float32) if a.dtype == jnp.bfloat16
                       else a)
    return out


def _numpy(t):
    if t is None:
        return None
    t = t.detach().cpu()
    # numpy has no bf16: its values, exactly, in f32
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def model_to_jax(tm):
    """``[(path, array or None)]``: bridge.jax_entries as numpy, the port
    model's leaves in the JAX layout and flatten order."""
    return [(e.path, _numpy(e.view)) for e in bridge.jax_entries(tm)]


def optimizer_state_to_jax(topt, tm):
    """bridge.optimizer_entries as numpy: ``{"master": [(path, array or
    None)] or None, "mt": [...], "step": int32 array, "vt": [...]}`` (no
    ``master`` for AdamWStochastic), in model_to_jax's order."""
    entries = bridge.jax_entries(tm)
    state = bridge.optimizer_entries(topt, tm, entries)
    out = {"step": state["step"].numpy().copy()}
    for key in ("master", "mt", "vt"):
        if key in state:
            out[key] = None if state[key] is None else [
                (e.path, _numpy(v)) for e, v in zip(entries, state[key])]
    return out


def _port_leaves(tm, topt):
    """The port's model and optimizer state as the JAX loop state's leaves
    ({model, optimizer_state} in sorted order)."""
    state = optimizer_state_to_jax(topt, tm)
    opt = []
    for key in sorted(state):
        if key == "step":
            opt.append(state["step"])
        elif state[key] is None:
            opt.append(None)
        else:
            opt.extend(a for _, a in state[key])
    return [a for _, a in model_to_jax(tm)], opt


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if g is not None:
            assert g.shape == w.shape, i
            np.testing.assert_array_equal(g, w, err_msg=str(i))


def _assert_step_agrees(case, jl, tl, jstate, tm, topt):
    """The losses and the updated values of one step from the loaded
    state, at test_torch_train.py's tolerances (the key bias to 3 learning
    rates: see the module's docstring)."""
    bf16 = "bf16" in case
    np.testing.assert_allclose(float(tl), float(jl),
                               rtol=2e-2 if bf16 else 1e-4)
    if bf16:  # the f32 masters
        got = optimizer_state_to_jax(topt, tm)["master"]
        want = _jax_leaves(jstate.opt_state["master"])
        atol = 5e-3
    else:
        got = model_to_jax(tm)
        want = _jax_leaves(jstate.model)
        atol = 1e-4
    for (path, g), w in zip(got, want):
        if g is not None:
            np.testing.assert_allclose(
                g, w, atol=9e-3 if path.endswith("w_k.bias") else atol,
                rtol=0, err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_loop_state_loads_in_the_port(case, tmp_path):
    make, stochastic = CASES[case]
    jm = make(0)
    jstate = jtrain.TrainState.init(jm, _jax_opt_step(case)[0])
    for i in range(2):
        jstate, _ = _jax_step(jstate, case, i)
    path = str(tmp_path / "ck")
    jio.save_loop_state(path, model=jstate.model,
                        optimizer_state=jstate.opt_state, epoch=2,
                        learning_curve=[(0, 1.5, None, None)],
                        lr_state={"factor": 0.5}, extra={"step": 2})
    # a template with other weights: the load must overwrite every leaf
    tm = _port_model(make(1))
    topt = _port_opt(tm, stochastic)
    state, meta = tio.load_loop_state(path, model_template=tm,
                                      optimizer_state_template=topt)
    assert state["model"] is tm and state["optimizer_state"] is topt
    assert state["min_validation_model"] is None
    assert meta["epoch"] == 2 and meta["lr_state"] == {"factor": 0.5}
    assert meta["learning_curve"] == [[0, 1.5, None, None]]
    assert topt.param_groups[0]["step"] == 2
    got_model, got_opt = _port_leaves(tm, topt)
    _assert_leaves_equal(got_model, _jax_leaves(jstate.model))
    _assert_leaves_equal(got_opt, _jax_leaves(jstate.opt_state))
    jstate, (jl, _) = _jax_step(jstate, case, 2)
    tstate = ttrain.TrainState(tm, topt, 2)
    _, (tl, _) = _port_step(tstate, topt, 2)
    _assert_step_agrees(case, jl, tl, jstate, tm, topt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_loop_state_loads_in_jax(case, tmp_path):
    make, stochastic = CASES[case]
    jm = make(0)
    tm = _port_model(jm)
    topt = _port_opt(tm, stochastic)
    tstate = ttrain.TrainState.init(tm, topt)
    for i in range(2):
        tstate, _ = _port_step(tstate, topt, i)
    path = str(tmp_path / "ck")
    tio.save_loop_state(path, model=tm, optimizer_state=topt, epoch=2,
                        min_validation_loss=1.25)
    jtemplate = jtrain.TrainState.init(make(1), _jax_opt_step(case)[0])
    loaded, meta = jio.load_loop_state(
        path, model_template=jtemplate.model,
        optimizer_state_template=jtemplate.opt_state)
    assert meta["epoch"] == 2 and meta["min_validation_loss"] == 1.25
    want_model, want_opt = _port_leaves(tm, topt)
    _assert_leaves_equal(_jax_leaves(loaded["model"]), want_model)
    _assert_leaves_equal(_jax_leaves(loaded["optimizer_state"]), want_opt)
    params, rest = jnn.partition_params(loaded["model"])
    jstate = jtrain.TrainState(params, rest, loaded["optimizer_state"],
                               jnp.asarray(2, jnp.int32))
    jstate, (jl, _) = _jax_step(jstate, case, 2)
    _, (tl, _) = _port_step(tstate, topt, 2)
    _assert_step_agrees(case, jl, tl, jstate, tm, topt)


def test_the_files_are_byte_identical_but_for_the_treedef(tmp_path):
    """The same state written by each package: the same .data and .meta
    bytes, and the same descriptor apart from the treedef string."""
    jstate = jtrain.TrainState.init(_jax_gpt(jnp.bfloat16, 0),
                                    _jax_opt_step("gpt_bf16")[0])
    jstate, _ = _jax_step(jstate, "gpt_bf16", 0)
    tm = _port_model(_jax_gpt(jnp.bfloat16, 1))
    topt = _port_opt(tm, False)
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    jio.save_loop_state(j, model=jstate.model,
                        optimizer_state=jstate.opt_state, epoch=1)
    tio.load_loop_state(j, model_template=tm, optimizer_state_template=topt)
    tio.save_loop_state(t, model=tm, optimizer_state=topt, epoch=1)
    assert filecmp.cmp(j + ".data", t + ".data", shallow=False)
    assert filecmp.cmp(j + ".meta", t + ".meta", shallow=False)
    jd, td = (json.load(open(p)) for p in (j, t))
    assert {k: v for k, v in jd.items() if k != "treedef"} == \
        {k: v for k, v in td.items() if k != "treedef"}
    assert td["treedef"].startswith("{'min_validation_model': *, 'model': [")


def _train_state_leaves(ts):
    """A port TrainState as the JAX TrainState's leaves."""
    entries = bridge.jax_entries(ts.model)
    model = dict(model_to_jax(ts.model))
    params = [model[e.path] if e.kind == "param" else None for e in entries]
    rest = [model[e.path] if e.kind == "buffer" else None for e in entries]
    _, opt = _port_leaves(ts.model, ts.optimizer)
    return params + rest + opt + [np.asarray(ts.step, np.int32)]


@pytest.mark.parametrize("case", ["gpt_bf16", "modern_tied"])
def test_min_validation_train_state_crosses(case, tmp_path):
    """A min_validation_model that is a whole TrainState (params, rest with
    the buffers, opt_state, step), as resumable_epochs writes it, in both
    directions."""
    make, _ = CASES[case]
    jopt = _jax_opt_step(case)[0]
    jstate = jtrain.TrainState.init(make(0), jopt)
    jstate, _ = _jax_step(jstate, case, 0)
    path = str(tmp_path / "j")
    jio.save_loop_state(path, model=jstate.model,
                        optimizer_state=jstate.opt_state, epoch=0,
                        min_validation_model=jstate)
    tm = _port_model(make(1))
    topt = _port_opt(tm, False)
    tmin_model = _port_model(make(2))
    tmin = ttrain.TrainState(tmin_model, _port_opt(tmin_model, False), 0)
    state, _ = tio.load_loop_state(path, model_template=tm,
                                   optimizer_state_template=topt,
                                   min_validation_model_template=tmin)
    assert state["min_validation_model"] is tmin and tmin.step == 1
    _assert_leaves_equal(_train_state_leaves(tmin), _jax_leaves(jstate))
    # and back: the port's TrainState read by JAX
    back = str(tmp_path / "t")
    tio.save_loop_state(back, model=tm, optimizer_state=topt, epoch=0,
                        min_validation_model=tmin)
    jtemplate = jtrain.TrainState.init(make(3), jopt)
    loaded, _ = jio.load_loop_state(
        back, model_template=jtemplate.model,
        optimizer_state_template=jtemplate.opt_state,
        min_validation_model_template=jtemplate)
    _assert_leaves_equal(_jax_leaves(loaded["min_validation_model"]),
                         _train_state_leaves(tmin))


def test_f32_master_tree_and_no_mixed_precision(tmp_path):
    """An f32 model's AdamW keeps a master tree of Nones (mixed precision
    on) or one None (off), as the JAX optimizer does; a file of one layout
    does not load into the other."""
    jm = _jax_gpt(jnp.float32, 0)
    tm = _port_model(jm)
    on = toptim.AdamW(tm.named_parameters(), 1e-3)
    off = toptim.AdamW(tm.named_parameters(), 1e-3, mixed_precision=False)
    assert all(a is None
               for _, a in optimizer_state_to_jax(on, tm)["master"])
    assert optimizer_state_to_jax(off, tm)["master"] is None
    for opt, jax_opt in ((on, joptim.AdamW(1e-3)),
                         (off, joptim.AdamW(1e-3, mixed_precision=False))):
        path = str(tmp_path / f"p{opt is on}")
        tio.save_loop_state(path, model=tm, optimizer_state=opt, epoch=0)
        jst = jtrain.TrainState.init(jm, jax_opt)
        loaded, _ = jio.load_loop_state(
            path, model_template=jst.model,
            optimizer_state_template=jst.opt_state)
        _assert_leaves_equal(_jax_leaves(loaded["optimizer_state"]),
                             _port_leaves(tm, opt)[1])
        other = off if opt is on else on
        with pytest.raises(ValueError, match="leaves"):
            tio.load_loop_state(path, model_template=tm,
                                optimizer_state_template=other)


BLOB_DTYPES = {
    "f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32),
    "f16": (jnp.float16, torch.float16), "bf16": (jnp.bfloat16,
                                                  torch.bfloat16),
    "i64": (jnp.int64, torch.int64), "i32": (jnp.int32, torch.int32),
    "i16": (jnp.int16, torch.int16), "i8": (jnp.int8, torch.int8),
    "u8": (jnp.uint8, torch.uint8), "bool": (jnp.bool_, torch.bool),
}


@pytest.mark.parametrize("name", sorted(BLOB_DTYPES))
def test_blob_bytes_match_jax(name, tmp_path):
    """write_tensor_blob of the same values gives the same bytes and
    descriptors in both packages, for every dtype of the format (odd sizes,
    so the 8-byte padding shows), and each reads the other's."""
    jdt, tdt = BLOB_DTYPES[name]
    rng = np.random.RandomState(0)
    values = [rng.randn(*shape) * 50 for shape in ((3, 5), (7,), ())]
    jx = [jnp.asarray(v).astype(jdt) for v in values]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32)
                                    if jdt == jnp.bfloat16 else x)).to(tdt)
          for x in jx]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    jd = jio.write_tensor_blob(j, jx)
    td = tio.write_tensor_blob(t, tx)
    assert jd == td and all(d["dtype"] == name for d in td)
    assert filecmp.cmp(j, t, shallow=False)
    assert os.path.getsize(t) % 8 == 0
    for a, b in zip(tio.read_tensor_blob(j, jd), jio.read_tensor_blob(t, td)):
        np.testing.assert_array_equal(a, b)


def test_fp8_has_no_checkpoint_dtype(tmp_path):
    with pytest.raises(KeyError):
        jio.write_tensor_blob(str(tmp_path / "j"),
                              [jnp.zeros(4, jnp.float8_e4m3fn)])
    with pytest.raises(KeyError):
        tio.write_tensor_blob(str(tmp_path / "t"),
                              [torch.zeros(4, dtype=torch.float8_e4m3fn)])


def test_pytree_of_tensors_crosses(tmp_path):
    """A plain tree (dicts, tuples, None, a Python scalar) with a template
    of tensors: dtypes and values come back, in both directions."""
    rng = np.random.RandomState(1)
    a = rng.randn(4, 3).astype(np.float32)
    b = rng.randint(0, 9, 5).astype(np.int32)
    jtree = {"w": jnp.asarray(a), "pair": (jnp.asarray(b), None), "n": 7}
    ttree = {"w": torch.from_numpy(a), "pair": (torch.from_numpy(b), None),
             "n": 7}
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    jio.save_pytree(j, jtree)
    tio.save_pytree(t, ttree)
    assert filecmp.cmp(j + ".data", t + ".data", shallow=False)
    template = {"w": torch.zeros(4, 3, dtype=torch.float64),
                "pair": (torch.zeros(5, dtype=torch.int32), None), "n": 0}
    got = tio.load_pytree(j, template)
    assert got["w"].dtype == torch.float64 and got["n"] == 7
    np.testing.assert_array_equal(got["w"].numpy(), a.astype(np.float64))
    np.testing.assert_array_equal(got["pair"][0].numpy(), b)
    assert got["pair"][1] is None
    back = jio.load_pytree(t, jtree)
    np.testing.assert_array_equal(np.asarray(back["w"]), a)
    assert back["n"] == 7


def test_safetensors_cross(tmp_path):
    """BF16, F32, I64 and metadata: the same bytes from either package
    (the header padded with spaces to 8 bytes), each reads the other's."""
    rng = np.random.RandomState(2)
    w = rng.randn(5, 3).astype(np.float32)
    ids = np.arange(7, dtype=np.int64)
    jt = {"w": jnp.asarray(w).astype(jnp.bfloat16), "b": jnp.asarray(w[0]),
          "ids": jnp.asarray(ids)}
    tt = {"w": torch.from_numpy(w).to(torch.bfloat16),
          "b": torch.from_numpy(w[0].copy()), "ids": torch.from_numpy(ids)}
    meta = {"format": "pt"}
    j, t = str(tmp_path / "j.safetensors"), str(tmp_path / "t.safetensors")
    jio.write_safetensors(j, jt, metadata=meta)
    tio.write_safetensors(t, tt, metadata=meta)
    assert filecmp.cmp(j, t, shallow=False)
    with open(t, "rb") as f:
        header_len = int(np.frombuffer(f.read(8), "<u8")[0])
        header = f.read(header_len)
    assert header_len % 8 == 0 and json.loads(header)["__metadata__"] == meta
    got = tio.read_safetensors(j)
    assert got["w"].dtype == torch.bfloat16 and "__metadata__" not in got
    assert torch.equal(got["w"], tt["w"]) and torch.equal(got["ids"],
                                                          tt["ids"])
    back = jio.read_safetensors(t)
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  np.asarray(jt["w"], np.float32))
    np.testing.assert_array_equal(np.asarray(back["b"]), w[0])


def test_sharded_files_cross(tmp_path):
    """JAX's sharded files over the 8-device CPU mesh (dp 4 x tp 2; one
    leaf replicated over tp, so its replicas are written once) assemble in
    the port; the port's one-process files load in JAX."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lamp_tpu import parallel

    mesh = parallel.make_mesh({"dp": 4, "tp": 2})
    x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    y = jnp.arange(16, dtype=jnp.bfloat16).reshape(8, 2)
    tree = {"x": jax.device_put(x, NamedSharding(mesh, P("dp", "tp"))),
            "y": jax.device_put(y, NamedSharding(mesh, P("dp", None))),
            "step": 7, "none": None}
    path = str(tmp_path / "j")
    jio.save_pytree_sharded(path, tree)
    with open(path + ".shard0.json") as f:
        assert len(json.load(f)["records"]) == 8 + 4  # y's replicas once
    template = {"x": torch.zeros(8, 8), "y": torch.zeros(8, 2,
                                                         dtype=torch.bfloat16),
                "step": 0, "none": None}
    got = tio.load_pytree_sharded(path, template)
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(x))
    np.testing.assert_array_equal(got["y"].float().numpy(),
                                  np.asarray(y, np.float32))
    assert got["step"] == 7 and got["none"] is None
    back = str(tmp_path / "t")
    tio.save_pytree_sharded(back, {"x": got["x"], "y": got["y"], "step": 7,
                                   "none": None})
    with open(back) as f:
        assert json.load(f)["processes"] == 1
    again = jio.load_pytree_sharded(back, {"x": x, "y": y, "step": 0,
                                           "none": None})
    np.testing.assert_array_equal(np.asarray(again["x"]), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(again["y"], np.float32),
                                  np.asarray(y, np.float32))
    with pytest.raises(NotImplementedError):
        tio.load_pytree_sharded(back, template, shardings={})


def test_async_checkpointer_reraises_and_background_save_equals_sync(
        tmp_path):
    ck = tio.AsyncCheckpointer()

    def boom(path, tree):
        raise RuntimeError("disk full")

    ck.save(str(tmp_path / "x"), {"a": torch.zeros(2)}, save_fn=boom)
    with pytest.raises(RuntimeError, match="disk full"):
        ck.wait()
    ck.save(str(tmp_path / "y"), {"a": torch.zeros(2)})  # reusable
    ck.wait()
    assert os.path.exists(str(tmp_path / "y.data"))
    # a background save of the loop state, then the model changes in
    # place: the file holds the state at the save, as a synchronous one
    tm = _port_model(_jax_gpt(jnp.float32, 0))
    topt = _port_opt(tm, False)
    sync, bg = str(tmp_path / "sync"), str(tmp_path / "bg")
    tio.save_loop_state(sync, model=tm, optimizer_state=topt, epoch=4)
    tio.save_loop_state(bg, model=tm, optimizer_state=topt, epoch=4,
                        background=True)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    tio.wait_for_background_saves()
    for suffix in ("", ".data", ".meta"):
        assert filecmp.cmp(sync + suffix, bg + suffix, shallow=False)


def test_models_without_a_jax_layout_raise_type_error(tmp_path):
    """Quantized layers and LoRA-injected trees have no JAX layout in the
    port yet: saving names the class."""
    tm = _port_model(_jax_modern(True, 0))
    lora = tnn.lora_inject(tm, 2, generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="LoRALinear"):
        tio.save_loop_state(str(tmp_path / "l"), model=lora,
                            optimizer_state=None, epoch=0)
    from lamp_tpu_torch.ops import quantize_model

    with pytest.raises(TypeError, match="QuantizedLinear"):
        bridge.jax_tree(quantize_model(tm, bits=8))
    with pytest.raises(TypeError, match="optimizer"):
        tio.save_pytree(str(tmp_path / "o"),
                        {"opt": toptim.AdamW(tm.named_parameters())})


def test_model_to_jax_inverts_the_loaders():
    """bridge.jax_entries' leaves (model_to_jax) build the same model
    through the loaders, and bridge.optimizer_entries'
    (optimizer_state_to_jax) the same state through load_adamw_state."""
    for jm in (_jax_gpt(jnp.float32, 4), _jax_modern(False, 4)):
        tm = _port_model(jm)
        leaves = {k: a for k, a in model_to_jax(tm) if a is not None}
        assert leaves.keys() == jax_params(jm).keys()
        again = (bridge.load_modern_lm(leaves, device="cpu")
                 if isinstance(tm, tnn.ModernLM) else
                 bridge.load_language_model(leaves, num_heads=2,
                                            device="cpu"))
        for (n, p), (m, q) in zip(tm.named_parameters(),
                                  again.named_parameters()):
            assert n == m and torch.equal(p, q)
        opt = _port_opt(tm, False)
        _port_step(ttrain.TrainState.init(tm, opt), opt, 0)
        state = optimizer_state_to_jax(opt, tm)
        fresh = _port_opt(tm, False)
        bridge.load_adamw_state(
            {"step": int(state["step"]),
             **{k: {n: a for n, a in state[k] if a is not None}
                for k in ("mt", "vt")}, "master": {}}, fresh, tm)
        for p in tm.parameters():
            assert torch.equal(fresh.state[p]["mt"], opt.state[p]["mt"])
            assert torch.equal(fresh.state[p]["vt"], opt.state[p]["vt"])
