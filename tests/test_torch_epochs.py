"""The port's epoch loop (lamp_tpu_torch.train.epochs, one_epoch,
resumable_epochs) and learning-rate schedules against lamp_tpu's.

A 1-block, 32-wide GPT (2 heads, attention 48 wide, MLP 128, vocab 61,
context 16) made by lamp_tpu from a seeded key is bridged into the port;
both packages run ``epochs`` over the same numpy batches (2 a epoch, 3
sequences each) with a validation stream, exponential smoothing and
``reduce_lr_on_plateau``, in f32. Tolerances: the learning curve's losses
and the minimum validation loss within rtol 1e-5 (a handful of f32 Adam
steps whose sums run in other orders), the minimum's epoch and the
schedule's counters and factors exact. The schedules are framework-free
copies: their factors and states equal JAX's exactly over 200 steps.
Within the port, a resumed run equals an uninterrupted one bit for bit on
the CPU, with dropout 0.1 (each epoch's generator comes from the seed and
the epoch alone).
"""

import filecmp
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import nn as jnn
from lamp_tpu import optim as joptim
from lamp_tpu import train as jtrain
from lamp_tpu.train import resilience as jres
from lamp_tpu_torch import bridge
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch import optim as toptim
from lamp_tpu_torch import train as ttrain
from lamp_tpu_torch.optim import schedules as tsched
from lamp_tpu_torch.train import resilience as tres

from .test_torch_modern import jax_params

VOCAB, CTX = 61, 16


def _jax_gpt(seed=0):
    return jnn.LanguageModelModule.init(
        vocab_size=VOCAB, context_length=CTX, num_blocks=1, embed_dim=32,
        attention_heads=2, attention_hidden=48, mlp_hidden=128,
        key=jax.random.PRNGKey(seed))


def _port_gpt(seed=0, dropout=0.0):
    return bridge.load_language_model(jax_params(_jax_gpt(seed)),
                                      num_heads=2, device="cpu",
                                      dropout=dropout)


def _train_batches(epoch):
    rng = np.random.RandomState(100 + epoch)
    out = []
    for _ in range(2):
        toks = rng.randint(0, VOCAB, (3, CTX)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _validation_batches(epoch):
    rng = np.random.RandomState(7)
    toks = rng.randint(0, VOCAB, (4, CTX)).astype(np.int32)
    return [(toks, np.roll(toks, -1, axis=1))]


def _jax_loss(m, batch, key, train):
    logits, nm = m.forward(batch[0], key=key, train=train)
    return (jnn.lm_loss(logits, batch[1]),
            jnp.float32(batch[0].shape[0]), nm)


def _port_loss(m, batch, generator, train):
    tokens, target = batch
    logits = m(tokens.long(), train=train, generator=generator)
    return tnn.lm_loss(logits, target.long()), tokens.shape[0]


def _port_opt(model):
    return toptim.AdamW(model.named_parameters(), 3e-3, weight_decay=0.01)


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def test_epochs_match_jax():
    jm = _jax_gpt()
    jpayloads, tpayloads = [], []
    jresult = jtrain.epochs(
        model=jm, optimizer=joptim.AdamW(3e-3, weight_decay=0.01),
        loss_fn=_jax_loss, train_batches=_train_batches,
        validation_batches=_validation_batches, epochs=4,
        learning_rate_schedule=joptim.schedules.reduce_lr_on_plateau(
            factor=0.5, patience=0, threshold=0.01),
        validation_smoothing_factor=0.7,
        return_min_validation_loss_model=True,
        checkpoint_callback=lambda s, p: jpayloads.append(p))
    tm = _port_gpt()
    tresult = ttrain.epochs(
        model=tm, optimizer=_port_opt(tm), loss_fn=_port_loss,
        train_batches=_train_batches,
        validation_batches=_validation_batches, epochs=4,
        learning_rate_schedule=tsched.reduce_lr_on_plateau(
            factor=0.5, patience=0, threshold=0.01),
        validation_smoothing_factor=0.7,
        return_min_validation_loss_model=True,
        checkpoint_callback=lambda s, p: tpayloads.append(p))
    assert [c[0] for c in tresult.learning_curve] == [0, 1, 2, 3]
    np.testing.assert_allclose(
        np.array([c[1:] for c in tresult.learning_curve], np.float64),
        np.array([c[1:] for c in jresult.learning_curve], np.float64),
        rtol=1e-5)
    assert tresult.min_validation_epoch == jresult.min_validation_epoch
    np.testing.assert_allclose(tresult.min_validation_loss,
                               jresult.min_validation_loss, rtol=1e-5)
    for tp, jp in zip(tpayloads, jpayloads):
        t_lr, j_lr = dict(tp["lr_state"]), dict(jp["lr_state"])
        t_best, j_best = t_lr.pop("best"), j_lr.pop("best")
        assert (t_best is None) == (j_best is None)
        if t_best is not None:
            np.testing.assert_allclose(t_best, j_best, rtol=1e-5)
        assert t_lr == j_lr
    # the plateau's cut ran: the learning rate fell during the run
    assert tpayloads[-1]["lr_state"]["factor"] < 1.0
    assert tresult.state.step == 8


def test_steps_per_call_matches_the_plain_loop():
    """Two batches a call through make_chained_train_step: the same steps,
    so the same parameters bit for bit, and the same curve (the mean taken
    through per-call means)."""
    results = []
    for spc in (1, 2):
        tm = _port_gpt()
        results.append((tm, ttrain.epochs(
            model=tm, optimizer=_port_opt(tm), loss_fn=_port_loss,
            train_batches=_train_batches, epochs=2, steps_per_call=spc)))
    (m1, r1), (m2, r2) = results
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)
    np.testing.assert_allclose([c[1] for c in r2.learning_curve],
                               [c[1] for c in r1.learning_curve], rtol=1e-6)
    with pytest.raises(ValueError, match="steps_per_call"):
        ttrain.epochs(model=m1, optimizer=_port_opt(m1), loss_fn=_port_loss,
                      train_batches=_train_batches, epochs=1,
                      steps_per_call=2, train_step=lambda *a: None)


def test_min_validation_state_is_a_copy():
    """The minimum's state is the state of its epoch, shares no tensor with
    the live one, and its optimizer runs over its own model."""
    tm = _port_gpt()
    seen = {}
    result = ttrain.epochs(
        model=tm, optimizer=_port_opt(tm), loss_fn=_port_loss,
        train_batches=_train_batches,
        validation_batches=lambda e: _train_batches(e + 1), epochs=4,
        return_min_validation_loss_model=True,
        checkpoint_callback=lambda s, p: seen.setdefault(p["epoch"],
                                                         _params(s.model)))
    best = result.min_validation_state
    assert best is not result.state and best.model is not tm
    for p, q in zip(best.model.parameters(),
                    seen[result.min_validation_epoch]):
        assert torch.equal(p, q)
    live = {t.data_ptr() for t in tm.parameters()}
    live |= {t.data_ptr() for s in result.state.optimizer.state.values()
             for t in s.values() if t is not None}
    mine = {t.data_ptr() for t in best.model.parameters()}
    mine |= {t.data_ptr() for s in best.optimizer.state.values()
             for t in s.values() if t is not None}
    assert not live & mine
    assert [id(p) for p in best.optimizer.params] == \
        [id(p) for p in best.model.parameters()]
    assert best.optimizer.param_names == result.state.optimizer.param_names


class Preempted(Exception):
    pass


def _resumable(tmp, model, **kw):
    return ttrain.resumable_epochs(
        checkpoint_dir=str(tmp), model=model, optimizer=_port_opt(model),
        loss_fn=_port_loss, train_batches=_train_batches,
        validation_batches=_validation_batches, epochs=3, keep=2, key=5,
        return_min_validation_loss_model=True, **kw)


def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path):
    """resumable_epochs preempted after epoch 0 and started again (into a
    model of other weights) ends where the uninterrupted run does, bit for
    bit, with dropout 0.1; the minimum's TrainState comes back from the
    file."""
    whole = _port_gpt(dropout=0.1)
    want = _resumable(tmp_path / "whole", whole)

    def preempt(state, payload):
        if payload["epoch"] == 0:
            raise Preempted

    first = _port_gpt(dropout=0.1)
    with pytest.raises(Preempted):
        _resumable(tmp_path / "cut", first, checkpoint_callback=preempt)
    assert sorted(os.listdir(tmp_path / "cut")) == [
        "epoch-0", "epoch-0.data", "epoch-0.meta"]
    again = _port_gpt(seed=9, dropout=0.1)
    got = _resumable(tmp_path / "cut", again)
    for p, q in zip(again.parameters(), whole.parameters()):
        assert torch.equal(p, q)
    opt_got, opt_want = got.state.optimizer, want.state.optimizer
    for p, q in zip(opt_got.params, opt_want.params):
        assert torch.equal(opt_got.state[p]["mt"], opt_want.state[q]["mt"])
        assert torch.equal(opt_got.state[p]["vt"], opt_want.state[q]["vt"])
    assert got.state.step == want.state.step == 6
    assert got.learning_curve == want.learning_curve
    assert got.min_validation_epoch == want.min_validation_epoch
    for p, q in zip(got.min_validation_state.model.parameters(),
                    want.min_validation_state.model.parameters()):
        assert torch.equal(p, q)
    assert sorted(os.listdir(tmp_path / "cut")) == sorted(
        os.listdir(tmp_path / "whole")) == [
        "epoch-1", "epoch-1.data", "epoch-1.meta",
        "epoch-2", "epoch-2.data", "epoch-2.meta"]


def test_background_saves_are_on_disk_when_resumable_epochs_returns(
        tmp_path, monkeypatch):
    """resumable_epochs(background=True) waits for its last write: its
    files (each write slowed down) equal a synchronous run's byte for byte
    when it returns, and a failed last write raises from it."""
    from lamp_tpu_torch.io import checkpoint as ckpt

    sync = tmp_path / "sync"
    _resumable(sync, _port_gpt())
    write = ckpt.save_pytree

    def slow(path, tree):
        time.sleep(0.3)
        write(path, tree)

    monkeypatch.setattr(ckpt, "save_pytree", slow)
    _resumable(tmp_path / "bg", _port_gpt(), background=True)
    for name in ("epoch-2", "epoch-2.data", "epoch-2.meta"):
        assert filecmp.cmp(sync / name, tmp_path / "bg" / name,
                           shallow=False), name

    def fail_last(path, tree):
        if path.endswith("epoch-2"):
            raise RuntimeError("disk full")
        write(path, tree)

    monkeypatch.setattr(ckpt, "save_pytree", fail_last)
    with pytest.raises(RuntimeError, match="disk full"):
        _resumable(tmp_path / "fail", _port_gpt(), background=True)


def test_checkpoint_names_and_pruning_match_jax(tmp_path):
    """latest_loop_checkpoint and _prune over the same directory in both
    packages: a checkpoint without its .meta is incomplete, other names
    are left alone."""
    dirs = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        for e in (0, 1, 3, 4, 10):
            for suffix in ("", ".data") + ((".meta",) if e != 4 else ()):
                (d / f"epoch-{e}{suffix}").write_text("x")
        (d / "other.meta").write_text("x")
        (d / "other").write_text("x")
        dirs.append(str(d))
    jdir, tdir = dirs
    assert os.path.basename(tres.latest_loop_checkpoint(tdir)) == \
        os.path.basename(jres.latest_loop_checkpoint(jdir)) == "epoch-10"
    jres._prune(jdir, 2)
    tres._prune(tdir, 2)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert tres.latest_loop_checkpoint(str(tmp_path / "none")) is None


SCHEDULES = {
    "noop": lambda m: m.noop(),
    "decrement": lambda m: m.decrement(7, 0.9),
    "linear": lambda m: m.linear(1.0, 0.1, 150),
    "step_after": lambda m: m.step_after(60, 0.3),
    "cyclic": lambda m: m.cyclic(3.0, 25),
    "cosine_with_warmup": lambda m: m.cosine_with_warmup(20, 180, 0.05),
    "reduce_lr_on_plateau": lambda m: m.reduce_lr_on_plateau(
        factor=0.5, patience=3, cooldown=2, min_factor=0.01),
    "reduce_lr_on_plateau_absolute": lambda m: m.reduce_lr_on_plateau(
        factor=0.7, patience=1, threshold=0.05, relative=False),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    jsched = SCHEDULES[name](joptim.schedules)
    tsch = SCHEDULES[name](tsched)
    rng = np.random.RandomState(3)
    vals = np.cumsum(rng.randn(200) * 0.1) + 5.0
    js, ts = jsched.init_state, tsch.init_state
    for step in range(200):
        val = None if step % 9 == 0 else float(vals[step])
        js, jf = jsched(js, step, val)
        ts, tf = tsch(ts, step, val)
        assert tf == jf and ts == js, step
    assert tsched.interpolate(1.0, 0.0, 10, 4) == \
        joptim.schedules.interpolate(1.0, 0.0, 10, 4)
