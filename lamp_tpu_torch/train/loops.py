"""Training loops: the train and eval steps, the epoch loop.

Counterpart of :mod:`lamp_tpu.train.loops` (``TrainState``,
``make_train_step`` with the ``simple``, ``adversarial`` and ``perturbed``
loss calculations, ``make_chained_train_step``, ``make_eval_step``,
``one_epoch``, ``validation_one_epoch``, ``epochs``, ``TrainingResult``,
``run_batch_stream``). The JAX step is a pure function of an immutable
state, jitted into one program. Here the model and the optimizer are
mutable ``torch`` objects: the step runs eagerly, updates them in place
and returns the same state. ``loss_fn(model, batch, generator, train) ->
(loss, n_examples)``; it returns no new model, since modules keep their own
buffers. Randomness (dropout, the perturbed loss's noise) comes from a
``torch.Generator``: ``epochs`` derives each epoch's from (seed, epoch), so
a resumed run draws what an uninterrupted one would.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..optim import schedules as lr_schedules

__all__ = ["TrainState", "make_train_step", "make_chained_train_step",
           "make_eval_step", "one_epoch", "validation_one_epoch", "epochs",
           "TrainingResult", "run_batch_stream", "parallel_run_batch_stream",
           "packed_lm_loss"]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @staticmethod
    def init(model: nn.Module, optimizer) -> "TrainState":
        return TrainState(model, optimizer, 0)


def _index(batch, i):
    """Micro-batch ``i`` of a tensor, or a tuple, list or dict of tensors,
    whose tensors lead with the accumulation axis."""
    if isinstance(batch, dict):
        return {k: _index(v, i) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_index(v, i) for v in batch)
    return batch[i]


def make_train_step(optimizer, loss_fn, *, accumulation_steps: int = 1,
                    loss_calculation: str = "simple",
                    adversarial_eps: float = 1e-3,
                    gradient_pmean_axis: Optional[str] = None):
    """Build ``step(state, batch, generator=None, lr_factor=1.0) ->
    (state, (loss, n))``: the loss's forward and backward, then
    ``optimizer.step(lr_factor=...)``.

    With ``accumulation_steps > 1`` every tensor of ``batch`` leads with an
    axis of that size. Each micro-batch's gradients (in the parameters'
    dtype) are summed in f32, weighted by its ``n_examples``, divided by
    the total and cast back to the parameters' dtype before the optimizer,
    as in the JAX step; the loss is the example-weighted mean. The
    micro-batches run as a Python loop (the JAX step's
    ``accumulation_unroll``, its choice between ``lax.scan`` and an
    unrolled trace, has no counterpart).

    ``loss_calculation``:

    - ``"simple"``: the loss's gradient;
    - ``"adversarial"`` (``batch`` is ``(features, target)``, the features
      a float tensor): the gradient of the loss with respect to the
      features gives ``adv = features + adversarial_eps * sign(grad)``; the
      step takes the mean of the clean and the adversarial loss, and of
      their gradients;
    - ``"perturbed"``: the gradient at the parameters plus
      ``adversarial_eps`` times a standard normal draw of ``generator``
      (in each parameter's dtype), applied to the parameters themselves.
      The noise is the port's own draw, so it agrees with the JAX step's in
      distribution only; at ``adversarial_eps=0`` the step is
      ``"simple"``'s.

    ``gradient_pmean_axis`` (data-parallel averaging over a mesh axis)
    raises ``NotImplementedError`` until the port's ``parallel`` exists.
    """
    if loss_calculation not in ("simple", "adversarial", "perturbed"):
        raise ValueError(loss_calculation)
    if gradient_pmean_axis is not None:
        raise NotImplementedError("make_train_step: gradient_pmean_axis= "
                                  "(the port has no parallel package yet)")

    def trainable():
        return [p for group in optimizer.param_groups
                for p in group["params"]]

    def micro(model, batch, generator):
        """One micro-batch's loss and ``n``, its gradients in ``.grad``."""
        if loss_calculation == "adversarial":
            features, target = batch
            x = features.detach().requires_grad_(True)
            loss_x, _ = loss_fn(model, (x, target), generator, True)
            gx, = torch.autograd.grad(loss_x, x)
            adv = features + adversarial_eps * torch.sign(gx)
            clean, n = loss_fn(model, batch, generator, True)
            clean.backward()
            adversarial, _ = loss_fn(model, (adv, target), generator, True)
            adversarial.backward()
            with torch.no_grad():
                for p in trainable():
                    if p.grad is not None:
                        p.grad.mul_(0.5)
            return 0.5 * (clean.detach() + adversarial.detach()), float(n)
        if loss_calculation == "perturbed":
            if generator is None:
                raise ValueError("the perturbed loss draws its noise from a "
                                 "generator")
            params = trainable()
            with torch.no_grad():
                saved = [p.detach().clone() for p in params]
                for p in params:
                    noise = torch.randn(p.shape, generator=generator,
                                        device=generator.device,
                                        dtype=p.dtype)
                    p.add_(noise.to(p.device).mul_(adversarial_eps))
            try:
                loss, n = loss_fn(model, batch, generator, True)
                loss.backward()
            finally:
                with torch.no_grad():
                    for p, s in zip(params, saved):
                        p.copy_(s)
            return loss.detach(), float(n)
        loss, n = loss_fn(model, batch, generator, True)
        loss.backward()
        return loss.detach(), float(n)

    def step(state: TrainState, batch, generator=None, lr_factor=1.0):
        optimizer.zero_grad(set_to_none=True)
        if accumulation_steps == 1:
            loss, n = micro(state.model, batch, generator)
        else:
            params = trainable()
            gsum, lsum, n = None, 0.0, 0.0
            # the JAX step folds the micro-batches with lax.scan inside one
            # jitted program; here it is a Python loop of eager steps (a
            # CUDA graph of the step is later work)
            for i in range(accumulation_steps):
                loss_i, n_i = micro(state.model, _index(batch, i), generator)
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         if p.grad is None else p.grad.float()
                         for p in params]
                if gsum is None:
                    gsum = torch._foreach_mul(grads, n_i)
                else:
                    torch._foreach_add_(gsum, grads, alpha=n_i)
                lsum = lsum + loss_i.float() * n_i
                n += n_i
                optimizer.zero_grad(set_to_none=True)
            torch._foreach_div_(gsum, n)
            for p, g in zip(params, gsum):
                p.grad = g.to(p.dtype)
            loss = lsum / n
        optimizer.step(lr_factor=lr_factor)
        state.step += 1
        return state, (loss, n)

    return step


def make_chained_train_step(optimizer, loss_fn, **step_kwargs):
    """Build ``chained(state, batches, generator=None, lr_factor=1.0) ->
    (state, (loss, n))``: one full optimizer step for each of the K batches
    stacked on the leading axis of ``batches``; the loss is the
    example-weighted mean over them and ``n`` their total. The JAX step
    runs the K steps as one ``lax.scan`` program, to pay one dispatch for
    them; here they are a Python loop (its CUDA graph is later work)."""
    step = make_train_step(optimizer, loss_fn, **step_kwargs)

    def chained(state: TrainState, batches, generator=None, lr_factor=1.0):
        k = _leading(batches)
        losses, ns = [], []
        for i in range(k):
            state, (loss, n) = step(state, _index(batches, i), generator,
                                    lr_factor)
            losses.append(loss * n)
            ns.append(n)
        total = sum(ns)
        return state, (torch.stack(losses).sum() / total, total)

    return chained


def _leading(batch) -> int:
    """The leading dimension of the first tensor of ``batch``."""
    while isinstance(batch, (dict, list, tuple)):
        batch = next(iter(batch.values())) if isinstance(batch, dict) \
            else batch[0]
    return batch.shape[0]


def make_eval_step(loss_fn):
    """``step(state, batch) -> (loss, n)`` without gradients, in eval
    mode (``train=False``)."""

    def step(state: TrainState, batch):
        with torch.no_grad():
            return loss_fn(state.model, batch, None, False)

    return step


def packed_lm_loss(model, batch, generator=None, train=True):
    """A ``loss_fn`` for :func:`make_train_step` over packed documents:
    ``batch`` is ``(tokens, targets, segment_ids, positions)`` as
    :func:`~lamp_tpu_torch.data.pack_documents` gives them (tensors,
    [B, T] each, -100 for no target); returns ``ModernLM.loss`` and the
    number of targets it averages, so that accumulated micro-batches weigh
    by tokens."""
    tokens, targets, segment_ids, positions = batch
    loss = model.loss(tokens, targets, segment_ids=segment_ids,
                      positions=positions)
    return loss, int((targets != -100).sum())


def _device_of(model) -> torch.device:
    for p in model.parameters():
        return p.device
    return torch.device("cpu")


def _on_device(batch, device):
    """``batch`` with each array or tensor a tensor on ``device``."""
    if isinstance(batch, dict):
        return {k: _on_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_on_device(v, device) for v in batch)
    if isinstance(batch, (np.ndarray, np.generic, torch.Tensor)):
        return torch.as_tensor(batch, device=device)
    return batch


def _stack(batches):
    """Batches of the same structure stacked on a new leading axis."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in batches]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([b[i] for b in batches])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(batches)
    return np.stack(batches)


def _shapes(batch):
    if isinstance(batch, dict):
        return tuple(_shapes(batch[k]) for k in sorted(batch))
    if isinstance(batch, (list, tuple)):
        return tuple(_shapes(b) for b in batch)
    return tuple(np.shape(batch))


def _batches(stream, prefetch, device):
    from ..data.batchstream import prefetch_to_device

    if prefetch:
        return prefetch_to_device(stream, device=device)
    return (_on_device(b, device) for b in stream)


def _weighted(losses, counts):
    """(sum of loss x n, sum of n) over an epoch: the one read of the
    device's losses an epoch."""
    if not losses:
        return 0.0, 0.0
    return float(torch.stack(losses).sum()), float(sum(float(c)
                                                       for c in counts))


def one_epoch(state: TrainState, stream, train_step, generator, *,
              lr_factor=1.0, prefetch: bool = True, device=None, log=None,
              steps_per_call: int = 1):
    """Drive one training epoch: ``train_step(state, batch, generator,
    lr_factor)`` over the batches of ``stream``, prefetched to ``device``
    (default: the model's) on a side stream. The losses stay on the device
    and are read once, at the end. ``steps_per_call > 1`` stacks that many
    batches (a ragged batch flushes the ones before it) for a
    :func:`make_chained_train_step` step.

    Returns (state, mean loss, instances, seconds)."""
    device = device if device is not None else _device_of(state.model)
    it = _batches(stream, prefetch, device)
    losses, counts = [], []
    t0 = time.perf_counter()
    if steps_per_call > 1:
        def stacked():
            buf = []
            for b in it:
                if buf and _shapes(b) != _shapes(buf[0]):
                    yield _stack(buf)
                    buf = []
                buf.append(b)
                if len(buf) == steps_per_call:
                    yield _stack(buf)
                    buf = []
            if buf:
                yield _stack(buf)

        batch_iter = stacked()
    else:
        batch_iter = it
    for batch in batch_iter:
        state, (loss, n) = train_step(state, batch, generator, lr_factor)
        losses.append(loss * n)
        counts.append(n)
    total_loss, total_n = _weighted(losses, counts)
    dt = time.perf_counter() - t0
    mean = total_loss / max(total_n, 1.0)
    if log:
        log(f"train loss {mean:.6f} ({total_n:.0f} instances, "
            f"{total_n / max(dt, 1e-9):.1f} inst/s)")
    return state, mean, total_n, dt


def validation_one_epoch(state: TrainState, stream, eval_step, *,
                         prefetch: bool = True, device=None):
    """The example-weighted mean of ``eval_step`` over ``stream``, read
    once."""
    device = device if device is not None else _device_of(state.model)
    losses, counts = [], []
    for batch in _batches(stream, prefetch, device):
        loss, n = eval_step(state, batch)
        losses.append(loss * n)
        counts.append(n)
    if not losses:
        return 0.0
    total_loss, total_n = _weighted(losses, counts)
    return total_loss / max(total_n, 1.0)


@dataclasses.dataclass
class TrainingResult:
    """What :func:`epochs` returns: the final state, the learning curve
    [(epoch, train loss, smoothed validation loss, validation loss)], and
    the minimum smoothed validation loss with its epoch and (when asked
    for) a copy of the state at that epoch."""

    state: TrainState
    learning_curve: List[Tuple[int, float, Optional[float], Optional[float]]]
    min_validation_loss: Optional[float]
    min_validation_epoch: Optional[int]
    min_validation_state: Optional[TrainState]


def _copy_state(state: TrainState) -> TrainState:
    """A copy of ``state`` that shares no tensor with it: the model, and
    the optimizer over the copy's parameters with its own state and
    settings. (JAX arrays are immutable, so the JAX loop keeps the state
    itself; the port's is updated in place.)"""
    memo: Dict[int, Any] = {}
    model = copy.deepcopy(state.model, memo)
    optimizer = object.__new__(type(state.optimizer))
    # the optimizer's own attributes too (a deepcopy of a torch optimizer
    # keeps only its defaults, state and param groups); the memo maps its
    # parameters onto the copied model's
    optimizer.__dict__.update(copy.deepcopy(state.optimizer.__dict__, memo))
    return TrainState(model, optimizer, state.step)


def _seed_of(key) -> int:
    if key is None:
        return 0
    if isinstance(key, torch.Generator):
        return key.initial_seed()
    return int(key)


def _epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The ``torch.Generator`` of ``epoch``, on ``device``: seeded from
    (seed, epoch) alone, so an epoch draws the same whether the run reached
    it or resumed at it."""
    word = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(word[0]))


def epochs(*, model=None, state: Optional[TrainState] = None, optimizer,
           loss_fn: Callable, train_batches: Callable[[int], Iterable],
           validation_batches: Optional[Callable[[int], Iterable]] = None,
           epochs: int, key=None,
           learning_rate_schedule: Optional[lr_schedules.Schedule] = None,
           validation_frequency: int = 1,
           return_min_validation_loss_model: bool = False,
           validation_smoothing_factor: float = 1.0,
           accumulation_steps: int = 1,
           loss_calculation: str = "simple",
           checkpoint_callback: Optional[Callable[[TrainState, Dict],
                                                  None]] = None,
           training_callback: Optional[Callable[[int, float], None]] = None,
           validation_callback: Optional[Callable[[int, float], None]] = None,
           train_step=None,
           prefetch: bool = True,
           steps_per_call: int = 1,
           resume_from: Optional[Dict] = None,
           log: Optional[Callable[[str], None]] = None) -> TrainingResult:
    """The training loop over epochs, as the JAX ``epochs``: each epoch
    takes its factor from ``learning_rate_schedule``, trains over
    ``train_batches(epoch)``, validates every ``validation_frequency``
    epochs over ``validation_batches(epoch)`` (smoothed exponentially by
    ``validation_smoothing_factor``), tracks the minimum smoothed
    validation loss (and, with ``return_min_validation_loss_model``, a copy
    of that epoch's state), appends to the learning curve and hands the
    state and the bookkeeping to ``checkpoint_callback``.

    ``key`` is the run's seed (an int, or a ``torch.Generator`` whose
    initial seed is taken; default 0): epoch ``e`` trains with
    :func:`_epoch_generator` (seed, e) on the model's device.
    ``resume_from`` (a ``checkpoint_callback`` payload, or the ``meta`` of
    :func:`lamp_tpu_torch.io.load_loop_state` with the resume fields that
    :func:`lamp_tpu_torch.train.resumable_epochs` adds), together with the
    restored ``state=``, continues at ``epoch + 1`` with the schedule's
    state, the curve and the minimum; with the generator a function of
    (seed, epoch), the resumed run trains as the uninterrupted one would.
    """
    if state is None:
        state = TrainState.init(model, optimizer)
    if train_step is not None and steps_per_call > 1:
        raise ValueError(
            "steps_per_call > 1 stacks batches on a leading axis, which a "
            "plain train_step will silently mis-handle; build yours with "
            "make_chained_train_step and drive one_epoch directly, or let "
            "epochs build the step (train_step=None)")
    if train_step is None:
        maker = (make_chained_train_step if steps_per_call > 1
                 else make_train_step)
        train_step = maker(optimizer, loss_fn,
                           accumulation_steps=accumulation_steps,
                           loss_calculation=loss_calculation)
    eval_step = make_eval_step(loss_fn)
    schedule = learning_rate_schedule or lr_schedules.noop()
    sched_state = schedule.init_state
    seed = _seed_of(key)
    device = _device_of(state.model)

    curve: List = []
    min_val = None
    min_val_epoch = None
    min_val_state = None
    smoothed_val = None
    last_val = None
    start_epoch = 0
    if resume_from is not None:
        start_epoch = int(resume_from["epoch"]) + 1
        if resume_from.get("lr_state") is not None:
            sched_state = resume_from["lr_state"]
        curve = [tuple(c) for c in resume_from.get("learning_curve") or []]
        min_val = resume_from.get("min_validation_loss")
        min_val_epoch = resume_from.get("min_validation_epoch")
        min_val_state = resume_from.get("min_validation_state")
        smoothed_val = resume_from.get("smoothed_validation_loss", min_val)
        last_val = resume_from.get("validation_loss")

    for epoch in range(start_epoch, epochs):
        sched_state, lr_factor = schedule(sched_state, epoch, last_val)
        state, train_loss, n, dt = one_epoch(
            state, train_batches(epoch), train_step,
            _epoch_generator(seed, epoch, device), lr_factor=lr_factor,
            prefetch=prefetch, device=device, log=log,
            steps_per_call=steps_per_call)
        if training_callback is not None:
            training_callback(epoch, train_loss)
        val_loss = None
        if validation_batches is not None and \
                epoch % validation_frequency == 0:
            val_loss = validation_one_epoch(
                state, validation_batches(epoch), eval_step,
                prefetch=prefetch, device=device)
            last_val = val_loss
            smoothed_val = (
                val_loss if smoothed_val is None
                else validation_smoothing_factor * val_loss
                + (1 - validation_smoothing_factor) * smoothed_val)
            if min_val is None or smoothed_val < min_val:
                min_val = smoothed_val
                min_val_epoch = epoch
                if return_min_validation_loss_model:
                    min_val_state = _copy_state(state)
            if validation_callback is not None:
                validation_callback(epoch, val_loss)
            if log:
                log(f"epoch {epoch}: validation loss {val_loss:.6f} "
                    f"(smoothed {smoothed_val:.6f})")
        curve.append((epoch, train_loss, smoothed_val, val_loss))
        if checkpoint_callback is not None:
            checkpoint_callback(state, {
                "epoch": epoch,
                "train_loss": train_loss,
                "validation_loss": last_val,
                "lr_state": sched_state,
                "learning_curve": curve,
                # what epochs(resume_from=) reads back
                "min_validation_loss": min_val,
                "min_validation_epoch": min_val_epoch,
                "smoothed_validation_loss": smoothed_val,
                "min_validation_state": min_val_state,
            })

    return TrainingResult(
        state=state,
        learning_curve=curve,
        min_validation_loss=min_val,
        min_validation_epoch=min_val_epoch,
        min_validation_state=min_val_state)


@torch.no_grad()
def run_batch_stream(state_or_model, stream, forward: Callable, *,
                     prefetch: bool = False):
    """Forward-only inference: ``[forward(model, batch) for batch in
    stream]``, without gradients; ``prefetch`` stages the batches on the
    model's device."""
    model = (state_or_model.model if isinstance(state_or_model, TrainState)
             else state_or_model)
    if prefetch:
        from ..data.batchstream import prefetch_to_device

        stream = prefetch_to_device(stream, device=_device_of(model))
    return [forward(model, batch) for batch in stream]


def parallel_run_batch_stream(state_or_model, stream, forward: Callable, *,
                              mesh, axis: str = "dp"):
    """Inference over a device mesh: not ported until the port's
    ``parallel`` exists."""
    raise NotImplementedError("parallel_run_batch_stream (the port has no "
                              "parallel package yet)")
