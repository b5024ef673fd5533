"""Train and eval steps.

Counterpart of :mod:`lamp_tpu.train.loops` (``TrainState``,
``make_train_step``, ``make_eval_step``). The JAX step is a pure function
of an immutable state, jitted into one program. Here the model and the
optimizer are mutable ``torch`` objects: the step runs eagerly, updates
them in place and returns the same state. ``loss_fn(model, batch,
generator, train) -> (loss, n_examples)``; it returns no new model, since
modules keep their own buffers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

__all__ = ["TrainState", "make_train_step", "make_eval_step", "packed_lm_loss"]


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
    """Micro-batch ``i`` of a tensor, or a tuple of tensors, whose tensors
    lead with the accumulation axis."""
    if isinstance(batch, torch.Tensor):
        return batch[i]
    return tuple(_index(v, i) for v in batch)


def make_train_step(optimizer, loss_fn, *, accumulation_steps: int = 1,
                    loss_calculation: str = "simple"):
    """Build ``step(state, batch, generator=None, lr_factor=1.0) ->
    (state, (loss, n))``: the loss's forward and backward, then
    ``optimizer.step(lr_factor=...)``.

    With ``accumulation_steps > 1`` every tensor of ``batch`` leads with an
    axis of that size. Each micro-batch's gradients (in the parameters'
    dtype) are summed in f32, weighted by its ``n_examples``, divided by
    the total and cast back to the parameters' dtype before the optimizer,
    as in the JAX step; the loss is the example-weighted mean. Only
    ``loss_calculation="simple"`` is ported.
    """
    if loss_calculation != "simple":
        raise NotImplementedError(
            f"make_train_step: loss_calculation={loss_calculation!r}")

    def micro(model, batch, generator):
        loss, n = loss_fn(model, batch, generator, True)
        loss.backward()
        return loss.detach(), float(n)

    def step(state: TrainState, batch, generator=None, lr_factor=1.0):
        optimizer.zero_grad(set_to_none=True)
        if accumulation_steps == 1:
            loss, n = micro(state.model, batch, generator)
        else:
            params = [p for group in optimizer.param_groups
                      for p in group["params"]]
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
