"""AdamW with f32 master weights for low-precision parameters.

Counterpart of ``lamp_tpu.optim.optimizers.AdamW`` (the optimizers after it
in that file are not ported yet). The JAX optimizer is pure: ``init``
returns a state and ``step`` returns new parameters and a new state. Here
it is a ``torch.optim.Optimizer`` that keeps the same state (``mt``, ``vt``
f32 moments, an f32 ``master`` for bf16/f16 parameters only, and the step
count) and updates the parameters in place under ``torch.no_grad()``, with
``torch._foreach_*`` ops over all parameters at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Hyper, resolve_hyper
from .clip import clip_by_global_norm

__all__ = ["AdamW"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class AdamW(torch.optim.Optimizer):
    """AdamW with ``b ** t`` debias, decoupled weight decay applied to the
    master weights, an optional global-norm clip of the gradients and an
    ``lr_factor`` from a schedule. ``debias=False`` drops the bias
    corrections (``1 - b ** t`` read as 1). ``mixed_precision=False`` keeps
    no master: bf16/f16 parameters are updated in f32 and rounded to
    nearest, the update that :class:`lamp_tpu_torch.ops.AdamWStochastic`
    rounds stochastically instead (the two agree to f32 rounding).

    ``params``: ``(name, parameter)`` pairs (``model.named_parameters()``)
    or a ``{name: parameter}`` dict. ``tags``: ``{name: tag}``
    (:func:`lamp_tpu_torch.nn.param_tags`) for per-tag ``learning_rate`` and
    ``weight_decay``; without it every tag is ``""``, as in the JAX
    optimizer. The update, per parameter, in f32::

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        w = w - lr_factor lr / (1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)
              - lr_factor lr wd w
    """

    def __init__(self, params, learning_rate: Hyper = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: Hyper = 0.0, clip=None, debias: bool = True,
                 mixed_precision: bool = True, tags=None):
        named = list(params.items() if isinstance(params, dict) else params)
        super().__init__([p for _, p in named], dict(step=0))
        self.param_names = [name for name, _ in named]
        tags = {name: (tags or {}).get(name, "") for name in self.param_names}
        lr = resolve_hyper(learning_rate, tags)
        wd = resolve_hyper(weight_decay, tags)
        self.lrs = [lr[name] for name in self.param_names]
        self.wds = [wd[name] for name in self.param_names]
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.clip = clip
        self.debias = debias
        for _, p in named:
            self.state[p] = {
                "mt": torch.zeros_like(p, dtype=torch.float32),
                "vt": torch.zeros_like(p, dtype=torch.float32),
                "master": (p.detach().float().clone()
                           if mixed_precision and p.dtype in _LOW_PRECISION
                           else None),
            }

    @property
    def params(self):
        return self.param_groups[0]["params"]

    @torch.no_grad()
    def step(self, closure=None, lr_factor: float = 1.0):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self.params
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if self.clip is not None:
            grads, _ = clip_by_global_norm(grads, self.clip)
        g32 = [g.float() for g in grads]
        b1, b2 = self.beta1, self.beta2
        t = self.param_groups[0]["step"] + 1
        states = [self.state[p] for p in params]
        mt = [s["mt"] for s in states]
        vt = [s["vt"] for s in states]
        torch._foreach_mul_(mt, b1)
        torch._foreach_add_(mt, g32, alpha=1 - b1)
        torch._foreach_mul_(vt, b2)
        torch._foreach_addcmul_(vt, g32, g32, value=1 - b2)
        # in f32, as the JAX optimizer computes b ** t
        tf = np.float32(t)
        bc1 = float(np.float32(1) - np.float32(b1) ** tf) if self.debias \
            else 1.0
        bc2 = float(np.float32(1) - np.float32(b2) ** tf) if self.debias \
            else 1.0
        denom = torch._foreach_div(vt, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mt, denom)
        # f32 parameters are their own master and update in place; the
        # others update their master (or, without one, an f32 copy) and are
        # cast back
        masters = [p.float() if s["master"] is None else s["master"]
                   for p, s in zip(params, states)]
        decay = torch._foreach_mul(
            masters, [lr_factor * lr * wd for lr, wd in zip(self.lrs,
                                                            self.wds)])
        torch._foreach_mul_(update, [-lr_factor * lr / bc1 for lr in self.lrs])
        torch._foreach_add_(masters, update)
        torch._foreach_sub_(masters, decay)
        cast = [(p, m) for p, m in zip(params, masters) if m is not p]
        if cast:
            torch._foreach_copy_([p for p, _ in cast], [m for _, m in cast])
        self.param_groups[0]["step"] = t
        return loss
