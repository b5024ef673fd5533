"""LoRA: low-rank adaptation of frozen linear layers (Hu et al. 2021).

Counterpart of the serving half of :mod:`lamp_tpu.nn.lora`:
:class:`LoRALinear`, :func:`lora_inject`, :func:`lora_merge` and
:func:`lora_parameter_count`. The base weight and bias of a
:class:`LoRALinear` are BUFFERS, so ``parameters()`` yields only the
adapter's factors ``lora_a`` and ``lora_b``.

Layout: the base weight keeps the port's ``Linear`` layout [out, in]; the
factors keep the JAX package's, ``lora_a`` [in, r] and ``lora_b`` [r, out],
so that ``x @ lora_a @ lora_b`` is the delta and the bridge carries them
across untransposed.

    tuned  = nn.lora_inject(model, rank=8, generator=gen)   # a new model
    merged = nn.lora_merge(tuned)                            # plain Linears

:func:`lora_inject` and :func:`lora_merge` return a NEW module tree, as the
JAX functions do: the modules they replace are new, and so are the modules
above them, which are shallow copies with tables of their own; every other
module and every tensor is the input's own (shared, not copied). Replacing
an entry of the result (``.to()``, ``.half()`` on its buffers, a hook)
leaves the input as it was; a change made in place to a shared tensor or
module shows in both. ``match`` selects by the same dotted paths as in the JAX package
(``blocks.0.w_q``, ``blocks.0.mlp.w1``, ``lm_head``).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import init as initializers
from .layers import Linear

__all__ = ["LoRALinear", "lora_inject", "lora_merge", "lora_parameter_count"]


def _accum_dtype(dtype):
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


class LoRALinear(nn.Module):
    """y = x W^T (+ b) + (x A) B * scale, with W and b frozen (buffers);
    ``scale`` = alpha / rank. A is He-normal, B zero: the wrapped layer
    starts equal to its base."""

    __tags__ = {"weight": "Linear.weight", "bias": "Linear.bias",
                "lora_a": "LoRA.a", "lora_b": "LoRA.b"}

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 lora_a: torch.Tensor, lora_b: torch.Tensor, scale: float):
        super().__init__()
        self.register_buffer("weight", weight.detach())
        self.register_buffer(
            "bias", None if bias is None else bias.detach())
        self.lora_a = nn.Parameter(lora_a)
        self.lora_b = nn.Parameter(lora_b)
        self.scale = float(scale)

    @staticmethod
    def wrap(linear: Linear, rank: int, *, generator,
             alpha: Optional[float] = None) -> "LoRALinear":
        """Adapt ``linear``: its weight and bias become this layer's
        buffers (the same tensors), A [in, rank] is drawn from
        ``generator``, B [rank, out] is zero."""
        d_out, d_in = linear.weight.shape
        w = linear.weight
        a = initializers.kaiming_normal(generator, (d_in, rank), w.dtype,
                                        w.device)
        b = torch.zeros((rank, d_out), dtype=w.dtype, device=w.device)
        return LoRALinear(w, linear.bias, a, b,
                          float(alpha if alpha is not None else rank) / rank)

    def merge(self) -> Linear:
        """Fold the adapter into a plain :class:`Linear`."""
        acc = torch.promote_types(self.weight.dtype, torch.float32)
        with torch.no_grad():
            delta = (self.lora_a.to(acc) @ self.lora_b.to(acc)) * self.scale
            w = (self.weight.to(acc) + delta.T).to(self.weight.dtype)
        return Linear(w, None if self.bias is None else self.bias.clone())

    def forward(self, x):
        acc = _accum_dtype(x.dtype)
        xa = x.to(acc)
        y = F.linear(xa, self.weight.to(acc),
                     None if self.bias is None else self.bias.to(acc))
        lo = (xa @ self.lora_a.to(acc)) @ self.lora_b.to(acc)
        return (y + self.scale * lo).to(x.dtype)


def _map_linears(module: nn.Module, fn: Callable, path: str = ""):
    """Rebuild ``module`` with ``fn(dotted path, submodule)`` applied to
    every submodule: where ``fn`` returns a module it takes the
    submodule's place, else the walk goes into its children. A module
    with a replaced descendant is a shallow copy with tables of its own
    (children, parameters, buffers, hooks), so that replacing an entry in
    the copy (``.to()``, ``.half()``) leaves the input as it was; its
    tensors are the input's. Every other module is the input's own."""
    hit = fn(path, module)
    if hit is not None:
        return hit
    changes = {}
    for name, child in module.named_children():
        new = _map_linears(child, fn, f"{path}.{name}" if path else name)
        if new is not child:
            changes[name] = new
    if not changes:
        return module
    out = copy.copy(module)
    for key, value in vars(module).items():
        if isinstance(value, (dict, set)):
            out.__dict__[key] = value.copy()
    out._modules.update(changes)
    return out


def lora_inject(model: nn.Module, rank: int, *, generator,
                alpha: Optional[float] = None,
                match: Optional[Callable[[str], bool]] = None) -> nn.Module:
    """A copy of ``model`` whose :class:`Linear` layers are
    :class:`LoRALinear` adapters (factors A drawn from ``generator`` in
    the walk's order). ``match`` filters by dotted path (e.g. ``lambda p:
    p.endswith(("w_q", "w_v"))``); default adapts every Linear."""

    def visit(path, node):
        if type(node) is Linear and (match is None or match(path)):
            return LoRALinear.wrap(node, rank, generator=generator,
                                   alpha=alpha)
        return None

    return _map_linears(model, visit)


def lora_merge(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every :class:`LoRALinear` folded back into
    a plain :class:`Linear`."""

    def visit(path, node):
        return node.merge() if type(node) is LoRALinear else None

    return _map_linears(model, visit)


def lora_parameter_count(model: nn.Module) -> int:
    """Trainable adapter parameters (the A and B factors only)."""
    return sum(m.lora_a.numel() + m.lora_b.numel()
               for m in model.modules() if type(m) is LoRALinear)
