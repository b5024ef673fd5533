"""Core layers: Linear, Embedding, Dropout and LayerNorm.

Counterpart of the same names in :mod:`lamp_tpu.nn.layers`, in PyTorch's
weight layout: ``Linear.weight`` is [out_features, in_features] and goes
through ``F.linear`` (``lamp_tpu`` stores [in, out]; the bridge transposes).
``__tags__`` name each parameter's tag as the JAX classes do
(:func:`lamp_tpu_torch.nn.module.param_tags`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import init as initializers

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "dropout"]


class Linear(nn.Module):
    """y = x W^T (+ b). Weight stored [out_features, in_features]."""

    __tags__ = {"weight": "Linear.weight", "bias": "Linear.bias"}

    def __init__(self, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    @staticmethod
    def init(in_features: int, out_features: int, *, generator,
             bias: bool = True, dtype=torch.float32, device="cuda") -> "Linear":
        # glorot-normal + zero bias, as lamp_tpu's Linear
        w = initializers.xavier_normal(
            generator, (out_features, in_features), dtype, device)
        b = (torch.zeros(out_features, dtype=dtype, device=w.device)
             if bias else None)
        return Linear(w, b)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Lookup table [num_embeddings, dim]."""

    __tags__ = {"weight": "Embedding.weight"}

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)

    @staticmethod
    def init(num_embeddings: int, dim: int, *, generator,
             dtype=torch.float32, device="cuda") -> "Embedding":
        return Embedding(initializers.normal(1.0)(
            generator, (num_embeddings, dim), dtype, device))

    def forward(self, x):
        return F.embedding(x, self.weight)


def dropout(x, prob: float, generator):
    """Inverted dropout: zero each entry with probability ``prob``, scale
    the others by 1 / (1 - prob). The mask is drawn from ``generator``; the
    JAX version draws from a ``jax.random`` key, so the two agree in
    distribution only."""
    if generator is None:
        raise ValueError("dropout in train mode requires a generator")
    keep = 1.0 - prob
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, 0.0).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout on an explicit ``torch.Generator``; identity in eval
    mode or at ``prob`` 0."""

    def __init__(self, prob: float = 0.5):
        super().__init__()
        self.prob = prob

    def forward(self, x, *, train: bool = False, generator=None):
        if not train or self.prob <= 0.0:
            return x
        return dropout(x, self.prob, generator)


class LayerNorm(nn.Module):
    """Normalize over the trailing ``norm_ndims`` dims with an optional
    learned scale and bias (of x's dtype); statistics in at least f32,
    output in x's dtype."""

    __tags__ = {"weight": "LayerNorm.weight", "bias": "LayerNorm.bias"}

    def __init__(self, weight: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
                 norm_ndims: int = 1):
        super().__init__()
        self.weight = None if weight is None else nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.eps = eps
        self.norm_ndims = norm_ndims

    @staticmethod
    def init(shape, *, eps: float = 1e-5, elementwise: bool = True,
             bias: bool = True, dtype=torch.float32,
             device="cuda") -> "LayerNorm":
        if isinstance(shape, int):
            shape = (shape,)
        w = torch.ones(shape, dtype=dtype, device=device) \
            if elementwise else None
        b = torch.zeros(shape, dtype=dtype, device=device) \
            if (elementwise and bias) else None
        return LayerNorm(w, b, eps=eps, norm_ndims=len(shape))

    def forward(self, x):
        # (x - mean) * rsqrt(biased var + eps) * weight + bias: PyTorch's
        # kernels compute it in f32 for bf16/f16 inputs and round the
        # output once, which is promote_types(x, f32) in the JAX version
        return F.layer_norm(x, x.shape[x.dim() - self.norm_ndims:],
                            self.weight, self.bias, self.eps)
