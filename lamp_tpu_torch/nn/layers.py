"""Core layers: Linear and Embedding.

Counterpart of the same names in :mod:`lamp_tpu.nn.layers`, in PyTorch's
weight layout: ``Linear.weight`` is [out_features, in_features] and goes
through ``F.linear`` (``lamp_tpu`` stores [in, out]; the bridge transposes).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import init as initializers

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """y = x W^T (+ b). Weight stored [out_features, in_features]."""

    def __init__(self, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    @staticmethod
    def init(in_features: int, out_features: int, *, generator,
             bias: bool = True, dtype=torch.float32, device=None) -> "Linear":
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

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)

    @staticmethod
    def init(num_embeddings: int, dim: int, *, generator,
             dtype=torch.float32, device=None) -> "Embedding":
        return Embedding(initializers.normal(1.0)(
            generator, (num_embeddings, dim), dtype, device))

    def forward(self, x):
        return F.embedding(x, self.weight)
