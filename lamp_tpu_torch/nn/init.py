"""Weight initializers drawing from an explicit ``torch.Generator``.

Counterpart of :mod:`lamp_tpu.nn.init`. Where the JAX package takes a
``jax.random`` key, these take a generator; the two draw different numbers
from one seed, so the parity tests carry weights across with
:mod:`lamp_tpu_torch.bridge` instead. Numbers are drawn in f32 on the
generator's device, then cast and moved.
"""

from __future__ import annotations

import math

import torch

__all__ = ["normal", "xavier_normal"]


def normal(std=0.02):
    def init(generator, shape, dtype=torch.float32, device=None):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * std).to(device=device or generator.device, dtype=dtype)

    return init


def xavier_normal(generator, shape, dtype=torch.float32, device=None):
    """Glorot normal, std sqrt(2 / (fan_in + fan_out)); symmetric in the two
    fans, so it serves the JAX [in, out] and the PyTorch [out, in] layout."""
    std = math.sqrt(2.0 / (shape[0] + shape[-1]))
    return normal(std)(generator, shape, dtype, device)
