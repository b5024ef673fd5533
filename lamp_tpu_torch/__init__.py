"""PyTorch/CUDA port of :mod:`lamp_tpu` for NVIDIA Hopper.

Mirrors the JAX package's layout (``nn``, ``ops``, ``models``) and its
public names. It imports torch and never JAX, and nothing of ``lamp_tpu``
(whose package import pulls in JAX). Each Pallas kernel of the JAX package
becomes a CUDA kernel written by hand for sm_90a, in ``csrc/``, built with
nvcc at its first CUDA use (``ops/_build.py``). On CPU tensors every kernel
wrapper takes its plain PyTorch version; on CUDA tensors it launches the
kernel or raises.

Ported so far: the paged-KV serving path (``models.ModernBatchServer``,
``models.ServingEngine``) over ``nn.ModernLM``; ``bridge.load_modern_lm``
carries a JAX model's weights across.
"""

from . import models, nn, ops

__all__ = ["models", "nn", "ops"]
