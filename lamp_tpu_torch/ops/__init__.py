"""Operators: plain PyTorch versions and the hand-written CUDA kernels."""

from .attention import mha_reference
from .paged_attention import paged_attention, paged_attention_reference

__all__ = ["mha_reference", "paged_attention", "paged_attention_reference"]
