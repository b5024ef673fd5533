"""Operators: plain PyTorch versions and the hand-written CUDA kernels."""

from .attention import (compact_attention, dot_product_attention,
                        flash_attention, flash_attention_reference,
                        mha_reference)
from .paged_attention import paged_attention, paged_attention_reference

__all__ = ["compact_attention", "dot_product_attention", "flash_attention",
           "flash_attention_reference", "mha_reference", "paged_attention",
           "paged_attention_reference"]
