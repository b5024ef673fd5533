"""Layers and models (``torch.nn.Module``s)."""

from . import init
from .layers import Embedding, Linear
from .modern import (LlamaBlock, ModernLM, RMSNorm, SwiGLU, apply_rope,
                     rope_frequencies)

__all__ = ["init", "Embedding", "Linear", "LlamaBlock", "ModernLM", "RMSNorm",
           "SwiGLU", "apply_rope", "rope_frequencies"]
