"""Layers and models (``torch.nn.Module``s)."""

from . import init
from .layers import Dropout, Embedding, LayerNorm, Linear
from .lm import (LanguageModelInput, LanguageModelLoss, LanguageModelModule,
                 lm_loss)
from .lora import (LoRALinear, lora_inject, lora_merge,
                   lora_parameter_count)
from .losses import cross_entropy_loss, nll_loss, sequence_nll
from .modern import (LlamaBlock, ModernLM, RMSNorm, SwiGLU, apply_rope,
                     rope_frequencies)
from .module import param_tags
from .moe import MoEMLP, SwiGLUMoE
from .transformer import (MultiheadAttention, TransformerEncoder,
                          TransformerEncoderBlock, lengths_to_mask,
                          linearized_attention)

__all__ = ["init", "Dropout", "Embedding", "LayerNorm", "Linear",
           "LanguageModelInput", "LanguageModelLoss", "LanguageModelModule",
           "lm_loss", "LoRALinear", "lora_inject", "lora_merge",
           "lora_parameter_count", "cross_entropy_loss", "nll_loss",
           "sequence_nll",
           "LlamaBlock", "ModernLM", "RMSNorm", "SwiGLU", "apply_rope",
           "rope_frequencies", "MoEMLP", "SwiGLUMoE", "param_tags", "MultiheadAttention",
           "TransformerEncoder", "TransformerEncoderBlock", "lengths_to_mask",
           "linearized_attention"]
