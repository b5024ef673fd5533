"""Operators: plain PyTorch versions and the hand-written CUDA kernels."""

from .attention import (compact_attention, dot_product_attention,
                        flash_attention, flash_attention_reference,
                        mha_reference)
from .fused_adamw import (AdamWStochastic, fused_adamw_update,
                          fused_adamw_update_reference)
from .paged_attention import paged_attention, paged_attention_reference
from .quantization import (QuantizedLinear, QuantizedLinearInt4,
                           dequantize_int4, dequantize_int8, int4_group_size,
                           int4_matmul, int4_matmul_reference, int8_matmul,
                           quantize_int4, quantize_int8,
                           quantize_int8_stochastic,
                           quantize_int8_stochastic_reference, quantize_model)

__all__ = ["compact_attention", "dot_product_attention", "flash_attention",
           "flash_attention_reference", "mha_reference", "AdamWStochastic",
           "fused_adamw_update", "fused_adamw_update_reference",
           "paged_attention",
           "paged_attention_reference", "QuantizedLinear",
           "QuantizedLinearInt4", "dequantize_int4", "dequantize_int8",
           "int4_group_size", "int4_matmul", "int4_matmul_reference",
           "int8_matmul", "quantize_int4", "quantize_int8",
           "quantize_int8_stochastic", "quantize_int8_stochastic_reference",
           "quantize_model"]
