"""Serving: token sampling and the paged-KV batch decode engine."""

from .sampling import SamplingParams, apply_penalties, sample_tokens
from .serving import (BatchServer, ModernBatchServer, ServingEngine,
                      SpeculativeDecoder, draft_view)

__all__ = ["SamplingParams", "apply_penalties", "sample_tokens",
           "BatchServer", "ModernBatchServer", "ServingEngine",
           "SpeculativeDecoder", "draft_view"]
