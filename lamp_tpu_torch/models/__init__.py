"""Generation and serving: the KV-cached ``generate``, token sampling,
constrained decoding and the paged-KV batch decode engine."""

from .constrained import TokenDFA, byte_vocab, json_value_regex
from .generate import KVCache, decode_step, generate, init_cache, prefill
from .sampling import SamplingParams, apply_penalties, sample_tokens
from .serving import (BatchServer, BeamSearchDecoder,
                      LoRADraftSpeculativeDecoder, ModernBatchServer,
                      ServingEngine, SpeculativeDecoder, draft_view)

__all__ = ["KVCache", "decode_step", "generate", "init_cache", "prefill",
           "SamplingParams", "apply_penalties", "sample_tokens",
           "BatchServer", "BeamSearchDecoder", "LoRADraftSpeculativeDecoder",
           "ModernBatchServer", "ServingEngine", "SpeculativeDecoder",
           "TokenDFA", "byte_vocab", "draft_view", "json_value_regex"]
