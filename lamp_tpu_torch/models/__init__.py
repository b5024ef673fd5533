"""Generation and serving: the KV-cached ``generate``, token sampling,
constrained decoding, the paged-KV batch decode engine, HuggingFace
checkpoint interop and (in ``openai_api``) the OpenAI-compatible HTTP
front end."""

from .constrained import TokenDFA, byte_vocab, json_value_regex
from .generate import KVCache, decode_step, generate, init_cache, prefill
from .hf import (modernlm_from_hf_llama, modernlm_from_hf_state,
                 modernlm_to_hf_llama)
from .sampling import SamplingParams, apply_penalties, sample_tokens
from .serving import (BatchServer, BeamSearchDecoder,
                      LoRADraftSpeculativeDecoder, ModernBatchServer,
                      ServingEngine, SpeculativeDecoder, draft_view)

__all__ = ["KVCache", "decode_step", "generate", "init_cache", "prefill",
           "SamplingParams", "apply_penalties", "sample_tokens",
           "BatchServer", "BeamSearchDecoder", "LoRADraftSpeculativeDecoder",
           "ModernBatchServer", "ServingEngine", "SpeculativeDecoder",
           "TokenDFA", "byte_vocab", "draft_view", "json_value_regex",
           "modernlm_from_hf_llama", "modernlm_from_hf_state",
           "modernlm_to_hf_llama"]
