"""KV-cached autoregressive generation for the GPT family.

Counterpart of :mod:`lamp_tpu.models.generate`: per-block K/V caches on
the model's device and one decode step a token (O(ctx) a token instead of
the full forward's O(ctx²)), with the same sampling semantics (temperature
or greedy).

    cache = init_cache(model, batch=2)
    logits, cache = prefill(model, cache, prompt_tokens)   # [2, T] int
    tokens = generate(model, prompt_tokens, 32, temperature=0.8,
                      generator=torch.Generator(device="cuda").manual_seed(0))

Like the JAX functions this assumes what a :class:`LanguageModelModule`
builds: pre-norm blocks and softmax attention (whatever ``linearized`` and
``gpt_order`` say). The attention over the cache is plain PyTorch, as the
JAX package's is a plain einsum outside any Pallas kernel. The cache is
written in place: :func:`decode_step` returns the same k and v tensors
with a new length, where the JAX function returns new arrays.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.lm import LanguageModelModule

__all__ = ["KVCache", "init_cache", "prefill", "decode_step", "generate"]


class KVCache(NamedTuple):
    k: torch.Tensor  # [layers, B, H, ctx, hd]
    v: torch.Tensor
    length: torch.Tensor  # scalar int32, on the cache's device


def _block_dims(model: LanguageModelModule):
    block = model.encoder.blocks[0]
    heads = block.attention.num_heads
    # the port's Linear is [out, in]: the q width is the weight's first axis
    qk_dim = block.attention.w_q.weight.shape[0]
    return len(model.encoder.blocks), heads, qk_dim // heads


def init_cache(model: LanguageModelModule, batch: int, dtype=None,
               device=None) -> KVCache:
    """An empty cache for ``batch`` sequences of up to the model's context,
    in ``dtype`` (default: the embedding's) on ``device`` (default: the
    model's)."""
    layers, heads, hd = _block_dims(model)
    ctx = model.context_length
    weight = model.token_embedding.weight
    dt = dtype or weight.dtype
    dev = weight.device if device is None else torch.device(device)
    shape = (layers, batch, heads, ctx, hd)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                   v=torch.zeros(shape, dtype=dt, device=dev),
                   length=torch.zeros((), dtype=torch.int32, device=dev))


def _attend_cached(q, k_cache, v_cache, valid_len):
    """q [B, H, 1, hd] over the cache [B, H, ctx, hd], keys at positions
    >= ``valid_len`` masked. Products and the softmax in f32, p in v's
    dtype before the second product, the output in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[2], device=q.device)[None, None, None, :]
    s = torch.where(pos < valid_len, s,
                    torch.finfo(torch.float32).min * 0.7)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(),
                        v_cache.float()).to(q.dtype)


@torch.no_grad()
def decode_step(model: LanguageModelModule, cache: KVCache, token):
    """One cached decode step. ``token``: [B] int (the newest token of
    each sequence), at position ``cache.length``. Writes its K/V rows into
    the cache in place and returns (logits [B, V] f32, the cache with its
    length one more)."""
    b = token.shape[0]
    pos = cache.length
    x = (model.token_embedding(token[:, None])
         + model.position_embedding.weight[pos.long()][None, None])  # [B,1,D]
    at = pos.long().reshape(1)
    for li, block in enumerate(model.encoder.blocks):
        att = block.attention
        h = att.num_heads
        a_in = block.norm1(x)
        q = att._split_heads(att.w_q(a_in), h)
        k = att._split_heads(att.w_k(a_in), h)  # [B, H, 1, hd]
        v = att._split_heads(att.w_v(a_in), h)
        cache.k[li].index_copy_(2, at, k.to(cache.k.dtype))
        cache.v[li].index_copy_(2, at, v.to(cache.v.dtype))
        o = _attend_cached(q, cache.k[li], cache.v[li], pos + 1)
        o = att.w_o(o.transpose(1, 2).reshape(b, 1, -1))
        x = x + o * block.scale1
        m = block.w2(block.activation(block.w1(block.norm2(x))))
        x = x + m * block.scale2
    x = model.final_norm(x)
    w = model.token_embedding.weight
    logits = F.linear(x.float(), w.float())[:, 0, :]
    return logits, KVCache(cache.k, cache.v, pos + 1)


def prefill(model: LanguageModelModule, cache: KVCache, tokens):
    """Feed a prompt ``tokens`` [B, T] through the cache one token at a
    time (the JAX function's ``lax.scan`` as a loop; neither has a dense
    prefill). Returns (the last step's logits [B, V] f32, the cache)."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(model, cache, tokens[:, t])
    return logits, cache


def _pick(logits, temperature, generator):
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(model: LanguageModelModule, prefix, length: int, *,
             temperature: float = 1.0,
             generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Sample ``length`` tokens after ``prefix`` ([T] or [B, T] ints) with
    the KV cache; returns them as a [B, length] int numpy array.

    ``temperature <= 0`` decodes greedily (the argmax); otherwise each token
    is a categorical draw at ``logits / temperature`` from ``generator``
    (default: one on the model's device seeded with 0), so sampled tokens
    agree with the JAX function's in distribution only. Runs on the
    model's device; the tokens reach the host once, at the end."""
    dev = model.token_embedding.weight.device
    prefix = torch.as_tensor(np.asarray(prefix), device=dev).long()
    if prefix.dim() == 1:
        prefix = prefix[None]
    b, t0 = prefix.shape
    if t0 + length > model.context_length:
        raise AssertionError("exceeds context length")
    if generator is None and temperature > 0:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = init_cache(model, b)
    logits, cache = prefill(model, cache, prefix)
    tok = _pick(logits, temperature, generator)
    out = [tok]
    for _ in range(length - 1):
        logits, cache = decode_step(model, cache, tok)
        tok = _pick(logits, temperature, generator)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy()
