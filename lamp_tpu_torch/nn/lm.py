"""GPT-style autoregressive language model.

Counterpart of :mod:`lamp_tpu.nn.lm`: learned token and position
embeddings, a causal pre-norm :class:`TransformerEncoder`, a final
:class:`LayerNorm`, and logits through the tied token embedding, computed
in at least f32. The KV-cached decode path of the JAX package is not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import init as initializers
from .layers import Embedding, LayerNorm
from .losses import sequence_nll
from .transformer import TransformerEncoder

__all__ = ["LanguageModelModule", "LanguageModelInput", "LanguageModelLoss",
           "lm_loss"]


class LanguageModelInput(NamedTuple):
    """tokens [B, T], optional lengths [B], optional positions [B, P]
    selecting which output positions to return."""

    tokens: torch.Tensor
    lengths: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None


class LanguageModelModule(nn.Module):
    def __init__(self, token_embedding: Embedding,
                 position_embedding: Embedding, encoder: TransformerEncoder,
                 final_norm: LayerNorm, *, context_length: int):
        super().__init__()
        self.token_embedding = token_embedding
        self.position_embedding = position_embedding
        self.encoder = encoder
        self.final_norm = final_norm
        self.context_length = context_length

    @staticmethod
    def init(*, vocab_size: int, context_length: int, num_blocks: int,
             embed_dim: int, attention_heads: int,
             attention_hidden: Optional[int] = None,
             mlp_hidden: Optional[int] = None, dropout: float = 0.0,
             generator, linearized: bool = False, dtype=torch.float32,
             device="cuda") -> "LanguageModelModule":
        """Random weights drawn from ``generator``, as the JAX init draws
        them from its key: normal(0.02) embeddings, glorot-normal linears,
        unit norms and residual scales."""
        emb = initializers.normal(0.02)
        return LanguageModelModule(
            Embedding(emb(generator, (vocab_size, embed_dim), dtype, device)),
            Embedding(emb(generator, (context_length, embed_dim), dtype,
                          device)),
            TransformerEncoder.init(
                num_blocks, embed_dim, attention_hidden or embed_dim,
                attention_heads, mlp_hidden, generator=generator,
                dropout=dropout, causal=True, gpt_order=True,
                linearized=linearized, dtype=dtype, device=device),
            LayerNorm.init(embed_dim, dtype=dtype, device=device),
            context_length=context_length)

    def forward(self, inp, *, train: bool = False, generator=None):
        """Logits [B, T, V] (or [B, P, V] with ``positions``) in at least
        f32. ``inp``: tokens, a ``(tokens, lengths, positions)`` tuple or a
        :class:`LanguageModelInput`."""
        if isinstance(inp, tuple):
            tokens, lengths, positions = (tuple(inp) + (None, None))[:3]
        else:
            tokens, lengths, positions = inp, None, None
        t = tokens.shape[1]
        pos_ids = torch.arange(t, device=tokens.device)[None, :]
        x = self.token_embedding(tokens) + self.position_embedding(pos_ids)
        x = self.encoder(x, lengths, train=train, generator=generator)
        x = self.final_norm(x)
        if positions is not None:
            x = x.gather(1, positions.long()[:, :, None].expand(
                -1, -1, x.shape[-1]))
        # tied embedding transpose; f32 products of the stored values
        acc = torch.promote_types(x.dtype, torch.float32)
        return F.linear(x.to(acc), self.token_embedding.weight.to(acc))


def lm_loss(logits, target, *, ignore_index: int = -100):
    """Sequence NLL over the targets (the inputs shifted by one)."""
    return sequence_nll(logits, target, ignore_index=ignore_index)


class LanguageModelLoss(nn.Module):
    """The language model paired with its loss."""

    def __init__(self, lm: LanguageModelModule):
        super().__init__()
        self.lm = lm

    def forward(self, batch, *, train: bool = False, generator=None):
        inp, target = batch
        return lm_loss(self.lm(inp, train=train, generator=generator), target)
