"""Transformer encoder stack: multi-head attention and pre-/post-norm
encoder blocks.

Counterpart of :mod:`lamp_tpu.nn.transformer` (``lengths_to_mask``,
``linearized_attention``, ``MultiheadAttention``,
``TransformerEncoderBlock``, ``TransformerEncoder``). Modules return their
output only (the JAX modules return ``(output, module)``), and take a
``torch.Generator`` where the JAX modules take a ``jax.random`` key. The
decoder, the encoder-decoder ``Transformer`` and ``TransformerEmbedding``
are not ported yet.

Attention goes to :func:`~lamp_tpu_torch.ops.attention.flash_attention` at
every length: on CUDA tensors its kernels, on CPU tensors its plain
version. The one exception is attention dropout in training, which takes
the unfused branch, as the JAX package's own gate does on the TPU
(``transformer.py:173-188``); the training slice's configurations have
dropout 0.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention
from .layers import LayerNorm, Linear, dropout

__all__ = ["MultiheadAttention", "TransformerEncoderBlock",
           "TransformerEncoder", "lengths_to_mask", "linearized_attention",
           "gelu"]


def gelu(x):
    """GELU, tanh approximation: ``jax.nn.gelu``'s default, which the JAX
    blocks use (``F.gelu`` defaults to the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def lengths_to_mask(lengths, max_len: int):
    """Valid-length limits -> boolean attend-mask over keys: [B] gives
    [B, 1, 1, max_len], [B, Sq] gives [B, 1, Sq, max_len]."""
    pos = torch.arange(max_len, device=lengths.device)
    if lengths.dim() == 2:
        return (pos[None, None, :] < lengths[:, :, None])[:, None, :, :]
    return (pos[None, :] < lengths[:, None])[:, None, None, :]


def linearized_attention(q, k, v, *, phi: Optional[Callable] = None):
    """O(n) linearized attention: phi(q) @ (phi(k)^T @ v) / normalizer,
    in f32. q, k, v: [B, H, S, D]."""
    if phi is None:
        phi = lambda x: F.elu(x) + 1.0  # noqa: E731
    qp = phi(q.float())
    kp = phi(k.float())
    kv = torch.einsum("bhsd,bhse->bhde", kp, v.float())
    z = 1.0 / (torch.einsum("bhsd,bhd->bhs", qp, kp.sum(dim=2)) + 1e-6)
    out = torch.einsum("bhsd,bhde,bhs->bhse", qp, kv, z)
    return out.to(q.dtype)


class MultiheadAttention(nn.Module):
    """Multi-head attention with separate q/k/v/out projections; grouped
    kv heads are repeated to the query heads before attention."""

    def __init__(self, w_q: Linear, w_k: Linear, w_v: Linear, w_o: Linear, *,
                 num_heads: int, num_kv_heads: Optional[int] = None,
                 dropout: float = 0.0, causal: bool = False,
                 linearized: bool = False):
        super().__init__()
        self.w_q, self.w_k, self.w_v, self.w_o = w_q, w_k, w_v, w_o
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError("num_kv_heads must divide num_heads")
        self.dropout = dropout
        self.causal = causal
        self.linearized = linearized

    @staticmethod
    def init(dim_in: int, dim_qk: int, dim_v: int, num_heads: int, *,
             generator, out_dim: Optional[int] = None, dropout: float = 0.0,
             causal: bool = False, bias: bool = False,
             linearized: bool = False, num_kv_heads: Optional[int] = None,
             dtype=torch.float32, device="cuda") -> "MultiheadAttention":
        out_dim = out_dim if out_dim is not None else dim_in
        kv_heads = num_kv_heads if num_kv_heads is not None else num_heads
        kw = dict(generator=generator, bias=bias, dtype=dtype, device=device)
        return MultiheadAttention(
            Linear.init(dim_in, dim_qk, **kw),
            Linear.init(dim_in, kv_heads * (dim_qk // num_heads), **kw),
            Linear.init(dim_in, kv_heads * (dim_v // num_heads), **kw),
            Linear.init(dim_v, out_dim, **kw),
            num_heads=num_heads, num_kv_heads=kv_heads, dropout=dropout,
            causal=causal, linearized=linearized)

    @staticmethod
    def _split_heads(x, heads):
        b, t, d = x.shape
        return x.reshape(b, t, heads, d // heads).transpose(1, 2)

    def _unfused(self, q, k, v, lengths, generator):
        """The JAX XLA branch with attention dropout on the weights."""
        acc = torch.promote_types(q.dtype, torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) / math.sqrt(
            q.shape[-1])
        neg = torch.finfo(torch.float32).min * 0.7
        sq, skv = q.shape[2], k.shape[2]
        if self.causal:
            qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
            kpos = torch.arange(skv, device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, neg)
        if lengths is not None:
            s = torch.where(lengths_to_mask(lengths, skv), s, neg)
        p = dropout(torch.softmax(s, dim=-1), self.dropout, generator)
        return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc),
                            v.to(acc)).to(v.dtype)

    def forward(self, x, *, train: bool = False, generator=None):
        """``x``: [B, T, D] (self-attention) or ``(query_input, kv_input,
        lengths_or_None)``; lengths ([B] or [B, Sq]) limit the keys."""
        if isinstance(x, tuple):
            xq, xkv, lengths = x
        else:
            xq, xkv, lengths = x, x, None
        q = self._split_heads(self.w_q(xq), self.num_heads)
        k = self._split_heads(self.w_k(xkv), self.num_kv_heads)
        v = self._split_heads(self.w_v(xkv), self.num_kv_heads)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        if self.linearized:
            o = linearized_attention(q, k, v)
        elif train and self.dropout > 0.0:
            o = self._unfused(q, k, v, lengths, generator)
        else:
            o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=self.causal, kv_lengths=lengths)
        b, h, t, d = o.shape
        return self.w_o(o.transpose(1, 2).reshape(b, t, h * d)).to(xq.dtype)


class TransformerEncoderBlock(nn.Module):
    """Attention + MLP with pre-norm (``gpt_order``) or post-norm order and
    learned per-channel residual scales ``scale1``/``scale2``."""

    __tags__ = {"scale1": "TransformerEncoderBlock.scale",
                "scale2": "TransformerEncoderBlock.scale"}

    def __init__(self, attention: MultiheadAttention, norm1: LayerNorm,
                 norm2: LayerNorm, w1: Linear, w2: Linear,
                 scale1: torch.Tensor, scale2: torch.Tensor, *,
                 dropout: float = 0.0, gpt_order: bool = True,
                 activation: Callable = gelu):
        super().__init__()
        self.attention = attention
        self.norm1, self.norm2 = norm1, norm2
        self.w1, self.w2 = w1, w2
        self.scale1 = nn.Parameter(scale1)
        self.scale2 = nn.Parameter(scale2)
        self.dropout = dropout
        self.gpt_order = gpt_order
        self.activation = activation

    @staticmethod
    def init(in_dim: int, attention_hidden: int, attention_heads: int,
             mlp_hidden: int, *, generator, dropout: float = 0.0,
             causal: bool = False, gpt_order: bool = True, bias: bool = True,
             activation: Callable = gelu, linearized: bool = False,
             dtype=torch.float32, device="cuda") -> "TransformerEncoderBlock":
        kw = dict(generator=generator, bias=bias, dtype=dtype, device=device)
        return TransformerEncoderBlock(
            MultiheadAttention.init(
                in_dim, attention_hidden, attention_hidden, attention_heads,
                out_dim=in_dim, dropout=dropout, causal=causal,
                linearized=linearized, **kw),
            LayerNorm.init(in_dim, dtype=dtype, device=device),
            LayerNorm.init(in_dim, dtype=dtype, device=device),
            Linear.init(in_dim, mlp_hidden, **kw),
            Linear.init(mlp_hidden, in_dim, **kw),
            torch.ones(in_dim, dtype=dtype, device=device),
            torch.ones(in_dim, dtype=dtype, device=device),
            dropout=dropout, gpt_order=gpt_order, activation=activation)

    def _mlp(self, x, train, generator):
        h = self.w2(self.activation(self.w1(x)))
        if train and self.dropout > 0:
            h = dropout(h, self.dropout, generator)
        return h

    def forward(self, x, lengths=None, *, train: bool = False,
                generator=None):
        """x [B, T, D] -> [B, T, D]; ``lengths`` ([B] or [B, Sq]) limit the
        keys of every query row."""
        if self.gpt_order:
            a = self.norm1(x)
            a = self.attention((a, a, lengths), train=train,
                               generator=generator)
            x = x + a * self.scale1
            return x + self._mlp(self.norm2(x), train, generator) * self.scale2
        a = self.attention((x, x, lengths), train=train, generator=generator)
        x = self.norm1(x + a * self.scale1)
        return self.norm2(x + self._mlp(x, train, generator) * self.scale2)


def _run_block(block, x, lengths, train, seed):
    # a block's dropout draws from a generator made from its own seed, so
    # the recompute under remat draws the same masks
    gen = None
    if seed is not None:
        gen = torch.Generator(device=x.device).manual_seed(seed)
    return block(x, lengths, train=train, generator=gen)


class TransformerEncoder(nn.Module):
    """A stack of encoder blocks. ``remat=True`` recomputes each block's
    activations on the backward pass (``torch.utils.checkpoint``, the
    counterpart of ``jax.checkpoint``)."""

    def __init__(self, blocks, *, remat: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.remat = remat

    @staticmethod
    def init(num_blocks: int, in_dim: int, attention_hidden: int,
             attention_heads: int, mlp_hidden: Optional[int] = None, *,
             generator, dropout: float = 0.0, causal: bool = False,
             gpt_order: bool = True, bias: bool = True,
             activation: Callable = gelu, linearized: bool = False,
             remat: bool = False, dtype=torch.float32,
             device="cuda") -> "TransformerEncoder":
        mlp_hidden = mlp_hidden if mlp_hidden is not None else in_dim * 4
        return TransformerEncoder([
            TransformerEncoderBlock.init(
                in_dim, attention_hidden, attention_heads, mlp_hidden,
                generator=generator, dropout=dropout, causal=causal,
                gpt_order=gpt_order, bias=bias, activation=activation,
                linearized=linearized, dtype=dtype, device=device)
            for _ in range(num_blocks)], remat=remat)

    def forward(self, x, lengths=None, *, train: bool = False,
                generator=None):
        seeds = [None] * len(self.blocks)
        if train and generator is not None and any(
                b.dropout > 0 or b.attention.dropout > 0 for b in self.blocks):
            seeds = torch.randint(0, 2 ** 62, (len(self.blocks),),
                                  generator=generator,
                                  device=generator.device).tolist()
        for block, seed in zip(self.blocks, seeds):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(_run_block, block, x, lengths, train, seed,
                               use_reentrant=False)
            else:
                x = _run_block(block, x, lengths, train, seed)
        return x
