"""Modern transformer components: RMSNorm, rotary embeddings, SwiGLU,
llama-style decoder blocks.

Counterpart of :mod:`lamp_tpu.nn.modern`. Modules return their output only
(the JAX modules return ``(output, module)``). ``LlamaBlock`` attends with
the flash-attention kernels on CUDA tensors at every length (the JAX
block's flash/compact length bands are TPU dispatch: the port has one
kernel), segment ids included, and with the plain
:func:`~lamp_tpu_torch.ops.attention.mha_reference` on CPU tensors, as the
JAX block does off the TPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, mha_reference
from ..ops.fused_ce import fused_lm_loss
from . import init as initializers
from .layers import Embedding, Linear
from .moe import SwiGLUMoE

__all__ = ["RMSNorm", "apply_rope", "rope_frequencies", "SwiGLU",
           "LlamaBlock", "ModernLM"]


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction, no bias); statistics in
    at least f32."""

    def __init__(self, weight: torch.Tensor, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.eps = eps

    @staticmethod
    def init(dim: int, *, eps: float = 1e-6, dtype=torch.float32,
             device="cuda") -> "RMSNorm":
        return RMSNorm(torch.ones(dim, dtype=dtype, device=device), eps=eps)

    def forward(self, x):
        sd = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(sd)
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + self.eps) * self.weight.to(sd)
        return y.to(x.dtype)


def rope_frequencies(head_dim: int, max_len: int, *, base: float = 10000.0,
                     scaling: Optional[dict] = None, dtype=torch.float32,
                     device=None):
    """Precompute (cos, sin) tables [max_len, head_dim/2].

    ``scaling`` follows HF's ``config.rope_scaling`` schema (all need
    ``{"factor": f}``): ``linear`` (positions divided by the factor),
    ``ntk`` (base stretched by ``factor^(d/(d-2))``), ``yarn`` (per-frequency
    ramp between interpolated and extrapolated angles, attention temperature
    ``0.1 ln f + 1`` folded into the tables) and ``llama3`` (frequency-banded
    interpolation). See :func:`lamp_tpu.nn.modern.rope_frequencies`.
    """
    compute = torch.promote_types(dtype, torch.float32)
    half = torch.arange(0, head_dim, 2, dtype=compute, device=device) / head_dim
    t = torch.arange(max_len, dtype=compute, device=device)
    attn_scale = 1.0
    inv = 1.0 / (base ** half)
    if scaling is not None:
        kind = scaling.get("type", "linear")
        factor = float(scaling["factor"])
        if kind == "linear":
            t = t / factor
        elif kind == "ntk":
            stretched = base * factor ** (head_dim / (head_dim - 2))
            inv = 1.0 / (stretched ** half)
        elif kind == "yarn":
            orig = int(scaling.get("original_max_len", max_len))
            beta_fast = float(scaling.get("beta_fast", 32.0))
            beta_slow = float(scaling.get("beta_slow", 1.0))

            # dims doing >= beta_fast rotations over the original window
            # extrapolate (keep inv), <= beta_slow rotations interpolate
            # (inv / factor), with a linear ramp in dimension index between
            def corr_dim(n_rot):
                return (head_dim * math.log(orig / (n_rot * 2.0 * math.pi))
                        / (2.0 * math.log(base)))

            lo = max(math.floor(corr_dim(beta_fast)), 0)
            hi = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
            if lo == hi:
                hi += 0.001  # avoid 0/0 on a degenerate range
            ramp = torch.clamp(
                (torch.arange(head_dim // 2, dtype=compute, device=device)
                 - lo) / (hi - lo), 0.0, 1.0)
            extrapolate = 1.0 - ramp
            inv = inv * extrapolate + (inv / factor) * (1.0 - extrapolate)
            attn_scale = (0.1 * math.log(factor) + 1.0) if factor > 1 else 1.0
        elif kind == "llama3":
            orig = int(scaling.get("original_max_len", max_len))
            low_f = float(scaling.get("low_freq_factor", 1.0))
            high_f = float(scaling.get("high_freq_factor", 4.0))
            wavelen = 2.0 * math.pi / inv
            # long wavelengths interpolate by the full factor; short ones
            # keep base angles; smooth blend between the two bands
            smooth = (orig / wavelen - low_f) / max(high_f - low_f, 1e-6)
            smooth = torch.clamp(smooth, 0.0, 1.0)
            inv = torch.where(
                wavelen > orig / low_f,
                inv / factor,
                torch.where(wavelen < orig / high_f, inv,
                            (1 - smooth) * inv / factor + smooth * inv),
            )
        else:
            raise ValueError(f"unknown rope scaling type {kind!r}")
    freqs = torch.outer(t, inv)
    return ((torch.cos(freqs) * attn_scale).to(dtype),
            (torch.sin(freqs) * attn_scale).to(dtype))


def apply_rope(x, cos, sin, *, positions=None):
    """Rotate q/k ([B, H, T, D]) by position-dependent angles.

    cos/sin: [max_len, D/2]; positions: optional [T] or [B, T] overrides.
    """
    t = x.shape[2]
    if positions is None:
        c = cos[:t][None, None]
        s = sin[:t][None, None]
    else:
        c, s = cos[positions], sin[positions]
        if positions.dim() == 1:
            c, s = c[None, None], s[None, None]
        else:  # [B, T]
            c, s = c[:, None], s[:, None]
    acc = torch.promote_types(x.dtype, torch.float32)
    c, s = c.to(acc), s.to(acc)
    x1, x2 = x.to(acc).chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


class SwiGLU(nn.Module):
    """Gated MLP: w2(silu(w1 x) * w3 x)."""

    def __init__(self, w1: Linear, w3: Linear, w2: Linear):
        super().__init__()
        self.w1, self.w3, self.w2 = w1, w3, w2

    @staticmethod
    def init(dim: int, hidden: int, *, generator, dtype=torch.float32,
             device="cuda") -> "SwiGLU":
        kw = dict(generator=generator, bias=False, dtype=dtype, device=device)
        return SwiGLU(w1=Linear.init(dim, hidden, **kw),
                      w3=Linear.init(dim, hidden, **kw),
                      w2=Linear.init(hidden, dim, **kw))

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class LlamaBlock(nn.Module):
    """Pre-RMSNorm decoder block: RoPE attention (GQA) + SwiGLU, or a
    :class:`~lamp_tpu_torch.nn.SwiGLUMoE` with ``moe_experts``. The
    projections may carry biases (a Qwen2 import's q/k/v)."""

    def __init__(self, norm1: RMSNorm, norm2: RMSNorm, w_q: Linear,
                 w_k: Linear, w_v: Linear, w_o: Linear, mlp: nn.Module, *,
                 num_heads: int, num_kv_heads: int,
                 window: Optional[int] = None):
        super().__init__()
        self.norm1, self.norm2 = norm1, norm2
        self.w_q, self.w_k, self.w_v, self.w_o = w_q, w_k, w_v, w_o
        self.mlp = mlp
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.window = window

    @staticmethod
    def init(dim: int, num_heads: int, *, generator,
             num_kv_heads: Optional[int] = None,
             mlp_hidden: Optional[int] = None, window: Optional[int] = None,
             norm_eps: float = 1e-6, moe_experts: Optional[int] = None,
             moe_top_k: int = 2, moe_dispatch: str = "dense",
             moe_capacity_factor: float = 1.25, moe_group_size: int = 0,
             dtype=torch.float32, device="cuda") -> "LlamaBlock":
        kv_heads = num_kv_heads or num_heads
        mlp_hidden = mlp_hidden or int(dim * 8 / 3 // 64 * 64) or dim * 2
        head_dim = dim // num_heads
        kw = dict(generator=generator, bias=False, dtype=dtype, device=device)
        return LlamaBlock(
            norm1=RMSNorm.init(dim, eps=norm_eps, dtype=dtype, device=device),
            norm2=RMSNorm.init(dim, eps=norm_eps, dtype=dtype, device=device),
            w_q=Linear.init(dim, dim, **kw),
            w_k=Linear.init(dim, kv_heads * head_dim, **kw),
            w_v=Linear.init(dim, kv_heads * head_dim, **kw),
            w_o=Linear.init(dim, dim, **kw),
            mlp=(SwiGLU.init(dim, mlp_hidden, generator=generator,
                             dtype=dtype, device=device)
                 if moe_experts is None else SwiGLUMoE.init(
                     dim, mlp_hidden, moe_experts, generator=generator,
                     top_k=moe_top_k, dispatch=moe_dispatch,
                     capacity_factor=moe_capacity_factor,
                     group_size=moe_group_size, dtype=dtype, device=device)),
            num_heads=num_heads, num_kv_heads=kv_heads, window=window,
        )

    def forward(self, x, cos, sin, *, positions=None, segment_ids=None,
                with_aux: bool = False):
        """x [B, T, D] -> [B, T, D]. ``positions`` ([T] or [B, T]) override
        the RoPE positions; ``segment_ids`` ([B, T]) keep attention within
        each packed document. ``with_aux``: also return the MLP's
        load-balancing loss (0 for a dense block), as ``(x, aux)``."""
        b, t, d = x.shape
        h, hk = self.num_heads, self.num_kv_heads
        hd = d // h
        a = self.norm1(x)
        q = self.w_q(a).reshape(b, t, h, hd).transpose(1, 2)
        k = self.w_k(a).reshape(b, t, hk, hd).transpose(1, 2)
        v = self.w_v(a).reshape(b, t, hk, hd).transpose(1, 2)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        if hk != h:
            k = k.repeat_interleave(h // hk, dim=1)
            v = v.repeat_interleave(h // hk, dim=1)
        if q.is_cuda:
            o = flash_attention(q, k, v.contiguous(), causal=True,
                                window=self.window, segment_ids=segment_ids)
        else:
            o = mha_reference(q, k, v, causal=True, window=self.window,
                              segment_ids=segment_ids)
        x = x + self.w_o(o.transpose(1, 2).reshape(b, t, d))
        a2 = self.norm2(x)
        x = x + self.mlp(a2)
        if not with_aux:
            return x
        aux = (self.mlp.load_balancing_loss(a2)
               if hasattr(self.mlp, "load_balancing_loss")
               else torch.zeros((), dtype=torch.float32, device=x.device))
        return x, aux


class ModernLM(nn.Module):
    """Llama-style LM: token embedding -> N LlamaBlocks -> RMSNorm -> tied
    (or untied) logits. RoPE positions, GQA, SwiGLU. The RoPE tables are
    f32 buffers whatever the weights' dtype, as in the JAX model."""

    def __init__(self, token_embedding: Embedding, blocks, final_norm: RMSNorm,
                 lm_head: Optional[Linear], rope_cos: torch.Tensor,
                 rope_sin: torch.Tensor, *, context_length: int):
        super().__init__()
        self.token_embedding = token_embedding
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.register_buffer("rope_cos", rope_cos)
        self.register_buffer("rope_sin", rope_sin)
        self.context_length = context_length

    @staticmethod
    def init(*, vocab_size: int, context_length: int, num_blocks: int,
             embed_dim: int, num_heads: int,
             num_kv_heads: Optional[int] = None,
             mlp_hidden: Optional[int] = None, tied: bool = True, generator,
             rope_base: float = 10000.0, rope_scaling: Optional[dict] = None,
             window=None, norm_eps: float = 1e-6,
             moe_experts: Optional[int] = None, moe_top_k: int = 2,
             moe_dispatch: str = "dense", moe_capacity_factor: float = 1.25,
             moe_group_size: int = 0, dtype=torch.float32,
             device="cuda") -> "ModernLM":
        """Random weights drawn from ``generator``. ``window``: None (full
        attention), an int (sliding window in every block) or one entry per
        block. ``moe_experts`` makes every block's MLP a
        :class:`~lamp_tpu_torch.nn.SwiGLUMoE` of that many experts
        (``moe_top_k``, ``moe_dispatch``, ``moe_capacity_factor`` and
        ``moe_group_size`` as its ``init`` takes them)."""
        cos, sin = rope_frequencies(embed_dim // num_heads, context_length,
                                    base=rope_base, scaling=rope_scaling,
                                    device=device)
        if window is None or isinstance(window, int):
            windows = [window] * num_blocks
        else:
            windows = list(window)
            if len(windows) != num_blocks:
                raise ValueError("per-block window list length mismatch")
        emb = Embedding(initializers.normal(0.02)(
            generator, (vocab_size, embed_dim), dtype, device))
        blocks = [
            LlamaBlock.init(embed_dim, num_heads, generator=generator,
                            num_kv_heads=num_kv_heads, mlp_hidden=mlp_hidden,
                            window=windows[i], norm_eps=norm_eps,
                            moe_experts=moe_experts, moe_top_k=moe_top_k,
                            moe_dispatch=moe_dispatch,
                            moe_capacity_factor=moe_capacity_factor,
                            moe_group_size=moe_group_size, dtype=dtype,
                            device=device)
            for i in range(num_blocks)
        ]
        lm_head = None if tied else Linear.init(
            embed_dim, vocab_size, generator=generator, bias=False,
            dtype=dtype, device=device)
        return ModernLM(
            emb, blocks,
            RMSNorm.init(embed_dim, eps=norm_eps, dtype=dtype, device=device),
            lm_head, cos, sin, context_length=context_length,
        )

    def hidden(self, tokens, *, positions=None, segment_ids=None,
               with_aux: bool = False):
        """Final-norm hidden states [B, T, D] (no logits projection).
        ``with_aux``: also return the blocks' summed MoE load-balancing
        loss (0.0 for a dense model), as ``(h, aux)``."""
        x = self.token_embedding(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x = block(x, self.rope_cos, self.rope_sin, positions=positions,
                      segment_ids=segment_ids, with_aux=with_aux)
            if with_aux:
                x, a = x
                aux = aux + a
        h = self.final_norm(x)
        return (h, aux) if with_aux else h

    @property
    def output_weight(self):
        """[V, D] logits projection weight (tied embedding or lm_head)."""
        if self.lm_head is not None:
            return self.lm_head.weight
        return self.token_embedding.weight

    def loss(self, tokens, targets, *, ignore_index: int = -100,
             row_chunk: Optional[int] = None, segment_ids=None,
             positions=None, moe_aux_coef: float = 0.0):
        """Mean next-token cross-entropy over the non-ignored targets
        without holding the [B, T, V] logits: the final hidden states go
        through :func:`~lamp_tpu_torch.ops.fused_ce.fused_lm_loss`. At
        vocabulary 32000 and 8192 tokens the logits would be the step's
        largest tensor. ``segment_ids`` and ``positions`` ([B, T]) train on
        packed documents (``data.pack_documents``). ``moe_aux_coef`` adds
        that multiple of the MoE blocks' summed balancing loss (Switch
        style; ~1e-2)."""
        x, aux = self.hidden(tokens, positions=positions,
                             segment_ids=segment_ids, with_aux=True)
        loss = fused_lm_loss(x, self.output_weight, targets,
                             ignore_index=ignore_index, row_chunk=row_chunk)
        if moe_aux_coef:
            loss = loss + moe_aux_coef * aux
        return loss

    def forward(self, tokens, *, positions=None, segment_ids=None):
        """Logits [B, T, V] in at least f32."""
        x = self.hidden(tokens, positions=positions, segment_ids=segment_ids)
        acc = torch.promote_types(x.dtype, torch.float32)
        if self.lm_head is not None:
            # the head module itself (it may be quantized), as the JAX model
            return self.lm_head(x).to(acc)
        return F.linear(x.to(acc), self.token_embedding.weight.to(acc))
