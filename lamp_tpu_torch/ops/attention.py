"""Plain PyTorch attention.

Counterpart of ``lamp_tpu.ops.attention.mha_reference``. The serving slice's
dense prefill uses it; the flash and compact kernels of the JAX package are
not on that path and are still to be ported (ROADMAP.md, K1-K3).
"""

from __future__ import annotations

import math

import torch

__all__ = ["mha_reference"]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mha_reference(q, k, v, *, causal=False, sm_scale=None, mask=None,
                  window=None, segment_ids=None):
    """Attention with the whole score matrix in memory.

    q: [B, H, Sq, D], k/v: [B, H, Skv, D]. ``mask`` is an optional boolean
    tensor broadcastable to [B, H, Sq, Skv]; True = attend. ``window`` (with
    ``causal=True``) restricts each query row to the last ``window`` keys.
    ``segment_ids`` ([B, S] int, or a ``(q_ids, kv_ids)`` pair) restricts
    attention to keys in the same segment. Scores accumulate in f32; a fully
    masked row gives the uniform mean of V, as in the JAX version.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if segment_ids is not None:
        q_ids, kv_ids = (segment_ids if isinstance(segment_ids, tuple)
                         else (segment_ids, segment_ids))
        seg = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        # align diagonals to the *end* of the kv sequence (standard
        # convention when Sq != Skv, e.g. decoding)
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = torch.where(keep, s, NEG_INF)
    elif window is not None:
        raise ValueError("window requires causal=True")
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc)).to(q.dtype)
