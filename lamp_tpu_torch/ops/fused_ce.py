"""Fused linear + softmax cross-entropy for LM heads, chunked over rows.

Counterpart of :mod:`lamp_tpu.ops.fused_ce`. A language-model loss computed
the plain way holds the logits ``[B*T, V]`` in f32: at 8192 tokens and a
32000 vocabulary that is 1 GB, and as much again for their gradient. Here
the projection ``x @ weight^T`` and the cross-entropy run over row chunks
in an ``autograd.Function`` (the JAX ``lax.scan`` under a ``custom_vjp``):

- forward: per chunk, the chunk's logits (f32 accumulation), reduced at
  once to each row's ``logsumexp`` and target logit; only ``[N]``-sized
  residuals are kept.
- backward: each chunk's logits are computed again (one more product, the
  flash-attention trade of operations for memory), ``p - onehot(t)`` is
  formed and contracted at once into ``dx = g @ W`` and a running f32
  ``dW += g^T @ x``.

The products are ``torch.mm`` (plain PyTorch: the JAX module is no Pallas
kernel). 16-bit inputs on the card multiply in their own type with an f32
result (``out_dtype``), as ``preferred_element_type=f32`` does in JAX;
other inputs multiply in their promoted f32 (or wider) type.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fused_linear_cross_entropy", "fused_lm_loss"]


def _acc_dtype(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.promote_types(dt, torch.float32)


def _pick_chunk(n: int, v: int) -> int:
    """JAX's choice: ~16M f32 logits a chunk (64 MB), a power of two in
    [128, 4096]."""
    target = max(1, (16 * 1024 * 1024) // max(v, 1))
    chunk = 1
    while chunk * 2 <= target:
        chunk *= 2
    return max(128, min(chunk, 4096))


def _mm(a, b, acc):
    """``a @ b`` accumulated in f32, the result in ``acc``."""
    if a.is_cuda and a.dtype == b.dtype and \
            a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32).to(acc)
    return torch.mm(a.to(acc), b.to(acc))


class _FusedCERows(torch.autograd.Function):
    """Per-row ``lse - logit[target]`` (0 for ignored rows), no logits
    tensor kept."""

    @staticmethod
    def forward(ctx, x, weight, targets, ignore_index, chunk):
        acc = _acc_dtype(x, weight)
        n = x.shape[0]
        lse = torch.empty(n, dtype=acc, device=x.device)
        tgt = torch.empty(n, dtype=acc, device=x.device)
        wt = weight.t()
        safe = targets.clamp(0, weight.shape[0] - 1)
        for r0 in range(0, n, chunk):
            r1 = min(n, r0 + chunk)
            logits = _mm(x[r0:r1], wt, acc)  # [chunk, V]
            lse[r0:r1] = torch.logsumexp(logits, dim=1)
            tgt[r0:r1] = logits.gather(1, safe[r0:r1, None])[:, 0]
        keep = targets != ignore_index
        ctx.save_for_backward(x, weight, targets, lse)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        return torch.where(keep, lse - tgt, 0.0)

    @staticmethod
    def backward(ctx, g):
        x, weight, targets, lse = ctx.saved_tensors
        acc = _acc_dtype(x, weight)
        # per-row upstream gradient; ignored rows contribute nothing
        rowscale = torch.where(targets != ctx.ignore_index, g.float(), 0.0)
        # the softmax gradient is contracted in the inputs' dtype (f32
        # accumulation), as XLA does for the unfused formulation
        mm_dt = torch.promote_types(x.dtype, weight.dtype)
        wt = weight.t()
        dx = torch.empty_like(x)
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        n, v = x.shape[0], weight.shape[0]
        for r0 in range(0, n, ctx.chunk):
            r1 = min(n, r0 + ctx.chunk)
            xc = x[r0:r1]
            logits = _mm(xc, wt, acc)
            p = torch.exp(logits.float() - lse[r0:r1, None].float())
            onehot = torch.arange(v, device=x.device)[None] == \
                targets[r0:r1, None]
            gmm = ((p - onehot.float()) * rowscale[r0:r1, None]).to(mm_dt)
            dx[r0:r1] = _mm(gmm, weight.to(mm_dt), acc).to(x.dtype)
            dw += _mm(gmm.t(), xc.to(mm_dt), torch.float32)
        return dx, dw.to(weight.dtype), None, None, None


def fused_linear_cross_entropy(x, weight, targets, *,
                               ignore_index: int = -100,
                               reduction: str = "mean",
                               row_chunk: Optional[int] = None):
    """Cross-entropy of ``x @ weight.T`` against ``targets`` without ever
    holding the ``[N, V]`` logits.

    x: ``[N, D]`` final hidden states; weight: ``[V, D]`` (the tied
    embedding or an untied head's weight); targets: ``[N]`` int class ids,
    rows equal to ``ignore_index`` excluded from the loss and from the
    mean's denominator. ``reduction``: ``"mean"`` (over non-ignored rows),
    ``"sum"`` or ``"none"``. ``row_chunk``: rows a chunk (by default ~64 MB
    of chunk logits, as in JAX), at most ``max(128, N)``.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    targets = targets.to(device=x.device, dtype=torch.long)
    chunk = row_chunk or _pick_chunk(x.shape[0], weight.shape[0])
    chunk = min(chunk, max(128, x.shape[0]))
    losses = _FusedCERows.apply(x, weight, targets, ignore_index, chunk)
    if reduction == "none":
        return losses
    total = losses.sum()
    if reduction == "sum":
        return total
    if reduction == "mean":
        cnt = (targets != ignore_index).to(losses.dtype).sum()
        return total / cnt.clamp_min(1.0)
    raise ValueError(f"unknown reduction {reduction!r}")


def fused_lm_loss(hidden, weight, targets, *, ignore_index: int = -100,
                  row_chunk: Optional[int] = None):
    """``hidden`` ``[B, T, D]``, ``targets`` ``[B, T]`` -> mean CE over the
    non-ignored tokens (the fused counterpart of ``nn.lm_loss``)."""
    b, t, d = hidden.shape
    return fused_linear_cross_entropy(
        hidden.reshape(b * t, d), weight, targets.reshape(b * t),
        ignore_index=ignore_index, row_chunk=row_chunk)
