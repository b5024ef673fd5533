"""Loss functions: NLL, cross entropy and sequence NLL.

Counterpart of the same names in :mod:`lamp_tpu.nn.losses`. Each computes
in at least f32, skips targets equal to ``ignore_index``, and with
``reduction="mean"`` divides by the number of targets kept (at least 1).
"""

from __future__ import annotations

import torch

__all__ = ["nll_loss", "cross_entropy_loss", "sequence_nll"]


def _reduce(x, reduction: str):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def _pick(log_probs, target, ignore_index):
    target = target.long()
    valid = target != ignore_index
    safe = torch.where(valid, target, 0)
    picked = log_probs.gather(-1, safe[..., None])[..., 0]
    return picked, valid


def nll_loss(log_probs, target, *, reduction: str = "mean",
             ignore_index: int = -100):
    """Negative log likelihood over log-probabilities (last axis =
    classes)."""
    picked, valid = _pick(log_probs, target, ignore_index)
    losses = torch.where(valid, -picked, 0.0)
    if reduction == "mean":
        return losses.sum() / valid.sum().clamp(min=1)
    return _reduce(losses, reduction)


def cross_entropy_loss(logits, target, *, reduction: str = "mean",
                       ignore_index: int = -100,
                       label_smoothing: float = 0.0):
    """Softmax cross entropy from raw logits, in at least f32."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    log_probs = torch.log_softmax(logits, dim=-1)
    if label_smoothing > 0.0:
        picked, valid = _pick(log_probs, target, ignore_index)
        smooth = log_probs.mean(dim=-1)
        losses = -(1.0 - label_smoothing) * picked - label_smoothing * smooth
        losses = torch.where(valid, losses, 0.0)
        if reduction == "mean":
            return losses.sum() / valid.sum().clamp(min=1)
        return _reduce(losses, reduction)
    return nll_loss(log_probs, target, reduction=reduction,
                    ignore_index=ignore_index)


def sequence_nll(logits, target, *, reduction: str = "mean",
                 ignore_index: int = -100):
    """NLL over (batch, time, classes) logits, time flattened into batch."""
    b, t, c = logits.shape
    return cross_entropy_loss(logits.reshape(b * t, c), target.reshape(b * t),
                              reduction=reduction, ignore_index=ignore_index)
