"""Global-norm gradient clipping, in f32.

Counterpart of :mod:`lamp_tpu.optim.clip` (``global_norm``,
``clip_by_global_norm``) over lists of tensors.
"""

from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all entries of all tensors, in f32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tensors, max_norm: float):
    """Scale every tensor by ``min(1, max_norm / norm)``, computed in f32
    and rounded once to each tensor's dtype. Returns ``(clipped, norm)``."""
    tensors = list(tensors)
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return torch._foreach_mul(tensors, scale), norm
