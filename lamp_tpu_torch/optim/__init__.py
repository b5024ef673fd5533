"""Optimizers, gradient clipping, LR schedules.

Counterpart of :mod:`lamp_tpu.optim`. Ported so far: ``AdamW`` (f32
masters for bf16/f16 parameters, per-tag hyperparameters, global-norm
clip), ``clip_by_global_norm``/``global_norm`` and the
``cosine_with_warmup`` schedule. The other optimizers and schedules are not
ported yet.
"""

from . import schedules
from .base import Hyper, resolve_hyper
from .clip import clip_by_global_norm, global_norm
from .optimizers import AdamW

__all__ = ["AdamW", "Hyper", "resolve_hyper", "clip_by_global_norm",
           "global_norm", "schedules"]
