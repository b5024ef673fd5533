"""Learning-rate schedules: multiplicative factors for ``lr_factor``.

Counterpart of :mod:`lamp_tpu.optim.schedules` (framework-free code, copied
here so that the port imports nothing of the JAX package). A schedule is
``factor(state, step_or_epoch, last_validation_loss) -> (state, factor)``.
Ported so far: ``cosine_with_warmup``; the others wait.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

__all__ = ["Schedule", "cosine_with_warmup"]


@dataclasses.dataclass
class Schedule:
    init_state: Any
    factor: Callable[[Any, int, Optional[float]], Tuple[Any, float]]

    def __call__(self, state, epoch: int, last_validation_loss):
        return self.factor(state, epoch, last_validation_loss)


def cosine_with_warmup(warmup_steps: int, total_steps: int,
                       min_factor: float = 0.1) -> Schedule:
    """Linear warmup, then cosine decay to ``min_factor`` (per step)."""

    def f(s, step, v):
        if step < warmup_steps:
            return s, (step + 1) / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(progress, 1.0)
        return s, min_factor + (1 - min_factor) * 0.5 * (
            1 + math.cos(math.pi * progress))

    return Schedule(None, f)
