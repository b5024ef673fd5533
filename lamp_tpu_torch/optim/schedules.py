"""Learning-rate schedules: multiplicative factors for ``lr_factor``.

Counterpart of :mod:`lamp_tpu.optim.schedules` (framework-free code, copied
here so that the port imports nothing of the JAX package): noop,
decrement, linear, step_after, cyclic, cosine_with_warmup and the stateful
reduce_lr_on_plateau. A schedule is ``factor(state, step_or_epoch,
last_validation_loss) -> (state, factor)``; its state is ``None`` or a
plain dict, so that it goes into a checkpoint's JSON sidecar.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

__all__ = [
    "Schedule",
    "noop",
    "interpolate",
    "decrement",
    "linear",
    "step_after",
    "cyclic",
    "cosine_with_warmup",
    "reduce_lr_on_plateau",
]


@dataclasses.dataclass
class Schedule:
    init_state: Any
    factor: Callable[[Any, int, Optional[float]], Tuple[Any, float]]

    def __call__(self, state, epoch: int, last_validation_loss: Optional[float]):
        return self.factor(state, epoch, last_validation_loss)


def noop() -> Schedule:
    return Schedule(None, lambda s, e, v: (s, 1.0))


def interpolate(start_y: float, end_y: float, end_x: float, x: float) -> float:
    if x >= end_x:
        return end_y
    slope = (end_y - start_y) / end_x
    return start_y + slope * x


def decrement(every_n_epochs: int, decrement_fraction: float) -> Schedule:
    def f(s, epoch, v):
        return s, decrement_fraction ** (epoch // every_n_epochs)

    return Schedule(None, f)


def linear(start: float, end: float, n_steps: int) -> Schedule:
    def f(s, epoch, v):
        return s, interpolate(start, end, n_steps, epoch)

    return Schedule(None, f)


def step_after(steps: int, factor: float) -> Schedule:
    def f(s, epoch, v):
        return s, 1.0 if epoch < steps else factor

    return Schedule(None, f)


def cyclic(max_factor: float, period: int) -> Schedule:
    """Triangular cyclic schedule."""

    def f(s, epoch, v):
        t = epoch % period
        half = period / 2
        fac = 1.0 + (max_factor - 1.0) * (
            t / half if t <= half else (period - t) / half
        )
        return s, fac

    return Schedule(None, f)


def cosine_with_warmup(warmup_steps: int, total_steps: int,
                       min_factor: float = 0.1) -> Schedule:
    """Linear warmup, then cosine decay to ``min_factor`` (per step)."""

    def f(s, step, v):
        if step < warmup_steps:
            return s, (step + 1) / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(progress, 1.0)
        return s, min_factor + (1 - min_factor) * 0.5 * (
            1 + math.cos(math.pi * progress)
        )

    return Schedule(None, f)


def reduce_lr_on_plateau(
    factor: float = 0.5,
    patience: int = 10,
    threshold: float = 1e-4,
    relative: bool = True,
    cooldown: int = 0,
    min_factor: float = 0.0,
) -> Schedule:
    """Scale the factor by ``factor`` after ``patience`` epochs without an
    improvement of the validation loss (by ``threshold``, relative or
    absolute), then wait ``cooldown`` epochs; never below ``min_factor``.
    The state is a plain dict, so it round-trips through the checkpoint's
    JSON."""

    init = {
        "best": None,
        "bad_epochs": 0,
        "cooldown": 0,
        "factor": 1.0,
    }

    def f(state, epoch, val):
        state = dict(state)
        if val is None:
            return state, state["factor"]
        best = state["best"]
        improved = (
            best is None
            or (relative and val < best * (1 - threshold))
            or (not relative and val < best - threshold)
        )
        if improved:
            state["best"] = val
            state["bad_epochs"] = 0
        else:
            if state["cooldown"] > 0:
                state["cooldown"] -= 1
            else:
                state["bad_epochs"] += 1
                if state["bad_epochs"] > patience:
                    state["factor"] = max(state["factor"] * factor, min_factor)
                    state["bad_epochs"] = 0
                    state["cooldown"] = cooldown
        return state, state["factor"]

    return Schedule(init, f)
