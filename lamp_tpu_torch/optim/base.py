"""Per-tag hyperparameters.

Counterpart of :mod:`lamp_tpu.optim.base`. Any scalar hyperparameter may be
a float, a ``dict[tag, value]`` (``"default"`` for tags it does not name,
else 0), or a callable ``tag -> value``; tags come from
:func:`lamp_tpu_torch.nn.param_tags`.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

__all__ = ["Hyper", "resolve_hyper"]

Hyper = Union[float, dict, Callable[[str], float]]


def resolve_hyper(hyper: Hyper, tags: Dict[str, str]) -> Dict[str, float]:
    """``{parameter name: value}`` for ``tags``, a ``{name: tag}`` dict."""
    if callable(hyper):
        fn = hyper
    elif isinstance(hyper, dict):
        default = hyper.get("default", 0.0)
        fn = lambda tag: hyper.get(tag, default)  # noqa: E731
    else:
        value = float(hyper)
        return {name: value for name in tags}
    return {name: float(fn(tag)) for name, tag in tags.items()}
