"""Parameter tags.

Counterpart of :func:`lamp_tpu.nn.module.param_tags`: every parameter gets
a string tag, ``"ClassName.attr"`` of the module that owns it, unless that
class names another in its ``__tags__``. Optimizers read the tags to pick
per-tag hyperparameters (weight decay off for biases, norms, embeddings).
Buffers are not parameters and get no tag, as in ``partition_params``.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

__all__ = ["param_tags"]


def param_tags(module: nn.Module) -> Dict[str, str]:
    """``{parameter name: tag}`` in ``named_parameters`` order."""
    tags = {}
    for prefix, owner in module.named_modules():
        override = getattr(type(owner), "__tags__", {})
        for attr, _ in owner.named_parameters(recurse=False):
            name = f"{prefix}.{attr}" if prefix else attr
            tags[name] = override.get(attr, f"{type(owner).__name__}.{attr}")
    return {name: tags[name] for name, _ in module.named_parameters()}
