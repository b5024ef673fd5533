"""Carry a JAX ``lamp_tpu`` model's weights into the port.

The parameters arrive as a flat dict of numpy arrays keyed by pytree path
(``blocks.3.w_q.weight``, ``token_embedding.weight``, ``rope_cos``, ...),
so this module needs neither JAX nor ``lamp_tpu``. ``Linear`` weights are
transposed from lamp_tpu's [in, out] to PyTorch's [out, in].
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .nn.layers import Embedding, Linear
from .nn.modern import LlamaBlock, ModernLM, RMSNorm, SwiGLU

__all__ = ["load_modern_lm"]

_BLOCK_KEYS = ("norm1.weight", "norm2.weight", "w_q.weight", "w_k.weight",
               "w_v.weight", "w_o.weight", "mlp.w1.weight", "mlp.w3.weight",
               "mlp.w2.weight")


def _tensor(a, dtype, device):
    a = np.asarray(a)
    # ml_dtypes (bf16, fp8) arrays go through f32, which holds them exactly
    host = a if a.dtype in (np.float32, np.float64) else a.astype(np.float32)
    return torch.tensor(host, device=device).to(dtype)


def load_modern_lm(params: Dict[str, np.ndarray], *, device="cpu",
                   dtype=torch.float32, window=None,
                   norm_eps: float = 1e-6) -> ModernLM:
    """Build a :class:`~lamp_tpu_torch.nn.ModernLM` from the parameters of a
    ``lamp_tpu.nn.ModernLM``. Shapes give the vocabulary, width, depth,
    heads (head_dim from the RoPE table), kv heads, MLP width, context and
    whether the embedding is tied; ``window`` (an int, or one entry per
    block) and ``norm_eps`` are not parameters and are passed as in
    ``ModernLM.init``. Weights are cast to ``dtype``; the RoPE tables stay
    f32. Raises ``KeyError`` on a missing or an unexpected key."""
    blocks = sorted({int(m.group(1)) for k in params
                     if (m := re.match(r"blocks\.(\d+)\.", k))})
    n_blocks = (blocks[-1] + 1) if blocks else 0
    expected = {"token_embedding.weight", "final_norm.weight", "rope_cos",
                "rope_sin"}
    if "lm_head.weight" in params:
        expected.add("lm_head.weight")
    expected |= {f"blocks.{i}.{k}" for i in range(n_blocks)
                 for k in _BLOCK_KEYS}
    missing = sorted(expected - set(params))
    unexpected = sorted(set(params) - expected)
    if missing or unexpected:
        raise KeyError(f"ModernLM parameters: missing {missing}, "
                       f"unexpected {unexpected}")

    def w(key, transpose=False):
        a = np.asarray(params[key])
        return _tensor(a.T if transpose else a, dtype, device)

    emb = params["token_embedding.weight"]
    embed_dim = emb.shape[1]
    head_dim = 2 * params["rope_cos"].shape[1]
    num_heads = embed_dim // head_dim
    windows = (window if isinstance(window, (list, tuple))
               else [window] * n_blocks)
    if len(windows) != n_blocks:
        raise ValueError("per-block window list length mismatch")

    def lin(key):
        return Linear(w(key, transpose=True))

    def block(i):
        p = f"blocks.{i}."
        return LlamaBlock(
            RMSNorm(w(p + "norm1.weight"), norm_eps),
            RMSNorm(w(p + "norm2.weight"), norm_eps),
            lin(p + "w_q.weight"), lin(p + "w_k.weight"),
            lin(p + "w_v.weight"), lin(p + "w_o.weight"),
            SwiGLU(lin(p + "mlp.w1.weight"), lin(p + "mlp.w3.weight"),
                   lin(p + "mlp.w2.weight")),
            num_heads=num_heads,
            num_kv_heads=params[p + "w_k.weight"].shape[1] // head_dim,
            window=windows[i],
        )

    lm_head: Optional[Linear] = (
        lin("lm_head.weight") if "lm_head.weight" in params else None)
    return ModernLM(
        Embedding(w("token_embedding.weight")),
        [block(i) for i in range(n_blocks)],
        RMSNorm(w("final_norm.weight"), norm_eps),
        lm_head,
        _tensor(params["rope_cos"], torch.float32, device),
        _tensor(params["rope_sin"], torch.float32, device),
        context_length=params["rope_cos"].shape[0],
    )
