"""Carry a JAX ``lamp_tpu`` model's weights, and AdamW's state, into the
port.

The parameters arrive as a flat dict of numpy arrays keyed by pytree path
(``blocks.3.w_q.weight``, ``encoder.blocks.3.attention.w_q.weight``,
``token_embedding.weight``, ``rope_cos``, ...), so this module needs neither
JAX nor ``lamp_tpu``. ``Linear`` weights are transposed from lamp_tpu's
[in, out] to PyTorch's [out, in]. Every loader raises ``KeyError`` on a
missing or an unexpected key.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .nn.layers import Embedding, LayerNorm, Linear
from .nn.lm import LanguageModelModule
from .nn.modern import LlamaBlock, ModernLM, RMSNorm, SwiGLU
from .nn.transformer import (MultiheadAttention, TransformerEncoder,
                             TransformerEncoderBlock)
from .ops.quantization import QuantizedLinear, QuantizedLinearInt4

__all__ = ["load_modern_lm", "load_language_model", "load_adamw_state",
           "load_quantized_linear"]

_BLOCK_KEYS = ("norm1.weight", "norm2.weight", "w_q.weight", "w_k.weight",
               "w_v.weight", "w_o.weight", "mlp.w1.weight", "mlp.w3.weight",
               "mlp.w2.weight")


def _check_keys(what, params, expected):
    missing = sorted(expected - set(params))
    unexpected = sorted(set(params) - expected)
    if missing or unexpected:
        raise KeyError(f"{what}: missing {missing}, unexpected {unexpected}")


def _tensor(a, dtype, device):
    a = np.asarray(a)
    # ml_dtypes (bf16, fp8) arrays go through f32, which holds them exactly
    host = a if a.dtype in (np.float32, np.float64) else a.astype(np.float32)
    return torch.tensor(host, device=device).to(dtype)


def load_modern_lm(params: Dict[str, np.ndarray], *, device="cuda",
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
    _check_keys("ModernLM parameters", params, expected)

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


def load_language_model(params: Dict[str, np.ndarray], *, num_heads: int,
                        device="cuda", dtype=torch.float32,
                        dropout: float = 0.0,
                        linearized: bool = False) -> LanguageModelModule:
    """Build a :class:`~lamp_tpu_torch.nn.LanguageModelModule` from the
    parameters of a ``lamp_tpu.nn.LanguageModelModule``
    (``encoder.blocks.3.attention.w_q.weight``, ``encoder.blocks.3.scale1``,
    ``position_embedding.weight``, ``final_norm.bias``, ...). Shapes give
    the vocabulary, context, width, depth, kv heads, MLP width and whether
    the linears have biases; ``num_heads``, ``dropout`` and ``linearized``
    are not parameters and are passed as in ``LanguageModelModule.init``.
    Weights are cast to ``dtype``."""
    blocks = sorted({int(m.group(1)) for k in params
                     if (m := re.match(r"encoder\.blocks\.(\d+)\.", k))})
    n_blocks = (blocks[-1] + 1) if blocks else 0
    bias = "encoder.blocks.0.attention.w_q.bias" in params
    linears = [f"attention.{w}" for w in ("w_q", "w_k", "w_v", "w_o")]
    linears += ["w1", "w2"]
    block_keys = [f"{lin}.{part}" for lin in linears
                  for part in (("weight", "bias") if bias else ("weight",))]
    block_keys += [f"norm{i}.{part}" for i in (1, 2)
                   for part in ("weight", "bias")]
    block_keys += ["scale1", "scale2"]
    expected = {"token_embedding.weight", "position_embedding.weight",
                "final_norm.weight", "final_norm.bias"}
    expected |= {f"encoder.blocks.{i}.{k}" for i in range(n_blocks)
                 for k in block_keys}
    _check_keys("LanguageModelModule parameters", params, expected)

    def w(key):
        return _tensor(params[key], dtype, device)

    def lin(key):
        return Linear(_tensor(np.asarray(params[key + ".weight"]).T, dtype,
                              device),
                      w(key + ".bias") if bias else None)

    def norm(key):
        return LayerNorm(w(key + ".weight"), w(key + ".bias"))

    def block(i):
        p = f"encoder.blocks.{i}."
        head_dim = params[p + "attention.w_q.weight"].shape[1] // num_heads
        kv_heads = params[p + "attention.w_k.weight"].shape[1] // head_dim
        attention = MultiheadAttention(
            lin(p + "attention.w_q"), lin(p + "attention.w_k"),
            lin(p + "attention.w_v"), lin(p + "attention.w_o"),
            num_heads=num_heads, num_kv_heads=kv_heads, dropout=dropout,
            causal=True, linearized=linearized)
        return TransformerEncoderBlock(
            attention, norm(p + "norm1"), norm(p + "norm2"), lin(p + "w1"),
            lin(p + "w2"), w(p + "scale1"), w(p + "scale2"), dropout=dropout,
            gpt_order=True)

    return LanguageModelModule(
        Embedding(w("token_embedding.weight")),
        Embedding(w("position_embedding.weight")),
        TransformerEncoder([block(i) for i in range(n_blocks)]),
        norm("final_norm"),
        context_length=params["position_embedding.weight"].shape[0])


def load_quantized_linear(params: Dict[str, np.ndarray], *, device="cuda",
                          dtype=torch.float32):
    """Build a :class:`~lamp_tpu_torch.ops.QuantizedLinear` (from ``w_q``,
    ``w_scale`` and an optional ``bias``) or a
    :class:`~lamp_tpu_torch.ops.QuantizedLinearInt4` (from ``w_packed``,
    ``w_scales`` and an optional ``bias``) out of the leaves of a
    ``lamp_tpu`` quantized layer. The packed values and the scales keep
    their bytes and their JAX layout [in, out] (no transpose); the bias is
    cast to ``dtype``. Raises ``KeyError`` on a missing or an unexpected
    key."""
    bias = ({"bias"} if "bias" in params else set())
    if "w_packed" in params:
        _check_keys("QuantizedLinearInt4 parameters", params,
                    {"w_packed", "w_scales"} | bias)
        cls, names = QuantizedLinearInt4, ("w_packed", "w_scales")
    else:
        _check_keys("QuantizedLinear parameters", params,
                    {"w_q", "w_scale"} | bias)
        cls, names = QuantizedLinear, ("w_q", "w_scale")
    values, scales = (torch.from_numpy(np.array(params[n])).to(device)
                      for n in names)
    return cls(values, scales.float(),
               _tensor(params["bias"], dtype, device) if bias else None)


def load_adamw_state(opt_state: Dict, optimizer, model) -> None:
    """Copy a ``lamp_tpu`` AdamW-family optimizer state into the port's
    optimizer over ``model``'s parameters, so that both packages go on from
    the same step. ``opt_state`` is keyed as ``optimizer.param_names``:

    - ``lamp_tpu.optim.AdamW`` into :class:`~lamp_tpu_torch.optim.AdamW`:
      ``{"step": int, "mt": {name: array}, "vt": {name: array}, "master":
      {name: array} | None}``; ``master`` holds exactly the parameters that
      have one (the bf16/f16 ones; none under ``mixed_precision=False``,
      where JAX stores ``None``);
    - ``lamp_tpu.ops.fused_adamw.AdamWStochastic`` into
      :class:`~lamp_tpu_torch.ops.AdamWStochastic`: ``{"step", "mt",
      "vt"}``.

    The moments and masters of ``Linear`` weights are transposed as the
    weights are."""
    linear = {f"{prefix}.weight" for prefix, m in model.named_modules()
              if isinstance(m, Linear)}
    names = optimizer.param_names
    params = dict(zip(names, optimizer.params))
    with_master = {n for n in names
                   if optimizer.state[params[n]].get("master") is not None}
    parts = {"mt": opt_state["mt"], "vt": opt_state["vt"],
             "master": opt_state.get("master") or {}}
    for part, expected in (("mt", set(names)), ("vt", set(names)),
                           ("master", with_master)):
        _check_keys(f"optimizer state {part!r}", parts[part], expected)
    for name, p in params.items():
        state = optimizer.state[p]
        for part in ("mt", "vt", "master"):
            if state.get(part) is not None:
                a = np.asarray(parts[part][name])
                state[part].copy_(_tensor(a.T if name in linear else a,
                                          torch.float32, p.device))
    optimizer.param_groups[0]["step"] = int(opt_state["step"])
