"""Carry a JAX ``lamp_tpu`` model's weights, and AdamW's state, into the
port, and back.

The parameters arrive as a flat dict of numpy arrays keyed by pytree path
(``blocks.3.w_q.weight``, ``encoder.blocks.3.attention.w_q.weight``,
``token_embedding.weight``, ``rope_cos``, ...), so this module needs neither
JAX nor ``lamp_tpu``. ``Linear`` weights are transposed from lamp_tpu's
[in, out] to PyTorch's [out, in]. Every loader raises ``KeyError`` on a
missing or an unexpected key.

The other direction: :func:`jax_entries` gives a port model's leaves in
JAX's layout and in ``jax.tree_util``'s flatten order (the order a
``lamp_tpu`` checkpoint file holds them in), :func:`optimizer_entries` its
optimizer's state as the JAX optimizer keeps it, and :func:`jax_tree` a
model, an optimizer or a ``TrainState`` as the whole JAX pytree it stands
for, which :mod:`lamp_tpu_torch.io.checkpoint` writes; :func:`load_jax_tree`
writes such a tree, as read back, into the port object in place.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .nn.layers import Embedding, LayerNorm, Linear
from .nn.lm import LanguageModelModule
from .nn.lora import LoRALinear
from .nn.modern import LlamaBlock, ModernLM, RMSNorm, SwiGLU
from .nn.moe import MoEMLP, SwiGLUMoE
from .nn.transformer import (MultiheadAttention, TransformerEncoder,
                             TransformerEncoderBlock)
from .ops.quantization import QuantizedLinear, QuantizedLinearInt4
from .train.loops import TrainState

__all__ = ["load_modern_lm", "load_language_model", "load_adamw_state",
           "load_quantized_linear", "jax_entries", "optimizer_entries",
           "jax_tree", "load_jax_tree"]

_BLOCK_KEYS = ("norm1.weight", "norm2.weight", "w_q.weight", "w_k.weight",
               "w_v.weight", "w_o.weight")
_MLP_KEYS = ("mlp.w1.weight", "mlp.w3.weight", "mlp.w2.weight")
# a SwiGLUMoE's stacked experts, in the JAX layout (not transposed)
_MOE_KEYS = ("mlp.w_gate", "mlp.w1", "mlp.w3", "mlp.w2")
_ATTENTION = ("w_q", "w_k", "w_v", "w_o")


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
                   norm_eps: float = 1e-6,
                   lora_scale: float = 1.0, moe_top_k: int = 2,
                   moe_dispatch: str = "dense",
                   moe_capacity_factor: float = 1.25,
                   moe_group_size: int = 0) -> ModernLM:
    """Build a :class:`~lamp_tpu_torch.nn.ModernLM` from the parameters of a
    ``lamp_tpu.nn.ModernLM``. Shapes give the vocabulary, width, depth,
    heads (head_dim from the RoPE table), kv heads, MLP width, context and
    whether the embedding is tied; ``window`` (an int, or one entry per
    block) and ``norm_eps`` are not parameters and are passed as in
    ``ModernLM.init``. Weights are cast to ``dtype``; the RoPE tables stay
    f32.

    A ``lora_inject``-ed model's adapted linears carry ``<path>.lora_a``
    [in, r] and ``<path>.lora_b`` [r, out] beside ``<path>.weight``; each
    becomes a :class:`~lamp_tpu_torch.nn.LoRALinear` with the factors in
    that layout (untransposed). Its ``scale`` (alpha / rank, 1.0 unless
    ``alpha`` was given) is not a parameter: pass it as ``lora_scale``.

    A MoE model's blocks carry ``mlp.w_gate`` [D, E] and the stacked
    ``mlp.w1``/``mlp.w3`` [E, D, H] and ``mlp.w2`` [E, H, D], which become a
    :class:`~lamp_tpu_torch.nn.SwiGLUMoE` in that layout; its static fields
    are passed as ``moe_top_k``, ``moe_dispatch``, ``moe_capacity_factor``
    and ``moe_group_size``. An attention projection's ``bias`` (a Qwen2
    import's q/k/v) is taken where the JAX tree has one. Raises
    ``KeyError`` on a missing or an unexpected key."""
    blocks = sorted({int(m.group(1)) for k in params
                     if (m := re.match(r"blocks\.(\d+)\.", k))})
    n_blocks = (blocks[-1] + 1) if blocks else 0
    expected = {"token_embedding.weight", "final_norm.weight", "rope_cos",
                "rope_sin"}
    if "lm_head.weight" in params:
        expected.add("lm_head.weight")
    moe = "blocks.0.mlp.w_gate" in params
    expected |= {f"blocks.{i}.{k}" for i in range(n_blocks)
                 for k in _BLOCK_KEYS + (_MOE_KEYS if moe else _MLP_KEYS)}
    expected |= {k for k in params if re.fullmatch(
        r"blocks\.\d+\.(w_q|w_k|w_v|w_o)\.bias", k)}
    # the linears that carry an adapter: both factors are then expected
    linears = {k[:-len(".weight")] for k in expected
               if k.endswith(".weight") and "norm" not in k
               and k != "token_embedding.weight"}
    adapted = {k.rsplit(".", 1)[0] for k in params
               if k.endswith((".lora_a", ".lora_b"))} & linears
    expected |= {f"{p}.{f}" for p in adapted for f in ("lora_a", "lora_b")}
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
        path = key[:-len(".weight")]
        bias = (w(path + ".bias") if path + ".bias" in params else None)
        if path in adapted:
            return LoRALinear(w(key, transpose=True), bias,
                              w(path + ".lora_a"), w(path + ".lora_b"),
                              lora_scale)
        return Linear(w(key, transpose=True), bias)

    def mlp(p):
        if moe:
            return SwiGLUMoE(
                w(p + "mlp.w_gate"), w(p + "mlp.w1"), w(p + "mlp.w3"),
                w(p + "mlp.w2"), top_k=moe_top_k, dispatch=moe_dispatch,
                capacity_factor=moe_capacity_factor,
                group_size=moe_group_size)
        return SwiGLU(lin(p + "mlp.w1.weight"), lin(p + "mlp.w3.weight"),
                      lin(p + "mlp.w2.weight"))

    def block(i):
        p = f"blocks.{i}."
        return LlamaBlock(
            RMSNorm(w(p + "norm1.weight"), norm_eps),
            RMSNorm(w(p + "norm2.weight"), norm_eps),
            *(lin(f"{p}{a}.weight") for a in _ATTENTION), mlp(p),
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


# The JAX modules' array fields, in their dataclass order: a JAX module
# flattens into its fields in this order (lists of blocks in index order),
# which is the order of the leaves in a lamp_tpu checkpoint.
_JAX_FIELDS = {
    LanguageModelModule: ("token_embedding", "position_embedding", "encoder",
                          "final_norm"),
    TransformerEncoder: ("blocks",),
    TransformerEncoderBlock: ("attention", "norm1", "norm2", "w1", "w2",
                              "scale1", "scale2"),
    MultiheadAttention: ("w_q", "w_k", "w_v", "w_o"),
    ModernLM: ("token_embedding", "blocks", "final_norm", "lm_head",
               "rope_cos", "rope_sin"),
    LlamaBlock: ("norm1", "norm2", "w_q", "w_k", "w_v", "w_o", "mlp"),
    SwiGLU: ("w1", "w3", "w2"),
    # top_k, dispatch, capacity_factor, group_size (and MoEMLP's activation)
    # are static fields, which JAX's flatten leaves out
    SwiGLUMoE: ("w_gate", "w1", "w3", "w2"),
    MoEMLP: ("w_gate", "w1", "b1", "w2", "b2"),
    Linear: ("weight", "bias"),
    Embedding: ("weight",),
    LayerNorm: ("weight", "bias"),
    RMSNorm: ("weight",),
}


class JaxEntry(NamedTuple):
    """One leaf of a model in JAX's flatten order: its pytree ``path``, a
    detached ``view`` of the port's tensor in JAX's layout (a ``Linear``
    weight transposed, so writing into the view writes the weight) or None
    where JAX holds ``None``, the port's ``tensor`` itself, ``kind``:
    "param" (trainable, in the optimizer's state), "buffer" (``None`` in
    the optimizer's state, as ``partition_params`` puts it) or None, and
    whether the view is ``transposed``."""

    path: str
    view: Optional[torch.Tensor]
    tensor: Optional[torch.Tensor]
    kind: Optional[str]
    transposed: bool = False


def jax_entries(model) -> List[JaxEntry]:
    """The leaves of ``model`` as the JAX module of the same structure
    flattens them (a ``LanguageModelModule`` or a ``ModernLM``, tied or
    untied, and their parts). A module with no JAX layout (a quantized
    layer, a ``LoRALinear``) raises ``TypeError`` naming its class."""
    out: List[JaxEntry] = []

    def visit(prefix, module):
        fields = _JAX_FIELDS.get(type(module))
        if fields is None:
            raise TypeError(f"{type(module).__name__} has no JAX layout to "
                            f"write or read")
        for name in fields:
            value = getattr(module, name)
            path = prefix + name
            if isinstance(value, (nn.ModuleList, list, tuple)):
                for i, sub in enumerate(value):
                    visit(f"{path}.{i}.", sub)
            elif isinstance(value, nn.Module):
                visit(path + ".", value)
            elif value is None:
                out.append(JaxEntry(path, None, None, None))
            else:
                transposed = type(module) is Linear and name == "weight"
                view = value.detach()
                kind = ("param" if isinstance(value, nn.Parameter)
                        else "buffer")
                out.append(JaxEntry(path, view.t() if transposed else view,
                                    value, kind, transposed))

    visit("", model)
    return out


def _optimizer_kind(optimizer):
    from .ops.fused_adamw import AdamWStochastic
    from .optim.optimizers import AdamW

    if isinstance(optimizer, AdamW):
        return "adamw"
    if isinstance(optimizer, AdamWStochastic):
        return "stochastic"
    raise TypeError(f"{type(optimizer).__name__} has no JAX layout to write "
                    f"or read")


def optimizer_entries(optimizer, model,
                      entries: Optional[List[JaxEntry]] = None) -> Dict:
    """The state of ``optimizer`` (over ``model``'s parameters) as the JAX
    optimizer keeps it, with views for leaves: ``optim.AdamW`` as
    ``{"master", "mt", "step", "vt"}`` and ``ops.AdamWStochastic`` as
    ``{"mt", "step", "vt"}``. ``mt``, ``vt`` and ``master`` are lists in
    ``jax_entries(model)``'s order, None where the model's leaf is a buffer
    or None; ``master`` holds None for a parameter without a master, and
    is None itself under ``mixed_precision=False``; ``step`` is an int32
    0-d tensor. Moments and masters of ``Linear`` weights are transposed
    views, as the weights are."""
    kind = _optimizer_kind(optimizer)
    entries = jax_entries(model) if entries is None else entries
    params = [e.tensor for e in entries if e.kind == "param"]
    if {id(p) for p in params} != {id(p) for p in optimizer.params}:
        raise ValueError("the optimizer's parameters are not the model's")

    def part(key):
        out = []
        for e in entries:
            s = optimizer.state[e.tensor].get(key) if e.kind == "param" \
                else None
            if s is not None and e.transposed:
                s = s.t()
            out.append(None if s is None else s.detach())
        return out

    state = {"mt": part("mt"),
             "step": torch.tensor(optimizer.param_groups[0]["step"],
                                  dtype=torch.int32),
             "vt": part("vt")}
    if kind == "adamw":
        state["master"] = part("master") if optimizer.mixed_precision \
            else None
    return state


def jax_tree(obj, model=None):
    """The JAX pytree that a port object stands for, its leaves views of
    the object's own tensors:

    - a model (``LanguageModelModule``, ``ModernLM``): its leaves, a list in
      :func:`jax_entries`' order;
    - an optimizer over ``model``: :func:`optimizer_entries`;
    - a ``TrainState``: the JAX ``TrainState``, ``(params, rest,
      opt_state, step)``: ``params`` the model's leaves with ``None`` at
      each buffer, ``rest`` with ``None`` at each parameter (as
      ``partition_params`` splits them), an int32 ``step``.

    Anything else (``None``, a tree of tensors) is returned as it is."""
    if isinstance(obj, TrainState):
        entries = jax_entries(obj.model)
        return ([e.view if e.kind == "param" else None for e in entries],
                [e.view if e.kind == "buffer" else None for e in entries],
                optimizer_entries(obj.optimizer, obj.model, entries),
                torch.tensor(int(obj.step), dtype=torch.int32))
    if isinstance(obj, nn.Module):
        return [e.view for e in jax_entries(obj)]
    if isinstance(obj, torch.optim.Optimizer):
        if model is None:
            raise TypeError("an optimizer's JAX state follows its model's "
                            "tree: pass model=")
        return optimizer_entries(obj, model)
    return obj


@torch.no_grad()
def _put(view, value, what):
    """Write a leaf read back from a file into the port's tensor ``view``
    (None where the JAX tree holds None), checking its shape."""
    if view is None or value is None:
        if view is not None or value is not None:
            raise ValueError(f"{what}: the file holds "
                             f"{'None' if value is None else 'an array'} "
                             f"where the template holds "
                             f"{'None' if view is None else 'an array'}")
        return
    if tuple(value.shape) != tuple(view.shape):
        raise ValueError(f"{what}: the file's shape {tuple(value.shape)} is "
                         f"not the template's {tuple(view.shape)}")
    view.copy_(value)


def load_jax_tree(obj, tree, model=None):
    """Write ``tree``, the JAX pytree of ``obj`` as a checkpoint gives it
    back (:func:`jax_tree`'s structure, tensors, ``None`` and ints), into
    ``obj`` in place, checking each leaf's shape; returns ``obj``. For an
    ``obj`` that :func:`jax_tree` returns as it is, returns ``tree``."""
    if isinstance(obj, TrainState):
        params, rest, opt_state, step = tree
        entries = jax_entries(obj.model)
        for e, p, r in zip(entries, params, rest):
            _put(e.view if e.kind == "param" else None, p, e.path)
            _put(e.view if e.kind == "buffer" else None, r, e.path)
        load_jax_tree(obj.optimizer, opt_state, model=obj.model)
        obj.step = int(step)
        return obj
    if isinstance(obj, nn.Module):
        for e, value in zip(jax_entries(obj), tree):
            _put(e.view, value, e.path)
        return obj
    if isinstance(obj, torch.optim.Optimizer):
        state = jax_tree(obj, model)
        for key in sorted(state):
            if key == "step":
                obj.param_groups[0]["step"] = int(tree[key])
            elif state[key] is None or tree[key] is None:
                _put(state[key], tree[key], key)
            else:
                for view, value in zip(state[key], tree[key]):
                    _put(view, value, key)
        return obj
    return tree
