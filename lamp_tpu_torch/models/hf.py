"""HuggingFace Llama-family checkpoint interop for :class:`ModernLM`.

Counterpart of :mod:`lamp_tpu.models.hf`: a directory holding
``config.json`` plus one or more ``*.safetensors`` shards, as
``transformers``' ``save_pretrained`` writes them, loads into a
:class:`~lamp_tpu_torch.nn.ModernLM` (Llama, Mistral with its
``sliding_window``, Qwen2 with its attention biases, Mixtral into
``SwiGLUMoE`` blocks; the ``rope_scaling`` kinds linear, dynamic, yarn and
llama3), and a ModernLM exports to such a directory. Files are read and
written by :func:`~lamp_tpu_torch.io.read_safetensors` and
:func:`~lamp_tpu_torch.io.write_safetensors`.

The port's ``Linear`` stores [out, in], as HF does, so the projections
cross untransposed; a Mixtral gate and its experts are transposed into the
JAX package's stacked layout (``w_gate`` [D, E], ``w1``/``w3`` [E, D, H],
``w2`` [E, H, D]). The loader builds the modules from the file's tensors
directly, where the JAX loader draws a random model first and replaces its
weights (``ModernLM.init(key=PRNGKey(0))``): at 3 B parameters that draw
would cost the card seconds for weights that are thrown away. The module
tree is the same either way.

    model = modernlm_from_hf_llama("open_llama_3b/", device="cuda")
    modernlm_to_hf_llama(model, "export/")
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..io.checkpoint import read_safetensors, write_safetensors
from ..nn.layers import Embedding, Linear
from ..nn.modern import (LlamaBlock, ModernLM, RMSNorm, SwiGLU,
                         rope_frequencies)
from ..nn.moe import SwiGLUMoE

__all__ = ["modernlm_from_hf_llama", "modernlm_to_hf_llama",
           "modernlm_from_hf_state"]


_SUPPORTED_ARCHS = {"LlamaForCausalLM", "MistralForCausalLM",
                    "Qwen2ForCausalLM", "MixtralForCausalLM"}


def _load_dir(path: str):
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    state: Dict[str, Any] = {}
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    for shard in shards:
        state.update(read_safetensors(shard))
    return config, state


def modernlm_from_hf_llama(path: str, *, dtype=None,
                           context_length: Optional[int] = None,
                           device="cuda") -> ModernLM:
    """Load a HF Llama/Mistral/Qwen2/Mixtral checkpoint directory into a
    ModernLM on ``device``.

    ``dtype`` (default: the checkpoint's own dtype) casts every parameter;
    ``context_length`` overrides ``max_position_embeddings`` (it only sizes
    the RoPE tables).
    """
    config, state = _load_dir(path)
    archs = config.get("architectures") or []
    if archs and not any(a in _SUPPORTED_ARCHS for a in archs):
        raise ValueError(f"unsupported architectures {archs}; expected one "
                         f"of {sorted(_SUPPORTED_ARCHS)}")
    return modernlm_from_hf_state(state, config, dtype=dtype,
                                  context_length=context_length,
                                  device=device)


def _rope_scaling_of(rs: Optional[Dict[str, Any]],
                     ctx: int) -> Optional[Dict[str, Any]]:
    """Translate HF ``config.rope_scaling`` to
    :func:`~lamp_tpu_torch.nn.rope_frequencies`'s schema."""
    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind in (None, "default"):
        return None
    factor = float(rs.get("factor", 1.0))
    orig = int(rs.get("original_max_position_embeddings", ctx))
    if kind == "linear":
        return {"type": "linear", "factor": factor}
    if kind == "dynamic":
        # dynamic NTK at full window == static NTK stretch (the decode-time
        # per-length rescale collapses once the table is precomputed)
        return {"type": "ntk", "factor": factor}
    if kind == "yarn":
        return {"type": "yarn", "factor": factor, "original_max_len": orig,
                "beta_fast": float(rs.get("beta_fast", 32.0)),
                "beta_slow": float(rs.get("beta_slow", 1.0))}
    if kind == "llama3":
        return {"type": "llama3", "factor": factor,
                "original_max_len": orig,
                "low_freq_factor": float(rs.get("low_freq_factor", 1.0)),
                "high_freq_factor": float(rs.get("high_freq_factor", 4.0))}
    raise NotImplementedError(f"rope_scaling type {kind!r}")


def _as_tensor(v) -> torch.Tensor:
    """A tensor of a state entry (an ml_dtypes bf16 array by its bits)."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(a)


def modernlm_from_hf_state(state: Dict[str, Any], config: Dict[str, Any], *,
                           dtype=None, context_length: Optional[int] = None,
                           device="cuda") -> ModernLM:
    """Build a ModernLM on ``device`` from a HF-named state dict (tensors
    or arrays) and a config dict."""
    dim = config["hidden_size"]
    heads = config["num_attention_heads"]
    kv_heads = config.get("num_key_value_heads") or heads
    n_layers = config["num_hidden_layers"]
    head_dim = config.get("head_dim") or dim // heads
    if head_dim != dim // heads:
        raise NotImplementedError(
            f"head_dim {head_dim} != hidden_size/num_heads {dim // heads}")
    tied = bool(config.get("tie_word_embeddings", False))
    moe_experts = config.get("num_local_experts")  # Mixtral
    moe_top_k = config.get("num_experts_per_tok", 2)
    ctx = context_length or config.get("max_position_embeddings", 2048)
    rope_scaling = _rope_scaling_of(config.get("rope_scaling"), ctx)
    window = config.get("sliding_window")  # Mistral/Qwen2; None for Llama
    if window is not None and config.get("use_sliding_window", True) is False:
        window = None
    eps = float(config.get("rms_norm_eps", 1e-6))
    state = {k: _as_tensor(v) for k, v in state.items()}
    if dtype is None:
        dtype = state["model.embed_tokens.weight"].dtype

    def get(name, transpose=False):
        t = state[name]
        t = t.T if transpose else t
        return t.to(device=device, dtype=dtype).contiguous()

    def linear(name):
        bias = (get(name + ".bias") if name + ".bias" in state
                else None)  # Qwen2-style attention biases
        return Linear(get(name + ".weight"), bias)

    def stacked(p, which):
        # Mixtral's per-expert [out, in] -> the stacked [E, in, out]
        return torch.stack([
            get(f"{p}.block_sparse_moe.experts.{e}.{which}.weight",
                transpose=True) for e in range(moe_experts)])

    def mlp(p):
        if moe_experts is None:
            return SwiGLU(linear(f"{p}.mlp.gate_proj"),
                          linear(f"{p}.mlp.up_proj"),
                          linear(f"{p}.mlp.down_proj"))
        return SwiGLUMoE(
            get(f"{p}.block_sparse_moe.gate.weight", transpose=True),
            stacked(p, "w1"), stacked(p, "w3"), stacked(p, "w2"),
            top_k=moe_top_k)

    blocks = []
    for i in range(n_layers):
        p = f"model.layers.{i}"
        blocks.append(LlamaBlock(
            RMSNorm(get(f"{p}.input_layernorm.weight"), eps),
            RMSNorm(get(f"{p}.post_attention_layernorm.weight"), eps),
            linear(f"{p}.self_attn.q_proj"), linear(f"{p}.self_attn.k_proj"),
            linear(f"{p}.self_attn.v_proj"), linear(f"{p}.self_attn.o_proj"),
            mlp(p), num_heads=heads, num_kv_heads=kv_heads, window=window))
    cos, sin = rope_frequencies(
        head_dim, ctx, base=float(config.get("rope_theta", 10000.0)),
        scaling=rope_scaling, device=device)
    return ModernLM(
        Embedding(get("model.embed_tokens.weight")), blocks,
        RMSNorm(get("model.norm.weight"), eps),
        None if tied else Linear(get("lm_head.weight")),
        cos, sin, context_length=ctx)


def _rope_base(model: ModernLM, hd: int,
               config_extra: Optional[Dict[str, Any]]) -> float:
    """The RoPE base recovered from the table: the angle at position 1,
    frequency index 1 is base^(-2/hd). It holds only for an unscaled
    table; a scaled one must come with ``config_extra["rope_theta"]``."""
    if hd <= 2 or model.rope_cos.shape[0] <= 1:
        return 10000.0
    sin1 = model.rope_sin[1, 1].detach().float().cpu()
    cos1 = model.rope_cos[1, 1].detach().float().cpu()
    angle = float(torch.atan2(sin1, cos1))
    base = (1.0 / angle) ** (hd / 2.0)
    inv = base ** -(np.arange(0, hd, 2) / hd)
    row1 = model.rope_cos[1].detach().double().cpu().numpy()
    if not np.allclose(row1, np.cos(inv), atol=1e-3):
        if not (config_extra and "rope_theta" in config_extra):
            raise NotImplementedError(
                "model uses scaled RoPE tables; pass config_extra with "
                "rope_theta and rope_scaling for HF export")
        base = config_extra["rope_theta"]
    return base


def modernlm_to_hf_llama(model: ModernLM, path: str, *,
                         config_extra: Optional[Dict[str, Any]] = None
                         ) -> None:
    """Export a ModernLM as a HF checkpoint directory (``config.json`` +
    ``model.safetensors``), loadable by ``transformers``'
    ``LlamaForCausalLM`` (``MistralForCausalLM`` with a window,
    ``MixtralForCausalLM`` with MoE blocks). ``rope_theta`` is recovered
    from the RoPE table; a rope-scaled model must pass
    ``config_extra={"rope_theta": ..., "rope_scaling": {...}}``."""
    os.makedirs(path, exist_ok=True)
    blk0 = model.blocks[0]
    dim = blk0.w_q.weight.shape[1]
    heads = blk0.num_heads
    moe = isinstance(blk0.mlp, SwiGLUMoE)
    windows = {b.window for b in model.blocks}
    if len(windows) > 1:
        raise NotImplementedError(
            "HF Llama export needs a uniform per-block window")
    (window,) = windows
    base = _rope_base(model, dim // heads, config_extra)
    if moe:
        arch, mtype = ["MixtralForCausalLM"], "mixtral"
    elif window is not None:
        arch, mtype = ["MistralForCausalLM"], "mistral"
    else:
        arch, mtype = ["LlamaForCausalLM"], "llama"
    config = {
        "architectures": arch,
        "model_type": mtype,
        "hidden_size": dim,
        "intermediate_size": (blk0.mlp.w1.shape[2] if moe
                              else blk0.mlp.w1.weight.shape[0]),
        "num_attention_heads": heads,
        "num_key_value_heads": blk0.num_kv_heads,
        "num_hidden_layers": len(model.blocks),
        "vocab_size": model.token_embedding.weight.shape[0],
        "max_position_embeddings": model.context_length,
        "rope_theta": round(base, 4),
        "rms_norm_eps": model.final_norm.eps,
        "tie_word_embeddings": model.lm_head is None,
        "hidden_act": "silu",
        "torch_dtype": ("bfloat16" if model.token_embedding.weight.dtype
                        == torch.bfloat16 else "float32"),
    }
    if window is not None:
        config["sliding_window"] = window
    if moe:
        config["num_local_experts"] = int(blk0.mlp.num_experts)
        config["num_experts_per_tok"] = int(blk0.mlp.top_k)
    config.update(config_extra or {})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)

    tensors: Dict[str, Any] = {
        "model.embed_tokens.weight": model.token_embedding.weight,
        "model.norm.weight": model.final_norm.weight,
    }
    if model.lm_head is not None:
        tensors["lm_head.weight"] = model.lm_head.weight
    for i, blk in enumerate(model.blocks):
        p = f"model.layers.{i}"
        tensors[f"{p}.input_layernorm.weight"] = blk.norm1.weight
        tensors[f"{p}.post_attention_layernorm.weight"] = blk.norm2.weight
        proj = [("self_attn.q_proj", blk.w_q),
                ("self_attn.k_proj", blk.w_k),
                ("self_attn.v_proj", blk.w_v),
                ("self_attn.o_proj", blk.w_o)]
        if not moe:
            proj += [("mlp.gate_proj", blk.mlp.w1),
                     ("mlp.up_proj", blk.mlp.w3),
                     ("mlp.down_proj", blk.mlp.w2)]
        for hf_name, lin in proj:
            tensors[f"{p}.{hf_name}.weight"] = lin.weight
            if lin.bias is not None:
                tensors[f"{p}.{hf_name}.bias"] = lin.bias
        if moe:
            bs = f"{p}.block_sparse_moe"
            tensors[f"{bs}.gate.weight"] = blk.mlp.w_gate.T
            for e in range(int(blk.mlp.num_experts)):
                tensors[f"{bs}.experts.{e}.w1.weight"] = blk.mlp.w1[e].T
                tensors[f"{bs}.experts.{e}.w3.weight"] = blk.mlp.w3[e].T
                tensors[f"{bs}.experts.{e}.w2.weight"] = blk.mlp.w2[e].T
    write_safetensors(os.path.join(path, "model.safetensors"), tensors,
                      metadata={"format": "pt"})
