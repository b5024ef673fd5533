"""lamp_tpu_torch.models.hf against lamp_tpu.models.hf and ``transformers``,
on tiny checkpoint directories that ``transformers`` writes: Llama untied
with GQA, Llama tied with one kv head and another RoPE base and eps,
Mistral with a sliding window, Qwen2 (attention biases), Mixtral (4
experts, top-2) and Llama under the ``rope_scaling`` kinds of
tests/test_hf.py.

Tolerances (f32): the port's logits against the JAX loader's within atol
1e-4 (the same weights; sums taken in another order), against
``transformers`` within atol 3e-4, rtol 1e-3 (5e-4 for Mixtral), as
tests/test_hf.py holds the JAX loader. An export of the same weights by
both packages: the same tensor names and shapes, the same bits, and the
same ``config.json`` key for key, but ``rope_theta``, which each package
recovers from its own f32 RoPE table (an atan2 of f32 values, raised to
the power head_dim / 2): within rtol 1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from lamp_tpu.models import hf as jhf  # noqa: E402
from lamp_tpu_torch import nn as tnn  # noqa: E402
from lamp_tpu_torch.io import read_safetensors  # noqa: E402
from lamp_tpu_torch.models import hf as thf  # noqa: E402
from lamp_tpu_torch.models import (modernlm_from_hf_llama,  # noqa: E402
                                   modernlm_to_hf_llama)

TOKS = np.array([[5, 1, 88, 12, 63, 9, 42, 2, 17, 30, 8, 77]], np.int32)
BASE = dict(vocab_size=97, hidden_size=64, intermediate_size=112,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-6,
            tie_word_embeddings=False)

# name: (transformers class, config class, config, logits atol vs HF)
CASES = {
    "llama_untied_gqa": ("LlamaForCausalLM", "LlamaConfig", {}, 3e-4),
    "llama_tied_kv1": ("LlamaForCausalLM", "LlamaConfig",
                       dict(tie_word_embeddings=True, num_key_value_heads=1,
                            rope_theta=50000.0, rms_norm_eps=1e-5), 3e-4),
    "mistral_window": ("MistralForCausalLM", "MistralConfig",
                       dict(sliding_window=4), 3e-4),
    "qwen2_biases": ("Qwen2ForCausalLM", "Qwen2Config",
                     dict(use_sliding_window=False), 3e-4),
    "mixtral": ("MixtralForCausalLM", "MixtralConfig",
                dict(num_local_experts=4, num_experts_per_tok=2,
                     sliding_window=None), 5e-4),
    "rope_linear": ("LlamaForCausalLM", "LlamaConfig",
                    dict(rope_scaling={"rope_type": "linear",
                                       "factor": 2.0}), 3e-4),
    "rope_yarn": ("LlamaForCausalLM", "LlamaConfig",
                  dict(rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                     "original_max_position_embeddings": 16}),
                  3e-4),
    "rope_llama3": ("LlamaForCausalLM", "LlamaConfig",
                    dict(rope_scaling={
                        "rope_type": "llama3", "factor": 8.0,
                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                        "original_max_position_embeddings": 16}), 3e-4),
}


def _write(case, path):
    cls, cfg_cls, over, _ = CASES[case]
    torch.manual_seed(sorted(CASES).index(case))
    cfg = getattr(transformers, cfg_cls)(**dict(BASE, **over))
    tm = getattr(transformers, cls)(cfg).eval()
    if case == "qwen2_biases":  # nonzero biases, so that they show
        with torch.no_grad():
            for layer in tm.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.normal_(0.0, 0.5)
    tm.save_pretrained(path, safe_serialization=True)
    return tm


def _port_logits(model):
    with torch.no_grad():
        return model(torch.from_numpy(TOKS).long()).numpy()


def _read_dir(path):
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    return config, read_safetensors(os.path.join(path, "model.safetensors"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_hf_directory_loads_and_exports_as_jax(case, tmp_path):
    src = str(tmp_path / "src")
    tm = _write(case, src)
    ours = modernlm_from_hf_llama(src, device="cpu")
    theirs = jhf.modernlm_from_hf_llama(src)
    got = _port_logits(ours)
    want, _ = theirs.forward(jnp.asarray(TOKS))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    with torch.no_grad():
        ref = tm(torch.from_numpy(TOKS).long()).logits.float().numpy()
    np.testing.assert_allclose(got, ref, atol=CASES[case][3], rtol=1e-3)
    if case == "mixtral":
        assert isinstance(ours.blocks[0].mlp, tnn.SwiGLUMoE)
        assert ours.blocks[0].mlp.top_k == 2
    if case == "mistral_window":
        assert all(b.window == 4 for b in ours.blocks)
    if case == "qwen2_biases":
        assert ours.blocks[0].w_q.bias is not None
        assert ours.blocks[0].w_o.bias is None

    extra = None
    if case.startswith("rope_"):  # the table cannot give a scaled base
        extra = {"rope_theta": 10000.0,
                 "rope_scaling": CASES[case][2]["rope_scaling"]}
        with pytest.raises(NotImplementedError, match="scaled RoPE"):
            modernlm_to_hf_llama(ours, str(tmp_path / "refused"))
    modernlm_to_hf_llama(ours, str(tmp_path / "port"), config_extra=extra)
    jhf.modernlm_to_hf_llama(theirs, str(tmp_path / "jax"),
                             config_extra=extra)
    cfg_p, st_p = _read_dir(str(tmp_path / "port"))
    cfg_j, st_j = _read_dir(str(tmp_path / "jax"))
    assert list(st_p) == list(st_j)
    for name in st_j:
        assert st_p[name].dtype == st_j[name].dtype, name
        np.testing.assert_array_equal(st_p[name].numpy(), st_j[name].numpy(),
                                      err_msg=name)
    assert sorted(cfg_p) == sorted(cfg_j)
    for key in cfg_j:
        if key == "rope_theta":
            assert cfg_p[key] == pytest.approx(cfg_j[key], rel=1e-5)
        else:
            assert cfg_p[key] == cfg_j[key], key


@pytest.mark.parametrize("what", ["llama", "mixtral"])
def test_port_export_loads_in_transformers(what, tmp_path):
    """A port-made ModernLM (a RoPE base of 12345; Mixtral: 3 experts,
    top-2) exported and loaded by transformers gives the port's logits, and
    the re-import gives them again bit for bit."""
    gen = torch.Generator().manual_seed(3)
    model = tnn.ModernLM.init(
        vocab_size=97, context_length=32, num_blocks=2, embed_dim=64,
        num_heads=4, num_kv_heads=2, mlp_hidden=96, tied=False,
        rope_base=12345.0, generator=gen, device="cpu",
        moe_experts=3 if what == "mixtral" else None)
    out = str(tmp_path / "export")
    modernlm_to_hf_llama(model, out)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["rope_theta"] == pytest.approx(12345.0,
                                                           rel=1e-5)
    cls = ("MixtralForCausalLM" if what == "mixtral"
           else "LlamaForCausalLM")
    tm = getattr(transformers, cls).from_pretrained(out).eval()
    toks = TOKS[:, :8]
    with torch.no_grad():
        ref = tm(torch.from_numpy(toks).long()).logits.float().numpy()
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    back = modernlm_from_hf_llama(out, device="cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 back.state_dict().items()):
        if "rope" not in name:
            assert torch.equal(a, b), name


def test_rope_scaling_translation_matches_jax():
    for rs in (None, {}, {"rope_type": "default"},
               {"type": "linear", "factor": 2.0},
               {"rope_type": "dynamic", "factor": 3.0},
               {"rope_type": "yarn", "factor": 4.0, "beta_fast": 16},
               {"rope_type": "llama3", "factor": 8.0,
                "original_max_position_embeddings": 8192}):
        assert thf._rope_scaling_of(rs, 64) == jhf._rope_scaling_of(rs, 64)
    with pytest.raises(NotImplementedError):
        thf._rope_scaling_of({"rope_type": "longrope", "factor": 2.0}, 64)


def test_loader_refusals_match_jax(tmp_path):
    src = str(tmp_path / "src")
    _write("llama_untied_gqa", src)
    config, state = thf._load_dir(src)
    with pytest.raises(NotImplementedError, match="head_dim"):
        thf.modernlm_from_hf_state(state, dict(config, head_dim=32),
                                   device="cpu")
    with open(os.path.join(src, "config.json"), "w") as f:
        json.dump(dict(config, architectures=["GPT2LMHeadModel"]), f)
    with pytest.raises(ValueError, match="unsupported"):
        modernlm_from_hf_llama(src, device="cpu")
    # a dtype cast and a context override, as JAX's
    with open(os.path.join(src, "config.json"), "w") as f:
        json.dump(config, f)
    m = modernlm_from_hf_llama(src, dtype=torch.bfloat16, context_length=16,
                               device="cpu")
    assert m.token_embedding.weight.dtype == torch.bfloat16
    assert m.rope_cos.shape[0] == 16 and m.rope_cos.dtype == torch.float32
    # a bf16 directory's state as the JAX package reads it (numpy arrays,
    # bf16 as ml_dtypes) builds the same model as the port's own read
    out = str(tmp_path / "bf16")
    modernlm_to_hf_llama(m, out)
    config, _ = thf._load_dir(out)
    from lamp_tpu.io.checkpoint import read_safetensors as jax_read

    jm = thf.modernlm_from_hf_state(
        jax_read(os.path.join(out, "model.safetensors")), config,
        device="cpu")
    own = modernlm_from_hf_llama(out, device="cpu")
    assert own.token_embedding.weight.dtype == torch.bfloat16
    for (name, a), (_, b) in zip(own.state_dict().items(),
                                 jm.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
