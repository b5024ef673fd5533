"""LoRA (lamp_tpu_torch.nn.lora) against lamp_tpu.nn.lora: LoRALinear's
forward and merge, lora_inject's dotted paths, lora_parameter_count, and a
lora_inject-ed ModernLM carried across by the bridge.

Weights are made by lamp_tpu from seeded keys (or by numpy from a seed)
and carried across; everything runs in f32 on CPU. Tolerances: outputs
and merged weights at atol 1e-5 (f32 products summed in other orders),
logits at 1e-4 (test_torch_serving's); paths and counts exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lamp_tpu.nn as jnn
from lamp_tpu.nn.lora import LoRALinear as JaxLoRALinear
from lamp_tpu.nn.lora import _map_linears
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch.bridge import load_modern_lm

from .test_torch_modern import jax_modern_lm, jax_params
from .test_torch_serving_controls import jax_adapter

ATOL = 1e-5
ATOL_LOGITS = 1e-4


@pytest.mark.parametrize("bias", [False, True])
def test_lora_linear_forward_and_merge_match_jax(bias):
    """y = x W (+ b) + (x A) B * alpha / rank, and its merge into a plain
    Linear, on the same W, b, A and B (W transposed into the port's [out,
    in] layout; A and B keep the JAX layout)."""
    rng = np.random.RandomState(0)
    w = rng.randn(24, 40).astype(np.float32) * 0.2
    b = rng.randn(40).astype(np.float32) if bias else None
    a = rng.randn(24, 4).astype(np.float32)
    bb = rng.randn(4, 40).astype(np.float32) * 0.3
    x = rng.randn(3, 5, 24).astype(np.float32)
    jl = JaxLoRALinear(weight=jnp.asarray(w),
                       bias=None if b is None else jnp.asarray(b),
                       lora_a=jnp.asarray(a), lora_b=jnp.asarray(bb),
                       scale=2.0)
    tl = tnn.LoRALinear(torch.from_numpy(w.T.copy()),
                        None if b is None else torch.from_numpy(b),
                        torch.from_numpy(a), torch.from_numpy(bb), 2.0)
    assert [n for n, _ in tl.named_parameters()] == ["lora_a", "lora_b"]
    want, _ = jl.forward(jnp.asarray(x))
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    merged = tl.merge()
    np.testing.assert_allclose(merged.weight.detach().numpy().T,
                               np.asarray(jl.merge().weight), atol=ATOL,
                               rtol=0)
    with torch.no_grad():
        np.testing.assert_allclose(merged(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), atol=ATOL, rtol=0)


def _jax_paths(model):
    paths = []

    def visit(path, node):
        if type(node) is JaxLoRALinear:
            paths.append(".".join(str(p) for p in path))
        return None

    _map_linears(model, visit, ())
    return sorted(paths)


def _port_paths(model):
    return sorted(n for n, m in model.named_modules()
                  if type(m) is tnn.LoRALinear)


MATCHES = {"all": None,
           "q_v": lambda p: p.endswith(("w_q", "w_v")),
           "mlp_or_o": lambda p: "mlp" in p or p.endswith("w_o"),
           "block1": lambda p: p.startswith("blocks.1.")}


@pytest.mark.parametrize("match", list(MATCHES))
def test_lora_inject_paths_and_count_match_jax(match):
    """lora_inject with and without ``match`` adapts the modules of the
    same dotted paths as the JAX function (the untied lm_head included),
    and lora_parameter_count agrees. The port returns a new model: the
    input keeps its plain Linears, and the new model's unadapted tensors
    and adapted base weights are the input's own."""
    jm = jax_modern_lm(tied=False)
    tm = load_modern_lm(jax_params(jm), device="cpu")
    fn = MATCHES[match]
    jt = jnn.lora_inject(jm, rank=3, key=jax.random.PRNGKey(1), match=fn)
    tt = tnn.lora_inject(tm, rank=3, generator=torch.Generator(), match=fn)
    assert _port_paths(tt) == _jax_paths(jt)
    assert tnn.lora_parameter_count(tt) == jnn.lora_parameter_count(jt)
    assert not _port_paths(tm) and tnn.lora_parameter_count(tm) == 0
    assert tt.token_embedding is tm.token_embedding
    blk = tt.blocks[1]
    assert blk.w_q.weight.data_ptr() == tm.blocks[1].w_q.weight.data_ptr()
    # an adapted module's parameters are its factors alone
    adapted = [q + "." for q in _port_paths(tt)]
    assert all(n.rsplit(".", 1)[1] in ("lora_a", "lora_b")
               for n, _ in tt.named_parameters() if n.startswith(tuple(
                   adapted)))


def test_lora_inject_starts_at_the_base_and_merges_back():
    """A fresh adapter (B = 0) leaves the logits as they were; after B is
    drawn, lora_merge gives the adapted model's logits."""
    tm = load_modern_lm(jax_params(jax_modern_lm()), device="cpu")
    gen = torch.Generator().manual_seed(0)
    tt = tnn.lora_inject(tm, rank=4, generator=gen, alpha=8.0)
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 61, (2, 9)))
    with torch.no_grad():
        base = tm(toks)
        np.testing.assert_allclose(tt(toks).numpy(), base.numpy(), atol=ATOL,
                                   rtol=0)
        for m in tt.modules():
            if type(m) is tnn.LoRALinear:
                m.lora_b.normal_(0.0, 0.3, generator=gen)
        tuned = tt(toks)
        assert (tuned - base).abs().max() > 1e-2
        np.testing.assert_allclose(tnn.lora_merge(tt)(toks).numpy(),
                                   tuned.numpy(), atol=ATOL_LOGITS, rtol=0)


def test_converting_the_injected_tree_leaves_the_input_as_it_was():
    """lora_inject's copies own their tables: .double() on the injected
    tree (which replaces the buffer entries of every module it walks,
    ModernLM's RoPE tables and each LoRALinear's base weight included) and
    a hook on it leave the input's modules, tables and tensors as they
    were. The modules lora_inject did not copy (norms, embedding) are the
    input's own, as documented, and are not looked at."""
    tm = load_modern_lm(jax_params(jax_modern_lm()), device="cpu")
    before = dict(tm.named_buffers())
    linears = {n: (m, m.weight) for n, m in tm.named_modules()
               if type(m) is tnn.Linear}
    tt = tnn.lora_inject(tm, rank=2, generator=torch.Generator()
                         .manual_seed(0))
    assert tt.rope_cos is tm.rope_cos
    assert tt.blocks[0].w_q.weight.data_ptr() == tm.blocks[0].w_q.weight \
        .data_ptr()
    tt.register_forward_hook(lambda *a: None)
    tt.double()
    assert tt.rope_cos.dtype == tt.blocks[0].w_q.weight.dtype == torch.float64
    assert dict(tm.named_buffers()).keys() == before.keys()
    for name, t in tm.named_buffers():
        assert t is before[name] and t.dtype == torch.float32, name
    for name, (mod, w) in linears.items():
        assert tm.get_submodule(name) is mod, name
        assert mod.weight is w and w.dtype == torch.float32, name
    assert not tm._forward_hooks


@pytest.mark.parametrize("tied", [True, False])
def test_bridged_lora_modern_lm_logits_match_jax(tied):
    """A lora_inject-ed JAX ModernLM (rank 3, alpha 6: scale 2; B random;
    the untied lm_head adapted too) through bridge.load_modern_lm: its
    logits and those of its lora_merge against JAX's."""
    jm = jax_modern_lm(tied=tied)
    ja = jax_adapter(jm, 3, 1, alpha=6.0)
    tm = load_modern_lm(jax_params(ja), device="cpu", lora_scale=2.0)
    assert tnn.lora_parameter_count(tm) == jnn.lora_parameter_count(ja)
    assert _port_paths(tm) == _jax_paths(ja)
    toks = np.random.RandomState(2).randint(0, 61, (2, 11))
    want, _ = ja.forward(jnp.asarray(toks, jnp.int32))
    merged, _ = jnn.lora_merge(ja).forward(jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))
        got_m = tnn.lora_merge(tm)(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_LOGITS, rtol=0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(merged),
                               atol=ATOL_LOGITS, rtol=0)


def test_bridge_checks_lora_keys():
    """A lone factor or a factor on a module that is no linear raises
    KeyError, as any missing or unexpected key does."""
    params = jax_params(jax_adapter(jax_modern_lm(), 2, 1))
    lone = dict(params)
    del lone["blocks.0.w_q.lora_b"]
    with pytest.raises(KeyError, match="lora_b"):
        load_modern_lm(lone, device="cpu")
    odd = dict(params)
    odd["blocks.0.norm1.lora_a"] = np.zeros((64, 2), np.float32)
    with pytest.raises(KeyError, match="norm1.lora_a"):
        load_modern_lm(odd, device="cpu")
