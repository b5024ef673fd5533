"""Port parity: lamp_tpu_torch.nn.modern against lamp_tpu.nn.modern.

Weights are made by the JAX modules from a seeded key and carried across
with lamp_tpu_torch.bridge; inputs are made with numpy. Everything runs in
f32. Tolerance: atol 1e-5 for the single-op pieces (norm, RoPE, SwiGLU)
and 1e-4 for blocks and model logits (sums of a few hundred f32 products
taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import nn as jnn
from lamp_tpu.nn.module import combine
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch.bridge import load_modern_lm

ATOL_OP, ATOL_MODEL = 1e-5, 1e-4


def jax_params(module) -> dict:
    """A lamp_tpu module's leaves as {pytree path: numpy array}, with paths
    written as the bridge reads them (``blocks.3.w_q.weight``)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    out = {}
    for path, leaf in leaves:
        parts = [str(getattr(p, "name", getattr(p, "idx", None)))
                 for p in path]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def jax_modern_lm(seed=0, **kw):
    cfg = dict(vocab_size=61, context_length=64, num_blocks=2, embed_dim=64,
               num_heads=4, num_kv_heads=2, dtype=jnp.float32)
    cfg.update(kw)
    return jnn.ModernLM.init(key=jax.random.PRNGKey(seed), **cfg)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_rmsnorm_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.rand(32).astype(np.float32) + 0.5
    x = rng.randn(3, 5, 32).astype(np.float32)
    want, _ = jnn.RMSNorm(weight=jnp.asarray(w), eps=1e-5).forward(
        jnp.asarray(x))
    _close(tnn.RMSNorm(torch.from_numpy(w), eps=1e-5)(torch.from_numpy(x)),
           want, ATOL_OP)


@pytest.mark.parametrize("scaling", [
    None,
    {"type": "linear", "factor": 2.0},
    {"type": "ntk", "factor": 4.0},
    {"type": "yarn", "factor": 4.0, "original_max_len": 32},
    {"type": "llama3", "factor": 8.0, "original_max_len": 32},
], ids=["none", "linear", "ntk", "yarn", "llama3"])
def test_rope_frequencies_match_jax(scaling):
    want_c, want_s = jnn.rope_frequencies(32, 128, scaling=scaling,
                                          dtype=jnp.float32)
    got_c, got_s = tnn.rope_frequencies(32, 128, scaling=scaling)
    # angles up to 128 rad: one f32 ulp of an angle moves cos/sin by ~1e-5
    _close(got_c, want_c, 3e-5)
    _close(got_s, want_s, 3e-5)


@pytest.mark.parametrize("positions", ["none", "1d", "2d"])
def test_apply_rope_matches_jax(positions):
    rng = np.random.RandomState(1)
    cos, sin = jnn.rope_frequencies(16, 32, dtype=jnp.float32)
    x = rng.randn(2, 3, 7, 16).astype(np.float32)
    pos = {"none": None,
           "1d": rng.randint(0, 32, 7).astype(np.int32),
           "2d": rng.randint(0, 32, (2, 7)).astype(np.int32)}[positions]
    want = jnn.apply_rope(jnp.asarray(x), cos, sin,
                          positions=None if pos is None else jnp.asarray(pos))
    got = tnn.apply_rope(
        torch.from_numpy(x), torch.tensor(np.asarray(cos)),
        torch.tensor(np.asarray(sin)),
        positions=None if pos is None else torch.from_numpy(pos).long())
    _close(got, want, ATOL_OP)


def test_swiglu_matches_jax():
    m = jax_modern_lm()
    jmlp = m.blocks[0].mlp
    t = load_modern_lm(jax_params(m), device="cpu")
    x = np.random.RandomState(2).randn(2, 5, 64).astype(np.float32)
    want, _ = jmlp.forward(jnp.asarray(x))
    _close(t.blocks[0].mlp(torch.from_numpy(x)), want, ATOL_OP)


@pytest.mark.parametrize("window", [None, 3])
def test_llama_block_matches_jax(window):
    m = jax_modern_lm(window=window)
    t = load_modern_lm(jax_params(m), window=window, device="cpu")
    x = np.random.RandomState(3).randn(2, 9, 64).astype(np.float32)
    (want, _), _ = m.blocks[1].forward((jnp.asarray(x),
                                        (m.rope_cos, m.rope_sin)))
    got = t.blocks[1](torch.from_numpy(x), t.rope_cos, t.rope_sin)
    assert t.blocks[1].num_kv_heads == 2 and t.blocks[1].window == window
    _close(got, want, ATOL_MODEL)


@pytest.mark.parametrize("tied,packed", [(True, False), (False, False),
                                          (True, True)],
                         ids=["tied", "untied", "packed"])
def test_modern_lm_forward_matches_jax(tied, packed):
    """``packed``: two documents per row, segment ids keep attention inside
    each and RoPE positions restart at the second."""
    m = jax_modern_lm(tied=tied, window=[None, 5])
    t = load_modern_lm(jax_params(m), window=[None, 5],
                       device="cpu")
    toks = np.random.RandomState(4).randint(0, 61, (2, 12))
    seg = pos = None
    if packed:
        seg = np.repeat([[0] * 5 + [1] * 7], 2, 0).astype(np.int32)
        pos = np.repeat([list(range(5)) + list(range(7))], 2, 0).astype(
            np.int32)
    want, _ = m.forward(
        jnp.asarray(toks, jnp.int32),
        segment_ids=None if seg is None else jnp.asarray(seg),
        positions=None if pos is None else jnp.asarray(pos))
    with torch.no_grad():
        got = t(torch.from_numpy(toks),
                segment_ids=None if seg is None else torch.from_numpy(seg),
                positions=None if pos is None else torch.from_numpy(pos))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 61)
    _close(got, want, ATOL_MODEL)


def test_bridge_carries_config_and_casts():
    m = jax_modern_lm(num_blocks=3)
    t = load_modern_lm(jax_params(m), dtype=torch.bfloat16, device="cpu")
    assert len(t.blocks) == 3 and t.context_length == 64
    assert t.blocks[0].num_heads == 4 and t.blocks[0].num_kv_heads == 2
    assert t.blocks[0].w_q.weight.dtype == torch.bfloat16
    assert t.rope_cos.dtype == torch.float32
    # PyTorch layout: [out, in]
    np.testing.assert_array_equal(
        t.blocks[2].mlp.w1.weight.detach().float().numpy(),
        np.asarray(m.blocks[2].mlp.w1.weight, np.float32).T.astype(
            jnp.bfloat16).astype(np.float32))


def test_bridge_rejects_missing_and_extra_keys():
    params = jax_params(jax_modern_lm())
    missing = dict(params)
    del missing["blocks.1.w_v.weight"]
    with pytest.raises(KeyError, match="blocks.1.w_v.weight"):
        load_modern_lm(missing, device="cpu")
    # an attention projection's bias is taken (a Qwen2 import's); an MLP
    # bias has no place in a ModernLM
    extra = dict(params,
                 **{"blocks.0.mlp.w1.bias": np.zeros(64, np.float32)})
    with pytest.raises(KeyError, match="blocks.0.mlp.w1.bias"):
        load_modern_lm(extra, device="cpu")


def test_modern_lm_init_is_seeded():
    kw = dict(vocab_size=50, context_length=16, num_blocks=1, embed_dim=32,
              num_heads=4, num_kv_heads=2, device="cpu")
    a = tnn.ModernLM.init(generator=torch.Generator().manual_seed(7), **kw)
    b = tnn.ModernLM.init(generator=torch.Generator().manual_seed(7), **kw)
    for (na, pa), (_, pb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(pa, pb), na
    # and so is a MoE model's
    a, b = (tnn.ModernLM.init(generator=torch.Generator().manual_seed(7),
                              moe_experts=4, **kw) for _ in range(2))
    assert type(a.blocks[0].mlp).__name__ == "SwiGLUMoE"
    for (na, pa), (_, pb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(pa, pb), na


def _packed(seed=5, ctx=16, vocab=61, rows=2):
    """Documents of 3-9 tokens packed into ``rows`` rows of ``ctx``."""
    from lamp_tpu_torch.data import pack_documents

    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, vocab, rng.randint(3, 10)) for _ in range(12)]
    p = pack_documents(docs, ctx)
    return {k: v[:rows] for k, v in p.items()}, docs


@pytest.mark.parametrize("tied,row_chunk", [(True, None), (False, 7)],
                         ids=["tied", "untied_chunk_7"])
def test_modern_lm_loss_packed_matches_jax(tied, row_chunk):
    """``ModernLM.loss`` on packed rows (segment ids, per-document
    positions, ignored targets at document ends and in the padding): the
    loss and every parameter's gradient against JAX's. Tolerance: rtol
    1e-5 on the loss, atol 1e-5 on gradients (f32, sums taken in another
    order)."""
    m = jax_modern_lm(tied=tied, context_length=16)
    t = load_modern_lm(jax_params(m), device="cpu")
    p, _ = _packed()
    j = {k: jnp.asarray(v) for k, v in p.items()}

    def jloss(model):
        return model.loss(j["tokens"], j["targets"], row_chunk=row_chunk,
                          segment_ids=j["segment_ids"],
                          positions=j["positions"])

    params, rest = jnn.partition_params(m)
    want, wgrad = jax.value_and_grad(
        lambda ps: jloss(combine(ps, rest)))(params)
    tt = {k: torch.from_numpy(v) for k, v in p.items()}
    got = t.loss(tt["tokens"], tt["targets"], row_chunk=row_chunk,
                 segment_ids=tt["segment_ids"], positions=tt["positions"])
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grads = jax_params(wgrad)
    linear = {f"{n}.weight" for n, mod in t.named_modules()
              if isinstance(mod, tnn.Linear)}
    for name, prm in t.named_parameters():
        w = grads[name].T if name in linear else grads[name]
        np.testing.assert_allclose(prm.grad.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_modern_lm_packed_loss_is_document_weighted():
    """The property of tests/test_modern.py's packing test, in the port:
    the packed loss equals the token-weighted mean of each document's
    standalone loss, and changing one document leaves the others' hidden
    states unchanged."""
    t = load_modern_lm(jax_params(jax_modern_lm(context_length=16)),
                       device="cpu")
    p, docs = _packed(rows=100)  # every row of the packing
    tt = {k: torch.from_numpy(v) for k, v in p.items()}
    with torch.no_grad():
        packed = t.loss(tt["tokens"], tt["targets"],
                        segment_ids=tt["segment_ids"],
                        positions=tt["positions"])
        total = count = 0.0
        for doc in docs:
            d = torch.from_numpy(np.asarray(doc)[None])
            total += float(t.loss(d[:, :-1], d[:, 1:])) * (len(doc) - 1)
            count += len(doc) - 1
        np.testing.assert_allclose(float(packed), total / count, rtol=2e-5)
        first = int(np.flatnonzero(p["positions"][0] == 0)[1])  # doc 2
        h0 = t.hidden(tt["tokens"], segment_ids=tt["segment_ids"],
                      positions=tt["positions"])
        mutated = tt["tokens"].clone()
        mutated[0, :first] = (mutated[0, :first] + 1) % 61
        h1 = t.hidden(mutated, segment_ids=tt["segment_ids"],
                      positions=tt["positions"])
    _close(h1[0, first:], h0[0, first:].numpy(), 1e-5)
    _close(h1[1:], h0[1:].numpy(), 1e-5)
    assert not torch.allclose(h1[0, :first], h0[0, :first])
    # a dense model's balancing loss is 0, so moe_aux_coef adds nothing
    with torch.no_grad():
        aux = t.loss(tt["tokens"], tt["targets"],
                     segment_ids=tt["segment_ids"],
                     positions=tt["positions"], moe_aux_coef=0.01)
    assert float(aux) == float(packed)
