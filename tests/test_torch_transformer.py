"""Port parity: lamp_tpu_torch's LayerNorm, MultiheadAttention, encoder
blocks, encoder, GPT language model, losses and param_tags against
lamp_tpu's.

Weights are made by the JAX modules from a seeded key and carried across
with lamp_tpu_torch.bridge (or, for single modules, from the same numpy
arrays); inputs are made with numpy. The JAX modules run their XLA
attention path on CPU, the port its flash_attention wrapper's plain
version. Tolerance: atol 1e-4 in f32 for modules, logits and parameter
gradients (sums of a few hundred f32 products taken in another order),
1e-5 for LayerNorm and the losses; bf16 LayerNorm within one bf16 rounding
of the output (2^-8 relative, atol 2e-2 at these magnitudes).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import nn as jnn
from lamp_tpu_torch import bridge
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch.nn import transformer as ttr

from .test_torch_modern import jax_params

ATOL = 1e-4


def jax_lm(seed=0, **kw):
    cfg = dict(vocab_size=61, context_length=16, num_blocks=2, embed_dim=32,
               attention_heads=2, dtype=jnp.float32)
    cfg.update(kw)
    return jnn.LanguageModelModule.init(key=jax.random.PRNGKey(seed), **cfg)


def torch_lm(jm, heads=2, dtype=torch.float32):
    return bridge.load_language_model(jax_params(jm), num_heads=heads,
                                      device="cpu", dtype=dtype)


def _linear(jlin):
    w = torch.tensor(np.asarray(jlin.weight).T.copy())
    b = None if jlin.bias is None else torch.tensor(np.asarray(jlin.bias))
    return tnn.Linear(w, b)


def _mha(jm, **kw):
    return tnn.MultiheadAttention(
        _linear(jm.w_q), _linear(jm.w_k), _linear(jm.w_v), _linear(jm.w_o),
        num_heads=jm.num_heads, num_kv_heads=jm.num_kv_heads,
        causal=jm.causal, **kw)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.RandomState(0)
    w = (rng.rand(48) + 0.5).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    x = (rng.randn(3, 7, 48) * 2 + 1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jln = jnn.LayerNorm(weight=jnp.asarray(w, jdt), bias=jnp.asarray(b, jdt),
                        eps=1e-5)
    want, _ = jln.forward(jnp.asarray(x, jdt))
    tln = tnn.LayerNorm(torch.tensor(w).to(tdt), torch.tensor(b).to(tdt))
    got = tln(torch.tensor(x).to(tdt))
    assert got.dtype == tdt
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)
    # without an elementwise affine, and the init's defaults
    plain = tnn.LayerNorm.init(48, elementwise=False, device="cpu")
    want, _ = jnn.LayerNorm.init(48, elementwise=False).forward(
        jnp.asarray(x))
    _close(plain(torch.tensor(x)), want, 1e-5)


@pytest.mark.parametrize("kind", ["plain", "gqa", "lengths_1d", "lengths_2d",
                                  "noncausal_cross", "linearized"])
def test_multihead_attention_matches_jax(kind):
    causal = kind != "noncausal_cross"
    jm = jnn.MultiheadAttention.init(
        32, 32, 32, 4, key=jax.random.PRNGKey(1), causal=causal, bias=True,
        num_kv_heads=2 if kind == "gqa" else None,
        linearized=kind == "linearized", dtype=jnp.float32)
    tm = _mha(jm, linearized=kind == "linearized")
    rng = np.random.RandomState(2)
    x = rng.randn(2, 11, 32).astype(np.float32)
    xkv = rng.randn(2, 13, 32).astype(np.float32) \
        if kind == "noncausal_cross" else x
    lengths = None
    if kind == "lengths_1d":
        lengths = np.array([5, 11], np.int32)
    elif kind == "lengths_2d":
        lengths = rng.randint(1, 12, (2, 11)).astype(np.int32)
    want, _ = jm.forward((jnp.asarray(x), jnp.asarray(xkv),
                          None if lengths is None else jnp.asarray(lengths)))
    got = tm((torch.tensor(x), torch.tensor(xkv),
              None if lengths is None else torch.tensor(lengths)))
    _close(got, want)


@pytest.mark.parametrize("gpt_order", [True, False], ids=["pre", "post"])
def test_encoder_block_matches_jax(gpt_order):
    jenc = jnn.TransformerEncoder.init(
        1, 32, 32, 4, 64, key=jax.random.PRNGKey(3), causal=True,
        gpt_order=gpt_order, dtype=jnp.float32)
    # learned residual scales away from 1, so that they are exercised
    rng = np.random.RandomState(4)
    params = jax_params(jenc)
    for name in ("blocks.0.scale1", "blocks.0.scale2"):
        params[name] = (rng.rand(32) + 0.5).astype(np.float32)
    jblock = dataclasses.replace(
        jenc.blocks[0], scale1=jnp.asarray(params["blocks.0.scale1"]),
        scale2=jnp.asarray(params["blocks.0.scale2"]))
    tblock = tnn.TransformerEncoderBlock(
        _mha(jblock.attention),
        tnn.LayerNorm(torch.tensor(np.asarray(jblock.norm1.weight)),
                      torch.tensor(np.asarray(jblock.norm1.bias))),
        tnn.LayerNorm(torch.tensor(np.asarray(jblock.norm2.weight)),
                      torch.tensor(np.asarray(jblock.norm2.bias))),
        _linear(jblock.w1), _linear(jblock.w2),
        torch.tensor(params["blocks.0.scale1"]),
        torch.tensor(params["blocks.0.scale2"]), gpt_order=gpt_order)
    x = rng.randn(2, 9, 32).astype(np.float32)
    lengths = np.array([9, 4], np.int32)
    (want, _), _ = jblock.forward((jnp.asarray(x), jnp.asarray(lengths)))
    got = tblock(torch.tensor(x), torch.tensor(lengths))
    _close(got, want)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_encoder_output_and_grads_match_jax(remat):
    jenc = jnn.TransformerEncoder.init(
        2, 32, 32, 2, key=jax.random.PRNGKey(5), causal=True, remat=remat,
        dtype=jnp.float32)
    jm = jax_lm()
    # carry the encoder across through a language model's key layout
    params = {f"encoder.{k}": v for k, v in jax_params(jenc).items()}
    params.update({k: v for k, v in jax_params(jm).items()
                   if not k.startswith("encoder.")})
    tenc = bridge.load_language_model(params, num_heads=2,
                                      device="cpu").encoder
    tenc.remat = remat
    rng = np.random.RandomState(6)
    x = rng.randn(2, 10, 32).astype(np.float32)
    dy = rng.randn(2, 10, 32).astype(np.float32)

    def jloss(enc, x):
        (y, _), _ = enc.forward((x, None))
        return jnp.sum(y * jnp.asarray(dy)), y

    (_, want), (gmod, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jenc, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = tenc(tx)
    (got * torch.tensor(dy)).sum().backward()
    _close(got, want)
    _close(tx.grad, gx)
    jg = jax_params(gmod)
    for name, p in tenc.named_parameters():  # 2-D: Linear weights
        _close(p.grad, jg[name].T if p.dim() == 2 else jg[name])


def test_language_model_logits_and_grads_match_jax():
    jm = jax_lm()
    tm = torch_lm(jm)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, 61, (3, 16)).astype(np.int32)
    target = np.roll(toks, -1, axis=1)
    target[0, :3] = -100  # ignored targets

    def jloss(m):
        logits, _ = m.forward(jnp.asarray(toks))
        return jnn.lm_loss(logits, jnp.asarray(target)), logits

    (jl, want), grads = jax.value_and_grad(jloss, has_aux=True)(jm)
    logits = tm(torch.tensor(toks))
    assert logits.dtype == torch.float32 and logits.shape == (3, 16, 61)
    loss = tnn.lm_loss(logits, torch.tensor(target))
    loss.backward()
    _close(logits, want)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, tnn.Linear)}
    jg = jax_params(grads)
    assert set(jg) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _close(p.grad, jg[name].T if name in linear else jg[name])


def test_language_model_input_positions_and_lengths_match_jax():
    jm = jax_lm(seed=1)
    tm = torch_lm(jm)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, 61, (2, 12)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)
    positions = rng.randint(0, 12, (2, 4)).astype(np.int32)
    want, _ = jm.forward(jnn.LanguageModelInput(
        jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(positions)))
    with torch.no_grad():
        got = tm(tnn.LanguageModelInput(torch.tensor(toks),
                                        torch.tensor(lengths),
                                        torch.tensor(positions)))
    assert got.shape == (2, 4, 61)
    _close(got, want)


def test_param_tags_match_jax():
    jm = jax_lm()
    want = jax.tree_util.tree_flatten_with_path(
        jnn.param_tags(jnn.partition_params(jm)[0]))[0]
    want = {".".join(str(getattr(p, "name", getattr(p, "idx", None)))
                     for p in path): tag for path, tag in want}
    got = tnn.param_tags(torch_lm(jm))
    assert got == want
    assert got["encoder.blocks.1.scale2"] == "TransformerEncoderBlock.scale"
    assert got["encoder.blocks.0.attention.w_k.bias"] == "Linear.bias"
    assert got["position_embedding.weight"] == "Embedding.weight"
    assert list(got) == [n for n, _ in torch_lm(jm).named_parameters()]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_match_jax(smoothing, reduction):
    rng = np.random.RandomState(9)
    logits = rng.randn(2, 5, 7).astype(np.float32) * 3
    target = rng.randint(0, 7, (2, 5)).astype(np.int32)
    target[1, 2] = target[0, 4] = -100
    kw = dict(reduction=reduction, ignore_index=-100)
    want = jnn.losses.cross_entropy_loss(
        jnp.asarray(logits).reshape(10, 7), jnp.asarray(target).reshape(10),
        label_smoothing=smoothing, **kw)
    got = tnn.cross_entropy_loss(torch.tensor(logits).reshape(10, 7),
                                 torch.tensor(target).reshape(10),
                                 label_smoothing=smoothing, **kw)
    _close(got, want, 1e-5)
    want = jnn.losses.sequence_nll(jnp.asarray(logits), jnp.asarray(target),
                                   **kw)
    got = tnn.sequence_nll(torch.tensor(logits), torch.tensor(target), **kw)
    _close(got, want, 1e-5)
    lp = torch.log_softmax(torch.tensor(logits), -1)
    want = jnn.losses.nll_loss(jnp.asarray(lp.numpy()), jnp.asarray(target),
                               **kw)
    _close(tnn.nll_loss(lp, torch.tensor(target), **kw), want, 1e-5)


def test_bridge_rejects_missing_and_extra_keys():
    params = jax_params(jax_lm())
    missing = dict(params)
    del missing["encoder.blocks.1.norm2.bias"]
    with pytest.raises(KeyError, match="encoder.blocks.1.norm2.bias"):
        bridge.load_language_model(missing, num_heads=2, device="cpu")
    extra = dict(params, **{"encoder.blocks.0.extra": np.zeros(3)})
    with pytest.raises(KeyError, match="encoder.blocks.0.extra"):
        bridge.load_language_model(extra, num_heads=2, device="cpu")


def test_bridge_carries_config_and_casts():
    jm = jax_lm(num_blocks=3, attention_heads=4, mlp_hidden=48)
    tm = bridge.load_language_model(jax_params(jm), num_heads=4,
                                    device="cpu", dtype=torch.bfloat16)
    assert len(tm.encoder.blocks) == 3 and tm.context_length == 16
    att = tm.encoder.blocks[0].attention
    assert att.num_heads == 4 and att.num_kv_heads == 4 and att.causal
    assert tm.encoder.blocks[2].w1.weight.shape == (48, 32)
    assert tm.final_norm.bias.dtype == torch.bfloat16


def test_constructors_and_bridge_default_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU
    (read from the signatures: nothing is allocated)."""
    fns = [tnn.Linear.init, tnn.Embedding.init, tnn.LayerNorm.init,
           tnn.RMSNorm.init, tnn.SwiGLU.init, tnn.LlamaBlock.init,
           tnn.ModernLM.init, tnn.MultiheadAttention.init,
           tnn.TransformerEncoderBlock.init, tnn.TransformerEncoder.init,
           tnn.LanguageModelModule.init, bridge.load_modern_lm,
           bridge.load_language_model]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__


def test_init_is_seeded_and_shaped_like_jax():
    kw = dict(vocab_size=61, context_length=16, num_blocks=2, embed_dim=32,
              attention_heads=2, device="cpu")
    a = tnn.LanguageModelModule.init(
        generator=torch.Generator().manual_seed(3), **kw)
    b = tnn.LanguageModelModule.init(
        generator=torch.Generator().manual_seed(3), **kw)
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
    jshapes = {k: v.shape for k, v in jax_params(jax_lm()).items()}
    linear = {f"{n}.weight" for n, m in a.named_modules()
              if isinstance(m, tnn.Linear)}
    assert {n: tuple(p.shape)[::-1] if n in linear else tuple(p.shape)
            for n, p in a.named_parameters()} == jshapes


def test_dropout_is_inverted_and_seeded():
    drop = tnn.Dropout(0.25)
    x = torch.ones(4000)
    assert drop(x) is x  # eval mode
    y = drop(x, train=True, generator=torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) <= {0.0, float(torch.tensor(1 / 0.75))}
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.03
    y2 = drop(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    with pytest.raises(ValueError, match="generator"):
        drop(x, train=True)


def test_attention_dropout_takes_the_unfused_branch_and_remat_repeats_it(
        monkeypatch):
    gen = torch.Generator().manual_seed(0)
    enc = tnn.TransformerEncoder.init(2, 16, 16, 2, generator=gen,
                                      dropout=0.5, causal=True, device="cpu")
    x = torch.randn(2, 6, 16, generator=gen)
    calls = []
    orig = ttr.flash_attention
    monkeypatch.setattr(ttr, "flash_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    enc(x, train=True, generator=torch.Generator().manual_seed(1))
    assert not calls  # dropout in training: the unfused branch
    enc(x)
    assert len(calls) == 2  # eval: the kernel wrapper in both blocks
    ys = []
    for remat in (False, True):
        enc.remat = remat
        xr = x.clone().requires_grad_()
        y = enc(xr, train=True, generator=torch.Generator().manual_seed(1))
        y.sum().backward()
        ys.append((y.detach(), xr.grad))
    # the recompute draws the same dropout masks
    torch.testing.assert_close(ys[0][0], ys[1][0], rtol=0, atol=0)
    torch.testing.assert_close(ys[0][1], ys[1][1], rtol=1e-6, atol=1e-6)


def test_lengths_to_mask_and_linearized_attention_match_jax():
    lens = np.array([[1, 3, 0], [2, 2, 4]], np.int32)
    np.testing.assert_array_equal(
        ttr.lengths_to_mask(torch.tensor(lens), 4).numpy(),
        np.asarray(jnn.lengths_to_mask(jnp.asarray(lens), 4)))
    np.testing.assert_array_equal(
        ttr.lengths_to_mask(torch.tensor(lens[:, 0]), 4).numpy(),
        np.asarray(jnn.lengths_to_mask(jnp.asarray(lens[:, 0]), 4)))
    rng = np.random.RandomState(10)
    q, k, v = (rng.randn(2, 2, 9, 8).astype(np.float32) for _ in range(3))
    want = jnn.linearized_attention(*map(jnp.asarray, (q, k, v)))
    _close(ttr.linearized_attention(*map(torch.tensor, (q, k, v))), want,
           1e-5)
