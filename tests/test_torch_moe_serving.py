"""MoE serving: lamp_tpu_torch's ModernBatchServer on a MoE ModernLM against
lamp_tpu's, and the attention-bias refusal.

A 2-block, 64-wide, 4-head / 2-kv-head ModernLM with SwiGLUMoE blocks (4
experts, top-2, expert width 48; vocab 61, context 64) is made by
lamp_tpu from a seeded key and bridged into the port; both servers use
8-token pages and run in f32 on CPU. Tolerance: logits at atol 1e-4
(f32 sums in another order), greedy tokens, page tables and free lists
exactly equal.

Under ``quantize_bits=8`` both servers store the experts as the same int8
bytes and scales (checked exactly) and quantize the step's rows and the
SwiGLU activations in the same order; the rows themselves agree to f32
rounding noise (~1e-7), which is far from flipping an int8 code on these
inputs, so the int8 logits are held to the same atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import nn as jnn
from lamp_tpu.models.serving import ModernBatchServer as JaxServer
from lamp_tpu_torch.bridge import load_modern_lm
from lamp_tpu_torch.models import ModernBatchServer

from .test_torch_modern import jax_params

ATOL = 1e-4
PAGE = 8


def _jax_moe_lm():
    return jnn.ModernLM.init(
        vocab_size=61, context_length=64, num_blocks=2, embed_dim=64,
        num_heads=4, num_kv_heads=2, mlp_hidden=48, moe_experts=4,
        moe_top_k=2, key=jax.random.PRNGKey(0))


def _servers(quantize_bits=None, prefix=False):
    jm = _jax_moe_lm()
    tm = load_modern_lm(jax_params(jm), device="cpu")
    kw = dict(page_size=PAGE, total_pages=32, quantize_bits=quantize_bits,
              enable_prefix_cache=prefix)
    return JaxServer(jm, **kw), ModernBatchServer(tm, **kw)


def _same_pages(js, ts):
    assert ts.seq_pages == js.seq_pages
    assert ts.seq_len == js.seq_len
    assert ts.free_pages == js.free_pages


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("bits", [None, 8], ids=["f32", "int8"])
def test_moe_decode_chunk_and_step_many_match_jax(bits):
    """Prefill two requests; 4 decode steps (request "a" crosses into its
    second page); a chunk of 3 tokens a request; a prefix hit whose tail
    prefills through the chunk path; then step_many's greedy tokens."""
    js, ts = _servers(bits, prefix=True)
    assert ts._moe and ts._moe_top_k == 2
    if bits:
        # the experts' int8 values and scales are JAX's bytes
        (v13, s13), (v2, s2) = ts._extras[3][0], ts._extras[4][0]
        (w1v, w1s), (w3v, w3s), (jv2, js2) = (js._extras[2][0][1],
                                              js._extras[3][0],
                                              js._extras[4][0])
        e, d, h = np.asarray(w1v).shape
        got = v13.numpy().reshape(d, 2, e, h).transpose(1, 2, 0, 3)
        np.testing.assert_array_equal(got[0], np.asarray(w1v))
        np.testing.assert_array_equal(got[1], np.asarray(w3v))
        np.testing.assert_array_equal(
            s13.numpy().reshape(2, e, 1, h),
            np.stack([np.asarray(w1s), np.asarray(w3s)]))
        np.testing.assert_array_equal(v2.numpy(), np.asarray(jv2))
        np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))
    system = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]  # one full page and a tail
    for s in (js, ts):
        s.add("a", system)
        s.add("b", [2, 7])
    _same_pages(js, ts)
    toks = [9, 7]
    for _ in range(4):
        want = js._advance(["a", "b"], jnp.asarray(toks, jnp.int32))
        got = ts._advance(["a", "b"], torch.tensor(toks))
        _close(got, want)
        toks = [int(t) for t in np.asarray(want).argmax(-1)]
    chunk = [[1, 2, 3], [4, 5, 6]]
    want = js.advance_chunk(["a", "b"], jnp.asarray(chunk, jnp.int32))
    got = ts.advance_chunk(["a", "b"], torch.tensor(chunk))
    _close(got, want)
    # a prefix hit: "c" shares "a"'s first page, its tail through the chunk
    for s in (js, ts):
        s.add("c", system[:PAGE] + [11, 12, 13])
    assert ts.cache_hit_tokens == js.cache_hit_tokens == PAGE
    _same_pages(js, ts)
    want = js._advance(["c"], jnp.asarray([7], jnp.int32))
    got = ts._advance(["c"], torch.tensor([7]))
    _close(got, want)
    assert ts.step_many(5) == js.step_many(5)
    _same_pages(js, ts)


def test_moe_unsupported_options_raise_as_jax():
    """int4 experts and adapters raise NotImplementedError in both
    packages; mesh= in the port."""
    jm = _jax_moe_lm()
    tm = load_modern_lm(jax_params(jm), device="cpu")
    for server in (JaxServer, ModernBatchServer):
        model = jm if server is JaxServer else tm
        with pytest.raises(NotImplementedError, match="int4"):
            server(model, page_size=PAGE, total_pages=8, quantize_bits=4)
        s = server(model, page_size=PAGE, total_pages=8)
        with pytest.raises(NotImplementedError, match="MoE"):
            s.register_adapter("a", model)


def _biased(jm, names=("w_q", "w_k", "w_v"), std=0.5):
    """The JAX model with Qwen2-style attention biases on ``names``."""
    rng = np.random.RandomState(7)
    blocks = []
    for blk in jm.blocks:
        for n in names:
            lin = getattr(blk, n)
            out = lin.weight.shape[1]
            blk = blk.replace(**{n: lin.replace(bias=jnp.asarray(
                rng.randn(out).astype(np.float32) * std))})
        blocks.append(blk)
    return jm.replace(blocks=tuple(blocks))


@pytest.mark.parametrize("names", [("w_q", "w_k", "w_v"), ("w_o",)],
                         ids=["qkv", "o"])
def test_attention_biases_raise_in_the_port(names):
    """A ModernLM whose attention projections carry biases (a Qwen2
    import's q/k/v) is refused, naming the biases: the decode step and
    the prefill multiply by the weights alone, as the JAX server's do."""
    jm = _biased(jnn.ModernLM.init(
        vocab_size=61, context_length=32, num_blocks=2, embed_dim=32,
        num_heads=4, num_kv_heads=2, key=jax.random.PRNGKey(1)), names)
    tm = load_modern_lm(jax_params(jm), device="cpu")
    assert getattr(tm.blocks[0], names[0]).bias is not None
    with pytest.raises(NotImplementedError, match="attention biases"):
        ModernBatchServer(tm, page_size=PAGE, total_pages=8)
    # the model itself computes with them
    toks = np.array([[3, 1, 4, 1, 5]], np.int32)
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.forward(
        jnp.asarray(toks))[0]), atol=ATOL, rtol=0)


def test_jax_server_leaves_out_qwen2_attention_biases():
    """The JAX package's defect that the port's refusal answers: the JAX
    ModernBatchServer's greedy decode logits of a model with q/k/v biases
    (as a Qwen2 import has them) stray from the JAX model's own dense
    forward, where the same model without biases agrees to f32 noise.
    Reads the JAX package only."""
    base = jnn.ModernLM.init(
        vocab_size=61, context_length=32, num_blocks=2, embed_dim=32,
        num_heads=4, num_kv_heads=2, key=jax.random.PRNGKey(1))
    prompt = [3, 1, 4, 1, 5, 9]
    errs = {}
    for name, jm in (("plain", base), ("biased", _biased(base))):
        server = JaxServer(jm, page_size=PAGE, total_pages=8)
        server.add("a", prompt)
        toks, err = list(prompt), 0.0
        for _ in range(3):
            step = np.asarray(server._advance(
                ["a"], jnp.asarray([toks[-1]], jnp.int32)))[0]
            dense, _ = jm.forward(jnp.asarray([toks]))
            err = max(err, float(np.abs(step - np.asarray(dense)[0, -1])
                                 .max()))
            toks.append(int(step.argmax()))
        errs[name] = err
    assert errs["plain"] < ATOL
    assert errs["biased"] > 100 * ATOL, errs
