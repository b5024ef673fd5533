"""Port parity: lamp_tpu_torch.ops.quantization against lamp_tpu's.

The same numpy inputs go through both packages on CPU; the port's kernel
wrappers take their plain versions (CPU tensors), the JAX int4 kernel runs
in interpret mode, as tests/test_quantization.py runs it. Tolerances:

- quantized bytes and scales (int8 and int4, f32 and bf16 inputs): equal
  bit for bit;
- int8_matmul: the int32 product is exact on both sides and the two scales
  are applied in the same order, so within f32 rounding (rtol 1e-6);
- int4_matmul_reference against the JAX kernel (interpret mode): both sum
  exact products of x and the integer codes in f32 per group, so they
  differ in summation order only: rtol 1e-5, plus atol 1e-5 of the output's
  largest magnitude for sums that cancel;
- quantized models: logits at atol 1e-4, as the float model tests (sums of
  a few hundred f32 products taken in another order).

The JAX stochastic quantizer (K8) has no CPU lowering
(tests/test_quantization.py skips it off-TPU), so the port's plain version
is held to quantize_int8's scales, to {floor, ceil} of x / scale, to its
own seeding and to the unbiasedness check of that test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import nn as jnn
from lamp_tpu import ops as jops
from lamp_tpu_torch import bridge
from lamp_tpu_torch import ops as tops
from lamp_tpu_torch.nn import Linear
from lamp_tpu_torch.ops import quantization as tq

from .test_torch_modern import jax_modern_lm, jax_params
from .test_torch_transformer import jax_lm, torch_lm

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same numpy values as a JAX and a torch array of ``dtype`` (bf16
    rounds to nearest even on both sides)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _same(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32)
                                  if got.is_floating_point()
                                  else np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_bytes_match_jax(dtype, axis):
    x = np.random.RandomState(0).randn(48, 40).astype(np.float32)
    x[3] = 0.0  # an all-zero row: the 1e-8 floor of the scale
    jx, tx = _pair(x, dtype)
    jq, js = jops.quantize_int8(jx, axis=axis)
    tq_, ts = tops.quantize_int8(tx, axis=axis)
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    _same(tq_, jq)
    _same(ts, js)
    _same(tops.dequantize_int8(tq_, ts), jops.dequantize_int8(jq, js))


@pytest.mark.parametrize("k", [2, 6, 24, 96, 256, 768, 2048])
def test_int4_group_size_matches_jax(k):
    assert tops.int4_group_size(k) == jops.int4_group_size(k)
    assert tops.int4_group_size(k, 32) == jops.int4_group_size(k, 32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,n,g", [(256, 48, 128), (96, 20, 16)])
def test_quantize_int4_bytes_match_jax(dtype, k, n, g):
    w = np.random.RandomState(1).randn(k, n).astype(np.float32)
    jw, tw = _pair(w, dtype)
    jp, js = jops.quantize_int4(jw, group_size=g)
    tp, ts = tops.quantize_int4(tw, group_size=g)
    assert tp.dtype == torch.uint8 and tp.shape == (k // 2, n)
    assert ts.shape == (k // g, n)
    _same(tp, jp)
    _same(ts, js)
    for jdt, tdt in DTYPES.values():
        _same(tops.dequantize_int4(tp, ts, dtype=tdt),
              jops.dequantize_int4(jp, js, dtype=jdt))
    with pytest.raises(ValueError):
        tops.quantize_int4(tw, group_size=k)  # a group straddling K/2


@pytest.mark.parametrize("m", [5, 20])
def test_int8_matmul_matches_jax(m):
    """m=5 takes the zero-row padding that torch._int_mm needs on CUDA."""
    rng = np.random.RandomState(2)
    x = rng.randn(m, 64).astype(np.float32)
    w = (rng.randn(64, 24) * 0.1).astype(np.float32)
    jq, js = jops.quantize_int8(jnp.asarray(w), axis=0)
    tq_, ts = tops.quantize_int8(torch.from_numpy(w), axis=0)
    want = jops.int8_matmul(jnp.asarray(x), jq, js)
    got = tops.int8_matmul(torch.from_numpy(x), tq_, ts)
    assert got.shape == (m, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    got3 = tops.int8_matmul(torch.from_numpy(x).reshape(1, m, 64), tq_, ts,
                            out_dtype=torch.bfloat16)
    assert got3.shape == (1, m, 24) and got3.dtype == torch.bfloat16


def _int4_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# (M, K, N, dtype): kernel-eligible for the JAX kernel (N % 128, g % 32);
# M=5 takes its row-padding branch; the last four are the serving
# configuration's decode shapes (qkv, w1/w3, w2, logits)
@pytest.mark.parametrize("m,k,n,dtype", [
    (5, 256, 128, "f32"), (5, 256, 128, "bf16"), (16, 512, 256, "bf16"),
    (16, 512, 256, "f32"), (1, 768, 128, "bf16"), (32, 768, 1280, "bf16"),
    (7, 768, 2048, "bf16"), (32, 2048, 768, "bf16"),
    (1, 768, 32000, "bf16")])
def test_int4_matmul_reference_matches_jax_kernel(m, k, n, dtype):
    rng = np.random.RandomState(3)
    w = rng.randn(k, n).astype(np.float32)
    g = jops.int4_group_size(k)
    jp, js = jops.quantize_int4(jnp.asarray(w), group_size=g)
    tp, ts = torch.from_numpy(np.array(jp)), torch.from_numpy(np.array(js))
    jx, tx = _pair(rng.randn(m, k).astype(np.float32), dtype)
    want = jops.int4_matmul(jx, jp, js, out_dtype=jnp.float32, interpret=True)
    got = tops.int4_matmul_reference(tx, tp, ts)
    assert got.dtype == torch.float32
    _int4_close(got.numpy(), want)


def test_int4_matmul_at_a_fallback_shape_matches_jax_in_f32():
    """N=96 and g=16 send the JAX function to its dequantize-then-dot
    fallback, which rounds the dequantized weight to x's dtype; the port
    keeps the kernel's arithmetic at every shape. In f32 the two differ by
    f32 rounding only (in bf16 the fallback's rounded weight would not), so
    this shape is compared in f32 only."""
    rng = np.random.RandomState(4)
    w = rng.randn(64, 96).astype(np.float32)
    jp, js = jops.quantize_int4(jnp.asarray(w), group_size=16)
    x = rng.randn(3, 7, 64).astype(np.float32)
    want = jops.int4_matmul(jnp.asarray(x), jp, js)
    got = tops.int4_matmul(torch.from_numpy(x),
                           torch.from_numpy(np.array(jp)),
                           torch.from_numpy(np.array(js)))
    assert got.shape == (3, 7, 96)
    _int4_close(got.numpy(), want)


def test_int4_matmul_wrapper_is_the_plain_version_on_cpu():
    rng = np.random.RandomState(5)
    tp, ts = tops.quantize_int4(torch.from_numpy(
        rng.randn(128, 40).astype(np.float32)), group_size=32)
    x = torch.from_numpy(rng.randn(2, 3, 128).astype(np.float32)).bfloat16()
    before = tops.int4_matmul.launches
    got = tops.int4_matmul(x, tp, ts, out_dtype=torch.float32)
    torch.testing.assert_close(
        got.reshape(6, 40), tops.int4_matmul_reference(x.reshape(6, 128), tp,
                                                       ts), rtol=0, atol=0)
    assert tops.int4_matmul(x, tp, ts).dtype == torch.bfloat16
    assert tops.int4_matmul.launches == before
    with pytest.raises(ValueError, match="features"):
        tops.int4_matmul(x[..., :64], tp, ts)


# (M, N, K/2, g): the former split-K test's cases, then the serving
# configuration's five decode matmuls at M=32 (qkv, wo, w1/w3, w2, logits),
# then a ragged N and a K that needs rounds
@pytest.mark.parametrize("m,n,k2,g", [
    (32, 768, 1024, 128), (32, 768, 384, 128), (7, 1280, 768, 128),
    (1, 32000, 384, 128), (3072, 768, 1024, 128), (32, 2048, 896, 128),
    (32, 1280, 384, 128), (32, 768, 384, 128), (32, 2048, 384, 128),
    (32, 768, 1024, 128), (32, 32000, 384, 128), (64, 1000, 384, 16),
    (64, 4096, 8192, 128)])
def test_int4_plan_covers_k_once_and_fills_the_card(monkeypatch, m, n, k2,
                                                    g):
    """The wrapper decides K7's launch plan alone: M > 256 takes the
    row-tiled kernel's 128 x 128 tiles unsplit (its plans at 65-256 rows:
    tests/test_torch_speculative.py); otherwise each packed row lies in
    exactly one rank's slice of a cluster of at most 8 (none empty), a round is a
    multiple of 16 rows within the longest slice, the shared memory fits a
    block, and a call launches a block for every two SMs or more (66 of
    132; the plan aims there: more blocks in more ranks cost the H100 more
    in the cluster sum than they saved) or splits K as far as its 16-row
    steps allow (at most 8)."""
    monkeypatch.setattr(tq, "_sm_count", lambda index: 132)
    tile, cluster, round_rows = tq._int4_plan(m, n, k2, g,
                                              torch.device("cuda", 0))
    if m > 64:
        assert (tile, cluster, round_rows) == (128, 1, 128)
        return
    assert tile in (32, 64, 128)
    assert 1 <= cluster <= 8
    # the kernel's cut (launch_decode in csrc/int4_matmul.cu): rank r takes
    # the 16-row steps [r T / c, (r + 1) T / c) of the T = K/32 steps
    steps = k2 // 16
    slices = [(16 * (r * steps // cluster), 16 * ((r + 1) * steps // cluster))
              for r in range(cluster)]
    covered = np.zeros(k2, int)
    for start, end in slices:
        assert start < end and start % 16 == 0
        covered[start:end] += 1
    assert (covered == 1).all()
    longest = max(end - start for start, end in slices)
    assert 16 <= round_rows <= longest and round_rows % 16 == 0
    mrows = 8 * -(-m // 8)
    assert tq._int4_decode_smem(tile, mrows, k2, g, cluster, round_rows) \
        <= tq._MAX_SMEM
    blocks = -(-n // tile) * cluster
    assert blocks >= 132 // 2 or cluster == min(8, k2 // 16)


def _stochastic_input(rows=512):
    # anchor the scale at 1.0; payload 0.3 -> scaled 38.1 rounds 38/39
    return np.concatenate([np.ones((rows, 1), np.float32),
                           np.full((rows, 127), 0.3, np.float32)], axis=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stochastic_quantizer_scales_and_rounding(dtype):
    x = np.random.RandomState(6).randn(64, 96).astype(np.float32) * 3
    x[5] = 0.0
    jx, tx = _pair(x, dtype)
    vals, scales = tops.quantize_int8_stochastic(tx, seed=3)
    assert vals.dtype == torch.int8 and scales.shape == (64, 1)
    _, js = jops.quantize_int8(jx, axis=1)
    _same(scales, js)
    scaled = np.clip(_np(tx) / scales.numpy(), -127, 127)
    v = vals.numpy().astype(np.float32)
    assert ((v == np.floor(scaled)) | (v == np.ceil(scaled))).all()
    assert not vals[5].any()


def test_stochastic_quantizer_seeding():
    x = torch.from_numpy(_stochastic_input(64))
    a, _ = tops.quantize_int8_stochastic(x, seed=1)
    b, _ = tops.quantize_int8_stochastic(x, seed=1)
    c, _ = tops.quantize_int8_stochastic(x, seed=2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # a block of rows draws the same words alone as inside the whole
    # matrix: the stream depends on the flat index, not on a tiling
    x2 = torch.from_numpy(np.random.RandomState(7).randn(96, 40)
                          .astype(np.float32))
    whole, _ = tops.quantize_int8_stochastic(x2, seed=9)
    words = tq._random_words(9, 96 * 40, "cpu").reshape(96, 40)
    assert torch.equal(tq._random_words(9, 40 * 40, "cpu").reshape(40, 40),
                       words[:40])
    assert whole.shape == (96, 40)


def _lowbias32_py(v):
    v ^= v >> 16
    v = (v * 0x7FEB352D) & 0xFFFFFFFF
    v ^= v >> 15
    v = (v * 0x846CA68B) & 0xFFFFFFFF
    return v ^ (v >> 16)


def test_stochastic_quantizer_hash_is_the_stated_uint32_hash():
    """The int64 tensor hash equals lowbias32 on Python ints (unbounded,
    so no overflow), over the whole uint32 range, and the word of a 64-bit
    index follows the stated formula."""
    rng = np.random.RandomState(8)
    v = rng.randint(0, 2**32, 2000, dtype=np.int64)
    v[:3] = [0, 2**32 - 1, 0x80000000]
    got = tq._lowbias32(torch.from_numpy(v)).numpy()
    assert [int(a) for a in got] == [_lowbias32_py(int(a)) for a in v]
    seed, i = 12345, (5 << 32) + 77
    key = _lowbias32_py(seed ^ _lowbias32_py(i >> 32))
    want = _lowbias32_py((i & 0xFFFFFFFF) ^ key)
    idx = torch.tensor([i])
    got_key = tq._lowbias32(seed ^ tq._lowbias32(idx >> 32))
    assert int(tq._lowbias32((idx & 0xFFFFFFFF) ^ got_key)) == want


def test_stochastic_quantizer_unbiased():
    """tests/test_quantization.py's unbiasedness check, on the port."""
    x = torch.from_numpy(_stochastic_input())
    vals, scales = tops.quantize_int8_stochastic(x, seed=1)
    v = vals.numpy()[:, 1:]
    assert set(np.unique(v)) <= {38, 39}
    back = v.astype(np.float32) * scales.numpy()
    np.testing.assert_allclose(back.mean(), 0.3, rtol=0.005)


def _jax_forward(model, inputs):
    out = model(jnp.asarray(inputs))
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_model_language_model_matches_jax(bits):
    jm = jax_lm()
    tm = torch_lm(jm)
    jq = jops.quantize_model(jm, bits=bits)
    qm = tops.quantize_model(tm, bits=bits)
    kind = tops.QuantizedLinearInt4 if bits == 4 else tops.QuantizedLinear
    assert isinstance(qm.encoder.blocks[0].attention.w_q, kind)
    assert isinstance(qm.encoder.blocks[1].w2, kind)
    assert isinstance(tm.encoder.blocks[0].attention.w_q, Linear)
    toks = np.random.RandomState(9).randint(0, 61, (2, 16))
    want = _jax_forward(jq, toks)
    with torch.no_grad():
        got = qm(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tied", [True, False])
def test_quantize_model_modern_lm_matches_jax(bits, tied):
    jm = jax_modern_lm(tied=tied)
    tm = bridge.load_modern_lm(jax_params(jm), device="cpu")
    jq = jops.quantize_model(jm, bits=bits)
    qm = tops.quantize_model(tm, bits=bits)
    names = {type(m).__name__ for m in qm.modules()}
    assert "Linear" not in names
    toks = np.random.RandomState(10).randint(0, 61, (2, 12))
    want = _jax_forward(jq, toks)
    with torch.no_grad():
        got = qm(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 61)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_bridge_carries_a_jax_quantized_layer_unchanged(bits):
    rng = np.random.RandomState(11)
    lin = jnn.Linear.init(64, 48, key=jax.random.PRNGKey(3), bias=True)
    jl = (jops.QuantizedLinearInt4.from_linear(lin, 32) if bits == 4
          else jops.QuantizedLinear.from_linear(lin))
    params = jax_params(jl)
    tl = bridge.load_quantized_linear(params, device="cpu")
    names = ("w_packed", "w_scales") if bits == 4 else ("w_q", "w_scale")
    for name in names:
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(params[name]))
    x = rng.randn(5, 64).astype(np.float32)
    want = _jax_forward(jl, x)
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the port's own from_linear gives the same bytes from the bridged
    # float layer
    tlin = Linear(torch.from_numpy(np.asarray(lin.weight).T.copy()),
                  torch.from_numpy(np.array(lin.bias)))
    mine = (tops.QuantizedLinearInt4.from_linear(tlin, 32) if bits == 4
            else tops.QuantizedLinear.from_linear(tlin))
    for name in names:
        assert torch.equal(getattr(mine, name), getattr(tl, name))
    with pytest.raises(KeyError, match="unexpected"):
        bridge.load_quantized_linear(dict(params, extra=np.zeros(1)),
                                     device="cpu")


def test_quantize_model_rejects_other_bits_and_keeps_the_original():
    tm = torch_lm(jax_lm())
    before = tm.encoder.blocks[0].w1.weight.detach().clone()
    with pytest.raises(ValueError, match="bits"):
        tops.quantize_model(tm, bits=2)
    q = tops.quantize_model(tm, bits=8)
    assert torch.equal(tm.encoder.blocks[0].w1.weight, before)
    assert q.encoder.blocks[0].w1.w_q.shape == (32, before.shape[0])
    assert tq.QuantizedLinear.__tags__["w_q"] == "QuantizedLinear.weight"
    assert tq.QuantizedLinearInt4.__tags__["w_packed"] == \
        "QuantizedLinearInt4.weight"
