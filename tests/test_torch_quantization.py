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


# K8's exact forms (csrc/quantize_int8.cu), written in numpy over the same
# bits and held against the plain operations they replace

_MAGIC = np.float32(1.5 * 2 ** 23)


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _bits(f):
    return np.asarray(f, np.float32).view(np.uint32)


def _lowbias32_np(x):
    x = np.atleast_1d(np.asarray(x, np.uint32))  # arrays wrap silently
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _two_sum(a, b):
    """float64 (s, e) with s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma32(a, b, c):
    """fmaf(a, b, c): a b + c rounded once to float32 (nearest even). a b is
    exact in float64; the sum's float64 rounding error decides a float32
    midpoint that the float64 sum lands on."""
    s, e = _two_sum(np.float64(a) * np.float64(b), np.asarray(c, np.float64))
    f = s.astype(np.float32)
    other = np.nextafter(f, np.where(s > f, np.float32(np.inf),
                                     np.float32(-np.inf)).astype(np.float32))
    mid = (np.float64(f) + np.float64(other)) / 2
    on_mid = (s != f) & (s == mid)
    hi, lo = np.maximum(f, other), np.minimum(f, other)
    return np.where(on_mid & (e > 0), hi, np.where(on_mid & (e < 0), lo, f))


def _quotient(v, scale):
    """The kernel's bf16 quotient: RN(v inv) and one FMA residual
    correction, inv = RN(1 / scale)."""
    v = np.asarray(v, np.float32)
    inv = np.float32(1) / np.float32(scale)
    q = v * inv
    return _fma32(_fma32(-q, scale, v), inv, q)


def _floor_magic(s):
    """(t, floor) of s + 1.5 2^23 rounded down to float32 (its unit is 1
    there), as ``__fadd_rd``: the exact sum's floor."""
    big, err = _two_sum(np.asarray(s, np.float32).astype(np.float64),
                        np.float64(_MAGIC))
    t = np.floor(big) - ((big == np.floor(big)) & (err < 0))
    t = t.astype(np.float32)
    return t, t - _MAGIC


def _below(word, frac):
    """The kernel's u - frac rounded once: fma(wu, 2^-32, -frac), wu the
    word with its low 8 bits cleared (u = wu 2^-32), as a float."""
    wu = np.asarray(word, np.uint32) & np.uint32(0xFFFFFF00)
    return _fma32(wu.astype(np.float32), np.float32(2.0 ** -32),
                  -np.asarray(frac, np.float32))


def _round_byte(s, word):
    """The kernel's byte of floor(s) + (u < s - floor(s)), s unclipped (its
    sign bit of u - frac added to floor(s)'s pattern), and whether the
    kernel redoes it: |u - frac| <= 2^-17."""
    t, f = _floor_magic(s)
    d = _below(word, np.asarray(s, np.float32) - f)
    byte = (_bits(t) + (_bits(d) >> np.uint32(31))) & np.uint32(0xFF)
    return byte.astype(np.uint8), np.abs(d) <= np.float32(2.0 ** -17)


def _plain_byte(s, word):
    s = np.asarray(s, np.float32)
    f = np.floor(s)
    u = (word >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    return (f + (u < (s - f))).astype(np.int8).view(np.uint8)


def test_k8_compare_form_is_exact_over_every_24_bit_value():
    """u < frac as the sign bit of fma(wu, 2^-32, -frac), wu the word with
    its low 8 bits cleared, as a float (exact: 24 significant bits): equal
    to the comparison of u = (word >> 8) 2^-24 at all 2^24 values of the
    word's top 24 bits (its low 8 at random), with frac at u and one ulp
    above and below it (within [0, 1))."""
    m = np.arange(1 << 24, dtype=np.uint32)
    rng = np.random.RandomState(0)
    word = (m << np.uint32(8)) | rng.randint(0, 256, m.size).astype(np.uint32)
    wu = m << np.uint32(8)
    assert (wu.astype(np.float32).astype(np.uint64) == wu).all()
    u = m.astype(np.float32) * np.float32(2.0 ** -24)
    one = np.float32(1)
    for frac in (u, np.minimum(np.nextafter(u, one), np.nextafter(one, 0)),
                 np.maximum(np.nextafter(u, np.float32(0)), 0)):
        assert ((0 <= frac) & (frac < 1)).all()
        np.testing.assert_array_equal(_bits(_below(word, frac)) >> 31,
                                      (u < frac).astype(np.uint32))


def test_k8_clip_is_left_to_the_redo():
    """The quotient of |x| <= absmax by scale = RN(max(absmax, 1e-8) / 127)
    is at most 2^-17 past 127 (every bf16 significand of absmax, the clamp,
    10^6 seeded f32 absmax), and there the unclipped byte equals the clipped
    plain one at every u except where |u - frac| <= 2^-17, which the kernel
    redoes (and differs at some of those)."""
    absmax = np.concatenate([
        (1 + np.arange(128) / 128).astype(np.float32),
        np.float32([1e-8]),
        np.random.RandomState(3).uniform(1, 2, 10 ** 6).astype(np.float32)])
    for e in (-20, 0, 60):
        a = absmax * np.float32(2.0 ** e)
        scale = np.maximum(a, np.float32(1e-8)) / np.float32(127)
        assert (a / scale <= np.float32(127 + 2.0 ** -17)).all()
    m = np.arange(1 << 24, dtype=np.uint32)
    word = m << np.uint32(8)
    for s in np.float32([127 + 2.0 ** -17, -127 - 2.0 ** -17]):
        got, redone = _round_byte(np.full(m.size, s), word)
        want = _plain_byte(np.full(m.size, np.clip(s, -127, 127)), word)
        assert (got == want)[~redone].all()
        assert not (got == want)[redone].all()
        assert redone.mean() < 2.0 ** -15


def test_k8_floor_and_byte_forms_match_the_plain_rounding():
    """floor(s) from s + 1.5 2^23 rounded down, the byte from that sum's
    pattern plus the sign bit of u - frac: equal to floor, to s - floor(s)
    and to the int8 of floor(s) + (u < frac) at every integer in [-127,
    127], its neighbours one ulp each way, and 10^6 seeded values, each
    with words whose u lies at, below and above the fraction and at
    random."""
    ints = np.arange(-127, 128, dtype=np.float32)
    up = np.nextafter(ints, np.float32(np.inf))
    dn = np.nextafter(ints, np.float32(-np.inf))
    rng = np.random.RandomState(1)
    s = np.concatenate([ints, up[:-1], dn[1:], np.float32([0.0, -0.0, 2e-45,
                                                           -2e-45, 1e-30]),
                        rng.uniform(-127, 127, 10 ** 6).astype(np.float32)])
    t, f = _floor_magic(s)
    np.testing.assert_array_equal(f, np.floor(s))
    assert (_bits(t) & np.uint32(0xFF)).astype(np.uint8).tolist() == \
        np.floor(s).astype(np.int8).view(np.uint8).tolist()
    frac = s - np.floor(s)
    at = np.minimum(np.floor(frac.astype(np.float64) * 2 ** 24),
                    2 ** 24 - 1).astype(np.uint32)
    for m in (at, np.maximum(at, 1) - 1, np.minimum(at + 1, 2 ** 24 - 1),
              rng.randint(0, 1 << 24, s.size).astype(np.uint32)):
        word = (m << np.uint32(8)) | rng.randint(0, 256, s.size).astype(
            np.uint32)
        np.testing.assert_array_equal(_round_byte(s, word)[0],
                                      _plain_byte(s, word))


def _bf16_scales():
    """Every scale a bf16 row gives, up to a power of 2: RN(m / 127) for
    the 128 significands m in [1, 2), and RN(1e-8 / 127) (the clamp)."""
    m = (1 + np.arange(128) / 128).astype(np.float32)
    return np.concatenate([m / np.float32(127),
                           np.float32([np.float32(1e-8) / np.float32(127)])])


def test_k8_bf16_quotient_equals_the_ieee_division():
    """The bf16 path's quotient (RN(v inv) and one FMA residual correction)
    equals v / scale rounded to nearest at every bf16 significand of v, both
    signs, against every scale a bf16 row gives, at every binade of the
    quotient from 2^-66 to 2^8 (|v| >= scale 2^-64 and the clip to 127 keep
    the kernel within them; scaling v and the scale by one power of 2 keeps
    every step's rounding, no step being subnormal, so this covers every
    bf16 input there). Zeros give zero. Then 10^6 seeded bf16 elements of
    rows at every exponent: equal to the IEEE quotient above scale 2^-64;
    below, both quotients are under 2^-61 and never of the other sign, so
    their bytes can differ only where u = 0, where |u - frac| <= 2^-17: the
    kernel redoes those by the plain arithmetic."""
    sig = (1 + np.arange(128) / 128).astype(np.float32)
    for scale in _bf16_scales():
        e = np.floor(np.log2(scale))
        exps = np.arange(e - 67, e + 10)
        v = (sig[:, None] * np.float32(2.0) ** exps[None, :].astype(
            np.float32)).ravel()
        v = np.concatenate([v, -v, np.float32([0.0, -0.0])])
        assert np.abs(v[:-2]).min() / scale < 2.0 ** -66
        got = _quotient(v, scale)
        want = v / np.float32(scale)
        np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(2)
    absmax = torch.from_numpy((2.0 ** rng.uniform(-140, 127, 1000)).astype(
        np.float32)).bfloat16().float().numpy()
    x = torch.from_numpy((rng.uniform(-1, 1, (1000, 1000))
                          * 2.0 ** rng.uniform(-60, 0, (1000, 1000))
                          * absmax[:, None]).astype(np.float32)
                         ).bfloat16().float().numpy()
    x[:, 0] = absmax
    scale = (np.maximum(np.abs(x).max(1), np.float32(1e-8))
             / np.float32(127))[:, None]
    got, want = _quotient(x, scale), x / scale
    above = np.abs(x) >= scale * np.float32(2.0 ** -64)
    np.testing.assert_array_equal(got[above], want[above])
    below = ~above
    assert 0.1 < below.mean() < 0.5
    assert (np.abs(got[below]) < 2.0 ** -61).all()
    assert (np.abs(want[below]) < 2.0 ** -61).all()
    assert (got[below] * np.sign(x[below]) >= 0).all()
    word = rng.randint(0, 1 << 32, below.sum(), dtype=np.uint64).astype(
        np.uint32)
    word[:1000] &= np.uint32(0xFF)  # u = 0
    byte, redone = _round_byte(got[below], word)
    keep = ~redone
    np.testing.assert_array_equal(byte[keep], _plain_byte(want[below],
                                                          word)[keep])
    assert redone[:1000][got[below][:1000] >= 0].all()  # all but q < 0


@pytest.mark.parametrize("k", [3072, 8, 4096 + 8])
def test_k8_chunk_key_equals_the_element_key_across_2_32(k):
    """The kernel's words: a row's two keys h(seed ^ h(hi)) and h(seed ^
    h(hi + 1)), the chunk's low index lo0 + c (32-bit, wrapping) picking
    one, and its elements' words h((lo ^ key) ^ e): equal to the per-element
    formula (``_random_words``) on 8-aligned chunks of the rows on both
    sides of flat index 2^32."""
    seed = 0x9E3779B9
    row = (1 << 32) // k
    for r in range(row - 1, row + 2):
        off = r * k
        lo0, hi0 = np.uint32(off & 0xFFFFFFFF), np.uint32(off >> 32)
        key0, key1 = (_lowbias32_np(np.uint32(seed) ^ _lowbias32_np(h))
                      for h in (hi0, hi0 + np.uint32(1)))
        c = np.arange(0, k, 8, dtype=np.uint32)
        lo = lo0 + c
        h = lo ^ np.where(lo < lo0, key1, key0)
        got = _lowbias32_np(h[:, None] ^ np.arange(8, dtype=np.uint32))
        want = tq._random_words(seed, k, "cpu", start=off).numpy()
        np.testing.assert_array_equal(got.ravel().astype(np.int64), want)
    assert (row - 1) * k < 1 << 32 < (row + 2) * k


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


def test_split_f32_to_bf16x3_adds_back_bit_for_bit():
    """f32 x splits into three bf16 parts that add back (in f32) to x bit
    for bit: seeded normals at exponents 2^-100 to 2^100, signed zeros, and
    values at bf16 rounding ties (the low 16 bits 0x8000) and one step past
    them, as the K7 kernels split f32 x on the card."""
    rng = np.random.RandomState(11)
    normals = rng.randn(4096).astype(np.float32) * np.exp2(
        rng.randint(-100, 101, 4096)).astype(np.float32)
    bits = rng.randint(0, 1 << 16, 512).astype(np.uint32) << 16
    ties = np.concatenate([bits | 0x8000, bits | 0x8001, bits | 0x7FFF,
                           (bits | 0x8000) | 0x80000000]).view(np.float32)
    ties = ties[np.isfinite(ties) & (np.abs(ties) < 3e38)
                & (np.abs(ties) > 2.0 ** -100)]
    x = torch.from_numpy(np.concatenate(
        [normals, ties, np.float32([0.0, -0.0])]))
    hi, mid, lo = tq.split_f32_to_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = hi.float() + mid.float() + lo.float()
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))
    # each part is the rounding of what the ones before it left
    assert torch.equal(hi, x.bfloat16())
    assert torch.equal(mid, (x - hi.float()).bfloat16())


# the serving configuration's matmuls (K, g) cut to narrow N
@pytest.mark.parametrize("k,n", [(768, 40), (2048, 24), (768, 72)])
def test_reference_over_the_three_parts_equals_f32_x(k, n):
    """int4_matmul_reference over hi, mid and lo, summed, equals it over the
    f32 x within 1e-6 relative: the kernels' three products are the plain
    version's f32 product, summed in another order."""
    rng = np.random.RandomState(k + n)
    p, s = tq.quantize_int4(torch.from_numpy(
        (rng.randn(k, n) * k ** -0.5).astype(np.float32)),
        group_size=tq.int4_group_size(k))
    x = torch.from_numpy((rng.randn(32, k) * 3).astype(np.float32))
    want = tq.int4_matmul_reference(x, p, s)
    got = sum(tq.int4_matmul_reference(part, p, s)
              for part in tq.split_f32_to_bf16x3(x))
    assert float((got - want).norm() / want.norm()) < 1e-6
    # one part alone reads far above that: the chip's planted fault
    one = tq.int4_matmul_reference(x.bfloat16(), p, s)
    assert float((one - want).norm() / want.norm()) > 1e-4


# (M, N, K/2, g, xs): f32 x (xs 4) at the decode rows and above, bf16 x
# (xs 2) beside it, groups that are not a multiple of 16, odd N at M > 64
@pytest.mark.parametrize("m,n,k2,g,xs", [
    (32, 1280, 384, 128, 4), (1, 32000, 384, 128, 4), (64, 768, 1024, 128, 4),
    (64, 1024, 4096, 128, 4), (128, 1280, 384, 128, 4),
    (160, 2048, 384, 128, 4), (3072, 32000, 384, 128, 4),
    (128, 50257, 384, 128, 4), (32, 1280, 384, 8, 4), (32, 1280, 384, 8, 2),
    (128, 50257, 384, 128, 2), (32, 50257, 384, 128, 2),
    (3072, 1280, 384, 128, 2)])
def test_route_plan_puts_f32_x_on_the_tensor_cores(monkeypatch, m, n, k2, g,
                                                   xs):
    """K7's routing (ops/quantization.py:_route_plan): groups of a multiple
    of 16 run on the tensor cores in f32 x as in bf16 x (the decode plan at
    M <= 64, whose shared memory holds x's f32 stage; the row-tiled plan
    above, 128 columns by 64 rows for f32 x, unsplit above 256 rows); groups
    of 8 and an odd N above 64 rows take the scalar route (0, 0, 0)."""
    monkeypatch.setattr(tq, "_sm_count", lambda index: 132)
    plan = tq._route_plan(m, n, k2, g, xs, True, torch.device("cuda", 0))
    if g % 16 or (m > 64 and n % 4):
        assert plan == (0, 0, 0)
        return
    tile, cluster, rows = plan
    steps = k2 // 16
    assert 1 <= cluster <= min(8, steps)
    if m <= 64:
        assert tile in (32, 64, 128) and rows % 16 == 0
        assert tq._int4_decode_smem(tile, 8 * -(-m // 8), k2, g, cluster,
                                    rows, xs) <= tq._MAX_SMEM
    elif xs == 4:
        assert (tile, rows) == (128, 64)
        assert m <= 256 or cluster == 1
        tiles = -(-n // 128) * -(-min(m, 257) // 64)
        assert cluster <= max(1, -(-66 // tiles))
    assert tq._route_plan(m, n, k2, g, xs, False,
                          torch.device("cuda", 0)) == (
        plan if m <= 64 else (0, 0, 0))
