"""Port parity: lamp_tpu_torch's paged_attention against lamp_tpu's.

The same numpy inputs go through the JAX Pallas kernel (interpret mode on
CPU, as tests/test_paged_attention.py runs it) and through the port's
wrapper on CPU tensors (its plain PyTorch version), in f32.
Tolerance: atol 1e-5 (f32 on both sides; the two differ only in the order
of the softmax sums). The fp8-pool cases hold the port against the JAX
plain reference at atol 1e-4.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lamp_tpu.ops.paged_attention import _effective_window as jax_window
from lamp_tpu.ops.paged_attention import paged_attention as jax_paged
from lamp_tpu.ops.paged_attention import \
    paged_attention_reference as jax_reference
from lamp_tpu_torch.ops.paged_attention import (
    _check_cuda,
    _effective_window,
    paged_attention,
    paged_attention_reference,
)

ATOL = 1e-5
B, D, PAGE, PPS, TOTAL = 6, 16, 8, 4, 24
# 0 (no keys), a page boundary either side, full pages, the table's end
# (append mode places the new token at lengths[b], so at most PPS*PAGE-1)
LENGTHS = np.array([0, 1, PAGE - 1, PAGE, PAGE + 1, PPS * PAGE - 1], np.int32)
PER_REQUEST = np.array([0, 3, 1, 0, 9, 2], np.int32)  # <= 0: no limit


def _inputs(heads, kv_heads, layout, seed=0):
    rng = np.random.RandomState(seed)
    layers = 2 if layout == "stacked" else 1
    pool_shape = ((layers * TOTAL, 2, PAGE, kv_heads * D)
                  if layout != "split" else (TOTAL, PAGE, kv_heads * D))
    k = rng.randn(*pool_shape).astype(np.float32)
    v = rng.randn(*pool_shape).astype(np.float32) if layout == "split" else None
    q = rng.randn(B, heads, D).astype(np.float32)
    table = np.stack([rng.choice(TOTAL, PPS, replace=False)
                      for _ in range(B)]).astype(np.int32)
    new = [rng.randn(B, kv_heads * D).astype(np.float32) for _ in range(2)]
    # the stacked pool's second layer is addressed with page_offset
    offset = TOTAL if layout == "stacked" else 0
    return q, k, v, table, new, offset


CASES = [  # (heads, kv_heads, layout, append, window mode)
    (4, 2, "fused", False, "none"),
    (4, 2, "fused", True, "none"),
    (4, 2, "split", False, "static"),
    (4, 2, "split", True, "static"),
    (2, 2, "fused", False, "per_request"),
    (2, 2, "fused", True, "per_request"),
    (4, 2, "stacked", True, "combined"),
    (4, 2, "stacked", False, "combined"),
    (2, 2, "split", True, "combined"),
    (2, 2, "stacked", True, "static"),
    (4, 1, "fused", True, "per_request"),
    (2, 2, "split", False, "none"),
]


@pytest.mark.parametrize(
    "heads,kv_heads,layout,append,wmode", CASES,
    ids=[f"{'gqa' if h != kv else 'mha'}-{lay}-"
         f"{'append' if app else 'pool'}-{w}"
         for h, kv, lay, app, w in CASES])
def test_paged_attention_matches_jax_kernel(heads, kv_heads, layout, append,
                                            wmode):
    q, k, v, table, new, offset = _inputs(heads, kv_heads, layout)
    window = 5 if wmode in ("static", "combined") else None
    windows = PER_REQUEST if wmode in ("per_request", "combined") else None
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(k), None if v is None else jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(LENGTHS), num_kv_heads=kv_heads,
        window=window,
        windows=None if windows is None else jnp.asarray(windows),
        append_kv=(tuple(jnp.asarray(a) for a in new) if append else None),
        page_offset=offset, interpret=True)
    got = paged_attention(
        torch.from_numpy(q), torch.from_numpy(k),
        None if v is None else torch.from_numpy(v), torch.from_numpy(table),
        torch.from_numpy(LENGTHS), num_kv_heads=kv_heads, window=window,
        windows=None if windows is None else torch.from_numpy(windows),
        append_kv=(tuple(torch.from_numpy(a) for a in new)
                   if append else None),
        page_offset=offset)
    assert got.dtype == torch.float32 and got.shape == (B, heads, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if not append:  # no valid key -> exactly 0
        assert not got[LENGTHS == 0].any()


def test_paged_attention_fp8_pool_matches_jax_reference():
    """fp8 (e4m3) pools on the CPU path: dequantized after the gather, as
    the JAX reference does. Both sides see the same fp8 values; atol 1e-4
    covers the f32 sums of values up to 448."""
    _fp8_pool_case("float8_e4m3fn")


def test_paged_attention_fp8_e5m2_pool_matches_jax_reference():
    """The same for e5m2 pools, the other fp8 type the kernel takes."""
    _fp8_pool_case("float8_e5m2")


def _fp8_pool_case(f8):
    q, k, _, table, new, _ = _inputs(4, 2, "fused", seed=1)
    k8 = k.astype(getattr(ml_dtypes, f8))
    want = jax_reference(
        jnp.asarray(q), jnp.asarray(k8), None, jnp.asarray(table),
        jnp.asarray(LENGTHS), num_kv_heads=2, window=6,
        append_kv=tuple(jnp.asarray(a) for a in new))
    got = paged_attention(
        torch.from_numpy(q),
        torch.from_numpy(k8.astype(np.float32)).to(getattr(torch, f8)), None,
        torch.from_numpy(table), torch.from_numpy(LENGTHS), num_kv_heads=2,
        window=6, append_kv=tuple(torch.from_numpy(a) for a in new))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("per_request", [False, True])
def test_effective_window_matches_jax(window, per_request):
    windows = PER_REQUEST if per_request else None
    want = jax_window(
        window, None if windows is None else jnp.asarray(windows), B)
    got = _effective_window(
        window, None if windows is None else torch.from_numpy(windows), B)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_attention_reference_is_the_cpu_path():
    """The wrapper on CPU tensors is exactly the plain version and launches
    nothing."""
    q, k, _, table, new, _ = _inputs(4, 2, "fused", seed=2)
    args = (torch.from_numpy(q), torch.from_numpy(k), None,
            torch.from_numpy(table), torch.from_numpy(LENGTHS))
    kw = dict(num_kv_heads=2, window=7,
              append_kv=tuple(torch.from_numpy(a) for a in new))
    before = paged_attention.launches
    torch.testing.assert_close(paged_attention(*args, **kw),
                               paged_attention_reference(*args, **kw),
                               rtol=0, atol=0)
    assert paged_attention.launches == before


def test_paged_attention_rejects_bad_shapes():
    q, k, _, table, _, _ = _inputs(4, 2, "fused")
    args = (torch.from_numpy(q), torch.from_numpy(k), None,
            torch.from_numpy(table), torch.from_numpy(LENGTHS))
    with pytest.raises(ValueError, match="pool width"):
        paged_attention(*args, num_kv_heads=4)
    with pytest.raises(ValueError, match="window"):
        paged_attention(*args, num_kv_heads=2, window=0)
    with pytest.raises(ValueError, match="append_kv"):
        paged_attention(*args, num_kv_heads=2,
                        append_kv=(torch.zeros(B, 3), torch.zeros(B, 3)))


def test_kernel_input_checks_raise():
    """What the CUDA path refuses before it launches (the checks do not
    depend on the device, so they run here)."""
    q, k, v, table, new, _ = _inputs(4, 2, "split")
    q, k, v, table = map(torch.from_numpy, (q, k, v, table))
    lengths = torch.from_numpy(LENGTHS)
    _check_cuda(q, [k, v], table, lengths, None, None)  # accepted
    for f8 in (torch.float8_e4m3fn, torch.float8_e5m2):  # fp8 pools too
        _check_cuda(q.to(torch.bfloat16), [k.to(f8), v.to(f8)], table,
                    lengths, None, None)
        _check_cuda(q, [k.to(f8)], table, lengths, None, None)
    with pytest.raises(TypeError, match="fp8"):
        _check_cuda(q.to(torch.float16), [k.to(torch.float8_e4m3fn)], table,
                    lengths, None, None)
    with pytest.raises(TypeError, match="one dtype"):
        _check_cuda(q.to(torch.bfloat16), [k], table, lengths, None, None)
    with pytest.raises(TypeError, match="int32"):
        _check_cuda(q, [k], table.long(), lengths, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        _check_cuda(q, [k, v], table, lengths, None,
                    (torch.from_numpy(new[0]).t().contiguous().t(),
                     torch.from_numpy(new[1])))
