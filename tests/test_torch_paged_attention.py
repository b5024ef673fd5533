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
    _MAX_SPLITS,
    _check_cuda,
    _effective_window,
    _paged_plan,
    _split_pages,
    paged_attention,
    paged_attention_reference,
)

ATOL = 1e-5
B, D, PAGE, PPS, TOTAL = 6, 16, 8, 4, 24
# 0 (no keys), a page boundary either side, full pages, the table's end
# (append mode places the new token at lengths[b], so at most PPS*PAGE-1)
LENGTHS = np.array([0, 1, PAGE - 1, PAGE, PAGE + 1, PPS * PAGE - 1], np.int32)
PER_REQUEST = np.array([0, 3, 1, 0, 9, 2], np.int32)  # <= 0: no limit


def _inputs(heads, kv_heads, layout, seed=0, d=D):
    rng = np.random.RandomState(seed)
    layers = 2 if layout == "stacked" else 1
    pool_shape = ((layers * TOTAL, 2, PAGE, kv_heads * d)
                  if layout != "split" else (TOTAL, PAGE, kv_heads * d))
    k = rng.randn(*pool_shape).astype(np.float32)
    v = rng.randn(*pool_shape).astype(np.float32) if layout == "split" else None
    q = rng.randn(B, heads, d).astype(np.float32)
    table = np.stack([rng.choice(TOTAL, PPS, replace=False)
                      for _ in range(B)]).astype(np.int32)
    new = [rng.randn(B, kv_heads * d).astype(np.float32) for _ in range(2)]
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


# Head dims other than 64 and 128, more than 8 query heads per kv head,
# float16 and fp8 pools at head_dim 100 (what the CUDA wrapper once
# refused), against the JAX kernel in interpret mode: (name, heads,
# kv_heads, head_dim, layout, append, window mode, q dtype, pool dtype;
# None: q's). Tolerances: f32 as ATOL; float16 rounds p and the output to
# f16 (2^-11 relative) on both sides at other places, as the flash
# attention tests' float16 cases (4e-3). Under fp8 pools the JAX kernel
# rounds p and the appended rows to bf16 before its dots where the port
# and the JAX plain reference keep q's dtype (ROADMAP.md's stated choice),
# an error relative to the V values it weighs; there the port is held to
# the JAX reference at 1e-4 (as the fp8 cases below), and to be no further
# from the exact result (the port's plain version in float64 on the same
# fp8 values) than the JAX kernel is, within ATOL.
# the split plan's page boundaries +- 1 (append mode puts the new token at
# lengths[b], so at most PPS * PAGE - 1)
SPLIT_BOUNDS = np.array([1, 15, 16, 17, 24, 25], np.int32)
WIDE_CASES = [
    ("d100_mha", 2, 2, 100, "fused", True, "combined", "float32", None),
    ("d100_group12", 12, 1, 100, "stacked", True, "per_request", "float32",
     None),
    ("d100_group16", 32, 2, 100, "split", False, "static", "float32", None),
    ("d256_group32", 32, 1, 256, "fused", True, "none", "float32", None),
    ("d256_mha", 2, 2, 256, "split", True, "static", "float32", None),
    ("d100_f16", 4, 2, 100, "fused", True, "combined", "float16", None),
    ("d100_f16_group16", 16, 1, 100, "stacked", False, "none", "float16",
     None),
    ("d100_e4m3", 4, 2, 100, "fused", True, "static", "float32",
     "float8_e4m3fn"),
    ("d100_e5m2_f16", 2, 2, 100, "fused", True, "none", "float16",
     "float8_e5m2"),
    # lengths at the edges of the CUDA kernel's key split (ranks of one page
    # each at PAGE = 8: boundaries at 8, 16 and 24 tokens), and a group of
    # 32 query heads over one kv head (MQA), whose rows the split serves
    ("d100_split_bounds", 2, 2, 100, "fused", True, "combined", "float32",
     None, SPLIT_BOUNDS),
    ("d100_split_bounds_pool", 2, 2, 100, "split", False, "none", "float32",
     None, SPLIT_BOUNDS),
    ("d128_group32_kv1", 32, 1, 128, "fused", True, "per_request",
     "float32", None, SPLIT_BOUNDS),
    ("d128_group32_kv1_pool", 32, 1, 128, "stacked", False, "static",
     "float32", None, None),
]
WIDE_ATOL = {"float32": ATOL, "float16": 4e-3}


@pytest.mark.parametrize("case", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_head_dims_groups_and_dtypes_match_jax_kernel(case):
    _, heads, kv_heads, d, layout, append, wmode, qdt, pool, *rest = case
    lengths = LENGTHS if not rest or rest[0] is None else rest[0]
    q, k, v, table, new, offset = _inputs(heads, kv_heads, layout, seed=3,
                                          d=d)
    window = 5 if wmode in ("static", "combined") else None
    windows = PER_REQUEST if wmode in ("per_request", "combined") else None
    q, new = q.astype(qdt), [a.astype(qdt) for a in new]
    if pool is None:
        kj, vj = k.astype(qdt), None if v is None else v.astype(qdt)
        kt, vt = torch.from_numpy(kj), None if v is None else \
            torch.from_numpy(vj)
    else:  # the same fp8 values on both sides
        f8 = getattr(ml_dtypes, pool)
        kj, vj = k.astype(f8), None if v is None else v.astype(f8)
        kt = torch.from_numpy(kj.astype(np.float32)).to(getattr(torch, pool))
        vt = None if v is None else torch.from_numpy(
            vj.astype(np.float32)).to(getattr(torch, pool))
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(kj), None if v is None else jnp.asarray(vj),
        jnp.asarray(table), jnp.asarray(lengths), num_kv_heads=kv_heads,
        window=window,
        windows=None if windows is None else jnp.asarray(windows),
        append_kv=(tuple(jnp.asarray(a) for a in new) if append else None),
        page_offset=offset, interpret=True)
    got = paged_attention(
        torch.from_numpy(q), kt, vt, torch.from_numpy(table),
        torch.from_numpy(lengths), num_kv_heads=kv_heads, window=window,
        windows=None if windows is None else torch.from_numpy(windows),
        append_kv=(tuple(torch.from_numpy(a) for a in new)
                   if append else None),
        page_offset=offset)
    assert got.dtype == getattr(torch, qdt) and got.shape == (B, heads, d)
    got32, want32 = got.float().numpy(), np.asarray(want).astype(np.float32)
    if pool is None:
        np.testing.assert_allclose(got32, want32, atol=WIDE_ATOL[qdt], rtol=0)
    else:
        ref = jax_reference(
            jnp.asarray(q), jnp.asarray(kj),
            None if v is None else jnp.asarray(vj), jnp.asarray(table),
            jnp.asarray(lengths), num_kv_heads=kv_heads, window=window,
            windows=None if windows is None else jnp.asarray(windows),
            append_kv=(tuple(jnp.asarray(a) for a in new) if append
                       else None), page_offset=offset)
        np.testing.assert_allclose(got32, np.asarray(ref).astype(np.float32),
                                   atol=1e-4, rtol=0)
        exact = paged_attention(
            torch.from_numpy(q).double(), kt.double(),
            None if vt is None else vt.double(), torch.from_numpy(table),
            torch.from_numpy(lengths), num_kv_heads=kv_heads, window=window,
            windows=None if windows is None else torch.from_numpy(windows),
            append_kv=(tuple(torch.from_numpy(a).double() for a in new)
                       if append else None),
            page_offset=offset).numpy()
        assert np.abs(got32 - exact).max() <= \
            np.abs(want32 - exact).max() + ATOL
    if not append:  # no valid key -> exactly 0
        assert not got[lengths == 0].any()


def test_float64_matches_jax_kernel_and_computes_in_double():
    """float64 under JAX's x64, at head_dim 100 with 6 query heads per kv
    head: the JAX kernel's dots ask for f32 results even there, so the two
    agree at f32's ATOL; the port's plain version (the CUDA kernel's
    reference, which computes in double) is also held to a float64 numpy
    computation at 1e-12."""
    import jax

    q, k, _, table, new, _ = _inputs(12, 2, "fused", seed=4, d=100)
    q, k, new = q.astype(np.float64), k.astype(np.float64), \
        [a.astype(np.float64) for a in new]
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jax_paged(
            jnp.asarray(q), jnp.asarray(k), None, jnp.asarray(table),
            jnp.asarray(LENGTHS), num_kv_heads=2, window=6,
            append_kv=tuple(jnp.asarray(a) for a in new), interpret=True))
    finally:
        jax.config.update("jax_enable_x64", old)
    got = paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), None,
        torch.from_numpy(table), torch.from_numpy(LENGTHS), num_kv_heads=2,
        window=6, append_kv=tuple(torch.from_numpy(a) for a in new)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # exact: per row b, head h, keys of the band plus the appended one
    for b in range(B):
        n = int(LENGTHS[b])
        keys = [(p, s) for p in table[b] for s in range(PAGE)][:n][-5:]
        for h in range(12):
            g = h // 6
            kk = [k[p, 0, s, g * 100:(g + 1) * 100] for p, s in keys]
            vv = [k[p, 1, s, g * 100:(g + 1) * 100] for p, s in keys]
            kk = np.stack(kk + [new[0][b, g * 100:(g + 1) * 100]])
            vv = np.stack(vv + [new[1][b, g * 100:(g + 1) * 100]])
            sc = kk @ q[b, h] / 10.0
            p = np.exp(sc - sc.max())
            np.testing.assert_allclose(got[b, h], p @ vv / p.sum(),
                                       atol=1e-12, rtol=0)


# The CUDA fixed kernel's edges (paged_attention_fixed: head_dim 64 or 128,
# at most 8 query heads a kv head, the band's 16-key boxes interleaved over
# a cluster of _paged_plan's splits): the serving slice's 12 / 4 heads of
# 64 and a group of 8 at 128, bf16 q over a bf16 or an e4m3 pool of
# 16-token pages, lengths at a box's edges (15-17), a page's (127-129 at
# pages of 16: a box's too) and the plan's split boundaries +- 1,
# per-request windows whose bands start inside a box, one case with a
# static window too.
# Tolerance: both sides give bf16 outputs from f32 sums and round p to
# bf16 at different places (the JAX kernel before normalising, the plain
# version after): they differ by at most a bf16 step (2^-8 relative) and a
# little more, atol 1e-2 and rtol 1e-2.
FIXED_EDGE_CASES = [  # (name, heads, kv heads, head_dim, pool, append, window)
    ("d64_12_4_bf16", 12, 4, 64, "bfloat16", False, None),
    ("d64_12_4_e4m3_append", 12, 4, 64, "float8_e4m3fn", True, None),
    ("d128_group8_bf16_append", 16, 2, 128, "bfloat16", True, 40),
    ("d128_group8_e4m3", 16, 2, 128, "float8_e4m3fn", False, None),
]


@pytest.mark.parametrize("case", FIXED_EDGE_CASES,
                         ids=[c[0] for c in FIXED_EDGE_CASES])
def test_fixed_kernel_edges_match_jax_kernel(case):
    _, heads, kv_heads, d, pool, append, window = case
    page, pps, total = 16, 16, 200
    splits, _ = _paged_plan(12, kv_heads, heads // kv_heads, d, pps, 132)
    assert splits > 1  # the split's boundaries are among the lengths
    edges = [0, 1, 15, 16, 17, 127, 128, 129, pps * page - 1]
    for lo, _ in _split_pages(pps, splits)[1:]:
        edges += [lo * page - 1, lo * page, lo * page + 1]
    lengths = np.asarray(edges, np.int32)
    b = len(lengths)
    rng = np.random.RandomState(7)
    # bands starting inside a 16-key box (or no limit: 0)
    windows = np.asarray([0, 3, 9, 20, 0, 37, 50, 0, 100] * 4,
                         np.int32)[:b]
    k = rng.randn(total, 2, page, kv_heads * d).astype(np.float32)
    q = rng.randn(b, heads, d).astype(ml_dtypes.bfloat16)
    table = np.stack([rng.choice(total, pps, replace=False)
                      for _ in range(b)]).astype(np.int32)
    new = [rng.randn(b, kv_heads * d).astype(ml_dtypes.bfloat16)
           for _ in range(2)]
    kj = k.astype(getattr(ml_dtypes, pool))
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(kj), None, jnp.asarray(table),
        jnp.asarray(lengths), num_kv_heads=kv_heads, window=window,
        windows=jnp.asarray(windows),
        append_kv=tuple(jnp.asarray(a) for a in new) if append else None,
        interpret=True)
    kt = torch.from_numpy(kj.astype(np.float32)).to(getattr(torch, pool))
    got = paged_attention(
        torch.from_numpy(q.astype(np.float32)).bfloat16(), kt, None,
        torch.from_numpy(table), torch.from_numpy(lengths),
        num_kv_heads=kv_heads, window=window,
        windows=torch.from_numpy(windows),
        append_kv=tuple(torch.from_numpy(a.astype(np.float32)).bfloat16()
                        for a in new) if append else None)
    assert got.dtype == torch.bfloat16 and got.shape == (b, heads, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=1e-2, rtol=1e-2)
    if not append:  # no valid key -> exactly 0
        assert not got[torch.from_numpy(lengths) == 0].any()


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
        # float16 q, with a pool of its dtype or of an fp8 dtype
        _check_cuda(q.to(torch.float16), [k.to(f8)], table, lengths, None,
                    None)
    _check_cuda(q.to(torch.float16), [k.to(torch.float16)], table, lengths,
                None, None)
    _check_cuda(q.double(), [k.double(), v.double()], table, lengths, None,
                None)
    with pytest.raises(TypeError, match="fp8"):  # float64 has no fp8 pool
        _check_cuda(q.double(), [k.to(torch.float8_e4m3fn)], table, lengths,
                    None, None)
    with pytest.raises(TypeError, match="fp8"):
        _check_cuda(q.to(torch.float16), [k.to(torch.bfloat16)], table,
                    lengths, None, None)
    with pytest.raises(TypeError, match="one dtype"):
        _check_cuda(q.to(torch.bfloat16), [k], table, lengths, None, None)
    with pytest.raises(TypeError, match="int32"):
        _check_cuda(q, [k], table.long(), lengths, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        _check_cuda(q, [k, v], table, lengths, None,
                    (torch.from_numpy(new[0]).t().contiguous().t(),
                     torch.from_numpy(new[1])))
    # the kernels' maps address the pool's rows by int32 coordinates: a
    # pool of 2^32 rows (a shape alone, on the meta device) is refused
    with pytest.raises(ValueError, match="rows"):
        _check_cuda(q, [torch.empty((2 ** 24, 2, 128, 8), device="meta")],
                    table, lengths, None, None)
    # q is read 4 or 8 bytes at a time: a view 4 bytes into a buffer is
    # refused
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        _check_cuda(shifted, [k, v], table, lengths, None, None)


# the CUDA kernel's shapes beside the serving slice's (chip_smoke.py's
# K6_WIDE: name, heads, kv heads, head dim), each planned at phase 2's
# B=32 and at B=1 on an H100's 132 SMs
K6_WIDE_SHAPES = [
    ("serving d64", 12, 4, 64), ("d128 group 8", 16, 2, 128),
    ("d80", 12, 4, 80), ("d96", 12, 4, 96), ("openllama d100", 32, 32, 100),
    ("d128 32/32", 32, 32, 128), ("gemma d256", 8, 1, 256),
    ("405B 128/8", 128, 8, 128), ("MQA 32/1", 32, 1, 128),
    ("d75 odd", 4, 2, 75), ("d320 2/1", 2, 1, 320),
    ("128/1 d256", 128, 1, 256),
]


@pytest.mark.parametrize("shape", K6_WIDE_SHAPES,
                         ids=[s[0] for s in K6_WIDE_SHAPES])
def test_paged_split_plan_covers_pages_once(shape):
    """The key split of both kernels (paged_attention_fixed at the first
    two shapes, paged_attention_any at the rest): at pages_per_seq 1-16, every
    page lies in exactly one rank's range and every rank has one, a
    cluster holds at most _MAX_SPLITS blocks, the ring 1 to 3 stages, and
    the plan is a function of shapes alone (it takes no lengths, so a
    decode step can be captured in a CUDA graph)."""
    import inspect

    _, heads, kv_heads, d = shape
    assert set(inspect.signature(_paged_plan).parameters) == {
        "batch", "kv_heads", "group", "head_dim", "pages_per_seq", "sms"}
    for batch in (32, 1):
        for pps in range(1, 17):
            splits, stages = _paged_plan(batch, kv_heads, heads // kv_heads,
                                         d, pps, 132)
            assert 1 <= splits <= min(_MAX_SPLITS, pps)
            assert 1 <= stages <= 3
            ranges = _split_pages(pps, splits)
            assert len(ranges) == splits
            assert all(lo < hi for lo, hi in ranges)
            pages = [p for lo, hi in ranges for p in range(lo, hi)]
            assert pages == list(range(pps))
            # blocks without the split fill the card: no split
            if batch * kv_heads * -(-d // 256) >= 132:
                assert splits == 1


def test_paged_plan_and_route_follow_the_kernel():
    """The splits each kernel gets at the path's shapes: the fixed kernel
    at the serving slice's 12 / 4 heads of 64 splits its 4 pages into 2
    ranks of 2 (128 blocks unsplit, on 132 SMs); OpenLLaMA-3B's 32 kv heads
    at B=32 fill the card unsplit; MQA 32/1 and Gemma-2B's 8/1 split phase
    2's 4 pages into 4 ranks of one page. Every call passes a plan, also
    an empty batch."""
    assert _paged_plan(32, 4, 3, 64, 4, 132) == (2, 1)
    assert _split_pages(4, 2) == [(0, 2), (2, 4)]
    assert _paged_plan(0, 4, 3, 64, 4, 132) == (4, 1)
    assert _paged_plan(32, 32, 1, 100, 16, 132) == (1, 1)
    assert _paged_plan(32, 1, 32, 128, 4, 132) == (4, 1)
    assert _paged_plan(32, 1, 8, 256, 4, 132) == (4, 1)
    # 5 splits of 16 pages would leave a rank of one page: 4 ranks of 4
    assert _paged_plan(32, 1, 32, 128, 16, 132)[0] == 4
    assert _split_pages(16, 4) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert _paged_plan(1, 1, 32, 128, 64, 132)[0] == _MAX_SPLITS
    # a tile's products are long at 128 query heads a kv head: two stages
    assert _paged_plan(32, 1, 128, 256, 4, 132) == (4, 2)
