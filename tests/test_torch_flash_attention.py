"""Port parity: lamp_tpu_torch.ops.attention.flash_attention against
lamp_tpu's flash_attention and compact_attention.

The port's wrapper on CPU tensors runs its plain versions
(``flash_attention_reference`` forward, ``_flash_backward_reference``
backward) through its ``autograd.Function``; the JAX side runs its Pallas
kernels in interpret mode with 32 x 32 tiles, so several kv tiles, skipped
tiles and ragged edges are exercised. Inputs are made with numpy; all
f32. Tolerance: atol 1e-5 on the output and on dq, dk and dv (sums of at
most ~100 f32 products of unit-scale values, taken in another order).

Rows with no visible key give 0 output and 0 gradient in the port; the
JAX kernel gives the mean of V there when one of the row's tiles ran. Such
rows are compared for being exactly 0, and their upstream gradient is set
to 0 before comparing gradients with JAX, so that only rows with a key
feed dk and dv.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu.ops import attention as jatt
from lamp_tpu_torch.ops import attention as tatt

ATOL = 1e-5

# (name, B, H, Sq, Skv, D, causal, window, lengths kind)
CASES = [
    ("causal", 2, 2, 64, 64, 32, True, None, None),
    ("noncausal", 2, 2, 64, 64, 32, False, None, None),
    ("sq_lt_skv", 1, 2, 40, 72, 32, True, None, None),
    ("noncausal_sq_gt_skv", 1, 2, 72, 40, 32, False, None, None),
    ("ragged", 2, 1, 45, 45, 32, True, None, None),
    ("lengths_1d", 3, 2, 64, 64, 32, True, None, "1d"),
    ("lengths_2d", 2, 2, 48, 48, 32, False, None, "2d"),
    ("window", 1, 2, 96, 96, 32, True, 20, None),
    ("window_lengths", 2, 1, 70, 70, 32, True, 33, "1d"),
    ("head_dim_64", 1, 2, 64, 64, 64, True, None, None),
    # the edges of the CUDA backward's 128-row and 128-key blocks
    ("edge_129", 1, 2, 129, 129, 32, True, None, None),
    ("edge_129_200", 1, 2, 129, 200, 32, True, None, None),
    ("edge_200_129_noncausal", 1, 2, 200, 129, 32, False, None, None),
    # 64 rows: with one visible key, dv of key 0 sums every row's do, and
    # the tolerance holds sums of ~100 terms
    ("edge_lengths_1", 2, 1, 64, 200, 32, False, None, "edge"),
    ("edge_window_5", 1, 2, 200, 200, 32, True, 5, None),
    ("edge_lengths_2d", 2, 1, 129, 200, 32, False, None, "2d"),
]


def _inputs(b, h, sq, skv, d, lengths, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, skv, d).astype(np.float32)
    v = rng.randn(b, h, skv, d).astype(np.float32)
    do = rng.randn(b, h, sq, d).astype(np.float32)
    lens = None
    if lengths == "1d":
        # every row keeps a key, also under the windows of CASES
        lens = rng.randint(skv - 20, skv + 1, b).astype(np.int32)
        lens[0] = skv - 3  # not a multiple of the tile
    elif lengths == "2d":
        lens = rng.randint(1, skv + 1, (b, sq)).astype(np.int32)
    elif lengths == "edge":  # one key, and one past a 128-key block
        lens = np.array([1, 129][:b], np.int32)
    elif lengths == "empty":
        # [B, Sq] limits with rows of length 0 inside 64-row blocks that
        # keep rows with keys
        lens = rng.randint(2, skv + 1, (b, sq)).astype(np.int32)
        lens[:, 10:20] = 0
    elif lengths == "halves":
        # per-row limits that differ between the 64-row halves of a
        # 128-row block: a few keys in one half, every key in the other
        rows = np.arange(sq)
        short = 2 + rows % 5
        lens = np.stack([np.where(rows % 128 < 64, short, skv),
                         np.where(rows % 128 < 64, skv, short)])[:b]
        lens = lens.astype(np.int32)
    return q, k, v, do, lens


def _jax_run(fn, q, k, v, do, **kw):
    """Output and (dq, dk, dv) of sum(fn(q, k, v) * do) under JAX."""
    args = [jnp.asarray(x) for x in (q, k, v)]

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, **kw) * jnp.asarray(do))

    out = fn(*args, **kw)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_run(fn, q, k, v, do, **kw):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts, **kw)
    out.backward(torch.tensor(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_flash(q, k, v, **kw):
    return jatt.flash_attention(q, k, v, interpret=True, block_q=32,
                                block_k=32, **kw)


def _jax_compact(q, k, v, **kw):
    return jatt.compact_attention(q, k, v, interpret=True, **kw)


def _compare(jax_fn, case):
    name, b, h, sq, skv, d, causal, window, lengths = case
    q, k, v, do, lens = _inputs(b, h, sq, skv, d, lengths)
    kw = dict(causal=causal, window=window)
    want, want_g = _jax_run(jax_fn, q, k, v, do, **kw, kv_lengths=None
                            if lens is None else jnp.asarray(lens))
    got, got_g = _torch_run(tatt.flash_attention, q, k, v, do, **kw,
                            kv_lengths=None if lens is None
                            else torch.from_numpy(lens))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for g, w, what in zip(got_g, want_g, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_attention_matches_jax_flash(case):
    _compare(_jax_flash, case)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_attention_matches_jax_compact(case):
    """K3: the JAX whole-tile kernels compute the same function."""
    _compare(_jax_compact, case)


def test_flash_attention_matches_jax_split_backward(monkeypatch):
    """A zero slab budget sends JAX to its split dq / dkv kernels (the
    fused kernel is the default above): the port's one backward design is
    held against both."""
    monkeypatch.setattr(jatt, "_FUSED_BWD_SLAB_BYTES", 0)
    _compare(_jax_flash, ("split", 2, 2, 70, 70, 32, True, 24, "1d"))


@pytest.mark.parametrize("lengths", ["1d", "2d"])
def test_rows_without_keys_give_zero_output_and_gradient(lengths):
    b, h, s, d = 2, 2, 48, 32
    q, k, v, do, _ = _inputs(b, h, s, s, d, None, seed=1)
    if lengths == "1d":
        lens = np.array([0, 30], np.int32)
        empty = np.zeros((b, s), bool)
        empty[0] = True
    else:
        lens = np.random.RandomState(2).randint(0, 4, (b, s)).astype(np.int32)
        empty = lens == 0
    got, got_g = _torch_run(tatt.flash_attention, q, k, v, do, causal=True,
                            kv_lengths=torch.from_numpy(lens))
    rows = np.broadcast_to(empty[:, None, :], (b, h, s))
    assert rows.any() and (got[rows] == 0).all()
    assert (got_g[0][rows] == 0).all()  # dq
    # the rows with a key against JAX, with the empty rows' gradient zeroed
    do0 = np.where(rows[..., None], 0.0, do).astype(np.float32)
    want, want_g = _jax_run(_jax_flash, q, k, v, do0, causal=True,
                            kv_lengths=jnp.asarray(lens))
    np.testing.assert_allclose(got[~rows], want[~rows], atol=ATOL, rtol=0)
    got0, got0_g = _torch_run(tatt.flash_attention, q, k, v, do0, causal=True,
                              kv_lengths=torch.from_numpy(lens))
    # the empty rows feed nothing into dk and dv
    np.testing.assert_array_equal(got_g[1], got0_g[1])
    np.testing.assert_array_equal(got_g[2], got0_g[2])
    for g0, w in zip(got0_g, want_g):
        np.testing.assert_allclose(g0, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["segment_ids", "segment_pair", "mask"])
def test_segment_ids_and_mask_match_jax_on_cpu(kind):
    b, h, s, d = 2, 2, 40, 32
    q, k, v, do, _ = _inputs(b, h, s, s, d, None, seed=3)
    rng = np.random.RandomState(4)
    if kind == "mask":
        m = rng.rand(b, 1, s, s) < 0.7
        m[:, :, :, 0] = True  # every row keeps a key
        jkw, tkw = dict(mask=jnp.asarray(m)), dict(mask=torch.from_numpy(m))
    else:
        seg = np.sort(rng.randint(0, 3, (b, s)), axis=1).astype(np.int32)
        if kind == "segment_pair":
            jkw = dict(segment_ids=(jnp.asarray(seg), jnp.asarray(seg)))
            tkw = dict(segment_ids=(torch.from_numpy(seg),
                                    torch.from_numpy(seg)))
        else:
            jkw = dict(segment_ids=jnp.asarray(seg))
            tkw = dict(segment_ids=torch.from_numpy(seg))
    want, want_g = _jax_run(_jax_flash, q, k, v, do, causal=True, **jkw)
    got, got_g = _torch_run(tatt.flash_attention, q, k, v, do, causal=True,
                            **tkw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_forward_lse_is_the_row_logsumexp():
    q, k, v, _, _ = _inputs(1, 2, 20, 30, 32, None, seed=5)
    o, lse = tatt.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(32)
    keep = np.arange(30)[None, :] <= np.arange(20)[:, None] + 10
    s = np.where(keep, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32


def test_cpu_calls_launch_no_kernel_and_cuda_checks_refuse():
    """On CPU tensors the wrapper takes its plain version and counts no
    launch. The CUDA path's checks raise on what the kernels do not take;
    they are called here on CPU tensors, which needs no card."""
    q, k, v, _, _ = _inputs(1, 1, 16, 16, 64, None)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = (tatt.flash_attention.launches,
              tatt.flash_attention.backward_launches)
    tatt.flash_attention(tq.requires_grad_(), tk, tv, causal=True).sum() \
        .backward()
    assert (tatt.flash_attention.launches,
            tatt.flash_attention.backward_launches) == before
    # segment ids, masks, every float dtype and every head dim pass the
    # checks (the kernels take all of them); integer and mixed dtypes are
    # refused
    seg = torch.zeros((1, 16), dtype=torch.int32)
    tatt._check_cuda(tq, tk, tv, None, seg,
                     torch.ones((1, 1, 16, 16), dtype=torch.bool))
    tatt._check_cuda(tq.half(), tk.half(), tv.half(), None, (seg, seg), None)
    for d in (1, 8, 12, 16, 32, 36, 40, 96, 100, 128, 160, 256, 300):
        x = torch.zeros((1, 1, 16, d))
        tatt._check_cuda(x, x, x, None, None, None)
    tatt._check_cuda(tq.double(), tk.double(), tv.double(), None, None, None)
    with pytest.raises(TypeError,
                       match="float32, bfloat16, float16 or float64"):
        tatt._check_cuda(tq.int(), tk.int(), tv.int(), None, None, None)
    with pytest.raises(TypeError, match="of one dtype"):
        tatt._check_cuda(tq.double(), tk, tv, None, None, None)
    with pytest.raises(ValueError, match="segment ids"):
        tatt._check_cuda(tq, tk, tv, None, seg[:, :8], None)
    with pytest.raises(ValueError, match="does not broadcast"):
        tatt._check_cuda(tq, tk, tv, None, None,
                         torch.ones((1, 2, 16, 16), dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        tatt._check_cuda(tq.transpose(2, 3).contiguous().transpose(2, 3),
                         tk, tv, None, None, None)
    with pytest.raises(ValueError, match="kv_lengths"):
        tatt._check_cuda(tq, tk, tv, torch.zeros(3, dtype=torch.int32),
                         None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"))


def test_window_and_compact_limits_follow_jax():
    q = torch.zeros((1, 1, 8, 32))
    with pytest.raises(ValueError, match="causal"):
        tatt.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="positive"):
        tatt.flash_attention(q, q, q, causal=True, window=0)
    long = torch.zeros((1, 1, 2049, 32))
    with pytest.raises(ValueError, match="COMPACT_MAX_KV|exceeds"):
        tatt.compact_attention(long, long, long)
    with pytest.raises(ValueError, match="exceeds"):
        jatt.compact_attention(jnp.zeros((1, 1, 2049, 32)),
                               jnp.zeros((1, 1, 2049, 32)),
                               jnp.zeros((1, 1, 2049, 32)), interpret=True)


@pytest.mark.parametrize("causal,window,segments", [
    (True, None, False), (False, None, False), (True, 7, False),
    (False, None, True)], ids=["causal", "noncausal", "window", "segments"])
def test_dot_product_attention_routes_like_jax(causal, window, segments):
    """CPU tensors take the plain path, as the JAX router does off the
    TPU."""
    q, k, v, _, _ = _inputs(1, 2, 24, 24, 32, None, seed=6)
    seg = np.repeat(np.arange(3), 8)[None].astype(np.int32) \
        if segments else None
    want = jatt.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = tatt.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# Segment ids, masks, head dims and float16 against the JAX flash kernel
# (interpret mode, 32 x 32 tiles): (name, B, H, Sq, Skv, D, causal, window,
# ids, mask, kv lengths, dtype). ids: "sorted", "pair" (q and kv ids of
# their own lengths, every q id present among the kv ids) or "unsorted";
# mask: "heads" ([B, 1, Sq, Skv]), "per_head" ([B, H, Sq, Skv]) or "one"
# ([1, 1, Sq, Skv]). Every row keeps a visible key (the rows' own key, or
# the first key of their segment), so that the JAX kernel's rows without
# one (a mean of V) do not enter.
VIS_CASES = [
    ("ids_sorted", 2, 2, 70, 70, 32, True, None, "sorted", None, None,
     np.float32),
    ("ids_pair", 2, 2, 40, 72, 32, False, None, "pair", None, None,
     np.float32),
    ("ids_unsorted", 2, 2, 64, 64, 32, True, None, "unsorted", None, None,
     np.float32),
    ("mask_heads", 2, 2, 48, 48, 32, False, None, None, "heads", None,
     np.float32),
    ("mask_per_head", 1, 3, 70, 70, 32, True, None, None, "per_head", None,
     np.float32),
    ("mask_one", 2, 2, 40, 72, 32, False, None, None, "one", None,
     np.float32),
    ("mask_ids_lengths", 2, 2, 70, 70, 32, True, None, "sorted", "heads",
     "1d", np.float32),
    ("ids_window", 1, 2, 96, 96, 32, True, 20, "sorted", None, None,
     np.float32),
    ("head_dim_16_ids", 2, 2, 48, 48, 16, True, None, "sorted", None, None,
     np.float32),
    ("head_dim_32_mask", 1, 2, 64, 64, 32, True, None, None, "per_head",
     None, np.float32),
    ("head_dim_96_ids", 1, 2, 40, 40, 96, True, None, "unsorted", None, None,
     np.float32),
    ("f16", 1, 2, 64, 64, 64, True, None, None, None, None, np.float16),
    ("f16_ids_mask", 2, 1, 48, 48, 32, True, None, "sorted", "heads", None,
     np.float16),
]
# float16: o, p and ds round to f16 (2^-11 relative) in both versions, at
# other places of the sums; values and gradients here are of unit scale
ATOL_F16 = 4e-3


def _vis_inputs(case, seed=7):
    name, b, h, sq, skv, d, causal, window, ids, mask, lengths, dtype = case
    q, k, v, do, lens = _inputs(b, h, sq, skv, d, lengths, seed=seed)
    q, k, v, do = (x.astype(dtype) for x in (q, k, v, do))
    rng = np.random.RandomState(seed + 1)
    seg = None
    if ids == "sorted":
        seg = np.sort(rng.randint(0, 3, (b, sq)), axis=1).astype(np.int32)
    elif ids == "unsorted":
        seg = rng.randint(0, 3, (b, sq)).astype(np.int32)
    elif ids == "pair":
        q_ids = np.sort(rng.randint(0, 3, (b, sq)), axis=1)
        kv_ids = np.sort(np.concatenate(
            [np.tile(np.arange(3), (b, 1)), rng.randint(0, 3, (b, skv - 3))],
            axis=1), axis=1)
        seg = (q_ids.astype(np.int32), kv_ids.astype(np.int32))
    m = None
    if mask is not None:
        shape = {"heads": (b, 1, sq, skv), "per_head": (b, h, sq, skv),
                 "one": (1, 1, sq, skv)}[mask]
        m = rng.rand(*shape) < 0.7
        if causal:  # the row's own key
            m |= np.eye(sq, skv, skv - sq, dtype=bool)
        else:
            m[..., 0] = True
        if seg is not None:  # the first key of each segment
            first = np.ones((b, skv), bool)
            first[:, 1:] = seg[:, 1:] != seg[:, :-1]
            m = m | first[:, None, None, :]
    if lens is not None and lengths not in ("halves", "empty"):
        # past the last segment's start
        lens = np.maximum(lens, skv - 8).astype(np.int32)
    return q, k, v, do, lens, seg, m




# Head dims the backward's TMA instances of 32, 64 and 128 do not hold (not
# a multiple of 8, or above 128: the CUDA path runs them in the ragged
# forward and backward, whose producers copy by cp.async, and in the
# wgmma kernels' D=192 and 256 instances), causal, windowed and
# segmented, and the wgmma forward's edges, in the VIS_CASES layout
HEAD_DIM_CASES = [
    ("d12_causal", 1, 2, 64, 64, 12, True, None, None, None, None,
     np.float32),
    ("d12_ids", 2, 1, 48, 48, 12, True, None, "sorted", None, None,
     np.float32),
    ("d100_causal", 1, 2, 64, 64, 100, True, None, None, None, None,
     np.float32),
    ("d100_window", 1, 2, 70, 70, 100, True, 20, None, None, None,
     np.float32),
    ("d100_ids", 2, 1, 48, 48, 100, True, None, "sorted", None, None,
     np.float32),
    ("d160_causal", 1, 1, 64, 64, 160, True, None, None, None, None,
     np.float32),
    ("d160_ids_window", 1, 2, 70, 70, 160, True, 24, "sorted", None, None,
     np.float32),
    ("d256_causal", 1, 1, 64, 64, 256, True, None, None, None, None,
     np.float32),
    ("d256_ids", 2, 1, 40, 40, 256, True, None, "unsorted", None, None,
     np.float32),
    ("d100_f16", 1, 2, 64, 64, 100, True, None, None, None, None,
     np.float16),
    # the wgmma forward's edges: its D=192 instance (d 136 and 192), the
    # rows of a block's two 64-row consumers seeing different key counts
    # across a 129-row edge, and d 72 in float16
    ("d136_causal", 1, 2, 64, 64, 136, True, None, None, None, None,
     np.float32),
    ("d136_ids_window", 1, 2, 70, 70, 136, True, 24, "sorted", None, None,
     np.float32),
    ("d192_causal", 1, 1, 64, 64, 192, True, None, None, None, None,
     np.float32),
    ("d192_ids_window", 1, 2, 70, 70, 192, True, 24, "sorted", None, None,
     np.float32),
    ("s129_halves", 2, 1, 129, 129, 32, True, None, None, None, "halves",
     np.float32),
    ("d72_f16", 1, 2, 64, 64, 72, True, None, None, None, None, np.float16),
    # the wgmma backward above 128 (dq_wide, dkv_wide): d 200 across a
    # 129-row edge, d 192 with [B, Sq] lengths and rows of length 0, d 256
    # with Sq != Skv, d 160 under a mask, d 256 at 65 rows with a window
    ("d200_causal_s129", 1, 1, 129, 129, 200, True, None, None, None, None,
     np.float32),
    ("d192_lengths_empty", 2, 1, 70, 70, 192, True, None, None, None,
     "empty", np.float32),
    ("d256_sq_ne_skv", 1, 1, 40, 72, 256, True, None, None, None, None,
     np.float32),
    ("d160_mask", 1, 2, 48, 48, 160, True, None, None, "heads", None,
     np.float32),
    ("d256_s65_window", 1, 1, 65, 65, 256, True, 20, None, None, None,
     np.float32),
    # the ragged head dims of the wgmma forward's cp.async producer in its
    # other instances: 4-byte pieces in D=128 (102) and D=192 (130, under
    # ids: the masked instance), and d 250 in D=256 across a 129-row edge
    ("d102_causal", 1, 2, 70, 70, 102, True, None, None, None, None,
     np.float32),
    ("d130_ids", 2, 1, 48, 48, 130, True, None, "sorted", None, None,
     np.float32),
    ("d250_causal_s129", 1, 1, 129, 129, 250, True, None, None, None, None,
     np.float32),
    # the ragged backward's tiling (the wgmma backward fed by cp.async): d
    # 100 over 129 rows whose lengths differ between a 128-row dq block's
    # halves, d 100 with Sq != Skv, an odd d (75) under a mask, d 102 with
    # rows of length 0, and d 130 (dq_wide/dkv_wide's D=192 instance) at 65
    # rows with a window
    ("d100_s129_halves", 2, 1, 129, 129, 100, True, None, None, None,
     "halves", np.float32),
    ("d100_sq_ne_skv", 1, 2, 40, 72, 100, True, None, None, None, None,
     np.float32),
    ("d75_mask", 1, 2, 48, 48, 75, True, None, None, "heads", None,
     np.float32),
    ("d102_lengths_empty", 2, 1, 70, 70, 102, True, None, None, None,
     "empty", np.float32),
    ("d130_s65_window", 1, 1, 65, 65, 130, True, 20, None, None, None,
     np.float32),
]


def _vis_compare(case, atol):
    """The port's flash attention against JAX's kernel (interpret mode) on
    one VIS_CASES case. Rows with no visible key give 0 in the port and
    the mean of a tile's values in the TPU kernel (its NEG_INF is finite):
    they must be 0 here, and the rest is compared with their output
    gradient zeroed."""
    causal, window = case[6], case[7]
    q, k, v, do, lens, seg, m = _vis_inputs(case)
    empty = None
    if lens is not None and lens.ndim == 2 and (lens == 0).any():
        empty = np.broadcast_to((lens == 0)[:, None, :], q.shape[:3])
        do = np.where(empty[..., None], 0, do).astype(do.dtype)
    jkw = dict(causal=causal, window=window)
    tkw = dict(jkw)
    if lens is not None:
        jkw["kv_lengths"] = jnp.asarray(lens)
        tkw["kv_lengths"] = torch.from_numpy(lens)
    if seg is not None:
        jkw["segment_ids"] = tuple(map(jnp.asarray, seg)) \
            if isinstance(seg, tuple) else jnp.asarray(seg)
        tkw["segment_ids"] = tuple(map(torch.from_numpy, seg)) \
            if isinstance(seg, tuple) else torch.from_numpy(seg)
    if m is not None:
        jkw["mask"], tkw["mask"] = jnp.asarray(m), torch.from_numpy(m)
    want, want_g = _jax_run(_jax_flash, q, k, v, do, **jkw)
    got, got_g = _torch_run(tatt.flash_attention, q, k, v, do, **tkw)
    rows = np.ones(q.shape[:3], bool)
    if empty is not None:
        assert (got[empty] == 0).all() and (got_g[0][empty] == 0).all()
        rows = ~empty
    np.testing.assert_allclose(got[rows].astype(np.float32),
                               want[rows].astype(np.float32), atol=atol,
                               rtol=0)
    for g, w, what in zip(got_g, want_g, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), atol=atol, rtol=0,
                                   err_msg=what)
    return q, k, v, do, tkw, got, got_g


@pytest.mark.parametrize("case", VIS_CASES + HEAD_DIM_CASES,
                         ids=[c[0] for c in VIS_CASES + HEAD_DIM_CASES])
def test_visibility_branches_match_jax(case):
    """Forward and gradients (dq, dk, dv) under segment ids, id pairs,
    unsorted ids, broadcast and per-head masks, their compositions with
    kv lengths and windows, head dims 12 to 256, and float16."""
    _vis_compare(case, ATOL_F16 if case[-1] == np.float16 else ATOL)


# float64 under JAX's x64: its kernel's dots ask for f32 results
# (preferred_element_type) even on f64 inputs, so it agrees with the
# port's float64 (computed in double throughout) at f32's tolerance,
# ATOL; the port's forward and gradients are also held to the f64
# gradients of mha_reference through autograd (every row here keeps a
# visible key) at 1e-10, which only a double computation meets.
F64_CASES = [
    ("f64_d64", 1, 2, 64, 64, 64, True, None, None, None, None, np.float64),
    ("f64_d100_ids", 2, 1, 48, 48, 100, True, None, "sorted", None, None,
     np.float64),
]


@pytest.mark.parametrize("case", F64_CASES, ids=[c[0] for c in F64_CASES])
def test_float64_matches_jax_and_computes_in_double(case):
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        q, k, v, do, tkw, got, got_g = _vis_compare(case, ATOL)
    finally:
        jax.config.update("jax_enable_x64", old)
    assert got.dtype == np.float64
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    kw = {key: val for key, val in tkw.items() if key != "kv_lengths"}
    out = tatt.mha_reference(*ts, **kw)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(got, out.detach().numpy(), atol=1e-10, rtol=0)
    for g, t, what in zip(got_g, ts, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, t.grad.numpy(), atol=1e-10, rtol=0,
                                   err_msg=what)


# CPU parity of the plain backward (flash_attention_reference and
# _flash_backward_reference, which flash_attention takes on CPU tensors)
# at the head dims and lengths where the CUDA backward for float32 and
# float64 (dq_any, dkv_any) changes its tiling: 64-row blocks, 64-, 32- or
# 16-row tiles, instances of 32, 64 and 128 columns, 128-column parts above
# 128. In the VIS_CASES layout without the dtype: head dims 8, 100, 136 and
# 320, Sq != Skv, kv lengths that are not a multiple of 64, segment ids and
# a mask. These cases cannot see a fault of the kernels themselves: those
# are held at the same edges on the card by chip_smoke.py's
# check_any_backward.
ANY_CASES = [
    ("d8_lengths", 2, 2, 70, 130, 8, True, None, None, None, "1d"),
    ("d100_ids", 2, 1, 70, 70, 100, True, None, "sorted", None, None),
    ("d136_mask", 1, 2, 48, 100, 136, True, None, None, "heads", None),
    ("d320_lengths", 1, 2, 40, 72, 320, False, None, None, None, "1d"),
    ("d320_pair", 2, 1, 40, 72, 320, False, None, "pair", None, None),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ANY_CASES, ids=[c[0] for c in ANY_CASES])
def test_any_backward_edges_match_jax(case, dtype):
    """Forward and gradients against JAX's at ATOL (in float64 under x64,
    whose dots ask for f32 results); float64 also against mha_reference's
    gradients in double at 1e-10, the kv lengths given to it as a mask."""
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        q, k, v, do, tkw, got, got_g = _vis_compare(case + (dtype,), ATOL)
    finally:
        jax.config.update("jax_enable_x64", old)
    assert got.dtype == dtype
    if dtype != np.float64:
        return
    kw = {key: val for key, val in tkw.items() if key != "kv_lengths"}
    if "kv_lengths" in tkw:
        keys = torch.arange(k.shape[2])
        keep = keys[None, None, None, :] < tkw["kv_lengths"][:, None, None,
                                                             None]
        kw["mask"] = keep if "mask" not in kw else kw["mask"] & keep
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tatt.mha_reference(*ts, **kw)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(got, out.detach().numpy(), atol=1e-10, rtol=0)
    for g, t, what in zip(got_g, ts, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, t.grad.numpy(), atol=1e-10, rtol=0,
                                   err_msg=what)


# The forward for float32 and float64 (fwd_any on the card) at the edges
# where the CUDA kernel changes its tiling or visibility: rows that cut its
# 64-row blocks, rows with no visible key inside a block with visible rows,
# Sq = 1, a window, and head dims 12, 129 and 257 (an instance of 32
# columns, and 128-column parts above 128). In the CASES layout; lengths
# "zeros" gives [B, Sq] kv lengths with rows 3-8 at 0. On the CPU the port
# takes its plain forward (flash_attention_reference), so these cases hold
# that plain version, o and lse, against JAX's forward; the kernel's own
# edges are held only on the card, by chip_smoke.py's check_any_forward.
ANY_FWD_CASES = [
    ("rows_65", 1, 2, 65, 100, 32, True, None, None),
    ("rows_129_noncausal", 1, 2, 129, 70, 16, False, None, None),
    ("zero_rows", 2, 2, 70, 90, 32, True, None, "zeros"),
    ("sq_1", 2, 2, 1, 75, 32, True, None, None),
    ("window", 1, 2, 96, 96, 32, True, 20, None),
    ("d12", 1, 2, 40, 50, 12, True, None, None),
    ("d129_lengths", 2, 1, 40, 50, 129, True, None, "1d"),
    ("d257", 1, 1, 33, 40, 257, False, None, None),
]


def _jax_forward(q, k, v, causal, window, lens):
    """o and lse of JAX's forward kernel (``_fwd``, in interpret mode with
    32 x 32 tiles), on the padded operands that ``flash_attention`` gives
    it."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if window is not None and window >= skv:
        window = None
    bq, bk = min(32, -(-sq // 8) * 8), min(32, -(-skv // 8) * 8)
    sq_p, skv_p = -(-sq // bq) * bq, -(-skv // bk) * bk

    def rows(x, n, n_p):
        return jnp.pad(jnp.asarray(x).reshape(b * h, n, d),
                       ((0, 0), (0, n_p - n), (0, 0)))

    limits = None
    if lens is not None:
        limits = jnp.asarray(lens, jnp.int32)
        if limits.ndim == 1:
            limits = jnp.broadcast_to(limits[:, None], (b, sq))
        limits = jnp.pad(limits, ((0, 0), (0, sq_p - sq)))[:, None, :]
    o, lse = jatt._fwd(rows(q, sq, sq_p), rows(k, skv, skv_p),
                       rows(v, skv, skv_p), limits, None, None, None,
                       1.0 / math.sqrt(d), causal, bq, bk, skv,
                       skv - sq if causal else 0, h, True, window=window)
    return (np.asarray(o)[:, :sq].reshape(b, h, sq, d),
            np.asarray(lse)[:, :sq].reshape(b, h, sq))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ANY_FWD_CASES,
                         ids=[c[0] for c in ANY_FWD_CASES])
def test_any_forward_edges_match_jax(case, dtype):
    """o and lse against JAX's forward at ATOL (in float64 under x64, whose
    dots ask for f32 results); float64 also against a double logsumexp
    and mha_reference at 1e-10. Rows with no visible key give o = 0 and
    lse = -inf in the port (JAX's kernel gives the mean of V there), and
    are compared for exactly that."""
    name, b, h, sq, skv, d, causal, window, lengths = case
    q, k, v, _, lens = _inputs(b, h, sq, skv, d,
                               None if lengths == "zeros" else lengths)
    if lengths == "zeros":
        lens = np.random.RandomState(3).randint(1, skv + 1, (b, sq))
        lens[:, 3:9] = 0
        lens = lens.astype(np.int32)
    q, k, v = (x.astype(dtype) for x in (q, k, v))
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        want, want_lse = _jax_forward(q, k, v, causal, window, lens)
    finally:
        jax.config.update("jax_enable_x64", old)
    tlens = None if lens is None else torch.from_numpy(lens)
    got, got_lse = (x.numpy() for x in tatt.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        kv_lengths=tlens))
    assert got.dtype == dtype and got_lse.dtype == dtype
    # the visibility in double: causal with the offset Skv - Sq, the
    # window, the kv lengths
    qpos = np.arange(sq)[:, None] + (skv - sq if causal else 0)
    kpos = np.arange(skv)[None, :]
    keep = np.ones((b, 1, sq, skv), bool)
    if causal:
        keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
    if lens is not None:
        lim = lens[:, None] if lens.ndim == 1 else lens
        keep &= (kpos[None] < lim[:, :, None])[:, None]
    keep = np.broadcast_to(keep, (b, h, sq, skv))
    rows = keep.any(-1)
    assert (got[~rows] == 0).all() and (got_lse[~rows] == -np.inf).all()
    np.testing.assert_allclose(got[rows], want[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lse[rows], want_lse[rows], atol=ATOL,
                               rtol=0)
    if dtype != np.float64:
        return
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    s = np.where(keep, s, -np.inf)
    top = np.where(rows, s.max(-1), 0.0)
    with np.errstate(divide="ignore"):  # log(0) = -inf in the empty rows
        lse = np.log(np.exp(s - top[..., None]).sum(-1)) + top
    np.testing.assert_allclose(got_lse[rows], lse[rows], atol=1e-10, rtol=0)
    ref = tatt.mha_reference(*map(torch.from_numpy, (q, k, v)),
                             mask=torch.from_numpy(keep.copy())).numpy()
    np.testing.assert_allclose(got[rows], ref[rows], atol=1e-10, rtol=0)


def test_visibility_reads_ids_and_mask_in_place():
    """The CUDA path's view of the ids and the mask: int32 contiguous ids
    are taken as they are, a broadcast mask keeps stride 0 on its size-1
    axes and is never expanded, a mask without a contiguous last axis is
    copied in its own shape, and the class map has one byte per 64 x 64
    block of each (batch, head) the ids and mask tell apart."""
    q = torch.zeros((2, 3, 100, 32))
    ids = torch.zeros((2, 100), dtype=torch.int32)
    mask = torch.ones((2, 1, 100, 100), dtype=torch.bool)
    vis = tatt._Visibility(q, ids, mask)
    assert vis.q_ids.data_ptr() == ids.data_ptr()
    assert vis.mask.data_ptr() == mask.data_ptr()
    assert vis.strides == (10000, 0, 100, 1)
    assert (vis.map_batch, vis.map_heads) == (2, 1)
    vis.alloc_map(q, 130)
    assert vis.tiles.numel() == 2 * 1 * 2 * 3
    wide = torch.ones((100, 200), dtype=torch.bool)[:, ::2]  # stride 2
    vis = tatt._Visibility(q, None, wide)
    assert vis.mask.shape == (1, 1, 100, 100) and vis.mask.stride(3) == 1
    assert vis.strides == (0, 0, 100, 1)
    assert (vis.map_batch, vis.map_heads) == (1, 1)
    per_head = torch.ones((1, 3, 100, 1), dtype=torch.bool)
    vis = tatt._Visibility(q, (ids.long(), ids.long()), per_head)
    assert vis.q_ids.dtype == torch.int32
    assert vis.strides == (0, 100, 1, 0)
    assert (vis.map_batch, vis.map_heads) == (2, 3)
    assert not tatt._Visibility(q, None, None).active
