"""Paged attention: decode-time attention over a paged KV cache.

Counterpart of :mod:`lamp_tpu.ops.paged_attention`. The KV cache of a batch
of concurrent sequences lives in fixed-size pages of one shared pool; each
sequence's page table maps its logical pages to physical ones. One query
token per sequence attends over its pages (GQA-aware: query heads are
grouped per kv head).

Layout (the JAX package's, so the two compare like with like):
  q:            [B, H, D]              one decode token per sequence
  k_pages:      [P, page, H_kv * D]    physical page pool
  v_pages:      [P, page, H_kv * D]
  page_indices: [B, pages_per_seq]     logical -> physical page table
  lengths:      [B]                    valid tokens per sequence

FUSED layout (pass ``v_pages=None``): kv_pages [P, 2, page, H_kv * D]
(index 0 = K, 1 = V).

:func:`paged_attention` launches the hand-written CUDA kernel
(``csrc/paged_attention.cu``) for CUDA tensors and takes the plain PyTorch
:func:`paged_attention_reference` for CPU tensors only.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .attention import aligned16
from .quantization import _sm_count

__all__ = ["paged_attention", "paged_attention_reference"]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# "no limit" sentinel for per-request windows (fits int32, larger than any
# real context length)
_NO_WINDOW = 0x3FFFFFFF

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
# the kernel's codes: q (and its output) in f32, bf16, f16 or f64; pools
# of q's dtype, or of either fp8 type with a 32- or 16-bit q
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                  torch.float64: 3}
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
                torch.float8_e5m2: 3, torch.float16: 4, torch.float64: 5}


def _effective_window(window, windows, b, device=None):
    """Per-row window limit [B] combining a static ``window`` with an
    optional per-request ``windows`` tensor (<=0 entries mean "no limit");
    None when neither imposes a limit."""
    if windows is None:
        if window is None:
            return None
        return torch.full((b,), window, dtype=torch.int32, device=device)
    w = torch.where(windows > 0, windows.to(torch.int32),
                    torch.full_like(windows, _NO_WINDOW, dtype=torch.int32))
    if window is not None:
        w = torch.clamp(w, max=int(window))
    return w


def paged_attention_reference(q, k_pages, v_pages, page_indices, lengths, *,
                              num_kv_heads: int,
                              sm_scale: Optional[float] = None,
                              window: Optional[int] = None,
                              windows=None,
                              append_kv=None,
                              page_offset: int = 0):
    """Plain PyTorch version: gather pages, then masked attention. Follows
    ``lamp_tpu.ops.paged_attention.paged_attention_reference`` line for line
    (see :func:`paged_attention` for the arguments). Scores and the
    probability-weighted sum accumulate in f32, as the JAX version's
    ``preferred_element_type`` does."""
    if v_pages is None:
        k_pages, v_pages = k_pages[:, 0], k_pages[:, 1]
    b, h, d = q.shape
    page = k_pages.shape[1]
    pages_per_seq = page_indices.shape[1]
    h_kv = num_kv_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if k_pages.dtype in _FP8:
        # fp8 KV cache: dequantize after the gather
        k_pages = k_pages.to(q.dtype)
        v_pages = v_pages.to(q.dtype)
    # gather: [B, pages, page, H_kv*D] -> [B, T, H_kv, D] -> [B, H_kv, T, D]
    idx = page_indices.long() + page_offset
    k = k_pages[idx].reshape(b, pages_per_seq * page, h_kv, d)
    v = v_pages[idx].reshape(b, pages_per_seq * page, h_kv, d)
    eff_lengths = lengths
    if append_kv is not None:
        new_k, new_v = append_kv
        # place the new token at key position lengths[b] (clamped into the
        # table; the engine guarantees the slot's page is allocated)
        pos_new = torch.clamp(lengths.long(), max=pages_per_seq * page - 1)
        rows = torch.arange(b, device=q.device)
        k[rows, pos_new] = new_k.reshape(b, h_kv, d).to(k.dtype)
        v[rows, pos_new] = new_v.reshape(b, h_kv, d).to(v.dtype)
        eff_lengths = lengths + 1
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhd,bhkd->bhk", q.to(acc), k.to(acc)) * sm_scale
    pos = torch.arange(pages_per_seq * page, device=q.device)[None, None, :]
    eff = eff_lengths.long()[:, None, None]
    keep = pos < eff
    w_eff = _effective_window(window, windows, b, q.device)
    if w_eff is not None:
        keep = keep & (pos >= eff - w_eff.long()[:, None, None])
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bhkd->bhd", p.to(v.dtype).to(acc), v.to(acc))
    # no valid keys -> zero output (not the meaningless uniform-softmax mean)
    o = torch.where(eff > 0, o, 0.0)
    return o.to(q.dtype)


# csrc/paged_attention.cu's kernels walk a sequence's pages over up to
# _MAX_SPLITS blocks (one thread-block cluster)
_MAX_SPLITS = 8
# the kernels' TMA maps address the pool's rows by int32 coordinates
_MAX_POOL_ROWS = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def _paged_plan(batch: int, kv_heads: int, group: int, head_dim: int,
                pages_per_seq: int, sms: int):
    """The launch plan of a paged-attention call, ``(splits, stages)``,
    decided here from shapes alone and never from ``lengths`` (a decode
    step stays capturable in a CUDA graph). Every call passes it; the C
    entry point alone picks the kernel: paged_attention_fixed (head_dim 64
    or 128, at most 8 query heads a kv head, pages of a multiple of 16
    tokens) takes 4 warps' worth of parts a split (the 8 warps of one block
    for 2, a thread-block cluster of such blocks past that) and keeps a
    ring of its own, and paged_attention_any takes both:

    - splits: how many blocks of one thread-block cluster walk a
      sequence's pages, rank r the pages [r per, (r + 1) per) with per =
      ceil(pages_per_seq / splits). Without a split the grid has batch x
      kv_heads blocks (x the 256-column chunks of a head_dim above 256); a
      call aims at one block per SM: splits reach that aim, at most
      _MAX_SPLITS (a portable cluster) and at most one page a split, then
      the fewest that keep the longest split as short;
    - stages: paged_attention_any's ring of K/V tiles in flight. One, unless
      a tile's products are long (a group of 64 or more query heads a kv
      head): on an H100 a block's second and third stages cost more in
      blocks an SM holds than their overlap gains (PERF.md §6).
    """
    base = max(1, batch * kv_heads * -(-head_dim // 256))
    splits = max(1, min(_MAX_SPLITS, pages_per_seq, -(-sms // base)))
    per = max(1, -(-pages_per_seq // splits))
    stages = 2 if group >= 64 else 1
    return -(-pages_per_seq // per), stages


def _split_pages(pages_per_seq: int, splits: int):
    """The pages [start, stop) that each rank of a plan walks (as the kernel
    computes them)."""
    per = -(-pages_per_seq // splits)
    return [(r * per, min((r + 1) * per, pages_per_seq))
            for r in range(splits)]


def _check_cuda(q, pools, page_indices, lengths, windows, append_kv):
    """Raise on anything the CUDA kernel does not take (a non-contiguous
    or misaligned q or append_kv is copied by :func:`paged_attention`
    before this check)."""
    pool = pools[0]
    if q.dtype not in _KERNEL_DTYPES or (pool.dtype != q.dtype and (
            pool.dtype not in _FP8 or q.dtype == torch.float64)):
        raise TypeError(
            f"paged_attention kernel takes float32, bfloat16, float16 or "
            f"float64 q with a pool of one dtype with it, or a 32- or 16-bit "
            f"q with a pool of an fp8 dtype, got {q.dtype} and "
            f"{pool.dtype}")
    rows = pool.numel() // max(1, pool.shape[-1])
    if rows > _MAX_POOL_ROWS:
        raise ValueError(
            f"paged_attention: the pool's {rows} rows exceed the kernel's "
            f"{_MAX_POOL_ROWS}")
    tensors = [q, *pools, page_indices, lengths]
    tensors += [] if windows is None else [windows]
    tensors += [] if append_kv is None else list(append_kv)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(
                f"paged_attention: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention: tensors must be contiguous")
    for t in [page_indices, lengths] + ([] if windows is None else [windows]):
        if t.dtype != torch.int32:
            raise TypeError(
                "paged_attention: page table, lengths and windows must be "
                f"int32, got {t.dtype}")
    if any(t.data_ptr() % 16 for t in [q, *pools]):
        raise ValueError(
            "paged_attention: q and the pools must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, page_indices, lengths, *,
                    num_kv_heads: int,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    windows=None,
                    append_kv=None,
                    page_offset: int = 0):
    """Decode attention over the paged KV pool (shapes in module docstring).
    Returns [B, H, D] in q's dtype.

    ``window`` restricts each decode token to its last ``window`` keys;
    ``windows`` adds PER-REQUEST limits, a [B] int32 tensor (<=0 entries
    mean "no per-request limit"); rows use the tighter of the two.
    ``append_kv=(new_k [B, H_kv*D], new_v [B, H_kv*D])`` injects the current
    decode token's K/V as key position ``lengths[b]`` without it being in
    the pool; ``lengths`` are then the OLD lengths and the self token is
    always visible. ``page_offset`` is added to every physical page id, so
    layer ``li`` of a layer-stacked pool ``[L*P, ...]`` is addressed with
    ``page_offset=li * P``. Rows with no valid key give 0.

    CPU tensors take :func:`paged_attention_reference`. CUDA tensors launch
    the kernel (f32, bf16, f16 or f64 q with a pool of q's dtype, or a
    32- or 16-bit q with a float8_e4m3fn or float8_e5m2 pool; any head_dim
    and any number of query heads per kv head) or raise; each launch adds
    one to ``paged_attention.launches``. q and ``append_kv`` may have any
    layout (a non-contiguous or misaligned one is copied first); the pools,
    page table, lengths and windows, which the server keeps, must be
    contiguous and the pools 16-byte aligned, or the call raises. fp8 pools
    are upcast in the kernel; the append rows stay in q's dtype.
    """
    if window is not None:
        window = int(window)
        if window <= 0:
            raise ValueError("window must be a positive int")
    b, h, d = q.shape
    fused_kv = v_pages is None
    if fused_kv:
        total_pages, two, page, fused = k_pages.shape
        if two != 2:
            raise ValueError("fused kv_pages must be [P, 2, page, fused]")
    else:
        total_pages, page, fused = k_pages.shape
        if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
            raise ValueError("k_pages and v_pages must match")
    if fused != num_kv_heads * d or h % num_kv_heads:
        raise ValueError(
            f"pool width {fused} must be num_kv_heads={num_kv_heads} x "
            f"head_dim={d}, and num_kv_heads must divide heads={h}")
    if windows is not None and windows.shape != (b,):
        raise ValueError(f"windows must be [B]={b}, got {tuple(windows.shape)}")
    if append_kv is not None:
        new_k, new_v = append_kv
        if new_k.shape != (b, fused) or new_v.shape != (b, fused):
            raise ValueError(
                f"append_kv arrays must be [B={b}, {fused}], got "
                f"{tuple(new_k.shape)} / {tuple(new_v.shape)}")
        cast = q.dtype if k_pages.dtype in _FP8 else k_pages.dtype
        append_kv = (new_k.to(cast), new_v.to(cast))
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, page_indices, lengths,
            num_kv_heads=num_kv_heads, sm_scale=sm_scale, window=window,
            windows=windows, append_kv=append_kv, page_offset=page_offset,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    # q and the appended rows may have any layout (copied where not
    # contiguous and 16-byte aligned); the pools, page table, lengths and
    # windows, which the server keeps, must already be
    q = aligned16(q)
    if append_kv is not None:
        append_kv = (aligned16(append_kv[0]), aligned16(append_kv[1]))
    _check_cuda(q, [k_pages] if fused_kv else [k_pages, v_pages],
                page_indices, lengths, windows, append_kv)
    # csrc/paged_attention.cu replaces lamp_tpu's _paged_kernel. It is bound
    # by K/V bytes read (B x live tokens x 2 x F x 2 B per layer in bf16,
    # 1 B in fp8) and reads each K/V row once per kv head, not once per
    # query head; both kernels spread a sequence's keys over warps and
    # cluster ranks by _paged_plan, and read rows inside the pool's
    # total_pages.
    from ._build import library

    lib = library()
    out = torch.empty_like(q)
    esize = k_pages.element_size()
    if fused_kv:
        k_ptr = k_pages.data_ptr()
        v_ptr = k_ptr + page * fused * esize
        page_stride = 2 * page * fused
    else:
        k_ptr, v_ptr = k_pages.data_ptr(), v_pages.data_ptr()
        page_stride = page * fused
    nk, nv = (None, None) if append_kv is None else (
        append_kv[0].data_ptr(), append_kv[1].data_ptr())
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    pages_per_seq = page_indices.shape[1]
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    splits, stages = _paged_plan(b, num_kv_heads, h // num_kv_heads, d,
                                 pages_per_seq, _sm_count(index))
    rc = lib.lamp_paged_attention(
        q.data_ptr(), k_ptr, v_ptr, nk, nv, page_indices.data_ptr(),
        lengths.data_ptr(), None if windows is None else windows.data_ptr(),
        out.data_ptr(), b, h, num_kv_heads, d, page, pages_per_seq,
        total_pages, page_stride, int(page_offset),
        0 if window is None else window,
        float(sm_scale), _KERNEL_DTYPES[q.dtype], _POOL_DTYPES[k_pages.dtype],
        splits, stages, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "paged_attention kernel launch failed: "
            f"{lib.lamp_cuda_error_string(rc).decode()} ({rc})")
    paged_attention.launches += 1
    return out


# kernel launches since the last reset (a run shows the path used the kernel)
paged_attention.launches = 0
