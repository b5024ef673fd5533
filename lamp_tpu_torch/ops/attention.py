"""Attention: plain PyTorch versions and the flash-attention kernels.

Counterpart of :mod:`lamp_tpu.ops.attention`. Layout is the JAX package's:
q [B, H, Sq, D], k/v [B, H, Skv, D].

:func:`flash_attention` launches the hand-written CUDA kernels
(``csrc/flash_forward.cu``, ``csrc/flash_attention.cu``,
``csrc/flash_backward_wide.cu``, ``csrc/flash_forward_any.cu`` and
``csrc/flash_backward_any.cu``: a forward, and a backward in two kernels,
dq then dkv, at every head dim and float dtype) for CUDA tensors, and takes the plain PyTorch
:func:`flash_attention_reference` and :func:`_flash_backward_reference` for
CPU tensors only. On Hopper one kernel serves every length, so
:func:`compact_attention` is the same function under the JAX name, with the
JAX length limit, and :func:`dot_product_attention` has one kernel to route
to.

Rows with no visible key (a ``kv_lengths`` entry of 0, or rows before the
causal diagonal when Sq > Skv) give exactly 0 output and 0 gradient. The
JAX flash kernel gives 0 there only when every kv tile was skipped and the
mean of V otherwise, and :func:`mha_reference` always gives the mean of V.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["mha_reference", "flash_attention", "flash_attention_reference",
           "compact_attention", "dot_product_attention", "COMPACT_MAX_KV"]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
LANES = 128
# the JAX compact kernels' padded kv ceiling, kept as compact_attention's
# limit so that the two packages accept the same calls
COMPACT_MAX_KV = 2048

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                  torch.float64: 3}


def _segment_mask(segment_ids):
    q_ids, kv_ids = (segment_ids if isinstance(segment_ids, tuple)
                     else (segment_ids, segment_ids))
    return q_ids[:, None, :, None] == kv_ids[:, None, None, :]


def mha_reference(q, k, v, *, causal=False, sm_scale=None, mask=None,
                  window=None, segment_ids=None):
    """Attention with the whole score matrix in memory.

    q: [B, H, Sq, D], k/v: [B, H, Skv, D]. ``mask`` is an optional boolean
    tensor broadcastable to [B, H, Sq, Skv]; True = attend. ``window`` (with
    ``causal=True``) restricts each query row to the last ``window`` keys.
    ``segment_ids`` ([B, S] int, or a ``(q_ids, kv_ids)`` pair) restricts
    attention to keys in the same segment. Scores accumulate in f32; a fully
    masked row gives the uniform mean of V, as in the JAX version.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if segment_ids is not None:
        seg = _segment_mask(segment_ids)
        mask = seg if mask is None else (mask & seg)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        # align diagonals to the *end* of the kv sequence (standard
        # convention when Sq != Skv, e.g. decoding)
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = torch.where(keep, s, NEG_INF)
    elif window is not None:
        raise ValueError("window requires causal=True")
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc)).to(q.dtype)


def _visible(q, k, *, causal, window, kv_lengths, segment_ids, mask):
    """Boolean [B or 1, H or 1, Sq, Skv]: which key each query row sees.
    Composes the kernels' rules: kv limits, the causal diagonal at Skv -
    Sq, the window, equal segment ids and the mask."""
    sq, skv = q.shape[2], k.shape[2]
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        diag = rows + (skv - sq)
        keep = cols <= diag
        if window is not None:
            keep = keep & (cols > diag - window)
    keep = keep[None, None]
    if kv_lengths is not None:
        lim = kv_lengths.to(device=q.device, dtype=torch.long)
        lim = lim[:, None] if lim.dim() == 1 else lim  # [B, 1] or [B, Sq]
        keep = keep & (cols[None] < lim[:, :, None])[:, None]
    if segment_ids is not None:
        keep = keep & _segment_mask(segment_ids)
    if mask is not None:
        keep = keep & mask.to(device=q.device, dtype=torch.bool)
    return keep


def flash_attention_reference(q, k, v, *, causal=False, sm_scale=None,
                              kv_lengths=None, window=None, segment_ids=None,
                              mask=None):
    """The plain forward: ``(o, lse)`` with the whole score matrix in memory.

    The math of the JAX ``_fwd_kernel`` without tiles: f32 scores, f32
    softmax statistics, ``p`` rounded to v's dtype for ``p @ v`` with f32
    accumulation, ``o`` in q's dtype and ``lse = m + log(l)`` f32
    [B, H, Sq]; float64 inputs compute, and keep lse, in float64. Rows
    with no visible key give o = 0 and lse = -inf."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    keep = _visible(q, k, causal=causal, window=window,
                    kv_lengths=kv_lengths, segment_ids=segment_ids, mask=mask)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    s = torch.where(keep, s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == -math.inf, 0.0, m)
    p = torch.exp(s - m)                       # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc))
    o = torch.where(l == 0, 0.0, o / l)
    lse = torch.where(l == 0, -math.inf, m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _flash_backward_reference(q, k, v, o, lse, do, *, causal=False,
                              sm_scale=None, kv_lengths=None, window=None,
                              segment_ids=None, mask=None):
    """The plain backward from the saved ``lse``: ``(dq, dk, dv)``.

    The math of the JAX ``_bwd_fused_kernel`` without tiles:
    ``di = rowsum(o * do)`` in f32, ``p = exp(s - lse)``, ``p`` rounded to
    do's dtype for ``dv = p^T do`` and ``ds = p (dp - di) sm_scale`` rounded
    to q's dtype for ``dk = ds^T q`` and ``dq = ds k``, all with f32
    accumulation."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    keep = _visible(q, k, causal=causal, window=window,
                    kv_lengths=kv_lengths, segment_ids=segment_ids, mask=mask)
    di = (o.to(acc) * do.to(acc)).sum(dim=-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    p = torch.where(keep, torch.exp(s - lse[..., None].to(acc)), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).to(acc), do.to(acc))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(acc), v.to(acc))
    ds = (p * (dp - di) * sm_scale).to(q.dtype).to(acc)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def aligned16(t):
    """``t`` itself where it is contiguous and 16-byte aligned, else a
    fresh contiguous copy: the kernels read rows in 16-byte pieces. Any
    layout of an input is taken this way (a copy, not a plain version)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda(q, k, v, kv_lengths, segment_ids, mask):
    """Raise on anything the CUDA kernels do not take: integer or mixed
    dtypes, bad shapes, tensors on other devices, non-contiguous or
    misaligned q, k and v (which :func:`flash_attention` copies through
    :func:`aligned16` before this check), and segment ids or masks of the
    wrong shape or device. Every head dim and every float dtype is
    taken."""
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32, bfloat16, float16 or "
            f"float64 q, k and v of one dtype, got {q.dtype}, {k.dtype} and "
            f"{v.dtype}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
            f"{tuple(v.shape)} must be [B, H, Sq, D] and [B, H, Skv, D]")
    tensors = [q, k, v] + ([] if kv_lengths is None else [kv_lengths])
    for t in tensors:
        if t.device != q.device:
            raise ValueError(
                f"flash_attention: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash_attention: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    if kv_lengths is not None:
        if tuple(kv_lengths.shape) not in ((b,), (b, sq)):
            raise ValueError(
                f"flash_attention: kv_lengths must be [B]={b} or [B, Sq]="
                f"{(b, sq)}, got {tuple(kv_lengths.shape)}")
    if segment_ids is not None:
        q_ids, kv_ids = (segment_ids if isinstance(segment_ids, tuple)
                         else (segment_ids, segment_ids))
        for ids, n, what in ((q_ids, sq, "q"), (kv_ids, skv, "kv")):
            if tuple(ids.shape) != (b, n):
                raise ValueError(
                    f"flash_attention: {what} segment ids must be [B, S]="
                    f"{(b, n)}, got {tuple(ids.shape)}")
            if ids.device != q.device or ids.dtype.is_floating_point:
                raise ValueError(
                    f"flash_attention: segment ids must be integers on "
                    f"{q.device}, got {ids.dtype} on {ids.device}")
    if mask is not None:
        if mask.device != q.device:
            raise ValueError(
                f"flash_attention: mask on {mask.device}, q on {q.device}")
        shape = (1,) * (4 - mask.dim()) + tuple(mask.shape)
        if mask.dim() > 4 or any(n not in (1, want) for n, want in
                                 zip(shape, (b, h, sq, skv))):
            raise ValueError(
                f"flash_attention: mask {tuple(mask.shape)} does not "
                f"broadcast to [B, H, Sq, Skv]={(b, h, sq, skv)}")


class _Visibility:
    """Segment ids and the mask as the kernels read them: int32 ids
    ([B, Sq], [B, Skv]), the mask as a 4-D boolean view with its strides (0
    on a broadcast axis; never expanded in memory) and the 64 x 64 class
    map that the forward writes and the backward reads."""

    def __init__(self, q, segment_ids, mask):
        b, h, sq, _ = q.shape
        self.q_ids = self.kv_ids = self.mask = None
        self.strides = (0, 0, 0, 0)
        self.map_batch = self.map_heads = 1
        if segment_ids is not None:
            q_ids, kv_ids = (segment_ids if isinstance(segment_ids, tuple)
                             else (segment_ids, segment_ids))
            # no copy when the ids are int32 and contiguous already
            self.q_ids = q_ids.to(torch.int32).contiguous()
            self.kv_ids = kv_ids.to(torch.int32).contiguous()
            self.map_batch = b
        if mask is not None:
            m = mask if mask.dtype == torch.bool else mask != 0
            m = m[(None,) * (4 - m.dim())]
            if m.shape[3] > 1 and m.stride(3) != 1:
                m = m.contiguous()  # the un-broadcast tensor, not [B, H, ..]
            self.mask = m
            self.strides = tuple(0 if n == 1 else st
                                 for n, st in zip(m.shape, m.stride()))
            self.map_batch = max(self.map_batch, m.shape[0])
            self.map_heads = m.shape[1]
        self.tiles = None

    @property
    def active(self):
        return self.q_ids is not None or self.mask is not None

    def alloc_map(self, q, skv):
        """The class map's bytes, for the forward to write."""
        if self.active:
            sq = q.shape[2]
            n = -(-sq // 64) * -(-skv // 64)
            self.tiles = torch.empty(self.map_batch * self.map_heads * n,
                                     dtype=torch.uint8, device=q.device)

    def args(self):
        def ptr(t):
            return None if t is None else t.data_ptr()

        return (ptr(self.q_ids), ptr(self.kv_ids), ptr(self.mask),
                ptr(self.tiles), *self.strides, self.map_batch,
                self.map_heads)


# the entry points return this plus libcuda's CUresult when a TMA tensor
# map is refused (minus one: no encoder found)
_MAP_ERROR = 10000


def _raise_on(lib, rc, what):
    if rc >= _MAP_ERROR - 1:
        raise RuntimeError(
            f"flash_attention {what}: libcuda refused a TMA tensor map "
            f"(CUresult {rc - _MAP_ERROR}; -1: cuTensorMapEncodeTiled not "
            f"found)")
    if rc != 0:
        raise RuntimeError(
            f"flash_attention {what} kernel launch failed: "
            f"{lib.lamp_cuda_error_string(rc).decode()} ({rc})")


def _limit_args(kv_lengths, sq):
    """(pointer, batch stride, row stride) of the per-row kv limits."""
    if kv_lengths is None:
        return None, 0, 0
    if kv_lengths.dim() == 1:
        return kv_lengths.data_ptr(), 1, 0
    return kv_lengths.data_ptr(), sq, 1


def _cuda_shape_args(q, k, kv_lengths, causal, window, sm_scale):
    b, h, sq, d = q.shape
    lim_ptr, lim_b, lim_r = _limit_args(kv_lengths, sq)
    return lim_ptr, (b * h, h, sq, k.shape[2], d, lim_b, lim_r, int(causal),
                     0 if window is None else window, float(sm_scale),
                     _KERNEL_DTYPES[q.dtype],
                     torch.cuda.current_stream(q.device).cuda_stream)


def _fwd_cuda(q, k, v, kv_lengths, causal, sm_scale, window, vis=None):
    """The forward kernel: ``(o, lse)``. ``vis`` (a :class:`_Visibility`)
    carries segment ids and a mask; the launch writes its class map."""
    from ._build import library

    lib = library()
    vis = vis or _Visibility(q, None, None)
    vis.alloc_map(q, k.shape[2])
    o = torch.empty_like(q)
    # f32, f64 for float64 inputs
    lse = torch.empty(q.shape[:3], dtype=torch.promote_types(
        q.dtype, torch.float32), device=q.device)
    lim_ptr, shape = _cuda_shape_args(q, k, kv_lengths, causal, window,
                                      sm_scale)
    rc = lib.lamp_flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      lim_ptr, o.data_ptr(), lse.data_ptr(),
                                      *vis.args(), *shape)
    _raise_on(lib, rc, "forward")
    flash_attention.launches += 1
    return o, lse


def _bwd_cuda(q, k, v, o, lse, do, kv_lengths, causal, sm_scale, window,
              vis=None):
    """The backward kernels, dq then dkv: ``(dq, dk, dv)``. ``vis`` is the
    forward's, its class map written."""
    from ._build import library

    lib = library()
    vis = vis or _Visibility(q, None, None)
    do = aligned16(do.to(q.dtype))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # di = rowsum(o * do) in f32 (f64 for float64 inputs): written by the
    # dq kernel, read by dkv
    di = torch.empty(q.shape[:3], dtype=torch.promote_types(
        q.dtype, torch.float32), device=q.device)
    lim_ptr, shape = _cuda_shape_args(q, k, kv_lengths, causal, window,
                                      sm_scale)
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    rc = lib.lamp_flash_attention_bwd_dq(
        *qkv, o.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        lim_ptr, dq.data_ptr(), *vis.args(), *shape)
    _raise_on(lib, rc, "backward dq")
    rc = lib.lamp_flash_attention_bwd_dkv(
        *qkv, do.data_ptr(), lse.data_ptr(), di.data_ptr(), lim_ptr,
        dk.data_ptr(), dv.data_ptr(), *vis.args(), *shape)
    _raise_on(lib, rc, "backward dkv")
    flash_attention.backward_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward saves ``q, k, v, o, lse``; backward recomputes ``p`` from
    ``lse`` (the JAX ``custom_vjp`` of ``_flash``). CPU tensors take the
    plain versions, CUDA tensors the kernels, which keep the forward's
    segment ids, mask and class map for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, segment_ids, mask, causal,
                sm_scale, window):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(
                q, k, v, causal=causal, sm_scale=sm_scale,
                kv_lengths=kv_lengths, window=window,
                segment_ids=segment_ids, mask=mask)
            ctx.vis = None
        else:
            ctx.vis = _Visibility(q, segment_ids, mask)
            o, lse = _fwd_cuda(q, k, v, kv_lengths, causal, sm_scale, window,
                               ctx.vis)
        ctx.save_for_backward(q, k, v, o, lse, kv_lengths)
        ctx.segment_ids, ctx.mask = segment_ids, mask
        ctx.cfg = (causal, sm_scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lengths = ctx.saved_tensors
        causal, sm_scale, window = ctx.cfg
        if q.device.type == "cpu":
            dq, dk, dv = _flash_backward_reference(
                q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale,
                kv_lengths=kv_lengths, window=window,
                segment_ids=ctx.segment_ids, mask=ctx.mask)
        else:
            dq, dk, dv = _bwd_cuda(q, k, v, o, lse, do, kv_lengths, causal,
                                   sm_scale, window, ctx.vis)
        return dq, dk, dv, None, None, None, None, None, None


def _check_window(window, causal, skv):
    if window is None:
        return None
    if not causal:
        raise ValueError("window requires causal=True")
    window = int(window)
    if window <= 0:
        raise ValueError("window must be a positive int")
    return None if window >= skv else window  # band covers everything


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None, kv_lengths=None,
                    window: Optional[int] = None, segment_ids=None,
                    mask=None):
    """Flash attention on [B, H, S, D] tensors, differentiable.

    ``causal`` aligns the diagonal to the end of kv when Sq != Skv.
    ``kv_lengths`` ([B] or [B, Sq] int) limits the keys each row sees.
    ``window`` (requires ``causal``) keeps each row's last ``window`` keys.
    ``segment_ids`` ([B, S] int, or a ``(q_ids [B, Sq], kv_ids [B, Skv])``
    pair) keeps attention within equal ids; ``mask`` (boolean, broadcastable
    to [B, H, Sq, Skv], True = attend) keeps what it sets. Rows with no
    visible key give 0.

    CPU tensors take :func:`flash_attention_reference` and
    :func:`_flash_backward_reference`. CUDA tensors launch the kernels of
    ``csrc/flash_forward.cu``, ``csrc/flash_attention.cu``,
    ``csrc/flash_backward_wide.cu``, ``csrc/flash_forward_any.cu`` and
    ``csrc/flash_backward_any.cu`` (float32, bfloat16, float16 or
    float64, any head_dim, q, k and v of any layout: a non-contiguous or
    misaligned one is copied first; the mask is read in place through its
    strides) or raise: each
    forward launch adds one to ``flash_attention.launches`` and each
    backward (two kernels) one to ``flash_attention.backward_launches``.
    """
    window = _check_window(window, causal, k.shape[2])
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_lengths is not None:  # int32, as jnp.asarray(kv_lengths, int32)
        kv_lengths = torch.as_tensor(kv_lengths, device=q.device).to(
            torch.int32).contiguous()
    if q.device.type == "cuda":
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
        _check_cuda(q, k, v, kv_lengths, segment_ids, mask)
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, kv_lengths, segment_ids, mask,
                                 causal, float(sm_scale), window)


# kernel launches since the last reset (a run shows the path used the
# kernels): forward launches, and backward calls of two kernels each
flash_attention.launches = 0
flash_attention.backward_launches = 0


def compact_attention(q, k, v, *, causal: bool = False,
                      sm_scale: Optional[float] = None, kv_lengths=None,
                      window: Optional[int] = None, segment_ids=None,
                      mask=None):
    """The JAX package's short-sequence attention. On Hopper it is
    :func:`flash_attention` itself; like the JAX version it refuses a kv
    length that pads past ``COMPACT_MAX_KV``."""
    skv_p = -(-k.shape[2] // LANES) * LANES
    if skv_p > COMPACT_MAX_KV:
        raise ValueError(
            f"compact_attention: padded kv length {skv_p} exceeds "
            f"{COMPACT_MAX_KV}; use flash_attention")
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           kv_lengths=kv_lengths, window=window,
                           segment_ids=segment_ids, mask=mask)


_IMPLEMENTATIONS = (None, "xla", "compact", "flash")


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          sm_scale: Optional[float] = None,
                          window: Optional[int] = None, segment_ids=None,
                          implementation: Optional[str] = None):
    """The JAX router with one kernel. CUDA tensors go to
    :func:`flash_attention` at every length (``implementation`` None or
    ``"flash"``; ``"compact"`` through :func:`compact_attention`, which is
    the same kernel with the JAX path's kv-length limit), or, for
    ``"xla"``, to :func:`mha_reference`: the caller's explicit request for
    the unfused path, as in JAX. CPU tensors take :func:`mha_reference`
    whatever the value (the JAX package's XLA path off the TPU). Any other
    value raises ``ValueError`` (the JAX router would take it as
    ``"xla"``)."""
    if implementation not in _IMPLEMENTATIONS:
        raise ValueError(
            f"dot_product_attention: implementation must be one of "
            f"{_IMPLEMENTATIONS}, got {implementation!r}")
    if q.device.type == "cuda" and implementation != "xla":
        fn = compact_attention if implementation == "compact" \
            else flash_attention
        return fn(q, k, v, causal=causal, sm_scale=sm_scale, window=window,
                  segment_ids=segment_ids, mask=mask)
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                         mask=mask, window=window, segment_ids=segment_ids)
