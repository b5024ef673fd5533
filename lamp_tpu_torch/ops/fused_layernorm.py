"""Fused LayerNorm over the last dimension, forward and backward.

Counterpart of :mod:`lamp_tpu.ops.fused_layernorm`: a library op callers
opt into (:class:`lamp_tpu_torch.nn.LayerNorm` stays one ``F.layer_norm``,
as the JAX ``nn.LayerNorm`` keeps its own lowering). Statistics are f32,
``rsqrt(var + eps)``, y in x's dtype; the backward is the analytic
gradient ``dx = rs (dyg - mean(dyg) - yhat mean(dyg yhat))`` with ``dyg =
dy w``, and dw, db summed over rows in f32.

``csrc/fused_layernorm.cu`` replaces the JAX ``_fwd_kernel`` (K5a) and
``_bwd_kernel`` (K5b). :func:`fused_layernorm` is a
``torch.autograd.Function`` whose forward saves mu and rstd (f32, [N]).
CPU tensors take the plain :func:`fused_layernorm_reference` and
:func:`fused_layernorm_backward_reference`; CUDA tensors (x f32 or bf16)
launch the kernels or raise. Each forward launch adds one to
``fused_layernorm.launches`` and each backward (a kernel and its
reduction pass) one to ``fused_layernorm.backward_launches``.

The CUDA forward reads x once and writes y: a warp a row at a time,
16-byte loads, the row held in registers up to 768 columns (bf16, 1024
without the next row in flight; f32 768) with w and b (read in their own
dtype, f32 or bf16) kept as floats across the warp's rows, the next row's
loads issued before this row's sums. The CUDA backward reads x and dy
once: a warp a row, 16-byte loads, the row held in registers up to 1024
columns (bf16; 768 in f32), each lane's dw, db partials in registers
across its rows, added in warp order, then in a fixed order over the
blocks, so two calls give the same bits. Both run on one grid
(:func:`_plan`) of blocks over contiguous bands of rows.

**Every shape takes the kernel.** The JAX op sends shapes its TPU kernel
cannot tile (D not a multiple of 128, or N not a multiple of 8) to a jnp
path; here any N and D go through the kernels. The statistics stay f32 for
every input dtype (the JAX jnp path would promote them to f64 under x64).
"""

from __future__ import annotations

from typing import Optional

import torch

from .quantization import _sm_count

__all__ = ["fused_layernorm", "fused_layernorm_reference",
           "fused_layernorm_backward_reference"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA backward's narrowest window of columns (csrc/fused_layernorm.cu
# bwd_chunks: 1024 for 16-byte bf16 loads, 768 for f32 and one value a
# load): above it, each row's m1, m2 go through the workspace
_HELD = 768


def fused_layernorm_reference(x2, weight, bias, eps: float = 1e-5):
    """Plain version of K5a on x2 [N, D]: returns (y in x2's dtype, mu
    [N] f32, rstd [N] f32), the JAX ``_fwd_kernel`` line for line in f32."""
    x = x2.float()
    mu = x.sum(dim=1, keepdim=True) / x.shape[1]
    xc = x - mu
    var = (xc * xc).sum(dim=1, keepdim=True) / x.shape[1]
    rs = torch.rsqrt(var + eps)
    y = xc * rs * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2.dtype), mu[:, 0], rs[:, 0]


def fused_layernorm_backward_reference(x2, dy2, weight, mu, rs):
    """Plain version of K5b: returns (dx in x2's dtype, dw [D] f32, db [D]
    f32), the JAX ``_bwd_kernel`` line for line in f32 (its sequential
    accumulation of dw, db over row blocks is a sum over all rows)."""
    inv_d = 1.0 / x2.shape[1]
    x = x2.float()
    dy = dy2.float()
    g = weight.float()[None, :]
    mu, rs = mu[:, None], rs[:, None]
    yhat = (x - mu) * rs
    dyg = dy * g
    m1 = dyg.sum(dim=1, keepdim=True) * inv_d
    m2 = (dyg * yhat).sum(dim=1, keepdim=True) * inv_d
    dx = (rs * (dyg - m1 - yhat * m2)).to(x2.dtype)
    return dx, (dy * yhat).sum(dim=0), dy.sum(dim=0)


def _plan(n: int, sms: int) -> int:
    """Both CUDA kernels' grid: two blocks an SM, but no more than one block
    for every 8 rows (a row for each of its warps), and at least one. Block
    b takes the contiguous rows ``_bands(n, blocks)[b]``, its warp w the
    rows w, w + 8, ... of them; the backward's dw, db partial of a block is
    one row of a workspace [2, blocks, D]. (At [3072, 768] bf16 on an H100,
    scripts/exp_layernorm_variants.py: the backward read 11.54 us a call at
    8 rows a block against 12.54 at 16, 12.03 at 32 and 16.77 at 64; the
    forward 4.84 against 5.73 at one row a warp and 4.99 at two.)"""
    return max(1, min(2 * sms, -(-n // 8)))


def _bands(n: int, blocks: int):
    """Each block's rows ``[start, end)``, as both kernels cut them."""
    return [(b * n // blocks, (b + 1) * n // blocks) for b in range(blocks)]


def _blocks(n: int, device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _plan(n, _sm_count(index))


def _param(t):
    """w or b as the forward kernel reads them: f32 or bf16 as they are
    (another dtype widened to f32, as the plain version does), contiguous."""
    return (t if t.dtype in _KERNEL_DTYPES else t.float()).contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(
            f"fused_layernorm {what} kernel launch failed: "
            f"{lib.lamp_cuda_error_string(rc).decode()} ({rc})")


def _fwd_cuda(x2, weight, bias, eps):
    from ._build import library

    lib = library()
    n, d = x2.shape
    y = torch.empty_like(x2)
    mu = torch.empty(n, dtype=torch.float32, device=x2.device)
    rs = torch.empty(n, dtype=torch.float32, device=x2.device)
    w = _param(weight)
    b = None if bias is None else _param(bias)
    rc = lib.lamp_layernorm_fwd(
        x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), mu.data_ptr(), rs.data_ptr(), n, d, eps,
        _KERNEL_DTYPES[x2.dtype], _KERNEL_DTYPES[w.dtype],
        0 if b is None else _KERNEL_DTYPES[b.dtype],
        _blocks(n, x2.device), _stream(x2))
    _raise_on(lib, rc, "forward")
    fused_layernorm.launches += 1
    return y, mu, rs


def _bwd_cuda(x2, dy2, weight, mu, rs):
    from ._build import library

    lib = library()
    n, d = x2.shape
    blocks = _blocks(n, x2.device)
    dx = torch.empty_like(x2)
    dw = torch.empty(d, dtype=torch.float32, device=x2.device)
    db = torch.empty(d, dtype=torch.float32, device=x2.device)
    # the blocks' partials, and each row's m1, m2 where a row is cut into
    # windows
    work = torch.empty(2 * blocks * d + (2 * n if d > _HELD else 0),
                       dtype=torch.float32, device=x2.device)
    w = weight.float().contiguous()
    rc = lib.lamp_layernorm_bwd(
        x2.data_ptr(), dy2.data_ptr(), w.data_ptr(), mu.data_ptr(),
        rs.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        work.data_ptr(), n, d, blocks, _KERNEL_DTYPES[x2.dtype], _stream(x2))
    _raise_on(lib, rc, "backward")
    fused_layernorm.backward_launches += 1
    return dx, dw, db


class _FusedLayerNorm(torch.autograd.Function):
    """Forward saves x, mu and rstd; backward returns dx in x's dtype and
    dw, db in the parameters' dtypes (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if x.device.type == "cpu":
            y, mu, rs = fused_layernorm_reference(x2, weight, bias, eps)
        else:
            y, mu, rs = _fwd_cuda(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, mu, rs)
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, weight, mu, rs = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).to(x2.dtype).contiguous()
        if x2.device.type == "cpu":
            dx, dw, db = fused_layernorm_backward_reference(x2, dy2, weight,
                                                            mu, rs)
        else:
            dx, dw, db = _bwd_cuda(x2, dy2, weight, mu, rs)
        dbias = db.to(ctx.bias_dtype) if ctx.has_bias else None
        return dx.reshape(dy.shape), dw.to(weight.dtype), dbias, None


def fused_layernorm(x, weight, bias: Optional[torch.Tensor] = None,
                    eps: float = 1e-5):
    """LayerNorm over the last dim with a learned scale and an optional
    bias, differentiable: ``x [..., D]``, ``weight [D]``, ``bias [D] |
    None``; y in x's dtype, statistics in f32. CPU tensors take the plain
    versions; CUDA tensors launch ``csrc/fused_layernorm.cu`` (x f32 or
    bf16, any N and D) or raise."""
    d = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.shape != (d,) or t.device != x.device):
            raise ValueError(f"fused_layernorm: {name} must be [{d}] on "
                             f"{x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if x.device.type == "cuda":
        if x.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"fused_layernorm kernel takes float32 or "
                            f"bfloat16 x, got {x.dtype}")
    elif x.device.type != "cpu":
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    return _FusedLayerNorm.apply(x, weight, bias, float(eps))


# kernel launches since the last reset (a run shows the path used the
# kernels): forward launches, and backward calls of two kernels each
fused_layernorm.launches = 0
fused_layernorm.backward_launches = 0
