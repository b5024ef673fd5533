"""Int8 and int4 weight quantization for serving.

Counterpart of :mod:`lamp_tpu.ops.quantization`, with its names and its
layouts, so that the two packages' quantized tensors compare byte for byte:

- int8: per-channel absmax values ``[K, N]`` int8 with f32 scales
  ``[1, N]`` (:func:`quantize_int8`); :func:`int8_matmul` quantizes x per
  row and multiplies int8 x int8 -> int32 with ``torch._int_mm``, which is
  left to the library as the JAX package leaves it to XLA.
- int4: group-wise absmax, nibble-packed uint8 ``[K/2, N]`` in the
  HALF-SPLIT layout (packed row i holds row i in the low nibble and row
  i + K/2 in the high nibble, offset-binary v + 8) with f32 scales
  ``[K/g, N]`` (:func:`quantize_int4`). :func:`int4_matmul` multiplies by
  the packed weight without unpacking it in device memory.

Two hand-written CUDA kernels replace the JAX package's Pallas kernels:

- ``csrc/int4_matmul.cu`` (K7, ``_int4_mm_kernel``) behind
  :func:`int4_matmul`, with the plain :func:`int4_matmul_reference`;
- ``csrc/quantize_int8.cu`` (K8, ``_quant_kernel``) behind
  :func:`quantize_int8_stochastic`, with the plain
  :func:`quantize_int8_stochastic_reference`.

Each wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises, and counts its launches in
``<wrapper>.launches``.

**K7 at every shape.** The JAX :func:`int4_matmul` sends shapes its TPU
kernel does not tile (N % 128, group < 32, other dtypes) to a
dequantize-then-dot fallback that rounds the weight to x's dtype. The port
computes the kernel's arithmetic at every shape instead: x in its own dtype
times the exact integer codes, summed in f32 per K-group, each group's
partial product scaled by its f32 scale row, the result in f32 and then cast
to ``out_dtype``. The CUDA kernels take every M >= 1, every N and every
group size and mask the ragged edges. Groups of a multiple of 16 run on
tensor cores, in bf16 and f32 x alike: ``int4_mm_decode`` at M <= 64,
``int4_mm_tc`` on wgmma above where N % 4 == 0 and the packed weight is
4-byte aligned. Every other call (groups not a multiple of 16; M > 64 with
N % 4 != 0 or a packed weight not 4-byte aligned) runs ``int4_mm_scalar``,
register-tiled FFMA.

**f32 x on the tensor cores.** An f32 value splits exactly into three bf16
parts (:func:`split_f32_to_bf16x3`): ``hi = bf16(x)``, ``r = x - hi``
(exact), ``mid = bf16(r)``, ``lo = bf16(r - mid)``; three 8-bit
significands cover f32's 24, so ``hi + mid + lo == x`` bit for bit. The
kernels split x this way inside the kernel and add the three products with
the exact integer codes into the same f32 accumulators: the plain
version's f32 arithmetic, at three bf16 products a weight fragment. A
stated difference: where ``lo`` falls below bf16's normal range (``|x|``
below about 2^-110) it keeps fewer bits, and above bf16's largest finite
value (about 3.39e38) ``hi`` rounds to inf, so those x do not split
exactly.

**K8's random bits.** ``pltpu.prng_random_bits`` has no counterpart, so the
stream is NOT the TPU's: element ``i`` (its flat index in ``[M, K]``) draws
the 32-bit word ``h(lo32(i) ^ h(seed ^ h(hi32(i))))``, where ``h`` is the
``lowbias32`` integer hash (``x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15;
x *= 0x846ca68b; x ^= x >> 16``, mod 2^32). It depends on the seed and the
index alone, not on any tiling (the JAX stream reseeds per 1024-row block),
so the kernel and its plain version give the same values bit for bit.
"""

from __future__ import annotations

import copy
import functools
from typing import Optional, Tuple

import torch
from torch import nn

from .attention import aligned16

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "int8_matmul",
    "QuantizedLinear",
    "quantize_model",
    "quantize_int8_stochastic",
    "quantize_int8_stochastic_reference",
    "int4_group_size",
    "quantize_int4",
    "dequantize_int4",
    "int4_matmul",
    "int4_matmul_reference",
    "split_f32_to_bf16x3",
    "QuantizedLinearInt4",
]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


def _div(a, value: float):
    """``a / value`` as a true division on every device. A CUDA division by
    a Python scalar multiplies by its reciprocal instead, which can differ
    in the last bit; K8's kernel is held to its plain version bit for bit."""
    return a / torch.full_like(a, value)


def quantize_int8(x, *, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (along ``axis``) absmax int8 quantization.

    Returns (values int8, scales f32) with x ~= values * scales; ties round
    to even, as ``jnp.round`` does."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = _div(torch.clamp(absmax, min=1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def dequantize_int8(values, scales, dtype=torch.float32):
    return (values.float() * scales).to(dtype)


# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_INT_MM_MIN_ROWS = 17


def int_mm(xq, w_q):
    """``torch._int_mm(xq, w_q)``, int8 [M, K] times int8 [K, N] summed in
    int32, for any M: fewer than 17 rows are padded with zero rows to meet
    its shape constraints on CUDA (the padding rows are dropped)."""
    m, k = xq.shape
    if m < _INT_MM_MIN_ROWS:
        rows = -(-_INT_MM_MIN_ROWS // 8) * 8
        xq = torch.cat([xq, xq.new_zeros((rows - m, k))])
    return torch._int_mm(xq, w_q)[:m]


def int8_matmul(x, w_q, w_scale, *, out_dtype=None):
    """y = x @ dequant(w): x is quantized per row, the product of the int8
    values accumulates in int32 (``torch._int_mm``), and both scales are
    applied to the int32 result, in that order.

    x: [..., K] float; w_q: [K, N] int8; w_scale: [1, N] f32. Fewer than 17
    rows are padded with zero rows to meet ``torch._int_mm``'s shape
    constraints on CUDA (the padding rows are dropped from the result)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w_q.shape[1]
    if x.device.type == "cuda" and (k % 8 or n % 8):
        raise ValueError(
            f"int8_matmul: torch._int_mm on CUDA takes K and N multiples of "
            f"8, got K={k}, N={n}")
    xq, x_scale = quantize_int8(x.reshape(-1, k), axis=1)  # per row
    y = int_mm(xq, w_q).float() * x_scale * w_scale
    return y.reshape(*lead, n).to(out_dtype)


class QuantizedLinear(nn.Module):
    """Serving replacement for :class:`~lamp_tpu_torch.nn.Linear` with int8
    weights in the JAX layout: ``w_q`` [in, out] int8 and ``w_scale``
    [1, out] f32 buffers; the bias stays a float parameter."""

    __tags__ = {"w_q": "QuantizedLinear.weight",
                "bias": "QuantizedLinear.bias"}

    def __init__(self, w_q, w_scale, bias=None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.bias = None if bias is None else nn.Parameter(bias)

    @staticmethod
    def from_linear(linear) -> "QuantizedLinear":
        # the port's Linear.weight is [out, in]: quantize its transpose
        q, scale = quantize_int8(linear.weight.detach().T, axis=0)
        bias = None if linear.bias is None else linear.bias.detach().clone()
        return QuantizedLinear(q, scale, bias)

    def forward(self, x):
        y = int8_matmul(x, self.w_q, self.w_scale)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def quantize_model(model, *, bits: int = 8, group_size: int = 128):
    """A copy of ``model`` with every :class:`~lamp_tpu_torch.nn.Linear`
    replaced by its quantized equivalent (``bits=8``: per-channel int8;
    ``bits=4``: nibble-packed group-wise int4). ``model`` is left as it
    was, as the JAX version returns a new tree."""
    from ..nn.layers import Linear

    if bits not in (4, 8):
        raise ValueError("bits must be 4 or 8")

    def swap(linear):
        if bits == 4:
            return QuantizedLinearInt4.from_linear(linear, group_size)
        return QuantizedLinear.from_linear(linear)

    if isinstance(model, Linear):
        return swap(model)
    model = copy.deepcopy(model)
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, Linear):
                setattr(parent, name, swap(child))
    return model


# ---------------------------------------------------------------------------
# K8: per-row int8 quantization with stochastic rounding
# ---------------------------------------------------------------------------


def _mul32(a, c: int):
    """(a * c) mod 2^32 for int64 tensors of uint32 values, c taken in two
    16-bit halves so that no product leaves int64."""
    return ((((a * (c >> 16)) & 0xFFFF) << 16) + a * (c & 0xFFFF)) & _M32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _random_words(seed: int, numel: int, device, start: int = 0):
    """The 32-bit word of each flat index ``start <= i < start + numel``
    (module docstring), as int64."""
    i = torch.arange(start, start + numel, dtype=torch.int64, device=device)
    key = _lowbias32((seed & _M32) ^ _lowbias32(i >> 32))
    return _lowbias32((i & _M32) ^ key)


def quantize_int8_stochastic_reference(x, *, seed: int = 0):
    """Plain version of :func:`quantize_int8_stochastic`: per-row absmax
    scale (``quantize_int8(x, axis=1)``'s), then floor plus Bernoulli(frac),
    ``u`` from the top 24 bits of the element's random word and rounding up
    where ``u < frac``, as the JAX kernel does."""
    m, k = x.shape
    xf = x.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    scale = _div(torch.clamp(absmax, min=1e-8), 127.0)
    scaled = torch.clamp(xf / scale, -127.0, 127.0)
    words = _random_words(seed, m * k, x.device).reshape(m, k)
    u = (words >> 8).float() * (1.0 / (1 << 24))
    floor = torch.floor(scaled)
    rounded = floor + (u < (scaled - floor)).float()
    return rounded.to(torch.int8), scale


def quantize_int8_stochastic(x, *, seed: int = 0):
    """Per-row int8 quantization with stochastic rounding.

    x: [M, K] float -> (values int8 [M, K], scales f32 [M, 1]). CPU tensors
    take :func:`quantize_int8_stochastic_reference`; CUDA tensors (f32 or
    bf16, contiguous) launch ``csrc/quantize_int8.cu`` or raise, and each
    launch adds one to ``quantize_int8_stochastic.launches``."""
    if x.dim() != 2:
        raise ValueError(f"quantize_int8_stochastic: x must be [M, K], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_stochastic_reference(x, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8_stochastic: unsupported device "
                         f"{x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"quantize_int8_stochastic kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8_stochastic: x must be contiguous")
    # csrc/quantize_int8.cu replaces lamp_tpu's _quant_kernel: one warp per
    # row, held in registers, bound by the bytes of x read and of the int8
    # values written and close to its instructions an element
    from ._build import library

    lib = library()
    m, k = x.shape
    vals = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    rc = lib.lamp_quantize_int8_stochastic(
        x.data_ptr(), vals.data_ptr(), scales.data_ptr(), m, k,
        seed & _M32, _KERNEL_DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, "quantize_int8_stochastic")
    quantize_int8_stochastic.launches += 1
    return vals, scales


# kernel launches since the last reset (a run shows the path used the kernel)
quantize_int8_stochastic.launches = 0


# ---------------------------------------------------------------------------
# Int4 weight-only quantization (decode reads the weights once per token, so
# nibble-packed weights cut its weight bytes 4x against bf16)
# ---------------------------------------------------------------------------


def int4_group_size(k: int, preferred: int = 128) -> int:
    """Largest group size <= ``preferred`` dividing both K and K/2 (the
    half-split packing constraint)."""
    if k % 2:
        raise ValueError("odd input dim cannot be nibble-packed")
    g = preferred
    while g > 1 and (k % g or (k // 2) % g):
        g //= 2
    return g


def quantize_int4(w, *, group_size: int = 128):
    """Group-wise absmax int4 quantization of a weight matrix ``w`` [K, N].

    Returns (packed uint8 [K/2, N], scales f32 [K/group_size, N]) in the
    half-split, offset-binary layout of the module docstring. K/2 must be a
    multiple of ``group_size`` so that no group straddles the half."""
    k, n = w.shape
    if k % 2:
        raise ValueError("K must be even for nibble packing")
    if k % group_size or (k // 2) % group_size:
        raise ValueError(
            f"K/2={k // 2} not divisible by group_size={group_size}")
    wf = w.float().reshape(k // group_size, group_size, n)
    absmax = wf.abs().amax(dim=1, keepdim=True)
    scales = _div(torch.clamp(absmax, min=1e-8), 7.0)
    q = torch.clamp(torch.round(wf / scales), -8, 7).to(torch.int8)
    u = (q.reshape(k, n) + 8).to(torch.uint8)
    half = k // 2
    packed = u[:half] | (u[half:] << 4)
    return packed.contiguous(), scales[:, 0, :].contiguous()


def dequantize_int4(packed, scales, *, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_int4` -> [K, N] ``dtype``."""
    k = 2 * packed.shape[0]
    group_size = k // scales.shape[0]
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    vals = torch.cat([lo, hi]).float()
    s = scales.float().repeat_interleave(group_size, dim=0)
    return (vals * s).to(dtype)


def _int4_shapes(x, w_packed, w_scales):
    """(K, N, group size), or raise on shapes that do not fit together."""
    k2, n = w_packed.shape
    k = 2 * k2
    if w_packed.dtype != torch.uint8 or w_scales.dim() != 2 or \
            w_scales.shape[1] != n or k % w_scales.shape[0]:
        raise ValueError(
            f"int4_matmul: packed uint8 [K/2, N] and scales [K/g, N], got "
            f"{w_packed.dtype} {tuple(w_packed.shape)} and "
            f"{tuple(w_scales.shape)}")
    g = k // w_scales.shape[0]
    if k2 % g:
        raise ValueError(f"int4_matmul: group {g} straddles the half K/2={k2}")
    if x.shape[-1] != k:
        raise ValueError(f"int4_matmul: x has {x.shape[-1]} features, the "
                         f"packed weight {k}")
    return k, n, g


def int4_matmul_reference(x2, w_packed, w_scales):
    """Plain version of K7: x2 [M, K] @ dequant(w) -> [M, N] f32, with the
    kernel's arithmetic: per K-group, x (exactly upcast from its dtype)
    times the integer codes summed in f32, that partial product scaled by
    the group's f32 scale row (low nibbles: row k, high nibbles: row
    k + K/(2g)), and the groups summed in order."""
    k, n, g = _int4_shapes(x2, w_packed, w_scales)
    k2 = k // 2
    n_kp = k2 // g
    codes = w_packed.to(torch.int32)
    lo = ((codes & 0xF) - 8).float()
    hi = ((codes >> 4) - 8).float()
    xf = x2.float()
    s = w_scales.float()
    out = None
    for kk in range(n_kp):
        rows = slice(kk * g, (kk + 1) * g)
        acc = (xf[:, rows] @ lo[rows]) * s[kk]
        acc = acc + (xf[:, k2 + kk * g:k2 + (kk + 1) * g] @ hi[rows]) \
            * s[kk + n_kp]
        out = acc if out is None else out + acc
    return out


def split_f32_to_bf16x3(x):
    """The exact three-way split of f32 ``x`` into bf16 parts (hi, mid, lo)
    with ``hi + mid + lo == x`` (summed in f32) bit for bit, as K7's
    kernels split f32 x on the card (``split3`` in csrc/int4_matmul.cu):
    ``hi = bf16(x)``, ``r = -(hi - x)``, ``mid = bf16(r)``, ``lo =
    bf16(-(mid - r))``. ``-(hi - x)`` equals ``x - hi`` and keeps a zero's
    sign, so -0 splits into three -0. The module docstring states where the
    split is not exact. The main path does not call this: the plain version
    of the kernels' split, for the tests."""
    x = x.float()
    hi = x.bfloat16()
    r = -(hi.float() - x)
    mid = r.bfloat16()
    return hi, mid, (-(mid.float() - r)).bfloat16()


def int4_matmul(x, w_packed, w_scales, *, out_dtype=None):
    """y = x @ dequant_int4(w), the weight staying nibble-packed.

    x: [..., K]; w_packed: [K/2, N] uint8; w_scales: [K/g, N] f32. Returns
    [..., N] in ``out_dtype`` (default x's dtype). CPU tensors take
    :func:`int4_matmul_reference`; CUDA tensors launch
    ``csrc/int4_matmul.cu`` (x f32 or bf16, out f32 or bf16) or raise, and
    each launch adds one to ``int4_matmul.launches``, and to the counter of
    its route: ``tc_launches`` (the row-tiled kernel, M > 64),
    ``f32_launches`` (f32 x on the tensor cores, either kernel),
    ``scalar_launches`` (the scalar-route kernel). x may have any
    layout: a non-contiguous or misaligned x is copied to a fresh
    contiguous tensor first. The packed weight and its scales, which the
    caller keeps, must be contiguous: the wrapper raises otherwise."""
    out_dtype = out_dtype or x.dtype
    k, n, g = _int4_shapes(x, w_packed, w_scales)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        y = int4_matmul_reference(x2, w_packed, w_scales)
        return y.reshape(*lead, n).to(out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES or \
            w_scales.dtype != torch.float32:
        raise TypeError(
            f"int4_matmul kernel takes float32 or bfloat16 x and out and "
            f"float32 scales, got {x.dtype}, {out_dtype} and {w_scales.dtype}")
    for t in (w_packed, w_scales):
        if t.device != x.device:
            raise ValueError(f"int4_matmul: tensors on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("int4_matmul: weights must be contiguous")
    x2 = aligned16(x2)
    # csrc/int4_matmul.cu replaces lamp_tpu's _int4_mm_kernel. It is bound
    # by the packed weight bytes (K*N/2) at decode's rows and by its
    # products at an LM forward's; each packed byte feeds both halves'
    # products.
    from ._build import library

    lib = library()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    plan = _route_plan(m, n, k // 2, g, x.element_size(),
                       w_packed.data_ptr() % 4 == 0, x.device)
    rc = lib.lamp_int4_matmul(
        x2.data_ptr(), w_packed.data_ptr(), w_scales.data_ptr(),
        out.data_ptr(), m, k, n, g, _KERNEL_DTYPES[x.dtype],
        _KERNEL_DTYPES[out_dtype], *plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, "int4_matmul")
    int4_matmul.launches += 1
    if not plan[0]:
        int4_matmul.scalar_launches += 1
    else:
        int4_matmul.tc_launches += m > _DECODE_ROWS
        int4_matmul.f32_launches += x.dtype == torch.float32
    return out.reshape(*lead, n)


# kernel launches since the last reset (a run shows the path used the
# kernel): every route's, the row-tiled kernel's (int4_mm_tc), f32 x's on
# the tensor cores (int4_mm_decode or int4_mm_tc) and the scalar-route
# kernel's (int4_mm_scalar)
int4_matmul.launches = 0
int4_matmul.tc_launches = 0
int4_matmul.f32_launches = 0
int4_matmul.scalar_launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# K7's decode kernel (csrc/int4_matmul.cu, int4_mm_decode) takes M <= 64
# rows of bf16 or f32 x; each plan it is given stays within a block's 227
# KB of shared memory, and a stage of a round within _DECODE_STAGE_BYTES,
# so that two blocks of one round each fit on an SM (the logits' 250 blocks
# of 128 columns then run in one wave; f32 x's logits, in rounds, keep
# both stages within it)
_DECODE_ROWS = 64
_DECODE_STAGE_BYTES = 112 << 10
_DECODE_WARPS = 8
_DECODE_BAR_BYTES = 128  # the mbarriers, ahead of the stages
_MAX_SMEM = 232448


def _int4_decode_smem(tile: int, mrows: int, k2: int, g: int, cluster: int,
                      round_rows: int, xs: int = 2) -> int:
    """The decode kernel's dynamic shared memory (bytes) for a plan, by the
    kernel's own arithmetic (``Layout`` in csrc/int4_matmul.cu): the
    mbarriers, then one stage (two when the longest slice takes more than
    one round) of the round's packed rows [R][tile + 16], x rows
    [2][mrows][xs (R + 8)] bytes (xs: x's element bytes, 2 for bf16, 4 for
    f32) and scale rows [2][groups][tile] f32, or the
    K parts' partial tiles [8 / (tile / 16)][mrows][tile + 4] f32 if
    larger, then in a cluster the sum's slots [cluster][ceil(mrows tile /
    4 / cluster)] float4s."""
    slice_rows = 16 * -(-(k2 // 16) // cluster)
    r = min(round_rows, slice_rows)
    groups = (r + g - 17) // g + 1
    stage = r * (tile + 16) + 2 * mrows * xs * (r + 8) + 2 * groups * tile * 4
    stages = 2 if r < slice_rows else 1
    red = (_DECODE_WARPS // (tile // 16)) * mrows * (tile + 4) * 4
    recv = cluster * -(-(mrows * tile // 4) // cluster) * 16 \
        if cluster > 1 else 0
    return _DECODE_BAR_BYTES + max(stages * stage, red) + recv


def _route_plan(m: int, n: int, k2: int, g: int, xs: int, aligned4: bool,
                device) -> Tuple[int, int, int]:
    """K7's route for a call: the tensor cores' plan (:func:`_int4_plan`)
    where ``g`` is a multiple of 16 and either M <= 64 (the decode kernel)
    or N % 4 == 0 and the packed weight is 4-byte aligned (``aligned4``;
    the row-tiled kernel), for bf16 and f32 x (``xs`` 2 or 4 bytes) alike;
    else ``(0, 0, 0)``, the scalar-route kernel."""
    if g % 16 == 0 and (m <= _DECODE_ROWS or (n % 4 == 0 and aligned4)):
        return _int4_plan(m, n, k2, g, device, xs)
    return 0, 0, 0


def _int4_plan(m: int, n: int, k2: int, g: int, device,
               xs: int = 2) -> Tuple[int, int, int]:
    """The launch plan of a tensor-core K7 call (``g`` % 16 == 0; x of
    ``xs`` bytes an element: 2 for bf16, 4 for f32, which the kernels split
    into three bf16 parts), decided here only: ``(tile, cluster,
    round_rows)`` for the decode kernel of M <= 64 rows
    (:func:`_decode_plan`), or ``(tile, cluster, rows)`` for the row-tiled
    kernel above (:func:`_tc_plan`). The kernel refuses a plan that it
    cannot run."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if m > _DECODE_ROWS:
        return _tc_plan(min(m, 257), n, k2, g, _sm_count(index), xs)
    return _decode_plan(m, n, k2, g, _sm_count(index), xs)


def _even_cluster(steps: int, want: int) -> int:
    """At most ``want`` (and 8, and ``steps``) blocks splitting ``steps``
    16-row steps: the fewest that keep the longest slice as short."""
    cluster = max(1, min(8, steps, want))
    return -(-steps // -(-steps // cluster))


@functools.lru_cache(maxsize=None)
def _tc_plan(m: int, n: int, k2: int, g: int, sms: int, xs: int = 2):
    """``(tile, cluster, rows)`` of the row-tiled kernel (int4_mm_tc): a
    block is two consumer warpgroups of 64 output columns each (wgmma's M)
    over ``tile`` columns by ``rows`` x rows.

    - f32 x (``xs`` 4): 128 columns by 64 rows at every M, the warpgroups
      over 64 columns each (wgmma m64n64): a stage holds x's three bf16
      planes a half, and 64 rows are what leaves room for three stages
      beside a cluster's slots;
    - above 256 rows: 128 x 128 tiles, no split (the tiles fill the card,
      and the products bound the call; the grid is persistent);
    - 129-256 rows: 64 columns by 256 rows, the warpgroups over 128 rows
      each, so that each packed byte is read once a call;
    - 65-128 rows: 128 columns by 128 rows where the 128-column tiles are
      at least one for every two SMs (the logits), else 64 columns, the
      warpgroups over 64 rows each (wgmma m64n64);
    - cluster: at 256 rows or fewer, the blocks (<= 8) that split a tile's
      K range, aiming at a block for every two SMs (a block fills an SM's
      shared memory; clusters of 6-8 such blocks did not all fit on the
      card at once: a second wave). Ranks that split at group boundaries
      (a divisor of the half's groups) are taken where one lies within a
      factor 2 below the aim: a rank then scales whole groups, in passes
      of whole stages, and no rank waits on another's extra pass; else the
      even split of the decode plan.
    """
    if m > 256:
        return (128, 1, 64) if xs == 4 else (128, 1, 128)
    steps = k2 // 16
    if xs == 4:
        tile, rows = 128, 64
    elif m > 128:
        tile, rows = 64, 256
    else:
        rows = 128
        tile = 128 if -(-n // 128) >= sms // 2 else 64
    tiles = -(-n // tile) * -(-m // rows)
    want = max(1, min(8, steps, -(-max(1, sms // 2) // tiles)))
    n_kp = k2 // g
    aligned = max(d for d in range(1, want + 1) if n_kp % d == 0)
    cluster = aligned if 2 * aligned >= want else _even_cluster(steps, want)
    return tile, cluster, rows


@functools.lru_cache(maxsize=None)
def _decode_plan(m: int, n: int, k2: int, g: int, sms: int, xs: int = 2):
    steps = k2 // 16
    target = max(1, sms // 2)  # blocks a call aims at
    tiles64 = -(-n // 64)
    if tiles64 >= 2 * sms:
        tile = 128
    elif tiles64 * min(8, steps) >= target:
        tile = 64
    else:
        tile = 32
    cluster = _even_cluster(steps, -(-target // -(-n // tile)))
    slice_rows = 16 * -(-steps // cluster)
    mrows = 8 * -(-m // 8)
    # f32 x's stage is twice bf16's: where the blocks outnumber the SMs (the
    # logits), its two stages together stay within one bf16 stage's bytes,
    # so that two blocks still fit an SM and the grid runs in one wave
    one_wave = xs == 4 and -(-n // tile) * cluster > sms
    round_rows = slice_rows
    while round_rows > 16 and _int4_decode_smem(
            tile, mrows, k2, g, cluster, round_rows, xs) \
            - _DECODE_BAR_BYTES > _DECODE_STAGE_BYTES * (
                2 if round_rows < slice_rows and not one_wave else 1):
        round_rows -= 16
    return tile, cluster, round_rows


# the int4 entry returns this plus libcuda's CUresult when x's TMA map is
# refused (minus one: no encoder found)
_MAP_ERROR = 10000


def _raise_on(lib, rc, what):
    if rc >= _MAP_ERROR - 1:
        raise RuntimeError(
            f"{what}: libcuda refused a TMA tensor map (CUresult "
            f"{rc - _MAP_ERROR}; -1: cuTensorMapEncodeTiled not found)")
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.lamp_cuda_error_string(rc).decode()} ({rc})")


class QuantizedLinearInt4(nn.Module):
    """Serving replacement for :class:`~lamp_tpu_torch.nn.Linear` with
    nibble-packed int4 weights: ``w_packed`` [in/2, out] uint8 and
    ``w_scales`` [in/group, out] f32 buffers; the bias stays a float
    parameter."""

    __tags__ = {"w_packed": "QuantizedLinearInt4.weight",
                "bias": "QuantizedLinearInt4.bias"}

    def __init__(self, w_packed, w_scales, bias=None):
        super().__init__()
        self.register_buffer("w_packed", w_packed)
        self.register_buffer("w_scales", w_scales)
        self.bias = None if bias is None else nn.Parameter(bias)

    @staticmethod
    def from_linear(linear, group_size: int = 128) -> "QuantizedLinearInt4":
        w = linear.weight.detach().T  # [in, out], the JAX layout
        g = int4_group_size(w.shape[0], group_size)
        packed, scales = quantize_int4(w, group_size=g)
        bias = None if linear.bias is None else linear.bias.detach().clone()
        return QuantizedLinearInt4(packed, scales, bias)

    def forward(self, x):
        y = int4_matmul(x, self.w_packed, self.w_scales)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)
