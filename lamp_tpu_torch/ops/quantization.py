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
to ``out_dtype``. The CUDA kernel takes every M >= 1, every N and every
group size (tensor cores for bf16 x and groups of a multiple of 16, a
scalar loop otherwise) and masks the ragged edges.

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
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    xq, x_scale = quantize_int8(x2, axis=1)  # per row
    if m < _INT_MM_MIN_ROWS:
        rows = -(-_INT_MM_MIN_ROWS // 8) * 8
        xq = torch.cat([xq, xq.new_zeros((rows - m, k))])
    acc = torch._int_mm(xq, w_q)[:m]
    y = acc.float() * x_scale * w_scale
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


def _random_words(seed: int, numel: int, device):
    """The 32-bit word of each flat index ``i < numel`` (module docstring),
    as int64."""
    i = torch.arange(numel, dtype=torch.int64, device=device)
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
    # row, bound by the bytes of x read and of the int8 values written
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


def int4_matmul(x, w_packed, w_scales, *, out_dtype=None):
    """y = x @ dequant_int4(w), the weight staying nibble-packed.

    x: [..., K]; w_packed: [K/2, N] uint8; w_scales: [K/g, N] f32. Returns
    [..., N] in ``out_dtype`` (default x's dtype). CPU tensors take
    :func:`int4_matmul_reference`; CUDA tensors launch
    ``csrc/int4_matmul.cu`` (x f32 or bf16, out f32 or bf16) or raise, and
    each launch adds one to ``int4_matmul.launches``."""
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
    x2 = x2.contiguous()
    for t in (w_packed, w_scales):
        if t.device != x.device:
            raise ValueError(f"int4_matmul: tensors on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("int4_matmul: weights must be contiguous")
    if x2.data_ptr() % 16:
        raise ValueError("int4_matmul: x must be 16-byte aligned")
    # csrc/int4_matmul.cu replaces lamp_tpu's _int4_mm_kernel. It is bound
    # by the packed weight bytes (K*N/2) and reads each packed byte once
    # per row tile, consuming both nibbles.
    from ._build import library

    lib = library()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    plan = (_int4_plan(m, n, k // 2, g, x.device)
            if x.dtype == torch.bfloat16 and g % 16 == 0 else (0, 0, 0))
    rc = lib.lamp_int4_matmul(
        x2.data_ptr(), w_packed.data_ptr(), w_scales.data_ptr(),
        out.data_ptr(), m, k, n, g, _KERNEL_DTYPES[x.dtype],
        _KERNEL_DTYPES[out_dtype], *plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, "int4_matmul")
    int4_matmul.launches += 1
    return out.reshape(*lead, n)


# kernel launches since the last reset (a run shows the path used the kernel)
int4_matmul.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# K7's decode kernel (csrc/int4_matmul.cu, int4_mm_decode) takes M <= 64
# rows of bf16 x; each plan it is given stays within a block's 227 KB of
# shared memory, and a stage of a round within _DECODE_STAGE_BYTES, so that
# two blocks of one round each fit on an SM (the logits' 250 blocks of 128
# columns then run in one wave)
_DECODE_ROWS = 64
_DECODE_STAGE_BYTES = 112 << 10
_DECODE_WARPS = 8
_DECODE_BAR_BYTES = 128  # the mbarriers, ahead of the stages
_MAX_SMEM = 232448


def _int4_decode_smem(tile: int, mrows: int, k2: int, g: int, cluster: int,
                      round_rows: int) -> int:
    """The decode kernel's dynamic shared memory (bytes) for a plan, by the
    kernel's own arithmetic (``Layout`` in csrc/int4_matmul.cu): the
    mbarriers, then one stage (two when the longest slice takes more than
    one round) of the round's packed rows [R][tile + 16], x rows
    [2][mrows][2R + 16] bytes and scale rows [2][groups][tile] f32, or the
    K parts' partial tiles [8 / (tile / 16)][mrows][tile + 4] f32 if
    larger, then in a cluster the sum's slots [cluster][ceil(mrows tile /
    4 / cluster)] float4s."""
    slice_rows = 16 * -(-(k2 // 16) // cluster)
    r = min(round_rows, slice_rows)
    groups = (r + g - 17) // g + 1
    stage = r * (tile + 16) + 2 * mrows * (2 * r + 16) + 2 * groups * tile * 4
    stages = 2 if r < slice_rows else 1
    red = (_DECODE_WARPS // (tile // 16)) * mrows * (tile + 4) * 4
    recv = cluster * -(-(mrows * tile // 4) // cluster) * 16 \
        if cluster > 1 else 0
    return _DECODE_BAR_BYTES + max(stages * stage, red) + recv


def _int4_plan(m: int, n: int, k2: int, g: int, device) -> Tuple[int, int,
                                                                 int]:
    """The launch plan of a tensor-core K7 call (bf16 x, ``g`` % 16 == 0),
    decided here only: ``(tile, cluster, round_rows)`` for the decode
    kernel, or ``(0, 0, 0)`` for the row-tiled kernel of M > 64 rows.

    - the call aims at a block for every two SMs: on an H100 more blocks
      in more ranks cost more in the cluster sum than they save
      (PERF.md §6);
    - tile, the output columns of a block: 128 where the 64-column tiles
      are at least two per SM (the logits: x is staged once per 128
      columns), else 64 where clusters of 8 over 64-column tiles reach the
      aim, else 32;
    - cluster, the blocks (<= 8) that split a tile's K range: enough to
      reach the aim, at most one per 16-row step, then the fewest that
      keep the longest slice as short;
    - round_rows, the packed rows a block stages at once: its whole slice
      where a stage fits in _DECODE_STAGE_BYTES, else the most that do (the
      kernel then runs two stages of rounds).

    The kernel refuses a plan that it cannot run."""
    if m > _DECODE_ROWS:
        return 0, 0, 0
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _decode_plan(m, n, k2, g, _sm_count(index))


@functools.lru_cache(maxsize=None)
def _decode_plan(m: int, n: int, k2: int, g: int, sms: int):
    steps = k2 // 16
    target = max(1, sms // 2)  # blocks a call aims at
    tiles64 = -(-n // 64)
    if tiles64 >= 2 * sms:
        tile = 128
    elif tiles64 * min(8, steps) >= target:
        tile = 64
    else:
        tile = 32
    cluster = max(1, min(8, steps, -(-target // -(-n // tile))))
    cluster = -(-steps // -(-steps // cluster))
    slice_rows = 16 * -(-steps // cluster)
    mrows = 8 * -(-m // 8)
    round_rows = slice_rows
    while round_rows > 16 and _int4_decode_smem(
            tile, mrows, k2, g, cluster, round_rows) - _DECODE_BAR_BYTES > \
            _DECODE_STAGE_BYTES * (2 if round_rows < slice_rows else 1):
        round_rows -= 16
    return tile, cluster, round_rows


def _raise_on(lib, rc, what):
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
