"""Fused AdamW update with stochastic rounding to bf16.

Counterpart of :mod:`lamp_tpu.ops.fused_adamw`. The standard bf16 recipe
keeps f32 master weights (:class:`lamp_tpu_torch.optim.AdamW`);
:class:`AdamWStochastic` removes them: the update is computed in f32 and
written back to the bf16 parameter by *stochastic rounding*, which keeps
the tiny updates unbiased instead of losing them to round-to-nearest, and
saves 4 bytes per parameter of optimizer state.

``csrc/fused_adamw.cu`` (K4, replacing the JAX ``_kernel``) makes one pass
over each tensor: the moments, the bias correction, the decoupled weight
decay, the update and the rounding. One launch updates every tensor of one
dtype of an optimizer step (up to 256 tensors a launch). The wrappers take
the plain :func:`fused_adamw_update_reference` for CPU tensors only; CUDA
tensors launch the kernel or raise, and each launch adds one to
``fused_adamw_update.launches``. Both update ``param``, ``m`` and ``v`` in
place (the JAX functions return new arrays).

**The arithmetic**, in f32, each operation rounded on its own (the kernel
uses no FMA, so it and the plain version agree bit for bit)::

    m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
    p = p - ((lr (m / bc1)) / (sqrt(v / bc2) + eps) + (lr wd) p)

``bc1, bc2 = 1 - exp(f32(t) log b)`` (the JAX kernel's formula) are
computed once per step on the host in f32, as are ``lr`` and ``lr wd``.

**Rounding.** Only a bf16 parameter under ``stochastic=True`` rounds
stochastically: the low 16 bits of a random word are added to the f32 bit
pattern, which is then truncated to bf16 (``pltpu.stochastic_round``).
Other bf16 and f16 parameters round to nearest even. The random word of
element ``i`` (its flat index in the tensor) is ``h(lo32(i) ^ h(hi32(i) ^
h(seed ^ h(t))))``, with ``h`` the ``lowbias32`` hash of K8
(:mod:`lamp_tpu_torch.ops.quantization`) and ``t`` the 1-based step. It
depends on (seed, step, index) only, not on any tiling, so the kernel and
the plain version draw the same bits; it is not the TPU's per-block
stream.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .quantization import _M32, _lowbias32

__all__ = ["fused_adamw_update", "fused_adamw_update_reference",
           "AdamWStochastic"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TABLE = 256  # tensors per launch (csrc/fused_adamw.cu kMaxTensors)


def _step_scalars(step: int, lr: float, beta1: float, beta2: float,
                  weight_decay: float):
    """(lr, lr wd, bc1, bc2) in f32, as the JAX kernel computes them."""
    f32 = np.float32
    t = f32(step)
    bc1 = f32(1) - np.exp(t * f32(math.log(beta1)))
    bc2 = f32(1) - np.exp(t * f32(math.log(beta2)))
    lr32 = f32(lr)
    return lr32, lr32 * f32(weight_decay), bc1, bc2


def _random_words(seed: int, step: int, numel: int, device):
    """The 32-bit word of each flat index ``i < numel`` (module docstring),
    as int64."""
    key = _lowbias32((seed & _M32) ^ _lowbias32(step & _M32))
    i = torch.arange(numel, dtype=torch.int64, device=device)
    return _lowbias32((i & _M32) ^ _lowbias32((i >> 32) ^ key))


def _stochastic_bf16(x, words):
    """f32 ``x`` to bf16: the low 16 bits of ``words`` added to its bit
    pattern, then truncated (modulo 2^32, as the kernel's uint32 sum)."""
    bits = x.view(torch.int32).to(torch.int64) & _M32
    top = ((bits + (words & 0xFFFF)) >> 16) & 0xFFFF
    return (top - (top >> 15) * 0x10000).to(torch.int16).view(torch.bfloat16)


def fused_adamw_update_reference(param, grad, m, v, step: int, *, lr: float,
                                 beta1: float = 0.9, beta2: float = 0.999,
                                 eps: float = 1e-8, weight_decay: float = 0.0,
                                 stochastic: bool = True, seed: int = 0):
    """Plain version of K4 on one tensor; returns new (param, m, v) and
    leaves its inputs as they are. One tensor op per operation of the
    kernel, each rounded to f32 (the bias corrections divide as tensors:
    CUDA's division by a Python scalar multiplies by its reciprocal)."""
    lr32, lrwd, bc1, bc2 = _step_scalars(step, lr, beta1, beta2,
                                         weight_decay)
    dev = param.device
    g = grad.float()
    p = param.float()
    m = m * beta1 + g * (1.0 - beta1)
    v = v * beta2 + (g * (1.0 - beta2)) * g
    upd = (m / torch.tensor(float(bc1), device=dev)) * float(lr32)
    den = torch.sqrt(v / torch.tensor(float(bc2), device=dev)) + eps
    new_p = p - (upd / den + p * float(lrwd))
    if stochastic and param.dtype == torch.bfloat16:
        words = _random_words(seed, step, new_p.numel(), dev)
        out = _stochastic_bf16(new_p.reshape(-1), words).reshape(param.shape)
    else:
        out = new_p.to(param.dtype)
    return out, m, v


def _check_cuda(param, grad, m, v):
    if param.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_adamw_update kernel takes float32, bfloat16 "
                        f"or float16 parameters, got {param.dtype}")
    if grad.dtype != param.dtype or m.dtype != torch.float32 or \
            v.dtype != torch.float32:
        raise TypeError(
            f"fused_adamw_update: grad in the parameter's dtype and float32 "
            f"m, v; got {param.dtype}, {grad.dtype}, {m.dtype}, {v.dtype}")
    for t in (param, grad, m, v):
        if t.device != param.device:
            raise ValueError(f"fused_adamw_update: tensors on {t.device} and "
                             f"{param.device}")
        if t.shape != param.shape or not t.is_contiguous():
            raise ValueError("fused_adamw_update: param, grad, m and v must "
                             "be contiguous and of one shape")


def _update_many(params: Sequence[torch.Tensor], grads, ms, vs, seeds,
                 step: int, *, lr: float, beta1: float, beta2: float,
                 eps: float, weight_decay: float, stochastic: bool):
    """K4 over several tensors, in place. CPU tensors take the plain
    version one by one; CUDA tensors are grouped by dtype, one launch per
    group of up to 256 tensors."""
    cuda = [i for i, p in enumerate(params) if p.device.type == "cuda"]
    for i in cuda:
        _check_cuda(params[i], grads[i], ms[i], vs[i])
    for i, p in enumerate(params):
        if p.device.type == "cpu":
            new = fused_adamw_update_reference(
                p, grads[i], ms[i], vs[i], step, lr=lr, beta1=beta1,
                beta2=beta2, eps=eps, weight_decay=weight_decay,
                stochastic=stochastic, seed=seeds[i])
            for dst, src in zip((p, ms[i], vs[i]), new):
                dst.copy_(src)
        elif p.device.type != "cuda":
            raise ValueError(f"fused_adamw_update: unsupported device "
                             f"{p.device}")
    if not cuda:
        return
    from ._build import library

    lib = library()
    lr32, lrwd, bc1, bc2 = _step_scalars(step, lr, beta1, beta2,
                                         weight_decay)
    groups = {}
    for i in cuda:
        groups.setdefault((params[i].device, params[i].dtype), []).append(i)
    for (device, dtype), idx in groups.items():
        stream = torch.cuda.current_stream(device).cuda_stream
        for start in range(0, len(idx), _TABLE):
            chunk = idx[start:start + _TABLE]
            rows = np.array([[params[i].data_ptr(), grads[i].data_ptr(),
                              ms[i].data_ptr(), vs[i].data_ptr(),
                              params[i].numel(), seeds[i] & _M32]
                             for i in chunk], dtype=np.int64)
            rc = lib.lamp_fused_adamw(
                rows.ctypes.data, len(chunk), _KERNEL_DTYPES[dtype],
                float(lr32), float(lrwd), beta1, 1.0 - beta1, beta2,
                1.0 - beta2, float(bc1), float(bc2), eps, step & _M32,
                int(stochastic and dtype == torch.bfloat16), stream)
            if rc != 0:
                raise RuntimeError(
                    f"fused_adamw_update kernel launch failed: "
                    f"{lib.lamp_cuda_error_string(rc).decode()} ({rc})")
            fused_adamw_update.launches += 1


@torch.no_grad()
def fused_adamw_update(param, grad, m, v, step: int, *, lr: float,
                       beta1: float = 0.9, beta2: float = 0.999,
                       eps: float = 1e-8, weight_decay: float = 0.0,
                       stochastic: bool = True, seed: int = 0):
    """Update ONE parameter tensor in place; returns ``(param, m, v)``.

    ``m``/``v`` are f32 with the parameter's shape, ``grad`` is in its
    dtype, ``step`` is the 1-based step count. A bf16 parameter rounds
    stochastically unless ``stochastic=False``; f16 and f32 ones round to
    nearest. CPU tensors take :func:`fused_adamw_update_reference`; CUDA
    tensors (f32, bf16 or f16, contiguous) launch ``csrc/fused_adamw.cu``
    or raise."""
    _update_many([param], [grad], [m], [v], [seed], int(step), lr=lr,
                 beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, stochastic=stochastic)
    return param, m, v


# kernel launches since the last reset (a run shows the path used the kernel)
fused_adamw_update.launches = 0


class AdamWStochastic(torch.optim.Optimizer):
    """AdamW without master weights: every parameter is updated in place by
    K4, bf16 ones with stochastic rounding. State: f32 ``mt`` and ``vt``
    per parameter and the step count (saves the 4-byte master copy of
    :class:`lamp_tpu_torch.optim.AdamW`).

    ``params``: ``(name, parameter)`` pairs (``model.named_parameters()``)
    or a ``{name: parameter}`` dict; tensor ``i`` in that order draws its
    rounding bits under ``seed + i``, as the JAX optimizer does over its
    pytree leaves. Weight decay applies to every tensor; there are no tags
    and no clip. ``step(lr_factor=...)`` scales the learning rate, so
    :func:`lamp_tpu_torch.train.make_train_step` drives it as it drives
    ``AdamW``. A parameter without a gradient takes a zero gradient.
    """

    def __init__(self, params, learning_rate: float = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, seed: int = 0):
        named = list(params.items() if isinstance(params, dict) else params)
        super().__init__([p for _, p in named], dict(step=0))
        self.param_names = [name for name, _ in named]
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.seed = seed
        for _, p in named:
            self.state[p] = {
                "mt": torch.zeros_like(p, dtype=torch.float32),
                "vt": torch.zeros_like(p, dtype=torch.float32),
            }

    @property
    def params(self):
        return self.param_groups[0]["params"]

    @torch.no_grad()
    def step(self, closure=None, lr_factor: float = 1.0):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self.params
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        states = [self.state[p] for p in params]
        t = self.param_groups[0]["step"] + 1
        _update_many(params, grads, [s["mt"] for s in states],
                     [s["vt"] for s in states],
                     [self.seed + i for i in range(len(params))], t,
                     lr=self.learning_rate * lr_factor, beta1=self.beta1,
                     beta2=self.beta2, eps=self.eps,
                     weight_decay=self.weight_decay, stochastic=True)
        self.param_groups[0]["step"] = t
        return loss
