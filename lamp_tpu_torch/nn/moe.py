"""Mixture-of-experts feed-forward blocks: top-k gated expert MLPs.

Counterpart of :mod:`lamp_tpu.nn.moe`: :class:`MoEMLP` (biased experts
with an activation callable) and :class:`SwiGLUMoE` (Mixtral-style SwiGLU
experts, the MLP of ``ModernLM.init(moe_experts=...)``), each with its
Switch-style ``load_balancing_loss``. The experts keep the JAX package's
stacked layout, as the LoRA factors do: gate ``w_gate`` [d, E], ``w1`` and
``w3`` [E, d, h], ``w2`` [E, h, d], ``b1`` [E, h], ``b2`` [E, d]; the
bridge carries them across untransposed.

Three dispatches, as in JAX:

- ``"dense"`` (the default): every expert computes every token, and the
  outputs are combined with the renormalized top-k gates. Exact.
- ``"sorted"``: the (token, k) slots are sorted by expert (a stable sort,
  as JAX's ``argsort``) and each expert multiplies its contiguous rows by
  one ``torch.mm`` (JAX's ``lax.ragged_dot`` grouped GEMM is an XLA op,
  not a Pallas kernel). The group sizes are read on the host once a call
  to cut the rows. Exact.
- ``"capacity"``: GShard's static-capacity dispatch over token groups of
  ``group_size`` (0: one group; a trailing group is padded with rows that
  route nowhere): every token's first choice claims its expert's capacity
  before any second choice (k-major order), and slots past the capacity
  C = ceil(top_k * tokens_per_group * capacity_factor / E) are dropped.

Every product sums in f32 (cuBLAS); a product of 16-bit inputs is rounded
once to their dtype and then taken on in f32, where the JAX einsums keep
the f32 sum (``preferred_element_type``). f32 models compute the JAX
arithmetic. ``moe_sharding_rules`` (a JAX mesh rule) waits for the port's
``parallel`` package.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from . import init as initializers

__all__ = ["MoEMLP", "SwiGLUMoE", "moe_combine", "swiglu_moe_dense"]

_DISPATCHES = ("dense", "sorted", "capacity")


def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def _dense_combine(top_vals, top_idx, num_experts, acc):
    """[T, E] combine weights: each token's top-k gates at its experts."""
    return torch.zeros((top_idx.shape[0], num_experts), dtype=acc,
                       device=top_idx.device).scatter(
        1, top_idx, top_vals.to(acc))


def _balancing(probs, num_experts, acc):
    """Switch-style objective E * sum_e frac_routed_e * mean_prob_e, with
    top-1 routing fractions."""
    frac = F.one_hot(probs.argmax(-1), num_experts).to(acc).mean(0)
    return (frac * probs.mean(0)).sum() * num_experts


def _sorted_expert_dispatch(flat, top_idx, top_vals, acc, num_experts,
                            expert_fn):
    """Dropless sorted dispatch: route each (token, k) slot to its expert's
    contiguous block of rows and run ``expert_fn(xs, group_sizes,
    slot_ids) -> [S, d]`` over the sorted rows ``xs`` [S = T * k, d]; the
    result is gate-weighted and added back in token order."""
    t, k = top_idx.shape
    ids = top_idx.reshape(-1)
    order = torch.argsort(ids, stable=True)  # ties in token order
    tok = order // k
    xs = flat.index_select(0, tok)
    group_sizes = torch.bincount(ids, minlength=num_experts)
    out = expert_fn(xs, group_sizes, ids[order])
    gates = top_vals.reshape(-1)[order].to(acc)
    return torch.zeros((t, flat.shape[1]), dtype=acc,
                       device=flat.device).index_add(
        0, tok, out.to(acc) * gates[:, None])


def _grouped_mm(xs, w, group_sizes):
    """Rows of expert e (contiguous, ``group_sizes[e]`` of them) times
    ``w[e]``: one ``torch.mm`` an expert with rows. The sizes are read on
    the host."""
    parts = torch.split(xs, group_sizes.tolist())
    out = [torch.mm(p, w[e].to(xs.dtype)) for e, p in enumerate(parts)
           if p.shape[0]]
    if not out:
        return xs.new_zeros((0, w.shape[-1]))
    return torch.cat(out)


def _one_hot(idx, n, dtype):
    """One-hot rows of ``idx`` over ``n`` classes, all zero where ``idx`` is
    out of range (as ``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _capacity_masks(top_vals, top_idx, num_experts, capacity, acc):
    """GShard dispatch and combine tensors of one token group: top_vals and
    top_idx [T, k] -> (dispatch [T, E, C] 0/1, combine [T, E, C] gates).
    Capacity positions are claimed in k-major order; slots past capacity
    are dropped (their rows are zero)."""
    t, k = top_idx.shape
    ids = top_idx.T.reshape(-1)                      # [k*T], k-major
    oh = F.one_hot(ids, num_experts)
    pos = ((torch.cumsum(oh, 0) - oh) * oh).sum(1)   # rank in its expert
    keep = (pos < capacity).reshape(k, t).T
    pos = pos.reshape(k, t).T                        # [T, k]
    disp = (_one_hot(top_idx, num_experts, acc)[..., None]
            * _one_hot(pos, capacity, acc)[:, :, None, :]
            * keep[..., None, None].to(acc))         # [T, k, E, C]
    combine = (disp * top_vals[..., None, None].to(acc)).sum(1)
    return disp.sum(1), combine


def _capacity_dispatch(flat, top_vals, top_idx, acc, num_experts,
                       capacity_factor, group_size, expert_fn):
    """Group the tokens, build the dispatch and combine tensors, run
    ``expert_fn(xs [G, E, C, d]) -> [G, E, C, d]`` on the gathered capacity
    buckets and combine back to token order. Also returns the number of
    (token, k) slots dropped, a 0-d tensor."""
    t, d = flat.shape
    k = top_idx.shape[1]
    g = max(1, -(-t // group_size)) if group_size else 1
    tg = -(-t // g)
    if g * tg != t:  # pad the trailing group with rows that route nowhere
        pad = g * tg - t
        flat = F.pad(flat, (0, 0, 0, pad))
        top_vals = F.pad(top_vals, (0, 0, 0, pad))
        top_idx = torch.cat([top_idx, top_idx.new_full((pad, k),
                                                       num_experts)])
    cap = int(max(1, math.ceil(k * tg * capacity_factor / num_experts)))
    cap = min(cap, k * tg)
    xg = flat.reshape(g, tg, d)
    vg = top_vals.reshape(g, tg, k)
    ig = top_idx.reshape(g, tg, k)
    masks = [_capacity_masks(vg[i], ig[i], num_experts + 1, cap, acc)
             for i in range(g)]
    # drop the padding pseudo-expert
    disp = torch.stack([m[0] for m in masks])[:, :, :num_experts]
    combine = torch.stack([m[1] for m in masks])[:, :, :num_experts]
    dropped = t * k - disp.sum().round().long()
    xs = torch.einsum("gtd,gtec->gecd", xg.to(acc), disp).to(flat.dtype)
    out = expert_fn(xs)
    y = torch.einsum("gecd,gtec->gtd", out.to(acc), combine)
    return y.reshape(g * tg, d)[:t], dropped


def _route(flat, w_gate, top_k, acc):
    """(gate probabilities [T, E], renormalized top-k gates [T, k], their
    experts [T, k]) of rows ``flat`` [T, d]."""
    probs = torch.softmax(torch.matmul(flat, w_gate.to(flat.dtype)).to(acc),
                          -1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
    return (probs, top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9),
            top_idx)


def moe_combine(flat, w_gate, top_k: int):
    """[T, E] combine weights of rows ``flat`` [T, d]: each row's
    renormalized top-k gate probabilities at its experts, 0 elsewhere, in
    the f32 accumulator."""
    acc = _acc(flat.dtype)
    _, top_vals, top_idx = _route(flat, w_gate, top_k, acc)
    return _dense_combine(top_vals, top_idx, w_gate.shape[1], acc)


def swiglu_moe_dense(flat, w_gate, w1, w3, w2, top_k: int):
    """A SwiGLU MoE under dense dispatch, flat [T, d] -> [T, d] in the f32
    accumulator: every expert computes every row, combined by the
    renormalized top-k gates. :class:`SwiGLUMoE`'s ``"dense"`` forward and
    the decode step of ``ModernBatchServer`` (whatever the module's
    dispatch, as in JAX) run it."""
    acc = _acc(flat.dtype)
    g = F.silu(_bmm(flat, w1).to(acc)) * _bmm(flat, w3).to(acc)
    out = torch.matmul(g.to(flat.dtype), w2.to(flat.dtype)).to(acc)
    return torch.einsum("te,etd->td", moe_combine(flat, w_gate, top_k), out)


def _bmm(x, w):
    """[T, d] times every expert's [E, d, h] -> [E, T, h] (the stacked
    weights cast to x's dtype)."""
    return torch.matmul(x, w.to(x.dtype))


def _check(top_k, num_experts, dispatch):
    if not 1 <= top_k <= num_experts:
        raise ValueError("need 1 <= top_k <= num_experts")
    if dispatch not in _DISPATCHES:
        raise ValueError("dispatch must be 'dense', 'sorted' or 'capacity'")


class _MoE(nn.Module):
    """The routing and dispatch that both expert MLPs share. A subclass
    sets its parameters (``w_gate`` [d, E] first), then calls
    :meth:`_routing`, and gives ``_dense(flat) -> [T, d]``,
    ``_experts_sorted(xs, sizes, slot_ids) -> [S, d]`` and
    ``_experts_capacity(xs [G, E, C, d]) -> [G, E, C, d]``, the last three
    in the f32 accumulator."""

    def _routing(self, top_k, dispatch, capacity_factor, group_size):
        _check(top_k, self.w_gate.shape[1], dispatch)
        self.top_k = top_k
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        self.group_size = group_size
        # the (token, k) slots that the last capacity dispatch dropped, a
        # 0-d tensor on the device (read it with int())
        self.dropped = None

    @property
    def num_experts(self) -> int:
        return self.w_gate.shape[1]

    def forward(self, x):
        """x [..., d] -> the same shape. The balancing objective is
        :meth:`load_balancing_loss`, added to a training loss apart."""
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        if self.dispatch == "dense":
            return self._dense(flat).reshape(shape).to(x.dtype)
        acc = _acc(x.dtype)
        _, top_vals, top_idx = _route(flat, self.w_gate, self.top_k, acc)
        if self.dispatch == "sorted":
            y = _sorted_expert_dispatch(flat, top_idx, top_vals, acc,
                                        self.num_experts,
                                        self._experts_sorted)
        else:
            y, self.dropped = _capacity_dispatch(
                flat, top_vals, top_idx, acc, self.num_experts,
                self.capacity_factor, self.group_size,
                self._experts_capacity)
        return y.reshape(shape).to(x.dtype)

    def load_balancing_loss(self, x):
        """Switch-style auxiliary objective E * sum_e frac_routed_e *
        mean_prob_e (top-1 routing fractions); 1.0 is perfectly balanced.
        Scale it by ~1e-2 in the training objective."""
        flat = x.reshape(-1, x.shape[-1])
        acc = _acc(x.dtype)
        probs = _route(flat, self.w_gate, self.top_k, acc)[0]
        return _balancing(probs, self.num_experts, acc)


class MoEMLP(_MoE):
    """Top-k gated expert MLP with biases: y = sum_k gate_k * Expert_k(x),
    Expert_e(x) = act(x w1[e] + b1[e]) w2[e] + b2[e]."""

    __tags__ = {"w_gate": "MoEMLP.gate", "w1": "MoEMLP.w1",
                "w2": "MoEMLP.w2", "b1": "MoEMLP.bias", "b2": "MoEMLP.bias"}

    def __init__(self, w_gate, w1, b1, w2, b2, *, top_k: int,
                 activation: Callable = None, dispatch: str = "dense",
                 capacity_factor: float = 1.25, group_size: int = 0):
        super().__init__()
        self.w_gate = nn.Parameter(w_gate)
        self.w1 = nn.Parameter(w1)
        self.b1 = nn.Parameter(b1)
        self.w2 = nn.Parameter(w2)
        self.b2 = nn.Parameter(b2)
        self._routing(top_k, dispatch, capacity_factor, group_size)
        # JAX's default, jax.nn.gelu, is the tanh form
        self.activation = activation or (
            lambda h: F.gelu(h, approximate="tanh"))

    @staticmethod
    def init(dim: int, hidden: int, num_experts: int, *, generator,
             top_k: int = 2, activation: Callable = None,
             dispatch: str = "dense", capacity_factor: float = 1.25,
             group_size: int = 0, dtype=torch.float32,
             device="cuda") -> "MoEMLP":
        _check(top_k, num_experts, dispatch)
        return MoEMLP(
            initializers.normal(0.02)(generator, (dim, num_experts), dtype,
                                      device),
            initializers.kaiming_normal(generator, (num_experts, dim, hidden),
                                        dtype, device, fan_in=dim),
            torch.zeros((num_experts, hidden), dtype=dtype, device=device),
            initializers.kaiming_normal(generator, (num_experts, hidden, dim),
                                        dtype, device, fan_in=hidden),
            torch.zeros((num_experts, dim), dtype=dtype, device=device),
            top_k=top_k, activation=activation, dispatch=dispatch,
            capacity_factor=capacity_factor, group_size=group_size)

    def _dense(self, flat):
        acc = _acc(flat.dtype)
        h = _bmm(flat, self.w1).to(acc) + self.b1[:, None, :].to(acc)
        h = self.activation(h).to(flat.dtype)
        out = (torch.matmul(h, self.w2.to(flat.dtype)).to(acc)
               + self.b2[:, None, :].to(acc))
        return torch.einsum("te,etd->td",
                            moe_combine(flat, self.w_gate, self.top_k), out)

    def _experts_sorted(self, xs, sizes, slot_ids):
        acc = _acc(xs.dtype)
        h = (_grouped_mm(xs, self.w1, sizes).to(acc)
             + self.b1.index_select(0, slot_ids).to(acc))
        h = self.activation(h).to(xs.dtype)
        return (_grouped_mm(h, self.w2, sizes).to(acc)
                + self.b2.index_select(0, slot_ids).to(acc))

    def _experts_capacity(self, xs):  # [G, E, C, d]
        acc = _acc(xs.dtype)
        h = (torch.einsum("gecd,edh->gech", xs, self.w1.to(xs.dtype)).to(acc)
             + self.b1[None, :, None, :].to(acc))
        h = self.activation(h).to(xs.dtype)
        return (torch.einsum("gech,ehd->gecd", h,
                             self.w2.to(xs.dtype)).to(acc)
                + self.b2[None, :, None, :].to(acc))


class SwiGLUMoE(_MoE):
    """Mixtral-style sparse MLP: top-k gated SwiGLU experts,
    Expert_e(x) = (silu(x w1[e]) * x w3[e]) w2[e]. The MLP of a
    :class:`~lamp_tpu_torch.nn.LlamaBlock` built with ``moe_experts``."""

    def __init__(self, w_gate, w1, w3, w2, *, top_k: int,
                 dispatch: str = "dense", capacity_factor: float = 1.25,
                 group_size: int = 0):
        super().__init__()
        self.w_gate = nn.Parameter(w_gate)
        self.w1 = nn.Parameter(w1)
        self.w3 = nn.Parameter(w3)
        self.w2 = nn.Parameter(w2)
        self._routing(top_k, dispatch, capacity_factor, group_size)

    @staticmethod
    def init(dim: int, hidden: int, num_experts: int, *, generator,
             top_k: int = 2, dispatch: str = "dense",
             capacity_factor: float = 1.25, group_size: int = 0,
             dtype=torch.float32, device="cuda") -> "SwiGLUMoE":
        _check(top_k, num_experts, dispatch)
        return SwiGLUMoE(
            initializers.normal(0.02)(generator, (dim, num_experts), dtype,
                                      device),
            initializers.kaiming_normal(generator, (num_experts, dim, hidden),
                                        dtype, device, fan_in=dim),
            initializers.kaiming_normal(generator, (num_experts, dim, hidden),
                                        dtype, device, fan_in=dim),
            initializers.kaiming_normal(generator, (num_experts, hidden, dim),
                                        dtype, device, fan_in=hidden),
            top_k=top_k, dispatch=dispatch, capacity_factor=capacity_factor,
            group_size=group_size)

    def _dense(self, flat):
        return swiglu_moe_dense(flat, self.w_gate, self.w1, self.w3,
                                self.w2, self.top_k)

    def _experts_sorted(self, xs, sizes, slot_ids):
        acc = _acc(xs.dtype)
        g = (F.silu(_grouped_mm(xs, self.w1, sizes).to(acc))
             * _grouped_mm(xs, self.w3, sizes).to(acc))
        return _grouped_mm(g.to(xs.dtype), self.w2, sizes).to(acc)

    def _experts_capacity(self, xs):  # [G, E, C, d]
        acc = _acc(xs.dtype)
        g = (F.silu(torch.einsum("gecd,edh->gech", xs,
                                 self.w1.to(xs.dtype)).to(acc))
             * torch.einsum("gecd,edh->gech", xs,
                            self.w3.to(xs.dtype)).to(acc))
        return torch.einsum("gech,ehd->gecd", g.to(xs.dtype),
                            self.w2.to(xs.dtype)).to(acc)
