"""Batched on-device token sampling for the serving engine.

Counterpart of :mod:`lamp_tpu.models.sampling`: per-request temperature,
top-k, nucleus (top-p) and min-p filtering for a whole batch of
heterogeneous requests, with no per-request host round trips. Semantics
follow the sequential-filter convention (temperature scale, then top-k,
then top-p over the top-k-filtered distribution); ``temperature == 0`` rows
decode greedily regardless of the filters.

Random draws come from an explicit ``torch.Generator`` in place of a
``jax.random`` key; the two give different bits, so sampled tokens agree
with the JAX package in distribution, not token for token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["SamplingParams", "sample_tokens", "apply_penalties"]

_NEG_INF = torch.finfo(torch.float32).min * 0.5


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls.

    temperature: 0 = greedy; otherwise softmax temperature.
    top_k:       keep only the k highest-probability tokens (0 = off).
    top_p:       nucleus sampling — keep the smallest prefix of the
                 sorted distribution with cumulative probability >=
                 ``top_p`` (1.0 = off).
    min_p:       keep only tokens whose probability is >= ``min_p`` times
                 the most-likely token's (0 = off).
    logprobs:    also record the chosen token's log-probability each step
                 (under the model's distribution — post penalties,
                 pre temperature/filters).
    max_tokens:  stop after this many generated tokens (engine-level).
    stop_tokens: token ids that terminate the request (engine-level).
    presence_penalty:   subtract from the logit of every token already
                        GENERATED by this request (0 = off).
    frequency_penalty:  subtract ``penalty * count`` per generated
                        occurrence (0 = off).
    repetition_penalty: divide positive / multiply negative logits of
                        tokens seen in the PROMPT OR OUTPUT (1.0 = off).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    max_tokens: Optional[int] = None
    stop_tokens: Tuple[int, ...] = ()
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logprobs: bool = False

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if not 0.0 <= self.min_p < 1.0:
            raise ValueError("min_p must be in [0, 1)")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")

    @property
    def has_penalties(self) -> bool:
        return (self.presence_penalty != 0.0 or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)


# nucleus candidate cap: top-p is evaluated over each row's NUCLEUS_CAND
# highest logits; a nucleus spanning more candidates is truncated at the
# cap. Rows requesting top_k beyond the cap widen it (``max_top_k``).
NUCLEUS_CAND = 2048


def _apply_filters(scaled, top_k, top_p, min_p=None, max_top_k: int = 0):
    """Apply top-k, min-p and nucleus filtering over the top candidates;
    filtered logits become a large negative number. Within the descending
    candidate order the top-k survivors' mass is ``z = csum[k-1]``, so the
    nucleus condition on the renormalized probabilities is
    ``(csum - p) < top_p * z``. Rows with every filter off pass through
    unchanged; the best token is always kept."""
    v = scaled.shape[-1]
    cand = min(v, max(NUCLEUS_CAND, max_top_k))
    sl = torch.topk(scaled, cand, dim=-1).values  # descending [B, cand]
    if top_k is not None:
        k = torch.where(top_k <= 0, cand, torch.clamp(top_k, 1, cand)).long()
    else:
        k = torch.full(scaled.shape[:-1], cand, dtype=torch.long,
                       device=scaled.device)
    kth = torch.gather(sl, -1, (k - 1)[:, None])
    keep = sl >= kth
    if top_p is not None or min_p is not None:
        lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
        probs = torch.exp(sl - lse)  # exact probabilities of the candidates
    if min_p is not None:
        mp = torch.where(min_p > 0, min_p, 0.0)[:, None]
        keep = keep & (probs >= mp * probs[:, :1])
    if top_p is not None:
        csum = torch.cumsum(probs, dim=-1)
        # top-k-OFF rows renormalize over the FULL distribution (z = 1)
        if top_k is None:
            z = 1.0
        else:
            z = torch.where((top_k <= 0)[:, None], 1.0,
                            torch.gather(csum, -1, (k - 1)[:, None]))
        keep = keep & ((csum - probs) < top_p[:, None] * z)
    thresh = torch.where(keep, sl, torch.inf).amin(dim=-1, keepdim=True)
    row_off = torch.ones(scaled.shape[:-1], dtype=torch.bool,
                         device=scaled.device)
    if top_k is not None:
        row_off = row_off & (top_k <= 0)
    if top_p is not None:
        row_off = row_off & (top_p >= 1.0)
    if min_p is not None:
        row_off = row_off & (min_p <= 0.0)
    thresh = torch.where(row_off[:, None], -torch.inf, thresh)
    return torch.where(scaled >= thresh, scaled, _NEG_INF)


def apply_penalties(logits, out_counts, prompt_mask, presence, frequency,
                    repetition):
    """Repetition/presence/frequency penalties (vLLM semantics).

    logits [B, V] f32; out_counts [B, V] int (generated-token counts);
    prompt_mask [B, V] bool; per-row presence/frequency/repetition [B] f32
    (repetition 1.0 = off). Repetition considers prompt OR output tokens;
    presence/frequency only generated ones.
    """
    seen = prompt_mask | (out_counts > 0)
    rp = repetition[:, None]
    logits = torch.where(
        seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
    counts = out_counts.to(logits.dtype)
    logits = logits - frequency[:, None] * counts
    return logits - presence[:, None] * (out_counts > 0)


def sample_tokens(logits, generator, temperature, top_k=None, top_p=None,
                  penalties=None, allowed_rows=None, min_p=None,
                  max_top_k: int = 0, return_logprobs: bool = False):
    """Sample one token per row with per-row controls.

    logits:      [B, V] float
    generator:   ``torch.Generator`` on the logits' device (unused when
                 every row is greedy)
    temperature: [B] f32 (0 = greedy for that row), or None when every row
                 is greedy — a bare argmax, no random draws
    top_k:       [B] int or None;  top_p, min_p: [B] f32 or None
    penalties:   None, or (out_counts, prompt_mask, presence, frequency,
                 repetition) — see :func:`apply_penalties`
    allowed_rows: [B, V] int or None — constrained-decoding rows (entry
                 >= 0 means the token is allowed); applied first
    max_top_k:   upper bound on the ``top_k`` values present (widens the
                 candidate set beyond NUCLEUS_CAND)
    return_logprobs: also return the log-probability [B] f32 of the chosen
                 token under log_softmax of the logits after penalties and
                 the constraint mask, before temperature and filters.

    Returns [B] int64 tokens, or (tokens, logprobs). Sampling is the
    Gumbel-max form of a categorical draw, as ``jax.random.categorical``.
    """
    logits = logits.float()
    if allowed_rows is not None:
        logits = torch.where(allowed_rows >= 0, logits, _NEG_INF)
    if penalties is not None:
        logits = apply_penalties(logits, *penalties)
    greedy = torch.argmax(logits, dim=-1)

    def lp_of(toks):
        lse = torch.logsumexp(logits, dim=-1)
        return torch.gather(logits, -1, toks[:, None])[:, 0] - lse

    if temperature is None:
        return (greedy, lp_of(greedy)) if return_logprobs else greedy
    t = temperature[:, None]
    scaled = logits / torch.where(t > 0, t, 1.0)
    if top_k is not None or top_p is not None or min_p is not None:
        scaled = _apply_filters(scaled, top_k, top_p, min_p, max_top_k)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u))  # u == 0 gives -inf: never drawn
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    toks = torch.where(temperature > 0, sampled, greedy)
    return (toks, lp_of(toks)) if return_logprobs else toks
