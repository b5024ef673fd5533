"""Language-model data: corpus minibatches, packed rows, sampling.

Counterpart of :mod:`lamp_tpu.data.lm_data`: numpy copies of
``autoregressive_minibatches_from_corpus`` (random corpus crops, the same
batches as the JAX package's under the same numpy generator) and
``pack_documents`` (framework free, so the port keeps its own copy rather
than importing the JAX package), and ``autoregressive_inference``, the
reference's sampling loop of one full forward a generated token. The
KV-cached decode is :func:`lamp_tpu_torch.models.generate`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .batchstream import BatchStream

__all__ = ["autoregressive_minibatches_from_corpus",
           "autoregressive_inference", "pack_documents"]


def pack_documents(docs, context_length: int, *, pad_id: int = 0,
                   ignore_index: int = -100):
    """Pack variable-length token sequences into fixed ``[N, ctx]`` rows
    for packed-document training: no FLOPs spent on padding and no
    attention across document boundaries.

    Documents are placed greedily in order (first fit), never split across
    rows; documents longer than ``context_length`` are truncated. Returns a
    dict of int32 numpy arrays, each ``[N, context_length]``:

    - ``tokens``: packed input ids (``pad_id`` in the unused tail)
    - ``targets``: next token WITHIN the same document; the last token of
      each document and all padding get ``ignore_index``
    - ``segment_ids``: 0, 1, ... per document within a row (padding gets its
      own trailing id)
    - ``positions``: 0-based offsets restarting at each document, for
      per-document RoPE
    """
    rows = []          # list of list-of-docs
    room = []          # remaining space per row
    for doc in docs:
        doc = np.asarray(doc)[:context_length]
        if len(doc) == 0:
            continue
        for i in range(len(rows)):
            if room[i] >= len(doc):
                rows[i].append(doc)
                room[i] -= len(doc)
                break
        else:
            rows.append([doc])
            room.append(context_length - len(doc))

    n = len(rows)
    tokens = np.full((n, context_length), pad_id, np.int32)
    targets = np.full((n, context_length), ignore_index, np.int32)
    segment_ids = np.zeros((n, context_length), np.int32)
    positions = np.zeros((n, context_length), np.int32)
    for r, row_docs in enumerate(rows):
        at = 0
        for s, doc in enumerate(row_docs):
            ln = len(doc)
            tokens[r, at:at + ln] = doc
            targets[r, at:at + ln - 1] = doc[1:]
            segment_ids[r, at:at + ln] = s
            positions[r, at:at + ln] = np.arange(ln)
            at += ln
        # the padded tail: its own segment id and fresh positions, so pad
        # rows attend only to each other and never to document tokens
        if at < context_length:
            segment_ids[r, at:] = len(row_docs)
            positions[r, at:] = np.arange(context_length - at)
    return {"tokens": tokens, "targets": targets,
            "segment_ids": segment_ids, "positions": positions}


def autoregressive_minibatches_from_corpus(
        corpus: np.ndarray, batch_size: int, context_length: int, *,
        batches_per_epoch: Optional[int] = None,
        rng: Optional[np.random.Generator] = None) -> BatchStream:
    """Random crops of ``corpus``: (tokens, tokens shifted by one) int32
    numpy batches of ``[batch_size, context_length]``, the crops' starts
    drawn from ``rng`` (default ``np.random.default_rng(0)``)."""
    corpus = np.asarray(corpus)
    n = len(corpus)
    rng = rng or np.random.default_rng(0)
    nb = batches_per_epoch or max(1, (n - context_length - 1) // (
        batch_size * context_length))

    def gen():
        for _ in range(nb):
            starts = rng.integers(0, n - context_length - 1, batch_size)
            x = np.stack([corpus[s:s + context_length] for s in starts])
            y = np.stack([corpus[s + 1:s + context_length + 1]
                          for s in starts])
            yield (x.astype(np.int32), y.astype(np.int32))

    return BatchStream(gen, nb)


@torch.no_grad()
def autoregressive_inference(model, prefix: np.ndarray, *, length: int,
                             temperature: float = 1.0, generator=None,
                             context_length: Optional[int] = None):
    """Sample ``length`` tokens after ``prefix`` ([T] or [B, T] ints) with
    one full forward a token over a ``[B, ctx]`` buffer and its valid
    length (the buffer slides once full). Greedy (argmax) at
    ``temperature <= 0``, else drawn from softmax(logits / temperature) by
    ``generator`` (a ``torch.Generator`` on the model's device; seeded 0 if
    None), so sampled tokens agree with the JAX loop's in distribution
    only. Returns the continuation, int32 numpy ``[B, length]``."""
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    prefix = np.asarray(prefix)
    if prefix.ndim == 1:
        prefix = prefix[None]
    b, t0 = prefix.shape
    ctx = context_length or getattr(model, "context_length", None) or (
        t0 + length)
    buf = np.zeros((b, ctx), np.int64)
    fill = min(t0, ctx)
    buf[:, :fill] = prefix[:, -fill:]
    valid = fill
    rows = torch.arange(b, device=device)
    generated = []
    for _ in range(length):
        tokens = torch.as_tensor(buf, device=device)
        lengths = torch.full((b,), valid, device=device)
        logits = model((tokens, lengths), train=False)[rows, valid - 1]
        if temperature <= 0:
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        nxt = nxt.cpu().numpy().astype(np.int32)
        generated.append(nxt[:, None])
        if valid < ctx:
            buf[:, valid] = nxt
            valid += 1
        else:
            buf = np.concatenate([buf[:, 1:], nxt[:, None]], axis=1)
    return np.concatenate(generated, axis=1)
