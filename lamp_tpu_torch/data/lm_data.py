"""Language-model data: packing documents into fixed-length rows.

A numpy copy of :func:`lamp_tpu.data.lm_data.pack_documents` (framework
free, so the port keeps its own copy rather than importing the JAX
package). The rows feed ``ModernLM.loss(..., segment_ids=, positions=)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_documents"]


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
