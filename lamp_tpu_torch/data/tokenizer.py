"""Byte-segment BPE tokenizer and text codecs.

A copy of :mod:`lamp_tpu.data.tokenizer` (framework-free; the port imports
nothing of the JAX package): the vocabulary is every single byte seen plus
the most frequent letter-or-digit byte n-grams (n <= 7), and encoding is a
greedy left-to-right contraction that prefers the longest known segment.
``decode(encode(x)) == x``. ``Codec`` is the codec interface,
``IdentityCodec`` raw bytes, ``ByteSegmentCodec`` a trained vocabulary
with JSON persistence (the same files as the JAX package's).

The n-gram counts and the encoder run in C++ (:mod:`lamp_tpu_torch.native`)
where ``g++`` built the library, else in Python; both give the same
vocabulary and the same tokens.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["train_bpe", "bpe_encode", "bpe_decode", "ByteSegmentCodec",
           "IdentityCodec", "Codec"]


def train_bpe(corpus: bytes, vocab_min: int, vocab_max: int,
              max_segment_length: int = 7) -> List[Tuple[bytes, int]]:
    """Train the byte-segment vocabulary.

    Returns ``[(segment_bytes, token_id)]``; token ids span
    [vocab_min, vocab_max). Singles (all distinct bytes in the corpus) come
    first, then the most frequent alnum n-grams.
    """
    max_len = min(7, max_segment_length)
    freqs = None
    try:
        from ..native import native_ngram_counts

        freqs = native_ngram_counts(corpus, max_len)
    except Exception:
        freqs = None
    if freqs is None:
        freqs = Counter()
        n = len(corpus)
        for i in range(n):
            for j in range(i + 1, min(i + max_len, n) + 1):
                freqs[corpus[i:j]] += 1
    vocab_size = vocab_max - vocab_min
    singles = sorted({bytes([b]) for b in corpus})
    multis = [
        (seg, c) for seg, c in freqs.items()
        if len(seg) > 1 and all(chr(b).isalnum() for b in seg)
    ]
    multis.sort(key=lambda kv: -kv[1])
    chosen = singles + [seg for seg, _ in multis[: vocab_size - len(singles)]]
    return [(seg, vocab_min + i) for i, seg in enumerate(chosen)]


def bpe_encode(corpus: bytes, encoding: Sequence[Tuple[bytes, int]],
               unknown_token: int) -> np.ndarray:
    """Greedy longest-match encode; unknown single bytes -> unknown_token."""
    table: Dict[bytes, int] = {seg: tok for seg, tok in encoding}
    max_len = max((len(seg) for seg, _ in encoding), default=1)
    out = []
    i = 0
    n = len(corpus)
    while i < n:
        tok = None
        used = 1
        for length in range(min(max_len, n - i), 0, -1):
            t = table.get(corpus[i:i + length])
            if t is not None:
                tok = t
                used = length
                break
        out.append(unknown_token if tok is None else tok)
        i += used
    return np.asarray(out, dtype=np.int32)


def bpe_decode(tokens: Sequence[int], encoding: Sequence[Tuple[bytes, int]],
               unknown_byte: int = ord("?")) -> bytes:
    rev = {tok: seg for seg, tok in encoding}
    out = bytearray()
    for t in tokens:
        out += rev.get(int(t), bytes([unknown_byte]))
    return bytes(out)


class Codec:
    """Text codec interface."""

    def encode(self, text: bytes) -> np.ndarray:
        raise NotImplementedError

    def decode(self, tokens: Sequence[int]) -> bytes:
        raise NotImplementedError

    def save(self, path: str) -> None:
        raise NotImplementedError


class IdentityCodec(Codec):
    """Raw bytes as tokens."""

    vocab_size = 256

    def encode(self, text: bytes) -> np.ndarray:
        return np.frombuffer(text, dtype=np.uint8).astype(np.int32)

    def decode(self, tokens) -> bytes:
        return bytes(int(t) & 0xFF for t in tokens)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": "identity"}, f)


class ByteSegmentCodec(Codec):
    """Trained byte-segment codec with JSON persistence."""

    def __init__(self, encoding: List[Tuple[bytes, int]], unknown_token: int,
                 unknown_byte: int = ord("?")):
        self.encoding = encoding
        self.unknown_token = unknown_token
        self.unknown_byte = unknown_byte
        self._native = None
        try:
            from ..native import NativeBpe

            self._native = NativeBpe(encoding)
        except Exception:
            self._native = None

    @staticmethod
    def train(corpus: bytes, vocab_min: int, vocab_max: int,
              max_segment_length: int = 7,
              unknown_token: Optional[int] = None) -> "ByteSegmentCodec":
        enc = train_bpe(corpus, vocab_min, vocab_max, max_segment_length)
        unk = unknown_token if unknown_token is not None else vocab_max
        return ByteSegmentCodec(enc, unk)

    @property
    def vocab_size(self) -> int:
        # must cover the unknown token too: unseen bytes encode to it, and a
        # model sized without it would silently alias them onto the last
        # real vocab entry (an embedding lookup would go out of range)
        top = max(tok for _, tok in self.encoding)
        return max(top, self.unknown_token) + 1

    def encode(self, text: bytes) -> np.ndarray:
        if self._native is not None:
            return self._native.encode(text, self.unknown_token)
        return bpe_encode(text, self.encoding, self.unknown_token)

    def decode(self, tokens) -> bytes:
        return bpe_decode(tokens, self.encoding, self.unknown_byte)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "type": "byte_segment",
                "encoding": [[list(seg), tok] for seg, tok in self.encoding],
                "unknown_token": self.unknown_token,
                "unknown_byte": self.unknown_byte,
            }, f)

    @staticmethod
    def load(path: str) -> "ByteSegmentCodec":
        with open(path) as f:
            doc = json.load(f)
        enc = [(bytes(seg), tok) for seg, tok in doc["encoding"]]
        return ByteSegmentCodec(enc, doc["unknown_token"], doc["unknown_byte"])
