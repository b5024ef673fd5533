"""Native (C++) host-side components, loaded through ctypes.

A copy of :mod:`lamp_tpu.native` and its ``lamp_native.cpp`` (the port
imports nothing of the JAX package). The library is compiled with ``g++``
at its first use into the package's git-ignored ``_build/`` directory
(never beside the source), under a name keyed by a hash of the source, so
an edited source builds anew. Every caller has a pure-Python route for
when ``g++`` or the library is missing (:func:`get_lib` returns None):
``data.train_bpe`` counts n-grams in Python and ``data.ByteSegmentCodec``
encodes with ``bpe_encode``; both routes give the same tokens. Nothing here
runs on the card. The C++ file is copied whole; its forest traversal
(``tree_apply``, ``forest_predict``) is built but not bound until its
caller, ``sidecars.extratrees``, is ported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["get_lib", "NativeBpe", "native_ngram_counts"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "lamp_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build() -> Optional[str]:
    """The built library's path (built now if it is not there), or None
    when it cannot be built."""
    try:
        with open(_SRC, "rb") as f:
            key = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, f"lamp_native-{key}.so")
        if os.path.exists(so):
            return so
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                        "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.CalledProcessError):
        return None


def get_lib():
    """The loaded ctypes library, or None if it is unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int64
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.bpe_count_build.restype = ctypes.c_void_p
        lib.bpe_count_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.bpe_count_size.restype = ctypes.c_int64
        lib.bpe_count_size.argtypes = [ctypes.c_void_p]
        lib.bpe_count_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.bpe_count_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


class NativeBpe:
    """Greedy longest-match encoder backed by the C++ table."""

    def __init__(self, encoding: List[Tuple[bytes, int]]):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        seg_bytes = b"".join(seg for seg, _ in encoding)
        offsets = np.zeros(len(encoding) + 1, np.int64)
        for i, (seg, _) in enumerate(encoding):
            offsets[i + 1] = offsets[i] + len(seg)
        tokens = np.asarray([tok for _, tok in encoding], np.int32)
        self._seg_buf = np.frombuffer(seg_bytes, np.uint8).copy()
        self._handle = lib.bpe_create(
            self._seg_buf.ctypes.data, offsets.ctypes.data,
            tokens.ctypes.data, len(encoding),
        )

    def encode(self, corpus: bytes, unknown_token: int) -> np.ndarray:
        buf = np.frombuffer(corpus, np.uint8)
        out = np.empty(len(corpus), np.int32)
        n = self._lib.bpe_encode(
            self._handle, buf.ctypes.data, len(corpus), unknown_token,
            out.ctypes.data,
        )
        return out[:n].copy()

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.bpe_destroy(self._handle)
            self._handle = None


def native_ngram_counts(corpus: bytes, max_len: int):
    """Count byte n-grams (length <= 7) in C++; returns {bytes: count}, or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(corpus, np.uint8)
    handle = lib.bpe_count_build(buf.ctypes.data, len(corpus), max_len)
    try:
        size = lib.bpe_count_size(handle)
        keys = np.empty(size, np.uint64)
        counts = np.empty(size, np.int64)
        lib.bpe_count_fill(handle, keys.ctypes.data, counts.ctypes.data)
    finally:
        lib.bpe_count_free(handle)
    out = {}
    lengths = (keys >> np.uint64(56)).astype(np.int64)
    payload = keys & np.uint64((1 << 56) - 1)
    raw = payload.astype("<u8").view(np.uint8).reshape(-1, 8)
    for i in range(size):
        out[raw[i, :lengths[i]].tobytes()] = int(counts[i])
    return out
