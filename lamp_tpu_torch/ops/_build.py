"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources in ``lamp_tpu_torch/csrc/*.cu`` expose plain C entry points.
They are compiled into one shared library at first CUDA use (never at
import, so the CPU tests import every module freely), into
``lamp_tpu_torch/_build/``, under a name keyed by a hash of the sources and
flags: an edited source builds anew, an unchanged one loads the cached
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "library"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``_build/`` unless an up-to-date library
    is there; returns its path. ``verbose`` prints the compiler's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    sources = sorted(_SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = _BUILD_DIR / f"lamp_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError(
            f"nvcc not found; tried: {' '.join(cmd)}") from None
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never sees half a file
    if verbose:
        print(f"built {out.name} in {time.perf_counter() - t0:.1f} s: "
              f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}", flush=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Every pointer and
    the stream are ``c_void_p`` so that no pointer is cut to 32 bits."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lamp_paged_attention.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # tensors
        i32, i32, i32, i32, i32, i32,                 # batch .. pages_per_seq
        i64, i64, i32, ctypes.c_float, i32, ptr,      # strides .. stream
    ]
    lib.lamp_paged_attention.restype = i32
    lib.lamp_cuda_error_string.argtypes = [i32]
    lib.lamp_cuda_error_string.restype = ctypes.c_char_p
    return lib
