"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources in ``lamp_tpu_torch/csrc/*.cu`` expose plain C entry points;
``csrc/*.cuh`` are headers they include.
Each compiles to an object in its own nvcc process, all at once, and they
are linked into one shared library at first CUDA use (never at
import, so the CPU tests import every module freely), into
``lamp_tpu_torch/_build/``, under a name keyed by a hash of the sources and
flags (:func:`source_key`): an edited source or header builds anew, an
unchanged tree loads the cached library. The wgmma backward kernels fetch
libcuda's ``cuTensorMapEncodeTiled`` through the runtime
(``cudaGetDriverEntryPoint``), so nothing links libcuda.
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

__all__ = ["build", "library", "load", "source_key"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _run(cmds):
    """Run the commands at once; raise on the first that fails. Returns
    their combined output."""
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
    except FileNotFoundError:
        raise RuntimeError(f"nvcc not found; tried: {cmds[0][0]}") from None
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(f"{' '.join(cmd)}\n{log}" for cmd, log in zip(cmds, logs))


def source_key(src_dir: Path = _SRC_DIR) -> str:
    """The library's cache key: a hash of the flags and of every file
    under ``src_dir`` (sources and the headers they include), by name and
    content."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(p for p in src_dir.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(src_dir)).encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``_build/`` unless an up-to-date library
    is there; returns its path. Each source compiles in its own nvcc
    process, all at once, and one more links them. ``verbose`` prints the
    compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per kernel)."""
    sources = sorted(_SRC_DIR.glob("*.cu"))
    key = source_key()
    out = _BUILD_DIR / f"lamp_kernels_{key}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = _run([[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)])
    log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)  # atomic: another process never sees half a file
    if verbose:
        print(f"built {out.name} in {time.perf_counter() - t0:.1f} s:\n{log}",
              flush=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return load(build())


def load(path: Path) -> ctypes.CDLL:
    """Load a library linked from every ``csrc/*.cu`` (the package's, or an
    experiment's edited copy) and declare its entry points' C signatures.
    Every pointer and the stream are ``c_void_p`` so that no pointer is cut
    to 32 bits."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.lamp_paged_attention.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # tensors
        i32, i32, i32, i32, i32, i32, i32,  # batch .. pages_per_seq, pages
        i64, i64, i32, ctypes.c_double, i32, i32,     # strides .. kv dtype
        i32, i32, ptr,                                # splits, stages, stream
    ]
    lib.lamp_paged_attention.restype = i32
    # flash attention: tensors, then the visibility (q ids, kv ids, mask,
    # class map, the mask's four strides, the map's batch and heads), then
    # bh, heads, sq, skv, head_dim, the two limit strides, causal, window,
    # sm_scale, dtype and the stream
    shape = [ptr] * 4 + [i64] * 4 + [i32] * 11 + [ctypes.c_double, i32, ptr]
    lib.lamp_flash_attention_fwd.argtypes = [ptr] * 6 + shape
    # dq: q, k, v, o, do, lse, di (written), limits, dq
    lib.lamp_flash_attention_bwd_dq.argtypes = [ptr] * 9 + shape
    lib.lamp_flash_attention_bwd_dkv.argtypes = [ptr] * 9 + shape
    for fn in (lib.lamp_flash_attention_fwd, lib.lamp_flash_attention_bwd_dq,
               lib.lamp_flash_attention_bwd_dkv):
        fn.restype = i32
    # int4 matmul: x, packed, scales, out, then m, k, n, group, the x and
    # out dtypes, the decode kernel's plan (tile, cluster, round rows; 0 on
    # the other routes) and the stream
    lib.lamp_int4_matmul.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.lamp_int4_matmul.restype = i32
    # stochastic int8 quantizer: x, values, scales, m, k, seed, dtype, stream
    lib.lamp_quantize_int8_stochastic.argtypes = [
        ptr, ptr, ptr, i32, i32, ctypes.c_uint, i32, ptr]
    lib.lamp_quantize_int8_stochastic.restype = i32
    # fused AdamW: the host table of (p, g, m, v, n, seed) rows, its row
    # count, the dtype, lr, lr wd, b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps,
    # the step, stochastic, the stream
    lib.lamp_fused_adamw.argtypes = [ptr, i32, i32] + [f32] * 9 + [
        ctypes.c_uint, i32, ptr]
    lib.lamp_fused_adamw.restype = i32
    # fused LayerNorm forward: x, weight, bias, y, mu, rstd, n, d, eps, the
    # x, weight and bias dtypes, blocks, stream; backward: x, dy, weight, mu,
    # rstd, dx, dweight, dbias, the workspace, n, d, blocks, dtype, stream
    lib.lamp_layernorm_fwd.argtypes = [ptr] * 6 + [i32, i32, f32] + \
        [i32] * 4 + [ptr]
    lib.lamp_layernorm_fwd.restype = i32
    lib.lamp_layernorm_bwd.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
    lib.lamp_layernorm_bwd.restype = i32
    lib.lamp_cuda_error_string.argtypes = [i32]
    lib.lamp_cuda_error_string.restype = ctypes.c_char_p
    return lib
