"""Serialization: the JAX package's checkpoint format, safetensors.

Counterpart of :mod:`lamp_tpu.io`: the checkpoint files cross between the
two packages in both directions. ``orbax_compat`` (a JAX-ecosystem format)
and the ONNX export are not ported.
"""

from .checkpoint import (
    AsyncCheckpointer,
    load_loop_state,
    load_pytree,
    load_pytree_sharded,
    read_safetensors,
    read_tensor_blob,
    save_loop_state,
    save_pytree,
    save_pytree_sharded,
    wait_for_background_saves,
    write_safetensors,
    write_tensor_blob,
)

__all__ = [
    "write_tensor_blob",
    "read_tensor_blob",
    "save_pytree",
    "save_pytree_sharded",
    "AsyncCheckpointer",
    "load_pytree",
    "load_pytree_sharded",
    "save_loop_state",
    "load_loop_state",
    "wait_for_background_saves",
    "read_safetensors",
    "write_safetensors",
]
