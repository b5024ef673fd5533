"""Tensor and training-state serialization, in the JAX package's format.

Counterpart of :mod:`lamp_tpu.io.checkpoint`: the same files, so that a
checkpoint written by either package loads in the other. Tensors go into
one raw little-endian blob with 8-byte padded records and a JSON
descriptor, written atomically (a temporary file, then a rename) and read
back through ``np.memmap``. bf16 is written as ``uint16`` payloads; a dtype
outside ``_DTYPE_TO_NAME`` (fp8, for one) raises ``KeyError``, as in JAX.

A JAX checkpoint holds no names: its leaves come in ``jax.tree_util``'s
flatten order, and the loader takes the structure from a template. Here a
tree is nested dicts (in sorted key order), lists and tuples of tensors,
numpy arrays, ``None`` and JSON-able scalars. Loading gives a new tensor
for each template leaf, in its dtype and on its device (a CPU tensor of the
file's dtype where the template leaf is not a tensor). The descriptor's
``treedef`` is the port's own string of the structure (``{'model': [*, *,
...], ...}``, a ``*`` a leaf), which neither loader reads; every other byte
of the files, the ``.data`` blob and the ``.meta`` sidecar included, is
what the JAX package writes for the same values.

:func:`save_loop_state` and :func:`load_loop_state` also take the port's
model, optimizer and ``TrainState``, which stand for the JAX pytrees they
replace (:func:`lamp_tpu_torch.bridge.jax_tree`: ``Linear`` weights [in,
out], ``None`` for an absent bias or a tied ``lm_head``); a load writes
the file's values into them in place, checking each shape
(:func:`lamp_tpu_torch.bridge.load_jax_tree`).

The port is one process: the sharded layout is written as process 0's
files, each leaf whole (start 0) and ``"processes": 1``, and a sharded
file that JAX wrote over several devices is assembled from its pieces.
``orbax_compat`` (a JAX-ecosystem format) is not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import bridge

__all__ = [
    "write_tensor_blob",
    "read_tensor_blob",
    "save_pytree",
    "load_pytree",
    "save_pytree_sharded",
    "load_pytree_sharded",
    "save_loop_state",
    "load_loop_state",
    "wait_for_background_saves",
    "read_safetensors",
    "write_safetensors",
    "AsyncCheckpointer",
]

_ALIGN = 8

_DTYPE_TO_NAME = {
    np.dtype("float64"): "f64",
    np.dtype("float32"): "f32",
    np.dtype("float16"): "f16",
    np.dtype("int64"): "i64",
    np.dtype("int32"): "i32",
    np.dtype("int16"): "i16",
    np.dtype("int8"): "i8",
    np.dtype("uint8"): "u8",
    np.dtype("bool"): "bool",
}
_NAME_TO_DTYPE = {v: k for k, v in _DTYPE_TO_NAME.items()}
# bf16 has no numpy dtype: written as raw uint16 payloads
_BF16 = "bf16"

_TORCH_TO_NUMPY = {
    torch.float64: np.float64, torch.float32: np.float32,
    torch.float16: np.float16, torch.int64: np.int64, torch.int32: np.int32,
    torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.bool: np.bool_,
}


def _np_of(x) -> Tuple[np.ndarray, str]:
    """(host array, dtype name) of a tensor or an array; bf16 as uint16."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return (x.contiguous().cpu().view(torch.int16).numpy()
                    .view(np.uint16), _BF16)
        if x.dtype not in _TORCH_TO_NUMPY:
            raise KeyError(f"{x.dtype} has no checkpoint dtype")
        arr = x.contiguous().cpu().numpy()
    else:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # an ml_dtypes array
            return arr.view(np.uint16), _BF16
    return arr, _DTYPE_TO_NAME[arr.dtype]


def _host_tensor(arr: np.ndarray, dname: str) -> torch.Tensor:
    """A CPU tensor of a blob's values (bf16 from its uint16 payload)."""
    if not arr.flags.writeable:
        arr = np.array(arr)
    if dname == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _write_array(f, arr: np.ndarray) -> int:
    """Write ``arr``'s bytes and the zeros that pad them to 8 bytes; return
    the bytes of the array. The buffer is written as it is, without a copy
    (the writer of a background save then holds the interpreter's lock for
    less of its time)."""
    arr = np.ascontiguousarray(arr)
    f.write(arr.reshape(-1).view(np.uint8).data)
    f.write(b"\x00" * ((-arr.nbytes) % _ALIGN))
    return arr.nbytes


def write_tensor_blob(path: str, tensors: List[Any]) -> List[Dict]:
    """Write tensors to ``path`` (raw little-endian records, each padded to
    8 bytes) and return their descriptors (``offset``, ``nbytes``,
    ``dtype``, ``shape``). A tensor on the card is copied to the host
    first."""
    descriptors = []
    dirn = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirn, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirn)
    f = os.fdopen(fd, "wb")
    try:
        offset = 0
        for t in tensors:
            arr, dname = _np_of(t)
            nbytes = _write_array(f, arr)
            descriptors.append({
                "offset": offset,
                "nbytes": nbytes,
                "dtype": dname,
                "shape": list(arr.shape),
            })
            offset += nbytes + (-nbytes) % _ALIGN
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return descriptors


def read_tensor_blob(path: str, descriptors: List[Dict]) -> List[np.ndarray]:
    """The blob's tensors as read-only numpy views of an ``np.memmap``
    (bf16 as its uint16 payload)."""
    return _mapped(path, descriptors, "r")


def _mapped(path, descriptors, mode):
    """The blob's tensors as views of the file mapped in ``mode``; "c"
    (copy-on-write) gives writable views, which ``torch.from_numpy``
    takes without a copy."""
    mm = np.memmap(path, dtype=np.uint8, mode=mode)
    out = []
    for d in descriptors:
        raw = mm[d["offset"]:d["offset"] + d["nbytes"]]
        dtype = np.uint16 if d["dtype"] == _BF16 else \
            _NAME_TO_DTYPE[d["dtype"]]
        out.append(raw.view(dtype).reshape(d["shape"]))
    return out


def _flatten(tree) -> List[Any]:
    """The leaves of a plain tree in ``jax.tree_util``'s order (dict keys
    sorted; ``None`` is a leaf)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ")"
    return "*"


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _leaf_meta(x):
    if x is None:
        return {"kind": "none"}
    if _is_array(x):
        return {"kind": "array"}
    if isinstance(x, (bool, int, float, str)):
        return {"kind": "py", "value": x}
    raise TypeError(f"a {type(x).__name__} leaf: a tree holds tensors, "
                    f"arrays, None and JSON scalars (a port model or "
                    f"optimizer goes through bridge.jax_tree or "
                    f"save_loop_state)")


def _write_json(path: str, doc) -> None:
    dirn = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dirn)
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors (and JSON-able scalars) as descriptor + blob:
    ``path`` is the JSON descriptor, ``path + ".data"`` the blob."""
    arrays, metas = [], []
    for leaf in _flatten(tree):
        meta = _leaf_meta(leaf)
        if meta["kind"] == "array":
            meta["index"] = len(arrays)
            arrays.append(leaf)
        metas.append(meta)
    descriptors = write_tensor_blob(path + ".data", arrays)
    _write_json(path, {
        "version": 1,
        "treedef": _treedef(tree),
        "leaves": metas,
        "tensors": descriptors,
    })


def _restore(tree, values):
    """``tree`` (a template) filled from ``values``, an iterator over the
    file's leaves in flatten order: host tensors, ``None`` and scalars."""
    if isinstance(tree, dict):
        return {k: _restore(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_restore(v, values) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    value = next(values)
    if not isinstance(value, torch.Tensor):
        return value
    if isinstance(tree, torch.Tensor):
        return value.to(device=tree.device, dtype=tree.dtype, copy=True)
    return value.clone()  # not a view of the mapped file


def _load_leaves(metas, read, template):
    t_leaves = _flatten(template)
    if len(t_leaves) != len(metas):
        raise ValueError(f"checkpoint has {len(metas)} leaves, template has "
                         f"{len(t_leaves)}")
    values = []
    for meta in metas:
        if meta["kind"] == "none":
            values.append(None)
        elif meta["kind"] == "py":
            values.append(meta["value"])
        else:
            values.append(read(meta))
    return _restore(template, iter(values))


def load_pytree(path: str, template: Any) -> Any:
    """Load a tree saved by :func:`save_pytree` (by either package), taking
    its structure from ``template``."""
    with open(path) as f:
        doc = json.load(f)
    blobs = _mapped(path + ".data", doc["tensors"], "c")

    def read(meta):
        i = meta["index"]
        return _host_tensor(blobs[i], doc["tensors"][i]["dtype"])

    return _load_leaves(doc["leaves"], read, template)


def save_pytree_sharded(path: str, tree: Any) -> None:
    """The sharded layout of one process: ``path`` is the main descriptor,
    ``path + ".shard0.json"`` and ``path + ".data.shard0"`` the process's
    records and blob, each leaf written whole (start 0)."""
    blob_path = f"{path}.data.shard0"
    dirn = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirn, exist_ok=True)
    metas, records = [], []
    arr_count = 0
    offset = 0
    fd, tmp = tempfile.mkstemp(dir=dirn)
    with os.fdopen(fd, "wb") as f:
        for leaf in _flatten(tree):
            meta = _leaf_meta(leaf)
            if meta["kind"] == "array":
                arr, dname = _np_of(leaf)
                meta["index"] = arr_count
                meta["shape"] = list(arr.shape)
                meta["dtype"] = dname
                nbytes = _write_array(f, arr)
                records.append({
                    "leaf": arr_count,
                    "offset": offset,
                    "nbytes": nbytes,
                    "start": [0] * arr.ndim,
                    "shape": list(arr.shape),
                })
                offset += nbytes + (-nbytes) % _ALIGN
                arr_count += 1
            metas.append(meta)
    os.replace(tmp, blob_path)
    _write_json(f"{path}.shard0.json", {"process": 0, "records": records})
    _write_json(path, {"version": 1, "sharded": True,
                       "treedef": _treedef(tree), "processes": 1,
                       "leaves": metas})


def load_pytree_sharded(path: str, template: Any, *, shardings=None) -> Any:
    """Load a sharded checkpoint (of any number of processes), assembling
    each leaf from the records of the shard files that the save wrote
    (``"processes"`` in the main descriptor). ``shardings`` (a JAX
    placement) raises ``NotImplementedError`` until the port's ``parallel``
    exists."""
    import glob as _glob

    if shardings is not None:
        raise NotImplementedError("load_pytree_sharded: shardings= (the "
                                  "port has no parallel package yet)")
    with open(path) as f:
        doc = json.load(f)
    if "processes" in doc:
        shard_paths = [f"{path}.shard{p}.json"
                       for p in range(doc["processes"])]
    else:  # written before "processes" existed: every shard file present
        shard_paths = sorted(_glob.glob(f"{path}.shard*.json"))
    by_leaf: Dict[int, List] = {}
    for sp in shard_paths:
        with open(sp) as f:
            sd = json.load(f)
        if not sd["records"]:
            continue  # that process held only replicas (a 0-byte blob)
        blob = np.memmap(f"{path}.data.shard{sd['process']}", dtype=np.uint8,
                         mode="r")
        for rec in sd["records"]:
            by_leaf.setdefault(rec["leaf"], []).append((blob, rec))

    def read(meta):
        dname = meta["dtype"]
        np_dtype = np.uint16 if dname == _BF16 else _NAME_TO_DTYPE[dname]
        full = np.empty(meta["shape"], np_dtype)
        covered = 0
        for blob, rec in by_leaf.get(meta["index"], []):
            raw = blob[rec["offset"]:rec["offset"] + rec["nbytes"]]
            piece = raw.view(np_dtype).reshape(rec["shape"])
            idx = tuple(slice(s, s + n)
                        for s, n in zip(rec["start"], rec["shape"]))
            full[idx] = piece
            covered += piece.size
        if covered < full.size:
            raise ValueError(f"leaf {meta['index']}: shards cover {covered} "
                             f"of {full.size} elements (missing shard "
                             f"files?)")
        return _host_tensor(full, dname)

    return _load_leaves(doc["leaves"], read, template)


_BG_CHECKPOINTER = None


def save_loop_state(path: str, *, model, optimizer_state, epoch: int,
                    last_validation_loss=None, min_validation_loss=None,
                    min_validation_model=None, learning_curve=None,
                    lr_state=None, extra=None,
                    background: bool = False) -> None:
    """Persist the training loop's state: ``model``, ``optimizer_state``
    (the port's optimizer over ``model``, or a tree) and
    ``min_validation_model`` (a ``TrainState``, a model or ``None``) into
    ``path`` and ``path + ".data"``, the rest into the JSON sidecar
    ``path + ".meta"``, which is written last.

    ``background=True`` routes through a module-wide
    :class:`AsyncCheckpointer`: every tensor is cloned on its device first,
    in stream order before the caller's next in-place update, and a thread
    copies the clones to the host and writes the files. Background saves
    run one at a time; :func:`wait_for_background_saves` waits for the one
    in flight, and a failed write raises there or at the next save."""
    state = {"model": bridge.jax_tree(model),
             "optimizer_state": bridge.jax_tree(optimizer_state, model),
             "min_validation_model": bridge.jax_tree(min_validation_model)}
    meta = {
        "epoch": epoch,
        "last_validation_loss": last_validation_loss,
        "min_validation_loss": min_validation_loss,
        "learning_curve": learning_curve or [],
        "lr_state": lr_state,
        "extra": extra,
    }

    def write(p, tree):
        save_pytree(p, tree)
        _write_json(p + ".meta", meta)

    if background:
        global _BG_CHECKPOINTER
        if _BG_CHECKPOINTER is None:
            _BG_CHECKPOINTER = AsyncCheckpointer()
        _BG_CHECKPOINTER.save(path, state, save_fn=write)
    else:
        write(path, state)


def wait_for_background_saves() -> None:
    """Block until the write that ``save_loop_state(background=True)`` has
    in flight (if any) ends; re-raise its error."""
    if _BG_CHECKPOINTER is not None:
        _BG_CHECKPOINTER.wait()


def load_loop_state(path: str, *, model_template, optimizer_state_template,
                    min_validation_model_template=None):
    """Resume the training loop's state into the templates: returns
    ``(state, meta)``, ``state`` keyed ``model``, ``optimizer_state`` and
    ``min_validation_model``. A port model, optimizer or ``TrainState``
    template is written in place and returned in its slot."""
    objects = {
        "model": model_template,
        "optimizer_state": optimizer_state_template,
        "min_validation_model": min_validation_model_template,
    }
    trees = load_pytree(path, {
        k: bridge.jax_tree(v, model_template) for k, v in objects.items()})
    state = {k: bridge.load_jax_tree(v, trees[k], model_template)
             for k, v in objects.items()}
    with open(path + ".meta") as f:
        meta = json.load(f)
    return state, meta


# ---------------------------------------------------------------------------
# safetensors (HuggingFace weights)
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A HuggingFace safetensors file as named CPU tensors (BF16 as
    ``torch.bfloat16``); the ``__metadata__`` entry is skipped."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    header_len = int(np.frombuffer(mm[:8].tobytes(), dtype="<u8")[0])
    header = json.loads(mm[8:8 + header_len].tobytes().decode("utf-8"))
    base = 8 + header_len
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = np.array(mm[base + start:base + end])
        if info["dtype"] == "BF16":
            arr = raw.view(np.uint16).reshape(info["shape"])
            out[name] = _host_tensor(arr, _BF16)
        else:
            out[name] = torch.from_numpy(
                raw.view(_ST_DTYPES[info["dtype"]]).reshape(info["shape"]))
    return out


def _st_entry(t) -> Tuple[str, List[int], int]:
    """(safetensors dtype, shape, bytes) of a tensor or an array, without
    copying it."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            dt = "BF16"
        elif t.dtype in _TORCH_TO_NUMPY:
            dt = _ST_NAMES[np.dtype(_TORCH_TO_NUMPY[t.dtype]).type]
        else:
            raise KeyError(f"{t.dtype} has no safetensors dtype")
        return dt, list(t.shape), t.numel() * t.element_size()
    arr = np.asarray(t)
    dt = ("BF16" if arr.dtype.name == "bfloat16"
          else _ST_NAMES[arr.dtype.type])
    return dt, list(arr.shape), arr.nbytes


_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def write_safetensors(path: str, tensors: Dict[str, Any],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write named tensors (or arrays) as a safetensors file: the header's
    JSON padded with spaces to 8 bytes, then the payloads in order. Each
    tensor is copied to the host and written in turn, so the host holds
    one tensor at a time."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    for name, t in tensors.items():
        dt, shape, nbytes = _st_entry(t)
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hj = json.dumps(header).encode("utf-8")
    hj += b" " * ((-len(hj)) % 8)
    dirn = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirn, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirn)
    with os.fdopen(fd, "wb") as f:
        f.write(np.uint64(len(hj)).tobytes())
        f.write(hj)
        for t in tensors.values():
            arr = np.ascontiguousarray(_np_of(t)[0])
            f.write(arr.reshape(-1).view(np.uint8).data)
    os.replace(tmp, path)


class AsyncCheckpointer:
    """Checkpoint writes on a background thread, so the training loop does
    not wait for the host copies and the disk.

    ``save`` clones every tensor of the tree on its device (the caller's
    next step updates the originals in place; the clones are issued on the
    caller's stream, so they come before that step's writes) and records a
    CUDA event after them. A writer thread makes its own stream wait on that
    event, copies the clones to the host from it and writes the files,
    while the caller's stream goes on with its steps. At most one write is
    in flight: ``save`` first waits for the previous one, and ``wait``
    re-raises a failed write's error. The tree's tensors lie on one card
    (or on the host)."""

    def __init__(self):
        self._thread = None
        self._exc = None
        self._streams = {}

    def _snapshot(self, tree):
        """(the tree's clones, the card they lie on or None)."""
        devices = set()

        def copy(x):
            if isinstance(x, dict):
                return {k: copy(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                items = [copy(v) for v in x]
                return type(x)(*items) if hasattr(x, "_fields") \
                    else type(x)(items)
            if isinstance(x, torch.Tensor):
                if x.is_cuda:
                    devices.add(x.device)
                return x.detach().clone()
            return x

        snapshot = copy(tree)
        if len(devices) > 1:
            raise ValueError("AsyncCheckpointer: a tree on more than one "
                             "card")
        return snapshot, (devices.pop() if devices else None)

    def save(self, path: str, tree: Any, *, save_fn=None) -> None:
        """Queue ``save_fn(path, snapshot)`` (default :func:`save_pytree`)
        on the writer thread; returns once the clones are issued."""
        self.wait()
        fn = save_fn or save_pytree
        snapshot, device = self._snapshot(tree)
        stream = None
        if device is not None:
            if device not in self._streams:
                self._streams[device] = torch.cuda.Stream(device)
            stream = self._streams[device]
            stream.wait_event(torch.cuda.current_stream(device)
                              .record_event())

        def worker():
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    fn(path, snapshot)
            except BaseException as e:  # raised by the next wait()/save()
                self._exc = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight (if any) ends; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
