"""Batch streams: host-side data pipelines feeding the card.

Counterpart of :mod:`lamp_tpu.data.batchstream`: pull-based, restartable
streams of batches with the same combinators and constructors, and
:func:`prefetch_to_device`. A batch is a tensor or numpy array, or a tuple,
list or dict of them.

:func:`prefetch_to_device` is the reference's pinned-buffer prefetch
(SURVEY.md: batches staged in page-locked host buffers and copied to the
card while the previous step computes): a thread copies each batch into
pinned host memory and issues its copy to the card without blocking on a
side stream, recording an event after it; the consumer's stream waits on
that event before the batch is used. For ``device="cpu"`` the thread only
turns the arrays into tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "BatchStream",
    "from_full_batch",
    "minibatches_from_full",
    "from_indices",
    "from_function",
    "staged_from_indices",
    "prefetch_to_device",
]


def _leaves(batch):
    if isinstance(batch, dict):
        return [leaf for k in sorted(batch) for leaf in _leaves(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [leaf for b in batch for leaf in _leaves(b)]
    return [batch]


def _map_batch(fn, batch):
    if isinstance(batch, dict):
        return {k: _map_batch(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        items = [_map_batch(fn, b) for b in batch]
        return type(batch)(*items) if hasattr(batch, "_fields") \
            else type(batch)(items)
    return fn(batch)


class BatchStream:
    """A restartable stream of batches: a zero-argument factory that
    returns an iterator, and its length where known. Combinators: ``map``,
    ``take``, ``concat``, ``every_nth`` (rank sharding), ``repeat_or_take``,
    ``without_empty``, ``fold_left``, ``drain_to_list``."""

    def __init__(self, factory: Callable[[], Iterator],
                 length: Optional[int] = None):
        self._factory = factory
        self.length = length

    def __iter__(self):
        return self._factory()

    def __len__(self):
        if self.length is None:
            raise TypeError("stream length unknown")
        return self.length

    def map(self, fn) -> "BatchStream":
        return BatchStream(lambda: (fn(b) for b in self), self.length)

    def take(self, n: int) -> "BatchStream":
        def gen():
            for i, b in enumerate(self):
                if i >= n:
                    return
                yield b

        return BatchStream(gen, min(n, self.length) if self.length else n)

    def concat(self, other: "BatchStream") -> "BatchStream":
        def gen():
            yield from self
            yield from other

        length = (self.length + other.length
                  if self.length is not None and other.length is not None
                  else None)
        return BatchStream(gen, length)

    def every_nth(self, n: int, offset: int) -> "BatchStream":
        """Every ``n``-th batch from ``offset`` (one stream split across
        data-parallel workers)."""

        def gen():
            for i, b in enumerate(self):
                if i % n == offset:
                    yield b

        length = (None if self.length is None
                  else (self.length - offset + n - 1) // n)
        return BatchStream(gen, length)

    def repeat_or_take(self, n: int) -> "BatchStream":
        """Cycle the stream until exactly ``n`` batches are produced (equal
        batch counts across ranks)."""

        def gen():
            produced = 0
            while produced < n:
                got = False
                for b in self:
                    got = True
                    yield b
                    produced += 1
                    if produced >= n:
                        return
                if not got:
                    return

        return BatchStream(gen, n)

    def without_empty(self) -> "BatchStream":
        """Drop empty batches: those whose first leaf has a zero leading
        dimension."""

        def gen():
            for b in self:
                leaves = _leaves(b)
                if leaves and hasattr(leaves[0], "shape") and \
                        tuple(leaves[0].shape[:1]) == (0,):
                    continue
                yield b

        return BatchStream(gen, None)

    def fold_left(self, init, fn):
        acc = init
        for b in self:
            acc = fn(acc, b)
        return acc

    def drain_to_list(self):
        return list(self)


def from_full_batch(features, target, shuffle_key=None) -> BatchStream:
    """One full batch an epoch."""

    def gen():
        yield (features, target)

    return BatchStream(gen, 1)


def minibatches_from_full(batch_size: int, features, target, *,
                          rng: Optional[np.random.Generator] = None,
                          drop_last: bool = True) -> BatchStream:
    """Shuffled index minibatches over in-memory arrays (numpy arrays or
    tensors; a tensor on the card is copied to the host once an epoch)."""
    n = features.shape[0]

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def gen():
        f_host = host(features)
        t_host = host(target)
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        end = n - (n % batch_size) if drop_last else n
        for s in range(0, end, batch_size):
            sel = idx[s:s + batch_size]
            yield (f_host[sel], t_host[sel])

    nb = n // batch_size if drop_last else (n + batch_size - 1) // batch_size
    return BatchStream(gen, nb)


def from_indices(index_batches: Sequence[Sequence[int]],
                 load: Callable[[np.ndarray], Any]) -> BatchStream:
    """Load batches by explicit index lists."""

    def gen():
        for sel in index_batches:
            yield load(np.asarray(sel))

    return BatchStream(gen, len(index_batches))


def from_function(num_batches: int, fn: Callable[[int], Any]) -> BatchStream:
    """Batch ``i`` is ``fn(i)``."""

    def gen():
        for i in range(num_batches):
            yield fn(i)

    return BatchStream(gen, num_batches)


def staged_from_indices(bucket_indices: Sequence[Sequence[int]],
                        batches_per_bucket: int,
                        load_bucket: Callable[[np.ndarray], Any],
                        slice_batch: Callable[[Any, np.ndarray], Any], *,
                        rng: Optional[np.random.Generator] = None
                        ) -> BatchStream:
    """Two-stage loader: load a large bucket (from disk, say), cut it into
    shuffled minibatches, and open the next bucket ahead on a background
    thread."""

    def gen():
        pool: queue.Queue = queue.Queue(maxsize=1)

        def loader():
            for bidx in bucket_indices:
                pool.put(load_bucket(np.asarray(bidx)))
            pool.put(None)

        t = threading.Thread(target=loader, daemon=True)
        t.start()
        while True:
            bucket = pool.get()
            if bucket is None:
                return
            size = len(bucket[0]) if isinstance(bucket, tuple) \
                else len(bucket)
            order = np.arange(size)
            if rng is not None:
                rng.shuffle(order)
            per = size // batches_per_bucket
            for i in range(batches_per_bucket):
                sel = order[i * per:(i + 1) * per]
                if len(sel):
                    yield slice_batch(bucket, sel)

    return BatchStream(gen, len(bucket_indices) * batches_per_bucket)


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


def prefetch_to_device(stream: Iterable, *, size: int = 2, device=None,
                       sharding=None) -> Iterator:
    """Yield the batches of ``stream`` as tensors on ``device`` (default
    ``"cuda"``), staged by a background thread that keeps ``size`` batches
    ahead.

    On the card, each array goes into pinned host memory and is copied on a
    side stream without blocking; the consumer's current stream waits on
    an event recorded after those copies, and the batch's tensors are
    recorded as used on it, so the next step overlaps the next batch's
    copy. An error of the stream is raised to the consumer where the batch
    would have come. ``sharding`` (a JAX placement) raises
    ``NotImplementedError`` until the port's ``parallel`` exists."""
    if sharding is not None:
        raise NotImplementedError("prefetch_to_device: sharding= (the port "
                                  "has no parallel package yet)")
    device = torch.device("cuda" if device is None else device)
    cuda = device.type == "cuda"
    if cuda:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        side = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    done = object()

    def stage(batch):
        host = _map_batch(_as_tensor, batch)
        if not cuda:
            return host, None
        pinned = _map_batch(
            lambda t: t.pin_memory() if isinstance(t, torch.Tensor)
            and t.device.type == "cpu" else t, host)
        with torch.cuda.stream(side):
            moved = _map_batch(
                lambda t: t.to(device, non_blocking=True)
                if isinstance(t, torch.Tensor) else t, pinned)
            ready = torch.cuda.Event()
            ready.record(side)
        return moved, ready

    def worker():
        try:
            for batch in stream:
                q.put(stage(batch))
        except BaseException as e:  # raised to the consumer
            q.put(e)
        else:
            q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        batch, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for t in _leaves(batch):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(consumer)
        yield batch
