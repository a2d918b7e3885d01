"""Batch loader: each process's numpy rows → the global batch on the
model's device.

Port of ``learning_jax_sharding_tpu/data/loader.py``. Each process (each
rank of a mesh) loads only its :func:`parallel.multihost.local_batch_slice`
rows, and :func:`parallel.multihost.host_local_batch` assembles them: over a
mesh a DTensor split as ``(BATCH, ...)``, on one device a tensor there.

Prefetch runs the loading (the dataset's numpy work and the host→device
copy) on a background thread. On a GPU that thread copies from pinned host
memory on a CUDA stream of its own and records an event after the copies;
the consumer's stream waits on that event and the batch's tensors are
recorded on the consumer's stream, so a step never reads a batch before it
has arrived and the allocator never reuses its memory early. The batches
are the same bits with prefetch on or off.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from learning_jax_sharding_tpu_torch import resolve_device
from learning_jax_sharding_tpu_torch.parallel.multihost import (
    host_local_batch,
    local_batch_slice,
)


@dataclasses.dataclass
class ShardedBatchLoader:
    """Global batches from a per-process-sliceable dataset.

    Args:
        dataset: an object with ``batch(index, rows, batch_size) -> dict of
            numpy arrays`` (both datasets of :mod:`data.datasets` qualify).
        mesh: the ``DeviceMesh`` the batches are laid out over, or None for
            one device.
        batch_size: the GLOBAL batch size.
        spec: the mesh axes of each leaf's dims; the leading (batch) dim's
            entry is what is split (``("data",)``: the batch over the data
            axis, the JAX package's input placement).
        start_index: the first batch index (the step count when resuming).
        device: without a mesh, where the batches land (None: the GPU,
            raising without one, the port's rule); pass the model's device.
    """

    dataset: Any
    mesh: Any = None
    batch_size: int = 8
    spec: Sequence = ("data",)
    start_index: int = 0
    device: Any = None

    def __post_init__(self):
        # The rank's rows, read once here on the caller's thread (a mesh's
        # coordinates belong to the thread of its rank).
        self._rows = (None if self.mesh is None
                      else local_batch_slice(self.batch_size, self.mesh, self.spec))
        device = (torch.device(self.mesh.device_type) if self.mesh is not None
                  else resolve_device(self.device))
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self._device = device

    def load_local(self, index: int, *, pin: bool = False) -> dict:
        """This process's rows of batch ``index`` as tensors on the device
        (``pin``: through pinned host memory, the copy ``non_blocking``)."""
        local = self.dataset.batch(index, rows=self._rows, batch_size=self.batch_size)

        def put(leaf):
            t = torch.from_numpy(np.ascontiguousarray(leaf))
            if pin and self._device.type == "cuda":
                return t.pin_memory().to(self._device, non_blocking=True)
            return t.to(self._device)

        return {k: put(v) for k, v in local.items()}

    def assemble(self, local: dict) -> dict:
        """The global batch from this process's device rows."""
        return host_local_batch(local, self.mesh, self.spec, device=self._device)

    def batch_at(self, index: int) -> dict:
        """The global batch of step ``index`` (random access: a resume needs
        no iterator state)."""
        return self.assemble(self.load_local(index))

    def __iter__(self) -> Iterator[dict]:
        index = self.start_index
        while True:
            yield self.batch_at(index)
            index += 1

    def prefetched(self, depth: int = 2, start: int | None = None) -> "PrefetchIterator":
        """Iterate with a background thread keeping ``depth`` batches ahead
        (``start`` overrides ``start_index``). Its ``close()`` always stops
        the thread and drops the buffered batches, even if no batch was ever
        taken."""
        if depth < 1:
            raise ValueError(f"prefetch depth must be ≥ 1, got {depth}")
        return PrefetchIterator(self, depth, self.start_index if start is None else start)


class PrefetchIterator:
    """Background-thread batch iterator (see
    :meth:`ShardedBatchLoader.prefetched`).

    ``close()`` is unconditional: it stops the producer, drains the queue
    and joins the thread whether or not iteration ever started. Also a
    context manager."""

    def __init__(self, loader: ShardedBatchLoader, depth: int, start: int):
        self._loader = loader
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        cuda = loader._device.type == "cuda"
        self._stream = torch.cuda.Stream(loader._device) if cuda else None

        def producer():
            index = start
            try:
                if cuda:
                    torch.cuda.set_device(loader._device)
                while not self._stop.is_set():
                    if cuda:
                        with torch.cuda.stream(self._stream):
                            local = loader.load_local(index, pin=True)
                            ready = torch.cuda.Event()
                            ready.record(self._stream)
                    else:
                        local, ready = loader.load_local(index), None
                    self._q.put(("ok", (local, ready)))
                    index += 1
            except Exception as e:               # surfaced on the consumer side
                self._q.put(("error", e))

        self._thread = threading.Thread(target=producer, name="prefetch", daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        # After close() the producer is gone and nothing will put again: a
        # bare get() would block forever.
        if self._closed:
            raise RuntimeError("PrefetchIterator is closed")
        kind, item = self._q.get()
        if kind == "error":
            self.close()
            raise item
        local, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._loader._device)
            consumer.wait_event(ready)
            for t in local.values():
                t.record_stream(consumer)
        return self._loader.assemble(local)

    def close(self) -> None:
        self._closed = True
        self._stop.set()
        # Drain until the producer is gone: it may be blocked on a full
        # queue, or finishing one more batch.
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        while not self._q.empty():
            self._q.get_nowait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if not self._closed and hasattr(self, "_thread"):
            self.close()
