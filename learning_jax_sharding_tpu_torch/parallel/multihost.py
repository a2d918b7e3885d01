"""Per-process data feeding over ``torch.distributed``.

Port of the part of ``learning_jax_sharding_tpu/parallel/multihost.py`` that
the batch loader needs. A JAX process (a host) drives several devices; a
``torch.distributed`` rank drives one. So a rank of a mesh loads the rows of
the global batch that its coordinate on the batch's mesh axes owns (the
ranks that share that coordinate load the same rows), and
:func:`host_local_batch` assembles them into one DTensor split as
``(BATCH, ...)``: the layout ``training.pipeline``'s step keeps as it is.
With no process group, or with no mesh, one process holds the whole batch.

``initialize``, the registry gathers and ``sharded_batches`` come with
slice D.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard


def initialize(*args, **kwargs) -> None:
    """Bringing up a multi-host run: ported with slice D (the process group
    of a mesh comes from ``parallel.run_on_mesh`` or the caller's own
    ``init_process_group`` until then)."""
    raise NotImplementedError("multihost.initialize: ported with slice D (training breadth)")


def allgather_registry_snapshots(registry: Any) -> dict:
    """Merging every process's registry snapshot: ported with slice D."""
    raise NotImplementedError(
        "allgather_registry_snapshots: ported with slice D (training breadth)")


def merge_registry_snapshots(per_host, *, labels=None) -> dict:
    """The fleet-merge rule for registry snapshots: ported with slice D."""
    raise NotImplementedError(
        "merge_registry_snapshots: ported with slice D (training breadth)")


def sharded_batches(it, mesh, spec):
    """A process-local batch iterator as global batches: ported with slice
    D (``data.loader.ShardedBatchLoader`` covers the training loop)."""
    raise NotImplementedError("sharded_batches: ported with slice D (training breadth)")


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if _group_up() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _group_up() else 0


def is_primary() -> bool:
    """True on exactly one rank: gate logging and checkpoint metadata."""
    return process_index() == 0


def _batch_axes(spec: Sequence) -> tuple[str, ...]:
    """The mesh axes a spec splits the leading (batch) dim over."""
    first = tuple(spec)[0] if len(tuple(spec)) else None
    if first is None:
        return ()
    return (first,) if isinstance(first, str) else tuple(first)


def local_batch_slice(global_batch: int, mesh=None, spec: Sequence = ("data",)) -> slice:
    """The half-open row range of the global batch this process loads.

    With a mesh: the rows of this rank's coordinate on the mesh axes that
    ``spec`` splits the batch over (in mesh order, the major axis first, as
    DTensor's nested ``Shard(0)`` splits). Without one: the JAX package's rule, an equal
    contiguous slice a process (the whole batch in one process)."""
    if mesh is None:
        n, i = process_count(), process_index()
    else:
        n, i = 1, 0
        axes = _batch_axes(spec)
        for dim, axis in enumerate(mesh.mesh_dim_names):
            if axis in axes:
                n, i = n * mesh.size(dim), i * mesh.size(dim) + mesh.get_local_rank(axis)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} batch shards")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def host_local_batch(local_data: Any, mesh=None, spec: Sequence = ("data",), *,
                     device=None) -> Any:
    """Assemble this process's rows into the global batch.

    ``local_data``: a dict of numpy arrays or tensors (or one leaf) holding
    the :func:`local_batch_slice` rows. With a mesh each leaf becomes a
    DTensor over it, ``Shard(0)`` on the axes ``spec`` splits the batch over
    and replicated on the others, whose local tensor is this rank's rows on
    the mesh's device; no rank holds the whole batch. Without a mesh each
    leaf becomes a tensor on ``device``. A tensor already on its device is
    not copied."""

    def put(leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(leaf))
        if mesh is None:
            return t.to(device)
        axes = _batch_axes(spec)
        placements = [Shard(0) if name in axes else Replicate()
                      for name in mesh.mesh_dim_names]
        return DTensor.from_local(t.to(mesh.device_type), mesh, placements, run_check=False)

    if isinstance(local_data, dict):
        return {k: put(v) for k, v in local_data.items()}
    return put(local_data)
