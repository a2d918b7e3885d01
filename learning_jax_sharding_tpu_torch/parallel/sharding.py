"""Sharding specification, placement, and shard introspection.

Port of ``learning_jax_sharding_tpu/parallel/sharding.py``. A JAX
``NamedSharding(mesh, PartitionSpec(...))`` names, for each ARRAY dim, the
mesh axes it is split over; a DTensor's placements name, for each MESH dim,
the array dim it splits (``Shard(d)``) or ``Replicate()``.
:class:`NamedSharding` keeps the JAX spelling and converts
(:func:`spec_to_placements`), so callers read as they do in JAX.

The introspection probes (:func:`shard_shapes`, :func:`unique_shard_count`)
gather every rank's local shard, so any rank answers for the whole array as
JAX's ``addressable_shards`` does in one process; shards come in rank order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

Axes = str | Sequence[str] | None


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per array dim, each ``None``, a
    mesh axis name, or a tuple of names (major first)."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            tuple(a) if isinstance(a, list) else a for a in axes
        ))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_to_placements(mesh: DeviceMesh, spec: Sequence) -> tuple[Placement, ...]:
    """A ``PartitionSpec`` → one DTensor placement per mesh dim. Two mesh
    axes on one array dim must come in mesh order: DTensor splits a dim over
    its mesh dims major-first, in that order."""
    names = mesh.mesh_dim_names
    out: list[Placement] = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        idx = []
        for axis in axes:
            if axis not in names:
                raise ValueError(f"mesh has no axis {axis!r}: {names}")
            i = names.index(axis)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {axis!r} named twice in {spec}")
            out[i] = Shard(dim)
            idx.append(i)
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec entry {entry!r} lists mesh axes out of mesh order {names}"
            )
    return tuple(out)


def placements_to_spec(mesh: DeviceMesh, placements: Sequence[Placement], ndim: int) -> PartitionSpec:
    """DTensor placements → the ``PartitionSpec`` JAX would print (Partial
    placements have no spec entry: they read as replicated)."""
    spec: list = [None] * ndim
    for name, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            cur = spec[pl.dim]
            spec[pl.dim] = name if cur is None else _names(cur) + (name,)
    return P(*spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a spec over its axis names."""

    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple[Placement, ...]:
        return spec_to_placements(self.mesh, self.spec)


# ---------------------------------------------------------------------------
# Placement helpers
# ---------------------------------------------------------------------------


def mesh_sharding(mesh: DeviceMesh, *axes: Axes) -> NamedSharding:
    """``NamedSharding(mesh, P(*axes))``: the one way to spell a placement."""
    return NamedSharding(mesh, P(*axes))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    """Every device holds the whole array."""
    return NamedSharding(mesh, P())


def shard_dims(mesh: DeviceMesh, ndim: int, **dim_axes: int) -> NamedSharding:
    """Shard array dims over named mesh axes, replicate the rest:
    ``shard_dims(mesh, 2, x=0, y=1)``. Several mesh axes may split one dim;
    they combine into a tuple entry (in keyword order)."""
    spec: list = [None] * ndim
    for axis_name, dim in dim_axes.items():
        if axis_name not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {axis_name!r}: {mesh.mesh_dim_names}")
        if not 0 <= dim < ndim:
            raise ValueError(f"array dim {dim} out of range for ndim={ndim}")
        cur = spec[dim]
        spec[dim] = axis_name if cur is None else _names(cur) + (axis_name,)
    return NamedSharding(mesh, P(*spec))


def row_sharded(mesh: DeviceMesh, axis: str, *, ndim: int = 2) -> NamedSharding:
    """Dim 0 (rows) over ``axis``: the data-parallel operand placement."""
    return shard_dims(mesh, ndim, **{axis: 0})


def col_sharded(mesh: DeviceMesh, axis: str, *, ndim: int = 2) -> NamedSharding:
    """The last dim (columns) over ``axis``: the tensor-parallel weight
    placement."""
    return shard_dims(mesh, ndim, **{axis: ndim - 1})


def local_slice(x: torch.Tensor, mesh: DeviceMesh, placements: Sequence[Placement]) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``placements``
    (even splits only, as JAX requires), sliced with no communication."""
    coords = mesh.get_coordinate()
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(mdim)
            if x.shape[pl.dim] % n:
                raise ValueError(
                    f"dim {pl.dim} of size {x.shape[pl.dim]} does not split {n} ways"
                )
            size = x.shape[pl.dim] // n
            x = x.narrow(pl.dim, coords[mdim] * size, size)
    return x


def local_rows(x: torch.Tensor, mesh: DeviceMesh, placements: Sequence[Placement]) -> torch.Tensor:
    """This rank's rows of a whole per-row tensor ``x``: dim 0 sliced as
    ``placements`` split dim 0 of the tensor they lay out (splits of its
    other dims take every row)."""
    return local_slice(x, mesh, [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                                 for pl in placements])


def put(x, sharding: NamedSharding | Sequence[Placement], mesh: DeviceMesh | None = None) -> DTensor:
    """``jax.device_put``: the full array ``x`` (numpy or a tensor, the same
    on every rank) → a DTensor on the mesh's device. Each rank keeps its own
    slice; nothing is sent."""
    if isinstance(sharding, NamedSharding):
        mesh, placements = sharding.mesh, sharding.placements
    else:
        placements = tuple(sharding)
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    local = local_slice(x, mesh, placements).to(mesh.device_type).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


# ---------------------------------------------------------------------------
# Shard introspection
# ---------------------------------------------------------------------------


def _gather(obj, mesh: DeviceMesh) -> list:
    """``obj`` of every rank, in rank order (the mesh spans the world)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _local_of(x) -> torch.Tensor:
    if isinstance(x, DTensor):
        if any(isinstance(p, Partial) for p in x.placements):
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(p, Partial) else p for p in x.placements
            ])
        return x.to_local()
    return x


def shard_shapes(x) -> list[tuple[int, ...]]:
    """Per-device shard shapes, in rank order (every rank gets the list)."""
    if not isinstance(x, DTensor):
        return [tuple(x.shape)]
    return [tuple(s) for s in _gather(tuple(_local_of(x).shape), x.device_mesh)]


def shard_arrays(x) -> list[np.ndarray]:
    """Every rank's shard on the host, in rank order."""
    if not isinstance(x, DTensor):
        return [x.detach().cpu().numpy()]
    return _gather(_local_of(x).detach().cpu().numpy(), x.device_mesh)


def unique_shard_count(x) -> int:
    """Number of distinct shard contents across devices: 1 when fully
    replicated, the device count when every tile differs."""
    seen: list[np.ndarray] = []
    for arr in shard_arrays(x):
        if not any(a.shape == arr.shape and np.array_equal(a, arr) for a in seen):
            seen.append(arr)
    return len(seen)


def is_fully_replicated(x) -> bool:
    """True if every device holds the full array."""
    if not isinstance(x, DTensor):
        return True
    return all(isinstance(p, Replicate) for p in x.placements)


def assert_shard_shape(x, expected: tuple[int, ...]) -> None:
    """Assert every shard has shape ``expected``."""
    shapes = set(shard_shapes(x))
    if shapes != {tuple(expected)}:
        raise AssertionError(f"expected uniform shard shape {tuple(expected)}, got {shapes}")


def assert_replicated(x, full: np.ndarray | None = None) -> None:
    """Assert full replication; optionally that every shard equals ``full``."""
    if not is_fully_replicated(x):
        raise AssertionError(f"array is not fully replicated: {x.placements}")
    if full is not None:
        for arr in shard_arrays(x):
            if not np.allclose(arr, full):
                raise AssertionError("replicated shard differs from reference array")


def layout_text(x: DTensor) -> str:
    """The array's tiles as text: one line per rank with its mesh
    coordinate and the index ranges of the tile it holds."""
    mesh, shape = x.device_mesh, tuple(x.shape)
    lines = [f"{tuple(shape)} over {dict(zip(mesh.mesh_dim_names, mesh.shape))}: "
             f"{placements_to_spec(mesh, x.placements, len(shape))}"]
    grid = mesh.mesh.reshape(-1).tolist()
    coords = [np.unravel_index(i, mesh.shape) for i in range(len(grid))]
    for rank, coord in zip(grid, coords):
        ranges = []
        for d, size in enumerate(shape):
            lo, hi = 0, size
            for mdim, pl in enumerate(x.placements):
                if isinstance(pl, Shard) and pl.dim == d:
                    step = (hi - lo) // mesh.size(mdim)
                    lo, hi = lo + int(coord[mdim]) * step, lo + (int(coord[mdim]) + 1) * step
            ranges.append(f"{lo}:{hi}")
        lines.append(f"  rank {rank} {tuple(int(c) for c in coord)}: [{', '.join(ranges)}]")
    return "\n".join(lines)


def visualize(x) -> None:
    """Print the layout (rank 0 prints): ``jax.debug.visualize_array_sharding``."""
    if not isinstance(x, DTensor):
        print(f"{tuple(x.shape)}: not sharded")
        return
    if dist.get_rank() == 0:
        print(layout_text(x))
