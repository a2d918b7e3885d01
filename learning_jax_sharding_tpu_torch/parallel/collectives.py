"""Explicit collective matmuls: the collectives GSPMD keeps implicit.

Port of ``learning_jax_sharding_tpu/parallel/collectives.py``. Each function
takes DTensors (or full tensors, placed here), runs the per-shard product on
the local shards with the collective written out
(``torch.distributed._functional_collectives``), and returns a DTensor with
the JAX function's output placement. The int8 ring all-reduce
(``quantized_all_reduce``) is ported with slice F.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from learning_jax_sharding_tpu_torch.parallel.hlo import note_permute
from learning_jax_sharding_tpu_torch.parallel.sharding import P, NamedSharding, put

# The tiled all-gather and reduce-scatter under their current names (newer
# PyTorch renames the ``*_tensor`` spellings ``*_single``).
all_gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
reduce_scatter = getattr(funcol, "reduce_scatter_single", funcol.reduce_scatter_tensor)


def _local(x, mesh: DeviceMesh, spec) -> torch.Tensor:
    """The local shard of ``x`` placed as ``spec`` (a full tensor is
    sliced; a DTensor is redistributed first when it lies otherwise)."""
    sharding = NamedSharding(mesh, spec)
    if not isinstance(x, DTensor):
        return put(x, sharding).to_local()
    if tuple(x.placements) != sharding.placements:
        x = x.redistribute(mesh, sharding.placements)
    return x.to_local()


def _wrap(local: torch.Tensor, mesh: DeviceMesh, spec, shape) -> DTensor:
    return DTensor.from_local(local, mesh, NamedSharding(mesh, spec).placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def psum_matmul(a, b, *, mesh: DeviceMesh, axis: str) -> DTensor:
    """Case 1a made explicit: the contraction dim of both operands over
    ``axis`` → local partial products + all-reduce → replicated output."""
    a_l, b_l = _local(a, mesh, P(None, axis)), _local(b, mesh, P(axis, None))
    out = funcol.all_reduce(a_l @ b_l, "sum", mesh.get_group(axis))
    return _wrap(funcol.wait_tensor(out), mesh, P(), (a.shape[0], b.shape[1]))


def allgather_matmul(a, b, *, mesh: DeviceMesh, a_axis: str | None = None,
                     b_axis: str | None = None) -> DTensor:
    """Case 1b made explicit: mismatched contraction shardings → all-gather
    both operands whole, then one local product → replicated output."""
    a_l, b_l = _local(a, mesh, P(None, a_axis)), _local(b, mesh, P(b_axis, None))
    if a_axis:
        a_l = all_gather(a_l, 1, mesh.get_group(a_axis))
    if b_axis:
        b_l = all_gather(b_l, 0, mesh.get_group(b_axis))
    return _wrap(a_l @ b_l, mesh, P(), (a.shape[0], b.shape[1]))


def reduce_scatter_matmul(a, b, *, mesh: DeviceMesh, axis: str, scatter_dim: int = 0) -> DTensor:
    """Contraction-sharded product whose partial sums are reduce-scattered:
    the output arrives split over ``axis`` along ``scatter_dim``."""
    a_l, b_l = _local(a, mesh, P(None, axis)), _local(b, mesh, P(axis, None))
    part = (a_l @ b_l).contiguous()
    out = reduce_scatter(part, "sum", scatter_dim, mesh.get_group(axis))
    spec = [None, None]
    spec[scatter_dim] = axis
    return _wrap(funcol.wait_tensor(out), mesh, P(*spec), (a.shape[0], b.shape[1]))


def dp_tp_matmul(a, b, *, mesh: DeviceMesh, dp_axis: str, tp_axis: str) -> DTensor:
    """Case 4 made explicit: data-parallel rows × tensor-parallel columns;
    the output is born 2-D sharded and no collective runs."""
    a_l, b_l = _local(a, mesh, P(dp_axis, None)), _local(b, mesh, P(None, tp_axis))
    return _wrap(a_l @ b_l, mesh, P(dp_axis, tp_axis), (a.shape[0], b.shape[1]))


def quantized_all_reduce(*args, **kwargs):
    """The int8-payload ring all-reduce: ported with slice F (compression,
    fleet and tenancy)."""
    raise NotImplementedError("quantized_all_reduce: ported with slice F (compression)")


def _ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` steps ahead on ``axis`` and return
    the one from ``shift`` steps behind (a ring hop)."""
    group = mesh.get_group(axis)
    n, me = dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    note_permute()
    return recv


def ring_allgather_matmul(a, b, *, mesh: DeviceMesh, axis: str) -> DTensor:
    """Ring matmul: B's contraction rows stay split over ``axis`` and rotate
    around the ring (one hop a step) while each rank multiplies the block it
    holds against the matching columns of the replicated A; after ``n``
    steps every rank holds the whole product."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    a_l, b_cur = _local(a, mesh, P()), _local(b, mesh, P(axis, None))
    idx = mesh.get_local_rank(axis)
    kb = b_cur.shape[0]
    acc = torch.zeros(a_l.shape[0], b_cur.shape[1], dtype=a_l.dtype, device=a_l.device)
    for i in range(n):
        k = (idx + i) % n
        acc = acc + a_l[:, k * kb:(k + 1) * kb] @ b_cur
        # Rank j's block goes to rank j - 1, so rank d holds block d + i + 1 next.
        b_cur = _ppermute(b_cur, mesh, axis, -1)
    return _wrap(acc, mesh, P(), (a.shape[0], b.shape[1]))
