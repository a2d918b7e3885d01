"""Explicit collective matmuls: the collectives GSPMD keeps implicit.

Port of ``learning_jax_sharding_tpu/parallel/collectives.py``. Each function
takes DTensors (or full tensors, placed here), runs the per-shard product on
the local shards with the collective written out
(``torch.distributed._functional_collectives``), and returns a DTensor with
the JAX function's output placement. :func:`all_to_all` and the ring hop
(``_ppermute``) are ``lax.all_to_all``/``lax.ppermute`` on a rank's local
tensor, with gradients, for the sequence-parallel attentions and the MoE
dispatch. The int8 ring all-reduce
(``quantized_all_reduce``) is ported with slice F.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.utils._python_dispatch import _disable_current_modes
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from torch.distributed.tensor.experimental import local_map

from learning_jax_sharding_tpu_torch.parallel.hlo import note_permute
from learning_jax_sharding_tpu_torch.parallel.logical import place
from learning_jax_sharding_tpu_torch.parallel.sharding import (
    NamedSharding,
    P,
    put,
    spec_to_placements,
)

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


def shard_map(fn, mesh: DeviceMesh, in_specs, out_specs):
    """``jax.shard_map``: a callable running ``fn`` on each rank's local
    blocks of its tensor args, laid out by ``in_specs`` (mesh-axis
    ``PartitionSpec``s; a plain tensor is taken as the whole array, a
    DTensor is redistributed where it lies otherwise), its output coming
    back as a DTensor laid out by ``out_specs``. Gradients flow through,
    each arg's gradient laid out as the arg."""
    in_pl = tuple(list(spec_to_placements(mesh, s)) for s in in_specs)
    out_pl = list(spec_to_placements(mesh, out_specs))

    def body(*local):
        return fn(*local).contiguous()

    def call(*args):
        moved = [place(a, mesh, pl) for a, pl in zip(args, in_pl)]
        return local_map(body, out_placements=out_pl, in_placements=in_pl,
                         in_grad_placements=in_pl, device_mesh=mesh)(*moved)

    return call


def _axis_group(mesh: DeviceMesh, axis: str):
    """The group of ``axis``, its size and this rank's index in it."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())


def _permute(x: torch.Tensor, group, n: int, me: int, shift: int) -> torch.Tensor:
    """One ring hop over ``group``: an all-to-all whose only non-empty
    split goes ``shift`` ranks ahead and comes from ``shift`` behind. One
    collective serves gloo, NCCL and the threaded group (which has no
    point-to-point sends). Hidden from ``CommDebugMode``: the hop counts as
    a ``collective-permute`` (``note_permute``), never as an all-to-all."""
    x = x.contiguous()
    recv = torch.empty_like(x)
    sends, takes = [0] * n, [0] * n
    sends[(me + shift) % n] = takes[(me - shift) % n] = x.shape[0]
    with _disable_current_modes():
        dist.all_to_all_single(recv, x, output_split_sizes=takes, input_split_sizes=sends,
                               group=group)
    note_permute()
    return recv


class _Permute(torch.autograd.Function):
    """A ring hop; its gradient hops back."""

    @staticmethod
    def forward(ctx, x, group, n, me, shift):
        ctx.hop = (group, n, me, shift)
        return _permute(x, group, n, me, shift)

    @staticmethod
    def backward(ctx, grad):
        group, n, me, shift = ctx.hop
        return _permute(grad, group, n, me, -shift), None, None, None, None


def _ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` steps ahead on ``axis`` and return
    the one from ``shift`` steps behind (a ring hop, ``lax.ppermute`` over a
    cyclic permutation); differentiable, the gradient taking the hop back."""
    group, n, me = _axis_group(mesh, axis)
    return _Permute.apply(x, group, n, me, shift)


def _all_to_all(x: torch.Tensor, group, n: int, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` over ``group``: ``split_axis`` cut in
    ``n`` blocks, block j sent to rank j; the blocks received concatenated
    along ``concat_axis`` in rank order."""
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {n} ranks")
    moved = x.movedim(split_axis, 0)
    blocks = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:]).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single(blocks, None, None, group))
    # got[i] is rank i's block for this rank: its dims back in place, then
    # the rank dim folded into concat_axis ahead of that dim's own entries.
    got = got.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(got.shape)
    shape[concat_axis:concat_axis + 2] = [shape[concat_axis] * shape[concat_axis + 1]]
    return got.reshape(shape)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its gradient is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.swap = (group, n, split_axis, concat_axis)
        return _all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, n, split_axis, concat_axis = ctx.swap
        return _all_to_all(grad, group, n, concat_axis, split_axis), None, None, None, None


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`` on a
    rank's local tensor: ``split_axis`` is cut into one block per rank of
    ``axis`` and block j goes to rank j; the blocks this rank receives are
    concatenated along ``concat_axis`` in rank order. Differentiable (the
    gradient takes the inverse exchange). Counted as one ``all-to-all``."""
    group, n, _ = _axis_group(mesh, axis)
    split_axis, concat_axis = split_axis % x.ndim, concat_axis % x.ndim
    if n == 1:
        return x
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)


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
