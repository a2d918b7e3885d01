"""Explicit all-to-all expert-parallel MoE dispatch.

Port of ``learning_jax_sharding_tpu/ops/moe_dispatch.py``, the third
dispatch of ``models.moe.MoEFeedForward``: the tokens are bucketed per
token shard by the flop-free scatter (``models.moe.assign_slots`` /
``scatter_slot_ids`` / ``bucket_tokens``, the one slot rule), one
all-to-all over the expert mesh axis trades token shards for expert shards
(``parallel.collectives.all_to_all``), each rank runs its experts' FF, and
one all-to-all brings the outputs home for a local gather-combine.

Experts split over the same mesh axis as the batch (EP = DP,
``parallel.logical.RULES_DP_EP_A2A``). Capacity is per token group (each
shard's T/D tokens), GShard's grouped form: the single-group einsum and
scatter paths are the D = 1 case. No kernel of its own: the products are
``torch.einsum``, as JAX leaves them to XLA.
"""

from __future__ import annotations

import math

from torch.distributed.device_mesh import DeviceMesh

from learning_jax_sharding_tpu_torch.models.moe import (
    assign_slots,
    bucket_tokens,
    combine_slots,
    expert_ff,
    scatter_slot_ids,
)
from learning_jax_sharding_tpu_torch.parallel.collectives import all_to_all, shard_map
from learning_jax_sharding_tpu_torch.parallel.sharding import P


def moe_a2a_ff(
    x,
    probs,
    w_up,
    w_down,
    *,
    mesh: DeviceMesh,
    ep_axis: str,
    top_k: int,
    capacity_factor: float,
    dtype,
):
    """Routed expert FF over ``x (T, M)`` / ``probs (T, E)`` split over
    ``ep_axis`` (dim 0) and the expert stacks ``(E, M, H)`` / ``(E, H, M)``
    split over the same axis (dim 0). Returns ``(T, M)`` split like ``x``
    (a DTensor). Needs ``E % D == 0`` and ``T % D == 0`` for the ``D``
    ranks of ``ep_axis``."""
    d = mesh.size(mesh.mesh_dim_names.index(ep_axis))
    t, _ = x.shape
    e = probs.shape[-1]
    if e % d:
        raise ValueError(
            f"all-to-all dispatch needs num_experts ({e}) divisible by the "
            f"'{ep_axis}' axis size ({d})"
        )
    if t % d:
        raise ValueError(
            f"all-to-all dispatch needs tokens ({t}) divisible by the "
            f"'{ep_axis}' axis size ({d})"
        )

    def local(x_l, probs_l, w_up_l, w_down_l):
        t_l = x_l.shape[0]
        # Per-group capacity (this shard's tokens), GShard's grouped form.
        capacity = min(t_l, max(1, math.ceil(top_k * t_l * capacity_factor / e)))
        gate_vals, gate_idx, pos, fits, masks = assign_slots(probs_l, top_k, capacity)
        flat_slot = scatter_slot_ids(pos, fits, masks, gate_idx, capacity, e)
        buckets = bucket_tokens(x_l, flat_slot, e, capacity, top_k, dtype)   # (E, C, M)
        # Each peer gets its experts' buckets; this rank receives every
        # peer's buckets for its own experts → (E/D, D·C, M).
        recv = all_to_all(buckets, mesh, ep_axis, split_axis=0, concat_axis=1)
        out_slots = expert_ff(recv, w_up_l, w_down_l, dtype)
        # Every token's slots home: (E/D, D·C, M) → (E, C, M).
        back = all_to_all(out_slots, mesh, ep_axis, split_axis=1, concat_axis=0)
        return combine_slots(back, flat_slot, gate_vals, top_k, dtype)

    rows, stack = P(ep_axis, None), P(ep_axis, None, None)
    return shard_map(local, mesh, (rows, rows, stack, stack), rows)(x, probs, w_up, w_down)


def make_moe_a2a_fn(mesh: DeviceMesh, rules=None, ep_axis: str | None = None):
    """A ``dispatch_fn`` for ``MoEFeedForward(dispatch="alltoall")``. The
    expert axis defaults to the mesh axis the rules map ``EXPERT`` to
    (``RULES_DP_EP_A2A`` → ``"data"``; no rule: ``"data"``)."""
    if ep_axis is None:
        from learning_jax_sharding_tpu_torch.parallel.logical import EXPERT

        ep_axis = dict(rules or ()).get(EXPERT, "data")

    def fn(x, probs, w_up, w_down, *, top_k, capacity_factor, dtype):
        return moe_a2a_ff(x, probs, w_up, w_down, mesh=mesh, ep_axis=ep_axis, top_k=top_k,
                          capacity_factor=capacity_factor, dtype=dtype)

    return fn
