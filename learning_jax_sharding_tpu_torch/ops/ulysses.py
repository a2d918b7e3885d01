"""Ulysses attention: sequence parallelism by an all-to-all head/sequence swap.

Port of ``learning_jax_sharding_tpu/ops/ulysses.py``. Where ring attention
rotates k/v blocks around the mesh axis (n − 1 hops), Ulysses pays one
all-to-all before and one after the attention: each rank trades its
sequence shard for a head shard, (B, S/n, N, H) → (B, S, N/n, H)
(``parallel.collectives.all_to_all``), computes complete attention for its
heads with any backend (the dense op, or the flash kernels through
``make_flash_attn_fn()``, which then see the whole sequence), and swaps
back. Needs the per-rank head count divisible by n; ring has no such
constraint. No kernel of its own: the swaps are collectives, the inner
backend brings its kernels.
"""

from __future__ import annotations

from typing import Any, Callable

from torch.distributed.device_mesh import DeviceMesh

from learning_jax_sharding_tpu_torch.ops.attention import causal_mask, dot_product_attention
from learning_jax_sharding_tpu_torch.parallel.collectives import all_to_all, shard_map
from learning_jax_sharding_tpu_torch.parallel.sharding import P


def ulysses_attention(
    q,
    k,
    v,
    *,
    mesh: DeviceMesh,
    axis: str,
    causal: bool = False,
    scale: float | None = None,
    batch_axis: str | None = None,
    heads_axis: str | None = None,
    attn_fn: Callable | None = None,
):
    """Attention over ``(B, S, N, H)`` inputs whose S dim is split over the
    mesh axis ``axis``; returns the output split the same way (a DTensor).

    ``causal`` is exact: each rank sees the whole sequence for its heads.
    ``scale`` goes to the dense backend (default H^-0.5). ``batch_axis`` /
    ``heads_axis``: mesh axes the batch / heads dims are already split
    over (``heads_axis`` must differ from ``axis``, which the swap splits
    heads over itself). ``attn_fn``: the per-rank backend ``(q, k, v, *,
    causal)`` on whole-sequence ``(B, S, N/n, H)`` operands (e.g. the flash
    kernels); None takes the dense fp32-softmax op."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if heads_axis == axis:
        raise ValueError(f"heads_axis must differ from the sequence axis {axis!r}")
    heads_ranks = mesh.size(mesh.mesh_dim_names.index(heads_axis)) if heads_axis else 1
    local_heads = q.shape[2] // heads_ranks
    if local_heads % n != 0:
        raise ValueError(
            f"Ulysses needs per-device head count ({local_heads}) divisible "
            f"by the '{axis}' axis size ({n}); use ring attention otherwise"
        )

    def local(q_blk, k_blk, v_blk):
        # (B, S/n, N, H) → (B, S, N/n, H): scatter heads, gather sequence.
        qh, kh, vh = (all_to_all(t, mesh, axis, split_axis=2, concat_axis=1)
                      for t in (q_blk, k_blk, v_blk))
        if attn_fn is not None:
            out = attn_fn(qh, kh, vh, causal=causal)
        else:
            mask = causal_mask(qh.shape[1], device=qh.device) if causal else None
            out = dot_product_attention(qh, kh, vh, scale=scale, mask=mask)
        # (B, S, N/n, H) → (B, S/n, N, H): back to sequence shards.
        return all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)

    spec = P(batch_axis, axis, heads_axis, None)
    return shard_map(local, mesh, (spec, spec, spec), spec)(q, k, v)


def make_ulysses_attn_fn(mesh: DeviceMesh, rules: Any, axis: str | None = None,
                         attn_fn: Callable | None = None) -> Callable:
    """An ``attn_fn`` for :class:`models.attention.MultiHeadAttention`
    running Ulysses over the mesh axis the rules map ``SEQ`` to (the
    counterpart of ``ops.ring_attention.make_ring_attn_fn``). ``attn_fn``
    sets the per-rank backend inside the swap (e.g.
    ``make_flash_attn_fn()``)."""
    from learning_jax_sharding_tpu_torch.parallel.logical import attention_mesh_axes

    batch_axis, seq_axis, heads_axis = attention_mesh_axes(rules, axis)
    if heads_axis == seq_axis:
        raise ValueError(
            f"rules map both SEQ and HEADS to mesh axis {seq_axis!r}; Ulysses "
            "re-shards heads over that axis itself"
        )

    def fn(q, k, v, *, causal: bool = False):
        return ulysses_attention(q, k, v, mesh=mesh, axis=seq_axis, causal=causal,
                                 batch_axis=batch_axis, heads_axis=heads_axis, attn_fn=attn_fn)

    return fn
