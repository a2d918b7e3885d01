"""Ring attention: sequence (context) parallelism over a mesh axis.

Port of ``learning_jax_sharding_tpu/ops/ring_attention.py``. q/k/v stay
split along the sequence over a mesh axis; the k/v blocks rotate around
that axis (``parallel.collectives._ppermute``, one hop a step) while each
rank folds the visiting block into a running fp32 online softmax
(blockwise attention, Liu et al.). After ``n`` blocks every query has seen
every key, and no rank ever held more than S/n keys.

As in JAX there is no kernel here: the fold is dense torch ops on each
rank's blocks (``parallel.collectives.shard_map``), and gradients come by
autograd through the hops, whose backward sends each gradient back the way
its block came.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from learning_jax_sharding_tpu_torch.parallel.collectives import _ppermute, shard_map
from learning_jax_sharding_tpu_torch.parallel.sharding import P

_NEG_INF = -1e30


def _block_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, Sq, N, H) × (B, Sk, N, H) → fp32 scores (B, N, Sq, Sk)."""
    return torch.einsum("bqnh,bknh->bnqk", q.float() * scale, k.float())


def ring_attention(
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
):
    """Attention over ``(B, S, N, H)`` inputs whose S dim is split over the
    mesh axis ``axis``; returns the output split the same way (a DTensor).

    ``batch_axis`` / ``heads_axis`` name mesh axes the batch / heads dims
    are already split over: attention is independent along both, so they
    partition the work. Memory a rank: S/n keys and values plus one
    ``(B, N, S/n, S/n)`` fp32 score block at a time."""
    h = q.shape[-1]
    scale = h**-0.5 if scale is None else scale
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def local(q_blk, k_blk, v_blk):
        # q_blk: this rank's query chunk, fixed; k/v rotate.
        idx = mesh.get_local_rank(axis)
        b, sq, heads, _ = q_blk.shape
        sk = k_blk.shape[1]
        dev = q_blk.device
        q_pos = idx * sq + torch.arange(sq, device=dev)[:, None]   # global q positions
        acc = torch.zeros(b, heads, sq, h, dtype=torch.float32, device=dev)
        m = torch.full((b, heads, sq, 1), _NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)

        def fold(acc, m, l, k_cur, v_cur, src):
            """Fold the visiting block (global chunk ``src``) into the
            running online softmax."""
            s = _block_scores(q_blk, k_cur, scale)                  # (B, N, Sq, Sk)
            if causal:
                k_pos = src * sk + torch.arange(sk, device=dev)[None, :]
                s = torch.where(q_pos >= k_pos, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            # Rows with no visible key yet: exp(-1e30 - (-1e30)) = 1 would
            # pollute l, so the shift is clamped and masked scores zeroed.
            p = torch.exp(s - torch.clamp(m_new, min=_NEG_INF / 2))
            p = torch.where(s <= _NEG_INF / 2, 0.0, p)
            correction = torch.exp(torch.clamp(m - m_new, max=0.0))
            l_new = l * correction + p.sum(-1, keepdim=True)
            pv = torch.einsum("bnqk,bknh->bnqh", p, v_cur.float())
            return acc * correction + pv, m_new, l_new

        # After i hops to the right this rank holds chunk (idx - i) mod n.
        # n - 1 hops; the last visiting block is folded after the loop, so
        # no hop ships a block nobody reads.
        k_cur, v_cur = k_blk, v_blk
        for i in range(n - 1):
            k_nxt = _ppermute(k_cur, mesh, axis, 1)
            v_nxt = _ppermute(v_cur, mesh, axis, 1)
            acc, m, l = fold(acc, m, l, k_cur, v_cur, (idx - i) % n)
            k_cur, v_cur = k_nxt, v_nxt
        acc, m, l = fold(acc, m, l, k_cur, v_cur, (idx - (n - 1)) % n)
        safe_l = torch.where(l == 0.0, 1.0, l)
        out = (acc / safe_l).to(q_blk.dtype)                       # (B, N, Sq, H)
        return out.transpose(1, 2)                                 # (B, Sq, N, H)

    spec = P(batch_axis, axis, heads_axis, None)
    return shard_map(local, mesh, (spec, spec, spec), spec)(q, k, v)


def make_ring_attn_fn(mesh: DeviceMesh, rules: Any, axis: str | None = None):
    """An ``attn_fn`` for :class:`models.attention.MultiHeadAttention`
    running ring attention over the mesh axis the rules map ``SEQ`` to
    (``axis`` overrides it); the batch and heads axes come from the same
    rules, so dims already split partition the ring's work."""
    from learning_jax_sharding_tpu_torch.parallel.logical import attention_mesh_axes

    batch_axis, seq_axis, heads_axis = attention_mesh_axes(rules, axis)

    def attn_fn(q, k, v, *, causal: bool = False):
        return ring_attention(q, k, v, mesh=mesh, axis=seq_axis, causal=causal,
                              batch_axis=batch_axis, heads_axis=heads_axis)

    return attn_fn
