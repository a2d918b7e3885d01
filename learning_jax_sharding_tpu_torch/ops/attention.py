"""Dense (fully materialized) multi-head attention op.

Port of ``learning_jax_sharding_tpu/ops/attention.py``: two products with an
fp32 softmax between them. Scores materialize as ``(B, N, Q, K)``.
"""

from __future__ import annotations

import torch


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention over ``(B, S, N, H)`` inputs.

    Scores and softmax are fp32 (the products of bf16 inputs are exact in
    fp32, as with the JAX op's ``preferred_element_type``). Masked scores
    are filled with ``finfo(float32).min``. The weights are cast to the q
    dtype before the second product.

    Args:
        q: ``(B, Q, N, H)``; k, v: ``(B, K, N, H)``.
        scale: defaults to ``H ** -0.5``.
        mask: boolean, broadcastable to ``(B, N, Q, K)``; True keeps.

    Returns:
        ``(B, Q, N, H)`` in ``q.dtype``.
    """
    out_dtype = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "bnqk,bknh->bqnh", weights.to(out_dtype), v.to(out_dtype)
    )


def causal_mask(q_len: int, k_len: int | None = None, *, device=None) -> torch.Tensor:
    """Lower-triangular causal mask ``(1, 1, Q, K)`` (True = attend)."""
    k_len = q_len if k_len is None else k_len
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(k_len, device=device)[None, :]
    return (j <= i)[None, None]


def sliding_window_mask(
    q_len: int, window: int, k_len: int | None = None, *, device=None
) -> torch.Tensor:
    """Causal sliding-window mask ``(1, 1, Q, K)``: query ``i`` attends to
    keys in ``(i - window, i]``."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    k_len = q_len if k_len is None else k_len
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(k_len, device=device)[None, :]
    return ((j <= i) & (j > i - window))[None, None]
