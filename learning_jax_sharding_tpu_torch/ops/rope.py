"""Rotary position embeddings (RoPE), split-half pairing.

Port of ``learning_jax_sharding_tpu/ops/rope.py``: angles in fp32, rotated
values cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float = 10_000.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position ``(cos, sin)`` of shape ``positions.shape + (head_dim/2,)``."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    exponents = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device
    ) / head_dim
    freqs = theta ** (-exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0
) -> torch.Tensor:
    """Rotate ``x`` ``(B, S, N, H)`` by absolute ``positions`` ``(S,)`` or
    ``(B, S)``."""
    h = x.shape[-1]
    cos, sin = rope_angles(positions, h, theta)
    if cos.ndim == 2:  # (S, H/2) → (1, S, 1, H/2)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, H/2) → (B, S, 1, H/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., : h // 2].float(), x[..., h // 2 :].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)
