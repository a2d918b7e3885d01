"""Shared serving-path plumbing for the decoding entry points.

Port of ``learning_jax_sharding_tpu/models/decoding.py``:

* :func:`derive_decode_config` — a training config's decode variant;
* :func:`make_param_caster` — the eager cast of a state dict to
  ``inference_dtype``;
* :func:`make_cached_apply` — the model call every decoder loops over;
* :func:`check_sequence_budget` — the prompt + new vs ``max_seq_len`` guard.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from learning_jax_sharding_tpu_torch.models.transformer import (
    DecodeCache,
    Transformer,
    TransformerConfig,
)


def derive_decode_config(
    config: TransformerConfig, inference_dtype: torch.dtype | None = None
) -> TransformerConfig:
    """Decode variant of a training config: KV caches on, dropout off, and,
    with ``inference_dtype``, compute and param dtypes swapped to it."""
    cfg = dataclasses.replace(config, decode=True, dropout_rate=0.0)
    if inference_dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=inference_dtype, param_dtype=inference_dtype)
    return cfg


def make_param_caster(
    inference_dtype: torch.dtype | None, device=None
) -> Callable[[Mapping[str, torch.Tensor]], dict]:
    """Eager ``maybe_cast(state_dict)``: floating tensors to
    ``inference_dtype`` (kept as they are when ``None``), everything moved
    to ``device``. Once per generate call, never per step."""

    def maybe_cast(params: Mapping[str, torch.Tensor]) -> dict:
        out = {}
        for name, value in params.items():
            value = torch.as_tensor(value, device=device)
            if inference_dtype is not None and value.is_floating_point():
                value = value.to(inference_dtype)
            out[name] = value
        return out

    return maybe_cast


def make_cached_apply(
    model: Transformer,
) -> Callable[..., tuple[torch.Tensor, DecodeCache]]:
    """``apply(cache, tokens, chunk_lengths=None) -> (fp32 logits, cache)``.
    With ``cache=None`` the call creates zeroed caches (prefill); later
    calls pass the cache on, which the model updates in place."""

    def apply(cache, tokens, chunk_lengths=None):
        if cache is None:
            cache = model.init_cache(tokens.shape[0])
        logits = model(tokens, cache=cache, chunk_lengths=chunk_lengths)
        return logits.float(), cache

    return apply


def check_sequence_budget(needed: int, max_seq_len: int, what: str) -> None:
    """Raise if a decode plan would write past the KV caches."""
    if needed > max_seq_len:
        raise ValueError(f"{what} ({needed}) exceeds max_seq_len ({max_seq_len})")
