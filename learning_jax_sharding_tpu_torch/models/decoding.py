"""Shared serving-path plumbing for the decoding entry points.

Port of ``learning_jax_sharding_tpu/models/decoding.py``:

* :func:`derive_decode_config` — a training config's decode variant;
* :func:`apply_dequantize_policy` — the quantized-serving policy (the
  ``dequantize`` modes);
* :func:`make_param_caster` — the eager cast of a state dict to
  ``inference_dtype``, leaving quantized nodes as they are;
* :func:`make_cached_apply` — the model call every decoder loops over,
  optionally dequantizing an int8/int4 state dict inside each call;
* :func:`check_sequence_budget` — the prompt + new vs ``max_seq_len`` guard.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from learning_jax_sharding_tpu_torch.models.quantize import dequantize_tree, map_unquantized
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


def apply_dequantize_policy(
    cfg: TransformerConfig, dequantize: bool | str
) -> tuple[TransformerConfig, bool]:
    """The quantized-serving policy, on one device: validates the
    ``dequantize`` mode and, for the fused modes, sets the config's
    ``quantization`` so an int4 state dict applies as it is through the
    fused kernels (``"fused_w4a8"``: with per-row int8 activations).

    Returns ``(cfg, fused)``: callers build their cached apply with
    ``dequantize=bool(dequantize) and not fused`` and their param caster
    with ``dequantize=bool(dequantize)``."""
    if isinstance(dequantize, str) and dequantize not in ("fused", "fused_w4a8"):
        raise ValueError(
            f"dequantize must be False, True, 'fused', or 'fused_w4a8'; "
            f"got {dequantize!r}"
        )
    fused = dequantize in ("fused", "fused_w4a8")
    if fused:
        cfg = dataclasses.replace(
            cfg, quantization="int4_w4a8" if dequantize == "fused_w4a8" else "int4"
        )
    return cfg, fused


def make_param_caster(
    inference_dtype: torch.dtype | None, device=None, *, dequantize: bool = False
) -> Callable[[Mapping[str, torch.Tensor]], dict]:
    """Eager ``maybe_cast(state_dict)``: floating tensors to
    ``inference_dtype`` (kept as they are when ``None``), everything moved
    to ``device``. Once per generate call, never per step. With
    ``dequantize`` the state dict holds quantized nodes
    (``models/quantize.py::quantize_tree``): their ``q``/``q4`` and fp32
    ``scale`` stay as they are, while embeddings, norms and biases cast."""

    def cast(value: torch.Tensor) -> torch.Tensor:
        if inference_dtype is not None and value.is_floating_point():
            return value.to(inference_dtype)
        return value

    def maybe_cast(params: Mapping[str, torch.Tensor]) -> dict:
        moved = {name: torch.as_tensor(v, device=device) for name, v in params.items()}
        if dequantize:
            return map_unquantized(cast, moved)
        return {name: cast(value) for name, value in moved.items()}

    return maybe_cast


def make_cached_apply(
    model: Transformer, *, dequantize: bool = False, dequant_dtype: torch.dtype | None = None
) -> Callable[..., tuple[torch.Tensor, DecodeCache]]:
    """``apply(cache, tokens, chunk_lengths=None, *, params=None) -> (fp32
    logits, cache)``. With ``cache=None`` the call creates zeroed caches
    (prefill); later calls pass the cache on, which the model updates in
    place. The model's own weights serve, unless ``dequantize``: then
    ``params`` is an int8/int4 state dict that stays quantized, and each
    call dequantizes it to ``dequant_dtype`` and runs the model on the
    result (``torch.func.functional_call``)."""

    def apply(cache, tokens, chunk_lengths=None, *, params=None):
        if cache is None:
            cache = model.init_cache(tokens.shape[0])
        kwargs = dict(cache=cache, chunk_lengths=chunk_lengths)
        if dequantize:
            weights = dequantize_tree(params, dequant_dtype)
            logits = torch.func.functional_call(model, weights, (tokens,), kwargs, strict=True)
        else:
            logits = model(tokens, **kwargs)
        return logits.float(), cache

    return apply


def check_sequence_budget(needed: int, max_seq_len: int, what: str) -> None:
    """Raise if a decode plan would write past the KV caches."""
    if needed > max_seq_len:
        raise ValueError(f"{what} ({needed}) exceeds max_seq_len ({max_seq_len})")
