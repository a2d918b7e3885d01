"""Device-memory budget of a transformer train step.

Port of ``learning_jax_sharding_tpu/utils/memory.py``: "will this config
fit the card?" before paying for an out-of-memory run. Estimates, not
measurements: the big terms (parameters, optimizer moments, per-layer saved
activations, S² score tensors, (B, S, V) logits) are shape arithmetic, with
the JAX package's byte formulas (``torch.dtype.itemsize`` in place of
``jnp.dtype(...).itemsize``).

Conventions: fp32 parameters and optimizer state (the default), activations
in ``cfg.dtype``. The attention regime is read off the port's config:
``attn_fn`` set → flash-style (no S² saved); else dense (the S²
probabilities saved for backward). ``remat_attention`` (q/k/v saved, scores
recomputed) is read where a config has it.

:func:`device_hbm_bytes` is the live capacity of a CUDA card, None on the
CPU; the JAX package's table of TPU kinds has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def device_hbm_bytes(device: Any | None = None) -> float | None:
    """Memory capacity of ``device`` (default: the current CUDA card) in
    bytes, from ``torch.cuda.get_device_properties``; None on the CPU or
    without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return float(torch.cuda.get_device_properties(device).total_memory)


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Byte estimates for one train step (one device unless divided)."""

    params: float
    grads: float
    optimizer_state: float
    saved_activations: float
    loss_head: float
    total: float
    detail: dict

    def fits(self, hbm_bytes: float, *, headroom: float = 0.8) -> bool:
        """Conservative fit check: the estimate under ``headroom`` × the
        capacity (allocator fragmentation and temporaries take the rest)."""
        return self.total <= hbm_bytes * headroom


def memory_plan(
    cfg: Any,
    batch: int,
    seq: int,
    *,
    optimizer_slots: int = 2,       # adamw: m + v
    donate_state: bool = True,
    unfused_loss: bool = False,
    n_model_shards: int = 1,        # TP/FSDP degree dividing params & opt state
    n_data_shards: int = 1,         # DP degree dividing the batch dim
) -> MemoryPlan:
    """Estimate a train step's device memory for a ``TransformerConfig``
    (the JAX package's formulas; ``donate_state=False`` counts a second
    copy of the parameters and optimizer state, which a step that keeps its
    input state alive holds)."""
    act_bytes = cfg.dtype.itemsize
    param_bytes = cfg.param_dtype.itemsize
    b = batch / n_data_shards
    p = cfg.param_count / n_model_shards

    params = p * param_bytes
    grads = p * param_bytes
    opt = p * param_bytes * optimizer_slots
    if not donate_state:
        params, opt = 2 * params, 2 * opt

    kv_heads = cfg.num_kv_heads if cfg.num_kv_heads is not None else cfg.num_heads
    nh = cfg.num_heads * cfg.head_dim / n_model_shards
    nkv = kv_heads * cfg.head_dim / n_model_shards
    tokens = b * seq

    # Saved-per-layer residuals the backward reads (block input, norm
    # outputs, q/k/v, attention output, FF up before and after the GELU).
    per_layer = tokens * act_bytes * (
        4 * cfg.features
        + nh + 2 * nkv
        + 2 * cfg.hidden / n_model_shards
    )
    if cfg.attn_fn is not None:
        scores = 0.0                # flash: O(S·H) only, counted in q/k/v
    elif getattr(cfg, "remat_attention", False):
        scores = 0.0                # recomputed in backward
    else:
        heads = cfg.num_heads / n_model_shards
        scores = b * heads * seq * seq * act_bytes
    saved = cfg.num_layers * (per_layer + scores)

    if unfused_loss:
        # Compute-dtype logits + the fp32 softmax upcast both live at peak.
        head = tokens * cfg.vocab_size / n_model_shards * (act_bytes + 4)
    else:
        chunk = min(seq, 128)  # fused_next_token_loss chunk size
        head = tokens * chunk / seq * cfg.vocab_size / n_model_shards * (act_bytes + 4)

    total = params + grads + opt + saved + head
    return MemoryPlan(
        params=params, grads=grads, optimizer_state=opt,
        saved_activations=saved, loss_head=head, total=total,
        detail={
            "per_layer_residuals": per_layer,
            "per_layer_scores": scores,
            "batch_per_shard": b,
        },
    )
