"""Shared serving-path plumbing for the decoding entry points.

Port of ``learning_jax_sharding_tpu/models/decoding.py``:

* :func:`derive_decode_config` — a training config's decode variant;
* :func:`apply_dequantize_policy` — the quantized-serving policy (the
  ``dequantize`` modes);
* :func:`make_param_caster` — the eager cast of a state dict to
  ``inference_dtype``, leaving quantized nodes as they are;
* :func:`make_cached_apply` — the model call every decoder loops over,
  optionally dequantizing an int8/int4 state dict inside each call;
* :func:`check_sequence_budget` — the prompt + new vs ``max_seq_len`` guard;
* :func:`whole_logits` — a model call's logits whole on every rank of a
  mesh, at each row's picked position;
* :func:`batch_ranks` / :func:`pad_rows` — a batch padded to a multiple of
  the ranks its rows split over, so any batch runs over a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from learning_jax_sharding_tpu_torch.models.quantize import dequantize_tree, map_unquantized
from learning_jax_sharding_tpu_torch.models.transformer import (
    DecodeCache,
    Transformer,
    TransformerConfig,
)
from learning_jax_sharding_tpu_torch.parallel.logical import BATCH, logical_placements
from learning_jax_sharding_tpu_torch.parallel.sharding import local_rows


def derive_decode_config(
    config: TransformerConfig, inference_dtype: torch.dtype | None = None
) -> TransformerConfig:
    """Decode variant of a training config: KV caches on, dropout off, and,
    with ``inference_dtype``, compute and param dtypes swapped to it.

    It takes no mesh: the JAX one injects a ``shard_map`` decode-attention
    wrapper on meshes of more than one device, while here the attention
    module over a mesh holds each rank's shard of the cache and runs the
    kernel on it itself (``models/attention.py``);
    ``ops.decode_attention.make_decode_attn_fn`` is that per-shard call for
    callers holding DTensors."""
    cfg = dataclasses.replace(config, decode=True, dropout_rate=0.0)
    if inference_dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=inference_dtype, param_dtype=inference_dtype)
    return cfg


def apply_dequantize_policy(
    cfg: TransformerConfig, dequantize: bool | str, mesh=None, rules=None
) -> tuple[TransformerConfig, bool]:
    """The quantized-serving policy: validates the ``dequantize`` mode and,
    for the fused modes, sets the config's ``quantization`` so an int4 state
    dict applies as it is through the fused kernels (``"fused_w4a8"``: with
    per-row int8 activations). Over a mesh the per-shard int4 matmul
    (``ops.int4_matmul.make_int4_matmul_fn``) is injected, on every mesh: JAX
    injects it on meshes of more than one device, but here a DTensor weight
    never reaches the kernel's own wrapper, so one device takes it too.

    Returns ``(cfg, fused)``: callers build their cached apply with
    ``dequantize=bool(dequantize) and not fused`` and their param caster
    with ``dequantize=bool(dequantize)``."""
    if isinstance(dequantize, str) and dequantize not in ("fused", "fused_w4a8"):
        raise ValueError(
            f"dequantize must be False, True, 'fused', or 'fused_w4a8'; "
            f"got {dequantize!r}"
        )
    fused = dequantize in ("fused", "fused_w4a8")
    if fused and cfg.num_experts > 0:
        # JAX's MoE FF declares float expert stacks, so a fused-mode tree
        # fails to apply there (a Flax parameter-shape error).
        raise ValueError(
            f"dequantize={dequantize!r} serves int4 trees through the fused "
            "dense kernels; an MoE model's expert stacks serve with "
            "dequantize=True"
        )
    if fused:
        w4a8 = dequantize == "fused_w4a8"
        cfg = dataclasses.replace(cfg, quantization="int4_w4a8" if w4a8 else "int4")
        if mesh is not None:
            from learning_jax_sharding_tpu_torch.ops.int4_matmul import make_int4_matmul_fn

            cfg = dataclasses.replace(
                cfg, quantized_matmul_fn=make_int4_matmul_fn(mesh, rules, w4a8=w4a8))
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


def whole_logits(logits: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
    """``(B, S, V)`` logits as one plain tensor, or with ``pos`` (``(B,)``
    positions) each row's ``(B, V)`` logits at its position.

    Over a mesh (a DTensor: the vocabulary split over ``model``, the batch
    perhaps over ``data``) each rank first takes its own rows' positions
    from its shard, then the picked rows are gathered whole on every rank.
    The samplers run on whole rows: of the two ways to keep JAX's tokens
    over vocab-sharded logits this takes the gather before the pick (not a
    draw on each vocab shard from the partitionable threefry counter offset
    by the shard's first column), so every rank draws the same token from
    the same key, bit-equal to one device."""
    if not isinstance(logits, DTensor):
        if pos is None:
            return logits
        return logits[torch.arange(logits.shape[0], device=logits.device), pos.long()]
    if pos is None:
        return logits.full_tensor()
    mesh = logits.device_mesh
    # Partial sums reduced and a split sequence gathered: each rank holds
    # every position of its rows.
    pl = tuple(Replicate() if isinstance(p, Partial) or (isinstance(p, Shard) and p.dim == 1)
               else p for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    local = logits.to_local()
    rows = local_rows(pos, mesh, pl).long()
    picked = local[torch.arange(local.shape[0], device=local.device), rows]
    b, _, v = logits.shape
    out_pl = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p for p in pl]
    return DTensor.from_local(picked.contiguous(), mesh, out_pl, run_check=False,
                              shape=torch.Size((b, v)), stride=(v, 1)).full_tensor()


def batch_ranks(mesh, rules) -> int:
    """The ranks a batch dim splits over under ``rules`` (1 with no mesh)."""
    if mesh is None:
        return 1
    size = 1
    for dim, placement in enumerate(logical_placements(mesh, rules, (BATCH,))):
        size *= mesh.size(dim) if placement.is_shard() else 1
    return size


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` with copies of its row 0 appended until its rows are a multiple
    of ``multiple``. The decoders run a padded batch over a mesh whose
    batch split does not divide the caller's (JAX's placement splits such
    a batch unevenly) and return only the caller's rows: every row is
    computed on its own, so a pad row reaches no real row's result."""
    if x.shape[0] % multiple == 0:
        return x
    extra = multiple - x.shape[0] % multiple
    return torch.cat([x, x[:1].expand(extra, *x.shape[1:])], dim=0)
