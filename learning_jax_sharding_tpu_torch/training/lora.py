"""LoRA: low-rank adapters fine-tuned over a frozen base model.

Port of ``learning_jax_sharding_tpu/training/lora.py``. Every projection
weight W of the base gets a pair of factors in JAX's orientation, A ``(in,
r)`` and B ``(r, out)``; the model runs on the merged weights ``W +
(alpha/r)·A@B`` and only A and B take gradients. B starts at zero, so step
0 is the base model exactly.

The port's weights are ``nn.Linear``'s ``(out, in)``, so a merge adds the
transposed product (values unchanged); adapters are a dict ``{weight name:
{"lora_a": A, "lora_b": B}}`` keyed like the base state dict
(``models.convert.adapters_from_flax`` carries a JAX tree across). Over a
mesh A takes the kernel's row (``in``) placement and B its column
(``out``) placement, so ``A@B`` lands placed as the weight with no
communication beyond the base matmul's. The optimizer state covers only
the adapters.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from learning_jax_sharding_tpu_torch.models.convert import is_kernel_weight
from learning_jax_sharding_tpu_torch.parallel.logical import constrain
from learning_jax_sharding_tpu_torch.parallel.sharding import put
from learning_jax_sharding_tpu_torch.training.pipeline import (
    _full,
    _inputs_of,
    _place_batch,
    _scope,
    clip_by_global_norm_,
)


def default_match(name: str, tensor: torch.Tensor) -> bool:
    """Adapt every 2-D projection weight (attention query/key/value/out, FF
    up/down, lm_head); never embeddings, norms or biases."""
    return is_kernel_weight(name) and tensor.ndim == 2


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def init_lora(generator: torch.Generator, params: Mapping[str, torch.Tensor], rank: int, *,
              match: Callable[[str, torch.Tensor], bool] = default_match,
              dtype: torch.dtype | None = None) -> dict[str, dict[str, torch.Tensor]]:
    """The adapters of ``params`` (a state dict): for each matched ``(out,
    in)`` weight, A ``(in, r)`` ~ N(0, 1)/√in drawn from ``generator`` and B
    ``(r, out)`` = 0, in the weight's dtype (or ``dtype``), on the
    generator's device. Raises ``ValueError`` when nothing matches."""
    adapters = {}
    for name, w in params.items():
        if not match(name, w):
            continue
        d_out, d_in = w.shape
        dt = dtype or w.dtype
        a = torch.randn((d_in, rank), generator=generator, device=generator.device,
                        dtype=torch.float32).to(dt)
        adapters[name] = {"lora_a": a / torch.tensor(math.sqrt(d_in), dtype=dt,
                                                        device=a.device),
                          "lora_b": torch.zeros((rank, d_out), dtype=dt, device=a.device)}
    if not adapters:
        raise ValueError("no parameters matched — nothing to adapt")
    return adapters


def zero_lora(adapters: Mapping) -> dict:
    """The identity adapters: A = B = 0, so ``merge_lora(params,
    zero_lora(a))`` is the base exactly (the base tenant of an adapter
    pool)."""
    return {n: {k: torch.zeros_like(v) for k, v in ab.items()} for n, ab in adapters.items()}


def merge_lora(params: Mapping[str, torch.Tensor], adapters: Any, *,
               alpha: float = 16.0) -> dict[str, torch.Tensor]:
    """``W + (alpha/r)·A@B`` at every adapted weight, every other tensor
    as it is: a state dict ``make_generate_fn`` and ``load_state_dict`` take.
    JAX's op order: the product scaled, cast to the weight's dtype, then
    added (transposed into the ``(out, in)`` weight). Differentiable in the
    adapters. A :class:`LoraState` merges with the alpha it trained with."""
    if isinstance(adapters, LoraState):
        alpha = adapters.alpha
        adapters = adapters.adapters
    alpha = float(alpha)
    out = dict(params)
    for name, ab in adapters.items():
        w = params[name]
        rank = ab["lora_a"].shape[1]
        delta = (alpha / rank) * (ab["lora_a"] @ ab["lora_b"])
        out[name] = w + delta.to(w.dtype).T
    return out


def lora_shardings(params: Mapping[str, torch.Tensor], adapters: Mapping) -> dict:
    """The placements of each adapter, inherited from its weight's: A
    takes the split of the weight's ``in`` dim (its dim 1) as its rows, B
    the split of the ``out`` dim (dim 0) as its columns; a plain weight
    gives None (one device)."""
    out = {}
    for name in adapters:
        w = params[name]
        if not isinstance(w, DTensor):
            out[name] = {"lora_a": None, "lora_b": None}
            continue
        a = tuple(Shard(0) if pl.is_shard(1) else Replicate() for pl in w.placements)
        b = tuple(Shard(1) if pl.is_shard(0) else Replicate() for pl in w.placements)
        out[name] = {"lora_a": a, "lora_b": b}
    return out


class LoraState(NamedTuple):
    """The fine-tune's state: the adapters (leaf tensors that take
    gradients), the torch optimizer over them, the count of steps taken,
    and ``alpha``, carried so a merge cannot drift from the training."""

    adapters: dict
    opt_state: torch.optim.Optimizer
    step: int
    alpha: float


def _leaves(adapters: Mapping) -> list[torch.Tensor]:
    return [ab[k] for ab in adapters.values() for k in ("lora_a", "lora_b")]


def lora_train_state(generator: torch.Generator, params: Mapping[str, torch.Tensor],
                     optimizer: Any, rank: int, *, alpha: float = 16.0,
                     match: Callable[[str, torch.Tensor], bool] = default_match,
                     dtype: torch.dtype | None = None,
                     adapters: Mapping | None = None) -> LoraState:
    """Adapters (from :func:`init_lora`, or ``adapters`` as given, e.g.
    carried across from JAX) placed by :func:`lora_shardings` over the
    mesh ``params`` lie on (JAX's ``mesh`` argument: the port reads it off
    the weights), and ``optimizer`` (an ``adamw(...)``-style description)
    built over them."""
    if adapters is None:
        adapters = init_lora(generator, {n: _whole(w) for n, w in params.items()}, rank,
                             match=match, dtype=dtype)
    placements = lora_shardings(params, adapters)
    placed = {}
    for name, ab in adapters.items():
        w = params[name]
        placed[name] = {}
        for k, t in ab.items():
            t = torch.as_tensor(t).to(device=_whole(w).device).detach()
            if placements[name][k] is not None:
                t = put(t, placements[name][k], w.device_mesh)
            placed[name][k] = t.requires_grad_(True)
    opt = optimizer.create(_leaves(placed))
    return LoraState(placed, opt, 0, float(alpha))


class _WithLoss(nn.Module):
    """The model and its loss as one module, so a functional call runs
    both on the merged weights (the fused loss reads the head's weight)."""

    def __init__(self, model, loss_fn, loss_needs_params, apply_kwargs):
        super().__init__()
        self.model = model
        self.loss_fn, self.loss_needs_params = loss_fn, loss_needs_params
        self.apply_kwargs = apply_kwargs or {}

    def forward(self, batch):
        y = self.model(_inputs_of(batch), **self.apply_kwargs)
        if self.loss_needs_params:
            return self.loss_fn(y, batch, self.model)
        return self.loss_fn(y, batch)


def make_lora_train_step(model: nn.Module, optimizer: Any, *,
                         loss_fn: Callable[..., torch.Tensor],
                         loss_needs_params: bool = False,
                         apply_kwargs: dict | None = None,
                         mesh=None, rules=None):
    """``step(base, lora_state, batch) -> (lora_state, loss)``: the loss of
    ``model`` run (``torch.func.functional_call``) on ``merge_lora(base,
    lora_state)``, gradients to the adapters only, one update of
    ``optimizer`` (the description ``lora_train_state`` was given: its
    schedule and clipping). The base is a state dict that is never written
    (over a mesh, laid out as the model's parameters, e.g.
    ``dict(model.named_parameters())`` after ``sharded_train_state``);
    ``mesh``/``rules`` run the step over that mesh, the batch split as
    ``(BATCH, ...)``. The adapters update IN PLACE; the returned state
    counts the step."""
    wrapped = _WithLoss(model, loss_fn, loss_needs_params, apply_kwargs)

    def step(base: Mapping[str, torch.Tensor], ls: LoraState, batch: Any):
        frozen = {n: t.detach() for n, t in base.items()}
        ls.opt_state.zero_grad(set_to_none=True)
        with _scope(mesh, rules):
            merged = merge_lora(frozen, ls)
            loss = torch.func.functional_call(
                wrapped, {f"model.{n}": t for n, t in merged.items()},
                (_place_batch(batch, mesh),), strict=False)
            if isinstance(loss, DTensor):
                loss = constrain(loss)
            loss.backward()
        leaves = _leaves(ls.adapters)
        for t in leaves:
            # Over a mesh: the data axis's partial sums reduced to the
            # adapter's placement.
            if isinstance(t.grad, DTensor) and t.grad.placements != t.placements:
                t.grad = t.grad.redistribute(t.device_mesh, t.placements)
        grads = [t.grad for t in leaves if t.grad is not None]
        if optimizer.clip_norm is not None:
            clip_by_global_norm_(grads, optimizer.clip_norm)
        for group in ls.opt_state.param_groups:
            group["lr"] = optimizer.schedule(ls.step)
        ls.opt_state.step()
        return ls._replace(step=ls.step + 1), _full(loss.detach())

    return step
