"""Train state, train step, eval step and apply function, on one device.

Port of ``learning_jax_sharding_tpu/training/pipeline.py``. The JAX module
builds the state born sharded over a mesh and jits SPMD step programs; here
the model already lives on its device, the optimizer state is the torch
optimizer's, and a step runs eagerly, updating the state IN PLACE (the JAX
state is immutable and returned anew; ``donate_state`` has no counterpart,
since nothing is copied). Sharding the state over a mesh comes with slice A.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """What a train step reads and updates IN PLACE: the model, the torch
    optimizer over its parameters, ``step`` (the count of updates made),
    the learning-rate ``schedule`` read at ``step`` before each update
    (None: the optimizer's own rate), and the global-norm ``clip_norm``
    applied to the gradients before it (None: no clipping)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    schedule: Callable[[int], float] | None = None
    clip_norm: float | None = None


def default_loss(y: torch.Tensor, batch: Any) -> torch.Tensor:
    """The reference's stand-in loss, ``y.sum()``; real tasks pass their
    own ``loss_fn(y, batch)``."""
    del batch
    return y.sum()


def _inputs_of(batch: Any) -> torch.Tensor:
    """A batch is the bare input tensor or a dict with ``"inputs"``."""
    return batch["inputs"] if isinstance(batch, dict) else batch


def _map_batch(fn: Callable[[torch.Tensor], Any], batch: Any) -> Any:
    return {k: fn(v) for k, v in batch.items()} if isinstance(batch, dict) else fn(batch)


def _leading_dim(batch: Any) -> int:
    return _inputs_of(batch).shape[0]


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: √(Σ‖g‖²) over every gradient, on the device."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm_(
    grads: list[torch.Tensor], max_norm: float, gnorm: torch.Tensor | None = None
) -> None:
    """``optax.clip_by_global_norm``, IN PLACE: every gradient becomes
    ``g / ‖g‖ · max_norm`` when the global norm ``‖g‖`` (``gnorm``, computed
    here when None) is not below ``max_norm``. Decided on the device."""
    gnorm = global_norm(grads) if gnorm is None else gnorm
    keep = gnorm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / gnorm * max_norm))


def sharded_train_state(model: nn.Module, optimizer, *, mesh=None, rules=None) -> TrainState:
    """The train state of ``model`` under ``optimizer`` (an
    ``training.loop.AdamW``, e.g. ``adamw(3e-4)``), whose torch optimizer is
    built here over the model's parameters. ``mesh``/``rules`` (the state
    born sharded) are not ported yet."""
    del rules
    if mesh is not None:
        raise NotImplementedError(
            "sharded_train_state over a mesh: ported with slice A (the "
            "sharding lessons)"
        )
    return TrainState(
        model=model, optimizer=optimizer.create(model.parameters()),
        schedule=optimizer.schedule, clip_norm=optimizer.clip_norm,
    )


def make_train_step(
    *,
    loss_fn: Callable[..., torch.Tensor] = default_loss,
    dropout_seed: int | None = None,
    loss_needs_params: bool = False,
    apply_kwargs: dict[str, Any] | None = None,
    grad_accum_steps: int = 1,
    steps_per_call: int = 1,
    with_grad_norm: bool = False,
    skip_nonfinite: bool = False,
) -> Callable[[TrainState, Any], tuple[TrainState, Any]]:
    """Build ``step(state, batch) -> (state, loss)``: forward, backward and
    one optimizer update, the state updated in place.

    ``loss_fn(y, batch)``, or ``loss_fn(y, batch, model)`` with
    ``loss_needs_params`` (the chunked head of
    ``models.transformer.fused_next_token_loss``, with ``apply_kwargs={
    "return_hidden": True}``). ``apply_kwargs`` go to the model's forward.

    ``dropout_seed``: train with dropout on (``deterministic=False``), each
    microbatch drawing from a generator seeded by ``(dropout_seed, step,
    microbatch)``, the counterpart of the JAX step's folded ``dropout_rng``.
    None keeps dropout off.

    ``grad_accum_steps``: split the batch along its leading dim into this
    many microbatches; loss and gradients are averaged over them before the
    single update.

    ``with_grad_norm``: return ``{"loss": ..., "grad_norm": ...}``, the
    global norm of the gradients before any clipping.

    ``steps_per_call``: the batch carries a leading ``(steps_per_call,)``
    dim of per-step batches; one call runs that many full steps and returns
    the ``(steps_per_call,)`` losses. Nothing in a call waits for the
    device: the losses stay on it.

    ``skip_nonfinite`` (gating the update on a finite loss and norm) is not
    ported yet. ``donate_state`` has no counterpart: the update is in place.
    """
    if skip_nonfinite:
        raise NotImplementedError("skip_nonfinite: ported with slice E (robustness)")

    def loss_of(state: TrainState, batch: Any, micro_idx: int) -> torch.Tensor:
        kwargs = dict(apply_kwargs or {})
        if dropout_seed is not None:
            words = np.random.SeedSequence([dropout_seed, state.step, micro_idx])
            seed = int(words.generate_state(2, np.uint64)[0])
            device = next(state.model.parameters()).device
            kwargs.update(
                deterministic=False,
                generator=torch.Generator(device=device).manual_seed(seed),
            )
        y = state.model(_inputs_of(batch), **kwargs)
        return loss_fn(y, batch, state.model) if loss_needs_params else loss_fn(y, batch)

    def one_step(state: TrainState, batch: Any):
        params = [p for p in state.model.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            loss = loss_of(state, batch, 0)
            loss.backward()
            loss = loss.detach()
        else:
            n = _leading_dim(batch)
            if n % grad_accum_steps:
                raise ValueError(
                    f"batch dim {n} not divisible by grad_accum_steps {grad_accum_steps}"
                )
            size = n // grad_accum_steps
            total = 0.0
            for idx in range(grad_accum_steps):
                micro = _map_batch(lambda x: x[idx * size:(idx + 1) * size], batch)
                loss_i = loss_of(state, micro, idx)
                loss_i.backward()
                total = total + loss_i.detach()
            loss = total / grad_accum_steps
            for p in params:
                if p.grad is not None:
                    p.grad.div_(grad_accum_steps)
        grads = [p.grad for p in params if p.grad is not None]
        gnorm = None
        if with_grad_norm or state.clip_norm is not None:
            gnorm = global_norm(grads)
        if state.clip_norm is not None:
            clip_by_global_norm_(grads, state.clip_norm, gnorm)
        if state.schedule is not None:
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return {"loss": loss, "grad_norm": gnorm} if with_grad_norm else loss

    def run(state: TrainState, batch: Any):
        if steps_per_call == 1:
            return state, one_step(state, batch)
        if _leading_dim(batch) != steps_per_call:
            raise ValueError(
                f"a batch of steps_per_call={steps_per_call} steps must lead "
                f"with that dim, got {_leading_dim(batch)}"
            )
        outs = [one_step(state, _map_batch(lambda x: x[i], batch))
                for i in range(steps_per_call)]
        if with_grad_norm:
            return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return state, torch.stack(outs)

    return run


def make_eval_step(
    *,
    loss_fn: Callable[..., torch.Tensor] = default_loss,
    loss_needs_params: bool = False,
    apply_kwargs: dict[str, Any] | None = None,
) -> Callable[[TrainState, Any], torch.Tensor]:
    """Build ``eval_step(state, batch) -> loss``: the forward and loss, no
    gradients, no update, dropout off."""

    @torch.no_grad()
    def ev(state: TrainState, batch: Any) -> torch.Tensor:
        y = state.model(_inputs_of(batch), **(apply_kwargs or {}))
        return loss_fn(y, batch, state.model) if loss_needs_params else loss_fn(y, batch)

    return ev


def make_apply_fn() -> Callable[[TrainState, torch.Tensor], torch.Tensor]:
    """Build ``apply_fn(state, x) -> y``: the model's forward, no gradients."""

    @torch.no_grad()
    def fwd(state: TrainState, x: torch.Tensor) -> torch.Tensor:
        return state.model(x)

    return fwd
