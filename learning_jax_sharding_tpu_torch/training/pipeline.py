"""Train state, train step, eval step and apply function, on one device or
over a mesh.

Port of ``learning_jax_sharding_tpu/training/pipeline.py``. The JAX module
builds the state born sharded over a mesh and jits SPMD step programs; here
the model already lives on its device, the optimizer state is the torch
optimizer's, and a step runs eagerly, updating the state IN PLACE (the JAX
state is immutable and returned anew; ``donate_state`` has no counterpart,
since nothing is copied).

Over a mesh (``sharded_train_state(..., mesh=, rules=)``) every parameter,
and so every AdamW moment, is a DTensor placed by its logical axes; a step
built with the same ``mesh=, rules=`` (``make_train_step``, and so
``make_eval_step`` and ``make_apply_fn``)
runs the model under ``parallel.logical.activate(mesh, rules)`` (one SPMD
program per rank, the collectives DTensor's), with the batch split as
``(BATCH, SEQ)``; the mean loss over the global batch makes the gradients
the data-axis average, reduced to each parameter's placement before the
update: or, under ZeRO-1 (``zero1_axis``, ``training/zero.py``), to the
placement of its slice of the optimizer state (a reduce-scatter).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import operator
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from learning_jax_sharding_tpu_torch.models.convert import shard_params
from learning_jax_sharding_tpu_torch.models.moe import collecting
from learning_jax_sharding_tpu_torch.parallel.logical import BATCH, activate, constrain
from learning_jax_sharding_tpu_torch.training.wrapped import create


@dataclasses.dataclass
class TrainState:
    """What a train step reads and updates IN PLACE: the model, the torch
    optimizer over its parameters, ``step`` (the count of steps taken),
    ``updates`` (the count of optimizer updates made: ``step`` less the
    steps the non-finite guard skipped, the count optax keeps in its
    state), the learning-rate ``schedule`` read at ``updates`` before each
    update (None: the optimizer's own rate), and the global-norm
    ``clip_norm`` applied to the gradients before it (None: no
    clipping)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    schedule: Callable[[int], float] | None = None
    clip_norm: float | None = None
    updates: int = 0


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


def sharded_train_state(model: nn.Module, optimizer, *, mesh=None, rules=None,
                        zero1_axis: str | None = None) -> TrainState:
    """The train state of ``model`` under ``optimizer`` (an
    ``training.loop.AdamW``, e.g. ``adamw(3e-4)``, or a wrapper of one:
    ``training.precision.master_weights``, ``training.ema.with_ema``), whose
    torch optimizer is built here over the model's parameters.

    With ``mesh``/``rules`` the model's parameters are laid out over the
    mesh first (``models.convert.shard_params``: each a DTensor placed by
    its logical axes; every rank built the same full model, and keeps its
    slice), so the optimizer's moments are born sharded the same way.
    ``zero1_axis`` (with a mesh): the whole optimizer state (moments,
    masters, EMA) split 1/D over that axis more (``training.zero``)."""
    if mesh is not None:
        if rules is None:
            raise ValueError("rules are required when a mesh is given")
        shard_params(model, mesh, rules)
    if zero1_axis is not None:
        if mesh is None:
            raise ValueError("zero1_axis needs a mesh")
        from learning_jax_sharding_tpu_torch.training.zero import Zero1

        optimizer = Zero1(optimizer, zero1_axis)
    return TrainState(
        model=model, optimizer=create(optimizer, list(model.named_parameters())),
        schedule=optimizer.schedule, clip_norm=optimizer.clip_norm,
    )


def _scope(mesh, rules):
    """The mesh context of a step (nothing on one device)."""
    if mesh is None:
        return contextlib.nullcontext()
    if rules is None:
        raise ValueError("rules are required when a mesh is given")
    return activate(mesh, rules)


def _full(x):
    """A DTensor result as the plain tensor every rank holds whole."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _place_batch(batch: Any, mesh) -> Any:
    """Split a whole batch's rows as ``(BATCH, ...)`` over the mesh (a
    DTensor keeps the layout it was given)."""
    if mesh is None:
        return batch
    return _map_batch(lambda x: x if isinstance(x, DTensor)
                      else constrain(x, BATCH, *([None] * (x.ndim - 1))), batch)


def make_train_step(
    *,
    loss_fn: Callable[..., torch.Tensor] = default_loss,
    dropout_seed: int | None = None,
    aux_loss_collection: str | None = None,
    loss_needs_params: bool = False,
    apply_kwargs: dict[str, Any] | None = None,
    grad_accum_steps: int = 1,
    steps_per_call: int = 1,
    with_grad_norm: bool = False,
    skip_nonfinite: bool = False,
    mesh=None,
    rules=None,
) -> Callable[[TrainState, Any], tuple[TrainState, Any]]:
    """Build ``step(state, batch) -> (state, loss)``: forward, backward and
    one optimizer update, the state updated in place.

    ``mesh``/``rules``: the step over a mesh, for a state built by
    ``sharded_train_state`` with the same two. The batch comes whole on
    every rank and is split as ``(BATCH, ...)``; the loss (and grad norm)
    come back whole on every rank.

    ``loss_fn(y, batch)``, or ``loss_fn(y, batch, model)`` with
    ``loss_needs_params`` (the chunked head of
    ``models.transformer.fused_next_token_loss``, with ``apply_kwargs={
    "return_hidden": True}``). ``apply_kwargs`` go to the model's forward.

    ``dropout_seed``: train with dropout on (``deterministic=False``), each
    microbatch drawing from a generator seeded by ``(dropout_seed, step,
    microbatch)``, the counterpart of the JAX step's folded ``dropout_rng``.
    None keeps dropout off.

    ``aux_loss_collection``: the name of a collection (``"losses"``) whose
    values the forward sows (``models.moe.sow``: the MoE load-balancing
    terms, one a routed layer) are summed into the task loss, as JAX sums
    the sown ``"losses"``. They are gathered around the forward only
    (``models.moe.collecting``), so a block that ``remat`` recomputes in
    the backward adds nothing the second time: each layer counts once.

    ``grad_accum_steps``: split the batch along its leading dim into this
    many microbatches; loss and gradients are averaged over them before the
    single update.

    ``with_grad_norm``: return ``{"loss": ..., "grad_norm": ...}``, the
    global norm of the gradients before any clipping.

    ``steps_per_call``: the batch carries a leading ``(steps_per_call,)``
    dim of per-step batches; one call runs that many full steps and returns
    the ``(steps_per_call,)`` losses. Nothing in a call waits for the
    device: the losses stay on it.

    ``skip_nonfinite``: gate the update on ``isfinite(loss) &
    isfinite(grad_norm)``. A non-finite step leaves the parameters and the
    whole optimizer state as they were (AdamW's per-parameter ``step``
    count included, as optax's count in the refused state) and advances
    ``state.step`` but not ``state.updates``; implies the grad-norm dict
    output, so the caller sees why a step was skipped. The decision is
    read on the host once a step (the JAX step selects on the device): a
    torch optimizer keeps its count on the host, and skipping its update
    keeps every slot exact. Over a mesh the loss and norm are whole on
    every rank, so every rank decides alike. ``donate_state`` has no
    counterpart: the update is in place.
    """
    with_grad_norm = with_grad_norm or skip_nonfinite

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
        if aux_loss_collection is None:
            y = state.model(_inputs_of(batch), **kwargs)
            aux = ()
        else:
            with collecting(aux_loss_collection) as aux:
                y = state.model(_inputs_of(batch), **kwargs)
        loss = loss_fn(y, batch, state.model) if loss_needs_params else loss_fn(y, batch)
        # Over a mesh: the loss whole on every rank (partial sums reduced).
        loss = constrain(loss) if isinstance(loss, DTensor) else loss
        if aux:
            # Summed first, then added, as the JAX step adds its sum. Over a
            # mesh the (whole, plain) sum joins as a replicated DTensor, so
            # its gradient comes back a plain tensor.
            total = functools.reduce(operator.add, aux)
            if isinstance(loss, DTensor):
                total = DTensor.from_local(total, loss.device_mesh, loss.placements,
                                           run_check=False)
            loss = loss + total
        return loss

    def one_step(state: TrainState, batch: Any):
        with _scope(mesh, rules):
            out = _one_step(state, _place_batch(batch, mesh))
        if isinstance(out, dict):
            return {k: None if v is None else _full(v) for k, v in out.items()}
        return _full(out)

    def _one_step(state: TrainState, batch: Any):
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
        target = getattr(state.optimizer, "grad_placements", lambda p: tuple(p.placements))
        for p in params:
            # Over a mesh: partial sums of a gradient (the data axis, a
            # contraction split) reduced to its parameter's placement, or
            # under ZeRO-1 scattered to its optimizer slice's.
            if isinstance(p.grad, DTensor) and tuple(p.grad.placements) != target(p):
                p.grad = p.grad.redistribute(p.device_mesh, target(p))
        grads = [p.grad for p in params if p.grad is not None]
        gnorm = None
        if with_grad_norm or state.clip_norm is not None:
            gnorm = global_norm(grads)
        if state.clip_norm is not None:
            clip_by_global_norm_(grads, state.clip_norm, gnorm)
        state.step += 1
        if skip_nonfinite and not bool(torch.isfinite(_full(loss)) & torch.isfinite(_full(gnorm))):
            return {"loss": loss, "grad_norm": gnorm}
        if state.schedule is not None:
            lr = state.schedule(state.updates)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
        state.updates += 1
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
    mesh=None,
    rules=None,
) -> Callable[[TrainState, Any], torch.Tensor]:
    """Build ``eval_step(state, batch) -> loss``: the forward and loss, no
    gradients, no update, dropout off. Over a mesh (``mesh``/``rules``) the
    loss comes back whole on every rank."""

    @torch.no_grad()
    def ev(state: TrainState, batch: Any) -> torch.Tensor:
        with _scope(mesh, rules):
            batch = _place_batch(batch, mesh)
            y = state.model(_inputs_of(batch), **(apply_kwargs or {}))
            loss = loss_fn(y, batch, state.model) if loss_needs_params else loss_fn(y, batch)
            return _full(loss)

    return ev


def make_apply_fn(*, mesh=None, rules=None) -> Callable[[TrainState, torch.Tensor], torch.Tensor]:
    """Build ``apply_fn(state, x) -> y``: the model's forward, no gradients.
    Over a mesh (``mesh``/``rules``) ``y`` is a DTensor laid out as the
    model's output is constrained."""

    @torch.no_grad()
    def fwd(state: TrainState, x: torch.Tensor) -> torch.Tensor:
        with _scope(mesh, rules):
            return state.model(_place_batch(x, mesh))

    return fwd
