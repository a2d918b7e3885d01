"""Exponential moving average of the parameters, kept in the optimizer.

Port of ``learning_jax_sharding_tpu/training/ema.py``. Serving or
evaluating from an EMA of the weights instead of the last iterate is the
cheapest quality gain in LM training. As in JAX the EMA lives in the
optimizer state (the slot ``"ema"`` of each parameter), so it is born with
the parameter's placement over a mesh, sharded 1/D under ZeRO-1, and
checkpointed and rolled back with the rest of the state.

``with_ema`` is the OUTERMOST wrapper (ZeRO-1 aside, which is a placement
of the whole state): it averages the parameters the model holds after the
inner step, so a wrapper around it would make it average a trajectory the
model never follows. Under ``master_weights`` those are the low-precision
parameters, not the masters, as JAX's ``optax.apply_updates(params,
updates)`` gives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from learning_jax_sharding_tpu_torch.training.wrapped import WrappedOptimizer, create, named


class EmaState(NamedTuple):
    """The JAX state's two parts, as :meth:`EmaOptimizer.as_state` gives
    them: the inner optimizer and the EMA by parameter name."""

    inner: Any
    ema: dict


class EmaOptimizer(WrappedOptimizer):
    """The optimizer of :func:`with_ema`: the inner optimizer over the
    parameters themselves, then ``e ← e + (1 − decay)·(acc(p) − e)`` in
    ``ema_dtype`` for every floating parameter (JAX's op order)."""

    def __init__(self, pairs, inner: Any, decay: float, ema_dtype: torch.dtype):
        super().__init__(pairs, inner.schedule(0))
        self.decay, self.ema_dtype = decay, ema_dtype
        self.ema = {p: p.detach().to(ema_dtype).clone() for p in self.params
                    if p.is_floating_point()}
        self.inner = create(inner, list(zip(self.names, self.params)))

    def own_slots(self, p):
        return {"ema": self.ema[p]} if p in self.ema else {}

    def reset(self) -> None:
        with torch.no_grad():
            for p, e in self.ema.items():
                e.copy_(p)
        super().reset()

    @torch.no_grad()
    def step(self, closure=None) -> None:
        self._inner_step()
        for p, e in self.ema.items():
            e.add_((1.0 - self.decay) * (p.to(self.ema_dtype) - e))

    def ema_by_name(self) -> dict[str, torch.Tensor]:
        return {n: self.ema[p] for n, p in zip(self.names, self.params) if p in self.ema}

    def as_state(self) -> EmaState:
        return EmaState(self.inner, self.ema_by_name())


@dataclasses.dataclass(frozen=True)
class Ema:
    """The description :func:`with_ema` returns."""

    inner: Any
    decay: float = 0.999
    ema_dtype: torch.dtype = torch.float32
    takes_names = True

    @property
    def clip_norm(self):
        return self.inner.clip_norm

    def schedule(self, step: int) -> float:
        return self.inner.schedule(step)

    def create(self, params) -> EmaOptimizer:
        return EmaOptimizer(named(params), self.inner, self.decay, self.ema_dtype)


def with_ema(inner: Any, decay: float = 0.999, ema_dtype: torch.dtype = torch.float32) -> Ema:
    """Wrap ``inner`` to also track ``ema ← decay·ema + (1 − decay)·params``.

    The EMA starts AT the parameters (no zero start, no debiasing) and is
    updated after each inner step; the training itself is the bare
    ``inner``'s, bit for bit. It accumulates in ``ema_dtype`` (fp32) whatever
    the parameters' dtype: a bf16 accumulator would round the ``0.001·(p −
    e)`` increment away. ``decay`` lies in (0, 1)."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"decay must be in (0, 1), got {decay}")
    return Ema(inner, decay, ema_dtype)


def ema_params(state: Any) -> dict[str, torch.Tensor]:
    """The EMA of a ``TrainState`` (or of its optimizer), keyed by the
    model's parameter names: a tree ``make_generate_fn`` and
    ``model.load_state_dict`` take. Searches the wrappers around and inside
    ``with_ema``; under ZeRO-1 each slice is gathered back into its
    parameter's placement. Raises ``LookupError`` when no EMA is kept."""
    opt = getattr(state, "optimizer", state)
    gathers = []
    while not isinstance(opt, EmaOptimizer):
        if hasattr(opt, "gather"):
            gathers.append(opt.gather)
        opt = getattr(opt, "inner", None)
        if opt is None:
            raise LookupError("no EMA found: was the optimizer wrapped with with_ema?")
    out = opt.ema_by_name()
    for gather in reversed(gathers):
        out = {n: gather(n, t) for n, t in out.items()}
    return out
