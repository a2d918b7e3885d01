"""Mixed-precision training: low-precision parameters, fp32 master weights.

Port of ``learning_jax_sharding_tpu/training/precision.py``. bf16
parameters halve the weights' memory and traffic, but bf16 Adam stalls:
with 8 significand bits a small update rounds to nothing. So the optimizer
keeps an fp32 master of every floating parameter:

* the gradients are upcast and the inner optimizer steps the masters, all
  in fp32;
* each parameter then takes JAX's arithmetic: the delta
  ``master.to(p.dtype) − p``, computed in the parameter's dtype, added to
  ``p`` (``optax.apply_updates``). That lands ``p`` on the rounded master
  wherever the delta is exact, which it is between neighbours; it is not
  a plain copy of the rounded master, and where the two differ the port
  follows JAX.

:func:`master_weights` returns a description like ``training.loop.AdamW``
(``create``, ``schedule``, ``clip_norm``), so ``sharded_train_state``,
``make_train_step`` and ``fit`` take it as they take a bare one. Over a
mesh each master is born with its parameter's placement; under ZeRO-1
(``training.zero``) it is a 1/D slice. A step the non-finite guard skips
never reaches the optimizer, so the masters stay as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from learning_jax_sharding_tpu_torch.training.wrapped import WrappedOptimizer, create, named


class MasterWeightsState(NamedTuple):
    """The JAX state's two parts, as :meth:`MasterWeightsOptimizer.as_state`
    gives them: the inner optimizer and the masters by parameter name."""

    inner: Any
    master: dict


def land(p: torch.Tensor, master: torch.Tensor) -> None:
    """``p ← p + (master.to(p.dtype) − p)``, IN PLACE, in ``p``'s dtype: the
    JAX wrapper's delta and ``optax.apply_updates``."""
    p.add_(master.to(p.dtype) - p)


class MasterWeightsOptimizer(WrappedOptimizer):
    """The optimizer of :func:`master_weights`: an fp32 master a floating
    parameter (its slot ``"master"``), the inner optimizer over the
    masters. Non-floating parameters stand for themselves."""

    def __init__(self, pairs, inner: Any, master_dtype: torch.dtype):
        super().__init__(pairs, inner.schedule(0))
        self.master_dtype = master_dtype
        self.master = {p: p.detach().to(master_dtype).clone() if p.is_floating_point() else p
                       for p in self.params}
        self.inner = create(inner, [(n, self.master[p]) for n, p in zip(self.names, self.params)])

    def stand_in(self, p):
        return self.master[p]

    def own_slots(self, p):
        return {"master": self.master[p]} if self.master[p] is not p else {}

    def reset(self) -> None:
        with torch.no_grad():
            for p, m in self.master.items():
                if m is not p:
                    m.copy_(p)
        super().reset()

    @torch.no_grad()
    def step(self, closure=None) -> None:
        stepped = []
        for p, m in self.master.items():
            if p.grad is None or m is p:
                continue
            m.grad = p.grad.to(self.master_dtype)
            stepped.append((p, m))
        self._inner_step()
        for p, m in stepped:
            m.grad = None
            land(p, m)

    def as_state(self) -> MasterWeightsState:
        return MasterWeightsState(self.inner, {n: self.master[p]
                                               for n, p in zip(self.names, self.params)})


@dataclasses.dataclass(frozen=True)
class MasterWeights:
    """The description :func:`master_weights` returns."""

    inner: Any
    master_dtype: torch.dtype = torch.float32
    takes_names = True

    @property
    def clip_norm(self):
        return self.inner.clip_norm

    def schedule(self, step: int) -> float:
        return self.inner.schedule(step)

    def create(self, params) -> MasterWeightsOptimizer:
        return MasterWeightsOptimizer(named(params), self.inner, self.master_dtype)


def master_weights(inner: Any, master_dtype: torch.dtype = torch.float32) -> MasterWeights:
    """Wrap ``inner`` (an ``adamw(...)``-style description, or another
    wrapper) so it steps fp32 masters and lands the low-precision
    parameters on them with JAX's delta arithmetic. For bf16 parameters
    (``TransformerConfig(param_dtype=torch.bfloat16)``)::

        state = sharded_train_state(model, master_weights(adamw(3e-4)))
    """
    return MasterWeights(inner, master_dtype)
