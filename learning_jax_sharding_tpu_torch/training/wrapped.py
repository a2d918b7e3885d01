"""The shared frame of the optimizer wrappers: ``master_weights``,
``with_ema`` and ZeRO-1.

An optax wrapper is a pure function over the state it nests; a torch
optimizer updates tensors it was built over. So each wrapper here is a
description (``create``, ``schedule``, ``clip_norm``, as
``training.loop.AdamW``) whose ``create(params)`` builds a
:class:`WrappedOptimizer`: the optimizer the train step holds, over the
model's parameters, which runs an inner optimizer over tensors standing for
them (fp32 masters, the parameters themselves, or each parameter's ZeRO
slice) and keeps slots of its own (a master, an EMA).

The state reads as a torch optimizer's does: ``optimizer.state[p]`` is a
dict of ``p``'s slots, the wrapper's own beside its inner optimizer's for
the tensor standing for ``p``, every value the live tensor (a restore
writes into it). A parameter has state once its inner optimizer has
stepped it; ``state.clear()`` puts the whole state back to what ``create``
made, from the parameters as they are. So the train step, checkpoints and
``fit``'s rollback take a wrapped optimizer as they take a bare one.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Iterable

import torch


def named(params: Iterable) -> list[tuple[str, torch.Tensor]]:
    """``params`` as ``(name, tensor)`` pairs: named pairs as given, bare
    tensors named by their position."""
    out = []
    for i, p in enumerate(params):
        out.append(tuple(p) if isinstance(p, tuple) else (str(i), p))
    return out


def create(description: Any, pairs: list[tuple[str, torch.Tensor]]):
    """The torch optimizer ``description`` builds over ``pairs``: a wrapper
    takes the names, a bare optimizer the tensors."""
    if getattr(description, "takes_names", False):
        return description.create(pairs)
    return description.create([t for _, t in pairs])


class _Slots(Mapping):
    """A wrapped optimizer's state, keyed by the parameters it was built
    over (see the module docstring)."""

    def __init__(self, owner: "WrappedOptimizer"):
        self._owner = owner

    def __getitem__(self, p):
        slots = self._owner.slots(p)
        if slots is None:
            raise KeyError(p)
        return slots

    def __contains__(self, p) -> bool:
        return self._owner.slots(p) is not None

    def __iter__(self):
        return (p for p in self._owner.params if p in self)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def clear(self) -> None:
        self._owner.reset()


class WrappedOptimizer:
    """The optimizer of a wrapper description, over ``pairs`` (the model's
    named parameters): one parameter group whose ``lr`` the train step sets
    (passed to the inner optimizer at each step), ``zero_grad``, ``step``
    and the state view. Subclasses keep ``self.inner`` and say which tensor
    stands for a parameter (``stand_in``) and which slots are their own
    (``own_slots``)."""

    takes_names = True

    def __init__(self, pairs: list[tuple[str, torch.Tensor]], lr: float):
        self.names = [n for n, _ in pairs]
        self.params = [p for _, p in pairs]
        self.param_groups = [{"params": self.params, "lr": lr}]
        self.state = _Slots(self)
        self.inner: Any = None

    def stand_in(self, p: torch.Tensor) -> torch.Tensor:
        return p

    def own_slots(self, p: torch.Tensor) -> dict[str, torch.Tensor]:
        return {}

    def slots(self, p: torch.Tensor) -> dict | None:
        """``p``'s slots, or None before its first inner step."""
        states, key = self.inner.state, self.stand_in(p)
        inner = states[key] if key in states else None
        if not inner:
            return None
        own = self.own_slots(p)
        clash = own.keys() & inner.keys()
        if clash:
            raise ValueError(f"slot names {sorted(clash)} appear in two wrappers")
        return {**own, **inner}

    def slot_tensor(self, p: torch.Tensor, slot: str) -> torch.Tensor:
        """The tensor of ``p``'s own slot ``slot`` in this wrapper or one it
        wraps (there before any step, unlike ``state[p]``)."""
        own = self.own_slots(p)
        if slot in own:
            return own[slot]
        if isinstance(self.inner, WrappedOptimizer):
            return self.inner.slot_tensor(self.stand_in(p), slot)
        raise KeyError(f"no wrapper keeps a {slot!r} slot")

    def reset(self) -> None:
        """The state as ``create`` made it, from the parameters as they are."""
        self.inner.state.clear()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()
        self.inner.zero_grad(set_to_none=True)

    def _inner_step(self) -> None:
        for group in self.inner.param_groups:
            group["lr"] = self.param_groups[0]["lr"]
        self.inner.step()
