"""ZeRO-1: the optimizer state split over the data axis.

Port of ``learning_jax_sharding_tpu/training/zero.py``. Under plain data
parallelism every data rank holds the whole optimizer state: for AdamW
twice the parameters' bytes, three times with fp32 masters
(``training.precision``), four with an EMA (``training.ema``). ZeRO stage 1
gives each data rank a 1/D slice of every state tensor and updates only
that slice.

The JAX module only chooses the state's shardings and lets the SPMD
partitioner derive the arithmetic. The port spells it out
(:class:`Zero1Optimizer`): each parameter gets a slice placed by
:func:`zero1_placements`, the inner optimizer (and every wrapper inside it)
runs over the slices, so its moments, masters and EMA are born 1/D; the
gradients go from the data axis's partial sums straight to the slice's
placement (a reduce-scatter, no all-reduce first); and each updated slice is
all-gathered back into its parameter's own placement.

Placement order: a dim already split over ``model`` that also takes
``data`` is ``(Shard(d), Shard(d))`` on the ``(data, model)`` mesh, DTensor's
left-to-right order, so data is the MAJOR split of the dim; JAX's
``P(('model', 'data'))`` makes model the major one. The shard shapes and
the whole tensors agree; which rank holds which piece differs, so the tests
compare shapes and ``full_tensor()``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from learning_jax_sharding_tpu_torch.models.convert import jax_dim_order
from learning_jax_sharding_tpu_torch.training.wrapped import WrappedOptimizer, create, named


def zero1_placements(shape: Sequence[int], dtype: torch.dtype, placements: Sequence[Placement],
                     mesh, axis: str = "data",
                     dim_order: Sequence[int] | None = None) -> tuple[Placement, ...]:
    """The ZeRO-1 placements of one optimizer-state tensor (JAX's
    ``_zero1_leaf``): the first dim, in ``dim_order`` (the JAX leaf's order;
    ``models.convert.jax_dim_order``), that ``axis`` divides evenly is split
    over it, stacked on an existing split of that dim when their product
    divides it. Scalars, non-floating tensors, tensors already split over
    ``axis`` and tensors no dim of which divides keep ``placements``."""
    placements = tuple(placements)
    a = mesh.mesh_dim_names.index(axis)
    if len(shape) == 0 or not dtype.is_floating_point or placements[a].is_shard():
        return placements
    size = mesh.size(a)
    for d in (range(len(shape)) if dim_order is None else dim_order):
        split = math.prod(mesh.size(i) for i, pl in enumerate(placements) if pl.is_shard(d))
        if shape[d] % (size * split):
            continue
        return placements[:a] + (Shard(d),) + placements[a + 1:]
    return placements


def zero1_shardings(tensors: dict[str, torch.Tensor], mesh, axis: str = "data",
                    dim_order: Callable[[str, int], Sequence[int]] = jax_dim_order) -> dict:
    """:func:`zero1_placements` over ``{name: tensor}`` (DTensors, or plain
    tensors as replicated): ``{name: placements}``. ``dim_order(name,
    ndim)`` gives each tensor's dims in the JAX leaf's order (the default
    reads the port's parameter names)."""
    out = {}
    for name, t in tensors.items():
        pl = t.placements if isinstance(t, DTensor) else (Replicate(),) * mesh.ndim
        out[name] = zero1_placements(tuple(t.shape), t.dtype, pl, mesh, axis,
                                     dim_order(name, t.ndim))
    return out


class Zero1Optimizer(WrappedOptimizer):
    """The optimizer of a ZeRO-1 state: a slice a parameter, placed by
    :func:`zero1_placements`, and the inner optimizer over the slices. A
    parameter whose placement the rule leaves as it is stands for itself."""

    def __init__(self, pairs, inner: Any, axis: str, dim_order):
        super().__init__(pairs, inner.schedule(0))
        self.axis = axis
        for name, p in pairs:
            if not isinstance(p, DTensor):
                raise ValueError(f"ZeRO-1 needs parameters laid out over a mesh: {name}")
        placements = zero1_shardings(dict(pairs), self.params[0].device_mesh, axis, dim_order)
        self.slice = {p: p if placements[n] == tuple(p.placements)
                      else p.detach().redistribute(p.device_mesh, placements[n]).clone()
                      for n, p in pairs}
        self.inner = create(inner, [(n, self.slice[p]) for n, p in zip(self.names, self.params)])

    def stand_in(self, p):
        return self.slice[p]

    def grad_placements(self, p) -> tuple:
        """Where the train step reduces ``p``'s gradient: its slice's
        placement (a reduce-scatter from the data axis's partial sums)."""
        return tuple(self.slice[p].placements)

    def gather(self, name: str, t: DTensor) -> DTensor:
        """A slice-placed tensor of parameter ``name`` (its EMA, say) in the
        parameter's own placement: an all-gather."""
        p = self.params[self.names.index(name)]
        return t.redistribute(p.device_mesh, p.placements)

    def _refresh(self) -> None:
        for p, s in self.slice.items():
            if s is not p:
                s.copy_(p.detach().redistribute(p.device_mesh, s.placements))

    def reset(self) -> None:
        with torch.no_grad():
            self._refresh()
        super().reset()

    @torch.no_grad()
    def step(self, closure=None) -> None:
        # The slices restart from the parameters (a restore or a rollback
        # writes the parameters), then take the reduced gradients.
        self._refresh()
        stepped = []
        for p, s in self.slice.items():
            if s is p or p.grad is None:
                continue
            g = p.grad
            if tuple(g.placements) != tuple(s.placements):
                g = g.redistribute(p.device_mesh, s.placements)
            s.grad = g
            stepped.append((p, s))
        self._inner_step()
        for p, s in stepped:
            s.grad = None
            p.copy_(s.redistribute(p.device_mesh, p.placements))


@dataclasses.dataclass(frozen=True)
class Zero1:
    """A description whose optimizer keeps ``inner``'s state ZeRO-1 split
    over ``axis`` (``sharded_train_state(..., zero1_axis=axis)`` wraps the
    given optimizer in it)."""

    inner: Any
    axis: str = "data"
    dim_order: Callable[[str, int], Sequence[int]] = jax_dim_order
    takes_names = True

    @property
    def clip_norm(self):
        return self.inner.clip_norm

    def schedule(self, step: int) -> float:
        return self.inner.schedule(step)

    def create(self, params) -> Zero1Optimizer:
        return Zero1Optimizer(named(params), self.inner, self.axis, self.dim_order)


def state_bytes(optimizer) -> int:
    """This rank's bytes of optimizer state (local shards of every slot
    tensor) of any optimizer the train step holds."""
    total = 0
    for slots in optimizer.state.values():
        for t in slots.values():
            if isinstance(t, torch.Tensor):
                local = t.to_local() if isinstance(t, DTensor) else t
                total += local.numel() * local.element_size()
    return total


def make_zero1_update(
    *,
    loss_fn: Callable[..., torch.Tensor],
    mesh,
    rules,
    axis: str = "data",
    quantized_comm: bool = False,
    loss_needs_params: bool = False,
    apply_kwargs: dict | None = None,
):
    """A ZeRO-1 train step with the data axis's gradient sync made a stage
    of its own: ``zero1_update(state, batch) -> (state, loss)``, for a state
    from ``sharded_train_state(..., zero1_axis=axis)``.

    As JAX's, each data slice's contribution is computed apart (the batch
    split ``(D, b/D, ...)``, one forward and backward a slice, so a slice's
    FLOPs match the fused step's), and the fp32 mean of the D contributions
    (their sum, then ``/ D``) is reduced straight to the state's placement
    before the update. Mean-over-batch losses only, as JAX's: the mean of
    the slices' means is the global mean. A batch ``D`` does not divide
    raises ``ValueError``.

    ``quantized_comm=True`` (JAX's int8 ring reduce-scatter over
    ``parallel/compression.py``) comes with slice F and raises
    ``NotImplementedError``."""
    from learning_jax_sharding_tpu_torch.training.pipeline import _leading_dim, make_train_step

    if quantized_comm:
        raise NotImplementedError(
            "make_zero1_update(quantized_comm=True): the int8 ring reduce-scatter is "
            "ported with slice F (parallel/compression.py)")
    d = mesh.size(mesh.mesh_dim_names.index(axis))
    step = make_train_step(loss_fn=loss_fn, loss_needs_params=loss_needs_params,
                           apply_kwargs=apply_kwargs, grad_accum_steps=d, mesh=mesh,
                           rules=rules)

    def run(state, batch):
        n = _leading_dim(batch)
        if n % d:
            raise ValueError(f"batch dim {n} not divisible by mesh axis {axis!r} size {d}")
        return step(state, batch)

    return run
