"""Logical-axis layer: named model axes mapped to mesh axes by rules.

Port of ``learning_jax_sharding_tpu/parallel/logical.py``. The JAX model
declares each parameter's logical axes with ``nn.with_logical_partitioning``
and constrains activations with ``nn.with_logical_constraint``; a rules
tuple maps logical names to mesh axes at trace time. Here the same rules
resolve, by flax's algorithm (:func:`logical_to_mesh_axes`), to a
``PartitionSpec`` and then to DTensor placements:

* :func:`activate` binds a mesh and rules for the code under it (flax's
  ``axis_rules`` plus the mesh context), and lets plain tensors mix with
  DTensors as replicated values;
* :func:`constrain` redistributes a DTensor to the placements its logical
  axes resolve to, and is the identity with no active mesh, so the
  single-device paths run exactly as before.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

from learning_jax_sharding_tpu_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec,
    spec_to_placements,
)

# Canonical logical axis names (the JAX package's).
BATCH = "batch"    # examples: data-parallel
SEQ = "seq"        # sequence / context positions
EMBED = "embed"    # model (residual-stream) features
HEADS = "heads"    # attention heads
KV = "kv"          # per-head feature dim
HIDDEN = "hidden"  # feed-forward hidden features
MLP = "mlp"        # alias kept distinct for gated-FF variants
VOCAB = "vocab"    # embedding rows / logits columns
STAGE = "stage"    # pipeline stage
EXPERT = "expert"  # MoE expert
LAYERS = "layers"  # stacked-layer dim (unmapped in every rule set)

Rules = tuple[tuple[str, str | None], ...]

#: Case-6 parity rules: batch→data, embed→model, hidden→model.
RULES_REFERENCE: Rules = (
    (BATCH, "data"),
    (EMBED, "model"),
    (HIDDEN, "model"),
)

#: Megatron-style tensor parallelism: q/k/v column-parallel over heads,
#: out/down row-parallel, embed replicated.
RULES_DP_TP: Rules = (
    (BATCH, "data"),
    (HEADS, "model"),
    (HIDDEN, "model"),
    (MLP, "model"),
    (VOCAB, "model"),
)

#: DP×TP plus sequence sharding over the model axis between blocks.
RULES_DP_TP_SP: Rules = RULES_DP_TP + ((SEQ, "model"),)

#: Long-context layout: batch over data, sequence over model.
RULES_DP_SP: Rules = (
    (BATCH, "data"),
    (SEQ, "model"),
)

#: DP×TP plus expert parallelism (EXPERT listed before MLP to claim the
#: axis; within one spec the later MLP→model duplicate is dropped).
RULES_DP_TP_EP: Rules = (
    (BATCH, "data"),
    (HEADS, "model"),
    (HIDDEN, "model"),
    (EXPERT, "model"),
    (MLP, "model"),
    (VOCAB, "model"),
)

#: Expert parallelism over the batch axis (the all-to-all MoE dispatch).
RULES_DP_EP_A2A: Rules = (
    (BATCH, "data"),
    (EXPERT, "data"),
    (HEADS, "model"),
    (HIDDEN, "model"),
    (VOCAB, "model"),
)

#: Serving layout for the paged KV cache: tensor parallelism only.
RULES_TP_SERVING: Rules = (
    (HEADS, "model"),
    (HIDDEN, "model"),
    (MLP, "model"),
    (VOCAB, "model"),
)

#: Fully-sharded data parallel: parameters sharded over the data axis too.
RULES_FSDP: Rules = (
    (BATCH, "data"),
    (EMBED, "data"),
    (HEADS, "model"),
    (HIDDEN, "model"),
    (MLP, "model"),
)

_UNASSIGNED = object()


def _mesh_names(entry) -> set:
    if entry is None or entry is _UNASSIGNED:
        return set()
    return {entry} if isinstance(entry, str) else set(entry)


def logical_to_mesh_axes(logical_axes: Sequence[str | None], rules: Rules) -> PartitionSpec:
    """flax's ``logical_to_mesh_axes``: rules in order of precedence; each
    ``(logical, mesh)`` pair assigns its mesh axes to the array dim of that
    logical name when the dim is still unassigned and none of those mesh
    axes is taken yet. A rule mapping to ``None`` pins its dim unsharded."""
    logical_axes = tuple(logical_axes)
    dups = {a for a in logical_axes if isinstance(a, str) and logical_axes.count(a) > 1}
    if dups:
        raise ValueError(f"Unsupported: Dimensions {tuple(dups)} occur more than once in array names.")
    result = [_UNASSIGNED if isinstance(a, str) else a for a in logical_axes]
    for name, mesh_axes in rules:
        if name in logical_axes:
            pos = logical_axes.index(name)
            taken = set().union(*(_mesh_names(r) for r in result))
            if not (_mesh_names(mesh_axes) & taken) and result[pos] is _UNASSIGNED:
                result[pos] = tuple(mesh_axes) if isinstance(mesh_axes, list) else mesh_axes
    return PartitionSpec(*(None if r is _UNASSIGNED else r for r in result))


class _Active(threading.local):
    mesh: DeviceMesh | None = None
    rules: Rules | None = None


_ACTIVE = _Active()


def active_mesh() -> tuple[DeviceMesh | None, Rules | None]:
    """The ``(mesh, rules)`` bound by :func:`activate`, or ``(None, None)``."""
    return _ACTIVE.mesh, _ACTIVE.rules


@contextlib.contextmanager
def axis_rules(rules: Rules):
    """Bind logical→mesh rules for the code underneath (flax's
    ``axis_rules``), keeping the active mesh."""
    prev = _ACTIVE.rules
    _ACTIVE.rules = tuple(rules)
    try:
        yield
    finally:
        _ACTIVE.rules = prev


@contextlib.contextmanager
def activate(mesh: DeviceMesh, rules: Rules):
    """Enter the mesh and the logical rules together. Inside, plain tensors
    meeting DTensors count as replicated (``implicit_replication``)."""
    prev = (_ACTIVE.mesh, _ACTIVE.rules)
    _ACTIVE.mesh, _ACTIVE.rules = mesh, tuple(rules)
    # implicit_replication resets its flag on exit: enter it at the
    # outermost level only, so a nested activate leaves it on.
    outer = prev[0] is None
    try:
        with implicit_replication() if outer else contextlib.nullcontext():
            yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules = prev


def logical_sharding(mesh: DeviceMesh, rules: Rules, *logical_axes: str | None) -> NamedSharding:
    """``NamedSharding`` for an array whose dims carry ``logical_axes``."""
    return NamedSharding(mesh, logical_to_mesh_axes(logical_axes, rules))


def logical_placements(mesh: DeviceMesh, rules: Rules, logical_axes: Sequence[str | None]):
    """The DTensor placements of an array with ``logical_axes``."""
    return spec_to_placements(mesh, logical_to_mesh_axes(logical_axes, rules))


def tree_shardings(logical_tree: dict, mesh: DeviceMesh, rules: Rules) -> dict:
    """Shardings for a whole ``{name: logical axes}`` table (the port's
    counterpart of reading the axes off an abstract Flax tree)."""
    return {name: logical_sharding(mesh, rules, *axes) for name, axes in logical_tree.items()}


def attention_mesh_axes(rules: Rules, axis: str | None = None) -> tuple[str | None, str, str | None]:
    """The (batch, seq, heads) mesh axes of ``(B, S, N, H)`` attention
    operands under ``rules``; ``axis`` overrides the sequence axis."""
    axes = logical_to_mesh_axes((BATCH, SEQ, HEADS, KV), rules)
    seq_axis = axis if axis is not None else axes[1]
    if seq_axis is None:
        raise ValueError("rules map SEQ to no mesh axis and no axis= was given")
    return axes[0], seq_axis, axes[2]


def constrain(x, *logical_axes: str | None):
    """``nn.with_logical_constraint``: with an active mesh, a DTensor (or a
    plain tensor, taken as replicated) is redistributed to the placements
    its logical axes resolve to; partial sums are reduced on the way. With
    no active mesh, ``x`` comes back as it is."""
    mesh, rules = _ACTIVE.mesh, _ACTIVE.rules
    if mesh is None:
        return x
    placements = logical_placements(mesh, rules, logical_axes)
    if not isinstance(x, DTensor):
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(mesh, placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


class _ReducedGrad(torch.autograd.Function):
    """The identity; its gradient's partial sums are reduced (to
    replicated) on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and any(p.is_partial() for p in grad.placements):
            grad = grad.redistribute(grad.device_mesh, [
                Replicate() if p.is_partial() else p for p in grad.placements])
        return grad


def reduce_partial_grad(x):
    """``x`` as it is, whose gradient comes back with its partial sums
    reduced. A DTensor redistributed out of a masked partial (a lookup in a
    vocabulary-split table) needs it: DTensor cannot turn a partial-sum
    gradient into the masked partial its redistribution's backward asks
    for. A plain tensor passes untouched."""
    return _ReducedGrad.apply(x) if isinstance(x, DTensor) else x


def place(x, mesh: DeviceMesh, placements) -> DTensor:
    """``x`` (a DTensor, or a plain tensor taken as replicated) laid out as
    ``placements``; partial sums are reduced on the way."""
    placements = tuple(placements)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    return x


def _is_spec_list(specs) -> bool:
    return any(isinstance(e, tuple) for e in specs)


def local_call(fn, args, in_specs, out_specs, partial_grads=()):
    """Run ``fn`` on the local shards of ``args`` under the active mesh:
    the counterpart of the JAX package's ``shard_map`` around a kernel.
    Each tensor arg is laid out by its logical spec (``None`` for an arg
    passed as it is) and handed to ``fn`` as its local tensor; the outputs
    come back as DTensors laid out by ``out_specs`` (one spec, or a tuple of
    specs for a tuple of outputs). Gradients flow through: an arg's local
    gradient lies as the arg does, except for the args whose indices are in
    ``partial_grads`` (a parameter replicated over the shards of rows: each
    shard's gradient is its rows' share, a partial sum over the mesh dims
    that split the rows of ``args[0]``)."""
    mesh, rules = _ACTIVE.mesh, _ACTIVE.rules
    in_pl, moved, grad_pl = [], [], []
    rows = logical_placements(mesh, rules, in_specs[0])
    for i, (a, spec) in enumerate(zip(args, in_specs)):
        if spec is None or a is None:
            in_pl.append(None)
            grad_pl.append(None)
            moved.append(a)
            continue
        pl = logical_placements(mesh, rules, spec)
        in_pl.append(list(pl))
        grad_pl.append([Partial() if isinstance(p, Shard) else Replicate() for p in rows]
                       if i in partial_grads else list(pl))
        moved.append(place(a, mesh, pl))
    # local_map reads a tuple as one placement list per output: one output's
    # placements go as a list.
    if _is_spec_list(out_specs):
        out_pl = tuple(None if s is None else list(logical_placements(mesh, rules, s))
                       for s in out_specs)
    else:
        out_pl = list(logical_placements(mesh, rules, out_specs))

    def body(*local):
        # Contiguous outputs (a no-op for most kernels): a DTensor reshapes
        # by views, which a strided local tensor cannot take.
        out = fn(*local)
        if isinstance(out, tuple):
            return tuple(o.contiguous() if isinstance(o, torch.Tensor) else o for o in out)
        return out.contiguous()

    return local_map(body, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh)(*moved)


def on_whole_shards() -> bool:
    """No active mesh, or one whose every axis has size 1: each rank's
    shard of every tensor is the whole tensor, so a kernel that takes no
    split (the int4 q/k/v triple, the whole-FF kernel) still runs."""
    return _ACTIVE.mesh is None or _ACTIVE.mesh.size() == 1


def whole_call(fn, args, out_specs):
    """``fn(*args)``, or under an active mesh of size-1 axes ``fn`` on the
    local tensors (the whole arrays), its outputs laid out by
    ``out_specs`` (as :func:`local_call`'s)."""
    if _ACTIVE.mesh is None:
        return fn(*args)
    specs = tuple(None if a is None else (None,) * a.ndim for a in args)
    return local_call(fn, args, specs, out_specs)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group, the result replicated on it; the gradient of each
    rank's term is the (replicated) gradient of the sum, passed as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def vocab_parallel_xent(logits: DTensor, targets) -> DTensor:
    """Summed fp32 cross-entropy of ``(..., V)`` logits against integer
    ``targets``, on each shard: rows stay where they are (their sums come
    back as partial sums over the mesh dims that split them) and a split
    vocabulary is never gathered: the row max, the sum of exponentials and
    the target's logit meet across the vocabulary's mesh dims (Megatron's
    vocab-parallel cross-entropy)."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = tuple(Replicate() if isinstance(p, Partial) else p for p in logits.placements)
    logits = place(logits, mesh, pl)
    # Mesh dims of size 1 split nothing: on them the loss is the one-device
    # cross-entropy, op for op.
    vocab_dims = [i for i, p in enumerate(pl)
                  if isinstance(p, Shard) and p.dim == last and mesh.size(i) > 1]
    t_pl = tuple(p if isinstance(p, Shard) and p.dim < last else Replicate() for p in pl)
    out_pl = tuple(Partial() if isinstance(p, Shard) and p.dim < last else Replicate()
                   for p in pl)
    targets = place(targets, mesh, t_pl)
    coord = mesh.get_coordinate()
    chunk, offset = logits.shape[-1], 0
    for d in vocab_dims:
        chunk //= mesh.size(d)
        offset += coord[d] * chunk
    groups = [mesh.get_group(d) for d in vocab_dims]

    def body(lg, tg):
        lf = lg.float()
        if not groups:
            return torch.nn.functional.cross_entropy(lf.flatten(0, -2), tg.flatten().long(),
                                                     reduction="sum")
        m = lf.detach().amax(-1)
        for g in groups:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
        se = (lf - m[..., None]).exp().sum(-1)
        t = tg.long() - offset
        inside = (t >= 0) & (t < lf.shape[-1])
        tl = lf.gather(-1, t.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
        tl = torch.where(inside, tl, torch.zeros_like(tl))
        for g in groups:
            se = _AllReduceSum.apply(se, g)
            tl = _AllReduceSum.apply(tl, g)
        return (m + se.log() - tl).sum()

    return local_map(body, out_placements=list(out_pl), in_placements=(list(pl), list(t_pl)),
                     device_mesh=mesh)(logits, targets)
