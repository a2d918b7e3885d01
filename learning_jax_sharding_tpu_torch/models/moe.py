"""Mixture-of-Experts feed-forward with expert parallelism.

Port of ``learning_jax_sharding_tpu/models/moe.py``: the GShard/Switch
capacity scheme, every expert taking exactly ``C`` token slots a step,
chosen by an int32 position cumsum, overflow dropped (the residual carries
those tokens). Three dispatches of the same routing (:func:`assign_slots`,
the one slot rule):

* ``"einsum"``: ``(T, E, C)`` one-hot dispatch and combine tensors and
  their contractions;
* ``"scatter"``: each kept (token, rank) moves by its flat slot id
  (``expert·C + position``) into an ``(E, C, M)`` pool and back, no routing
  FLOPs;
* ``"alltoall"``: ``dispatch_fn`` (``ops.moe_dispatch.make_moe_a2a_fn``),
  scatter's bucketing per token shard and one all-to-all each way over the
  expert mesh axis (capacity per token group).

Expert weights are ``up`` (E, M, H) and ``down`` (E, H, M), the JAX layout,
with logical axes ``(EXPERT, EMBED, MLP)`` / ``(EXPERT, MLP, EMBED)``; the
router is an ``nn.Linear`` computed in fp32 whatever the compute dtype (a
weight cast for serving is read back in fp32, as Flax's fp32 ``Dense``
promotes it). Over a mesh the
einsum and scatter paths route the whole batch on every rank (one global
group, as the JAX model's capacity) and run each rank's experts on its
slice of the stacks.

The load-balancing loss (Switch eq. 4, on rank-0 choices) is sown into the
``"losses"`` collection: :func:`collecting` gathers what the forwards under
it sow (``training.pipeline.make_train_step(aux_loss_collection=
"losses")`` adds it to the task loss). A forward outside it sows nothing,
so a block recomputed under remat in the backward never counts twice.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable

import torch
from torch import nn

from learning_jax_sharding_tpu_torch.models.attention import make_linear
from learning_jax_sharding_tpu_torch.parallel.logical import (
    BATCH,
    EMBED,
    EXPERT,
    MLP,
    SEQ,
    active_mesh,
    constrain,
    local_call,
)


class _Sinks(threading.local):
    def __init__(self):
        self.open: list[tuple[str, list]] = []


_SINKS = _Sinks()


@contextlib.contextmanager
def collecting(collection: str):
    """Gather the values sown into ``collection`` (Flax's ``mutable=``) by
    the forwards run under the block, on this thread: yields the list they
    are appended to, in the order sown."""
    sink: list = []
    _SINKS.open.append((collection, sink))
    try:
        yield sink
    finally:
        _SINKS.open.pop()


def sow(collection: str, value: torch.Tensor) -> None:
    """Flax's ``sow``: hand ``value`` to every open :func:`collecting`
    block of ``collection`` on this thread (none open: dropped)."""
    for name, sink in _SINKS.open:
        if name == collection:
            sink.append(value)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index first (``argmax`` takes the first maximum), as XLA's stable
    top-k."""
    vals, idx, rest = [], [], probs
    for _ in range(k):
        i = rest.argmax(-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        idx.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


def one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: a row of zeros for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def assign_slots(probs: torch.Tensor, top_k_: int, capacity: int):
    """THE slot rule of every dispatch: top-k choices, rank-major GShard
    priority (every rank-0 choice claims a slot before any rank-1 choice),
    an int32 position cumsum, the capacity drop, and the surviving gates
    renormalised per token at ``top_k > 1`` (the sum clamped at 1e-9).

    ``probs`` (T, E) for T tokens of one group → ``(gate_vals (T, k),
    gate_idx (T, k), pos (T, k, E) int32, fits (T, k, E), masks (T, k,
    E))``."""
    t, e = probs.shape
    gate_vals, gate_idx = top_k(probs, top_k_)                   # (T, k)
    masks = one_hot(gate_idx, e)                                 # (T, k, E)
    flat = masks.transpose(0, 1).reshape(top_k_ * t, e)          # (k·T, E)
    flat_i = flat.to(torch.int32)
    pos = torch.cumsum(flat_i, 0, dtype=torch.int32) - flat_i
    fits = flat * (pos < capacity)                               # drop overflow
    pos = pos.reshape(top_k_, t, e).transpose(0, 1)              # (T, k, E)
    fits = fits.reshape(top_k_, t, e).transpose(0, 1)            # (T, k, E)
    kept = (masks * fits).sum(-1)                                # (T, k)
    if top_k_ > 1:
        kept_vals = gate_vals * kept
        denom = torch.clamp(kept_vals.sum(-1, keepdim=True), min=1e-9)
        gate_vals = kept_vals / denom
    else:
        gate_vals = gate_vals * kept
    return gate_vals, gate_idx, pos, fits, masks


def slot_positions(pos: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Each (token, rank)'s position in its chosen expert: (T, k)."""
    return (pos * masks.to(torch.int32)).sum(-1)


def scatter_slot_ids(pos, fits, masks, gate_idx, capacity: int, num_experts: int):
    """Each kept (token, rank)'s flat slot id ``expert·C + position``
    (unique: a token's ranks pick distinct experts); dropped entries take
    the dump slot ``E·C``. Shared by the scatter and all-to-all paths."""
    kept = (masks * fits).sum(-1) > 0                            # (T, k)
    ids = gate_idx * capacity + slot_positions(pos, masks)
    return torch.where(kept, ids, num_experts * capacity).reshape(-1)   # (T·k,)


def bucket_tokens(xf, flat_slot, num_experts: int, capacity: int, top_k_: int, dtype):
    """Scatter the tokens into the ``(E, C, M)`` slot pool by their flat
    slot ids (the dump row past the pool takes the dropped entries): the
    movement half of the flop-free dispatch."""
    t, m = xf.shape
    token_of = torch.arange(t, device=xf.device).repeat_interleave(top_k_)
    pool = torch.zeros(num_experts * capacity + 1, m, dtype=dtype, device=xf.device)
    pool = pool.index_put((flat_slot,), xf.to(dtype)[token_of])
    return pool[:-1].reshape(num_experts, capacity, m)


def combine_slots(expert_out, flat_slot, gate_vals, top_k_: int, dtype):
    """Gather each (token, rank)'s slot output (the dump slot reads zero)
    and fold in the gates, which carry the kept mask and normalisation."""
    e, c, m = expert_out.shape
    eflat = torch.cat([expert_out.reshape(e * c, m), expert_out.new_zeros(1, m)])
    per_rank = eflat[flat_slot].reshape(gate_vals.shape[0], top_k_, m)
    return torch.einsum("tkm,tk->tm", per_rank, gate_vals.to(dtype))


def expert_ff(expert_in, w_up, w_down, dtype):
    """The experts' FF on their ``(E, C, M)`` slots: up, tanh GELU (Flax's
    ``nn.gelu``), down."""
    h = torch.einsum("ecm,emh->ech", expert_in, w_up.to(dtype))
    h = nn.functional.gelu(h, approximate="tanh")
    return torch.einsum("ech,ehm->ecm", h, w_down.to(dtype))


def load_balancing_loss(probs, masks0, weight: float) -> torch.Tensor:
    """Switch eq. 4: ``weight · E · Σ load · importance`` over the rank-0
    choices ``masks0`` (T, E) and the router probabilities (T, E)."""
    e = probs.shape[-1]
    return weight * e * (masks0.mean(0) * probs.mean(0)).sum()


def _whole(x):
    """A DTensor as the whole tensor on every rank (differentiable)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _lecun_stack_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """Flax's ``lecun_normal`` on an ``(E, in, out)`` stack: its fans count
    the leading dim as a receptive field, fan_in = E · in."""
    std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class MoEFeedForward(nn.Module):
    """Top-k routed expert FF, the drop-in for the dense ``FeedForward``.

    ``features`` M, ``hidden`` H a expert, ``num_experts`` E, ``top_k``
    experts a token, ``capacity_factor``: each expert takes ``C = min(T,
    max(1, ceil(top_k · T · capacity_factor / E)))`` slots for the ``T =
    B·S`` tokens of a call. ``aux_loss_weight`` scales the sown
    load-balancing loss; ``router_noise``: multiplicative jitter on the
    router logits in training (drawn from the forward's dropout
    ``generator``; off when ``deterministic``). ``dispatch``: ``"einsum"``,
    ``"scatter"`` or ``"alltoall"`` (with ``dispatch_fn``)."""

    def __init__(self, features: int, hidden: int, *, num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 1e-2,
                 router_noise: float = 0.0, dtype=torch.float32, param_dtype=torch.float32,
                 dispatch: str = "einsum", dispatch_fn: Callable | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.features, self.hidden, self.num_experts = features, hidden, num_experts
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.aux_loss_weight, self.router_noise = aux_loss_weight, router_noise
        self.dtype, self.dispatch, self.dispatch_fn = dtype, dispatch, dispatch_fn
        self.router = make_linear(features, num_experts, bias=False, dtype=torch.float32,
                                  device=device, generator=generator)
        self.up = nn.Parameter(_lecun_stack_(
            torch.empty(num_experts, features, hidden, dtype=param_dtype, device=device),
            generator))
        self.down = nn.Parameter(_lecun_stack_(
            torch.empty(num_experts, hidden, features, dtype=param_dtype, device=device),
            generator))

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(f"top_k={self.top_k} not in [1, {self.num_experts}]")
        if self.dispatch not in ("einsum", "scatter", "alltoall"):
            raise ValueError(
                f"unknown dispatch {self.dispatch!r}: 'einsum', 'scatter', or 'alltoall'"
            )
        if self.dispatch == "alltoall" and self.dispatch_fn is None:
            raise ValueError(
                "dispatch='alltoall' needs dispatch_fn — build one with "
                "ops.moe_dispatch.make_moe_a2a_fn(mesh)"
            )
        b, s, m = x.shape
        e, k = self.num_experts, self.top_k
        t = b * s
        x = constrain(x, BATCH, SEQ, EMBED)
        noise = None
        if self.router_noise > 0.0 and not deterministic:
            if generator is None:
                raise ValueError("router_noise with deterministic=False needs a generator")
            u = torch.rand((b, s, e), generator=generator, device=self.up.device)
            noise = 1.0 - self.router_noise + 2.0 * self.router_noise * u
        if self.dispatch == "alltoall":
            return self._alltoall(x, noise)

        # One global group: every rank routes the whole batch.
        xf = _whole(x).reshape(t, m)
        logits = nn.functional.linear(xf.float(), _whole(self.router.weight).float())
        if noise is not None:
            logits = logits * noise.reshape(t, e)
        probs = torch.softmax(logits, -1)                          # (T, E)
        capacity = min(t, max(1, math.ceil(k * t * self.capacity_factor / e)))
        gate_vals, gate_idx, pos, fits, masks = assign_slots(probs, k, capacity)
        sow("losses", load_balancing_loss(probs, masks[:, 0], self.aux_loss_weight))
        if self.dispatch == "einsum":
            slot = one_hot(slot_positions(pos, masks), capacity)   # (T, k, C)
            dispatch = torch.einsum("tke,tkc->tec", fits, slot)
            combine = torch.einsum("tke,tkc,tk->tec", fits, slot, gate_vals)
            expert_in = torch.einsum("tec,tm->ecm", dispatch.to(self.dtype), xf.to(self.dtype))
        else:
            flat_slot = scatter_slot_ids(pos, fits, masks, gate_idx, capacity, e)
            expert_in = bucket_tokens(xf, flat_slot, e, capacity, k, self.dtype)
        expert_out = self._experts(expert_in)
        if self.dispatch == "einsum":
            out = torch.einsum("tec,ecm->tm", combine.to(self.dtype), expert_out)
        else:
            out = combine_slots(expert_out, flat_slot, gate_vals, k, self.dtype)
        return constrain(out.reshape(b, s, m), BATCH, SEQ, EMBED)

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """The expert FF on the whole ``(E, C, M)`` slot pool; over a mesh
        each rank runs its slice of the stacks (the rules' ``EXPERT``
        placement) and the outputs are gathered whole."""
        run = lambda x_, u_, d_: expert_ff(x_, u_, d_, self.dtype)   # noqa: E731
        if active_mesh()[0] is None:
            return run(expert_in, self.up, self.down)
        out = local_call(run, (expert_in, self.up, self.down),
                         ((EXPERT, None, EMBED), (EXPERT, EMBED, MLP), (EXPERT, MLP, EMBED)),
                         (EXPERT, None, EMBED))
        return _whole(out)

    def _alltoall(self, x: torch.Tensor, noise) -> torch.Tensor:
        """The explicit expert-parallel path: the router on each rank's
        tokens, ``dispatch_fn`` routing each token shard (its own capacity)
        and exchanging the slots; the aux loss over the whole batch, its
        one-hot in the probabilities' dtype as the JAX path takes it."""
        b, s, m = x.shape
        e, t = self.num_experts, b * s

        def route(x_, w_, *n_):
            logits = nn.functional.linear(x_.float(), w_.float())
            return torch.softmax(logits * n_[0] if n_ else logits, -1)

        args, specs = [x, self.router.weight], [(BATCH, SEQ, EMBED), (None, None)]
        if noise is not None:
            args.append(noise)
            specs.append((BATCH, SEQ, None))
        if active_mesh()[0] is None:
            probs = route(*args)
        else:
            # The router is whole on every rank: each rank's gradient is its
            # tokens' share.
            probs = local_call(route, args, specs, (BATCH, SEQ, None), partial_grads=(1,))
        whole = _whole(probs).reshape(t, e)
        sow("losses", load_balancing_loss(
            whole, one_hot(whole.argmax(-1), e, whole.dtype), self.aux_loss_weight))
        out = self.dispatch_fn(x.reshape(t, m), probs.reshape(t, e), self.up, self.down,
                               top_k=self.top_k, capacity_factor=self.capacity_factor,
                               dtype=self.dtype)
        return constrain(out.reshape(b, s, m), BATCH, SEQ, EMBED)
