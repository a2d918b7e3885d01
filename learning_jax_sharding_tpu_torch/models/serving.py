"""Continuous batching: a persistent engine serving requests over time.

Port of ``learning_jax_sharding_tpu/models/serving.py``, on one device or
over a mesh: :class:`ContinuousEngine` and :func:`make_continuous_engine`
with greedy or
keyed sampled decoding, speculative decoding, the split and the mixed
refill+decode schedulers, the multi-step horizon, the paged KV cache and
the prefix cache. The names, arguments, errors and bookkeeping follow the
JAX engine; the allocator, prefix cache and schedulers are host code ported
almost line for line.

A fixed batch of cache slots serves a request queue: a finished row's slot
is refilled with the next queued prompt while the other rows keep their
state. Each :meth:`ContinuousEngine.step` admits queued requests into idle
slots, then runs ONE dispatch. The split engine (the default) runs:

* a **refill** when any slot has pending prompt tokens: a fixed ``(B,
  refill_chunk)`` chunk whose per-row valid length rides the ragged
  ``chunk_lengths`` (decoding and idle rows ride with 0), up to
  ``decode_chain`` chunks back to back with one host sync;
* else a **decode block** when any row is active: ``decode_block_steps``
  steps with ``tok``, ``active`` and ``remaining`` kept on the device (no
  host sync inside the block; rows freeze at EOS or at their budget and
  ride on with chunk length 0), up to ``decode_chain`` blocks chained with
  one sync. With ``draft_config`` each step is a draft-verify ROUND: the
  draft proposes ``num_draft`` tokens, the target verifies them in one
  ``(B, num_draft + 1)`` chunk, and each row accepts and rewinds its own
  cache (``models/speculative.py``).

``mixed=True`` fuses the two: each link advances every decoding row by one
token (or one round) AND pushes refill chunks scheduled FCFS under
``token_budget``, up to ``decode_chain`` links with one sync; pure-decode
phases fall through to the decode block. ``horizon > 1`` runs ``horizon``
planned links a dispatch with ``tok``, ``active`` and ``remaining`` on the
device and one sync after the last link, while the host stages the next
horizon's plan.

``temperature > 0`` samples every token from keys of (request id,
generated position) folded into the engine's key, speculative draws also
by a stream tag, through the port's threefry (``utils/prng.py``): a
request's tokens do not depend on its slot, batch or schedule, and equal
keys draw the JAX engine's tokens.

Admission is a reset of the row's counters (``_reset_rows``): stale K/V
past a reset row's index is hidden by the causal-at-index masks and
overwritten as the new request writes.

``paged_pages``: each layer's K/V live in pools of ``paged_pages`` pages of
``page_size`` tokens (page 0 is scratch), reached through one ``(B,
max_seq_len // page_size)`` block table that this host loop owns (a draft
model's pools page through the same table): pages are allocated as a row's
index approaches them and freed when the request retires, and the table is
pushed to the device only when it changed. ``prefix_cache``: a retired
request's prompt pages are kept under their page-aligned token prefix,
reference-counted, and mapped into a later request whose prompt starts
with the same tokens (the last prompt token is always recomputed);
reference-free pages are evicted LRU, chain tails before their roots. Pool
pressure preempts a request and recomputes it later, which cannot change
its tokens.

Device work is the model calls (``Transformer`` in decode mode, the blocked
backend on a GPU: decode attention's CUDA kernel, its paged mode with a
table) and the sampling draws; everything else here is host bookkeeping.
Host arrays reach the card through pinned buffers without blocking, so a
chain of dispatches queues back to back.

Over a mesh (``mesh``/``rules``, the JAX engine's signature) every rank runs
the same engine: the weights lie over the mesh by their logical axes, each
rank holds its shard of the KV caches (page pools over heads only), and the
model calls run every kernel on each rank's shards. Each call's logits come
back whole on every rank (``models/decoding.py::whole_logits``); the
per-row counters and the block table stay whole on every rank. So every
tensor the host reads is whole and equal on every rank, and so is every
host decision; see :class:`ContinuousEngine`.

The engine meters itself as the JAX engine does: a
:class:`~learning_jax_sharding_tpu_torch.telemetry.MetricsRegistry`
(``engine.registry``; ``last_stats`` and ``last_latency`` are windows over
its cumulative counters), a
:class:`~learning_jax_sharding_tpu_torch.telemetry.Tracer`
(``engine.tracer``), the process's flight recorder (``engine.recorder``),
a goodput ledger (``engine.ledger``: every second of the loop's wall clock
in one bucket) and an optional request trace store (``engine.trace_sink``).
The recovery policies are the JAX engine's: request deadlines, a bounded
queue, the SLO-driven degradation ladder and the quarantine of requests
whose dispatches fault (see :class:`ContinuousEngine`).

The engine also hands work between engines and tiers, as the JAX engine
does: ``drain_requests`` retires every request with a terminal status and
returns records to requeue elsewhere; ``export_kv`` / ``ingest_kv`` hand a
finished prefill's cache row to a decode engine (disaggregated serving,
through ``fleet/kv_transfer.py``'s transfer plan); ``spill_page`` /
``fill_page`` demote a retained prefix page to host memory and promote it
back, and ``prefix_digest`` exports the prefix registry's page hashes; and
``swap_weights`` stages new weights in the serving layout and commits them
between dispatches with no request dropped, each response carrying the one
``weights_version`` it was served under. Every byte these move goes through
``parallel/resharding.py``'s counted plans and into the goodput ledger's
``kv_handoff`` and ``swap`` buckets.

Not ported yet, each raising ``NotImplementedError`` naming its part:
multi-LoRA adapters (``adapter_pool``, ``add_request(adapter=)``, items 12
and 15), communication compression and the transfer codecs
(``comm_compression``, slice F) and the introspection of slice G
(``compile_counts``, ``collective_inventory``, ``program_hlo``,
``check_contracts``, ``explain_collectives``, ``overlap_report``,
``comm_report``, ``collective_axis_volume``, ``dump_diagnostics``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import time
from collections import deque
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from learning_jax_sharding_tpu_torch import resolve_device
from learning_jax_sharding_tpu_torch.models.attention import (
    resolve_decode_backend,
    row_update_masked,
)
from learning_jax_sharding_tpu_torch.models.decoding import (
    apply_dequantize_policy,
    check_sequence_budget,
    derive_decode_config,
    make_cached_apply,
    make_param_caster,
    whole_logits,
)
from learning_jax_sharding_tpu_torch.models.convert import (
    install_tensor,
    layout_tensors,
    param_logical_axes,
    shard_params,
)
from learning_jax_sharding_tpu_torch.models.generate import filtered_logits
from learning_jax_sharding_tpu_torch.models.quantize import dequantize_tree
from learning_jax_sharding_tpu_torch.models.speculative import (
    _greedy as greedy_pick,
    _rollback,
    emit_vector,
    greedy_accept_emit,
    rejection,
)
from learning_jax_sharding_tpu_torch.models.transformer import (
    DecodeCache,
    Transformer,
    TransformerConfig,
)
from learning_jax_sharding_tpu_torch.ops import _build
from learning_jax_sharding_tpu_torch.parallel.logical import activate, logical_placements
from learning_jax_sharding_tpu_torch.parallel.resharding import (
    HostBuffer,
    devices_indices_map,
    execute_transfer,
    plan_transfer,
    reshard_tree,
    sharding_of,
)
from learning_jax_sharding_tpu_torch.parallel.sharding import (
    NamedSharding,
    P,
    local_slice,
    placements_to_spec,
)
from learning_jax_sharding_tpu_torch.robustness.chaos import (
    InjectedFault,
    chaos_active,
    chaos_hook,
)
from learning_jax_sharding_tpu_torch.telemetry import (
    GoodputLedger,
    MetricsRegistry,
    Tracer,
    default_flight_recorder,
)
from learning_jax_sharding_tpu_torch.utils import prng
from learning_jax_sharding_tpu_torch.utils.profiling import annotate

#: Dispatch failures the quarantine recovers from (an injected hang or
#: abort, a NaN trap); anything else propagates.
_RECOVERABLE_DISPATCH = (InjectedFault, FloatingPointError)

#: The cache leaves with a leading physical-page dim on paged engines: what
#: ``spill_page`` and ``fill_page`` move one page of, a layer at a time in
#: this order. The per-row counters and the block table stay: a retained
#: prefix page carries K/V only, and its mapping is host state.
_PAGE_LEAF_KEYS = ("key", "value", "key_scale", "value_scale")


class AdmissionError(RuntimeError):
    """Admission control rejected the request (bounded queue full, or the
    degradation ladder at its shedding level). Nothing was enqueued."""


@dataclasses.dataclass
class RequestFailure:
    """A request that retired without completing, surfaced through
    ``pop_finished``: status ``"deadline"`` (its TTL passed), ``"poisoned"``
    (quarantined after repeated dispatch faults), ``"malformed"`` (its
    prompt failed the admission check), ``"shutdown"``
    (:meth:`ContinuousEngine.close` drained it) or ``"rerouted"`` (drained
    by :meth:`ContinuousEngine.drain_requests` to be recomputed elsewhere:
    terminal only for this engine). ``tokens`` holds the partial ``[prompt,
    generated...]`` output when it had been admitted."""

    rid: int
    status: str              # deadline|poisoned|malformed|shutdown|rerouted
    error: str | None = None
    tokens: np.ndarray | None = None


def _reset_rows(cache: DecodeCache, mask: torch.Tensor,
                values: torch.Tensor | None = None) -> DecodeCache:
    """Set the per-row decode counters (every layer's ``index`` and the
    ``position``) where ``mask`` is True, IN PLACE: request admission.
    ``values`` (``(B,)``, default zeros) is the admission index: 0 for a
    fresh prompt, or the shared-prefix length when the prefix cache hands
    the row filled pages."""
    for counter in [layer.index for layer in cache.layers] + [cache.position]:
        v = torch.zeros_like(counter) if values is None else values.to(counter.dtype)
        counter.copy_(torch.where(mask, v, counter))
    return cache


def _tensor_state(t: torch.Tensor):
    """A tensor's in-place version, or None for an inference tensor, which
    tracks none (it can change only inside ``torch.inference_mode()``, and
    keys on its identity alone)."""
    return None if t.is_inference() else t._version


def _storage(t: torch.Tensor) -> int:
    """The address of a tensor's storage (a DTensor's local one)."""
    return (t.to_local() if isinstance(t, DTensor) else t).untyped_storage().data_ptr()


def _same_tensors(key, cached) -> bool:
    """Whether two ``[(tensor, in-place version)]`` lists name the same
    tensor objects at the same versions."""
    return cached is not None and len(key) == len(cached) and all(
        t is c and v == cv for (t, v), (c, cv) in zip(key, cached))


@dataclasses.dataclass
class _Request:
    """Host bookkeeping for one request, from arrival to retirement."""

    rid: int
    prompt: np.ndarray
    arrival_t: float
    admit_t: float | None = None
    seq: int = 0                          # add order: the refill queue's last tie-break
    order_t: float = 0.0                  # the refill queue's arrival stamp (add_request)
    admit_pass: int | None = None         # the admission pass that first took it
    first_token_t: float | None = None
    finish_t: float | None = None
    tokens: np.ndarray | None = None      # final [prompt, generated...]
    status: str = "ok"                    # or deadline|poisoned|malformed|shutdown
    error: str | None = None
    deadline_s: float | None = None       # per-request TTL override
    strikes: int = 0                      # dispatch faults while admitted
    enqueue_t: float | None = None        # when this engine queued it
    tenant: str | None = None             # SLO / trace label
    version: int = 0                      # weights version pinned at admission
    ingested: bool = False                # prefilled on another engine (ingest_kv)


#: The JAX engine's counters after ``engine_rerouted_total``, in its order
#: (a scrape lists them so): the KV handoff and tier, compression (slice F:
#: at zero), the prefix router's, swaps, adapters (items 12 and 15: at zero).
_LATER_COUNTERS = (
    ("engine_kv_exports_total", "retired-request KV rows exported for disaggregated handoff"),
    ("engine_kv_ingests_total",
     "externally prefilled requests ingested (disaggregated handoff)"),
    ("engine_kv_page_spills_total",
     "retained prefix pages demoted (spilled) out of HBM to a host tier"),
    ("engine_kv_page_fills_total", "prefix pages promoted (filled) back into HBM from a tier"),
    ("engine_kv_page_spill_bytes_total", "bytes moved HBM → host demoting prefix pages"),
    ("engine_kv_page_fill_bytes_total", "bytes moved host → HBM promoting prefix pages"),
    ("engine_kv_raw_bytes_total",
     "pre-codec bytes of counted KV/page/swap host transfers — the *_bytes_total counters "
     "book WIRE bytes, so the gap to this counter is what the codec saved"),
    ("engine_comp_drift_probes_total", "compressed-vs-plain-oracle drift probes run"),
    ("engine_comp_drift_disagreements_total",
     "active rows whose greedy pick diverged from the plain oracle during a drift probe"),
    ("engine_comp_drift_trips_total",
     "drift-budget breaches that auto-disabled the quantized serving collectives (one-way "
     "until an operator re-enables)"),
    ("engine_prefix_expected_total", "admissions the router placed expecting a prefix hit"),
    ("engine_tier_misses_total",
     "admissions whose realized prefix hit fell short of the router's prediction (page "
     "evicted/raced away mid-route) — the request gracefully re-prefilled the missing tokens"),
    ("engine_swap_staged_total",
     "weight swaps staged (resharded into the serving layout off the hot path)"),
    ("engine_swap_commits_total", "weight swaps atomically committed between dispatches"),
    ("engine_swap_aborted_total",
     "weight swaps aborted during staging — the engine kept the old version, in-flight "
     "requests unaffected"),
    ("engine_swap_bytes_total",
     "bytes moved staging swapped weight trees into the serving layout"),
    ("engine_adapter_dispatches_total", "fused dispatches that gathered per-row adapters"),
    ("engine_adapter_rows_total", "occupied row-dispatches served under a non-base adapter"),
)


def _not_ported(name: str, where: str):
    """An engine method of a part not ported yet: raises naming the part."""
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{name}: ported with {where}")
    method.__name__ = method.__qualname__ = name
    method.__doc__ = f"Not ported yet: comes with {where}."
    return method


class ContinuousEngine:
    """A persistent continuous-batching engine, on one device or over a mesh.

    Construction builds the decode model(s) and validates the
    configuration; the engine then serves any number of workloads, one-shot
    (``serve(params, prompts, rng=None, draft_params=None)``: outputs in
    queue order) or streaming (``add_request`` at any time, ``step(params,
    draft_params)`` per scheduler iteration, ``pop_finished()``). The KV
    cache, page pool and prefix registry persist across calls: the cache is
    created by the first refill, once per engine (``cache_creations``), and
    prefix hits span calls. The registry keys pages by token bytes only, so
    call ``flush_prefix_cache()`` when the served params change.

    Each result is ``[prompt, generated...]``: generation stops at
    ``eos_id`` (included) or after ``max_new_tokens``. ``batch_size`` fixes
    the device batch (cache slots), ``refill_chunk`` the admission chunk
    (longer prompts stream through several refills), ``decode_block_steps``
    the steps (or speculative rounds) per decode dispatch, ``decode_chain``
    (public, read at each dispatch) how many refill chunks, decode blocks
    or mixed links go back to back with one host sync. ``dequantize``
    serves quantized weights as ``make_generate_fn`` does (``"fused"``,
    ``"fused_w4a8"`` or ``True``); ``paged_pages`` / ``page_size`` /
    ``prefix_cache`` as in the module docstring. ``device=None`` means
    ``cuda``.

    ``temperature > 0`` samples through the filters ``top_k`` / ``top_p`` /
    ``min_p`` / ``vocab_limit`` with draws keyed by (request id, generated
    position): ``serve()`` numbers requests by queue index and re-keys the
    engine with its ``rng`` (an int seed or two-word key data,
    ``jax.random.key(0)``'s when None), which stays the key of later
    streaming, as in the JAX engine; ``add_request`` ids are engine-global.

    ``draft_config`` turns on speculative decode blocks: pass the draft
    params as ``serve(..., draft_params=...)``; ``num_draft`` proposals a
    round; ``draft_dequantize=True`` serves a quantized draft dequantized
    inside each draft call. Greedy output equals the non-speculative
    engine's; sampled output follows the target's filtered distribution.

    ``mixed=True`` runs the fused refill+decode links under
    ``token_budget`` (public, read at each dispatch; default ``refill_chunk
    + batch_size``: decode rows funded first, refill takes the rest);
    ``horizon`` (public, read at each dispatch; > 1 requires ``mixed``) is
    the links one dispatch plans and runs.

    ``mesh``/``rules``: the engine over a ``DeviceMesh`` (SPMD: every rank
    constructs the same engine and makes the same calls, ``serve`` or
    ``add_request``/``step``, with the same arguments). Each rank's host
    loop decides admission, refill chunks, chains, horizon plans, page
    allocation, prefix hashing, retirement and preemption from values equal
    on every rank only: the whole logits every model call hands back, the
    whole per-row counters, and counters of its own (the refill queue orders
    by admission pass, the caller's ``arrival_t`` and add order, never by a
    clock). So every rank serves
    the same tokens and ``last_stats``, and issues the same collectives in
    the same order. Paged serving under rules that split the batch raises
    ``ValueError`` (any row may read any page), as the JAX engine does.

    ``model_forwards`` counts the target model calls the engine issued and
    ``draft_forwards`` the draft's, each a launch of decode attention per
    layer on the blocked backend.

    After each ``serve`` (and on demand through ``latency_stats()``):
    ``last_stats`` holds ``page_high_water`` (live pages, retained
    reference-free prefix pages apart), ``pages_total``, ``page_size``,
    ``preemptions`` and, with the prefix cache, ``prefix_hits``,
    ``prefix_pages_reused`` and ``prefix_pages_retained``, and, speculative,
    ``spec_accepted`` / ``spec_proposed`` / ``spec_accept_rate`` (``None``
    when no mode is on); ``last_latency`` the TTFT, TPOT, ITL, queue-wait
    and end-to-end p50/p99 in seconds, the refill share and the decode
    stall share of dispatch time, the shed and deadline-miss rates, and
    with a horizon the dispatches, links a dispatch and staged-plan reuse.
    Both are windows (``reset_stats``) over the cumulative counters of
    ``registry`` (engine-local unless one is passed in).

    Telemetry: ``registry``, ``tracer`` (a per-request timeline, arrival →
    admit → first token → finish, and a span a dispatch), ``recorder`` (the
    process's flight recorder unless one is passed: arrivals, admissions,
    preemptions, retirements, faults, degradation), ``ledger`` (a
    :class:`~learning_jax_sharding_tpu_torch.telemetry.GoodputLedger`:
    ``step()`` is its top-level frame; model-call launches and the host
    reads that wait for them book ``device``, or ``compile`` when a kernel
    library was built or loaded meanwhile), ``slo`` (an optional
    :class:`~learning_jax_sharding_tpu_torch.telemetry.SLOMonitor` fed
    TTFT, TPOT, ITL, queue wait, end-to-end latency and the decode stall
    per dispatch) and ``trace_sink`` (an optional
    :class:`~learning_jax_sharding_tpu_torch.telemetry.TraceStore`, legs
    recorded at retirement). Every dispatch runs inside a
    ``torch.profiler.record_function`` range named ``engine.<program>``.

    Recovery policies, the JAX engine's:

    * ``deadline_s`` (the engine's TTL; ``add_request(deadline_s=)``
      overrides it): a request older than its TTL, queued or in flight,
      retires with status ``"deadline"``;
    * ``max_queue``: an arrival past the bound raises
      :class:`AdmissionError` (nothing enqueued; ``engine_shed_total``);
    * ``degradation=DegradationLadder(...)`` (needs ``slo``): the monitor's
      burn rate walks speculation off (level 1), ``token_budget`` halved
      (level 2, mixed engines) and shedding new admits (level 3), with
      hysteresis; ``degradation_level`` reads the level;
    * quarantine: a dispatch that raises a recoverable fault (an injected
      hang or abort, a NaN trap; ``robustness/chaos.py``'s
      ``engine.dispatch`` seam) strikes every request in flight; a request
      at ``max_dispatch_strikes`` retires ``"poisoned"``, the others are
      requeued and readmitted one at a time (probation), recomputing their
      tokens exactly.

    Over a mesh of more than one rank the decisions that read a clock are
    taken on the mesh's first rank and broadcast (the expired requests, the
    ladder's level), and, while a chaos injector is installed, a fault at
    the dispatch seam on any rank is a fault on every rank (a MAX
    reduction before the dispatch's work), so every rank takes the same
    decisions. These collectives run in the mesh's own groups: ranks
    outside the mesh take no part. An injector must be installed alike on
    every rank, and its other faults must fire alike on every rank (a
    sticky fault, ``rid=k, count=-1``). A fault raised in the middle of a
    dispatch over such a mesh (a NaN trap of ``utils/profiling.checking``
    on one rank's shard) is not recovered: the other ranks may wait in the
    dispatch's next collective, so it propagates.
    """

    def __init__(
        self,
        config: TransformerConfig,
        mesh=None,
        rules=None,
        *,
        batch_size: int,
        max_new_tokens: int,
        eos_id: int | None = None,
        refill_chunk: int = 64,
        decode_block_steps: int = 16,
        decode_chain: int = 1,
        mixed: bool = False,
        token_budget: int | None = None,
        horizon: int = 1,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        min_p: float | None = None,
        vocab_limit: int | None = None,
        inference_dtype: torch.dtype | None = None,
        dequantize: bool | str = False,
        draft_config: TransformerConfig | None = None,
        draft_dequantize: bool = False,
        num_draft: int = 4,
        paged_pages: int | None = None,
        page_size: int = 64,
        prefix_cache: bool = False,
        registry: Any | None = None,
        tracer: Any | None = None,
        slo: Any | None = None,
        recorder: Any | None = None,
        deadline_s: float | None = None,
        max_queue: int | None = None,
        degradation: Any | None = None,
        max_dispatch_strikes: int = 2,
        adapter_pool: Any | None = None,
        comm_compression: Any | None = None,
        device=None,
    ):
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_dispatch_strikes < 1:
            raise ValueError(f"max_dispatch_strikes must be >= 1, got {max_dispatch_strikes}")
        if degradation is not None and slo is None:
            raise ValueError(
                "degradation needs slo=SLOMonitor(...): the ladder is "
                "driven by the monitor's burn rate"
            )
        later = {
            "adapter_pool": (adapter_pool is not None, "tenancy (swaps and adapters)"),
            "comm_compression": (comm_compression is not None, "slice F (compression)"),
        }
        for name, (used, where) in later.items():
            if used:
                raise NotImplementedError(f"{name}: ported with {where}")
        if batch_size < 1 or refill_chunk < 1 or decode_block_steps < 1:
            raise ValueError("batch_size, refill_chunk, decode_block_steps must be >= 1")
        if decode_chain < 1:
            raise ValueError(f"decode_chain must be >= 1, got {decode_chain}")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if horizon > 1 and not mixed:
            raise ValueError(
                "horizon > 1 requires mixed=True: the multi-step scan "
                "fuses the MIXED iteration body (the split engine's "
                "decode_block already amortizes its loop on device)"
            )
        if token_budget is not None and not mixed:
            raise ValueError("token_budget requires mixed=True")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if refill_chunk > config.max_seq_len:
            raise ValueError(
                f"refill_chunk ({refill_chunk}) exceeds max_seq_len ({config.max_seq_len})"
            )
        speculative = draft_config is not None
        if speculative:
            if num_draft < 1:
                raise ValueError(f"num_draft must be >= 1, got {num_draft}")
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"target vocab {config.vocab_size} != draft vocab "
                    f"{draft_config.vocab_size}"
                )
        if draft_dequantize and not speculative:
            raise ValueError("draft_dequantize requires draft_config")
        if vocab_limit is not None and vocab_limit < 1:
            raise ValueError(f"vocab_limit must be >= 1, got {vocab_limit}")
        if mesh is not None:
            if rules is None:
                raise ValueError("rules are required when a mesh is given")
            device = mesh.device_type if device is None else device
        device = resolve_device(device)
        paged = paged_pages is not None
        if prefix_cache and not paged:
            raise ValueError(
                "prefix_cache requires the paged KV cache (paged_pages=N): "
                "sharing is expressed through block-table entries"
            )

        def check_paged(name, c):
            # The paged preconditions, for the target and the draft: their
            # caches page side by side through one block table.
            if resolve_decode_backend(c.decode_attention, device) != "blocked":
                raise ValueError(
                    f"paged_pages requires the blocked decode backend for the {name} "
                    "config (decode_attention='blocked', or 'auto' on a GPU)"
                )
            if c.max_seq_len % page_size:
                raise ValueError(
                    f"{name} max_seq_len ({c.max_seq_len}) must be a multiple of "
                    f"page_size ({page_size})"
                )

        def pagedify(c):
            return dataclasses.replace(c, decode_paged=True, decode_page_count=paged_pages,
                                       decode_block_k=page_size)

        if paged:
            if paged_pages < 2:
                raise ValueError("paged_pages must be >= 2 (page 0 is the scratch page)")
            check_paged("target", config)
        cfg = dataclasses.replace(derive_decode_config(config, inference_dtype),
                                  decode_ragged=True)
        cfg, fused = apply_dequantize_policy(cfg, dequantize, mesh, rules)
        if paged:
            cfg = pagedify(cfg)
        self._mesh, self._rules = mesh, rules
        self._model = Transformer(cfg, device=device).eval()
        # A non-fused dequantize mode dequantizes inside each model call on
        # one device, and once a cast over a mesh (``_load``).
        self._dequant = bool(dequantize) and not fused
        self._apply = make_cached_apply(self._model, dequantize=self._dequant and mesh is None,
                                        dequant_dtype=cfg.param_dtype)
        self._maybe_cast = make_param_caster(inference_dtype, device,
                                             dequantize=bool(dequantize))
        d_cfg = None
        if speculative:
            if paged:
                check_paged("draft", draft_config)
                if draft_config.max_seq_len != config.max_seq_len:
                    raise ValueError(
                        f"draft max_seq_len ({draft_config.max_seq_len}) must equal the "
                        f"target's ({config.max_seq_len}) under paged_pages: both caches "
                        "page through one block table"
                    )
            d_cfg = dataclasses.replace(derive_decode_config(draft_config, inference_dtype),
                                        decode_ragged=True)
            if paged:
                d_cfg = pagedify(d_cfg)
            # A quantized draft is dequantized inside each draft call (once a
            # cast over a mesh): the non-fused policy, as a draft is small.
            self._d_model = Transformer(d_cfg, device=device).eval()
            self._d_dequant = bool(draft_dequantize)
            self._d_apply = make_cached_apply(self._d_model,
                                              dequantize=self._d_dequant and mesh is None,
                                              dequant_dtype=d_cfg.param_dtype)
            self._d_cast = make_param_caster(inference_dtype, device,
                                             dequantize=bool(draft_dequantize))

        self._device = device
        self._cfg, self._d_cfg = cfg, d_cfg
        self._b = batch_size
        self._max_new = max_new_tokens
        self._eos = eos_id
        self._temperature = temperature
        self._filters = (top_k, top_p, min_p, vocab_limit)
        self._vocab_limit = vocab_limit
        self._refill_chunk = refill_chunk
        self._block_steps = decode_block_steps
        self.decode_chain = decode_chain       # public, read at each dispatch
        self._mixed = bool(mixed)
        # Public like decode_chain: the mixed scheduler's per-dispatch token
        # ceiling (decode rows funded first, refill takes the rest).
        self.token_budget = token_budget if token_budget is not None else (
            refill_chunk + batch_size)
        # Public: the fused links one dispatch plans and runs (1: the link
        # loop under decode_chain).
        self.horizon = horizon
        self._num_draft = num_draft
        self._speculative = speculative
        # The recovery policies: request TTLs, admission control, the
        # burn-rate degradation ladder and poison quarantine.
        self._deadline_s = deadline_s
        self._any_req_deadline = False
        self._max_queue = max_queue
        self._ladder = degradation
        self._level = 0                        # the ladder level applied
        self._max_strikes = max_dispatch_strikes
        self._spec_disabled = False
        self._shed_all = False
        self._base_budget: int | None = None
        # Over a mesh of more than one rank: the mesh the host decisions are
        # agreed over, and the rank that takes the clock-driven ones.
        self._agree_mesh = mesh if mesh is not None and mesh.size() > 1 else None
        self._src = None if self._agree_mesh is None else int(mesh.mesh.flatten()[0])
        self._seam_fault: BaseException | None = None  # the fault the seam raised
        self._paged = paged
        self._paged_pages = paged_pages
        self._page_size = page_size
        self._prefix = prefix_cache

        self.rng = prng.key(0, device)         # the sampling key (serve() re-keys)
        self.cache_creations = 0               # lifetime count of cache creations
        self.model_forwards = 0                # lifetime count of target model calls
        self.draft_forwards = 0                # lifetime count of draft model calls
        self.last_stats: dict | None = None
        self.last_latency: dict | None = None
        self._cache: DecodeCache | None = None
        self._d_cache: DecodeCache | None = None
        self._queue: deque[_Request] = deque()
        self._finished: dict[int, _Request] = {}
        self._next_rid = 0
        self._n_added = 0                      # add_request calls: each request's seq
        self._n_admits = 0                     # admission passes
        self._cast_src: tuple | None = None
        self._cast_key: list | None = None
        self._cast_out: tuple | None = None
        # The planner's staged next-horizon plan: (fingerprint, plan), taken
        # by the next horizon dispatch only when the boundary state matches.
        self._staged_plan = None
        self._link_out: list[torch.Tensor] = []    # queued link outputs, read at the sync
        # Weight swaps: ``weights_version`` is pinned on every request at
        # admission and logged at retirement (``finished_versions``, rid →
        # version); a staged swap waits for its commit, after which the
        # committed (weights, draft weights) serve whatever params a caller
        # passes.
        self.weights_version = 0
        self.finished_versions: dict[int, int] = {}
        self._staged_swap: dict | None = None
        self._installed: tuple | None = None
        self._swap_plan_cache: dict = {}       # host transfer plans of swaps
        # The KV tier: ``prefix_epoch`` bumps on every change of the prefix
        # registry's keys (register, evict, spill, fill, flush), so a digest
        # is valid while its epoch matches; the router's predicted and the
        # realized prefix hit of each admission, by request id.
        self.prefix_epoch = 0
        self._digest_cache: tuple | None = None
        self.expected_prefix: dict[int, int] = {}
        self.prefix_realized: dict[int, int] = {}
        self._page_plan_cache: dict = {}       # spill and fill plans
        self._init_telemetry(registry, tracer, slo, recorder)
        self._init_slots()
        if paged:
            self._init_pool()
        self.reset_stats()

    # --- state initialisation --------------------------------------------

    def _init_telemetry(self, registry, tracer, slo, recorder):
        # Engine-local by default; a shared registry aggregates engines (and
        # then the window-derived last_stats include the others' counts).
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        # The flight recorder defaults to the process's ring; span closures
        # ride it beside the lifecycle events.
        self.recorder = recorder if recorder is not None else default_flight_recorder()
        self.recorder.attach_tracer(self.tracer)
        self.slo = slo
        if slo is not None:
            if slo.registry is None:
                slo.registry = self.registry
            if slo.recorder is None:
                slo.recorder = self.recorder
        # The JAX engine's metrics, names and help texts alike (those of
        # parts not ported yet stay at zero), so a snapshot or a scrape reads
        # the same series.
        r = self.registry
        c = r.counter
        self._c_requests = c("engine_requests_total", "requests enqueued")
        self._c_finished = c("engine_requests_finished_total", "requests retired")
        self._c_tokens = c("engine_tokens_generated_total", "generated tokens emitted")
        self._c_preempt = c("engine_preemptions_total",
                            "recompute preemptions under page-pool pressure")
        self._c_pfx_hits = c("engine_prefix_hits_total",
                             "admissions that reused retained prefix pages")
        self._c_pfx_pages = c("engine_prefix_pages_reused_total",
                              "prefix pages mapped on admission")
        self._c_spec_acc = c("engine_spec_accepted_total", "draft tokens accepted by the verifier")
        self._c_spec_prop = c("engine_spec_proposed_total", "draft tokens proposed")
        self._c_refill_s = c("engine_refill_seconds_total",
                             "host-observed refill dispatch+sync seconds")
        self._c_decode_s = c("engine_decode_seconds_total",
                             "host-observed decode dispatch+sync seconds")
        self._c_refill_n = c("engine_refill_dispatches_total", "refill dispatches")
        self._c_decode_n = c("engine_decode_dispatches_total", "decode dispatches")
        self._c_mixed_s = c("engine_mixed_seconds_total",
                            "host-observed fused refill+decode dispatch+sync seconds")
        self._c_mixed_n = c("engine_mixed_dispatches_total", "fused refill+decode dispatches")
        self._c_stall_s = c("engine_decode_stall_seconds_total",
                            "dispatch seconds during which decoding rows sat idle "
                            "behind another slot's refill")
        self._c_multi_n = c("engine_multi_dispatches_total",
                            "fused multi-step dispatches (horizon > 1 — one scanned "
                            "program advancing N engine iterations)")
        self._c_multi_links = c("engine_multi_links_total",
                                "engine iterations advanced inside multi-step dispatches "
                                "(steps_per_dispatch = links / dispatches)")
        self._c_plan_staged = c("engine_plan_staged_total",
                                "next-horizon refill plans staged by the async planner "
                                "while a multi-step program was in flight")
        self._c_plan_reused = c("engine_plan_reused_total",
                                "staged plans consumed at the next horizon boundary (the "
                                "boundary state matched the planner's prediction)")
        self._c_creations = c("engine_cache_creations_total", "cache-creating first refills")
        self._c_shed = c("engine_shed_total",
                         "arrivals rejected by admission control (bounded queue or "
                         "degradation-ladder shedding)")
        self._c_deadline = c("engine_deadline_evictions_total",
                             "requests failed by their TTL deadline (queued or in-flight)")
        self._c_quarantined = c("engine_quarantined_total",
                                "requests failed as poison after repeated dispatch faults")
        self._c_dispatch_faults = c("engine_dispatch_faults_total",
                                    "dispatches aborted by a recoverable fault")
        self._c_req_failed = c("engine_requests_failed_total",
                               "requests retired with a non-ok terminal status")
        self._c_rerouted = c("engine_rerouted_total",
                             "requests drained with status 'rerouted' — failover/handoff "
                             "requeue onto another fleet replica, never a lost request")
        for name, help_text in _LATER_COUNTERS:
            c(name, help_text)
        g = r.get
        self._c_kv_exports = g("engine_kv_exports_total")
        self._c_kv_ingests = g("engine_kv_ingests_total")
        self._c_pg_spills = g("engine_kv_page_spills_total")
        self._c_pg_fills = g("engine_kv_page_fills_total")
        self._c_pg_bytes_out = g("engine_kv_page_spill_bytes_total")
        self._c_pg_bytes_in = g("engine_kv_page_fill_bytes_total")
        self._c_kv_raw_bytes = g("engine_kv_raw_bytes_total")
        self._c_pfx_expected = g("engine_prefix_expected_total")
        self._c_tier_miss = g("engine_tier_misses_total")
        self._c_swap_staged = g("engine_swap_staged_total")
        self._c_swap_commits = g("engine_swap_commits_total")
        self._c_swap_aborted = g("engine_swap_aborted_total")
        self._c_swap_bytes = g("engine_swap_bytes_total")
        self._g_degraded = r.gauge("engine_degradation_level",
                                   "current graceful-degradation ladder level (0 = normal)")
        self._g_queue = r.gauge("engine_queue_depth", "requests waiting for a slot")
        self._g_active = r.gauge("engine_active_slots", "slots actively decoding")
        self._g_pages = r.gauge("engine_pages_live", "live (non-retained) pages held")
        self._g_retained = r.gauge("engine_prefix_pages_retained",
                                   "reference-free retained prefix pages")
        r.gauge("engine_comm_compression_active",
                "1 while quantized serving collectives are compiled in").set(0)
        self._g_comp_ratio = r.gauge(
            "engine_kv_compression_ratio",
            "raw/wire byte ratio of the most recent counted KV transfer batch (1.0 when "
            "no codec is attached)")
        self._g_comp_ratio.set(1.0)
        h = r.histogram
        self._h_ttft = h("engine_ttft_seconds", "arrival to first visible token")
        self._h_tpot = h("engine_tpot_seconds", "per-request mean inter-token seconds")
        self._h_itl = h("engine_itl_seconds", "raw host-visibility gaps")
        self._h_wait = h("engine_queue_wait_seconds", "arrival to slot admission")
        self._h_e2e = h("engine_e2e_seconds", "arrival to retirement")
        self._h_swap_stall = h("engine_swap_stall_seconds",
                               "stage-to-commit latency of weight swaps (drain or preempt)")
        # The goodput ledger: step() is the top-level frame ("sched"), the
        # regions inside claim their buckets, idle is derived.
        self.ledger = GoodputLedger(registry=r)
        # Request-scoped trace sink (a telemetry.TraceStore), attached by
        # the caller: legs are recorded at retirement.
        self.trace_sink = None
        self.trace_replica = "engine"

    @contextlib.contextmanager
    def _led_device(self, family: str):
        """Ledger frame for a dispatch's launches or the host read that waits
        for them: ``device``, tagged with the program ``family``, unless a
        kernel library was built or loaded inside the frame
        (``ops/_build.py``'s count grew): then the frame paid for a build or
        a load, not device work, and books ``compile``. A launch only queues
        work, so a dispatch's device seconds land in the frame of its
        read."""
        before = _build.loads
        with self.ledger.measure("device", family=family) as f:
            yield f
            if _build.loads > before:
                f.rebucket("compile")

    def _win_delta(self, counter) -> float:
        # The stats window (reset_stats → snapshot) over a cumulative
        # counter: its value minus its base at the last reset.
        return counter.value - self._win_base.get(counter.name, 0.0)

    def _init_slots(self):
        b = self._b
        # A slot is idle (req < 0), refilling (pending prompt tokens
        # remain), or decoding (active).
        self._req = [-1] * b               # request id per slot
        self._plen = [0] * b               # admitted prompt length per slot
        self._pending: list[np.ndarray] = [np.zeros((0,), np.int32)] * b
        self._emitted = [0] * b
        self._out: list[list[int]] = [[] for _ in range(b)]
        self._ttimes: list[list[float]] = [[] for _ in range(b)]
        self._slot_req: list[_Request | None] = [None] * b
        self._tok = np.zeros((b,), np.int32)
        self._active = np.zeros((b,), bool)
        # Admission resets are consumed by the first refill dispatch that
        # runs, so a raise between admission and dispatch (pool exhaustion)
        # cannot lose a row's counter reset.
        self._needs_reset = np.zeros((b,), bool)
        self._reset_to = np.zeros((b,), np.int32)
        # Retired request → its slot while the slot's KV row is intact (the
        # export window of the handoff); an entry goes when the slot is
        # reused.
        self._export_ok: dict[int, int] = {}

    def _init_pool(self):
        # Host-owned page allocator: page 0 is scratch; a slot holds a
        # prefix of logical blocks mapped to arbitrary physical pages.
        b = self._b
        self._free_pages = list(range(self._paged_pages - 1, 0, -1))
        self._held: list[list[int]] = [[] for _ in range(b)]
        t_cap = self._cfg.max_seq_len // self._page_size
        self._table_np = np.zeros((b, t_cap), np.int32)
        self._tables_dirty = True
        # Prefix cache: page-aligned token-prefix bytes → the page holding
        # that prefix's last page of K/V; refcounts of pages shared by live
        # slots; reference-free registered pages in LRU order (dict order).
        self._prefix_registry: dict[bytes, int] = {}
        self._key_of_page: dict[int, bytes] = {}
        self._refcnt: dict[int, int] = {}
        self._cached_lru: dict[int, None] = {}
        self._shared_count = [0] * b   # leading registry pages per slot
        self.prefix_epoch += 1         # any earlier digest is stale
        self._g_pages.set(0)
        self._g_retained.set(0)

    def reset_stats(self):
        """Start a stats window (``serve()`` calls this at entry; streaming
        users call it to start a measurement window). The registry's
        counters are cumulative and never zeroed: the window is a base
        snapshot that ``last_stats`` and ``latency_stats`` subtract."""
        self._completed: list[dict] = []
        self._itl: list[float] = []
        self._win_base = {
            c.name: c.value
            for c in (
                self._c_preempt, self._c_pfx_hits, self._c_pfx_pages,
                self._c_spec_acc, self._c_spec_prop, self._c_refill_s,
                self._c_decode_s, self._c_mixed_s, self._c_stall_s,
                self._c_refill_n, self._c_decode_n, self._c_mixed_n,
                self._c_multi_n, self._c_multi_links,
                self._c_plan_staged, self._c_plan_reused,
                self._c_requests, self._c_finished, self._c_shed,
                self._c_deadline, self._c_req_failed, self._c_rerouted,
                self._c_pfx_expected, self._c_tier_miss,
            )
        }
        # The page gauge's window high-water (its live value rides on).
        self._g_pages.reset_high_water()
        self.ledger.begin_window()

    def reset(self):
        """Abandon all in-flight work and return the engine to idle. Frees
        every page, the prefix registry included, and clears the queue and
        slots; keeps the model and the cache (admission resets its
        counters)."""
        self._queue.clear()
        self._init_slots()
        if self._paged:
            self._init_pool()

    def close(self):
        """Shut the engine down to idle: every in-flight or queued request
        retires with status ``"shutdown"`` (a :class:`RequestFailure` with
        any partial tokens, through ``pop_finished``), then the cache, page
        pool and prefix registry are dropped. The engine stays usable: the
        next dispatch creates the cache again (``cache_creations`` counts
        it)."""
        self.drain_requests(status="shutdown", error="engine closed")
        self._cache = self._d_cache = None
        self._cast_src = self._cast_key = self._cast_out = None
        self._export_ok = {}
        if self._paged:
            self._init_pool()
        self.recorder.record("engine.close")

    def drain_requests(self, *, status: str = "rerouted", error: str | None = None) -> list[dict]:
        """Retire EVERY queued and in-flight request with the terminal
        ``status`` (through ``pop_finished``; the default ``"rerouted"``, a
        failover drain, counts into ``engine_rerouted_total`` and
        ``latency_stats()["rerouted"]``) and return records to requeue them
        elsewhere, ``{rid, prompt, deadline_s, arrival_t}``, slots first,
        then the queue. A drained request recomputes exactly on whatever
        engine admits it again: greedy decoding is deterministic and every
        draw is keyed by (request id, generated position). The device state
        needs no repair (admission resets the per-row counters)."""
        now = time.perf_counter()
        records: list[dict] = []

        def rec(r):
            records.append(dict(rid=r.rid, prompt=r.prompt, deadline_s=r.deadline_s,
                                arrival_t=r.arrival_t))

        for slot in range(self._b):
            if self._slot_req[slot] is not None:
                rec(self._slot_req[slot])
                self._fail_slot(slot, status, error, now)
        while self._queue:
            r = self._queue.popleft()
            rec(r)
            self._fail_request(r, status, error, now=now)
        self._g_queue.set(0)
        self._g_active.set(0)
        self.recorder.record("engine.drain", status=status, n=len(records))
        return records

    def flush_prefix_cache(self):
        """Drop every retained prefix page: call between checkpoints, since
        the registry keys pages by token bytes only. Requires an idle
        engine."""
        if not self._paged:
            return
        if self.has_work():
            raise RuntimeError(
                "flush_prefix_cache() requires an idle engine: drain "
                "in-flight work first (params must not change mid-request)"
            )
        self._drop_prefix_registry()

    def _drop_prefix_registry(self):
        # flush_prefix_cache without its idle guard: a swap's commit calls
        # it with empty slots (every retained page is reference-free then;
        # queued requests admit after the commit, under the new weights).
        for pid in list(self._cached_lru):
            del self._cached_lru[pid]
            del self._prefix_registry[self._key_of_page.pop(pid)]
            del self._refcnt[pid]
            self._free_pages.append(pid)
        self.prefix_epoch += 1         # every exported digest is stale
        self._update_high_water()

    # --- page allocator ----------------------------------------------------

    def _take_page(self) -> int:
        # Chaos seam: kind="oom" raises this allocator's own RuntimeError,
        # driving the recompute-preemption path.
        chaos_hook("engine.page_alloc", free=len(self._free_pages))
        if self._free_pages:
            return self._free_pages.pop()
        if self._cached_lru:
            # Evict the oldest reference-free cached page: the pool serves
            # live requests before retained ones.
            pid = next(iter(self._cached_lru))
            del self._cached_lru[pid]
            del self._prefix_registry[self._key_of_page.pop(pid)]
            del self._refcnt[pid]
            self.prefix_epoch += 1
            return pid
        raise RuntimeError(
            f"page pool exhausted ({self._paged_pages - 1} pages "
            f"× {self._page_size} tokens): raise paged_pages or "
            "lower concurrency"
        )

    def _live_pages(self) -> int:
        # Live pages only: retained reference-free prefix pages are
        # reclaimable at will and reported apart (prefix_pages_retained).
        return (self._paged_pages - 1) - len(self._free_pages) - len(self._cached_lru)

    def _update_high_water(self):
        # The gauge carries the live value (export) and the window maximum
        # (last_stats["page_high_water"]).
        self._g_pages.set(self._live_pages())
        self._g_retained.set(len(self._cached_lru))

    def _ensure(self, slot: int, tokens_through: int):
        # Map positions [0, tokens_through) before the dispatch that writes
        # them.
        need = -(-int(tokens_through) // self._page_size)
        if len(self._held[slot]) >= need:
            return   # steady-state decode mostly allocates nothing
        with self.ledger.measure("page_alloc"):
            while len(self._held[slot]) < need:
                p = self._take_page()
                self._table_np[slot, len(self._held[slot])] = p
                self._held[slot].append(p)
                self._tables_dirty = True
            self._update_high_water()

    def _release(self, slot: int, register: bool = True):
        # ``register=False``: the slot is being un-admitted or failed, so its
        # prompt pages may be only partly written: never register them; free
        # the private pages and drop the shared references.
        pages, ns = self._held[slot], self._shared_count[slot] if self._prefix else 0
        if self._prefix:
            if register:
                # Private pages fully inside the prompt are immutable once
                # written: RETAIN them under their token-prefix key, deepest
                # first into the LRU (admission chains break at the first
                # missing page, so eviction must take chain tails before
                # their roots); free the rest.
                p_toks = np.asarray(self._out[slot][: self._plen[slot]], np.int32)
                full = self._plen[slot] // self._page_size
                for j in range(len(pages) - 1, ns - 1, -1):
                    pid = pages[j]
                    if j < full:
                        key = p_toks[: (j + 1) * self._page_size].tobytes()
                        if key not in self._prefix_registry:
                            self._prefix_registry[key] = pid
                            self._key_of_page[pid] = key
                            self._refcnt[pid] = 0
                            self._cached_lru[pid] = None
                            self.prefix_epoch += 1
                            continue
                    self._free_pages.append(pid)
            else:
                self._free_pages.extend(pages[ns:])
            for pid in reversed(pages[:ns]):   # drop shared refs, tails first
                self._refcnt[pid] -= 1
                if self._refcnt[pid] == 0:
                    self._cached_lru[pid] = None
            if register:
                # Touch this prompt's whole chain deepest-first, so every
                # ancestor is newer in the LRU than its deepest tail, across
                # retirements too.
                for k in range(full, 0, -1):
                    pid = self._prefix_registry.get(p_toks[: k * self._page_size].tobytes())
                    if pid is not None and pid in self._cached_lru:
                        del self._cached_lru[pid]
                        self._cached_lru[pid] = None
            self._shared_count[slot] = 0
        else:
            self._free_pages.extend(pages)
        self._held[slot] = []
        self._table_np[slot, :] = 0
        self._tables_dirty = True
        self._update_high_water()

    def _set_tables(self):
        # Push the host table into the caches' one block table (the draft's
        # cache shares it), only when an allocation or release changed it
        # since the last push.
        if not self._tables_dirty:
            return
        self._tables_dirty = False
        self._cache.block_table.copy_(self._to_device(self._table_np), non_blocking=True)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A COPY of a host array on the engine's device: later host updates
        of ``arr`` never reach a dispatch already queued. On a GPU through a
        pinned buffer without blocking the host."""
        t = torch.from_numpy(np.array(arr))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    # --- request lifecycle -------------------------------------------------

    def _validate_prompt(self, p: np.ndarray):
        if p.size < 1:
            raise ValueError("empty prompt")
        headroom = self._num_draft + 1 if self._speculative else 0
        budget_cfgs = [("target", self._cfg)]
        if self._speculative:
            # The draft's index walks in lockstep with the target's through
            # refill, proposals and rollback: the same worst case.
            budget_cfgs.append(("draft", self._d_cfg))
        for name, c in budget_cfgs:
            check_sequence_budget(
                p.size + self._max_new + headroom, c.max_seq_len,
                f"prompt ({p.size}) + max_new_tokens ({self._max_new})"
                + (f" + draft headroom ({headroom})" if headroom else "")
                + f" for {name}",
            )

    def _check_draft_args(self, draft_params):
        if self._speculative and draft_params is None:
            raise ValueError("draft_config was given: pass draft_params to serve()/step()")
        if not self._speculative and draft_params is not None:
            raise ValueError("draft_params requires draft_config")

    def _cast_params(self, params, draft_params=None):
        # The inference casts (and the loads into the models) run once per
        # (params, draft_params) pair and tensor state, not once per step;
        # a dequantize-per-call mode keeps its cast tree and hands it to
        # every model call. Torch updates parameters in place, and a
        # state_dict() aliases them, so the same dict can hold new weights:
        # each tensor's identity and in-place version counter key the cast
        # (host reads only, no device work).
        trees = (params,) if draft_params is None else (params, draft_params)
        key = [(t, _tensor_state(t)) for tree in trees for t in tree.values()]
        if (self._cast_src is not None and self._cast_src[0] is params
                and self._cast_src[1] is draft_params and _same_tensors(key, self._cast_key)):
            return self._cast_out
        weights = self._load(self._model, self._maybe_cast(params), self._dequant, self._cfg)
        d_weights = None
        if draft_params is not None:
            d_weights = self._load(self._d_model, self._d_cast(draft_params), self._d_dequant,
                                   self._d_cfg)
        self._cast_src, self._cast_key = (params, draft_params), key
        self._cast_out = (weights, d_weights)
        return self._cast_out

    def _load(self, model, weights, dequant, cfg):
        """Load cast ``weights`` into ``model`` → None. A tree of a non-fused
        dequantize mode (``dequant``) is, on one device, not loaded but
        returned: the tree every model call takes and dequantizes; over a
        mesh it is dequantized once here, so the mesh engine holds the
        full-precision weights. Over a mesh the weights are laid out by their
        logical axes."""
        if self._mesh is None:
            if dequant:
                return weights
            model.load_state_dict(weights)
        else:
            if dequant:
                weights = dequantize_tree(weights, cfg.param_dtype)
            shard_params(model, self._mesh, self._rules, weights)
        return None

    def add_request(self, prompt, *, rid: int | None = None, arrival_t: float | None = None,
                    deadline_s: float | None = None, adapter: str | None = None,
                    tenant: str | None = None) -> int:
        """Enqueue one request and return its id, the key ``pop_finished()``
        reports it under; admission happens in a later ``step()``.
        ``arrival_t`` (a ``time.perf_counter`` stamp) keeps an earlier
        arrival clock for the deadline and the latency telemetry, and places
        the request in the refill queue among those of its admission pass,
        as in the JAX engine. Unstamped, it is placed by the clock at this
        call on one device; over a mesh, where the clock differs by rank,
        after every stamped request of its pass, in add order.

        ``deadline_s`` overrides the engine's TTL for this request (arrival
        to retirement; past it the request retires ``"deadline"``).
        ``tenant`` labels the request's SLO observations and trace. Raises
        :class:`AdmissionError` when admission control sheds the arrival
        (queue at ``max_queue``, or the ladder shedding): nothing is
        enqueued."""
        if adapter is not None:
            raise NotImplementedError("adapter: ported with tenancy (swaps and adapters)")
        p = np.asarray(prompt, np.int32).reshape(-1)
        self._validate_prompt(p)
        if self._shed_all or (self._max_queue is not None
                              and len(self._queue) >= self._max_queue):
            self._c_shed.inc()
            why = ("degradation ladder is shedding" if self._shed_all
                   else f"queue full ({self._max_queue})")
            self.recorder.record("engine.shed", reason=why, queue_depth=len(self._queue))
            raise AdmissionError(f"request shed: {why}")
        if deadline_s is not None:
            if deadline_s <= 0:
                raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
            self._any_req_deadline = True
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            # An explicit id must be unique among everything live now, and
            # must not collide with later automatic ones.
            if (rid in self._finished or rid in self._req
                    or any(r.rid == rid for r in self._queue)):
                raise ValueError(f"request id {rid} already in use")
            self._next_rid = max(self._next_rid, rid + 1)
        now = time.perf_counter()
        order_t = arrival_t if arrival_t is not None else now if self._mesh is None else math.inf
        r = _Request(rid=rid, prompt=p, seq=self._n_added, order_t=order_t,
                     arrival_t=now if arrival_t is None else arrival_t, deadline_s=deadline_s,
                     enqueue_t=now, tenant=tenant)
        self._queue.append(r)
        self._n_added += 1
        self._c_requests.inc()
        self._g_queue.set(len(self._queue))
        if self.trace_sink is not None:
            self.trace_sink.mint(rid, arrival_t=r.arrival_t, tenant=tenant)
        self.tracer.instant("request.arrival", rid=rid, prompt_len=int(p.size))
        self.recorder.record("engine.arrival", rid=rid, prompt_len=int(p.size),
                             queue_depth=len(self._queue))
        return rid

    def has_work(self) -> bool:
        # A staged swap is work: one more step() commits it.
        return (bool(self._queue) or any(r >= 0 for r in self._req)
                or self._staged_swap is not None)

    @property
    def swap_pending(self) -> bool:
        """Whether a staged weight swap waits for its commit (staging another
        raises meanwhile)."""
        return self._staged_swap is not None

    def queue_depth(self) -> int:
        """Requests waiting for a slot."""
        return len(self._queue)

    def active_slots(self) -> int:
        """Slots actively decoding right now."""
        return int(self._active.sum())

    def occupied_slots(self) -> int:
        """Slots holding a request, decoding or mid-prefill."""
        return sum(1 for r in self._req if r >= 0)

    def free_slots(self) -> int:
        """Idle slots available for admission."""
        return sum(1 for r in self._req if r < 0)

    def pop_finished(self) -> dict[int, Any]:
        """Every request retired since the last pop: completed ones map to
        their ``[prompt, generated...]`` tokens, failed ones to a
        :class:`RequestFailure`."""
        fin = {
            rid: (r.tokens if r.status == "ok"
                  else RequestFailure(rid=rid, status=r.status, error=r.error, tokens=r.tokens))
            for rid, r in self._finished.items()
        }
        self._finished = {}
        return fin

    def _retire(self, slot: int, now: float, retired: list[int]):
        r = self._slot_req[slot]
        r.tokens = np.asarray(self._out[slot], np.int32)
        r.finish_t = now
        n = self._emitted[slot]
        times = self._ttimes[slot]
        gaps = [b - a for a, b in zip(times, times[1:])]
        self._itl.extend(gaps)
        rec = dict(
            rid=r.rid, prompt_len=int(r.prompt.size), generated=n,
            queue_wait=r.admit_t - r.arrival_t,
            ttft=r.first_token_t - r.arrival_t if r.first_token_t is not None else None,
            e2e=now - r.arrival_t,
            tpot=(now - r.first_token_t) / (n - 1) if n > 1 else None,
        )
        self._completed.append(rec)
        # The export histograms carry the same observations (the exact
        # percentiles of latency_stats stay sample-based); all of this
        # booking is the observability tax, the ledger's telemetry bucket.
        with self.ledger.measure("telemetry"):
            for g in gaps:
                self._h_itl.observe(g)
            self._c_finished.inc()
            self._c_tokens.inc(n)
            self._h_wait.observe(rec["queue_wait"])
            self._h_e2e.observe(rec["e2e"])
            if rec["ttft"] is not None:
                self._h_ttft.observe(rec["ttft"])
            if rec["tpot"] is not None:
                self._h_tpot.observe(rec["tpot"])
            self.tracer.async_end("request", r.rid, generated=n)
            self.recorder.record("engine.retire", rid=r.rid, slot=slot, generated=n,
                                 ttft=rec["ttft"], e2e=rec["e2e"], version=r.version)
            if self.slo is not None:
                ten = r.tenant
                self.slo.observe("queue_wait", rec["queue_wait"], tenant=ten)
                self.slo.observe("e2e", rec["e2e"], tenant=ten)
                if rec["ttft"] is not None:
                    self.slo.observe("ttft", rec["ttft"], tenant=ten)
                if rec["tpot"] is not None:
                    self.slo.observe("tpot", rec["tpot"], tenant=ten)
                for g in gaps:
                    self.slo.observe("itl", g, tenant=ten)
            if self.trace_sink is not None:
                self._record_trace_legs(r, now, generated=n)
                if self.trace_sink.auto_complete:
                    self.trace_sink.complete(r.rid, status="ok", finish_t=now)
        self._finished[r.rid] = r
        # Every response is attributable to the one weights version pinned
        # at its (last) admission.
        self.finished_versions[r.rid] = r.version
        retired.append(r.rid)
        # The export window opens: the row's KV stays intact until a later
        # admission reuses the slot.
        self._export_ok[r.rid] = slot
        self._free_slot(slot)
        if self._paged:
            self._release(slot)

    def _record_trace_legs(self, r: _Request, now: float, *, generated=0, wasted=False,
                           status="ok"):
        """Append this engine's legs of ``r``'s journey to the trace sink,
        from the request's own stamps: queue from its enqueue to its
        admission, prefill to its first token, decode to ``now``, each
        with the weights version it ran under. ``wasted`` marks compute a
        drain throws away (it is recomputed elsewhere). An ingested request
        has a decode leg only: its queue and prefill ran on another
        engine."""
        ts, rep, v = self.trace_sink, self.trace_replica, r.version
        q0 = r.enqueue_t if r.enqueue_t is not None else r.arrival_t
        if r.admit_t is None:
            # Never admitted: all wait.
            ts.leg(r.rid, "queue", q0, now, replica=rep, status=status)
            return
        if r.ingested:
            ts.leg(r.rid, "decode", q0, now, replica=rep, generated=generated, version=v,
                   wasted=wasted, status=status)
            return
        ts.leg(r.rid, "queue", q0, r.admit_t, replica=rep)
        ft = r.first_token_t
        if ft is None:
            # Retired mid-prefill.
            ts.leg(r.rid, "prefill", r.admit_t, now, replica=rep, version=v, wasted=wasted,
                   status=status)
            return
        ts.leg(r.rid, "prefill", r.admit_t, ft, replica=rep, first_token_t=ft, version=v,
               wasted=wasted)
        if now > ft:
            ts.leg(r.rid, "decode", ft, now, replica=rep, generated=generated, version=v,
                   wasted=wasted, status=status)

    def _free_slot(self, slot: int):
        self._slot_req[slot] = None
        self._req[slot] = -1
        self._active[slot] = False

    def _fail_request(self, r: _Request, status: str, error: str, *, now=None, tokens=None):
        """Retire ``r`` with a terminal non-ok status, surfaced through
        ``pop_finished`` as a :class:`RequestFailure`: the recovery
        policies' one exit (deadline, quarantine, malformed, shutdown)."""
        now = time.perf_counter() if now is None else now
        r.status, r.error = status, error
        r.finish_t = now
        if tokens is not None:
            r.tokens = tokens
        with self.ledger.measure("telemetry"):
            self._c_req_failed.inc()
            if status == "rerouted":
                self._c_rerouted.inc()
            self.recorder.record("engine.request_failed", rid=r.rid, status=status,
                                 error=error)
            if r.admit_t is not None:
                # Close the span async_begin opened at first admission.
                self.tracer.async_end("request", r.rid, status=status)
            if self.trace_sink is not None:
                # A reroute's compute is recomputed elsewhere: wasted legs.
                self._record_trace_legs(r, now, wasted=status == "rerouted", status=status)
                if self.trace_sink.auto_complete and status != "rerouted":
                    self.trace_sink.complete(r.rid, status=status, finish_t=now)
        self._finished[r.rid] = r
        self.finished_versions[r.rid] = r.version

    def _fail_slot(self, slot: int, status: str, error: str, now=None):
        """Fail the request in ``slot`` (partial output kept) and free it;
        its pages are never registered (a deadline or poison eviction can
        land mid-prefill, with pages partly written)."""
        self._fail_request(self._slot_req[slot], status, error, now=now,
                           tokens=np.asarray(self._out[slot], np.int32))
        if self._paged:
            self._release(slot, register=False)
        self._free_slot(slot)
        self._clear_admission(slot)

    def _clear_admission(self, slot: int):
        self._pending[slot] = np.zeros((0,), np.int32)
        self._needs_reset[slot] = False
        self._reset_to[slot] = 0

    def _sweep_deadlines(self):
        """TTL eviction: fail every queued or in-flight request older than its
        deadline (its own ``deadline_s``, else the engine's). Skipped at once
        when no deadline is set anywhere. Over a mesh the first rank reads
        its clock and broadcasts which requests expired."""
        if self._deadline_s is None and not self._any_req_deadline:
            return
        if self._deadline_s is None:
            # Only per-request deadlines: re-arm the skip once none is live.
            if not any(r.deadline_s is not None for r in self._queue) and not any(
                    r is not None and r.deadline_s is not None for r in self._slot_req):
                self._any_req_deadline = False
                return
        with self.ledger.measure("admission"):
            now = time.perf_counter()

            def expired(r):
                dl = r.deadline_s if r.deadline_s is not None else self._deadline_s
                return dl is not None and now - r.arrival_t > dl

            # Queued requests in queue order, then the slots.
            flags = np.asarray([expired(r) for r in self._queue]
                               + [r is not None and expired(r) for r in self._slot_req], bool)
            flags = self._agree(flags.astype(np.int64)).astype(bool)
            queued = flags[: len(self._queue)]
            if queued.any():
                keep = deque()
                for r, gone in zip(self._queue, queued):
                    if gone:
                        self._c_deadline.inc()
                        self._fail_request(r, "deadline", "deadline exceeded in queue", now=now)
                    else:
                        keep.append(r)
                self._queue = keep
                self._g_queue.set(len(self._queue))
            for slot, gone in enumerate(flags[len(queued):]):
                if gone:
                    self._c_deadline.inc()
                    self._fail_slot(slot, "deadline", "deadline exceeded in flight", now)

    def _dispatch_seam(self, phase: str):
        """The chaos seam before a dispatch's work, booked ``recovery`` (an
        injected delay is never device time). While an injector is
        installed, a recoverable fault raised here on any rank of a mesh is
        raised on every rank (a MAX reduction of the flag), before anything
        of the dispatch ran; without one the seam costs no collective."""
        with self.ledger.measure("recovery"):
            err = None
            try:
                chaos_hook("engine.dispatch", phase=phase, rids=[r for r in self._req if r >= 0])
            except _RECOVERABLE_DISPATCH as e:
                err = e
            if (self._agree_mesh is not None and chaos_active()
                    and self._any_rank(err is not None) and err is None):
                err = InjectedFault("engine.dispatch", "remote",
                                    "dispatch fault on another rank of the mesh")
            if err is not None:
                self._seam_fault = err
                raise err

    def _on_dispatch_fault(self, e: BaseException):
        """A dispatch raised a recoverable fault. Every request in a slot
        earns a strike; one at ``max_dispatch_strikes`` retires
        ``"poisoned"``, the rest are requeued (recompute preemption, exact:
        see ``_unadmit``) and readmitted one at a time (probation, see
        ``_pop_admittable``). The device state needs no repair: admission
        resets every per-row counter."""
        with self.ledger.measure("recovery"):
            self._c_dispatch_faults.inc()
            self.recorder.record("engine.dispatch_fault", error=type(e).__name__,
                                 message=str(e), rids=[r for r in self._req if r >= 0])
            now = time.perf_counter()
            for slot in range(self._b):
                r = self._slot_req[slot]
                if r is None:
                    continue
                r.strikes += 1
                if r.strikes >= self._max_strikes:
                    self._c_quarantined.inc()
                    self.recorder.record("engine.quarantine", rid=r.rid, strikes=r.strikes)
                    self._fail_slot(slot, "poisoned", str(e), now)
                else:
                    self._unadmit(slot)

    def _consume(self, slot: int, tokens, now: float, retired: list[int]):
        # Append a decode dispatch's tokens for one slot; retire at EOS or at
        # the budget.
        for t in tokens:
            self._out[slot].append(int(t))
            self._emitted[slot] += 1
            self._tok[slot] = int(t)
            self._ttimes[slot].append(now)
            if (self._eos is not None and t == self._eos) or self._emitted[slot] >= self._max_new:
                self._retire(slot, now, retired)
                break

    # --- the scheduler -----------------------------------------------------

    def _unadmit(self, slot: int):
        """Recompute preemption under pool pressure, or after a dispatch
        fault: push the slot's request back to the queue head and free the
        slot. The request restarts from scratch on a later admission and
        re-derives exactly the tokens it had: greedy decoding is
        deterministic, and every draw is keyed by (request id, generated
        position), never by the schedule."""
        r = self._slot_req[slot]
        self._queue.appendleft(r)
        self.tracer.instant("request.preempted", rid=r.rid, slot=slot)
        self.recorder.record("engine.preempt", rid=r.rid, slot=slot)
        if self._paged:
            self._release(slot, register=False)
        self._free_slot(slot)
        self._clear_admission(slot)

    def _admission_ok(self, p: np.ndarray) -> str | None:
        """The admission-time check of a queued prompt (it is not trusted
        between ``add_request`` and admission): a malformed prompt fails the
        request instead of wedging the slot. → the reason, or None."""
        if p.ndim != 1 or p.dtype.kind not in "iu":
            return f"malformed prompt (shape {p.shape}, dtype {p.dtype})"
        try:
            self._validate_prompt(p)
        except ValueError as e:
            return str(e)
        return None

    def _pop_admittable(self) -> _Request | None:
        """The next request to admit, with PROBATION: while a request holding
        dispatch strikes is in a slot nothing else admits, and suspects are
        readmitted one at a time into an idle engine, so a poison request
        trips its fault alone."""
        if any(r is not None and r.strikes > 0 for r in self._slot_req):
            return None             # a suspect is live: solo probation
        si = next((i for i, r in enumerate(self._queue) if r.strikes > 0), None)
        if si is None:
            return self._queue.popleft()
        if any(q >= 0 for q in self._req):
            return None             # wait for idle before the next suspect
        r = self._queue[si]
        del self._queue[si]
        return r

    def _admit(self):
        if self._staged_swap is not None:
            # A staged swap drains the engine: nothing admits until the
            # slots are empty and the commit flips the version, or an
            # admission now would pin the old version on a request that
            # outlives it. The step that commits admits under the new one.
            self._g_queue.set(len(self._queue))
            return
        with self.ledger.measure("admission"):
            now = time.perf_counter()
            self._n_admits += 1
            for slot in range(self._b):
                if self._req[slot] >= 0 or not self._queue:
                    continue
                r = self._pop_admittable()
                if r is None:
                    break
                r.prompt = np.asarray(chaos_hook("engine.admit", value=r.prompt, rid=r.rid))
                bad = self._admission_ok(r.prompt)
                if bad is not None:
                    self.recorder.record("engine.malformed", rid=r.rid, error=bad)
                    self._fail_request(r, "malformed", bad, now=now)
                    continue
                # A preempted request keeps its first admission time and
                # counts its prefix hit once.
                first_admission = r.admit_t is None
                if first_admission:
                    r.admit_t, r.admit_pass = now, self._n_admits
                    self.tracer.async_begin("request", r.rid, prompt_len=int(r.prompt.size),
                                            slot=slot)
                self.tracer.instant("request.admit", rid=r.rid, slot=slot)
                self.recorder.record("engine.admit", rid=r.rid, slot=slot,
                                     prompt_len=int(r.prompt.size),
                                     readmission=not first_admission)
                prompt = r.prompt
                # Pinned at every admission: a preempted request recomputes
                # under, and is attributed to, the version serving now.
                r.version = self.weights_version
                # The slot is reused: the row retired here is gone.
                self._export_ok = {k: v for k, v in self._export_ok.items() if v != slot}
                self._slot_req[slot] = r
                self._req[slot] = r.rid
                self._plen[slot] = prompt.size
                self._pending[slot] = prompt
                self._emitted[slot] = 0
                self._out[slot] = list(prompt)
                self._ttimes[slot] = []
                self._needs_reset[slot] = True
                self._reset_to[slot] = 0
                if self._paged and self._prefix:
                    # The longest chain of retained pages whose token prefix
                    # matches; the last prompt token is always recomputed
                    # (its logits seed generation).
                    shared = []
                    for k in range(1, (prompt.size - 1) // self._page_size + 1):
                        pid = self._prefix_registry.get(prompt[: k * self._page_size].tobytes())
                        if pid is None:
                            break
                        shared.append(pid)
                    for j, pid in enumerate(shared):
                        self._refcnt[pid] = self._refcnt.get(pid, 0) + 1
                        self._cached_lru.pop(pid, None)
                        self._table_np[slot, j] = pid
                        self._held[slot].append(pid)
                        self._tables_dirty = True
                    self._shared_count[slot] = len(shared)
                    if shared:
                        s_len = len(shared) * self._page_size
                        self._pending[slot] = prompt[s_len:]
                        self._reset_to[slot] = s_len
                        if first_admission:
                            self._c_pfx_hits.inc()
                            self._c_pfx_pages.inc(len(shared))
                        self._update_high_water()
                    if first_admission:
                        # The router's prediction (recorded under the rid
                        # before placement) against what admission found: a
                        # page evicted or spilled meanwhile re-prefills its
                        # tokens, and the shortfall is counted.
                        realized = len(shared) * self._page_size
                        self.prefix_realized[r.rid] = realized
                        exp = self.expected_prefix.pop(r.rid, None)
                        if exp is not None and exp > 0:
                            self._c_pfx_expected.inc()
                            if realized < exp:
                                self._c_tier_miss.inc()
                                self.recorder.record("engine.tier_miss", rid=r.rid,
                                                     expected=int(exp), realized=realized)
            self._g_queue.set(len(self._queue))

    # --- device programs ---------------------------------------------------

    def _scope(self):
        """The mesh and rules around model work (nothing on one device)."""
        if self._mesh is None:
            return contextlib.nullcontext()
        return activate(self._mesh, self._rules)

    def _agree(self, values: np.ndarray) -> np.ndarray:
        """``values`` as the mesh's first rank holds them, on every rank of
        the mesh: a small tensor on the engine's device broadcast along
        each axis in turn, from the rank at coordinate 0 of that axis, in
        the mesh's own groups. On one rank ``values`` itself."""
        mesh = self._agree_mesh
        if mesh is None:
            return values
        t = torch.as_tensor(np.ascontiguousarray(values), device=self._device)
        coord = mesh.get_coordinate()
        for d in range(mesh.ndim):
            if mesh.size(d) > 1:
                # After axis d, every rank at coordinate 0 on the later
                # axes holds the first rank's values.
                src = list(coord)
                src[d] = 0
                dist.broadcast(t, src=int(mesh.mesh[tuple(src)]), group=mesh.get_group(d))
        return t.cpu().numpy()

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the mesh (a MAX reduction
        along each axis in turn, in the mesh's own groups)."""
        mesh = self._agree_mesh
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self._device)
        for d in range(mesh.ndim):
            if mesh.size(d) > 1:
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(d))
        return bool(t.item())

    def _ensure_cache(self):
        if self._cache is None:
            with self._scope():
                self._cache = self._model.init_cache(self._b)
                if self._speculative:
                    self._d_cache = self._d_model.init_cache(
                        self._b, block_table=self._cache.block_table)
            self.cache_creations += 1
            self._c_creations.inc()
            self.recorder.record("engine.cache_create", n=self.cache_creations)

    def _forward(self, weights, tokens: torch.Tensor, lengths: torch.Tensor,
                 pick: torch.Tensor | None = None) -> torch.Tensor:
        """One target model call over the engine's cache → fp32 logits, whole
        on every rank: ``(B, S, V)``, or each row's ``(B, V)`` at ``pick``."""
        with self._scope():
            logits, _ = self._apply(self._cache, tokens, lengths, params=weights)
        self.model_forwards += 1
        return whole_logits(logits, pick)

    def _d_forward(self, d_weights, tokens: torch.Tensor, lengths: torch.Tensor, *,
                   read: bool = True) -> torch.Tensor | None:
        """One draft model call over the draft's cache → its fp32 logits
        whole (``read=False``: a feed whose logits nobody reads → None)."""
        with self._scope():
            logits, _ = self._d_apply(self._d_cache, tokens, lengths, params=d_weights)
        self.draft_forwards += 1
        return whole_logits(logits) if read else None

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return greedy_pick(logits, self._vocab_limit)

    def _row_keys(self, rid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Keys of (request id, generated position): a request's stream
        depends only on its identity and how far it has generated, never on
        the schedule. ``pos`` is ``(B,)`` or ``(B, J)``."""
        rid = rid.reshape(rid.shape + (1,) * (pos.ndim - 1))
        return prng.fold_in(prng.fold_in(self.rng, rid), pos)

    def _spec_keys(self, rid: torch.Tensor, pos: torch.Tensor, tag: int) -> torch.Tensor:
        """Per-request speculative streams: ``speculative._pos_key``'s
        position and tag (0 proposal, 1 acceptance, 2 residual/bonus) under
        the request-id fold, so a rolled-back position re-derives its draws."""
        return prng.fold_in(self._row_keys(rid, pos), tag)

    def _to_flogits(self, logits: torch.Tensor) -> torch.Tensor:
        return filtered_logits(logits, self._temperature, *self._filters)

    def _sample_rows(self, logits: torch.Tensor, rid: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
        """``(B, V)`` logits → ``(B,)`` int32: argmax at temperature 0, else
        one draw a row from its (request, position) key."""
        if self._temperature == 0.0:
            return self._greedy(logits)
        return prng.categorical(self._row_keys(rid, pos),
                                self._to_flogits(logits)).to(torch.int32)

    @staticmethod
    def _last(lengths: torch.Tensor) -> torch.Tensor:
        """Each row's chunk's last valid position (0 for an empty row)."""
        return (lengths.long() - 1).clamp(min=0)

    def _reset(self, reset: torch.Tensor, reset_to: torch.Tensor):
        _reset_rows(self._cache, reset, reset_to)
        if self._speculative:
            _reset_rows(self._d_cache, reset, reset_to)

    def _refill_step(self, weights, d_weights, chunk, lengths, reset, reset_to, rid):
        """Admission resets, then one ``(B, refill_chunk)`` chunk through the
        target (and the draft, whose cache mirrors the target's valid
        prefix): every row's caches advance by its own valid length (0 for
        decoding or idle rows). → each row's first generated token (device),
        position 0 of its stream, from its chunk's last valid position."""
        lengths = self._to_device(lengths)
        self._reset(self._to_device(reset), self._to_device(reset_to))
        chunk = self._to_device(chunk)
        logits = self._forward(weights, chunk, lengths, self._last(lengths))
        if self._speculative:
            self._d_forward(d_weights, chunk, lengths, read=False)
        return self._sample_rows(logits, rid, torch.zeros_like(rid))

    def _decode_block(self, weights, tok, active, remaining, rid):
        """``decode_block_steps`` steps, on the device with no host sync. Rows
        that emit EOS or spend their ``remaining`` budget flip inactive:
        chunk length 0 from then on, so a retired row's cache index never
        passes its admission budget. → ``(B, K)`` tokens and the carries."""
        toks = []
        for _ in range(self._block_steps):
            logits = self._forward(weights, tok[:, None], active)
            # This draw's generated position: the row has emitted
            # max_new_tokens - remaining tokens.
            nxt = self._sample_rows(logits[:, -1], rid, self._max_new - remaining)
            nxt = torch.where(active == 1, nxt, tok)
            remaining = remaining - active
            if self._eos is not None:
                active = active * (nxt != self._eos).to(torch.int32)
            active = active * (remaining > 0).to(torch.int32)
            toks.append(nxt)
            tok = nxt
        return torch.stack(toks, dim=1), active, remaining

    def _spec_round(self, weights, d_weights, carry, rid):
        """ONE draft-verify round with per-row acceptance and rollback: the
        speculative core of the decode block and the mixed link. Frozen rows
        (``active == 0``: idle, refilling or retired) ride every call with
        length 0 and emit nothing, so the rollback re-asserts their ``pos``.
        ``carry`` is ``(tok, active, pos, remaining, count, buffer, acc,
        prop)``; the caches are updated in place."""
        tok, active, pos, remaining, count, buffer, acc, prop = carry
        nd, width = self._num_draft, self._num_draft + 1
        sampled = self._temperature != 0.0
        gen = self._max_new - remaining      # each row's next generated position
        # 1. The draft proposes per row.
        prev, drafts, q_all = tok, [], []
        for j in range(nd):
            lg = self._d_forward(d_weights, prev[:, None], active)[:, -1]
            if sampled:
                fl = self._to_flogits(lg)
                nxt = prng.categorical(self._spec_keys(rid, gen + j, 0), fl).to(torch.int32)
                q_all.append(torch.softmax(fl, dim=-1))
            else:
                nxt = self._greedy(lg)
            prev = torch.where(active == 1, nxt, prev)
            drafts.append(prev)
        drafts = torch.stack(drafts, dim=1)
        # One more feed puts the last proposal's K/V in the draft cache.
        self._d_forward(d_weights, prev[:, None], active, read=False)
        # 2. One chunked target verify.
        chunk = torch.cat([tok[:, None], drafts], dim=1)
        t_logits = self._forward(weights, chunk, active * width)
        # 3. Per-row acceptance: accepted drafts, then the bonus/correction
        #    (greedy) or the residual sample (sampling).
        if sampled:
            js = torch.arange(nd, device=self._device)
            u = prng.uniform(self._spec_keys(rid, gen[:, None] + js, 1))
            m, residual = rejection(drafts, torch.stack(q_all, dim=1),
                                    torch.softmax(self._to_flogits(t_logits), dim=-1), u)
            m = m.to(torch.int32)
            rows = torch.arange(self._b, device=self._device)
            token_m = prng.categorical(self._spec_keys(rid, gen + m, 2),
                                       torch.log(residual[rows, m.long()]))
            emitted = emit_vector(drafts, m, token_m.to(torch.int32))
        else:
            m, emitted, _ = greedy_accept_emit(drafts, self._greedy(t_logits))
        # 4. Truncate each row's emission at EOS and at its budget.
        raw = 1 + m
        if self._eos is not None:
            slots = torch.arange(width, device=self._device)
            hit = (emitted == self._eos) & (slots[None, :] < raw[:, None])
            any_hit = hit.any(dim=1)
            first = hit.to(torch.int32).argmax(dim=1).to(torch.int32)
            n_stop = torch.where(any_hit, first + 1, raw)
        else:
            any_hit = torch.zeros_like(active, dtype=torch.bool)
            n_stop = raw
        n_emit = torch.minimum(n_stop, remaining) * active
        # 5. Append at each row's own offset; the pending token becomes the
        #    last emitted one.
        row_update_masked(buffer, emitted, count, n_emit, seq_dim=1)
        new_tok = emitted.gather(1, (n_emit.long() - 1).clamp(min=0)[:, None])[:, 0]
        tok = torch.where(active == 1, new_tok, tok)
        # 6. Per-row rollback to pos + n_emit (frozen rows: their index).
        pos = pos + n_emit
        _rollback(self._cache, pos)
        _rollback(self._d_cache, pos)
        remaining = remaining - n_emit
        count = count + n_emit
        # Verifier acceptance before EOS/budget truncation: the draft's
        # quality, what num_draft is tuned against.
        acc = acc + m * active
        prop = prop + active * nd
        stopped = (any_hit & (n_stop <= n_emit) & (active == 1)).to(torch.int32)
        active = active * (remaining > 0).to(torch.int32) * (1 - stopped)
        return tok, active, pos, remaining, count, buffer, acc, prop

    def _spec_carry(self, tok, active, pos, remaining, width: int):
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                           device=self._device)
        return (tok, active, pos, remaining, zeros(self._b), zeros(self._b, width),
                zeros(self._b), zeros(self._b))

    def _decode_block_spec(self, weights, d_weights, tok, active, pos, remaining, rid):
        """Speculative decode block: ``decode_block_steps`` rounds, each
        emitting 1 to ``num_draft + 1`` tokens a row. ``pos`` is each row's
        cache index (prompt + emitted - 1). → ``(buffer, count, acc, prop,
        tok, pos, active, remaining)``: the buffer and counts are final
        (EOS and budget truncate a round exactly)."""
        carry = self._spec_carry(tok, active, pos, remaining,
                                 self._block_steps * (self._num_draft + 1))
        for _ in range(self._block_steps):
            carry = self._spec_round(weights, d_weights, carry, rid)
        tok, active, pos, remaining, count, buffer, acc, prop = carry
        return buffer, count, acc, prop, tok, pos, active, remaining

    def _mixed_step(self, weights, chunk, lengths, reset, reset_to, tok, active, remaining,
                    rid):
        """ONE fused link: every decoding row advances one token AND every
        scheduled refill row pushes its budgeted chunk, in one model call.
        Decode rows ride with length 1 (their pending token in column 0),
        refill rows with their scheduled length, idle rows with 0: each row
        computes what the split engine's programs compute for it. → ``(nxt,
        tok, active, remaining)``; ``nxt`` holds the refill rows' first
        tokens and the decode rows' next ones."""
        if reset is not None:
            self._reset(reset, reset_to)
        dec = active == 1                    # decoding rows hold no pending tokens
        eff_len = torch.where(dec, 1, lengths).to(torch.int32)
        chunk[:, 0] = torch.where(dec, tok, chunk[:, 0])
        logits = self._forward(weights, chunk, eff_len, self._last(eff_len))
        # Refill rows draw their stream's position 0, decode rows their
        # current generated position: the split engine's keys.
        pos = torch.where(dec, self._max_new - remaining, 0)
        nxt = self._sample_rows(logits, rid, pos)
        tok = torch.where(dec, nxt, tok)
        remaining = remaining - dec.to(torch.int32)
        if self._eos is not None:
            active = active * torch.where(dec, (nxt != self._eos).to(torch.int32), 1)
        active = active * torch.where(dec, (remaining > 0).to(torch.int32), 1)
        return nxt, tok, active, remaining

    def _spec_mixed_step(self, weights, d_weights, chunk, lengths, reset, reset_to, tok,
                         active, pos, remaining, rid):
        """The speculative fused link: the budgeted refill chunk through the
        target and the draft (decoding rows ride with length 0), then ONE
        draft-verify round. Refill rows' ``pos`` advance by their chunk
        length first, so the round's rollback re-asserts their advance. →
        ``(first_tok, buffer, count, acc, prop, tok, pos, active,
        remaining)``."""
        if reset is not None:
            self._reset(reset, reset_to)
        logits = self._forward(weights, chunk, lengths, self._last(lengths))
        self._d_forward(d_weights, chunk, lengths, read=False)
        first_tok = self._sample_rows(logits, rid, torch.zeros_like(rid))
        carry = self._spec_carry(tok, active, pos + lengths, remaining, self._num_draft + 1)
        tok, active, pos, remaining, count, buffer, acc, prop = self._spec_round(
            weights, d_weights, carry, rid)
        return first_tok, buffer, count, acc, prop, tok, pos, active, remaining

    # --- dispatches --------------------------------------------------------

    def _rid_arr(self) -> torch.Tensor:
        return self._to_device(np.maximum(np.asarray(self._req, np.int64), 0).astype(np.int32))

    def _first_token(self, slot: int, t: int, now: float, retired: list[int]):
        # Prompt complete: its first token came from the chunk that ended it.
        self._out[slot].append(t)
        self._emitted[slot] = 1
        self._tok[slot] = t
        self._slot_req[slot].first_token_t = now
        self._ttimes[slot].append(now)
        self.tracer.instant("request.first_token", rid=self._req[slot])
        if (self._eos is not None and t == self._eos) or self._max_new == 1:
            self._retire(slot, now, retired)
        else:
            self._active[slot] = True

    def _preempt_or_raise(self, slot: int):
        # Called in the handler of the pool's RuntimeError. Backpressure
        # instead of a wedge: while another slot is in flight its retirement
        # will free pages, so requeue this request (recompute preemption);
        # re-raise only when it is alone.
        if not any(self._req[s] >= 0 for s in range(self._b) if s != slot):
            raise
        self._unadmit(slot)
        self._c_preempt.inc()

    def _refill_dispatch(self, weights, d_weights, retired: list[int]) -> bool:
        # One refill chunk for every slot with pending prompt tokens;
        # decoding rows ride along with length 0. Up to ``decode_chain``
        # chunks back to back, one host sync at the end: chunk contents are
        # host-known, so no chunk waits on another's readback.
        b = self._b
        segs = []
        for _ in range(self.decode_chain):
            lengths = np.zeros((b,), np.int32)
            chunk = np.zeros((b, self._refill_chunk), np.int32)
            for slot in range(b):
                n = min(self._pending[slot].size, self._refill_chunk)
                if n:
                    chunk[slot, :n] = self._pending[slot][:n]
                    lengths[slot] = n
            if not lengths.any():
                break
            self._dispatch_seam("refill")
            if self._paged:
                for slot in range(b):
                    if not lengths[slot]:
                        continue
                    consumed = self._plen[slot] - self._pending[slot].size
                    try:
                        self._ensure(slot, consumed + int(lengths[slot]))
                    except RuntimeError:
                        self._preempt_or_raise(slot)
                        lengths[slot] = 0
                        chunk[slot, :] = 0
                if not lengths.any():
                    break
            # The cache-creating chunk is the JAX engine's first_refill.
            family = "first_refill" if self._cache is None else "refill_step"
            with self._led_device(family), annotate(f"engine.{family}"):
                self._ensure_cache()
                if self._paged:
                    self._set_tables()
                tok_new = self._refill_step(weights, d_weights, chunk, lengths,
                                            self._needs_reset, self._reset_to, self._rid_arr())
            # The dispatch has its own copy of the admission resets; every
            # flagged row had pending tokens and rode this chunk.
            self._needs_reset[:] = False
            self._reset_to[:] = 0
            completes = []
            for slot in range(b):
                if lengths[slot]:
                    self._pending[slot] = self._pending[slot][lengths[slot]:]
                    if self._pending[slot].size == 0 and self._req[slot] >= 0:
                        completes.append(slot)
            segs.append((tok_new, completes))
        if not segs:
            return False
        with self._led_device(family):
            toks = torch.stack([t for t, _ in segs]).cpu().numpy()   # ONE sync
        now = time.perf_counter()
        for tok_new, (_, completes) in zip(toks, segs):
            for slot in completes:
                self._first_token(slot, int(tok_new[slot]), now, retired)
        return True

    def _remaining(self) -> np.ndarray:
        return np.asarray([max(0, self._max_new - e) for e in self._emitted], np.int32)

    def _decode_pos(self) -> np.ndarray:
        # Each decoding row's cache index: prompt + emitted - 1 (its pending
        # token is not in the cache yet).
        return np.asarray([max(0, p + e - 1) for p, e in zip(self._plen, self._emitted)],
                          np.int32)

    def _map_decode(self, remaining: np.ndarray, tokens: int, spec: bool):
        """Map every position a decoding row can write in its next
        ``tokens`` tokens, capped by its remaining budget (speculative
        rounds, ``spec``: plus the verify chunk's headroom), with recompute
        preemption."""
        for slot in range(self._b):
            if not self._active[slot]:
                continue
            pos = self._plen[slot] + self._emitted[slot] - 1
            span = min(int(remaining[slot]), tokens)
            if spec:
                span += self._num_draft + 1
            try:
                self._ensure(slot, pos + span)
            except RuntimeError:
                self._preempt_or_raise(slot)

    def _decode_dispatch(self, weights, d_weights, retired: list[int]) -> bool:
        # Up to ``decode_chain`` decode blocks back to back, the carries
        # flowing device to device, ONE host sync at the end. A retiring
        # slot idles until that sync (admission coarsens by up to a chain);
        # results cannot change. Returns whether a dispatch ran.
        if not self._active.any():
            return False
        b = self._b
        # Degradation level 1 turns the draft-verify rounds off: a
        # speculative engine decodes through the plain decode block on the
        # target's cache; the draft cache waits (on re-enable its stale K/V
        # costs acceptance, never tokens: the verifier decides each one).
        spec = self._speculative and not self._spec_disabled
        remaining = self._remaining()
        # Never dispatch blocks that cannot emit: cap the chain at what the
        # longest-running active row can still use.
        per_block = self._block_steps * ((self._num_draft + 1) if spec else 1)
        worst = int(remaining[self._active].max())
        chain = min(self.decode_chain, -(-worst // per_block))
        self._dispatch_seam("decode")
        if self._paged:
            self._map_decode(remaining, chain * per_block, spec)
            if not self._active.any():
                return False
            self._set_tables()
            # Re-cap the chain from the surviving rows.
            worst = int(remaining[self._active].max())
            chain = min(self.decode_chain, -(-worst // per_block))
        tok = self._to_device(self._tok)
        active = self._to_device(self._active.astype(np.int32))
        remaining_d = self._to_device(remaining)
        rid = self._rid_arr()
        segs = []
        family = "decode_block_spec" if spec else "decode_block"
        with self._led_device(family), annotate(f"engine.{family}"):
            if spec:
                pos_d = self._to_device(self._decode_pos())
                for _ in range(chain):
                    buffer, counts, acc, prop, tok, pos_d, active, remaining_d = (
                        self._decode_block_spec(weights, d_weights, tok, active, pos_d,
                                                remaining_d, rid))
                    segs.append(torch.cat([counts[:, None], acc[:, None], prop[:, None],
                                           buffer], dim=1))
            else:
                for _ in range(chain):
                    toks, active, remaining_d = self._decode_block(weights, tok, active,
                                                                   remaining_d, rid)
                    # Next block's pending token: each row's last emitted
                    # (frozen rows repeat theirs).
                    tok = toks[:, -1]
                    segs.append(toks)
        with self._led_device(family):
            segs = torch.stack(segs).cpu().numpy()     # ONE sync
        now = time.perf_counter()
        was_active = self._active.copy()
        for seg in segs:
            if spec:
                self._c_spec_acc.inc(int(seg[:, 1].sum()))
                self._c_spec_prop.inc(int(seg[:, 2].sum()))
            for slot in range(b):
                # A slot retired in an earlier block emits nothing real in
                # later ones: its lane froze on the device.
                if was_active[slot] and self._req[slot] >= 0:
                    toks = seg[slot, 3:3 + seg[slot, 0]] if spec else seg[slot]
                    self._consume(slot, toks.tolist(), now, retired)
        return True

    def _link_budget(self, n_active: int, per_link: int) -> int:
        # Decode rows are funded first at their true per-link consumption
        # (1 token, or the num_draft + 1 verify positions); refill takes the
        # remainder, uncapped when nothing is decoding.
        if n_active:
            return max(0, self.token_budget - n_active * per_link)
        return self._b * self._refill_chunk

    def _mixed_dispatch(self, weights, d_weights, retired: list[int]):
        # The FUSED iteration: up to ``decode_chain`` mixed links (or, with
        # ``horizon > 1``, one planned horizon) back to back, each advancing
        # every decoding row by one token or one round AND pushing budgeted
        # refill chunks; carries flow device to device; ONE host sync at the
        # end. Returns the program class that ran ("mixed", or "refill" /
        # "decode" for the fallthroughs) or False when nothing dispatched.
        if self._cache is None:
            # Cache creation routes through the refill path.
            return "refill" if self._refill_dispatch(weights, d_weights, retired) else False
        if self._speculative and self._spec_disabled:
            # Degradation level >= 1 on a speculative mixed engine: the split
            # dispatches (the refill still feeds the draft cache, so turning
            # speculation back on stays sound; decode runs the plain block).
            if any(p.size for p in self._pending):
                return "refill" if self._refill_dispatch(weights, d_weights, retired) else False
            return "decode" if self._decode_dispatch(weights, d_weights, retired) else False
        if not any(p.size for p in self._pending):
            # PURE-DECODE phase: nothing to fuse, so the K-step decode block
            # runs (a fused link costs one dispatch a token and exists to
            # overlap refill).
            return "decode" if self._decode_dispatch(weights, d_weights, retired) else False
        if self._speculative and not self._active.any():
            # PURE-REFILL phase in speculative mode: a fused link would pay a
            # full draft-verify round with every row frozen. Outputs do not
            # depend on the schedule, so refill runs split until a row
            # decodes.
            return "refill" if self._refill_dispatch(weights, d_weights, retired) else False
        b = self._b
        per_link = (self._num_draft + 1) if self._speculative else 1
        horizon = int(self.horizon)
        n_links = horizon if horizon > 1 else max(1, self.decode_chain)

        def chain_cap(remaining, active):
            # Links the longest-running decoding row can still use
            # (optimistic for speculative rounds).
            if not active.any():
                return 0
            return -(-int(remaining[active].max()) // per_link)

        remaining = self._remaining()
        chain_dec = chain_cap(remaining, self._active)
        if self._paged and self._active.any():
            self._map_decode(remaining, min(n_links, max(chain_dec, 1)) * per_link,
                             self._speculative)
            remaining = self._remaining()
            chain_dec = chain_cap(remaining, self._active)
        was_active = self._active.copy()
        n_active = int(was_active.sum())
        tok = self._to_device(self._tok)
        active = self._to_device(was_active.astype(np.int32))
        remaining_d = self._to_device(remaining)
        rid = self._rid_arr()
        pos_d = None
        if self._speculative:
            # Every row's CURRENT cache index: decoding rows at prompt +
            # emitted - 1, refilling rows at their consumed count (the
            # round's rollback must re-assert, never rewind, a refill
            # advance; each link adds its chunk lengths on top).
            pos_d = self._to_device(np.asarray(
                [max(0, self._plen[s] + self._emitted[s] - 1) if was_active[s]
                 else (self._plen[s] - self._pending[s].size if self._req[s] >= 0 else 0)
                 for s in range(b)], np.int32))
        carry = (tok, active, pos_d, remaining_d)
        self._dispatch_seam("mixed")
        if horizon > 1:
            return self._multi_dispatch(weights, d_weights, retired, n_links=n_links,
                                        per_link=per_link, chain_dec=chain_dec,
                                        was_active=was_active, n_active=n_active,
                                        carry=carry, rid=rid)
        links = []
        for link in range(max(1, self.decode_chain)):
            # Each link's schedule is planned after the previous link took
            # its tokens: the horizon's plan, one link at a time.
            planned, offs = self._plan_horizon_links(1, n_active, per_link, chain_dec - link,
                                                     allow_preempt=True)
            if not planned:
                break
            self._take_pending(offs)
            if self._paged:
                self._set_tables()
            # Link 0 carries every pending admission reset, rows the budget
            # starved included: a counter reset is idempotent and nothing
            # advances a row before its first chunk.
            reset = None
            if self._needs_reset.any():
                reset = (self._to_device(self._needs_reset), self._to_device(self._reset_to))
                self._needs_reset[:] = False
                self._reset_to[:] = 0
            chunk, lengths, _, _ = planned[0]
            links += planned
            with self._led_device("mixed_step"), annotate("engine.mixed_step"):
                carry = self._run_link(weights, d_weights, self._to_device(chunk),
                                       self._to_device(lengths), reset, carry, rid)
        if not links:
            return False
        self.recorder.record(
            "engine.mixed_schedule", links=len(links), decode_rows=n_active,
            refill_tokens=int(sum(ln.sum() for _, ln, _, _ in links)),
            starved=sum(st for _, _, st, _ in links), budget=self.token_budget,
            queue_depth=len(self._queue))
        with self._led_device("mixed_step"):
            outs = self._read_links()
        self._consume_links(outs, links, was_active, retired)
        return "mixed"

    def _take_pending(self, offs):
        # Commit a dispatched plan's advance of the pending prompt views.
        for slot, n in enumerate(offs):
            if n:
                self._pending[slot] = self._pending[slot][n:]

    def _run_link(self, weights, d_weights, chunk, lengths, reset, carry, rid):
        """One mixed link on the device. Its outputs go to ``self._link_out``
        (one ``(B, ...)`` int32 row block a link) until the host reads them
        all at once; → the next link's carry."""
        tok, active, pos, remaining = carry
        reset, reset_to = reset if reset is not None else (None, None)
        if self._speculative:
            first, buffer, count, acc, prop, tok, pos, active, remaining = (
                self._spec_mixed_step(weights, d_weights, chunk, lengths, reset, reset_to,
                                      tok, active, pos, remaining, rid))
            self._link_out.append(torch.cat(
                [first[:, None], count[:, None], acc[:, None], prop[:, None], buffer], dim=1))
        else:
            first, tok, active, remaining = self._mixed_step(
                weights, chunk, lengths, reset, reset_to, tok, active, remaining, rid)
            self._link_out.append(first[:, None])
        return tok, active, pos, remaining

    def _read_links(self) -> np.ndarray:
        out, self._link_out = self._link_out, []
        return torch.stack(out).cpu().numpy()      # ONE sync for every link

    def _consume_links(self, outs: np.ndarray, links, was_active: np.ndarray,
                       retired: list[int]):
        """Each link's completions (first tokens) and decode tokens, in link
        order, for the rows decoding at the dispatch's start that are still
        live (a row retired at an earlier link froze on the device)."""
        now = time.perf_counter()
        for out, (_, _, _, completes) in zip(outs, links):
            for slot in completes:
                self._first_token(slot, int(out[slot, 0]), now, retired)
            if self._speculative:
                self._c_spec_acc.inc(int(out[:, 2].sum()))
                self._c_spec_prop.inc(int(out[:, 3].sum()))
            for slot in range(self._b):
                if was_active[slot] and self._req[slot] >= 0:
                    toks = out[slot, 4:4 + out[slot, 1]] if self._speculative else out[slot, :1]
                    self._consume(slot, toks.tolist(), now, retired)

    def _plan_horizon_links(self, n_links, n_active, per_link, chain_dec, *, allow_preempt):
        """The mixed scheduler's refill plan of up to ``n_links`` fused links
        (the JAX engine's ``_schedule_refill`` policy, one link at a time,
        and its ``_plan_horizon_links``): FCFS over slots with pending prompt
        tokens in admission order (arrival breaks ties; a preempted request
        keeps its place), each taking ``min(pending, refill_chunk, budget
        left)``, over a VIRTUAL pending advance (per-slot offsets;
        ``self._pending`` is not consumed: the caller commits when the plan
        dispatches). A link is planned while it has refill tokens or the
        decode cap ``chain_dec`` reaches it. → ``(links, offs)``, each link
        ``(chunk, lengths, completes)``, or None when ``allow_preempt=False``
        (the in-flight planner) and the pool cannot cover the plan:
        preemption is a boundary decision. Admission order is the admission
        pass (the JAX engine's admission stamp, a counter equal on every
        rank of a mesh), then the arrival stamp ``add_request`` set, then the
        add order."""
        b = self._b
        offs = [0] * b
        links = []
        for link in range(n_links):
            budget = self._link_budget(n_active, per_link)
            lengths = np.zeros((b,), np.int32)
            chunk = np.zeros((b, self._refill_chunk), np.int32)
            completes = []
            starved = 0
            order = sorted((s for s in range(b) if self._pending[s].size - offs[s] > 0),
                           key=lambda s: (self._slot_req[s].admit_pass,
                                          self._slot_req[s].order_t, self._slot_req[s].seq))
            for slot in order:
                if budget <= 0:
                    starved += 1
                    continue
                n = min(self._pending[slot].size - offs[slot], self._refill_chunk, budget)
                if self._paged:
                    consumed = self._plen[slot] - self._pending[slot].size + offs[slot]
                    try:
                        self._ensure(slot, consumed + n)
                    except RuntimeError:
                        if not allow_preempt:
                            return None
                        self._preempt_or_raise(slot)
                        # Nothing dispatched yet: scrub the requeued request
                        # from the earlier planned links.
                        offs[slot] = 0
                        for ch2, ln2, _, comp2 in links:
                            ln2[slot] = 0
                            ch2[slot, :] = 0
                            if slot in comp2:
                                comp2.remove(slot)
                        continue
                chunk[slot, :n] = self._pending[slot][offs[slot]:offs[slot] + n]
                lengths[slot] = n
                offs[slot] += n
                budget -= n
                if offs[slot] == self._pending[slot].size and self._req[slot] >= 0:
                    completes.append(slot)
            has_decode = n_active > 0 and link < chain_dec
            if not lengths.any() and not has_decode:
                break
            links.append((chunk, lengths, starved, completes))
        return links, offs

    def _boundary_fingerprint(self, n_links, n_active, per_link, chain_dec):
        # Everything _plan_horizon_links reads: slot occupancy, pending sizes
        # (contents are fixed between admissions, so sizes and request ids
        # pin them), and the budget and cap inputs.
        return (tuple(self._req), tuple(int(p.size) for p in self._pending), int(n_active),
                int(chain_dec), int(n_links), int(per_link), int(self.token_budget))

    def _take_staged_plan(self, n_links, n_active, per_link, chain_dec):
        """The staged plan iff the boundary state matches its prediction
        exactly (a retirement, admission, preemption or knob change misses
        and the boundary plans live): staging moves host work off the
        boundary and never changes what dispatches."""
        staged, self._staged_plan = self._staged_plan, None
        if staged is None:
            return None
        fp, plan = staged
        if fp != self._boundary_fingerprint(n_links, n_active, per_link, chain_dec):
            return None
        self._c_plan_reused.inc()
        return plan

    def _multi_dispatch(self, weights, d_weights, retired, *, n_links, per_link, chain_dec,
                        was_active, n_active, carry, rid):
        # The multi-step horizon: plan up to ``n_links`` links on the host,
        # queue every planned link with the carries on the device, stage the
        # next horizon's plan while the device works, then sync ONCE and
        # consume every link as the link loop does. A link the host did not
        # plan is not run; a planned link with no active row runs with every
        # length 0, advancing no row.
        plan = self._take_staged_plan(n_links, n_active, per_link, chain_dec)
        reused = plan is not None
        if plan is None:
            plan = self._plan_horizon_links(n_links, n_active, per_link, chain_dec,
                                            allow_preempt=True)
        links, offs = plan
        if not links:
            return False
        self._take_pending(offs)           # the plan is final
        if self._paged:
            # The plan (refill) and the preamble (decode) allocated every
            # page of the horizon: one table push.
            self._set_tables()
        chunks = self._to_device(np.stack([c for c, _, _, _ in links]))
        lengths = self._to_device(np.stack([ln for _, ln, _, _ in links]))
        reset = None
        if self._needs_reset.any():
            reset = (self._to_device(self._needs_reset), self._to_device(self._reset_to))
        self._needs_reset[:] = False
        self._reset_to[:] = 0
        with self._led_device("multi_step"), annotate("engine.multi_step"):
            for i in range(len(links)):
                carry = self._run_link(weights, d_weights, chunks[i], lengths[i],
                                       reset if i == 0 else None, carry, rid)
        self.recorder.record(
            "engine.mixed_schedule", links=len(links), decode_rows=n_active,
            refill_tokens=int(sum(ln.sum() for _, ln, _, _ in links)),
            starved=sum(st for _, _, st, _ in links), budget=self.token_budget,
            queue_depth=len(self._queue), horizon=n_links, plan_reused=reused)
        self._c_multi_n.inc()
        self._c_multi_links.inc(len(links))
        # The planner's window: the links are queued and nothing below needs
        # their results yet.
        self._plan_next_horizon(n_links, per_link, chain_dec, links)
        with self._led_device("multi_step"):
            outs = self._read_links()            # ONE read for the horizon
        self._consume_links(outs, links, was_active, retired)
        return "mixed"

    def _plan_next_horizon(self, n_links, per_link, chain_dec, links):
        """Stage the NEXT horizon's refill plan (page reservations included)
        against a PREDICTED boundary state, while the device runs this one:
        host state only, no readback. Every active row is predicted to
        advance its minimum (one token or round a decode link) with no EOS;
        the next dispatch takes the plan only on an exact fingerprint
        match."""
        self._staged_plan = None
        b = self._b
        n_dec = min(len(links), max(0, chain_dec))
        rem = self._remaining()
        act = self._active.copy()
        surv = act & (rem > n_dec)
        rem_pred = rem.copy()
        rem_pred[act] = np.maximum(rem_pred[act] - n_dec, 0)
        req_pred = list(self._req)
        for s in range(b):
            if act[s] and not surv[s]:
                req_pred[s] = -1
        for _c, _l, _st, comp in links:
            for s in comp:
                # A prompt completing this horizon decodes at the boundary
                # (unless max_new_tokens == 1 retires it at its first token).
                if self._max_new > 1:
                    surv[s] = True
                    rem_pred[s] = self._max_new - 1
                else:
                    req_pred[s] = -1
        n_active_pred = int(surv.sum())
        chain_pred = -(-int(rem_pred[surv].max()) // per_link) if surv.any() else 0
        plan = self._plan_horizon_links(n_links, n_active_pred, per_link, chain_pred,
                                        allow_preempt=False)
        if plan is None or not plan[0]:
            return
        fp = (tuple(req_pred), tuple(int(p.size) for p in self._pending), n_active_pred,
              chain_pred, int(n_links), int(per_link), int(self.token_budget))
        self._staged_plan = (fp, plan)
        self._c_plan_staged.inc()
        self.recorder.record("engine.plan_staged", links=len(plan[0]),
                             predicted_active=n_active_pred)

    @property
    def degradation_level(self) -> int:
        """The degradation ladder's level (0 without a ladder): 0 normal, 1
        speculation off, 2 ``token_budget`` halved, 3 shedding new admits."""
        return self._level

    def _apply_degradation(self):
        """Feed the SLO monitor's burn rate into the ladder and apply a level
        change to the engine's knobs: the public ``token_budget`` an operator
        can turn too, so de-escalation restores the value the ladder took
        over. Over a mesh the first rank updates the ladder and broadcasts
        the level."""
        if self._ladder is None or self.slo is None:
            return
        level = burn = 0.0
        if self._agree_mesh is None or dist.get_rank() == self._src:
            burn = max((self.slo.burn_rate(t.name) for t in self.slo.targets), default=0.0)
            level = self._ladder.update(burn)
        level, burn = self._agree(np.asarray([level, burn], np.float64))
        level = int(level)
        if level == self._level:
            return
        self._level = level
        if self._speculative:
            self._spec_disabled = level >= 1
        if self._mixed:
            if level >= 2 and self._base_budget is None:
                self._base_budget = self.token_budget
                self.token_budget = max(self._b, self.token_budget // 2)
            elif level < 2 and self._base_budget is not None:
                self.token_budget = self._base_budget
                self._base_budget = None
        self._shed_all = level >= 3
        self._g_degraded.set(level)
        self.recorder.record(
            "engine.degrade", level=level, name=self._ladder.LEVELS[level], burn_rate=burn,
            spec_disabled=self._spec_disabled, token_budget=self.token_budget,
            shedding=self._shed_all)

    def step(self, params=None, draft_params=None) -> list[int]:
        """ONE scheduler iteration: commit a staged weight swap when the slots
        are empty, evict expired requests, admit queued ones into idle
        slots, then one dispatch: a refill if any slot has pending prompt
        tokens, else a decode block if any row is active, else nothing; with
        ``mixed=True`` the fused links instead. A recoverable dispatch fault
        is quarantined (see :class:`ContinuousEngine`); then the degradation
        ladder reads the SLO monitor. Once a swap has committed the engine
        owns its weights: they override whatever ``params`` the caller
        passes, which may then be omitted. Returns the ids of the requests
        that finished in this step (their outputs wait in
        ``pop_finished()``)."""
        # The ledger's top-level frame: the whole iteration is covered wall,
        # "sched" unless a region inside claims its own bucket.
        with self.ledger.measure("sched"):
            if self._staged_swap is not None:
                self._try_commit_swap()
            if self._installed is not None:
                weights, d_weights = self._installed
            elif params is None:
                raise TypeError("step() without params: pass the params to serve, or "
                                "swap_weights() first")
            else:
                self._check_draft_args(draft_params)
                weights, d_weights = self._cast_params(params, draft_params)
            retired: list[int] = []
            with torch.no_grad():
                # TTL eviction before admission: an expired queued request
                # takes no slot, an expired one in flight frees its slot.
                self._sweep_deadlines()
                self._admit()
                # A dispatch stalls decode when rows were decoding but it
                # advanced none of them (the split engine's refill).
                had_active = bool(self._active.any())
                t0 = time.perf_counter()
                self._seam_fault = None
                try:
                    if self._mixed:
                        kind = self._mixed_dispatch(weights, d_weights, retired)
                    elif self._refill_dispatch(weights, d_weights, retired):
                        kind = "refill"
                    elif self._decode_dispatch(weights, d_weights, retired):
                        kind = "decode"
                    else:
                        kind = False
                    if kind:
                        self._book_dispatch(kind, time.perf_counter() - t0, t0, had_active,
                                            len(retired))
                except _RECOVERABLE_DISPATCH as e:
                    # Over a mesh only the seam's faults are every rank's.
                    if self._agree_mesh is not None and e is not self._seam_fault:
                        raise
                    self._on_dispatch_fault(e)
                self._apply_degradation()
            self._g_active.set(int(self._active.sum()))
            self._g_queue.set(len(self._queue))
        return retired

    def _book_dispatch(self, kind: str, dt: float, t0: float, had_active: bool, retired: int):
        # Wall time accrues to the program class that ran (a mixed engine's
        # fallthroughs book refill or decode); a refill with rows decoding
        # stalls them, and the SLO feed sees a 0/1 stall per dispatch that
        # had decoding rows.
        with self.ledger.measure("telemetry"):
            if kind == "refill":
                self._c_refill_s.inc(dt)
                self._c_refill_n.inc()
                if had_active:
                    self._c_stall_s.inc(dt)
            elif kind == "decode":
                self._c_decode_s.inc(dt)
                self._c_decode_n.inc()
            else:
                self._c_mixed_s.inc(dt)
                self._c_mixed_n.inc()
            if had_active and self.slo is not None:
                self.slo.observe("decode_stall_share", 1.0 if kind == "refill" else 0.0)
            self.tracer.complete(f"engine.{kind}", t0, dt, retired=retired)

    # --- stats -------------------------------------------------------------

    def latency_stats(self) -> dict | None:
        """Latency percentiles over the requests completed in the current
        stats window, in seconds; the refill and decode-stall shares of
        dispatch time; the shed rate (shed arrivals over offered ones) and
        the deadline-miss rate (TTL evictions over retirements)."""
        comp = self._completed
        if not comp:
            return None

        def pcts(values, name):
            a = np.asarray([v for v in values if v is not None], np.float64)
            if not a.size:
                return {}
            return {f"{name}_p50": float(np.percentile(a, 50)),
                    f"{name}_p99": float(np.percentile(a, 99))}

        out = {"requests": len(comp)}
        out.update(pcts([c["queue_wait"] for c in comp], "queue_wait"))
        out.update(pcts([c["ttft"] for c in comp], "ttft"))
        out.update(pcts([c["tpot"] for c in comp], "tpot"))
        out.update(pcts(self._itl, "itl"))
        out.update(pcts([c["e2e"] for c in comp], "e2e"))
        d = self._win_delta
        refill_s, decode_s = d(self._c_refill_s), d(self._c_decode_s)
        mixed_s, stall_s = d(self._c_mixed_s), d(self._c_stall_s)
        busy = refill_s + decode_s + mixed_s
        out.update(
            refill_s=refill_s, decode_s=decode_s, mixed_s=mixed_s,
            refill_frac=refill_s / busy if busy else None,
            # The share of dispatch time that parked decoding rows behind
            # another slot's refill: what the mixed engine drives to ~0.
            decode_stall_s=stall_s,
            decode_stall_share=stall_s / busy if busy else None,
            refill_dispatches=int(d(self._c_refill_n)),
            decode_dispatches=int(d(self._c_decode_n)),
            mixed_dispatches=int(d(self._c_mixed_n)),
        )
        multi_n = d(self._c_multi_n)
        if multi_n:
            # The horizon: links fused a dispatch, and how often the staged
            # plan was taken.
            out.update(
                multi_dispatches=int(multi_n),
                steps_per_dispatch=d(self._c_multi_links) / multi_n,
                plan_reuse_rate=d(self._c_plan_reused) / max(1.0, d(self._c_plan_staged)),
            )
        shed = d(self._c_shed)
        offered = d(self._c_requests) + shed
        done = d(self._c_finished) + d(self._c_req_failed)
        out.update(
            shed_rate=shed / offered if offered else 0.0,
            deadline_miss_rate=d(self._c_deadline) / done if done else 0.0,
            failed=int(d(self._c_req_failed)),
            rerouted=int(d(self._c_rerouted)),
        )
        if self._paged and self._prefix:
            hits, admitted = d(self._c_pfx_hits), d(self._c_requests)
            exp, miss = d(self._c_pfx_expected), d(self._c_tier_miss)
            out.update(prefix_hit_rate=hits / admitted if admitted else 0.0,
                       tier_miss_rate=miss / exp if exp else 0.0)
        return out

    def _snapshot_stats(self):
        # The mode stats (None when no mode is on), as window deltas over the
        # cumulative registry counters.
        stats = None
        if self._paged:
            stats = dict(page_high_water=int(self._g_pages.high_water),
                         pages_total=self._paged_pages - 1, page_size=self._page_size,
                         preemptions=int(self._win_delta(self._c_preempt)))
            if self._prefix:
                stats.update(prefix_hits=int(self._win_delta(self._c_pfx_hits)),
                             prefix_pages_reused=int(self._win_delta(self._c_pfx_pages)),
                             prefix_pages_retained=len(self._cached_lru))
        if self._speculative:
            stats = stats or {}
            acc, prop = self._win_delta(self._c_spec_acc), self._win_delta(self._c_spec_prop)
            stats.update(spec_accepted=int(acc), spec_proposed=int(prop),
                         spec_accept_rate=acc / prop if prop else None)
        self.last_stats = stats
        self.last_latency = self.latency_stats()

    def serve(self, params, prompts, rng=None, draft_params=None) -> list:
        """Drain a whole queue: outputs in queue order, requests numbered by
        queue index (the sampling streams' identity). Requires an idle
        engine; the cache, pool and prefix registry carry over between calls.
        ``rng`` (an int seed or two-word key data; ``jax.random.key(0)``'s
        when None) becomes the engine's key, for this call and for later
        streaming, as the JAX engine's ``serve`` sets it."""
        self._check_draft_args(draft_params)
        if self.has_work():
            raise RuntimeError(
                "serve() requires an idle engine: drain streaming work "
                "(step() until not has_work()) first"
            )
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        # Validate everything before touching any state: a bad prompt must
        # raise without costing the engine its prefix registry.
        for p in prompts:
            self._validate_prompt(p)
        self.rng = prng.as_key(0 if rng is None else rng, self._device)
        self.reset_stats()
        # The per-call ids 0..n-1 must not collide with un-popped streaming
        # results: stash them and restore them after.
        stash, self._finished = self._finished, {}
        ok = False
        try:
            for i, p in enumerate(prompts):
                self.add_request(p, rid=i)
            with self.tracer.span("engine.serve", requests=len(prompts)):
                while self.has_work():
                    self.step(params, draft_params)
            ok = True
        finally:
            # The stats reflect this call even when it raises.
            self._snapshot_stats()
            if not ok:
                self.reset()
                self._finished = stash
        results = []
        for i in range(len(prompts)):
            r = self._finished.pop(i)
            if r.status == "ok":
                results.append(np.asarray(r.tokens, np.int32))
            else:
                results.append(RequestFailure(rid=r.rid, status=r.status, error=r.error,
                                              tokens=r.tokens))
        self._finished = stash
        return results

    # --- weight swaps --------------------------------------------------------

    def _serving_layout(self, model) -> dict:
        """``{name: (layout, dtype)}`` of every tensor ``_load`` fills in
        ``model``: on one device each state-dict entry, on the engine's
        device; over a mesh each parameter and int4 ``q4``/``scale`` buffer,
        placed by its logical axes (``shard_params``' layout)."""
        if self._mesh is None:
            device = sharding_of(torch.empty(0, device=self._device))
            return {name: (device, t.dtype) for name, t in model.state_dict().items()}
        axes = getattr(model, "logical_axes", param_logical_axes)
        return {name: (NamedSharding(self._mesh, placements_to_spec(
            self._mesh, logical_placements(self._mesh, self._rules, axes(name)), t.ndim)),
            t.dtype) for name, t, _ in layout_tensors(model)}

    def _stage(self, model, raw, cast, dequant, cfg) -> tuple[dict, int]:
        """The cast weights ``cast`` (of the caller's ``raw`` tree) laid out
        as ``_load`` lays them, in tensors of their own, with the live model
        untouched → ``(staged tree, bytes moved)``. On one device a
        dequantize-per-call tree stays as the calls take it; every other
        tree is cast to each parameter's dtype and resharded into the serving
        layout (over a mesh each rank slices its shard, dequantized first in
        a non-fused dequantize mode)."""
        with torch.no_grad():
            if self._mesh is None and dequant:
                tree = dict(cast)
                dst = {name: sharding_of(t) for name, t in tree.items()}
            else:
                if dequant:
                    cast = dequantize_tree(cast, cfg.param_dtype)
                layout = self._serving_layout(model)
                if set(cast) != set(layout):
                    raise ValueError(
                        f"swap_weights: the tree's names differ from the model's: missing "
                        f"{sorted(set(layout) - set(cast))}, unexpected "
                        f"{sorted(set(cast) - set(layout))}")
                tree = {name: cast[name].to(dtype) for name, (_, dtype) in layout.items()}
                dst = {name: sh for name, (sh, _) in layout.items()}
            staged, stats = reshard_tree(tree, dst, plan_cache=self._swap_plan_cache)
            # No staged tensor may share storage with the caller's tree, which
            # the caller may go on updating in place (a redistribute into the
            # placements a DTensor already has keeps its local tensor).
            theirs = {_storage(t) for t in raw.values() if isinstance(t, torch.Tensor)}
            staged = {name: t.clone() if _storage(t) in theirs else t
                      for name, t in staged.items()}
        return staged, int(stats["bytes"])

    def _install(self, model, staged: dict, dequant: bool):
        """Make ``staged`` the weights ``model`` serves (its tensors become the
        parameters and buffers, nothing copied) → what every model call
        then takes for it: None, or on one device in a dequantize-per-call
        mode the staged tree itself."""
        if self._mesh is None and dequant:
            return staged
        for name, t in staged.items():
            install_tensor(model, name, t)
        return None

    def swap_weights(self, new_params, *, version: int, draft_params=None,
                     mode: str = "drain") -> bool:
        """Stage ``new_params`` for a weight swap with no request dropped, and
        commit it between dispatches.

        Staging happens now: the tree goes through the engine's inference
        cast and is resharded into the serving layout
        (``parallel.resharding.reshard_tree``: the device path where the
        tensors already lie on the serving devices, the counted host plan
        otherwise; plans are cached across swaps) into tensors of its own.
        The engine serves the old weights meanwhile; nothing the scheduler
        reads changes before the commit.

        The commit installs the staged tensors as the model's weights and
        sets ``weights_version`` to ``version``; from then on every dispatch
        takes the installed weights as they are, casting nothing: they
        override any ``params`` a caller passes to ``step()``, and no later
        in-place update of ``new_params`` reaches them. It fires only with
        every slot empty:

        * ``mode="drain"``: admission pauses, requests in flight finish on
          the old weights, and the first ``step()`` that finds the slots
          empty commits and admits the queue under the new version;
        * ``mode="preempt"``: every request in flight is requeued (recompute
          preemption: it recomputes under the new weights) and the commit
          happens at once.

        Each request is attributed to one version: pinned at admission,
        logged at retirement (``finished_versions``). On a paged engine the
        commit drops the prefix registry and bumps ``prefix_epoch``. A fault
        at the ``engine.swap_stage`` chaos seam (on any rank of a mesh,
        while an injector is installed) or a recoverable staging failure
        aborts the swap into ``engine_swap_aborted_total``: the engine keeps
        its version. Returns True when staged (the commit may still wait),
        False when aborted. Raises ``RuntimeError`` while a swap is
        staged."""
        if mode not in ("drain", "preempt"):
            raise ValueError(f"mode must be 'drain' or 'preempt', got {mode!r}")
        self._check_draft_args(draft_params)
        if self._staged_swap is not None:
            raise RuntimeError(
                f"a weight swap is already staged (version {self._staged_swap['version']}): "
                "it commits when the slots drain; stage the next version after that")
        t0 = time.perf_counter()
        with self.ledger.measure("swap"):
            err = None
            try:
                chaos_hook("engine.swap_stage", version=version, mode=mode)
            except _RECOVERABLE_DISPATCH as e:
                err = e
            if (self._agree_mesh is not None and chaos_active()
                    and self._any_rank(err is not None) and err is None):
                err = InjectedFault("engine.swap_stage", "remote",
                                    "swap staging fault on another rank of the mesh")
            if err is None:
                try:
                    staged, p_bytes = self._stage(self._model, new_params,
                                                  self._maybe_cast(new_params), self._dequant,
                                                  self._cfg)
                    d_staged, d_bytes = None, 0
                    if draft_params is not None:
                        d_staged, d_bytes = self._stage(self._d_model, draft_params,
                                                        self._d_cast(draft_params),
                                                        self._d_dequant, self._d_cfg)
                except _RECOVERABLE_DISPATCH as e:
                    err = e
            if err is not None:
                self._c_swap_aborted.inc()
                self.recorder.record("engine.swap_abort", version=version, mode=mode,
                                     error=str(err))
                return False
            moved = p_bytes + d_bytes
            self._staged_swap = dict(version=version, mode=mode, staged=(staged, d_staged),
                                     staged_t=time.perf_counter())
            self._c_swap_staged.inc()
            self._c_swap_bytes.inc(moved)
            self.recorder.record("engine.swap_stage", version=version, mode=mode, bytes=moved,
                                 stage_s=time.perf_counter() - t0,
                                 occupied=sum(q >= 0 for q in self._req),
                                 queue_depth=len(self._queue))
            if mode == "preempt":
                for slot in range(self._b):
                    if self._req[slot] >= 0:
                        self._unadmit(slot)
                        self._c_preempt.inc()
            # An idle engine (and every preempt-mode swap) commits now; a
            # draining one in the step() that empties it.
            self._try_commit_swap()
        return True

    def _try_commit_swap(self) -> bool:
        """The switch, between dispatches and only with every slot empty, so
        no request straddles two versions. Over a mesh every rank commits in
        the same step: the slots are equal on every rank."""
        s = self._staged_swap
        if s is None or any(q >= 0 for q in self._req):
            return False
        with self.ledger.measure("swap"):
            if self._paged:
                # Old weights' K/V must not seed requests of the new ones.
                self._drop_prefix_registry()
            staged, d_staged = s["staged"]
            weights = self._install(self._model, staged, self._dequant)
            d_weights = (None if d_staged is None
                         else self._install(self._d_model, d_staged, self._d_dequant))
            # Every dispatch from now on takes the installed tensors as they
            # are: it casts and loads nothing, and no in-place update of the
            # caller's tree (an optimizer step) can reach the served weights.
            self._installed = (weights, d_weights)
            prev = self.weights_version
            self.weights_version = s["version"]
            self._staged_swap = None
            stall = time.perf_counter() - s["staged_t"]
            self._c_swap_commits.inc()
            self._h_swap_stall.observe(stall)
            self.recorder.record("engine.swap_commit", version=s["version"], previous=prev,
                                 mode=s["mode"], stall_s=stall)
            if self.trace_sink is not None:
                # Every request still queued admits under the new version.
                for r in self._queue:
                    self.trace_sink.instant(r.rid, "swap_pin", replica=self.trace_replica,
                                            version=s["version"], previous=prev, stall_s=stall)
        return True

    # --- disaggregated prefill/decode handoff --------------------------------

    def _check_handoff_supported(self, what: str):
        if self._speculative:
            raise ValueError(f"{what}: speculative engines are not supported: the draft cache "
                             "would have to ride the handoff in lockstep")
        if self._paged:
            raise ValueError(f"{what}: paged engines are not supported: rows live behind "
                             "host-owned block tables, not contiguous cache rows")

    def ensure_cache(self, params, draft_params=None):
        """Create the engine's zeroed KV cache without admitting work, as
        ``ingest_kv`` and ``kv_row_shardings`` need it before the first row
        lands (``cache_creations`` counts it); a no-op when it exists. The
        port allocates its cache with no model call, so ``params`` (JAX's
        signature) are not read; ``draft_params`` are checked."""
        self._check_draft_args(draft_params)
        if self._cache is None:
            with torch.no_grad():
                self._ensure_cache()
                if self._paged:
                    self._set_tables()

    def _need_cache(self, what: str):
        if self._cache is None:
            raise RuntimeError(f"{what}: the engine holds no cache yet; call "
                               "ensure_cache(params) first")

    def _row_tree(self, leaf) -> dict:
        """``leaf(tensor)`` over the cache's leaves, in the tree ``export_kv``
        returns: ``{"layers": [{"key", "value", "index"[, "key_scale",
        "value_scale"]}, ...], "position"}``."""
        def layer(kv):
            out = {"key": leaf(kv.key), "value": leaf(kv.value), "index": leaf(kv.index)}
            if kv.key_scale is not None:
                out.update(key_scale=leaf(kv.key_scale), value_scale=leaf(kv.value_scale))
            return out

        return {"layers": [layer(kv) for kv in self._cache.layers],
                "position": leaf(self._cache.position)}

    def _row_sharding(self, x):
        """The layout of one row of cache leaf ``x`` (its dim 0, the batch or
        a pool's pages, dropped): a DTensor's spec without its first entry;
        over a mesh a plain (whole, equal on every rank) leaf's row is
        replicated; on one device the engine's device."""
        if isinstance(x, DTensor):
            spec = placements_to_spec(x.device_mesh, x.placements, x.ndim)
            return NamedSharding(x.device_mesh, P(*tuple(spec)[1:]))
        if self._mesh is not None:
            return NamedSharding(self._mesh, P())
        return sharding_of(x)

    @staticmethod
    def _row_placements(placements):
        return [Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > 0 else Replicate()
                for pl in placements]

    def _row(self, x, i: int, *, clone: bool = True):
        """Row ``i`` of cache leaf ``x`` in its row layout
        (:meth:`_row_sharding`). A DTensor's row comes from the ranks holding
        it: along a mesh axis that splits dim 0 it is broadcast from its
        holder in that axis' own group. ``clone=False`` may return a view."""
        if not isinstance(x, DTensor):
            row = x[i].clone() if clone else x[i]
            if self._mesh is None:
                return row
            return DTensor.from_local(row, self._mesh, [Replicate()] * self._mesh.ndim,
                                      run_check=False)
        mesh, pls = x.device_mesh, x.placements
        local, coord = x.to_local(), list(mesh.get_coordinate())
        boxes = devices_indices_map(sharding_of(x), x.shape)
        holder = next(r for r, box in boxes.items() if box[0].start <= i < box[0].stop)
        owner = [int(c) for c in (mesh.mesh == holder).nonzero()[0]]
        mine = boxes[dist.get_rank()][0]
        splits = [m for m, pl in enumerate(pls) if isinstance(pl, Shard) and pl.dim == 0]
        if mine.start <= i < mine.stop:
            row = local[i - mine.start]
            row = row.clone() if clone or splits else row
        else:
            row = torch.empty(local.shape[1:], dtype=local.dtype, device=local.device)
        for m in splits:
            src = list(coord)
            src[m] = owner[m]
            dist.broadcast(row, src=int(mesh.mesh[tuple(src)]), group=mesh.get_group(m))
        shape = x.shape[1:]
        return DTensor.from_local(row, mesh, self._row_placements(pls), run_check=False,
                                  shape=shape, stride=torch.empty(shape, device="meta").stride())

    def _write_row(self, x, i: int, row):
        """Write ``row`` into row ``i`` of cache leaf ``x`` in place. Over a
        mesh a row in ``kv_row_shardings``' layout is a local copy on each
        rank holding row ``i``; a row in another layout of the mesh is
        redistributed first, a whole plain row sliced."""
        if not isinstance(x, DTensor):
            if isinstance(row, DTensor):
                row = row.full_tensor()
            x[i].copy_(row)
            return
        mesh = x.device_mesh
        want = self._row_placements(x.placements)
        if isinstance(row, DTensor):
            if list(row.placements) != want:
                row = row.redistribute(mesh, want)
            local_row = row.to_local()
        else:
            local_row = local_slice(torch.as_tensor(row), mesh, want)
        box = devices_indices_map(sharding_of(x), x.shape)[dist.get_rank()][0]
        if box.start <= i < box.stop:
            x.to_local()[i - box.start].copy_(local_row)

    def kv_row_shardings(self) -> dict:
        """Per-leaf layout of ONE cache row, the batch dim dropped, in
        ``export_kv``'s tree: the destination a KV transfer plan reshards
        into (``fleet.kv_transfer.transfer_tree``). A row delivered in this
        layout makes ``ingest_kv`` a local copy on every rank."""
        self._need_cache("kv_row_shardings")
        return self._row_tree(self._row_sharding)

    def kv_row_seq_dims(self) -> dict:
        """Per-leaf SEQUENCE dim of one cache row (``-1``: none, move the leaf
        whole), in ``export_kv``'s tree, for the transfer plan's
        valid-length clipping. Read off the row shapes, never assumed: the
        dense backend's rows are ``(L, N_kv, H)``, the blocked backend's
        ``(N_kv, L, H)``; a row dim is the sequence dim iff it is the one
        dim of size ``max_seq_len``, and an ambiguous row moves whole."""
        self._need_cache("kv_row_seq_dims")
        s = self._cfg.max_seq_len

        def leaf(x):
            if x.ndim < 2:
                return -1
            hits = [d for d, n in enumerate(tuple(x.shape[1:])) if n == s]
            return hits[0] if len(hits) == 1 else -1

        return self._row_tree(leaf)

    def export_kv(self, rid: int):
        """The prefill half of the disaggregated handoff: ``(rows, length)``
        for a request that retired here, ``rows`` every cache leaf's row of
        the slot it held (the per-row counters included; in
        :meth:`kv_row_shardings`' layout of this engine), ``length`` the
        row's valid length (``prompt + generated - 1``: the last emitted
        token was never written back), which bounds the transfer plan. Valid
        until a later admission reuses the slot: export right after the
        ``step()`` that retired the request. Books ``kv_handoff``."""
        self._check_handoff_supported("export_kv")
        slot = self._export_ok.get(rid)
        if slot is None:
            raise KeyError(f"request {rid} is not exportable: it never retired here, or its "
                           "slot was already reused by a later admission")
        if self._cache is None:
            raise RuntimeError("export_kv: the engine holds no cache")
        with self.ledger.measure("kv_handoff"), torch.no_grad():
            rows = self._row_tree(lambda x: self._row(x, slot))
            length = max(0, self._plen[slot] + self._emitted[slot] - 1)
            self._c_kv_exports.inc()
            self.recorder.record("engine.kv_export", rid=rid, slot=slot, length=length)
        return rows, length

    def ingest_kv(self, params, prompt, first_token, rows, *, rid: int,
                  deadline_s: float | None = None, arrival_t: float | None = None,
                  admit_t: float | None = None, first_token_t: float | None = None,
                  tenant: str | None = None) -> int:
        """The decode half of the handoff: occupy a free slot with a request
        whose prefill ran on another engine. Writes the transferred cache
        ``rows`` (an ``export_kv`` tree, in :meth:`kv_row_shardings`' layout
        after ``transfer_tree``), sets the row's counters to the prompt
        length, and marks it decoding with ``first_token`` pending; the
        request then advances through ``step()``. Greedy and sampled tokens
        equal one engine's serve of the whole request (the rows hold the
        bytes this engine's prefill would have written; every draw is keyed
        by (request id, generated position)). The ``*_t`` stamps carry the
        request's original clock across the handoff. Returns the slot;
        raises ``RuntimeError`` when no slot is free. Books
        ``kv_handoff``."""
        self._check_handoff_supported("ingest_kv")
        with self.ledger.measure("kv_handoff"), torch.no_grad():
            p = np.asarray(prompt, np.int32).reshape(-1)
            self._validate_prompt(p)
            if (rid in self._finished or rid in self._req
                    or any(r.rid == rid for r in self._queue)):
                raise ValueError(f"request id {rid} already in use")
            self._next_rid = max(self._next_rid, rid + 1)
            slot = next((s for s in range(self._b) if self._req[s] < 0), None)
            if slot is None:
                raise RuntimeError("ingest_kv: no free slot; poll free_slots() before "
                                   "transferring")
            self.ensure_cache(params)
            if len(rows["layers"]) != len(self._cache.layers):
                raise ValueError(f"ingest_kv: {len(rows['layers'])} layers of rows for a "
                                 f"cache of {len(self._cache.layers)}")
            n = int(p.size)
            for kv, row in zip(self._cache.layers, rows["layers"]):
                for name in _PAGE_LEAF_KEYS:
                    if getattr(kv, name) is not None:
                        self._write_row(getattr(kv, name), slot, row[name])
                kv.index[slot] = n
            self._cache.position[slot] = n
            now = time.perf_counter()
            r = _Request(rid=rid, prompt=p, arrival_t=now if arrival_t is None else arrival_t,
                         deadline_s=deadline_s, version=self.weights_version, tenant=tenant,
                         enqueue_t=now, ingested=True)
            r.admit_t = now if admit_t is None else admit_t
            r.first_token_t = now if first_token_t is None else first_token_t
            if deadline_s is not None:
                self._any_req_deadline = True
            self._export_ok = {k: v for k, v in self._export_ok.items() if v != slot}
            self._slot_req[slot] = r
            self._req[slot] = rid
            self._plen[slot] = n
            self._pending[slot] = np.zeros((0,), np.int32)
            self._emitted[slot] = 1
            self._out[slot] = list(p) + [int(first_token)]
            self._ttimes[slot] = [r.first_token_t]
            self._tok[slot] = int(first_token)
            self._needs_reset[slot] = False
            self._reset_to[slot] = 0
            self._c_requests.inc()
            self._c_kv_ingests.inc()
            self.tracer.async_begin("request", rid, prompt_len=n, slot=slot)
            self.recorder.record("engine.kv_ingest", rid=rid, slot=slot, length=n)
            if (self._eos is not None and int(first_token) == self._eos) or self._max_new <= 1:
                self._retire(slot, now, [])       # the first token ends it
            else:
                self._active[slot] = True
                self._g_active.set(int(self._active.sum()))
        return slot

    # --- the KV tier: the prefix digest, page spill and fill -----------------

    @staticmethod
    def prefix_hash(key: bytes) -> bytes:
        """The 8-byte hash of one registry key (page-aligned token-prefix
        bytes): the unit :meth:`prefix_digest` exports."""
        return hashlib.blake2b(key, digest_size=8).digest()

    def prefix_digest(self) -> tuple[int, frozenset]:
        """``(epoch, hashes)``: one :meth:`prefix_hash` per registered
        page-aligned token prefix, for prefix-aware placement. ``epoch``
        (``prefix_epoch``) bumps on every registry key change, so a digest
        is valid while its epoch matches; the memo answers repeated
        queries at once."""
        if not (self._paged and self._prefix):
            return (self.prefix_epoch, frozenset())
        if self._digest_cache is None or self._digest_cache[0] != self.prefix_epoch:
            self._digest_cache = (self.prefix_epoch, frozenset(
                self.prefix_hash(k) for k in self._prefix_registry))
        return self._digest_cache

    def retained_prefixes(self) -> list[bytes]:
        """Registry keys of the reference-free retained pages, oldest (the
        LRU's eviction order) first: the tier's demotion candidates. Pages
        shared by live slots are not listed."""
        if not (self._paged and self._prefix):
            return []
        return [self._key_of_page[pid] for pid in self._cached_lru if pid in self._key_of_page]

    def touch_prefix(self, key: bytes) -> bool:
        """Refresh a resident reference-free prefix page in the LRU (a tier
        touches a chain's resident ancestors before promoting its missing
        descendants, so the promotion cannot evict them). False when the
        key is not registered or its page is shared by a live slot."""
        if not (self._paged and self._prefix):
            return False
        pid = self._prefix_registry.get(key)
        if pid is None or pid not in self._cached_lru:
            return False
        self._cached_lru.pop(pid)
        self._cached_lru[pid] = None
        return True

    def _check_tier_supported(self, what: str):
        if not (self._paged and self._prefix):
            raise RuntimeError(f"{what} requires a paged engine with prefix_cache=True")
        if self._speculative:
            # A speculative engine's page holds target and draft K/V under
            # one id: moving the target's alone would corrupt the draft's.
            raise RuntimeError(f"{what}: speculative engines are not tiered")

    def _page_leaves(self) -> list:
        """The page-pool leaves, layer by layer in ``_PAGE_LEAF_KEYS`` order:
        the order of ``spill_page``'s rows."""
        return [getattr(kv, name) for kv in self._cache.layers for name in _PAGE_LEAF_KEYS
                if getattr(kv, name) is not None]

    def _page_row_shardings(self) -> list:
        """The layout of one page row of each page leaf (the pool dim
        dropped), in ``spill_page``'s order: what a fill reshards into."""
        return [self._row_sharding(x) for x in self._page_leaves()]

    def spill_page(self, key: bytes, *, drop: bool = True, base_rows=None):
        """Demote one retained prefix page out of device memory: its K/V rows
        move to host memory through the counted ``parallel.resharding`` plan
        (every rank of a mesh receives the whole rows; the bytes book
        ``kv_handoff``). ``drop=True`` frees the page and takes its key out
        of the registry; ``drop=False`` reads it and leaves it (a peer
        copying a warm page). → ``(rows, stats)``: the host page rows (CPU
        tensors; ``fill_page``'s input) and ``{"bytes", "raw_bytes",
        "segments"}``. ``base_rows``, the delta codecs' reference, comes
        with slice F."""
        if base_rows is not None:
            raise NotImplementedError("base_rows: ported with slice F (parallel/compression.py)")
        self._check_tier_supported("spill_page")
        pid = self._prefix_registry.get(key)
        if pid is None:
            raise KeyError("spill_page: key not in the prefix registry")
        if drop and pid not in self._cached_lru:
            raise RuntimeError("spill_page(drop=True): page is shared by live slots; it "
                               "cannot leave the device mid-request")
        if self._cache is None:
            raise RuntimeError("spill_page: the engine holds no cache")
        with self.ledger.measure("kv_handoff"), torch.no_grad():
            rows, nbytes, nsegs = [], 0, 0
            for x in self._page_leaves():
                row = self._row(x, pid, clone=False)
                src = sharding_of(row)
                pkey = (tuple(row.shape), str(row.dtype), src, "spill", None)
                plan = self._page_plan_cache.get(pkey)
                if plan is None:
                    plan = self._page_plan_cache[pkey] = plan_transfer(
                        row.shape, row.element_size(), src, HostBuffer(), seq_dim=None,
                        page_tokens=None)
                buf, stats = execute_transfer(plan, row)
                rows.append(buf)
                nbytes += stats["bytes"]
                nsegs += stats["segments"]
            if drop:
                del self._cached_lru[pid]
                del self._prefix_registry[self._key_of_page.pop(pid)]
                del self._refcnt[pid]
                self._free_pages.append(pid)
                self.prefix_epoch += 1
                self._update_high_water()
            self._c_pg_spills.inc()
            self._c_pg_bytes_out.inc(nbytes)
            self._c_kv_raw_bytes.inc(nbytes)
            self._g_comp_ratio.set(1.0)
            self.recorder.record("engine.kv_page_spill", pid=pid, bytes=nbytes,
                                 raw_bytes=nbytes, segments=nsegs, dropped=drop)
        return rows, {"bytes": nbytes, "raw_bytes": nbytes, "segments": nsegs}

    def fill_page(self, key: bytes, rows) -> dict:
        """Promote a spilled page back into device memory: take a page (which
        may evict a colder retained one), move the host ``rows`` into this
        cache's page-row layout through the counted plan, write them in, and
        register ``key`` as a reference-free retained page, newest in the
        LRU. The next admission whose prompt chain reaches ``key`` maps it
        like any resident prefix page. → ``{"bytes", "raw_bytes",
        "segments", "pid"}``. Raises ``ValueError`` if ``key`` is resident
        (check the digest first)."""
        self._check_tier_supported("fill_page")
        if key in self._prefix_registry:
            raise ValueError("fill_page: key is already resident")
        if self._cache is None:
            raise RuntimeError("fill_page: the engine holds no cache; ensure_cache() or "
                               "serve a request first")
        leaves = self._page_leaves()
        if len(rows) != len(leaves):
            raise ValueError(f"fill_page: {len(rows)} rows for {len(leaves)} page leaves")
        with self.ledger.measure("kv_handoff"), torch.no_grad():
            with self.ledger.measure("page_alloc"):
                pid = self._take_page()
            nbytes = nsegs = 0
            for x, buf in zip(leaves, rows):
                buf = buf if isinstance(buf, torch.Tensor) else torch.from_numpy(np.asarray(buf))
                dst = self._row_sharding(x)
                pkey = (tuple(buf.shape), str(buf.dtype), dst, "fill", None)
                plan = self._page_plan_cache.get(pkey)
                if plan is None:
                    plan = self._page_plan_cache[pkey] = plan_transfer(
                        buf.shape, buf.element_size(), HostBuffer(), dst, seq_dim=None,
                        page_tokens=None)
                out, stats = execute_transfer(plan, buf)
                self._write_row(x, pid, out)
                nbytes += stats["bytes"]
                nsegs += stats["segments"]
            self._prefix_registry[key] = pid
            self._key_of_page[pid] = key
            self._refcnt[pid] = 0
            self._cached_lru[pid] = None
            self.prefix_epoch += 1
            self._update_high_water()
            self._c_pg_fills.inc()
            self._c_pg_bytes_in.inc(nbytes)
            self._c_kv_raw_bytes.inc(nbytes)
            self._g_comp_ratio.set(1.0)
            self.recorder.record("engine.kv_page_fill", pid=pid, bytes=nbytes,
                                 raw_bytes=nbytes, segments=nsegs)
        return {"bytes": nbytes, "raw_bytes": nbytes, "segments": nsegs, "pid": pid}

    # The introspection of slice G.
    compile_counts = _not_ported("compile_counts", "slice G (introspection)")
    collective_inventory = _not_ported("collective_inventory", "slice G (introspection)")
    program_hlo = _not_ported("program_hlo", "slice G (introspection)")
    check_contracts = _not_ported("check_contracts", "slice G (introspection)")
    explain_collectives = _not_ported("explain_collectives", "slice G (introspection)")
    overlap_report = _not_ported("overlap_report", "slice G (introspection)")
    comm_report = _not_ported("comm_report", "slice G (introspection)")
    collective_axis_volume = _not_ported("collective_axis_volume", "slice G (introspection)")
    dump_diagnostics = _not_ported("dump_diagnostics", "slice G (introspection)")


def make_continuous_engine(config: TransformerConfig, mesh=None, rules=None, **kwargs):
    """Build a persistent :class:`ContinuousEngine` and return its one-shot
    entry ``serve(params, prompts, rng=None, draft_params=None) ->
    list[np.ndarray]``. The engine is ``serve.engine``; after each call
    ``serve.last_stats`` / ``serve.last_latency`` mirror the engine's.
    ``mesh``/``rules``: the engine over a mesh (every rank builds and calls
    it alike; see :class:`ContinuousEngine`)."""
    engine = ContinuousEngine(config, mesh, rules, **kwargs)

    def serve(params, prompts, rng=None, draft_params=None):
        try:
            return engine.serve(params, prompts, rng=rng, draft_params=draft_params)
        finally:
            serve.last_stats = engine.last_stats
            serve.last_latency = engine.last_latency

    serve.engine = engine
    serve.last_stats = None
    serve.last_latency = None
    return serve
