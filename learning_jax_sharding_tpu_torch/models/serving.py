"""Continuous batching: a persistent engine serving requests over time.

Port of ``learning_jax_sharding_tpu/models/serving.py`` on one device:
:class:`ContinuousEngine` and :func:`make_continuous_engine` with greedy
decoding, the split refill/decode scheduler, the paged KV cache and the
prefix cache. The names, arguments, errors and bookkeeping follow the JAX
engine; the allocator, prefix cache and scheduler are host code ported
almost line for line.

A fixed batch of cache slots serves a request queue: a finished row's slot
is refilled with the next queued prompt while the other rows keep their
state. Each :meth:`ContinuousEngine.step` admits queued requests into idle
slots, then runs ONE dispatch:

* a **refill** when any slot has pending prompt tokens: a fixed ``(B,
  refill_chunk)`` chunk whose per-row valid length rides the ragged
  ``chunk_lengths`` (decoding and idle rows ride with 0), up to
  ``decode_chain`` chunks back to back with one host sync;
* else a **decode block** when any row is active: ``decode_block_steps``
  greedy steps with ``tok``, ``active`` and ``remaining`` kept on the
  device (no host sync inside the block; rows freeze at EOS or at their
  budget and ride on with chunk length 0), up to ``decode_chain`` blocks
  chained with one sync.

Admission is a reset of the row's counters (``_reset_rows``): stale K/V
past a reset row's index is hidden by the causal-at-index masks and
overwritten as the new request writes.

``paged_pages``: each layer's K/V live in pools of ``paged_pages`` pages of
``page_size`` tokens (page 0 is scratch), reached through one ``(B,
max_seq_len // page_size)`` block table that this host loop owns: pages are
allocated as a row's index approaches them and freed when the request
retires, and the table is pushed to the device only when it changed.
``prefix_cache``: a retired request's prompt pages are kept under their
page-aligned token prefix, reference-counted, and mapped into a later
request whose prompt starts with the same tokens (the last prompt token is
always recomputed); reference-free pages are evicted LRU, chain tails before
their roots. Pool pressure preempts a request and recomputes it later, which
cannot change its tokens.

Device work is the model calls (``Transformer`` in decode mode, the blocked
backend on a GPU: decode attention's CUDA kernel, its paged mode with a
table); everything else here is host bookkeeping. Host arrays reach the card
through pinned buffers without blocking, so a chain of dispatches queues
back to back.

Not ported yet, each raising ``NotImplementedError`` naming what brings it:
sampling (``temperature > 0``), the mixed and multi-step schedulers,
speculative decoding, the recovery policies, multi-LoRA adapters,
communication compression and the telemetry objects (registry, tracer, SLO
monitor, flight recorder). ``last_stats`` and ``last_latency`` come from
plain host counters.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Mapping

import numpy as np
import torch

from learning_jax_sharding_tpu_torch import resolve_device
from learning_jax_sharding_tpu_torch.models.attention import resolve_decode_backend
from learning_jax_sharding_tpu_torch.models.decoding import (
    apply_dequantize_policy,
    check_sequence_budget,
    derive_decode_config,
    make_cached_apply,
    make_param_caster,
)
from learning_jax_sharding_tpu_torch.models.generate import vocab_limit_filter
from learning_jax_sharding_tpu_torch.models.transformer import (
    DecodeCache,
    Transformer,
    TransformerConfig,
)


@dataclasses.dataclass
class RequestFailure:
    """A request that retired without completing (status ``"shutdown"``:
    :meth:`ContinuousEngine.close` drained it), surfaced through
    ``pop_finished``; ``tokens`` holds the partial ``[prompt,
    generated...]`` output when it had been admitted."""

    rid: int
    status: str
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
    first_token_t: float | None = None
    finish_t: float | None = None
    tokens: np.ndarray | None = None      # final [prompt, generated...]
    status: str = "ok"                    # or shutdown
    error: str | None = None


#: Counters of one stats window (``reset_stats`` starts one).
_WINDOW = ("requests", "preemptions", "prefix_hits", "prefix_pages_reused",
           "refill_s", "decode_s", "stall_s", "refill_n", "decode_n")


class ContinuousEngine:
    """A persistent continuous-batching engine on one device.

    Construction builds the decode model and validates the configuration;
    the engine then serves any number of workloads, one-shot
    (``serve(params, prompts)``: outputs in queue order) or streaming
    (``add_request`` at any time, ``step(params)`` per scheduler iteration,
    ``pop_finished()``). The KV cache, page pool and prefix registry persist
    across calls: the cache is created by the first refill, once per engine
    (``cache_creations``), and prefix hits span calls. The registry keys
    pages by token bytes only, so call ``flush_prefix_cache()`` when the
    served params change.

    Each result is ``[prompt, generated...]``: generation stops at
    ``eos_id`` (included) or after ``max_new_tokens``. ``batch_size`` fixes
    the device batch (cache slots), ``refill_chunk`` the admission chunk
    (longer prompts stream through several refills), ``decode_block_steps``
    the greedy steps per decode dispatch, ``decode_chain`` (public, read at
    each dispatch) how many refill chunks or decode blocks go back to back
    with one host sync. ``dequantize`` serves quantized weights as
    ``make_generate_fn`` does (``"fused"``, ``"fused_w4a8"`` or ``True``);
    ``paged_pages`` / ``page_size`` / ``prefix_cache`` as in the module
    docstring. ``device=None`` means ``cuda``.

    ``model_forwards`` counts the model calls the engine issued (one per
    refill chunk and one per decode step), each a launch of decode
    attention per layer on the blocked backend.

    After each ``serve`` (and on demand through ``latency_stats()``):
    ``last_stats`` holds ``page_high_water`` (live pages, retained
    reference-free prefix pages apart), ``pages_total``, ``page_size``,
    ``preemptions`` and, with the prefix cache, ``prefix_hits``,
    ``prefix_pages_reused`` and ``prefix_pages_retained`` (``None``
    unpaged); ``last_latency`` the TTFT, TPOT, ITL, queue-wait and
    end-to-end p50/p99 in seconds and the refill share of dispatch time.
    """

    def __init__(
        self,
        config: TransformerConfig,
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
        # top_k / top_p / min_p and num_draft shape only sampling and
        # speculation, as in the JAX engine; greedy serving ignores them.
        later = {
            "temperature": (temperature > 0, "keyed per-request sampling"),
            "mixed": (mixed, "the mixed_step scheduler"),
            "token_budget": (token_budget is not None, "the mixed_step scheduler"),
            "horizon": (horizon != 1, "the multi_step horizon"),
            "draft_config": (draft_config is not None, "speculative decoding"),
            "draft_dequantize": (draft_dequantize, "speculative decoding"),
            "deadline_s": (deadline_s is not None, "the recovery policies"),
            "max_queue": (max_queue is not None, "the recovery policies"),
            "degradation": (degradation is not None, "the recovery policies"),
            "max_dispatch_strikes": (max_dispatch_strikes != 2, "the recovery policies"),
            "adapter_pool": (adapter_pool is not None, "tenancy (swaps and adapters)"),
            "comm_compression": (comm_compression is not None, "slice F (compression)"),
            "registry": (registry is not None, "slice E (telemetry)"),
            "tracer": (tracer is not None, "slice E (telemetry)"),
            "slo": (slo is not None, "slice E (telemetry)"),
            "recorder": (recorder is not None, "slice E (telemetry)"),
        }
        for name, (used, where) in later.items():
            if used:
                raise NotImplementedError(f"{name}: ported with {where}")
        if batch_size < 1 or refill_chunk < 1 or decode_block_steps < 1:
            raise ValueError("batch_size, refill_chunk, decode_block_steps must be >= 1")
        if decode_chain < 1:
            raise ValueError(f"decode_chain must be >= 1, got {decode_chain}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if refill_chunk > config.max_seq_len:
            raise ValueError(
                f"refill_chunk ({refill_chunk}) exceeds max_seq_len ({config.max_seq_len})"
            )
        if vocab_limit is not None and vocab_limit < 1:
            raise ValueError(f"vocab_limit must be >= 1, got {vocab_limit}")
        device = resolve_device(device)
        paged = paged_pages is not None
        if prefix_cache and not paged:
            raise ValueError(
                "prefix_cache requires the paged KV cache (paged_pages=N): "
                "sharing is expressed through block-table entries"
            )
        if paged:
            if paged_pages < 2:
                raise ValueError("paged_pages must be >= 2 (page 0 is the scratch page)")
            if resolve_decode_backend(config.decode_attention, device) != "blocked":
                raise ValueError(
                    "paged_pages requires the blocked decode backend for the target "
                    "config (decode_attention='blocked', or 'auto' on a GPU)"
                )
            if config.max_seq_len % page_size:
                raise ValueError(
                    f"target max_seq_len ({config.max_seq_len}) must be a multiple of "
                    f"page_size ({page_size})"
                )
        cfg = dataclasses.replace(derive_decode_config(config, inference_dtype),
                                  decode_ragged=True)
        cfg, fused = apply_dequantize_policy(cfg, dequantize)
        if paged:
            cfg = dataclasses.replace(cfg, decode_paged=True, decode_page_count=paged_pages,
                                      decode_block_k=page_size)
        self._model = Transformer(cfg, device=device).eval()
        self._in_apply = bool(dequantize) and not fused
        self._apply = make_cached_apply(self._model, dequantize=self._in_apply,
                                        dequant_dtype=cfg.param_dtype)
        self._maybe_cast = make_param_caster(inference_dtype, device,
                                             dequantize=bool(dequantize))

        self._device = device
        self._cfg = cfg
        self._b = batch_size
        self._max_new = max_new_tokens
        self._eos = eos_id
        self._vocab_limit = vocab_limit
        self._refill_chunk = refill_chunk
        self._block_steps = decode_block_steps
        self.decode_chain = decode_chain       # public, read at each dispatch
        self._paged = paged
        self._paged_pages = paged_pages
        self._page_size = page_size
        self._prefix = prefix_cache

        self.cache_creations = 0               # lifetime count of cache creations
        self.model_forwards = 0                # lifetime count of model calls
        self.last_stats: dict | None = None
        self.last_latency: dict | None = None
        self._cache: DecodeCache | None = None
        self._queue: deque[_Request] = deque()
        self._finished: dict[int, _Request] = {}
        self._next_rid = 0
        self._cast_src: Mapping | None = None
        self._cast_key: list | None = None
        self._cast_out: dict | None = None
        self._page_high = 0
        self._init_slots()
        if paged:
            self._init_pool()
        self.reset_stats()

    # --- state initialisation --------------------------------------------

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
        self._page_high = 0

    def reset_stats(self):
        """Start a stats window (``serve()`` calls this at entry; streaming
        users call it to start a measurement window)."""
        self._completed: list[dict] = []
        self._itl: list[float] = []
        self._win = dict.fromkeys(_WINDOW, 0)
        self._page_high = self._live_pages() if self._paged else 0

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
        now = time.perf_counter()
        for slot in range(self._b):
            if self._slot_req[slot] is not None:
                self._fail_slot(slot, "shutdown", "engine closed", now)
        while self._queue:
            self._fail_request(self._queue.popleft(), "shutdown", "engine closed", now=now)
        self._cache = None
        self._cast_src = self._cast_key = self._cast_out = None
        if self._paged:
            self._init_pool()

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
        for pid in list(self._cached_lru):
            del self._cached_lru[pid]
            del self._prefix_registry[self._key_of_page.pop(pid)]
            del self._refcnt[pid]
            self._free_pages.append(pid)
        self._update_high_water()

    # --- page allocator ----------------------------------------------------

    def _take_page(self) -> int:
        if self._free_pages:
            return self._free_pages.pop()
        if self._cached_lru:
            # Evict the oldest reference-free cached page: the pool serves
            # live requests before retained ones.
            pid = next(iter(self._cached_lru))
            del self._cached_lru[pid]
            del self._prefix_registry[self._key_of_page.pop(pid)]
            del self._refcnt[pid]
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
        self._page_high = max(self._page_high, self._live_pages())

    def _ensure(self, slot: int, tokens_through: int):
        # Map positions [0, tokens_through) before the dispatch that writes
        # them.
        need = -(-int(tokens_through) // self._page_size)
        if len(self._held[slot]) >= need:
            return   # steady-state decode mostly allocates nothing
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
        # Push the host table into the cache's one block table, only when an
        # allocation or release changed it since the last push.
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
        check_sequence_budget(
            p.size + self._max_new, self._cfg.max_seq_len,
            f"prompt ({p.size}) + max_new_tokens ({self._max_new}) for target",
        )

    @staticmethod
    def _check_draft_args(draft_params):
        if draft_params is not None:
            raise ValueError("draft_params requires draft_config")

    def _cast_params(self, params):
        # The inference cast (and the load into the model) runs once per
        # params object and tensor state, not once per step; the
        # dequantize-per-call mode keeps the cast tree and hands it to every
        # model call. Torch updates parameters in place, and a state_dict()
        # aliases them, so the same dict can hold new weights: each tensor's
        # identity and in-place version counter key the cast (host reads
        # only, no device work).
        key = [(t, _tensor_state(t)) for t in params.values()]
        if self._cast_src is params and _same_tensors(key, self._cast_key):
            return self._cast_out
        weights = self._maybe_cast(params)
        if not self._in_apply:
            self._model.load_state_dict(weights)
            weights = None
        self._cast_src, self._cast_key, self._cast_out = params, key, weights
        return weights

    def add_request(self, prompt, *, rid: int | None = None, arrival_t: float | None = None,
                    deadline_s: float | None = None, adapter: str | None = None,
                    tenant: str | None = None) -> int:
        """Enqueue one request and return its id, the key ``pop_finished()``
        reports it under; admission happens in a later ``step()``.
        ``arrival_t`` (a ``time.perf_counter`` stamp) keeps an earlier
        arrival clock for the latency telemetry."""
        for name, value, where in (("deadline_s", deadline_s, "the recovery policies"),
                                   ("adapter", adapter, "tenancy (swaps and adapters)"),
                                   ("tenant", tenant, "slice E (telemetry)")):
            if value is not None:
                raise NotImplementedError(f"{name}: ported with {where}")
        p = np.asarray(prompt, np.int32).reshape(-1)
        self._validate_prompt(p)
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
        self._queue.append(_Request(rid=rid, prompt=p,
                                    arrival_t=now if arrival_t is None else arrival_t))
        self._win["requests"] += 1
        return rid

    def has_work(self) -> bool:
        return bool(self._queue) or any(r >= 0 for r in self._req)

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
        self._itl.extend(b - a for a, b in zip(times, times[1:]))
        self._completed.append(dict(
            rid=r.rid, prompt_len=int(r.prompt.size), generated=n,
            queue_wait=r.admit_t - r.arrival_t,
            ttft=r.first_token_t - r.arrival_t if r.first_token_t is not None else None,
            e2e=now - r.arrival_t,
            tpot=(now - r.first_token_t) / (n - 1) if n > 1 else None,
        ))
        self._finished[r.rid] = r
        retired.append(r.rid)
        self._free_slot(slot)
        if self._paged:
            self._release(slot)

    def _free_slot(self, slot: int):
        self._slot_req[slot] = None
        self._req[slot] = -1
        self._active[slot] = False

    def _fail_request(self, r: _Request, status: str, error: str, *, now=None, tokens=None):
        """Retire ``r`` with a terminal non-ok status, surfaced through
        ``pop_finished`` as a :class:`RequestFailure`."""
        r.status, r.error = status, error
        r.finish_t = time.perf_counter() if now is None else now
        if tokens is not None:
            r.tokens = tokens
        self._finished[r.rid] = r

    def _fail_slot(self, slot: int, status: str, error: str, now=None):
        """Fail the request in ``slot`` (partial output kept) and free it;
        its pages are never registered."""
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
        """Recompute preemption under pool pressure: push the slot's request
        back to the queue head and free the slot. The request restarts from
        scratch on a later admission, and greedy decoding re-derives exactly
        the tokens it had."""
        self._queue.appendleft(self._slot_req[slot])
        if self._paged:
            self._release(slot, register=False)
        self._free_slot(slot)
        self._clear_admission(slot)

    def _admit(self):
        now = time.perf_counter()
        for slot in range(self._b):
            if self._req[slot] >= 0 or not self._queue:
                continue
            r = self._queue.popleft()
            # A preempted request keeps its first admission time and counts
            # its prefix hit once.
            first_admission = r.admit_t is None
            if first_admission:
                r.admit_t = now
            prompt = r.prompt
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
                # matches; the last prompt token is always recomputed (its
                # logits seed generation).
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
                        self._win["prefix_hits"] += 1
                        self._win["prefix_pages_reused"] += len(shared)
                    self._update_high_water()

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """``(B, V)`` logits → ``(B,)`` int32 argmax (ids ≥ ``vocab_limit``
        masked)."""
        logits = logits.float()
        if self._vocab_limit is not None:
            logits = vocab_limit_filter(logits, self._vocab_limit)
        return logits.argmax(dim=-1).to(torch.int32)

    def _forward(self, weights, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """One model call over the engine's cache → fp32 logits."""
        logits, _ = self._apply(self._cache, tokens, lengths, params=weights)
        self.model_forwards += 1
        return logits

    def _refill_step(self, weights, chunk, lengths, reset, reset_to) -> torch.Tensor:
        """Admission resets, then one ``(B, refill_chunk)`` chunk: every row's
        cache advances by its own valid length (0 for decoding or idle rows).
        → each row's first generated token (device), from its chunk's last
        valid position."""
        lengths_d = self._to_device(lengths)
        _reset_rows(self._cache, self._to_device(reset), self._to_device(reset_to))
        logits = self._forward(weights, self._to_device(chunk), lengths_d)
        rows = torch.arange(self._b, device=self._device)
        return self._greedy(logits[rows, (lengths_d.long() - 1).clamp(min=0)])

    def _decode_block(self, weights, tok, active, remaining):
        """``decode_block_steps`` greedy steps, on the device with no host
        sync. Rows that emit EOS or spend their ``remaining`` budget flip
        inactive: chunk length 0 from then on, so a retired row's cache
        index never passes its admission budget. → ``(B, K)`` tokens and the
        carries."""
        toks = []
        for _ in range(self._block_steps):
            logits = self._forward(weights, tok[:, None], active)
            nxt = torch.where(active == 1, self._greedy(logits[:, -1]), tok)
            remaining = remaining - active
            if self._eos is not None:
                active = active * (nxt != self._eos).to(torch.int32)
            active = active * (remaining > 0).to(torch.int32)
            toks.append(nxt)
            tok = nxt
        return torch.stack(toks, dim=1), active, remaining

    def _refill_dispatch(self, weights, retired: list[int]) -> bool:
        # One refill chunk for every slot with pending prompt tokens;
        # decoding rows ride along with length 0. Up to ``decode_chain``
        # chunks back to back, one host sync per chunk at the end: chunk
        # contents are host-known, so no chunk waits on another's readback.
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
            if self._paged:
                for slot in range(b):
                    if not lengths[slot]:
                        continue
                    consumed = self._plen[slot] - self._pending[slot].size
                    try:
                        self._ensure(slot, consumed + int(lengths[slot]))
                    except RuntimeError:
                        # Backpressure instead of a wedge: while another slot
                        # is in flight its retirement will free pages, so
                        # requeue this request; raise only when it is alone.
                        if not any(self._req[s] >= 0 for s in range(b) if s != slot):
                            raise
                        self._unadmit(slot)
                        self._win["preemptions"] += 1
                        lengths[slot] = 0
                        chunk[slot, :] = 0
                if not lengths.any():
                    break
            if self._cache is None:
                self._cache = self._model.init_cache(b)
                self.cache_creations += 1
            if self._paged:
                self._set_tables()
            tok_new = self._refill_step(weights, chunk, lengths, self._needs_reset,
                                        self._reset_to)
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
        for tok_new, completes in segs:
            tok_new = tok_new.cpu().numpy()        # each chunk's own sync
            now = time.perf_counter()              # its host-visibility time
            for slot in completes:
                # Prompt complete: its first token came from this chunk.
                t = int(tok_new[slot])
                self._out[slot].append(t)
                self._emitted[slot] = 1
                self._tok[slot] = t
                self._slot_req[slot].first_token_t = now
                self._ttimes[slot].append(now)
                if (self._eos is not None and t == self._eos) or self._max_new == 1:
                    self._retire(slot, now, retired)
                else:
                    self._active[slot] = True
        return True

    def _decode_dispatch(self, weights, retired: list[int]) -> bool:
        # Up to ``decode_chain`` decode blocks back to back, the carries
        # flowing device to device, ONE host sync at the end. A retiring
        # slot idles until that sync (admission coarsens by up to a chain);
        # results cannot change. Returns whether a dispatch ran.
        if not self._active.any():
            return False
        b = self._b
        remaining = np.asarray([max(0, self._max_new - e) for e in self._emitted], np.int32)
        # Never dispatch blocks that cannot emit: cap the chain at what the
        # longest-running active row can still use.
        worst = int(remaining[self._active].max())
        chain = min(self.decode_chain, -(-worst // self._block_steps))
        if self._paged:
            # Map every position this chain can write: chain·K new tokens a
            # row, capped by its remaining budget.
            for slot in range(b):
                if not self._active[slot]:
                    continue
                pos = self._plen[slot] + self._emitted[slot] - 1
                span = min(int(remaining[slot]), chain * self._block_steps)
                try:
                    self._ensure(slot, pos + span)
                except RuntimeError:
                    # Decode-time recompute preemption, unless this row is
                    # the only request holding pages (it can never fit).
                    if not any(self._req[s] >= 0 for s in range(b) if s != slot):
                        raise
                    self._unadmit(slot)
                    self._win["preemptions"] += 1
            if not self._active.any():
                return False
            self._set_tables()
            # Re-cap the chain from the surviving rows.
            worst = int(remaining[self._active].max())
            chain = min(self.decode_chain, -(-worst // self._block_steps))
        tok = self._to_device(self._tok)
        active = self._to_device(self._active.astype(np.int32))
        remaining_d = self._to_device(remaining)
        segs = []
        for _ in range(chain):
            toks, active, remaining_d = self._decode_block(weights, tok, active, remaining_d)
            # Next block's pending token: each row's last emitted (frozen
            # rows repeat theirs).
            tok = toks[:, -1]
            segs.append(toks)
        segs = [t.cpu().numpy() for t in segs]     # ONE sync
        now = time.perf_counter()
        was_active = self._active.copy()
        for toks in segs:
            for slot in range(b):
                # A slot retired in an earlier block emits nothing real in
                # later ones: its lane froze on the device.
                if was_active[slot] and self._req[slot] >= 0:
                    self._consume(slot, toks[slot].tolist(), now, retired)
        return True

    def step(self, params=None, draft_params=None) -> list[int]:
        """ONE scheduler iteration: admit queued requests into idle slots,
        then one dispatch: a refill if any slot has pending prompt tokens,
        else a decode block if any row is active, else nothing. Returns the
        ids of the requests that finished in this step (their outputs wait
        in ``pop_finished()``)."""
        if params is None:
            raise TypeError("step() without params: pass the params to serve")
        self._check_draft_args(draft_params)
        weights = self._cast_params(params)
        retired: list[int] = []
        with torch.no_grad():
            self._admit()
            had_active = bool(self._active.any())
            t0 = time.perf_counter()
            if self._refill_dispatch(weights, retired):
                dt = time.perf_counter() - t0
                self._win["refill_s"] += dt
                self._win["refill_n"] += 1
                if had_active:     # decoding rows sat idle behind this refill
                    self._win["stall_s"] += dt
            elif self._decode_dispatch(weights, retired):
                self._win["decode_s"] += time.perf_counter() - t0
                self._win["decode_n"] += 1
        return retired

    # --- stats -------------------------------------------------------------

    def latency_stats(self) -> dict | None:
        """Latency percentiles over the requests completed in the current
        stats window, in seconds, and the refill share of dispatch time."""
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
        w = self._win
        busy = w["refill_s"] + w["decode_s"]
        out.update(
            refill_s=w["refill_s"], decode_s=w["decode_s"],
            refill_frac=w["refill_s"] / busy if busy else None,
            decode_stall_s=w["stall_s"],
            decode_stall_share=w["stall_s"] / busy if busy else None,
            refill_dispatches=w["refill_n"], decode_dispatches=w["decode_n"],
        )
        if self._paged and self._prefix:
            out["prefix_hit_rate"] = w["prefix_hits"] / w["requests"] if w["requests"] else 0.0
        return out

    def _snapshot_stats(self):
        stats = None
        if self._paged:
            stats = dict(page_high_water=self._page_high, pages_total=self._paged_pages - 1,
                         page_size=self._page_size, preemptions=self._win["preemptions"])
            if self._prefix:
                stats.update(prefix_hits=self._win["prefix_hits"],
                             prefix_pages_reused=self._win["prefix_pages_reused"],
                             prefix_pages_retained=len(self._cached_lru))
        self.last_stats = stats
        self.last_latency = self.latency_stats()

    def serve(self, params, prompts, rng=None, draft_params=None) -> list:
        """Drain a whole queue: outputs in queue order, requests numbered by
        queue index. Requires an idle engine; the cache, pool and prefix
        registry carry over between calls. ``rng`` is accepted for the JAX
        signature; greedy decoding draws nothing."""
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
        self.reset_stats()
        # The per-call ids 0..n-1 must not collide with un-popped streaming
        # results: stash them and restore them after.
        stash, self._finished = self._finished, {}
        ok = False
        try:
            for i, p in enumerate(prompts):
                self.add_request(p, rid=i)
            while self.has_work():
                self.step(params)
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


def make_continuous_engine(config: TransformerConfig, mesh=None, rules=None, **kwargs):
    """Build a persistent :class:`ContinuousEngine` and return its one-shot
    entry ``serve(params, prompts, rng=None, draft_params=None) ->
    list[np.ndarray]``. The engine is ``serve.engine``; after each call
    ``serve.last_stats`` / ``serve.last_latency`` mirror the engine's.
    ``mesh``/``rules`` (the engine over a mesh) are ported with the rest of
    the engine (item 10)."""
    if mesh is not None:
        raise NotImplementedError(
            "the continuous engine over a mesh: ported with the rest of the engine (item 10)"
        )
    del rules
    engine = ContinuousEngine(config, **kwargs)

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
