"""Request-scoped trace context: a request's journey as one record.

Port of ``learning_jax_sharding_tpu/telemetry/tracecontext.py``. A trace id
is minted once per request (by the engine at ``add_request`` when a
:class:`TraceStore` is its ``trace_sink``) and every hop appends legs to
the same record, so each retired request yields

* a **critical-path decomposition**: queue → prefill → handoff → decode,
  with ``stall`` as the remainder the named stages cannot cover and
  ``wasted`` as work thrown away;
* per-stage histograms in the owning registry
  (``trace_stage_seconds{stage="queue"}`` ...);
* one **Perfetto timeline**: each replica a ``pid``, each request a
  ``tid`` row, instants as markers.

Timestamps are raw ``perf_counter`` values, the clock of the engine's
request stamps (``arrival_t``, ``admit_t``, ...), so producers hand their
stamps straight to :meth:`TraceStore.leg`. :func:`merge_tracers` rebases
several ``Tracer`` rings onto one epoch.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Iterable, Optional

#: The named critical-path stages, in journey order. ``stall`` is the
#: derived remainder; anything else a producer invents rides along.
STAGES = ("queue", "prefill", "handoff", "decode")


class TraceStore:
    """The fleet-wide (or engine-local) trace join point.

    One store per routing domain: the ``FleetRouter`` owns one and
    attaches it to every replica engine (``engine.trace_sink``); a solo
    engine given a store mints ids itself on first sight of a request.
    Keyed by ``rid`` — rids are unique within a domain and survive
    reroutes/requeues by design (the failover contract), which is
    exactly what makes the trace id stable across hops.

    ``auto_complete`` (default True, for solo engines): the engine
    finalizes a trace when it retires the request. The router sets it
    False and calls :meth:`complete` itself at ``_finish`` — in a
    disaggregated fleet the prefill replica also "retires" its one-token
    pass, which must append legs, not close the trace.
    """

    def __init__(
        self,
        *,
        registry: Any | None = None,
        auto_complete: bool = True,
        max_done: int = 4096,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self._clock = clock
        self._registry = registry
        self.auto_complete = auto_complete
        self._next = 0
        self._t0 = clock()
        self._recs: dict[Any, dict] = {}
        self._max_done = max_done
        self._done_order: list[Any] = []
        # Histogram handles cached at first completion: the registry's
        # get-or-create re-validates bucket edges per call, which at one
        # call per stage per retire is real money on the telemetry
        # budget.
        self._hists: dict[str, Any] = {}

    def _hist(self, key: str, name: str, help: str):
        h = self._hists.get(key)
        if h is None:
            h = self._registry.histogram(name, help)
            self._hists[key] = h
        return h

    # --- minting -----------------------------------------------------------

    def mint(
        self, rid: Any, *, arrival_t: float | None = None,
        tenant: str | None = None,
    ) -> str:
        """Mint (or return the existing) trace id for ``rid``.
        ``tenant`` labels the whole journey (cost attribution, tenant
        lanes in the Chrome export); like ``arrival_t`` it backfills an
        implicit mint — the router's canonical stamp wins either way."""
        rec = self._recs.get(rid)
        if rec is None:
            self._next += 1
            rec = {
                "trace_id": f"trace-{self._next:05d}",
                "rid": rid,
                "arrival_t": arrival_t,
                "tenant": tenant,
                "spans": [],
                "events": [],
                "done": False,
                "status": None,
                "finish_t": None,
            }
            self._recs[rid] = rec
        if arrival_t is not None and rec["arrival_t"] is None:
            rec["arrival_t"] = arrival_t
        if tenant is not None and rec.get("tenant") is None:
            rec["tenant"] = tenant
        return rec["trace_id"]

    def trace_of(self, rid: Any) -> str | None:
        rec = self._recs.get(rid)
        return rec["trace_id"] if rec else None

    def rids(self) -> list:
        return list(self._recs)

    # --- recording ---------------------------------------------------------

    def leg(
        self,
        rid: Any,
        stage: str,
        t0: float,
        t1: float,
        *,
        replica: str | None = None,
        **attrs: Any,
    ) -> None:
        """Append one span of the request's journey. ``t0``/``t1`` are
        raw ``perf_counter`` stamps; zero-length and clock-skewed legs
        are clipped to non-negative. Unknown rids mint implicitly (the
        solo-engine path)."""
        self.mint(rid)
        self._recs[rid]["spans"].append({
            "stage": stage,
            "t0": t0,
            "t1": max(t0, t1),
            "replica": replica,
            "attrs": attrs,
        })

    def instant(
        self,
        rid: Any,
        name: str,
        *,
        t: float | None = None,
        replica: str | None = None,
        **attrs: Any,
    ) -> None:
        """A point event on the trace (swap version pin, reroute,
        deadline sweep...)."""
        self.mint(rid)
        self._recs[rid]["events"].append({
            "name": name,
            "t": self._clock() if t is None else t,
            "replica": replica,
            "attrs": attrs,
        })

    def complete(
        self,
        rid: Any,
        *,
        status: str = "ok",
        finish_t: float | None = None,
    ) -> dict | None:
        """Close the trace: stamp status/finish, fold the critical path
        into the registry histograms. Idempotent — the first close wins
        (a late duplicate retire must not double-observe)."""
        rec = self._recs.get(rid)
        if rec is None or rec["done"]:
            return rec
        rec["done"] = True
        rec["status"] = status
        rec["finish_t"] = self._clock() if finish_t is None else finish_t
        self._done_order.append(rid)
        cp = self.critical_path(rid)
        if self._registry is not None and cp is not None:
            for stage in (*STAGES, "stall"):
                self._hist(
                    stage,
                    f'trace_stage_seconds{{stage="{stage}"}}',
                    "per-request critical-path seconds by stage",
                ).observe(cp["stages"].get(stage, 0.0))
            if cp["ttft_s"] is not None:
                self._hist(
                    "ttft", "trace_ttft_seconds",
                    "trace-derived time to first token",
                ).observe(cp["ttft_s"])
            self._hist(
                "e2e", "trace_e2e_seconds",
                "trace-derived end-to-end latency",
            ).observe(cp["e2e_s"])
        # Bound memory like every other ring in the stack: the OLDEST
        # finished traces age out, live ones never do.
        while len(self._done_order) > self._max_done:
            old = self._done_order.pop(0)
            self._recs.pop(old, None)
        return rec

    # --- analysis ----------------------------------------------------------

    def critical_path(self, rid: Any) -> dict | None:
        """The per-request decomposition. Stage seconds count only legs
        that WEREN'T thrown away (``wasted=True`` legs — a dead
        replica's partial compute — sum separately); ``stall`` is the
        e2e remainder no named stage covers: requeue gaps, swap drains,
        and that same wasted work as the user experienced it."""
        rec = self._recs.get(rid)
        if rec is None:
            return None
        spans = sorted(rec["spans"], key=lambda s: s["t0"])
        t_first = min((s["t0"] for s in spans), default=None)
        arrival = rec["arrival_t"] if rec["arrival_t"] is not None else t_first
        finish = rec["finish_t"]
        if finish is None:
            finish = max((s["t1"] for s in spans), default=arrival)
        stages: dict[str, float] = {}
        wasted = 0.0
        ttft = None
        for s in spans:
            dur = s["t1"] - s["t0"]
            if s["attrs"].get("wasted"):
                wasted += dur
                continue
            stages[s["stage"]] = stages.get(s["stage"], 0.0) + dur
            if s["stage"] == "prefill" and s["attrs"].get("first_token_t"):
                t = s["attrs"]["first_token_t"] - arrival
                ttft = t if ttft is None else min(ttft, t)
        e2e = max(0.0, (finish - arrival)) if arrival is not None else 0.0
        named = sum(stages.get(st, 0.0) for st in STAGES)
        stages["stall"] = max(0.0, e2e - named)
        return {
            "trace_id": rec["trace_id"],
            "rid": rid,
            "tenant": rec.get("tenant"),
            "status": rec["status"],
            "e2e_s": e2e,
            "ttft_s": ttft,
            "stages": stages,
            "wasted_s": wasted,
            "legs": len(spans),
            "reroutes": sum(
                1 for e in rec["events"] if e["name"] == "reroute"
            ),
            "swap_pins": [
                e["attrs"].get("version") for e in rec["events"]
                if e["name"] == "swap_pin"
            ],
        }

    def completed(self) -> list[dict]:
        """Critical paths of every completed trace, completion order."""
        out = []
        for rid in self._done_order:
            cp = self.critical_path(rid)
            if cp is not None:
                out.append(cp)
        return out

    def record(self, rid: Any) -> dict | None:
        """The raw trace record (spans + instants) — test/debug access."""
        return self._recs.get(rid)

    # --- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """One Perfetto timeline over every replica the store saw:
        replicas become named process tracks (``pid`` + process_name
        metadata), requests become ``tid`` rows within them, instants
        render as markers. Traces carrying a ``tenant`` label
        additionally mirror onto per-tenant process lanes AFTER the
        replica pids — "what did tenant X's traffic do, across every
        replica it touched" as one track; a tenant-less store emits
        exactly the pre-tenant document. Load at
        https://ui.perfetto.dev."""
        replicas: list[str] = []
        for rec in self._recs.values():
            for s in rec["spans"]:
                r = s["replica"] or "fleet"
                if r not in replicas:
                    replicas.append(r)
            for e in rec["events"]:
                r = e["replica"] or "fleet"
                if r not in replicas:
                    replicas.append(r)
        replicas.sort()
        pid_of = {r: i + 1 for i, r in enumerate(replicas)}
        tenants = sorted({
            rec["tenant"] for rec in self._recs.values()
            if rec.get("tenant")
        })
        tenant_pid = {
            t: len(replicas) + 1 + i for i, t in enumerate(tenants)
        }
        events: list[dict] = [
            {
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": f"replica {r}" if r != "fleet" else "fleet"},
            }
            for r, pid in pid_of.items()
        ] + [
            {
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": f"tenant {t}"},
            }
            for t, pid in tenant_pid.items()
        ]
        base = self._t0
        for rec in self._recs.values():
            tid = rec["rid"] if isinstance(rec["rid"], int) else (
                abs(hash(rec["rid"])) % 10_000
            )
            lane = tenant_pid.get(rec.get("tenant"))
            for s in rec["spans"]:
                ev = {
                    "name": s["stage"],
                    "ph": "X",
                    "ts": (s["t0"] - base) * 1e6,
                    "dur": (s["t1"] - s["t0"]) * 1e6,
                    "pid": pid_of[s["replica"] or "fleet"],
                    "tid": tid,
                    "args": {
                        "trace_id": rec["trace_id"], **s["attrs"],
                    },
                }
                events.append(ev)
                if lane is not None:
                    events.append({
                        **ev, "pid": lane,
                        "args": {
                            **ev["args"],
                            "replica": s["replica"] or "fleet",
                        },
                    })
            for e in rec["events"]:
                ev = {
                    "name": e["name"],
                    "ph": "i",
                    "s": "t",
                    "ts": (e["t"] - base) * 1e6,
                    "pid": pid_of[e["replica"] or "fleet"],
                    "tid": tid,
                    "args": {
                        "trace_id": rec["trace_id"], **e["attrs"],
                    },
                }
                events.append(ev)
                if lane is not None:
                    events.append({
                        **ev, "pid": lane,
                        "args": {
                            **ev["args"],
                            "replica": e["replica"] or "fleet",
                        },
                    })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"traces": len(self._recs)},
        }

    def dump_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def merge_tracers(
    tracers: dict[str, Any], *, extra_events: Iterable[dict] = (),
) -> dict:
    """Merge per-replica engine ``Tracer`` rings into one Perfetto trace.

    Each ``Tracer``'s event ``ts`` is microseconds since ITS OWN
    construction; merging rebases every ring onto the earliest tracer's
    epoch and assigns one ``pid`` (with a process_name metadata row) per
    replica, so the fleet's dispatch-level detail lands on the same
    timeline the :class:`TraceStore` request tracks use. ``extra_events``
    (e.g. ``TraceStore.chrome_trace()["traceEvents"]`` rebased by the
    caller, or anything already on the merged epoch) append verbatim.
    """
    t0s = {
        name: getattr(tr, "_t0", 0.0) for name, tr in tracers.items()
    }
    base = min(t0s.values(), default=0.0)
    events: list[dict] = []
    for i, (name, tr) in enumerate(sorted(tracers.items())):
        pid = i + 1
        # Deterministic track identity: pid from the sorted replica-name
        # order, process_sort_index matching it, and the tracer's own
        # metadata rows (process/thread names; tids are the tracer's
        # small first-seen indexes, not raw thread idents) — so the
        # merged fleet timeline sorts identically across runs in
        # Perfetto instead of interleaving by OS-assigned ids.
        meta = getattr(tr, "metadata_events", None)
        if meta is not None:
            rows = meta(pid=pid)
            for row in rows:
                if row["name"] == "process_name":
                    row["args"] = dict(row["args"], name=f"replica {name}")
            events.extend(rows)
        else:
            events.append({
                "name": "process_name", "ph": "M", "ts": 0.0, "pid": pid,
                "tid": 0, "args": {"name": f"replica {name}"},
            })
        events.append({
            "name": "process_sort_index", "ph": "M", "ts": 0.0, "pid": pid,
            "tid": 0, "args": {"sort_index": i},
        })
        off_us = (t0s[name] - base) * 1e6
        for ev in tr.events:
            ev = dict(ev)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = ev["ts"] + off_us
            events.append(ev)
    events.extend(extra_events)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"replicas": len(tracers), "epoch_perf_t0": base},
    }
