"""In-engine SLO monitoring: streaming percentiles + burn-rate targets.

Port of ``learning_jax_sharding_tpu/telemetry/slo.py``:

* :class:`StreamingPercentile`: a sliding-window quantile estimator (ring
  of the most recent ``window`` observations);
* :class:`SLOTarget`: one objective, ``metric``'s value ``<= threshold``
  for at least ``objective`` of events (``SLOTarget("ttft", 0.5,
  objective=0.99)``: p99 TTFT under 500 ms);
* :class:`SLOMonitor`: observes metric values (the engine feeds TTFT, TPOT,
  ITL, queue wait and end-to-end latency per retirement, and a 0/1
  ``decode_stall_share`` per dispatch with decoding rows), keeps per-target
  good/bad counts and the BURN RATE, the windowed bad fraction over the
  error budget ``1 - objective`` (1.0: consuming budget exactly; above 1:
  the target fails if the window's behavior persists), per tenant too.
  Counters and gauges mirror into a :class:`~.registry.MetricsRegistry`;
  breaches feed the flight recorder.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable

import numpy as np


class StreamingPercentile:
    """Sliding-window percentile estimator over the last ``window`` values."""

    def __init__(self, window: int = 2048):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._buf: "collections.deque[float]" = collections.deque(
            maxlen=window
        )
        self.count = 0   # lifetime observations (window holds the tail)

    def observe(self, value: float) -> None:
        self._buf.append(float(value))
        self.count += 1

    def quantile(self, q: float) -> float | None:
        if not self._buf:
            return None
        return float(np.percentile(np.asarray(self._buf), q * 100.0))

    def snapshot(self) -> dict:
        if self._buf:
            # One conversion + sort serves all three quantiles (the
            # per-call path re-sorts; snapshot is the bulk reader).
            p50, p90, p99 = (
                float(v)
                for v in np.percentile(np.asarray(self._buf), (50, 90, 99))
            )
        else:
            p50 = p90 = p99 = None
        return {
            "count": self.count,
            "window": len(self._buf),
            "p50": p50,
            "p90": p90,
            "p99": p99,
        }


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """``metric <= threshold`` for at least ``objective`` of events."""

    metric: str
    threshold: float
    objective: float = 0.99
    name: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )
        if not self.name:
            object.__setattr__(
                self, "name", f"{self.metric}_le_{self.threshold:g}"
            )


class SLOMonitor:
    """Streams metric observations into percentile estimators and SLO
    burn-rate accounting.

    ``registry``/``recorder`` may be bound later (the engine binds its own
    registry when the monitor arrives without one); counters are created on
    first use, so late binding loses nothing.
    """

    def __init__(
        self,
        targets: Iterable[SLOTarget] = (),
        *,
        registry: Any | None = None,
        recorder: Any | None = None,
        window: int = 2048,
    ):
        self.targets = list(targets)
        self.registry = registry
        self.recorder = recorder
        self._window = window
        self._est: dict[str, StreamingPercentile] = {}
        # Per-target: lifetime events/breaches + the burn window (ring of
        # bools — True = breached).
        self._events: dict[str, int] = {t.name: 0 for t in self.targets}
        self._breaches: dict[str, int] = {t.name: 0 for t in self.targets}
        self._burn: dict[str, collections.deque] = {
            t.name: collections.deque(maxlen=window) for t in self.targets
        }
        # Running breach count per window (evictions decrement it), so
        # burn_rate is O(1) — observe() runs per ITL gap in the engine's
        # retire path. Metric handles are cached per bound registry.
        self._burn_bad: dict[str, int] = {t.name: 0 for t in self.targets}
        self._handles: dict[str, tuple] = {}
        self._handles_registry: Any | None = None
        # Per-tenant burn accounting, created lazily on the
        # first tenant-labeled observe(), so an unlabeled monitor stays
        # BIT-compatible with the pre-tenant one: same state, same
        # registry series, same snapshot.
        self._tenants: dict[str, dict[str, dict]] = {}
        self._tenant_handles: dict[tuple, tuple] = {}

    def estimator(self, metric: str) -> StreamingPercentile:
        est = self._est.get(metric)
        if est is None:
            est = self._est[metric] = StreamingPercentile(self._window)
        return est

    def _target_handles(self, t: SLOTarget) -> tuple | None:
        if self.registry is None:
            return None
        if self._handles_registry is not self.registry:
            self._handles = {}   # re-bound: stale handles point elsewhere
            self._handles_registry = self.registry
        h = self._handles.get(t.name)
        if h is None:
            h = self._handles[t.name] = (
                self.registry.counter(
                    f"slo_{t.name}_events_total", "SLO-evaluated events"
                ),
                self.registry.counter(
                    f"slo_{t.name}_breaches_total",
                    "events over the SLO threshold",
                ),
                self.registry.gauge(
                    f"slo_{t.name}_burn_rate",
                    "windowed bad fraction over the error budget",
                ),
            )
        return h

    def _tenant_handles_for(self, t: SLOTarget, tenant: str):
        if self.registry is None:
            return None
        if self._handles_registry is not self.registry:
            self._handles = {}   # re-bound: stale handles point elsewhere
            self._tenant_handles = {}
            self._handles_registry = self.registry
        key = (tenant, t.name)
        h = self._tenant_handles.get(key)
        if h is None:
            from learning_jax_sharding_tpu_torch.telemetry.registry import (
                labeled_name,
            )

            h = self._tenant_handles[key] = (
                self.registry.counter(
                    labeled_name(
                        f"slo_{t.name}_events_total", tenant=tenant
                    ),
                    "SLO-evaluated events",
                ),
                self.registry.counter(
                    labeled_name(
                        f"slo_{t.name}_breaches_total", tenant=tenant
                    ),
                    "events over the SLO threshold",
                ),
                self.registry.gauge(
                    labeled_name(
                        f"slo_{t.name}_burn_rate", tenant=tenant
                    ),
                    "windowed bad fraction over the error budget",
                ),
            )
        return h

    def _observe_tenant(self, t: SLOTarget, tenant: str, bad: bool):
        per = self._tenants.setdefault(tenant, {})
        s = per.get(t.name)
        if s is None:
            s = per[t.name] = {
                "events": 0, "breaches": 0, "bad": 0,
                "ring": collections.deque(maxlen=self._window),
            }
        s["events"] += 1
        ring = s["ring"]
        if len(ring) == ring.maxlen:
            s["bad"] -= ring.popleft()
        ring.append(bad)
        s["bad"] += bad
        if bad:
            s["breaches"] += 1
        h = self._tenant_handles_for(t, tenant)
        if h is not None:
            h[0].inc()
            if bad:
                h[1].inc()
            h[2].set(self.tenant_burn_rate(t.name, tenant))

    def observe(
        self, metric: str, value: float, *, tenant: str | None = None,
    ) -> None:
        """Feed one observation. ``tenant`` additionally books it into
        that tenant's OWN burn window and ``{tenant="..."}``-labeled
        registry series (label values escaped) — the unlabeled series
        keep aggregating every event exactly as before, so the
        all-tenant view stays bit-compatible."""
        if value is None:
            return
        value = float(value)
        self.estimator(metric).observe(value)
        for t in self.targets:
            if t.metric != metric:
                continue
            bad = value > t.threshold
            self._events[t.name] += 1
            ring = self._burn[t.name]
            if len(ring) == ring.maxlen:
                self._burn_bad[t.name] -= ring.popleft()
            ring.append(bad)
            self._burn_bad[t.name] += bad
            handles = self._target_handles(t)
            if handles is not None:
                handles[0].inc()
            if bad:
                self._breaches[t.name] += 1
                if handles is not None:
                    handles[1].inc()
                if self.recorder is not None:
                    self.recorder.record(
                        "slo_breach", target=t.name, metric=metric,
                        value=value, threshold=t.threshold,
                        tenant=tenant,
                    )
            if handles is not None:
                handles[2].set(self.burn_rate(t.name))
            if tenant is not None:
                self._observe_tenant(t, tenant, bad)

    def reset_window(self) -> None:
        """Open a fresh burn/percentile window: drop every ring (global,
        per-tenant) and estimator, keep the LIFETIME events/breaches
        counters. The serving-side analogue of ``ledger.begin_window``
        — warm-up and calibration traffic observed before a measurement
        (or a control loop) starts must not keep reading as burn for
        the next 2048 events."""
        self._est = {}
        for name in self._burn:
            self._burn[name] = collections.deque(maxlen=self._window)
            self._burn_bad[name] = 0
        for per in self._tenants.values():
            for s in per.values():
                s["ring"] = collections.deque(maxlen=self._window)
                s["bad"] = 0

    def burn_rate(self, name: str) -> float:
        """Windowed breach fraction over the error budget ``1-objective``
        (O(1): the window's breach count is maintained incrementally).
        0 = clean window, 1 = consuming budget exactly, >1 = violating."""
        t = self._target(name)
        ring = self._burn[name]
        if not ring:
            return 0.0
        frac = self._burn_bad[name] / len(ring)
        return frac / (1.0 - t.objective)

    def tenant_burn_rate(self, name: str, tenant: str) -> float:
        """One tenant's windowed burn rate for target ``name`` — 0.0
        for a tenant (or target) that has no labeled observations yet."""
        t = self._target(name)
        s = self._tenants.get(tenant, {}).get(name)
        if not s or not s["ring"]:
            return 0.0
        return (s["bad"] / len(s["ring"])) / (1.0 - t.objective)

    def tenant_burn_rates(self) -> dict[str, dict[str, float]]:
        """``{tenant: {target: burn_rate}}`` over every tenant that has
        labeled observations — the per-tenant SLO burn timeline's
        sample, and economics' worst-tenant pick."""
        return {
            tenant: {
                name: self.tenant_burn_rate(name, tenant)
                for name in per
            }
            for tenant, per in self._tenants.items()
        }

    def _target(self, name: str) -> SLOTarget:
        for t in self.targets:
            if t.name == name:
                return t
        raise KeyError(f"unknown SLO target {name!r}")

    def breached(self) -> list[str]:
        """Targets currently burning budget faster than they earn it."""
        return [t.name for t in self.targets if self.burn_rate(t.name) > 1.0]

    def snapshot(self) -> dict:
        """JSON-able state: per-metric percentile snapshots + per-target
        burn accounting. Also refreshes the percentile gauges in the bound
        registry (quantiles cost a window sort — paid here, not per
        observation)."""
        metrics = {m: est.snapshot() for m, est in self._est.items()}
        if self.registry is not None:
            for m, snap in metrics.items():
                for q in ("p50", "p99"):
                    if snap[q] is not None:
                        self.registry.gauge(
                            f"slo_{m}_{q}",
                            f"windowed {q} of {m}",
                        ).set(snap[q])
        targets = {}
        for t in self.targets:
            br = self.burn_rate(t.name)
            targets[t.name] = {
                "metric": t.metric,
                "threshold": t.threshold,
                "objective": t.objective,
                "events": self._events[t.name],
                "breaches": self._breaches[t.name],
                "burn_rate": br,
                "healthy": br <= 1.0,
            }
        out = {"metrics": metrics, "targets": targets}
        if self._tenants:
            # Key present ONLY when tenant-labeled observations exist —
            # an unlabeled monitor's snapshot is bit-identical to the
            # pre-tenant format.
            out["tenants"] = {
                tenant: {
                    name: {
                        "events": s["events"],
                        "breaches": s["breaches"],
                        "burn_rate": self.tenant_burn_rate(name, tenant),
                    }
                    for name, s in per.items()
                }
                for tenant, per in self._tenants.items()
            }
        return out
