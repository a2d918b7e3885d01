"""Metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``learning_jax_sharding_tpu/telemetry/registry.py`` (it imports no
JAX; the port keeps its own copy). One place for every numeric the stack
emits (the serving engine's admission, page-pool and acceptance counters,
the goodput ledger's seconds), exported two ways:

* :meth:`MetricsRegistry.snapshot`: a JSON-able dict;
* :meth:`MetricsRegistry.prometheus_text`: Prometheus text exposition
  (version 0.0.4).

Three metric kinds, get-or-create by name, thread-safe. Percentiles that
must be exact stay sample-based (``ContinuousEngine.latency_stats``); the
histograms carry the same observations in fixed buckets for export.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Sequence

#: Default histogram upper bounds (seconds-flavoured, Prometheus-style).
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0,
)


class Counter:
    """Monotonically increasing value. ``inc`` with a negative amount
    raises — a counter that goes down is a gauge."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {amount})"
            )
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value, plus a high-water mark (max value seen since
    the last :meth:`reset_high_water`) — the page-pool/queue-depth shape
    of measurement, where the peak inside a window matters as much as the
    current value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._high_water = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            if value > self._high_water:
                self._high_water = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            if self._value > self._high_water:
                self._high_water = self._value

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    @property
    def high_water(self) -> float:
        return self._high_water

    def reset_high_water(self) -> None:
        with self._lock:
            self._high_water = self._value


class Histogram:
    """Fixed-bucket histogram: cumulative bucket counts (Prometheus
    ``le`` semantics), sum, and count. Buckets are chosen at creation and
    never resize — snapshots are O(buckets), observation is O(log
    buckets)."""

    kind = "histogram"

    def __init__(
        self, name: str, help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.name = name
        self.help = help
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)   # [+Inf] overflow last
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """[(upper_bound, cumulative_count)] ending with (+inf, count)."""
        out, running = [], 0
        for ub, c in zip(self.buckets, self._counts):
            running += c
            out.append((ub, running))
        out.append((math.inf, self._count))
        return out


class MetricsRegistry:
    """Get-or-create metric store. Re-requesting a name returns the same
    object; requesting it as a different kind (or a histogram with
    different buckets) raises — silent double-registration is how two
    subsystems end up fighting over one counter."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested as {cls.kind}"
            )
        if kwargs.get("buckets") is not None and tuple(
            sorted(float(b) for b in kwargs["buckets"])
        ) != m.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                f"buckets"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def metrics(self) -> list:
        return list(self._metrics.values())

    # --- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able dump: counters/gauges as numbers, gauges' high-water
        alongside, histograms as {buckets, counts, sum, count}."""
        out: dict = {}
        for m in self.metrics():
            if m.kind == "counter":
                out[m.name] = m.value
            elif m.kind == "gauge":
                out[m.name] = m.value
                out[m.name + "__high_water"] = m.high_water
            else:
                out[m.name] = {
                    "buckets": list(m.buckets),
                    "counts": [c for _, c in m.cumulative()],
                    "sum": m.sum,
                    "count": m.count,
                }
        return out

    def dump_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4.

        Metric names may carry an inline label set
        (``'ledger_seconds_total{bucket="device"}'`` — the goodput
        ledger and per-stage trace histograms register one metric per
        label value): every such series is grouped under its FAMILY name
        (labels stripped) with ONE ``# TYPE``/``# HELP`` header, as the
        exposition format requires — a per-series header with braces in
        the metric name would be malformed.
        """
        import re

        fmt = _fmt_value

        def parsed(name):
            # re.S: a raw (pre-escaping) newline inside a label value
            # must not crash the exporter — it degrades to an odd line,
            # escape_label_value at construction is the real fix.
            m = re.match(r"([^{]+?)(\{.*\})?$", name, re.S)
            return m.group(1), m.group(2) or ""

        fams: dict[str, list] = {}
        order: list[str] = []
        for m in self.metrics():
            fam, labels = parsed(m.name)
            if fam not in fams:
                fams[fam] = []
                order.append(fam)
            fams[fam].append((m, labels))
        lines = []
        for fam in order:
            members = fams[fam]
            help_text = next((m.help for m, _ in members if m.help), "")
            if help_text:
                lines.append(f"# HELP {fam} {help_text}")
            lines.append(f"# TYPE {fam} {members[0][0].kind}")
            for m, labels in members:
                if m.kind in ("counter", "gauge"):
                    lines.append(f"{fam}{labels} {fmt(m.value)}")
                else:
                    inner = labels[1:-1] + "," if labels else ""
                    for ub, c in m.cumulative():
                        lines.append(
                            f'{fam}_bucket{{{inner}le="{fmt(ub)}"}} {c}'
                        )
                    lines.append(f"{fam}_sum{labels} {fmt(m.sum)}")
                    lines.append(f"{fam}_count{labels} {m.count}")
        return "\n".join(lines) + "\n"

    def dump_prometheus(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def escape_label_value(value) -> str:
    """Prometheus text-exposition label-value escaping: backslash,
    double-quote, and newline must be escaped or the exposition line is
    corrupt (a tenant named ``evil"} 1`` would otherwise terminate the
    label set early and smuggle a fake sample). Escape at CONSTRUCTION
    time — label sets live inside metric NAMES here, and a retro-escape
    at render time could not tell an escaped backslash from a raw one."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def labeled_name(family: str, **labels) -> str:
    """Compose a metric name carrying an inline Prometheus label set —
    ``labeled_name("slo_e2e_burn_rate", tenant='a"b')`` →
    ``'slo_e2e_burn_rate{tenant="a\\"b"}'`` — with every value escaped
    via :func:`escape_label_value`. The one sanctioned way to build
    labeled series from UNTRUSTED strings (tenant ids, adapter names);
    the fixed internal labels (ledger buckets, trace stages) predate it
    and are trusted literals."""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items())
    )
    return f"{family}{{{inner}}}" if inner else family


def snapshot_prometheus_text(snapshot: dict) -> str:
    """Prometheus text exposition (0.0.4) for a SNAPSHOT dict — the
    registry-independent renderer.

    Accepts what :meth:`MetricsRegistry.snapshot` produces, including
    LABELED keys (``'name{replica="x"}'``), which render as real
    Prometheus labels. A snapshot
    cannot tell counters from gauges, so scalars render untyped;
    histogram dicts render as ``_bucket``/``_sum``/``_count`` series
    (the snapshot's counts are already cumulative, +Inf last); gauge
    ``__high_water`` companions render as ``<name>_high_water``.
    """
    import re

    def parsed(key):
        m = re.match(r"([^{]+?)(\{.*\})?$", key, re.S)
        name, labels = m.group(1), m.group(2) or ""
        if name.endswith("__high_water"):
            name = name[: -len("__high_water")] + "_high_water"
        return name, labels

    lines = []
    # Group by the RENDERED family name (labels stripped, high-water
    # normalized), not the raw key: the exposition format requires every
    # series of one metric in ONE contiguous group, and a raw-key sort
    # would split a family around its labeled variants ('{' sorts after
    # '_') and interleave 'name_high_water' between them.
    for key in sorted(snapshot, key=lambda k: parsed(k)):
        v = snapshot[key]
        name, labels = parsed(key)
        if isinstance(v, dict):
            inner = labels[1:-1] + "," if labels else ""
            for ub, c in zip(
                list(v["buckets"]) + [math.inf], v["counts"]
            ):
                lines.append(
                    f'{name}_bucket{{{inner}le="{_fmt_value(ub)}"}} {c}'
                )
            lines.append(f"{name}_sum{labels} {_fmt_value(v['sum'])}")
            lines.append(f"{name}_count{labels} {v['count']}")
        else:
            lines.append(f"{name}{labels} {_fmt_value(v)}")
    return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry — subsystems that are not handed one
    explicitly meter here."""
    return _DEFAULT
