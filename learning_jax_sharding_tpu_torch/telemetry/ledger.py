"""Goodput ledger: exhaustive wall-clock attribution for a serving loop.

Port of ``learning_jax_sharding_tpu/telemetry/ledger.py``. Every second of
a loop's wall clock lands in EXACTLY ONE bucket, and the buckets must sum
back to the wall within ε (:meth:`GoodputLedger.reconcile`). The identity
holds by construction:

* :meth:`~GoodputLedger.measure` opens a frame on a stack; a frame's
  bucket receives its EXCLUSIVE time (elapsed minus time spent in child
  frames), so nesting never double-counts;
* a TOP-LEVEL frame (the engine's ``step()``) also accrues ``covered``
  wall: anything inside it that no child frame claims falls to the
  frame's own bucket (the engine's host-scheduling remainder);
* ``idle`` is DERIVED: window wall minus covered time is time nobody was
  stepping.

Canonical buckets (:data:`BUCKETS`; the ledger accepts any name, these are
what the engine's wiring uses):

==============  ==========================================================
``device``      the launches of model calls and the host reads that wait
                for them (a CUDA launch only queues work: the device's
                seconds land in the frame around the read that drains the
                stream)
``compile``     a device frame during which a kernel library was built or
                loaded (``ops/_build.py``; re-bucketed from ``device``
                via :meth:`Frame.rebucket`)
``sched``       host scheduling remainder: slot bookkeeping, chunk
                assembly, retirement (the step's own bucket)
``admission``   queue admission + deadline sweeps
``page_alloc``  paged-KV page claims / prefix-cache mapping
``kv_handoff``  KV export/ingest
``swap``        weight swaps
``recovery``    chaos seams, dispatch-fault quarantine: time spent
                *because something failed* (injected hangs land here, not
                in ``device``)
``telemetry``   the observability tax: counter, span, recorder and SLO
                bookkeeping
``idle``        derived idle time (never opened as a frame)
==============  ==========================================================

Windowing mirrors the engine's ``reset_stats``: cumulative totals plus a
:meth:`begin_window` base snapshot; :meth:`window_report` gives the
per-window breakdown, ``host_share`` (1 − device/busy), a
``goodput_ratio`` and the named top gap contributor. Every booked second
also meters into the owning registry as the labeled counter
``ledger_seconds_total{bucket="..."}``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator, Optional

#: Canonical bucket names, in report order. ``idle`` is derived.
BUCKETS = (
    "device", "compile", "sched", "admission", "page_alloc",
    "kv_handoff", "swap", "recovery", "telemetry", "idle",
)


class Frame:
    """One open :meth:`GoodputLedger.measure` region. Exposed so callers
    can :meth:`rebucket` after the fact — the compile-steal idiom: open
    as ``device``, check the executable cache after the call, and move
    the frame to ``compile`` if the cache grew (the dispatch paid a
    trace+compile, not a device step)."""

    __slots__ = ("bucket", "t0", "child_s", "family")

    def __init__(self, bucket: str, t0: float, family: Optional[str] = None):
        self.bucket = bucket
        self.t0 = t0
        self.child_s = 0.0
        self.family = family

    def rebucket(self, bucket: str) -> None:
        self.bucket = bucket


class GoodputLedger:
    """Exclusive-bucket wall-clock accounting with a reconciliation
    invariant. Single-threaded by design (the engine loop is
    single-threaded); one ledger per loop, not per process.
    """

    def __init__(
        self,
        *,
        registry: Any | None = None,
        metric: str = "ledger_seconds_total",
        clock: Callable[[], float] = time.perf_counter,
    ):
        self._clock = clock
        self._registry = registry
        self._metric = metric
        self._counters: dict[str, Any] = {}
        self._totals: dict[str, float] = {}
        self._covered = 0.0          # cumulative top-level frame seconds
        self._windows = 0            # top-level frames opened (≈ steps)
        self._stack: list[Frame] = []
        # Per-family DEVICE attribution: every device-bucket second also
        # lands under exactly one program-family key ("unattributed" when
        # the caller didn't tag), so Σ families == device bucket by
        # construction (:meth:`device_families`).
        self._dev_family: dict[str, float] = {}
        self._dev_calls: dict[str, int] = {}
        t = clock()
        self._t_created = t
        self._win_t = t
        self._win_totals: dict[str, float] = {}
        self._win_covered = 0.0
        self._win_dev_family: dict[str, float] = {}
        self._win_dev_calls: dict[str, int] = {}

    # --- recording ---------------------------------------------------------

    def _add(
        self, bucket: str, seconds: float, family: Optional[str] = None
    ) -> None:
        self._totals[bucket] = self._totals.get(bucket, 0.0) + seconds
        if bucket == "device":
            fam = family or "unattributed"
            self._dev_family[fam] = self._dev_family.get(fam, 0.0) + seconds
        if self._registry is not None:
            c = self._counters.get(bucket)
            if c is None:
                c = self._registry.counter(
                    f'{self._metric}{{bucket="{bucket}"}}',
                    "ledger wall-clock seconds per exclusive bucket",
                )
                self._counters[bucket] = c
            if seconds > 0:
                c.inc(seconds)

    @contextlib.contextmanager
    def measure(
        self, bucket: str, family: Optional[str] = None
    ) -> Iterator[Frame]:
        """Attribute the enclosed wall-clock to ``bucket``, exclusively:
        time claimed by nested ``measure`` frames is subtracted here and
        booked there. A top-level frame also accrues covered wall (the
        idle-derivation base). ``family`` tags device frames with the
        program family for :meth:`device_families` — frames that rebucket
        away from ``device`` (compile-steal) drop out of the family
        totals together with their device seconds."""
        f = Frame(bucket, self._clock(), family)
        self._stack.append(f)
        try:
            yield f
        finally:
            total = self._clock() - f.t0
            self._stack.pop()
            self._add(f.bucket, max(0.0, total - f.child_s), f.family)
            if f.bucket == "device":
                fam = f.family or "unattributed"
                self._dev_calls[fam] = self._dev_calls.get(fam, 0) + 1
            if self._stack:
                self._stack[-1].child_s += total
            else:
                self._covered += total
                self._windows += 1

    def account(
        self, bucket: str, seconds: float, family: Optional[str] = None
    ) -> None:
        """Retrospective booking: ``seconds`` of wall that already passed
        land in ``bucket``. Inside an open frame this STEALS from the
        enclosing frame (its exclusive time shrinks by the same amount,
        so the identity is conserved); outside any frame the seconds
        count as covered wall — only book time that genuinely elapsed on
        this loop's clock."""
        if seconds < 0:
            raise ValueError(f"cannot account {seconds} s")
        self._add(bucket, seconds, family)
        if self._stack:
            self._stack[-1].child_s += seconds
        else:
            self._covered += seconds

    @property
    def in_frame(self) -> bool:
        return bool(self._stack)

    # --- windows -----------------------------------------------------------

    def begin_window(self) -> None:
        """Start a fresh reporting window (the engine's ``reset_stats``
        calls this): subsequent :meth:`window_report`/:meth:`reconcile`
        deltas run from here."""
        self._win_t = self._clock()
        self._win_totals = dict(self._totals)
        self._win_covered = self._covered
        self._win_dev_family = dict(self._dev_family)
        self._win_dev_calls = dict(self._dev_calls)

    @property
    def window_start(self) -> float:
        """Clock timestamp of the current window's start (creation time
        until the first :meth:`begin_window`): the cut that keeps
        pre-window (warm-up) trace legs out of attribution."""
        return self._win_t

    def window_buckets(self) -> dict[str, float]:
        """Per-bucket seconds since :meth:`begin_window`, with derived
        ``idle`` — keys ordered canonically, zero buckets included."""
        out = {
            b: self._totals.get(b, 0.0) - self._win_totals.get(b, 0.0)
            for b in BUCKETS if b != "idle"
        }
        for b in self._totals:        # non-canonical buckets still report
            if b not in out:
                out[b] = self._totals[b] - self._win_totals.get(b, 0.0)
        wall = self._clock() - self._win_t
        covered = self._covered - self._win_covered
        out["idle"] = max(0.0, wall - covered)
        return out

    def window_report(
        self, *, roofline_device_s: Optional[float] = None
    ) -> dict:
        """The goodput verdict for the current window.

        * ``host_share`` — 1 − device/busy, where busy is all covered
          (non-idle) time: the fraction of the engine's active wall spent
          anywhere but the device bucket.
        * ``goodput_ratio`` — roofline seconds over wall when a roofline
          estimate is given, else measured device over wall.
        * ``top_contributor`` — the named largest non-device bucket:
          where the next optimization round should look first.
        """
        wall = self._clock() - self._win_t
        covered = self._covered - self._win_covered
        buckets = self.window_buckets()
        device = buckets.get("device", 0.0)
        busy = max(covered, 1e-12)
        gaps = {b: s for b, s in buckets.items() if b != "device"}
        top = max(gaps, key=gaps.get) if gaps else None
        ratio = (
            roofline_device_s / wall
            if roofline_device_s is not None and wall > 0
            else (device / wall if wall > 0 else 0.0)
        )
        return {
            "wall_s": wall,
            "busy_s": covered,
            "steps": self._windows,
            "buckets": buckets,
            "device_s": device,
            "host_share": 1.0 - device / busy if covered > 0 else None,
            "goodput_ratio": ratio,
            "roofline_device_s": roofline_device_s,
            "top_contributor": top,
            "top_contributor_s": gaps.get(top, 0.0) if top else 0.0,
            "telemetry_share": (
                buckets.get("telemetry", 0.0) / wall if wall > 0 else 0.0
            ),
        }

    def reconcile(self, *, eps: float | None = None) -> dict:
        """The hard invariant, as a checkable dict: window buckets must
        sum to window wall within ``eps`` (default: 1 µs per recorded
        frame plus 0.1% of wall — pure float-rounding slack; a real leak
        is milliseconds). ``ok`` is False on residual past eps or any
        negative bucket. Raises nothing — tests assert on it so the
        failure message carries the whole breakdown."""
        wall = self._clock() - self._win_t
        buckets = self.window_buckets()
        total = sum(buckets.values())
        if eps is None:
            eps = 1e-6 * max(1, self._windows) + 1e-3 * max(wall, 1e-9)
        residual = wall - total
        return {
            "ok": abs(residual) <= eps
            and all(s >= -1e-9 for s in buckets.values())
            and not self._stack,
            "wall_s": wall,
            "sum_s": total,
            "residual_s": residual,
            "eps": eps,
            "open_frames": len(self._stack),
            "buckets": buckets,
        }

    def device_families(self) -> dict[str, dict[str, float]]:
        """Window device seconds and dispatch counts per program family.

        Σ over families of ``seconds`` equals the window's ``device``
        bucket by construction — every device booking (measure-close,
        :meth:`account`, rebucket-into-device) passes through
        :meth:`_add`, which accrues the family total with the SAME
        number."""
        out: dict[str, dict[str, float]] = {}
        for fam, s in self._dev_family.items():
            d = s - self._win_dev_family.get(fam, 0.0)
            n = self._dev_calls.get(fam, 0) - self._win_dev_calls.get(fam, 0)
            if d != 0.0 or n != 0:
                out[fam] = {"seconds": d, "calls": float(n)}
        return out

    def totals(self) -> dict[str, float]:
        """Cumulative (all-time) per-bucket seconds, no derived idle."""
        return dict(self._totals)
