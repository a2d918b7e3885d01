"""Structured spans: nested wall-clock timing that lands in three places.

Port of ``learning_jax_sharding_tpu/telemetry/spans.py``. A :class:`Tracer`
records host-side events (spans, instants, per-request async intervals)
and exports them as

* **Chrome trace-event JSON** (:meth:`Tracer.chrome_trace`), which
  Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` load;
* **JSONL** (:meth:`Tracer.dump_jsonl`), one event per line;
* **the PyTorch profiler**, live: every :meth:`Tracer.span` also enters a
  ``torch.profiler.record_function``, so under a ``utils.profiling.trace``
  capture the spans appear on the profiler's host timeline next to the
  kernels they launched.

A span around CUDA work measures the LAUNCHES (the queueing of kernels)
unless it contains a sync point. :meth:`Tracer.sync` is that point: it
synchronizes the devices of its argument's CUDA tensors
(``utils/bench.py::_sync``) and records how long that took.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Iterator

import torch


def device_sync(out: Any) -> None:
    """Wait until the work producing ``out`` (tensors, nested in lists,
    tuples and dicts) is done: THE sync point. Delegates to
    ``utils.bench._sync``, so the port has one definition of "synced"."""
    from learning_jax_sharding_tpu_torch.utils.bench import _sync

    _sync(out)


class Tracer:
    """Collects trace events; cheap enough to leave on.

    Events are Chrome trace-event dicts (``ph`` phases used: ``X``
    complete, ``i`` instant, ``b``/``e`` async begin/end). Timestamps are
    microseconds since tracer construction; the buffer is a bounded RING
    (``max_events``): past the cap the OLDEST events are dropped (with a
    count), because the trace someone exports after an incident needs
    the most recent window, not the run's first minutes.
    """

    def __init__(
        self,
        *,
        enabled: bool = True,
        max_events: int = 200_000,
        name: str | None = None,
    ):
        import collections

        self.enabled = enabled
        self.name = name or "tracer"
        self.dropped = 0
        self.sink_errors = 0   # on_event sink raises (counted, not fatal)
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=max_events
        )
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.perf_counter()
        # Deterministic ids: the OS pid and raw thread idents change per
        # run, which made merged fleet timelines interleave replicas
        # nondeterministically in Perfetto. Events carry pid 1 and small
        # first-seen thread indexes; the real OS pid survives in the
        # process-name metadata (`chrome_trace`), and `merge_tracers`
        # re-pids per replica.
        self._pid = 1
        self._os_pid = os.getpid()
        self._tid_of: dict[int, int] = {}
        self._max_events = max_events
        # Optional event sink (``FlightRecorder.attach_tracer`` sets it):
        # called with each emitted event dict, outside the ring lock. A
        # raising sink must not take the traced code down with it.
        self.on_event = None

    # --- time/emission -----------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self.dropped += 1   # the append below evicts the oldest
            self._events.append(ev)
        cb = self.on_event
        if cb is not None:
            try:
                cb(ev)
            except Exception:
                # A raising sink must not take the traced code down with
                # it — but the failure must not vanish either
                # (swallowed-exception lint): count it, so a broken
                # recorder attachment is visible in the tracer's state.
                self.sink_errors += 1

    def _tid(self) -> int:
        """Stable small tid for the calling thread: 1, 2, ... in
        first-seen order — deterministic for single-threaded loops
        (always 1), and never a raw ident that reshuffles every run."""
        ident = threading.get_ident()
        t = self._tid_of.get(ident)
        if t is None:
            with self._lock:
                t = self._tid_of.setdefault(ident, len(self._tid_of) + 1)
        return t

    def thread_ids(self) -> list[int]:
        """Assigned tids, sorted — for thread-name metadata emission."""
        with self._lock:
            return sorted(self._tid_of.values())

    def _base(self, name: str, ph: str, **extra) -> dict:
        ev = {
            "name": name,
            "ph": ph,
            "ts": self._now_us(),
            "pid": self._pid,
            "tid": self._tid(),
        }
        ev.update(extra)
        return ev

    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # --- recording API -----------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        """Nested complete event, also a ``record_function`` range. ``args`` become the
        event's ``args`` dict (JSON-able values only)."""
        if not self.enabled:
            yield
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        start = self._now_us()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            stack.pop()
            end = self._now_us()
            ev = self._base(name, "X", dur=end - start)
            ev["ts"] = start
            if parent is not None:
                args = dict(args, parent=parent)
            if args:
                ev["args"] = args
            self._emit(ev)

    def complete(
        self, name: str, start_perf: float, duration_s: float, **args
    ) -> None:
        """Record a complete event retrospectively from host timestamps
        (``time.perf_counter()`` start + seconds) — for call sites that
        only know after the fact whether a dispatch actually ran."""
        if not self.enabled:
            return
        ev = self._base(name, "X", dur=duration_s * 1e6)
        ev["ts"] = (start_perf - self._t0) * 1e6
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        ev = self._base(name, "i", s="t")
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_begin(self, name: str, id: int, **args) -> None:
        """Open an async interval (e.g. one request's admit→finish
        lifetime) — Perfetto renders ``b``/``e`` pairs keyed by
        (category, id) as horizontal tracks independent of call nesting."""
        if not self.enabled:
            return
        ev = self._base(name, "b", id=int(id), cat=name)
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_end(self, name: str, id: int, **args) -> None:
        if not self.enabled:
            return
        ev = self._base(name, "e", id=int(id), cat=name)
        if args:
            ev["args"] = args
        self._emit(ev)

    def sync(self, out: Any, name: str = "device_sync") -> None:
        """Honest sync point: host-readback ``out``, then mark the
        instant the device was known done (see module docstring)."""
        if not self.enabled:
            device_sync(out)
            return
        t0 = time.perf_counter()
        device_sync(out)
        self.complete(name, t0, time.perf_counter() - t0)

    # --- export ------------------------------------------------------------

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def metadata_events(self, *, pid: int | None = None) -> list[dict]:
        """Chrome ``M``-phase name rows for this tracer's process and
        threads — deterministic content, so exported traces diff cleanly
        run-to-run (the real OS pid rides in args, not in the ids)."""
        pid = self._pid if pid is None else pid
        rows = [{
            "name": "process_name", "ph": "M", "ts": 0.0, "pid": pid,
            "tid": 0,
            "args": {"name": self.name, "os_pid": self._os_pid},
        }]
        rows.extend(
            {
                "name": "thread_name", "ph": "M", "ts": 0.0, "pid": pid,
                "tid": t,
                "args": {"name": f"thread {t}"},
            }
            for t in self.thread_ids()
        )
        return rows

    def chrome_trace(self) -> dict:
        """Perfetto/chrome://tracing-loadable trace object, metadata
        (process/thread names) first."""
        return {
            "traceEvents": self.metadata_events() + self.events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def dump_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def dump_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")


_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer — subsystems not handed one trace here."""
    return _DEFAULT
