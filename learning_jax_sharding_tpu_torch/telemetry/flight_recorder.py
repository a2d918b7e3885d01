"""Flight recorder: a bounded ring of structured events + post-mortem dump.

Port of ``learning_jax_sharding_tpu/telemetry/flight_recorder.py``. A
:class:`FlightRecorder` holds the last ``max_events`` structured events
(engine arrivals, admissions, preemptions, retirements, dispatch faults,
span closures) in a thread-safe ring that costs one dict append per event.
:meth:`FlightRecorder.dump` writes a POST-MORTEM BUNDLE:

* ``events.json``: the ring's events, oldest first;
* ``registry.json``: a :class:`~.registry.MetricsRegistry` snapshot (when
  one is attached or passed);
* ``trace.json``: the attached :class:`~.spans.Tracer`'s Chrome trace;
* ``memory.json``: each CUDA device's ``torch.cuda.memory_stats()`` (empty
  without a card; a failure there never raises);
* ``error.txt``: the exception that triggered the dump.

:meth:`attach_tracer` forwards every span CLOSURE of a tracer into the
ring as a ``span`` record, so the ring carries the dispatch timeline
interleaved with the lifecycle events.

Bundles land under ``$LJST_ARTIFACT_DIR`` when set (one subdirectory per
bundle), else in a fresh temporary directory, never the working directory.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import pathlib
import tempfile
import threading
import time
import traceback
from typing import Any, Iterator


def _json_safe(obj: Any) -> Any:
    """Strict-JSON form of ``obj``: non-finite floats become the strings
    "NaN"/"Infinity"/"-Infinity". ``json.dump``'s default emits bare NaN
    tokens, which jq/JSON.parse/strict ingesters reject — and a NaN in
    the events is exactly the post-mortem case this module exists for."""
    if isinstance(obj, float):
        if obj != obj:
            return "NaN"
        if obj in (float("inf"), float("-inf")):
            return "Infinity" if obj > 0 else "-Infinity"
        return obj
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _device_memory_stats() -> dict:
    """``torch.cuda.memory_stats()`` of every visible CUDA device, keyed
    ``cuda:<i>`` (empty without a card)."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def artifact_dir(name: str) -> pathlib.Path:
    """Resolve the output directory for a named artifact set.

    ``$LJST_ARTIFACT_DIR`` (created on demand) when set — the operator's
    one knob for where diagnosis output lands — else a fresh temp
    directory, so cases and post-mortems never litter the CWD.
    """
    base = os.environ.get("LJST_ARTIFACT_DIR")
    if base:
        p = pathlib.Path(base) / name
        p.mkdir(parents=True, exist_ok=True)
        return p
    return pathlib.Path(tempfile.mkdtemp(prefix=f"ljst_{name}_"))


class FlightRecorder:
    """Bounded ring buffer of structured events with a post-mortem dump.

    Events are plain dicts ``{"t": unix_seconds, "kind": str, **fields}``;
    past ``max_events`` the OLDEST are evicted (with a count), because a
    post-mortem needs the window right before the incident, not the run's
    first minutes. A registry and tracer may be attached at construction so
    ``dump()`` needs no arguments at the crash site.
    """

    def __init__(
        self,
        *,
        max_events: int = 4096,
        registry: Any | None = None,
        tracer: Any | None = None,
    ):
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=max_events
        )
        self._max_events = max_events
        self._lock = threading.Lock()
        self.dropped = 0
        self.registry = registry
        self.tracer = tracer
        self.last_dump: pathlib.Path | None = None
        self._dump_seq = 0

    # --- recording ---------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event. Values must be JSON-able (the producer's
        contract — the dump path never filters)."""
        ev = {"t": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            if len(self._events) >= self._max_events:
                self.dropped += 1
            self._events.append(ev)

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def attach_tracer(self, tracer: Any) -> None:
        """Forward ``tracer``'s span closures (complete events) into the
        ring as ``span`` records — the dispatch timeline rides next to the
        lifecycle events it explains."""
        self.tracer = tracer

        def on_event(ev: dict) -> None:
            if ev.get("ph") == "X":
                self.record(
                    "span", name=ev["name"], dur_us=ev.get("dur"),
                    ts_us=ev.get("ts"),
                )

        tracer.on_event = on_event

    # --- the post-mortem bundle -------------------------------------------

    def dump(
        self,
        outdir: str | os.PathLike | None = None,
        *,
        registry: Any | None = None,
        tracer: Any | None = None,
        error: BaseException | str | None = None,
    ) -> pathlib.Path:
        """Write the post-mortem bundle; returns its directory.

        ``outdir`` defaults to a fresh ``postmortem<N>`` under
        :func:`artifact_dir` resolution. Every section is individually
        guarded — a dump taken mid-crash must never raise over the original
        failure.
        """
        if outdir is None:
            base = os.environ.get("LJST_ARTIFACT_DIR")
            if base:
                # A persistent artifact dir outlives this process: never
                # take a postmortem<N> slot an EARLIER run already wrote
                # — overwriting old forensic evidence with new is the one
                # failure a post-mortem dump must not have.
                while True:
                    self._dump_seq += 1
                    outdir = (
                        pathlib.Path(base) / f"postmortem{self._dump_seq}"
                    )
                    if not outdir.exists():
                        break
            else:
                self._dump_seq += 1
                outdir = artifact_dir(f"postmortem{self._dump_seq}")
        out = pathlib.Path(outdir)
        try:
            out.mkdir(parents=True, exist_ok=True)
            with open(out / "events.json", "w") as f:
                json.dump(
                    _json_safe(
                        {"dropped": self.dropped, "events": self.events()}
                    ),
                    f, indent=2, default=str, allow_nan=False,
                )
        except Exception:   # pragma: no cover - crash-path guard
            # An unwritable artifact dir must not mask the ORIGINAL
            # failure the dump is documenting (capture()/escalate() call
            # this mid-crash). Best effort only, like every section.
            return out
        registry = registry if registry is not None else self.registry
        if registry is not None:
            try:
                # Through the sanitizer, not registry.dump_json: a gauge
                # holding the NaN loss must not make the bundle unparseable.
                with open(out / "registry.json", "w") as f:
                    json.dump(
                        _json_safe(registry.snapshot()), f, indent=2,
                        sort_keys=True, allow_nan=False,
                    )
            except Exception:  # pragma: no cover - crash-path guard
                pass
        tracer = tracer if tracer is not None else self.tracer
        if tracer is not None:
            try:
                tracer.dump_chrome_trace(out / "trace.json")
            except Exception:  # pragma: no cover - crash-path guard
                pass
        try:
            with open(out / "memory.json", "w") as f:
                json.dump(_device_memory_stats(), f, indent=2)
        except Exception:  # pragma: no cover - crash-path guard
            pass
        if error is not None:
            if isinstance(error, BaseException):
                text = "".join(
                    traceback.format_exception(
                        type(error), error, error.__traceback__
                    )
                )
            else:
                text = str(error)
            (out / "error.txt").write_text(text)
        self.record("dump", path=str(out))
        self.last_dump = out
        return out

    @contextlib.contextmanager
    def capture(
        self, outdir: str | os.PathLike | None = None
    ) -> Iterator["FlightRecorder"]:
        """Dump a post-mortem bundle if the block raises, then re-raise —
        wrap a serve loop or training run to get the bundle for free."""
        try:
            yield self
        except BaseException as e:
            self.record("exception", type=type(e).__name__, message=str(e))
            self.dump(outdir, error=e)
            raise


_DEFAULT = FlightRecorder()


def default_flight_recorder() -> FlightRecorder:
    """The process-wide recorder — producers not handed one record here,
    so one ring holds the whole process's recent history."""
    return _DEFAULT
