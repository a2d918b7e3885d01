"""Runtime health watchdogs: NaN/spike detection, hang flagging, escalation.

Port of ``learning_jax_sharding_tpu/telemetry/watchdog.py``:

* :class:`Watchdog`: per-step numeric health at dispatch speed. An
  on-device ``isfinite`` of the loss plus the global grad norm is launched
  with the step, a CUDA event recorded after it, and the result is read
  only once that event has completed (``Event.query()``, the counterpart
  of ``jax.Array.is_ready``) or the probe is ``lag`` steps old: the probe
  adds no sync the loop was not already paying. Finite losses also feed a
  loss-spike detector (each against an EMA of the earlier ones).
* :class:`Heartbeat`: a daemon thread that flags HUNG sections: wrap a
  blocking section in :meth:`Heartbeat.expect` and the thread records a
  ``hang`` event (registry counter, flight-recorder record) the moment it
  overruns its deadline; the hung thread cannot report its own hang.
* :func:`localize_nan`: the escalation: re-run the offending computation
  under ``utils.profiling.checking()``, which traps the first operator to
  produce a non-finite value (``FloatingPointError``) and names it.

``training.loop.fit(watchdog=...)`` wires all of this: the step also
returns the grad norm (on the device), every step is probed, and a trip
re-runs the step's batch under checking, records the localization, dumps
the flight recorder's bundle and raises :class:`NonFiniteError`.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
from typing import Any, Callable, Iterator

import torch
from torch.utils._pytree import tree_leaves


class NonFiniteError(RuntimeError):
    """Training produced a non-finite loss/grad norm. Carries the step the
    watchdog flagged, the localized operator (when escalation ran) and the
    post-mortem bundle path (when a recorder dumped one)."""

    def __init__(
        self,
        step: int,
        what: str = "loss/grad_norm",
        localized: str | None = None,
        bundle: Any | None = None,
    ):
        self.step = step
        self.what = what
        self.localized = localized
        self.bundle = bundle
        msg = f"non-finite {what} at step {step}"
        if bundle is not None:
            msg += f" (post-mortem bundle: {bundle})"
        if localized:
            first = localized.strip().splitlines()
            msg += f"; first bad operator: {first[0] if first else ''}"
        super().__init__(msg)


def localize_nan(fn: Callable[[], Any]) -> str | None:
    """Re-run ``fn()`` under ``utils.profiling.checking()`` and return the
    trap's message (naming the first operator that produced a NaN or an
    infinity), or None when the re-run stayed finite (the state moved past
    the bad input, or the fault was not deterministic). Every operator's
    output is read on the host meanwhile: an incident-path diagnostic."""
    from learning_jax_sharding_tpu_torch.utils.profiling import checking

    try:
        with checking():
            out = fn()
            for leaf in tree_leaves(out):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
    except FloatingPointError as e:
        return str(e)
    except RuntimeError as e:
        # Anomaly detection reports a backward's NaN as a RuntimeError.
        if "nan" in str(e).lower():
            return str(e)
        raise
    return None


def _finite_probe(loss: Any, grad_norm: Any):
    """The fused check (loss + grad_norm is finite iff both are: an inf
    minus inf cancellation gives NaN, still caught) and an event after it
    on a CUDA stream (None on the CPU, where it is done at once)."""
    x = loss if grad_norm is None else loss + grad_norm
    finite = torch.isfinite(x.detach())
    if finite.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(finite.device))
        return finite, done
    return finite, None


class Watchdog:
    """Asynchronous numeric-health probe for a training loop.

    Call :meth:`probe` once a step with the DEVICE loss (and optionally the
    device grad norm). The finiteness check runs on the device; a result is
    consumed once ready or ``lag`` steps later, whichever comes first, so
    the watchdog adds no sync of its own. :attr:`first_bad_step` is the
    earliest flagged step; :attr:`tripped` is the cheap "should I escalate"
    test. Call :meth:`flush` after the loop to drain in-flight probes.

    Loss-spike detection: a finite loss more than ``spike_factor`` × the EMA
    of the earlier losses (after ``spike_min_steps`` observations) records
    a ``loss_spike`` event and counts ``watchdog_loss_spikes_total``.
    """

    def __init__(
        self,
        *,
        registry: Any | None = None,
        recorder: Any | None = None,
        lag: int = 2,
        ema_alpha: float = 0.1,
        spike_factor: float = 10.0,
        spike_min_steps: int = 5,
    ):
        if lag < 0:
            raise ValueError(f"lag must be >= 0, got {lag}")
        self.lag = lag
        self.ema_alpha = ema_alpha
        self.spike_factor = spike_factor
        self.spike_min_steps = spike_min_steps
        self.first_bad_step: int | None = None
        self.bad_what: str | None = None
        self.loss_ema: float | None = None
        self.spikes: list[dict] = []
        self.steps_probed = 0
        self._seen = 0
        self._pending: "collections.deque[tuple[int, Any, Any, Any, Any]]" = (
            collections.deque())
        self._recorder = None
        self._c_probes = self._c_nonfinite = self._c_spikes = None
        self.bind(registry=registry, recorder=recorder)

    def bind(self, *, registry: Any | None = None, recorder: Any | None = None) -> None:
        """Late-bind the export sinks an UNBOUND watchdog is missing
        (``fit()`` calls this with its own registry and recorder); sinks set
        at construction win."""
        if self._recorder is None:
            self._recorder = recorder
        if self._c_probes is None and registry is not None:
            self._c_probes = registry.counter(
                "watchdog_probes_total", "watchdog step probes consumed")
            self._c_nonfinite = registry.counter(
                "watchdog_nonfinite_total", "steps with non-finite health")
            self._c_spikes = registry.counter(
                "watchdog_loss_spikes_total", "losses beyond spike_factor×EMA")

    @property
    def tripped(self) -> bool:
        return self.first_bad_step is not None

    def probe(self, step: int, loss: Any, grad_norm: Any = None) -> None:
        """Launch this step's health check and consume every earlier check
        that is ready (or older than ``lag`` steps)."""
        finite, done = _finite_probe(loss, grad_norm)
        self.steps_probed += 1
        self._pending.append((step, finite, done, loss, grad_norm))
        self._drain(block_over=self.lag)

    def flush(self) -> None:
        """Consume every in-flight probe (blocking reads: the loop is over)."""
        self._drain(block_over=0)

    def _drain(self, *, block_over: int) -> None:
        while self._pending:
            step, finite, done, loss, grad_norm = self._pending[0]
            if len(self._pending) <= block_over and not (done is None or done.query()):
                return
            self._pending.popleft()
            self._consume(step, finite, loss, grad_norm)

    def _consume(self, step, finite, loss, grad_norm) -> None:
        self._seen += 1
        if self._c_probes is not None:
            self._c_probes.inc()
        if bool(finite):
            val = float(loss)
            if (
                self.loss_ema is not None
                and self._seen > self.spike_min_steps
                and abs(val) > self.spike_factor * max(abs(self.loss_ema), 1e-12)
            ):
                self.spikes.append({"step": step, "loss": val, "ema": self.loss_ema})
                if self._c_spikes is not None:
                    self._c_spikes.inc()
                if self._recorder is not None:
                    self._recorder.record("loss_spike", step=step, loss=val, ema=self.loss_ema)
            a = self.ema_alpha
            self.loss_ema = val if self.loss_ema is None else (1 - a) * self.loss_ema + a * val
            return
        what = "loss" if not math.isfinite(float(loss)) else "grad_norm"
        if self.first_bad_step is None:
            self.first_bad_step = step
            self.bad_what = what
        if self._c_nonfinite is not None:
            self._c_nonfinite.inc()
        if self._recorder is not None:
            self._recorder.record("nonfinite", step=step, what=what)


class Heartbeat:
    """Flags sections that overrun a deadline, from a SEPARATE thread,
    because the hung thread cannot report its own hang.

    >>> hb = Heartbeat(timeout=30.0, recorder=rec)
    >>> with hb:                       # starts/stops the monitor thread
    ...     with hb.expect("decode sync"):
    ...         tokens.cpu()           # the blocking read
    >>> hb.hangs                       # [] unless a section overran

    The flag is an event (``hang`` in the flight recorder, a counter in the
    registry, an entry in :attr:`hangs`): the section itself cannot be
    interrupted, but the post-mortem now knows WHICH sync wedged and for how
    long.
    """

    def __init__(
        self,
        timeout: float = 30.0,
        *,
        registry: Any | None = None,
        recorder: Any | None = None,
        poll: float | None = None,
    ):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.timeout = timeout
        self.hangs: list[dict] = []
        self._poll = poll if poll is not None else max(timeout / 4, 0.01)
        self._lock = threading.Lock()
        self._armed: tuple[str, float] | None = None   # (label, start)
        self._flagged = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._recorder = None
        self._c_hangs = None
        self.bind(registry=registry, recorder=recorder)

    def bind(self, *, registry: Any | None = None, recorder: Any | None = None) -> None:
        """Late-bind export sinks (see :meth:`Watchdog.bind`)."""
        if self._recorder is None:
            self._recorder = recorder
        if self._c_hangs is None and registry is not None:
            self._c_hangs = registry.counter(
                "watchdog_hangs_total", "sections that overran the heartbeat")

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Heartbeat":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="heartbeat", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll + 1.0)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @contextlib.contextmanager
    def expect(self, label: str) -> Iterator[None]:
        """Arm the monitor for the enclosed (blocking) section."""
        with self._lock:
            self._armed = (label, time.monotonic())
            self._flagged = False
        try:
            yield
        finally:
            with self._lock:
                self._armed = None
                self._flagged = False

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                armed, flagged = self._armed, self._flagged
                if armed is None or flagged:
                    continue
                label, start = armed
                overrun = time.monotonic() - start - self.timeout
                if overrun < 0:
                    continue
                self._flagged = True
            hang = {"label": label, "timeout": self.timeout, "overrun": overrun}
            self.hangs.append(hang)
            if self._c_hangs is not None:
                self._c_hangs.inc()
            if self._recorder is not None:
                self._recorder.record("hang", **hang)
