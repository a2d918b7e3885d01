"""Deterministic fault injection at the stack's seam points.

Port of ``learning_jax_sharding_tpu/robustness/chaos.py``. Production code
calls :func:`chaos_hook` at a handful of named seam points, and an
installed :class:`ChaosInjector` fires :class:`Fault` specs at exact
invocation indices of those sites: the same chaos run replays identically.

Sites in the port (the hook is one module-global ``None`` check when no
injector is installed):

========================  ====================================================
``engine.dispatch``       before each engine dispatch (refill / decode /
                          mixed); ``rids=`` carries the involved requests.
                          Kinds: ``raise`` (``error=FloatingPointError`` for
                          a NaN trap), ``hang`` (a hung dispatch aborted by
                          a watchdog), ``slow`` (sleep ``delay_s``).
``engine.page_alloc``     inside the paged allocator's ``_take_page``. Kind
                          ``oom`` raises the allocator's own RuntimeError:
                          the engine's recompute-preemption path.
``engine.admit``          at slot admission; ``value`` is the request's
                          prompt. Kind ``mutate`` corrupts it (the engine
                          must fail the request, not wedge the slot).
``train.step``            top of each ``fit()`` step. Kinds ``sigterm``
                          (the preemption drill), ``slow``.
``train.batch``           after the step's batch is fetched; ``value`` is
                          the batch. Kind ``mutate`` poisons it (a poisoned
                          batch makes the NaN inside the step, so the skip
                          guard is exercised for real).
``train.loss``            the host's reading of the step's loss; ``value``
                          is the float. Kinds ``mutate`` (the spike drill),
                          ``nan``.
========================  ====================================================

The fleet's sites come with the modules that call them. Checkpoint
corruption needs no hook (the files are on the host):
:func:`corrupt_latest_checkpoint` truncates or garbles the newest retained
step on disk, so ``CheckpointManager.restore_latest`` must fall back.

Every firing is recorded (``chaos.inject`` events) to the injector's
flight recorder.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import signal
import time
from typing import Any, Callable, Optional


class InjectedFault(RuntimeError):
    """A chaos-injected dispatch failure (the simulated hang/abort the
    engine's quarantine policy recovers from)."""

    def __init__(self, site: str, kind: str, message: str = ""):
        self.site = site
        self.kind = kind
        super().__init__(message or f"chaos: injected {kind} at {site}")


@dataclasses.dataclass
class Fault:
    """One fault spec: fire ``count`` times at the ``at``-th ELIGIBLE
    invocation of ``site`` (0-based; ``count=-1`` = keep firing forever).

    ``rid`` restricts eligibility to invocations whose context names
    that request (``rids=`` at the dispatch site) — a sticky ``rid``
    fault models a poison request: every dispatch containing it fails,
    every dispatch without it succeeds.
    """

    site: str
    kind: str                      # raise|hang|slow|oom|mutate|sigterm|nan
    at: int = 0
    count: int = 1
    delay_s: float = 0.05          # for kind="slow"
    rid: Optional[int] = None      # restrict to dispatches naming this rid
    mutate: Optional[Callable[[Any], Any]] = None   # for kind="mutate"
    error: Optional[type] = None   # exception class for kind="raise"
    seen: int = 0                  # eligible invocations observed (mutated)
    fired: int = 0                 # times actually fired (mutated)

    def __post_init__(self):
        if self.kind == "mutate" and self.mutate is None:
            raise ValueError("kind='mutate' needs a mutate callable")
        if self.at < 0:
            raise ValueError(f"at must be >= 0, got {self.at}")


_ACTIVE: "ChaosInjector | None" = None


class ChaosInjector:
    """Installs a set of :class:`Fault` specs over the seam points.

    >>> with ChaosInjector(Fault("engine.dispatch", "hang", at=2)):
    ...     serve(...)             # the 3rd dispatch raises InjectedFault

    One injector is active at a time (nesting restores the previous on
    exit). ``injections`` lists every firing for test assertions.
    """

    def __init__(self, *faults: Fault, recorder: Any | None = None):
        self.faults = list(faults)
        if recorder is None:
            from learning_jax_sharding_tpu_torch.telemetry import (
                default_flight_recorder,
            )

            recorder = default_flight_recorder()
        self.recorder = recorder
        self.injections: list[dict] = []
        self._prev: "ChaosInjector | None" = None

    def __enter__(self) -> "ChaosInjector":
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = self._prev

    def fire(self, site: str, value: Any, ctx: dict) -> Any:
        for f in self.faults:
            if f.site != site:
                continue
            if f.rid is not None and f.rid not in (ctx.get("rids") or ()):
                continue
            n = f.seen
            f.seen += 1
            if n < f.at or (f.count >= 0 and n >= f.at + f.count):
                continue
            f.fired += 1
            rec = {"site": site, "fault": f.kind, "invocation": n}
            rec.update({k: v for k, v in ctx.items() if k != "value"})
            self.injections.append(rec)
            self.recorder.record("chaos.inject", **rec)
            value = self._act(f, site, value)
        return value

    def _act(self, f: Fault, site: str, value: Any) -> Any:
        if f.kind == "slow":
            time.sleep(f.delay_s)
            return value
        if f.kind == "hang":
            # A truly hung dispatch cannot return; what the stack SEES is
            # the hang watchdog's deadline trip aborting the section —
            # modeled as this raise at the dispatch seam.
            raise InjectedFault(site, "hang", "chaos: dispatch hang (simulated watchdog-deadline abort)")
        if f.kind == "raise":
            err = f.error or InjectedFault
            if err is InjectedFault:
                raise InjectedFault(site, "raise")
            raise err(f"chaos: injected {err.__name__} at {site}")
        if f.kind == "oom":
            # The paged allocator's own exception type/text, so the
            # engine's existing backpressure handler takes it.
            raise RuntimeError("page pool exhausted (chaos-injected OOM)")
        if f.kind == "mutate":
            return f.mutate(value)
        if f.kind == "nan":
            return float("nan")
        if f.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return value
        raise ValueError(f"unknown fault kind {f.kind!r}")


def chaos_hook(site: str, value: Any = None, **ctx: Any) -> Any:
    """The seam-point call. No injector installed: returns ``value``
    untouched (one global ``None`` check — the production-path cost)."""
    inj = _ACTIVE
    if inj is None:
        return value
    return inj.fire(site, value, ctx)


def chaos_active() -> bool:
    """Whether an injector is installed (a seam may skip the work that only
    a fault needs)."""
    return _ACTIVE is not None


def corrupt_latest_checkpoint(
    directory: str | os.PathLike,
    *,
    mode: str = "truncate",
    recorder: Any | None = None,
) -> int | None:
    """Corrupt the NEWEST retained checkpoint step on disk (the
    partial-write / bit-rot fault ``CheckpointManager.restore_latest`` must
    survive by falling back to an older step).

    ``mode="truncate"`` halves every file under the step's directory;
    ``mode="garble"`` overwrites each file's head with junk bytes. Returns
    the corrupted step, or None when the directory holds no checkpoint."""
    root = pathlib.Path(os.fspath(directory))
    steps = sorted(
        (int(p.name), p) for p in root.iterdir() if p.is_dir() and p.name.isdigit()
    ) if root.exists() else []
    if not steps:
        return None
    step, stepdir = steps[-1]
    for f in sorted(stepdir.rglob("*")):
        if not f.is_file():
            continue
        size = f.stat().st_size
        if mode == "truncate":
            with open(f, "r+b") as fh:
                fh.truncate(size // 2)
        elif mode == "garble":
            with open(f, "r+b") as fh:
                fh.write(b"\xde\xad\xbe\xef" * 4)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    if recorder is not None:
        recorder.record("chaos.corrupt_checkpoint", step=step, mode=mode)
    return step
