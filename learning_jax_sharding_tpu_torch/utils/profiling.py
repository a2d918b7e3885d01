"""Tracing / profiling and the nearest thing to a sanitizer.

Port of ``learning_jax_sharding_tpu/utils/profiling.py`` onto the PyTorch
profiler:

* :func:`trace`: a ``torch.profiler`` capture of the enclosed block (host
  activity, and the card's kernels when there is one), written as a Chrome
  trace (``trace.json``, Perfetto-loadable) under ``logdir``;
* :func:`annotate`: a named range (``torch.profiler.record_function``) so
  framework phases are findable in that timeline;
* :func:`checking`: NaN/Inf trapping, scoped and restored on exit: every
  operator's floating outputs are checked as they are produced (raising
  ``FloatingPointError`` at the first non-finite one), and autograd's
  anomaly detection names the forward operator of a failing backward.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str | os.PathLike) -> Iterator[torch.profiler.profile]:
    """Capture a profiler trace of the enclosed block into
    ``logdir/trace.json`` and yield the profiler (its ``key_averages()``
    and ``events()`` hold the same capture). The capture includes the host's
    operators and every :func:`annotate` range, and the card's kernels
    when CUDA is available."""
    os.makedirs(os.fspath(logdir), exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(os.fspath(logdir), "trace.json"))


def annotate(name: str) -> torch.profiler.record_function:
    """Named range visible in the profiler timeline::

        with annotate("train_step"):
            state, loss = step(state, batch)
    """
    return torch.profiler.record_function(name)


class _NonFiniteTrap(TorchDispatchMode):
    """Raise ``FloatingPointError`` the moment an operator produces a NaN or
    an infinity in a floating output (JAX's ``jax_debug_nans``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(f"non-finite value in the output of {func}")
        return out


@contextlib.contextmanager
def checking(*, nans: bool = True, checks: bool = True) -> Iterator[None]:
    """Scoped debug mode: trap NaN/Inf the moment an operator produces one
    (``nans``) and turn on autograd's anomaly detection (``checks``: a
    failing backward names its forward operator; with ``nans`` also a NaN
    in a backward result raises).

    Every operator's outputs are read on the host: a debugging tool, not a
    production setting."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    trap = _NonFiniteTrap() if nans else None
    try:
        torch.set_anomaly_enabled(checks, nans)
        if trap is not None:
            trap.__enter__()
        yield
    finally:
        # The block typically exits by RAISING (that is the tool's point),
        # so the restore is exception-safe: the trap leaves first, then the
        # anomaly flags return under their own finally.
        try:
            if trap is not None:
                trap.__exit__(None, None, None)
        finally:
            torch.set_anomaly_enabled(*prev)
