"""Timing on the GPU: CUDA events, warmup, median; bandwidth utilization.

Port of ``learning_jax_sharding_tpu/utils/bench.py`` for the card. Times are
device times between CUDA events, or host times around work that ends in a
synchronize; a measurement needs a CUDA device and raises without one (a CPU
time is never reported as a device time). Beside the JAX module's
``time_fn`` and ``measure``: :func:`queued_time` (kernels timed back to back
behind a sleeping kernel), :func:`eager_time` and :func:`graph_time` (the
host's launch cost against the device's, per call) and :func:`bound` (the
least time the card takes for some bytes and operations).
"""

from __future__ import annotations

import dataclasses
import re
import statistics
import time
from collections import Counter
from typing import Callable

import torch

#: The port's own kernels by name, with their template arguments, in a
#: profile: every ``csrc/*.cu`` kernel's name starts so.
PORT_KERNELS = r"(?:flash_|decode_attention|int4_|fused_norm_|probe_)\w*(?:<[^>]*>)?"

# Peak device-memory bandwidth, bytes/s, by a substring of
# torch.cuda.get_device_name() (NVIDIA data sheets; "H100 80GB HBM3" is the
# SXM part). Checked in order, so the more specific names come first.
PEAK_HBM_BYTES: tuple[tuple[str, float], ...] = (
    ("H100 80GB HBM3", 3.35e12),
    ("H100 SXM", 3.35e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H200", 4.8e12),
)

# Peak dense bf16 tensor-core rate, FLOP/s, keyed the same way.
PEAK_BF16_FLOPS: tuple[tuple[str, float], ...] = (
    ("H100 80GB HBM3", 989e12),
    ("H100 SXM", 989e12),
    ("H100 NVL", 835e12),
    ("H100 PCIe", 756e12),
    ("H200", 989e12),
)


def _lookup(table, name: str | None) -> float | None:
    if name is None:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name()
    for key, value in table:
        if key in name:
            return value
    return None


def device_peak_hbm_bw(name: str | None = None) -> float | None:
    """Peak memory bytes/s of the card named ``name`` (default: the current
    card), or None if unknown."""
    return _lookup(PEAK_HBM_BYTES, name)


def device_peak_flops(name: str | None = None) -> float | None:
    """Peak dense bf16 FLOP/s of the card, or None if unknown."""
    return _lookup(PEAK_BF16_FLOPS, name)


def mbu(bytes_per_iter: float, seconds_per_iter: float, name: str | None = None) -> float | None:
    """Memory-bandwidth utilization: achieved bytes/s over the card's peak."""
    peak = device_peak_hbm_bw(name)
    if peak is None or seconds_per_iter <= 0:
        return None
    return bytes_per_iter / seconds_per_iter / peak


def time_fn(
    fn: Callable, *args, warmup: int = 3, repeats: int = 11, inner: int = 10, **kwargs
) -> float:
    """Median device seconds per call of ``fn(*args, **kwargs)``.

    After ``warmup`` calls, each of ``repeats`` samples times ``inner``
    back-to-back calls between two CUDA events on the current stream; the
    result is the median sample over ``inner``."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn measures device time and needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / inner)
    return statistics.median(samples)


def mfu(flops_per_iter: float, seconds_per_iter: float, name: str | None = None) -> float | None:
    """Model-FLOPs utilization: achieved FLOP/s over the card's dense bf16
    peak (None when the card is unknown)."""
    peak = device_peak_flops(name)
    if peak is None or seconds_per_iter <= 0:
        return None
    return flops_per_iter / seconds_per_iter / peak


def _sync(out) -> None:
    """Wait until the work producing ``out`` is done: synchronize the device
    of every CUDA tensor in ``out`` (tensors nested in lists, tuples and
    dicts); CPU tensors and other values need nothing. The port's one
    definition of "synced" (``telemetry/spans.py::device_sync``)."""
    from torch.utils._pytree import tree_leaves

    devices = {t.device for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def _need_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the card and needs a CUDA device")


def bound(nbytes: float, ops: float, peak: float | None = None) -> tuple[float, str]:
    """The least time the card takes: bytes over its memory rate or
    operations over its peak for their type (default bf16), whichever is
    larger (ms, and which: ``"bytes"`` or ``"operations"``)."""
    t_bytes = nbytes / (device_peak_hbm_bw() or 3.35e12) * 1e3
    t_ops = ops / (peak or device_peak_flops() or 989e12) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def queued_time(fn, *args, inner=20, repeats=7, **kwargs):
    """Median device seconds per call of ``fn``, as kernels run back to back:
    each sample enqueues ``inner`` calls behind a sleeping kernel, so the
    CUDA events time the device work and not the host's launch overhead
    (which exceeds a decode-size kernel). Returns (seconds, samples whose
    enqueue outlasted the sleep, which may hold host gaps)."""
    _need_cuda("queued_time")
    for _ in range(3):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    samples, late = [], 0
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)        # ~10 ms at the H100's clocks
        start.record()
        for _ in range(inner):
            fn(*args, **kwargs)
        late += bool(start.query())          # the sleep ended before the enqueue did
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / inner)
    return statistics.median(samples), late


def eager_time(fn: Callable, calls: int = 64, repeats: int = 5) -> float:
    """Median host seconds per call of ``fn()`` over ``calls`` back-to-back
    calls on the current stream, from an idle device to a synchronize: what
    eager code pays per call, the host's launch cost included."""
    _need_cuda("eager_time")
    for _ in range(3):
        fn()
    samples = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / calls)
    return statistics.median(samples)


def graph_time(fn: Callable, calls: int = 64, repeats: int = 5) -> float:
    """Median device seconds per call of ``fn()`` with ``calls`` calls
    captured once in a CUDA graph and replayed (CUDA events around each
    replay): the launches' device-side cost without the host's. ``fn`` must
    allocate nothing it keeps and may run only on the current stream."""
    _need_cuda("graph_time")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / calls)
    del graph
    return statistics.median(samples)


@dataclasses.dataclass(frozen=True)
class BenchResult:
    """One timed function: seconds per call, its FLOPs, the card's peak."""

    seconds_per_iter: float
    flops: float | None
    peak_flops: float | None
    samples: tuple[float, ...] = ()

    @property
    def mfu(self) -> float | None:
        if self.flops is None or self.peak_flops is None or self.seconds_per_iter <= 0:
            return None
        return self.flops / self.seconds_per_iter / self.peak_flops


def measure(fn: Callable, *args, flops: float | None = None, warmup: int = 1, repeats: int = 3,
            **kwargs) -> BenchResult:
    """Time ``fn(*args, **kwargs)`` and derive its throughput and MFU on this
    card: after ``warmup`` calls, ``repeats`` calls each between a
    synchronize and a synchronize on the host clock (a train step's call is
    milliseconds of eager work, its host time included), the median.
    ``flops``: per call (the JAX module reads XLA's cost analysis when it is
    None; here it stays None)."""
    _need_cuda("measure")
    for _ in range(warmup):
        fn(*args, **kwargs)
    samples = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return BenchResult(seconds_per_iter=statistics.median(samples), flops=flops,
                       peak_flops=device_peak_flops(), samples=tuple(samples))


RAW_EVENT_METHODS = ("name", "duration_ns", "device_type", "is_user_annotation")


def raw_events(prof, device_type) -> list[tuple[str, int]]:
    """(name, duration in ns) of each raw event a finished ``torch.profiler``
    run recorded on ``device_type``, annotations left out. Reads
    ``prof.profiler.kineto_results.events()``, which is not a public API:
    where this PyTorch lacks it, or an event lacks one of
    ``RAW_EVENT_METHODS``, this raises rather than count otherwise."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None or not callable(getattr(results, "events", None)):
        raise RuntimeError(f"torch {torch.__version__}: the profiler has no "
                           f"kineto_results.events(); device_profile cannot count kernels")
    events = results.events()
    for e in events[:1]:
        missing = [m for m in RAW_EVENT_METHODS if not callable(getattr(e, m, None))]
        if missing:
            raise RuntimeError(f"torch {torch.__version__}: a raw profiler event lacks {missing}")
    return [(e.name(), e.duration_ns()) for e in events
            if e.device_type() == device_type and not e.is_user_annotation()]


def device_profile(run: Callable, steps: int = 1) -> dict:
    """``run()`` (``steps`` steps) once under ``torch.profiler``: device
    kernels a step, device-busy ms a step, ms a step by kernel name, and the
    port's own kernels (``PORT_KERNELS``) among them: their count a step and
    their ms a step by name. Ranges that annotations draw over the kernels
    they enclose are left out. Reads the profiler's raw device events: the
    profiler's own event tree (``events()``) takes tens of seconds to build
    for a whole generate's ~10⁵ kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _need_cuda("device_profile")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = raw_events(prof, DeviceType.CUDA)
    if not kernels:
        raise AssertionError("the profiler saw no device kernels")
    by_name, port, port_ms = Counter(), Counter(), Counter()
    for name, ns in kernels:
        ms = ns / 1e6 / steps
        by_name[name] += ms
        if found := re.search(PORT_KERNELS, name):
            port[found.group(0)] += 1 / steps
            port_ms[found.group(0)] += ms
    return dict(kernels=len(kernels) / steps, busy_ms=sum(by_name.values()), by_name=by_name,
                port=sum(port.values()), port_by_name=dict(sorted(port.items())),
                port_ms_by_name=dict(sorted(port_ms.items())))
