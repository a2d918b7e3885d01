"""Timing on the GPU: CUDA events, warmup, median; bandwidth utilization.

Port of ``learning_jax_sharding_tpu/utils/bench.py`` for the card. Times are
device times between CUDA events; a measurement needs a CUDA device and
raises without one (a CPU time is never reported as a device time).
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

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
