"""Structured per-step training metrics.

Port of ``learning_jax_sharding_tpu/utils/metrics.py``: loss, step time,
achieved TFLOP/s per device and MFU, and token throughput, one JSON object
a step (a JSONL file) mirrored to a human-readable stderr line and, with a
registry, to its ``train_*`` series.

Timing is steady-state wall clock between ``log()`` calls. Reading the loss
back to the host (``float(loss)``) inside ``log`` is the synchronization
point: it cannot complete before the step that produced it, so the
per-step wall time is honest although CUDA launches are asynchronous.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any

from learning_jax_sharding_tpu_torch.parallel.multihost import process_count
from learning_jax_sharding_tpu_torch.utils.bench import device_peak_flops


class MetricsLogger:
    """Per-step metrics: wall time, throughput, MFU, arbitrary scalars.

    >>> metrics = MetricsLogger(flops_per_step=F, tokens_per_step=B*S)
    >>> for batch in data:
    ...     state, loss = step(state, batch)
    ...     metrics.log(state.step, loss=loss)

    Args:
        path: optional JSONL file; parent dirs are created.
        stream: human-readable mirror (default stderr); None to disable.
        flops_per_step: whole-program FLOPs a step (e.g. the config's
            ``train_step_flops(b, s)``): enables TFLOP/s and MFU.
        tokens_per_step: tokens consumed a step: enables tokens/s.
        n_devices: devices sharing the work (default: the ranks of the
            default process group, or 1).
        registry: optional ``telemetry.MetricsRegistry``: every record is
            mirrored as ``train_*`` metrics (steps counter, loss/rate
            gauges, step-time histogram).

    MFU needs the card's peak (``utils.bench.device_peak_flops``): there is
    none on the CPU, and so no ``mfu`` there.
    """

    def __init__(
        self,
        path: str | os.PathLike | None = None,
        *,
        stream: IO | None = sys.stderr,
        flops_per_step: float | None = None,
        tokens_per_step: int | None = None,
        n_devices: int | None = None,
        log_every: int = 1,
        registry: Any | None = None,
    ):
        self._file: IO | None = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(os.fspath(path))), exist_ok=True)
            self._file = open(path, "a")
        self._stream = stream
        self._flops = flops_per_step
        self._tokens = tokens_per_step
        self._n_devices = n_devices if n_devices is not None else process_count()
        self._peak = device_peak_flops()
        self._log_every = max(log_every, 1)
        self._last_t: float | None = None
        self._last_step: int | None = None
        self.history: list[dict[str, Any]] = []
        self._registry = registry
        if registry is not None:
            self._m_steps = registry.counter("train_steps_total", "train steps logged")
            self._m_loss = registry.gauge("train_loss", "latest loss")
            self._m_sps = registry.gauge(
                "train_seconds_per_step", "steady-state step seconds")
            self._m_tps = registry.gauge("train_tokens_per_second", "token throughput")
            self._m_mfu = registry.gauge("train_mfu", "model FLOPs utilization [0,1]")
            self._m_step_hist = registry.histogram("train_step_seconds", "per-step wall time")

    def log(self, step: int, loss: Any = None, **scalars: Any) -> dict[str, Any] | None:
        """Record one step. Returns the record, or None when skipped by
        ``log_every``. ``loss`` may be a device tensor: reading it is the
        step's sync point, so call this every step even if most are
        skipped."""
        rec: dict[str, Any] = {"step": int(step)}
        if loss is not None:
            rec["loss"] = float(loss)  # device→host read: syncs the step
        now = time.perf_counter()
        if step % self._log_every:
            self._last_t, self._last_step = now, int(step)
            self._mirror(rec)
            return None

        if self._last_t is not None and step > self._last_step:
            dt = (now - self._last_t) / (step - self._last_step)
            rec["seconds_per_step"] = dt
            if self._tokens is not None:
                rec["tokens_per_second"] = self._tokens / dt
            if self._flops is not None:
                rec["tflops_per_chip"] = self._flops / dt / self._n_devices / 1e12
                if self._peak is not None:
                    rec["mfu"] = rec["tflops_per_chip"] * 1e12 / self._peak
        self._last_t, self._last_step = now, int(step)

        rec.update({k: float(v) for k, v in scalars.items()})
        self._mirror(rec)
        self.history.append(rec)
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._stream is not None:
            parts = [f"step {rec['step']}"]
            if "loss" in rec:
                parts.append(f"loss {rec['loss']:.4f}")
            if "seconds_per_step" in rec:
                parts.append(f"{rec['seconds_per_step'] * 1e3:.1f} ms/step")
            if "tokens_per_second" in rec:
                parts.append(f"{rec['tokens_per_second']:,.0f} tok/s")
            if "mfu" in rec:
                parts.append(f"MFU {rec['mfu']:.1%}")
            parts += [f"{k} {rec[k]:.4g}" for k in scalars]
            print("  ".join(parts), file=self._stream, flush=True)
        return rec

    def _mirror(self, rec: dict[str, Any]) -> None:
        # A skipped step's partial record (step and loss) is mirrored too.
        if self._registry is None:
            return
        self._m_steps.inc()
        if "loss" in rec:
            self._m_loss.set(rec["loss"])
        if "seconds_per_step" in rec:
            self._m_sps.set(rec["seconds_per_step"])
            self._m_step_hist.observe(rec["seconds_per_step"])
        if "tokens_per_second" in rec:
            self._m_tps.set(rec["tokens_per_second"])
        if "mfu" in rec:
            self._m_mfu.set(rec["mfu"])

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
