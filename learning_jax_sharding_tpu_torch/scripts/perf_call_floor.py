"""The price of one kernel launch on the card, and of one real matmul call.

Port of ``scripts/perf_call_floor.py``. The TPU script timed a chained loop
of ``CH`` calls inside one jitted program; PyTorch runs eagerly, so each
probe is timed three ways here, per call:

* ``eager``: ``CH`` launches back to back on one stream, host clock from an
  idle card to a synchronize: what eager code pays per launch (the port's
  token step is ~630 of them);
* ``graph``: the same ``CH`` launches captured once in a CUDA graph and
  replayed, CUDA events: the device-side floor, which the jitted TPU loop
  measured;
* ``queued``: launches queued behind a sleeping kernel (``queued_time``),
  as every kernel time of the port is taken.

The probes (``ops/probes.py``): the copy of one (8, 128) bf16 block against
one eager elementwise op of the same size and ``Tensor.copy_``; the matmul
(8, 2048) × (2048, 8192) in one call and as four calls of 2048 columns
(column slices of the same ``w`` into column slices of one output), against
``torch.matmul`` on the same operands.

    python -m learning_jax_sharding_tpu_torch.scripts.perf_call_floor
"""

from __future__ import annotations

import torch

from learning_jax_sharding_tpu_torch.ops.probes import copy_probe, matmul_probe
from learning_jax_sharding_tpu_torch.utils.bench import (
    bound,
    eager_time,
    graph_time,
    queued_time,
)

CH = 64
ROWS, COLS = 8, 128            # the copy probe's block
M, K, N = 8, 2048, 8192        # the matmul probe
SPLIT = 4                      # calls of the four-call form


def floor_times(call, calls: int = CH) -> dict:
    """``call()`` per call, in ms: ``eager``, ``graph`` and ``queued`` (the
    module's three ways)."""
    queued, late = queued_time(call)
    return dict(eager_ms=eager_time(call, calls) * 1e3, graph_ms=graph_time(call, calls) * 1e3,
                queued_ms=queued * 1e3, late_samples=late)


def copy_inputs(seed: int = 0, device="cuda"):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(ROWS, COLS, generator=gen, device=device).to(torch.bfloat16)
    return x, torch.empty_like(x)


def matmul_inputs(seed: int = 0, device="cuda"):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = (torch.randn(K, N, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    x = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
    return x, w, torch.empty(M, N, dtype=torch.bfloat16, device=device)


def four_calls(x, w, out):
    """The product as ``SPLIT`` launches on column slices of ``w`` into
    column slices of ``out``."""
    step = w.shape[1] // SPLIT
    for j in range(SPLIT):
        matmul_probe(x, w[:, j * step:(j + 1) * step], out[:, j * step:(j + 1) * step])
    return out


def copy_floor(device="cuda") -> dict:
    """The copy probe and its controls, each timed by :func:`floor_times`."""
    x, out = copy_inputs(device=device)
    scratch = torch.empty_like(x)
    return {
        "copy_probe": floor_times(lambda: copy_probe(x, out)),
        "elementwise": floor_times(lambda: torch.mul(x, 1.0000001, out=scratch)),
        "copy_": floor_times(lambda: scratch.copy_(x)),
    }


def matmul_floor(device="cuda") -> dict:
    """The matmul probe in one call and in four, and ``torch.matmul`` on the
    same operands, each timed by :func:`floor_times` (ms per product)."""
    x, w, out = matmul_inputs(device=device)
    scratch = torch.empty_like(out)
    rows = {
        "matmul_probe": floor_times(lambda: matmul_probe(x, w, out)),
        "matmul_probe x4": floor_times(lambda: four_calls(x, w, out)),
        "torch.matmul": floor_times(lambda: torch.matmul(x, w, out=scratch)),
    }
    nbytes = 2 * (M * K + K * N + M * N)
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * M * K * N)
    return rows


def report(rows: dict, label: str) -> None:
    for name, row in rows.items():
        extra = f", bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})" if "bound_ms" in row \
            else ""
        print(f"[floor] {label} {name}: eager {row['eager_ms'] * 1e3:.2f} us, graph "
              f"{row['graph_ms'] * 1e3:.2f} us, queued {row['queued_ms'] * 1e3:.2f} us per "
              f"call{extra}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("perf_call_floor measures the card: no CUDA device")
    print(f"[floor] {torch.cuda.get_device_name(0)}, {CH} calls a sample", flush=True)
    report(copy_floor(), f"({ROWS}, {COLS}) bf16")
    report(matmul_floor(), f"({M}, {K}) x ({K}, {N}) bf16")


if __name__ == "__main__":
    main()
