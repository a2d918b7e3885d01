"""Collective counts: make the implicit collectives checkable.

Port of the counting half of ``learning_jax_sharding_tpu/parallel/hlo.py``.
JAX compiles a function and counts the collectives GSPMD put in its HLO;
here the function runs once under ``CommDebugMode``, which sees every
collective DTensor and the functional collectives issue, and the counts come
back under the JAX package's op names, so a case reads the same in both.
The HLO text parser and everything built on it are ported with slice G
(the analysis stack).
"""

from __future__ import annotations

import contextlib
from typing import Callable

from torch.distributed.tensor.debug import CommDebugMode

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# torch op name fragment → JAX collective name.
_KINDS = (
    ("reduce_scatter", "reduce-scatter"),
    ("all_gather", "all-gather"),
    ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
)

_PERMUTES: list[int] = []


def note_permute() -> None:
    """Count one ring hop (``parallel.collectives``' point-to-point
    exchange, which ``CommDebugMode`` does not see) as a
    ``collective-permute`` in every count running."""
    for i in range(len(_PERMUTES)):
        _PERMUTES[i] += 1


@contextlib.contextmanager
def counting():
    """Count the collectives issued under the block: yields a dict that is
    filled in, under :data:`COLLECTIVE_OPS` names, when the block ends."""
    counts = {op: 0 for op in COLLECTIVE_OPS}
    _PERMUTES.append(0)
    mode = CommDebugMode()
    try:
        with mode:
            yield counts
    finally:
        for op, n in mode.get_comm_counts().items():
            for frag, kind in _KINDS:
                if frag in str(op):
                    counts[kind] += n
                    break
        counts["collective-permute"] += _PERMUTES.pop()


def collective_counts(fn: Callable, *args, **kwargs) -> dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once and count its collectives per kind:
    ``{"all-reduce": 1, "all-gather": 0, ...}``."""
    with counting() as counts:
        fn(*args, **kwargs)
    return counts


def assert_collectives(
    fn: Callable,
    *args,
    expect: dict[str, int] | None = None,
    forbid: tuple[str, ...] = (),
    require: tuple[str, ...] = (),
    **kwargs,
) -> dict[str, int]:
    """Assert which collectives ``fn`` issues: ``expect`` exact counts,
    ``forbid`` kinds absent, ``require`` kinds present. Returns the counts."""
    for op in (*(expect or ()), *forbid, *require):
        if op not in COLLECTIVE_OPS:
            raise ValueError(f"unknown collective op {op!r}; valid: {COLLECTIVE_OPS}")
    counts = collective_counts(fn, *args, **kwargs)
    if expect:
        for op, n in expect.items():
            if counts.get(op, 0) != n:
                raise AssertionError(f"expected {n} × {op}, got {counts.get(op, 0)}; all={counts}")
    for op in forbid:
        if counts.get(op, 0):
            raise AssertionError(f"forbidden collective {op} present: {counts}")
    for op in require:
        if not counts.get(op, 0):
            raise AssertionError(f"required collective {op} absent: {counts}")
    return counts


def compiled_hlo(*args, **kwargs):
    """The compiled program's HLO text: there is none in eager PyTorch; the
    graph-level analysis is ported with slice G (the analysis stack)."""
    raise NotImplementedError("compiled_hlo / HLO parsing: ported with slice G (analysis stack)")
