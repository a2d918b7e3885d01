"""Mesh construction over ``torch.distributed``'s ``DeviceMesh``.

Port of ``learning_jax_sharding_tpu/parallel/mesh.py``. A JAX ``Mesh`` is an
array of the devices one process sees; a ``DeviceMesh`` is an array of the
RANKS of a process group, one process a device. So the counterpart of
``force_emulated_devices`` (8 emulated CPU devices in one process) is
:func:`run_on_mesh`, which spawns one process a rank over ``gloo`` and runs a
function on every rank with the mesh built there; :func:`run_on_threads` runs
the ranks as threads of one process instead, for ranks that share one card.

Axis-name conventions follow the JAX package: ``"data"`` (batch) and
``"model"`` (tensor parallel), or any names the caller gives.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
import warnings
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: Default 2-D mesh axis names (the JAX package's).
DEFAULT_AXIS_NAMES: tuple[str, ...] = (DATA_AXIS, MODEL_AXIS)


def _infer_shape(n_devices: int, ndim: int) -> tuple[int, ...]:
    """A balanced ``ndim``-D factorization of ``n_devices`` (8 → (2, 4),
    16 → (4, 4)): the JAX package's rule."""
    if ndim == 1:
        return (n_devices,)
    if ndim != 2:
        raise ValueError(f"automatic shape inference supports 1D/2D, got ndim={ndim}")
    best = (1, n_devices)
    for a in range(1, int(math.isqrt(n_devices)) + 1):
        if n_devices % a == 0:
            best = (a, n_devices // a)
    return best


def _device_type(device_type: str | None) -> str:
    """``None`` → ``cuda``, raising without a GPU (the port's rule: nothing
    falls back to the CPU on its own)."""
    if device_type is not None:
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device_type='cpu' for a CPU mesh")
    return "cuda"


def _ensure_group(device_type: str) -> None:
    """A one-rank default process group (an in-memory store, no file and no
    port) when none exists, so a one-device mesh needs no launcher."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def build_mesh(
    shape: Sequence[int] | None = None,
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
    *,
    device_type: str | None = None,
) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the ranks of the default process
    group (``None``: a balanced shape over all of them). Uses the first
    ``prod(shape)`` ranks, warning when some stay idle, as the JAX
    ``build_mesh`` uses the first devices."""
    device_type = _device_type(device_type)
    _ensure_group(device_type)
    # DTensor logs a warning for every two-axis reduction it issues as two
    # all-reduces (the (2, 4) meshes' partial sums): that is the plan here.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = _infer_shape(world, len(axis_names))
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} rank != axis_names {axis_names} rank")
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world}")
    if n < world:
        warnings.warn(
            f"mesh shape {shape} uses only {n} of {world} devices; the rest stay idle",
            stacklevel=2,
        )
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axis_names)


def build_hybrid_mesh(*args, **kwargs):
    """The ICI × DCN mesh of a multi-slice pod: ported with slice D
    (training breadth, item 12)."""
    raise NotImplementedError("build_hybrid_mesh: ported with slice D (item 12)")


def single_device_mesh(
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES, *, device_type: str | None = None
) -> DeviceMesh:
    """A mesh with every axis of size 1 on this process's device: every
    sharded program runs unchanged on one GPU."""
    return build_mesh((1,) * len(tuple(axis_names)), axis_names, device_type=device_type)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh description, for configs and checkpoint metadata."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...] = DEFAULT_AXIS_NAMES

    def build(self, device_type: str | None = None) -> DeviceMesh:
        return build_mesh(self.shape, self.axis_names, device_type=device_type)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _rank_main(rank, world, init_file, backend, device_type, shape, axis_names,
               fn, args, results, threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(0 if torch.cuda.device_count() == 1 else rank)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank, world_size=world
        )
        mesh = build_mesh(shape, axis_names, device_type=device_type)
        out = fn(mesh, *args)
        dist.barrier()
        results.put((rank, "ok", out if rank == 0 else None))
    except Exception:                        # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_on_mesh(
    fn: Callable[..., Any],
    shape: Sequence[int],
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
    *,
    device_type: str = "cpu",
    backend: str = "gloo",
    args: tuple = (),
    timeout: float = 600.0,
    threads: int | None = 1,
) -> Any:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh and return
    rank 0's result: the counterpart of ``force_emulated_devices``.

    Spawns one process a rank (``multiprocessing``'s spawn start method, so
    ``fn`` and ``args`` must pickle: a module-level function). The group
    meets through a ``file://`` store in a fresh temporary directory, so
    concurrent runs never share a port. ``device_type="cuda"`` puts every
    rank on the one card when there is one (``backend="gloo"`` then: NCCL
    refuses two ranks on one GPU). ``threads``: intra-op threads a rank.
    An exception on any rank stops every rank and raises here with its
    traceback; so does a run past ``timeout`` seconds."""
    shape = tuple(int(s) for s in shape)
    world = math.prod(shape)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mesh_")
    results = ctx.Queue()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(rank, world, os.path.join(tmp, "store"), backend, device_type, shape,
                  tuple(axis_names), fn, args, results, threads),
            daemon=True,
        )
        for rank in range(world)
    ]
    try:
        for p in procs:
            p.start()
        out, done, deadline = None, 0, time.monotonic() + timeout
        while done < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                # A rank that died before it could report (at start-up, or
                # killed) ends the run now, not at the deadline.
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_on_mesh: rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} before reporting") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"run_on_mesh: no result within {timeout} s") from None
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            if rank == 0:
                out = value
            done += 1
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def run_on_threads(
    fn: Callable[..., Any],
    shape: Sequence[int],
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
    *,
    device_type: str = "cpu",
    args: tuple = (),
) -> Any:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh, each rank a
    thread of this process, and return rank 0's result: several ranks on
    one card (NCCL refuses two ranks on one GPU). The group is torch's
    in-process ``"threaded"`` backend (``torch.testing._internal``), whose
    collectives copy between the ranks' tensors wherever they lie (it has
    no point-to-point sends, so the port's ring hops are all-to-alls,
    ``parallel.collectives``); autograd runs on the calling thread
    meanwhile (that backend's condition). An
    exception on any rank wakes the ranks waiting in a collective and
    raises here with its traceback."""
    from torch.testing._internal.distributed import multi_threaded_pg as threaded

    world = math.prod(int(s) for s in shape)
    store, results, errors = dist.HashStore(), [None] * world, []

    def rank_main(rank):
        try:
            dist.init_process_group("threaded", store=store, rank=rank, world_size=world)
            results[rank] = fn(build_mesh(shape, axis_names, device_type=device_type), *args)
        except BaseException as exc:         # raised by the caller below
            errors.append((rank, traceback.format_exc()))
            threaded.ProcessLocalGroup.exception_handle(exc)
        # No destroy_process_group: the groups live in this thread's world
        # and go with it (torch 2.11's destroy reads a field that its
        # threaded world lacks).

    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    threaded._install_threaded_pg()
    try:
        ranks = [threading.Thread(target=rank_main, args=(r,)) for r in range(world)]
        for t in ranks:
            t.start()
        for t in ranks:
            t.join()
    finally:
        threaded._uninstall_threaded_pg()
        threaded.ProcessLocalGroup.reset()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errors:                               # the first is the cause, the rest woken
        raise RuntimeError(f"rank {errors[0][0]} failed:\n{errors[0][1]}")
    return results[0]
