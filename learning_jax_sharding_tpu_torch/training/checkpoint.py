"""Sharded checkpoint / resume of the train state.

Port of ``learning_jax_sharding_tpu/training/checkpoint.py`` onto
``torch.distributed.checkpoint`` (DCP) in place of Orbax. A checkpoint of a
``training.pipeline.TrainState`` holds the model's state dict, the
optimizer's state tensors by parameter name, the step and the count of
updates made (which differ once the non-finite guard skipped a step):

* over a mesh every rank writes only its own shards (DTensor's), and a
  restore reads each target shard from whatever shards hold it, so a
  checkpoint restores onto another mesh, or onto one device;
* the step directory ``<dir>/<step>`` appears only once complete (written
  as ``<step>.partial`` and renamed), so a crash mid-write leaves no step
  that looks whole.

The port's state is updated IN PLACE, while the JAX state is immutable. So
a save snapshots the state before it returns: on one device the tensors
are copied into reused host buffers (pinned, ``non_blocking``, queued on
the current stream behind the step that made them and ahead of the next
one, so no later in-place update can reach the snapshot), and a background
thread writes the files once those copies are done. Over a mesh of several
ranks the save is synchronous: DCP's planning is collective, and a
background thread's collectives would race the step's.

``restore`` fills the given state in place and returns it (the JAX restore
returns a new state).
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor

_PARTIAL = ".partial"


def _optim_state(state) -> dict[str, torch.Tensor]:
    """The optimizer's state tensors keyed ``<parameter name>/<slot>``."""
    opt = state.optimizer.state
    return {f"{name}/{slot}": v
            for name, p in state.model.named_parameters() if p in opt
            for slot, v in opt[p].items() if isinstance(v, torch.Tensor)}


def _state_dict(state, *, optim: bool = True) -> dict:
    sd = {
        "model": state.model.state_dict(),
        "train": {"step": torch.tensor(int(state.step)),
                  "updates": torch.tensor(int(getattr(state, "updates", state.step)))},
    }
    if optim:
        slots = _optim_state(state)
        if slots:
            sd["optim"] = slots
    return sd


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _spread(sd: dict) -> bool:
    """Whether any tensor is a DTensor over more than one rank."""
    return any(isinstance(v, DTensor) and v.device_mesh.size() > 1 for _, v in _leaves(sd))


def _init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Give an optimizer with no state its state, without moving a
    parameter: one step on zero gradients at a zero learning rate (the
    slots are then overwritten by the restore). Gradients and rates are
    put back."""
    if optimizer.state:
        return
    params = [p for g in optimizer.param_groups for p in g["params"] if p.requires_grad]
    grads = [p.grad for p in params]
    lrs = [g["lr"] for g in optimizer.param_groups]
    try:
        for p in params:
            p.grad = torch.zeros_like(p)
        for g in optimizer.param_groups:
            g["lr"] = 0.0
        optimizer.step()
    finally:
        for p, grad in zip(params, grads):
            p.grad = grad
        for g, lr in zip(optimizer.param_groups, lrs):
            g["lr"] = lr


class CheckpointManager:
    """Step-indexed sharded checkpoints with retention and background writes.

    >>> ckpt = CheckpointManager(dir, max_to_keep=3, save_interval_steps=100)
    >>> ckpt.save(step, state)                      # no-op off the interval
    >>> state = ckpt.restore_latest(like=state)     # None if nothing on disk
    """

    def __init__(
        self,
        directory: str | os.PathLike,
        *,
        max_to_keep: int | None = 3,
        save_interval_steps: int = 1,
        recorder: Any | None = None,
    ):
        self.directory = Path(os.path.abspath(os.fspath(directory)))
        self._max_to_keep = max_to_keep
        self._interval = max(int(save_interval_steps), 1)
        # Restore failures (a corrupt step → fallback) land in the flight
        # recorder when one is given.
        self._recorder = recorder
        self._buffers: dict[str, torch.Tensor] = {}
        self._writer: threading.Thread | None = None
        self._pending: int | None = None
        self._error: BaseException | None = None
        if self._primary():
            self.directory.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _primary() -> bool:
        return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0

    # --- saving ------------------------------------------------------------

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Persist ``state`` at ``step``. Returns False when skipped by the
        save interval (``force`` saves anyway) or when ``step`` is already
        saved. On one device the snapshot is taken before this returns and
        the files are written in the background (:meth:`wait` before
        reading them back); over a mesh it returns once written."""
        step = int(step)
        if (not force and step % self._interval) or step in self.all_steps():
            return False
        sd = _state_dict(state)
        if _spread(sd):
            self._save_sync(step, sd)
            return True
        self.wait()                    # the host buffers are reused
        staged, ready = self._stage(sd)
        self._pending = step
        self._writer = threading.Thread(target=self._write, args=(step, staged, ready),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        return True

    def _stage(self, sd: dict):
        """Copy every tensor into this manager's host buffers. A CUDA tensor
        is copied ``non_blocking`` into pinned memory on the current stream
        (ordered after the step that wrote it, before the next); the
        returned event marks the copies done."""
        staged, cuda = {}, False
        for key, t in _leaves(sd):
            t = t.to_local() if isinstance(t, DTensor) else t
            t = t.detach()
            buf = self._buffers.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                  pin_memory=t.is_cuda)
                self._buffers[key] = buf
            buf.copy_(t, non_blocking=t.is_cuda)
            cuda = cuda or t.is_cuda
            staged[key] = buf
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
        return staged, ready

    def _write(self, step: int, staged: dict, ready) -> None:
        try:
            if ready is not None:
                ready.synchronize()
            tmp = self.directory / f"{step}{_PARTIAL}"
            shutil.rmtree(tmp, ignore_errors=True)
            dcp.save(staged, checkpoint_id=tmp, no_dist=True)
            self._commit(step)
        except BaseException as e:      # raised by wait()
            self._error = e

    def _save_sync(self, step: int, sd: dict) -> None:
        tmp = self.directory / f"{step}{_PARTIAL}"
        if self._primary():
            shutil.rmtree(tmp, ignore_errors=True)
        dist.barrier()
        dcp.save(sd, checkpoint_id=tmp)
        dist.barrier()
        if self._primary():
            self._commit(step)
        dist.barrier()

    def _commit(self, step: int) -> None:
        """Rename the finished step into place, then drop the oldest steps
        past ``max_to_keep``."""
        os.replace(self.directory / f"{step}{_PARTIAL}", self.directory / str(step))
        if self._max_to_keep is not None:
            for old in self._committed()[:-self._max_to_keep]:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)

    # --- restoring ---------------------------------------------------------

    def restore(self, step: int, *, like: Any) -> Any:
        """Load the checkpoint at ``step`` into ``like`` (a ``TrainState``,
        on one device or over any mesh) in place, and return it."""
        self.wait()
        path = self.directory / str(int(step))
        if not path.is_dir():
            raise FileNotFoundError(f"no checkpoint at step {step} under {self.directory}")
        keys = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        if any(k.startswith("optim.") for k in keys):
            _init_optimizer_state(like.optimizer)
            target = _state_dict(like)
        else:
            # Saved before the first update: the optimizer had no state.
            like.optimizer.state.clear()
            target = _state_dict(like, optim=False)
        dcp.load(target, checkpoint_id=path, no_dist=not _spread(target))
        like.step = int(target["train"]["step"])
        if hasattr(like, "updates"):
            like.updates = int(target["train"]["updates"])
        return like

    def restore_latest(self, *, like: Any, strict: bool = False) -> Any | None:
        """Resume from the newest RESTORABLE checkpoint, or None if the
        directory holds none (``like`` is then untouched).

        A corrupt or truncated newest step FALLS BACK to the next older
        retained one; every failed step is recorded (``checkpoint.corrupt``
        in the attached flight recorder, then ``checkpoint.fallback``). If
        every retained step fails the last error propagates. ``strict=True``
        restores only the newest or raises."""
        self.wait()
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        last_err: Exception | None = None
        for step in steps:
            try:
                restored = self.restore(step, like=like)
            except Exception as e:
                last_err = e
                if self._recorder is not None:
                    self._recorder.record("checkpoint.corrupt", step=step,
                                          error=f"{type(e).__name__}: {e}")
                if strict:
                    raise
                continue
            if step != steps[0] and self._recorder is not None:
                self._recorder.record("checkpoint.fallback", restored_step=step,
                                      skipped=[s for s in steps if s > step])
            return restored
        raise RuntimeError(
            f"every retained checkpoint failed to restore (tried newest-first: {steps})"
        ) from last_err

    # --- bookkeeping -------------------------------------------------------

    def _committed(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def all_steps(self) -> list[int]:
        """Saved steps, oldest first (a step still being written included)."""
        steps = set(self._committed())
        if self._pending is not None and self._writer is not None and self._writer.is_alive():
            steps.add(self._pending)
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the background write is on disk; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer, self._pending = None, None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
        self._buffers.clear()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def restore_params_for_serving(
    manager: CheckpointManager,
    *,
    like: Any,
    dst_shardings: Any,
    step: int | None = None,
    strict: bool = False,
    plan_cache: dict | None = None,
    jit_cache: dict | None = None,
) -> tuple[Any, dict] | None:
    """Restore a checkpointed state's PARAMETERS straight into the serving
    layout: the disk half of the weight swap.

    Restores ``step`` (or the newest restorable one, with
    :meth:`CheckpointManager.restore_latest`'s fallback) into ``like`` (a
    ``TrainState``), takes its model's state dict and runs it through
    ``parallel.resharding.reshard_tree`` into ``dst_shardings`` (the
    engine's live layout: ``tenancy.hot_swap.serving_shardings(params)``),
    the path ``engine.swap_weights`` stages with. Returns ``(staged params,
    transfer stats)``, or None when the directory is empty."""
    from learning_jax_sharding_tpu_torch.parallel.resharding import reshard_tree

    if step is not None:
        restored = manager.restore(step, like=like)
    else:
        restored = manager.restore_latest(like=like, strict=strict)
    if restored is None:
        return None
    params = {k: v.detach() for k, v in restored.model.state_dict().items()}
    return reshard_tree(params, dst_shardings, plan_cache=plan_cache, jit_cache=jit_cache)
