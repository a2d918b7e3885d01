"""Training-side recovery configuration and the preemption signal.

Port of ``learning_jax_sharding_tpu/robustness/recovery.py``: plain data
that ``training/loop.py::fit(resilience=ResilienceConfig(...))`` reads (the
non-finite step skip with bounded consecutive skips, loss-spike rollback
to the last checkpoint, the emergency checkpoint on SIGTERM), and
:class:`PreemptionError`, which ``fit`` raises after such a checkpoint.
"""

from __future__ import annotations

import dataclasses


class PreemptionError(RuntimeError):
    """``fit()`` was preempted (SIGTERM) and stopped AFTER persisting an
    emergency checkpoint — re-run with the same ``checkpoint_dir`` to
    resume bit-identically from ``step``."""

    def __init__(self, step: int, checkpoint_dir: str | None = None):
        self.step = step
        self.checkpoint_dir = checkpoint_dir
        msg = f"preempted at step {step}"
        if checkpoint_dir:
            msg += f" (emergency checkpoint saved under {checkpoint_dir})"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Recovery policy knobs for ``fit(resilience=...)``.

    ``skip_nonfinite`` guards the update on a finite loss and gradient
    norm; ``max_skips`` bounds consecutive skipped steps.
    ``rollback_on_spike`` needs a ``checkpoint_dir`` on the loop config to
    have anything to roll back to.
    """

    skip_nonfinite: bool = True
    max_skips: int = 3               # consecutive non-finite steps tolerated
    rollback_on_spike: bool = False
    spike_factor: float = 10.0
    spike_min_steps: int = 5
    spike_ema_alpha: float = 0.1
    max_rollbacks: int = 1
    emergency_checkpoint: bool = True
    handle_sigterm: bool = True

    def __post_init__(self):
        if self.max_skips < 0:
            raise ValueError(f"max_skips must be >= 0, got {self.max_skips}")
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}"
            )
        if self.spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {self.spike_factor}"
            )
