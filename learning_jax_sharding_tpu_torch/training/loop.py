"""The optimizer half of the training loop: run config, learning-rate
schedule and optimizer.

Port of ``learning_jax_sharding_tpu/training/loop.py``. An optax
transformation is a pure function of the parameters it is later applied to;
a torch optimizer is built over them. So :func:`adamw` and
:func:`default_optimizer` return an :class:`AdamW` description, and
``training.pipeline.sharded_train_state`` builds the torch optimizer from it
over the model's parameters.

Not ported yet: ``fit`` and ``evaluate`` (they need the data loader,
checkpoints and telemetry) and the ``"lion"`` and ``"adafactor"``
optimizers; they come with slice D (training breadth).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    """Run-level knobs (model knobs live in the model's own config)."""

    steps: int
    global_batch_size: int
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    lr_schedule: str = "constant"    # "constant" | "cosine" | "linear" decay
    min_learning_rate: float = 0.0   # decay floor (cosine/linear)
    grad_clip_norm: Optional[float] = None  # global-norm gradient clipping
    optimizer: str = "adamw"         # "adamw" | "lion" | "adafactor"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    max_checkpoints: int = 3
    metrics_path: Optional[str] = None
    log_every: int = 1
    seed: int = 0
    prefetch: int = 2


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init`` → ``end`` over ``steps``, then
    held (constant ``init`` when ``steps ≤ 0``)."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, steps: int, alpha: float) -> Schedule:
    """``optax.cosine_decay_schedule``: half a cosine from ``init`` to
    ``alpha·init`` over ``steps``, then held."""
    def schedule(count: int) -> float:
        decay = 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))
        return init * ((1 - alpha) * decay + alpha)
    return schedule


def lr_schedule(cfg: TrainLoopConfig) -> Schedule:
    """Warmup → decay as a plain ``step -> lr`` function, equal to the JAX
    package's optax schedule at every step: ``warmup_steps`` of linear
    warmup from 0, then per ``cfg.lr_schedule`` the peak held
    (``"constant"``) or decayed to ``min_learning_rate`` over the remaining
    steps (``"cosine"`` / ``"linear"``). The train step reads it at the
    count of updates made so far, so the first update uses ``schedule(0)``."""
    decay_steps = max(cfg.steps - cfg.warmup_steps, 1)
    if cfg.lr_schedule == "constant":
        decay = lambda count: cfg.learning_rate
    elif cfg.lr_schedule == "cosine":
        decay = _cosine(cfg.learning_rate, decay_steps,
                        cfg.min_learning_rate / cfg.learning_rate)
    elif cfg.lr_schedule == "linear":
        decay = _linear(cfg.learning_rate, cfg.min_learning_rate, decay_steps)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.warmup_steps == 0:
        return decay
    warmup = _linear(0.0, cfg.learning_rate, cfg.warmup_steps)
    boundary = cfg.warmup_steps
    return lambda count: warmup(count) if count < boundary else decay(count - boundary)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` (optionally behind ``optax.clip_by_global_norm``) as
    a description of a torch optimizer.

    ``torch.optim.AdamW`` computes the same update: its decoupled decay
    ``p·(1 − lr·wd)`` followed by the Adam step equals optax's ``−lr·(m̂ /
    (√v̂ + eps) + wd·p)``, both on the old ``p``; like optax it decays every
    parameter (norms, biases and embeddings too). ``learning_rate`` is a
    number or a ``step -> lr`` schedule. ``clip_norm``: the gradients are
    scaled by ``clip_norm / ‖g‖`` when their global norm ``‖g‖`` reaches it
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).
    """

    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    clip_norm: Optional[float] = None

    def schedule(self, step: int) -> float:
        """The learning rate of the update made after ``step`` updates."""
        lr = self.learning_rate
        return lr(step) if callable(lr) else lr

    def create(self, params) -> torch.optim.AdamW:
        """The torch optimizer over ``params`` (one parameter group)."""
        return torch.optim.AdamW(
            params, lr=self.schedule(0), betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay,
        )


def adamw(
    learning_rate: Union[float, Schedule],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> AdamW:
    """The counterpart of ``optax.adamw``, with its defaults (note the
    weight decay of 1e-4, where ``torch.optim.AdamW`` defaults to 1e-2)."""
    return AdamW(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def default_optimizer(cfg: TrainLoopConfig) -> AdamW:
    """``cfg.optimizer`` under the config's schedule, with optional
    global-norm clipping. ``"adamw"`` forwards ``cfg.weight_decay`` as it
    is; ``"lion"`` and ``"adafactor"`` are not ported yet."""
    if cfg.optimizer in ("lion", "adafactor"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r}: ported with slice D (training breadth)"
        )
    if cfg.optimizer != "adamw":
        raise ValueError(
            f"unknown optimizer {cfg.optimizer!r}: "
            "expected 'adamw', 'lion', or 'adafactor'"
        )
    return AdamW(lr_schedule(cfg), weight_decay=cfg.weight_decay,
                 clip_norm=cfg.grad_clip_norm)
