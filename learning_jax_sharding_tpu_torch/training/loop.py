"""The training loop: run config, schedule, optimizers, ``fit`` and
``evaluate``.

Port of ``learning_jax_sharding_tpu/training/loop.py``. An optax
transformation is a pure function of the parameters it is later applied to;
a torch optimizer is built over them. So :func:`adamw`, :func:`lion`,
:func:`adafactor` and :func:`default_optimizer` return a description
(:class:`AdamW`, :class:`Lion`, :class:`Adafactor`) with ``create(params)``
and ``schedule``, and ``training.pipeline.sharded_train_state`` builds the
torch optimizer from it over the model's parameters.

:func:`fit` composes the batch loader (``data.loader``), the train step,
per-step metrics (``utils.metrics``), checkpoints and resume
(``training.checkpoint``), telemetry and the recovery policies. Resume is
exact: the checkpoint's step indexes the loader (batches are a pure
function of their index), so a restored run consumes the batches the
uninterrupted run would have.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import signal
import threading
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.data.loader import ShardedBatchLoader
from learning_jax_sharding_tpu_torch.models.transformer import next_token_loss
from learning_jax_sharding_tpu_torch.robustness.chaos import chaos_hook
from learning_jax_sharding_tpu_torch.robustness.recovery import PreemptionError
from learning_jax_sharding_tpu_torch.telemetry import (
    GoodputLedger,
    Tracer,
    default_flight_recorder,
)
from learning_jax_sharding_tpu_torch.telemetry.watchdog import NonFiniteError, localize_nan
from learning_jax_sharding_tpu_torch.training.checkpoint import CheckpointManager
from learning_jax_sharding_tpu_torch.training.pipeline import (
    make_eval_step,
    make_train_step,
    sharded_train_state,
)
from learning_jax_sharding_tpu_torch.utils.metrics import MetricsLogger

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




# optax.lion's moment rates and optax.adafactor's defaults, which the
# port's lion and adafactor keep.
LION_B1, LION_B2 = 0.9, 0.99
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIPPING_THRESHOLD = 1.0
ADAFACTOR_MIN_PARAM_SCALE = 1e-3


class _Lion(torch.optim.Optimizer):
    """``optax.lion`` as a torch optimizer (foreach ops): the update is
    ``sign(b1·m + (1−b1)·g) + wd·p``, scaled by ``−lr``; then ``m ← b2·m +
    (1−b2)·g``. One moment a parameter, in its dtype."""

    def __init__(self, params, lr, weight_decay):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["step"] = torch.tensor(0.0)
                self.state[p]["step"] += 1
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            upd = torch._foreach_mul(mus, LION_B1)
            torch._foreach_add_(upd, torch._foreach_mul(grads, 1.0 - LION_B1))
            torch._foreach_sign_(upd)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            torch._foreach_mul_(mus, LION_B2)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - LION_B2))


def _factored_dims(shape) -> Optional[tuple[int, int]]:
    """optax's rule: the two largest dims (numpy's argsort order), or None
    when the second largest is below ``ADAFACTOR_MIN_DIM_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class _Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` with its defaults as a torch optimizer: the
    factored second moment (``v_row`` / ``v_col`` over the two largest dims
    when both reach ``ADAFACTOR_MIN_DIM_TO_FACTOR``, else a full ``v``) with
    the ``1 − (t+1)^−decay_rate`` decay, the update clipped to block RMS 1,
    scaled by the learning rate and by the parameter's RMS (at least 1e-3).
    No momentum, no weight decay. The decay is a number from the host's
    count and the unfactored slots move in foreach ops, so an update
    queues behind the backward without waiting for the card."""

    def __init__(self, params, lr):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            decays = []
            for p in params:
                state = self.state[p]
                if not state:
                    self._init_state(p, state)
                decays.append(_adafactor_decay(int(state["step"])))
                state["step"] += 1
            whole = [(p, d) for p, d in zip(params, decays) if "v" in self.state[p]]
            updates = dict(zip([p for p, _ in whole], self._whole_updates(whole)))
            for p, decay in zip(params, decays):
                u = updates[p] if p in updates else self._factored_update(p, decay)
                rms = (u * u).mean().sqrt()
                u = u / torch.clamp(rms / ADAFACTOR_CLIPPING_THRESHOLD, min=1.0)
                scale = torch.clamp((p * p).mean().sqrt(), min=ADAFACTOR_MIN_PARAM_SCALE)
                p.sub_(u * group["lr"] * scale)

    @staticmethod
    def _init_state(p, state) -> None:
        state["step"] = torch.tensor(0.0)
        dims = _factored_dims(tuple(p.shape))
        if dims is None:
            state["v"] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            state["v_row"] = torch.zeros_like(p.select(d0, 0))
            state["v_col"] = torch.zeros_like(p.select(d1, 0))

    def _whole_updates(self, whole) -> list:
        """The unfactored parameters' ``v`` and unclipped updates in foreach
        ops, from ``(parameter, (decay, 1 − decay))`` pairs: ``v ← decay·v
        + (1−decay)·(g² + eps)``, ``u = g·v^−½``."""
        if not whole:
            return []
        grads = [p.grad for p, _ in whole]
        vs = [self.state[p]["v"] for p, _ in whole]
        grad_sqr = torch._foreach_mul(grads, grads)
        torch._foreach_add_(grad_sqr, ADAFACTOR_EPS)
        torch._foreach_mul_(vs, [decay for _, (decay, _) in whole])
        torch._foreach_mul_(grad_sqr, [keep for _, (_, keep) in whole])
        torch._foreach_add_(vs, grad_sqr)
        return torch._foreach_mul(grads, torch._foreach_pow(vs, -0.5))

    def _factored_update(self, p, decays):
        """A factored parameter's ``v_row``/``v_col`` and unclipped update."""
        g, state = p.grad, self.state[p]
        d1, d0 = _factored_dims(tuple(p.shape))
        decay, keep = decays
        grad_sqr = g * g + ADAFACTOR_EPS
        v_row, v_col = state["v_row"], state["v_col"]
        v_row.copy_(decay * v_row + keep * grad_sqr.mean(dim=d0))
        v_col.copy_(decay * v_col + keep * grad_sqr.mean(dim=d1))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
        return g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)


def _adafactor_decay(count: int) -> tuple[float, float]:
    """optax's ``1 − (count+1)^−decay_rate`` and its complement, in float32
    as optax computes them, but on the host from the host's count: the
    update reads them as numbers, so no step copies a scalar to the device."""
    decay = np.float32(1.0) - np.float32(count + 1) ** np.float32(-ADAFACTOR_DECAY_RATE)
    return float(decay), float(np.float32(1.0) - decay)


@dataclasses.dataclass(frozen=True)
class Lion:
    """``optax.lion`` (b1 0.9, b2 0.99; optionally behind
    ``optax.clip_by_global_norm``) as a description of a torch optimizer:
    one moment a parameter, half of AdamW's optimizer state.
    ``learning_rate`` is a number or a ``step -> lr`` schedule (typical
    rates are 3–10× smaller than AdamW's)."""

    learning_rate: Union[float, Schedule]
    weight_decay: float = 1e-3
    clip_norm: Optional[float] = None

    def schedule(self, step: int) -> float:
        """The learning rate of the update made after ``step`` updates."""
        lr = self.learning_rate
        return lr(step) if callable(lr) else lr

    def create(self, params) -> torch.optim.Optimizer:
        return _Lion(params, self.schedule(0), self.weight_decay)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """``optax.adafactor`` with its defaults (optionally behind
    ``optax.clip_by_global_norm``) as a description of a torch optimizer:
    the second moment factored into a row and a column vector for a
    parameter whose two largest dims reach 128; no momentum and no weight
    decay."""

    learning_rate: Union[float, Schedule]
    clip_norm: Optional[float] = None

    def schedule(self, step: int) -> float:
        """The learning rate of the update made after ``step`` updates."""
        lr = self.learning_rate
        return lr(step) if callable(lr) else lr

    def create(self, params) -> torch.optim.Optimizer:
        return _Adafactor(params, self.schedule(0))


def lion(learning_rate: Union[float, Schedule], *, weight_decay: float = 1e-3) -> Lion:
    """The counterpart of ``optax.lion``, with its defaults."""
    return Lion(learning_rate, weight_decay=weight_decay)


def adafactor(learning_rate: Union[float, Schedule]) -> Adafactor:
    """The counterpart of ``optax.adafactor(learning_rate)``, with its
    defaults."""
    return Adafactor(learning_rate)


def default_optimizer(cfg: TrainLoopConfig):
    """``cfg.optimizer`` under the config's schedule, with optional
    global-norm clipping: ``"adamw"`` and ``"lion"`` with
    ``cfg.weight_decay``; ``"adafactor"`` with optax's defaults and no
    weight decay (optax's ``weight_decay_rate`` is a per-step
    multiplicative decay outside the learning-rate scaling, so AdamW's 0.01
    would shrink the weights ~1% a step)."""
    sched = lr_schedule(cfg)
    if cfg.optimizer == "adamw":
        opt = AdamW(sched, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "lion":
        opt = Lion(sched, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adafactor":
        opt = Adafactor(sched)
    else:
        raise ValueError(
            f"unknown optimizer {cfg.optimizer!r}: "
            "expected 'adamw', 'lion', or 'adafactor'"
        )
    return dataclasses.replace(opt, clip_norm=cfg.grad_clip_norm)


def _snapshot(state) -> tuple:
    """Clones of every parameter and optimizer slot, and the counts."""
    params = [p.detach().clone() for p in state.model.parameters()]
    slots = {p: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in s.items()}
             for p, s in state.optimizer.state.items()}
    return params, slots, state.step, state.updates


def _put_back(state, snap) -> None:
    params, slots, state.step, state.updates = snap
    with torch.no_grad():
        for p, old in zip(state.model.parameters(), params):
            p.copy_(old)
    state.optimizer.state.clear()
    state.optimizer.state.update(slots)
    state.optimizer.zero_grad(set_to_none=True)


def fit(
    model: torch.nn.Module,
    dataset: Any,
    mesh: Any,
    rules: Any,
    cfg: TrainLoopConfig,
    *,
    optimizer: Any | None = None,
    loss_fn: Callable[..., torch.Tensor] = next_token_loss,
    step_kwargs: dict[str, Any] | None = None,
    registry: Any | None = None,
    tracer: Any | None = None,
    watchdog: Any | None = None,
    heartbeat: Any | None = None,
    recorder: Any | None = None,
    contract: Any | None = None,
    resilience: Any | None = None,
    ledger: Any | None = None,
) -> tuple[Any, list[dict]]:
    """Train ``model`` on ``dataset`` for ``cfg.steps`` steps; returns
    ``(state, metrics history)``.

    Resumes from ``cfg.checkpoint_dir`` when it holds a checkpoint (a
    resume past the last step trains nothing and returns ``[]``).

    Args:
        model: a ``models.transformer.Transformer`` (or any module the
            train step can run) on its device; its parameters are trained.
        dataset: a per-process-sliceable dataset (:mod:`data.datasets`).
        mesh: a ``DeviceMesh`` (batches split over its ``"data"`` axis,
            the parameters laid out by ``rules``), or None for one device.
        rules: the logical → mesh rules (unused without a mesh).
        optimizer: an :class:`AdamW` / :class:`Lion` / :class:`Adafactor`
            description; default :func:`default_optimizer`.
        loss_fn: ``loss_fn(y, batch)`` (or with the model: pass
            ``loss_needs_params`` through ``step_kwargs``).
        step_kwargs: more ``training.pipeline.make_train_step`` arguments
            (e.g. ``loss_needs_params=True, apply_kwargs={"return_hidden":
            True}`` for the fused loss).
        registry: a ``telemetry.MetricsRegistry``: the per-step metrics as
            ``train_*`` series.
        tracer: a ``telemetry.Tracer``: the run's phases (setup, restore,
            every step) as nested spans.
        watchdog: a :class:`telemetry.watchdog.Watchdog`: the step also
            returns the grad norm, every step is probed (no sync of its
            own), and a non-finite loss or norm escalates: the step's batch
            is re-run under ``utils.profiling.checking()`` (the state put
            back afterwards), the flight recorder dumps its bundle, and
            ``NonFiniteError`` names the step.
        heartbeat: a :class:`telemetry.watchdog.Heartbeat`: each step and
            its loss read run under an armed deadline.
        recorder: a ``telemetry.FlightRecorder`` (default: the process-wide
            ring) for the per-step events and the escalation trail.
        contract: a collective contract: with slice G (raises).
        resilience: a ``robustness.ResilienceConfig``: the non-finite guard
            (``skip_nonfinite``; bounded consecutive skips, then
            escalation), a loss spike past the EMA rolling back to the last
            checkpoint and replaying (``reseek``), SIGTERM → an emergency
            checkpoint → ``PreemptionError`` (the same ``checkpoint_dir``
            resumes bit-identically), and a save before an escalation.
        ledger: a ``telemetry.GoodputLedger`` (one against ``registry``
            when omitted): setup books ``compile``; restore, chaos seams,
            skips, rollbacks and emergency saves ``recovery``; the step and
            its loss read ``device`` (family ``train_step``); probes and
            the recorder ``telemetry``; the rest ``sched``.
            ``ledger.reconcile()["ok"]`` holds after ``fit``.

    Departures from the JAX ``fit``, which the port's idiom forces:

    * Weights: the torch module carries its weights, so ``fit`` trains
      ``model``'s parameters as given (updated IN PLACE, as the port's
      step does) and does not re-initialise them from ``cfg.seed``; to
      start from JAX's initialisation, load ``from_flax_params`` of it.
    * FLOPs: the MFU's FLOP count is the config's ``train_step_flops(b,
      s)`` (the JAX ``fit`` asks XLA's cost analysis of the compiled step).
    * Compiles: an eager step has no executable cache, so the JAX ``fit``'s
      re-bucketing of a compiling step into ``compile`` and its
      ``CompileWatch`` have no counterpart (``compile_watch`` comes with
      slice E).
    * Contracts: ``contract=`` raises ``NotImplementedError`` (slice G).
    * Mesh: ``mesh=None`` means one device (the model's).
    """
    if contract is not None:
        raise NotImplementedError("fit(contract=): ported with slice G (the analysis stack)")
    tr = tracer if tracer is not None else Tracer(enabled=False)
    rec = recorder if recorder is not None else default_flight_recorder()
    led = ledger if ledger is not None else GoodputLedger(registry=registry)
    led.begin_window()
    if tracer is not None:
        rec.attach_tracer(tr)
    if watchdog is not None:
        watchdog.bind(registry=registry, recorder=rec)
    if heartbeat is not None:
        heartbeat.bind(registry=registry, recorder=rec)
    hb_owned = heartbeat is not None and not heartbeat.running
    optimizer = default_optimizer(cfg) if optimizer is None else optimizer
    with led.measure("compile"), tr.span("fit.setup"):
        device = next(model.parameters()).device
        loader = ShardedBatchLoader(dataset, mesh, cfg.global_batch_size, spec=("data",),
                                    device=device)
        sample = loader.batch_at(0)
        state = sharded_train_state(model, optimizer, mesh=mesh, rules=rules)
        extra = dict(step_kwargs or {})
        if watchdog is not None:
            # The watchdog reads the grad norm on the device.
            extra.setdefault("with_grad_norm", True)
        if resilience is not None and resilience.skip_nonfinite:
            extra.setdefault("skip_nonfinite", True)
        step_fn = make_train_step(loss_fn=loss_fn, mesh=mesh, rules=rules, **extra)

    ckpt = None
    start_step = 0
    if cfg.checkpoint_dir is not None:
        with led.measure("recovery"), tr.span("fit.restore"):
            ckpt = CheckpointManager(cfg.checkpoint_dir, max_to_keep=cfg.max_checkpoints,
                                     save_interval_steps=cfg.checkpoint_every, recorder=rec)
            # Falls back past a corrupt newest step (a preemption mid-write).
            if ckpt.restore_latest(like=state) is not None:
                start_step = int(state.step)
                rec.record("train_restore", step=start_step)

    b, s = sample["inputs"].shape[:2]
    flops_of = getattr(getattr(model, "config", None), "train_step_flops", None)
    metrics = MetricsLogger(
        cfg.metrics_path,
        flops_per_step=flops_of(b, s) if flops_of is not None else None,
        tokens_per_step=int(b * s),
        n_devices=mesh.size() if mesh is not None else 1,
        log_every=cfg.log_every,
        registry=registry,
    )

    def emergency_save(reason: str) -> bool:
        # The incident-path checkpoint of the CURRENT state (with the skip
        # guard on, the last healthy one), forced and awaited.
        if ckpt is None or resilience is None or not resilience.emergency_checkpoint:
            return False
        step_now = int(state.step)
        ckpt.save(step_now, state, force=True)
        ckpt.wait()
        rec.record("emergency_checkpoint", step=step_now, reason=reason)
        return True

    def escalate():
        # A probe came back non-finite: re-run the flagged step's batch
        # under the non-finite trap against the CURRENT state (put back
        # afterwards: the port's step updates in place), dump the bundle,
        # raise.
        emergency_save("watchdog_escalation")
        bad = watchdog.first_bad_step
        batch = recent.get(bad)
        localized = None
        if batch is not None:
            snap = _snapshot(state)
            try:
                localized = localize_nan(lambda: step_fn(state, batch))
            finally:
                _put_back(state, snap)
        rec.record("nan_localized", step=bad, what=watchdog.bad_what, message=localized)
        err = NonFiniteError(bad, watchdog.bad_what or "loss")
        bundle = rec.dump(registry=registry, tracer=tr, error=err)
        raise NonFiniteError(bad, watchdog.bad_what or "loss", localized=localized,
                             bundle=bundle)

    batches = None
    if cfg.prefetch > 0:
        batches = loader.prefetched(cfg.prefetch, start=start_step)

    def reseek(step: int):
        # The prefetch pipeline is positional; a rollback rebuilds it from
        # the restored step (the loader is random-access).
        nonlocal batches
        if batches is not None:
            batches.close()
            batches = loader.prefetched(cfg.prefetch, start=step)

    # SIGTERM → emergency checkpoint → PreemptionError; the handler is
    # installed from the main thread only and restored in the finally.
    sig = {"tripped": False}
    prev_sig: Any = None
    sig_installed = False
    if (resilience is not None and resilience.handle_sigterm
            and threading.current_thread() is threading.main_thread()):
        def _on_sigterm(signum, frame):
            sig["tripped"] = True

        prev_sig = signal.signal(signal.SIGTERM, _on_sigterm)
        sig_installed = True

    c_skips = (registry.counter("train_nonfinite_skips_total",
                                "train steps skipped by the non-finite guard")
               if registry is not None and resilience is not None else None)
    recent: dict[int, Any] = {}
    skips = 0          # CONSECUTIVE guarded skips (budget: max_skips)
    rollbacks = 0
    ema: float | None = None
    ema_seen = 0
    if hb_owned:
        heartbeat.start()
    try:
        i = start_step
        while i < cfg.steps:
            # The iteration's top-level frame: nested frames claim their
            # slices, the remainder (batch fetch, checkpoint dispatch,
            # bookkeeping) is the host's scheduling time.
            with led.measure("sched"):
                if sig["tripped"]:
                    with led.measure("recovery"):
                        saved = emergency_save("sigterm")
                        rec.record("preemption", step=int(state.step), checkpointed=saved)
                        raise PreemptionError(int(state.step), cfg.checkpoint_dir)
                with led.measure("recovery"):
                    chaos_hook("train.step", step=i + 1)
                batch = next(batches) if batches is not None else loader.batch_at(i)
                with led.measure("recovery"):
                    batch = chaos_hook("train.batch", value=batch, step=i + 1)
                if watchdog is not None:
                    with led.measure("telemetry"):
                        recent[i + 1] = batch
                        for old in [k for k in recent if k <= i + 1 - (watchdog.lag + 2)]:
                            del recent[old]
                hb = (heartbeat.expect(f"train_step {i + 1}") if heartbeat is not None
                      else contextlib.nullcontext())
                with led.measure("device", family="train_step"), \
                        tr.span("train_step", step=i + 1), hb:
                    state, loss = step_fn(state, batch)
                    loss, gnorm = ((loss["loss"], loss.get("grad_norm"))
                                   if isinstance(loss, dict) else (loss, None))
                    # metrics.log's float(loss) is the step's sync point,
                    # inside the span and the heartbeat's armed window.
                    metrics.log(i + 1, loss=loss)
                # The OBSERVED loss: a chaos seam can corrupt the host's
                # reading (the spike drill) without touching the state.
                with led.measure("recovery"):
                    loss_f = chaos_hook("train.loss", value=float(loss), step=i + 1)
                with led.measure("telemetry"):
                    rec.record("train_step", step=i + 1, loss=loss_f)
                if resilience is not None:
                    nonfinite = not math.isfinite(loss_f) or (
                        gnorm is not None and not math.isfinite(float(gnorm)))
                    if nonfinite:
                        # The guarded step already refused the update.
                        with led.measure("recovery"):
                            skips += 1
                            if c_skips is not None:
                                c_skips.inc()
                            rec.record("step_skipped", step=i + 1, loss=loss_f,
                                       consecutive=skips)
                            if skips > resilience.max_skips:
                                emergency_save("skip_budget_exhausted")
                                err = NonFiniteError(i + 1, "loss/grad_norm")
                                bundle = rec.dump(registry=registry, tracer=tr, error=err)
                                raise NonFiniteError(i + 1, "loss/grad_norm", bundle=bundle)
                            i += 1
                            continue
                    skips = 0
                    spiking = (resilience.rollback_on_spike and ema is not None
                               and ema_seen >= resilience.spike_min_steps
                               and abs(loss_f) > resilience.spike_factor * max(abs(ema), 1e-12))
                    if spiking:
                        if (ckpt is not None and ckpt.latest_step() is not None
                                and rollbacks < resilience.max_rollbacks):
                            with led.measure("recovery"):
                                rollbacks += 1
                                ckpt.wait()
                                state = ckpt.restore_latest(like=state)
                                i = int(state.step)
                                rec.record("loss_spike_rollback", step=i, loss=loss_f, ema=ema,
                                           rollbacks=rollbacks)
                                reseek(i)
                                ema = None
                                ema_seen = 0
                                continue
                        rec.record("loss_spike", step=i + 1, loss=loss_f, ema=ema)
                    a = resilience.spike_ema_alpha
                    ema = loss_f if ema is None else (1 - a) * ema + a * loss_f
                    ema_seen += 1
                if watchdog is not None:
                    with led.measure("telemetry"):
                        watchdog.probe(i + 1, loss, gnorm)
                    if watchdog.tripped:
                        with led.measure("recovery"):
                            escalate()
                if ckpt is not None:
                    ckpt.save(i + 1, state)
                i += 1
        if watchdog is not None:
            watchdog.flush()
            if watchdog.tripped:
                escalate()
        if ckpt is not None:
            if ckpt.latest_step() != cfg.steps:
                ckpt.save(cfg.steps, state, force=True)
            ckpt.wait()
    finally:
        if hb_owned:
            heartbeat.stop()
        if sig_installed:
            signal.signal(signal.SIGTERM, prev_sig if prev_sig is not None else signal.SIG_DFL)
        if batches is not None:
            batches.close()
        metrics.close()
        if ckpt is not None:
            ckpt.close()
    return state, metrics.history


def evaluate(
    state: Any,
    dataset: Any,
    mesh: Any,
    rules: Any,
    *,
    batch_size: int,
    num_batches: int,
    loss_fn: Callable[..., torch.Tensor] = next_token_loss,
    step_kwargs: dict[str, Any] | None = None,
) -> dict[str, float]:
    """Held-out evaluation: the mean loss and perplexity over batches
    ``0 .. num_batches-1`` (the loader is an infinite indexed stream, so
    the caller bounds the pass), through ``make_eval_step`` on ``state``'s
    model as it is laid out (``mesh``/``rules`` as for ``fit``). Returns
    ``{"loss", "perplexity", "batches"}``."""
    if num_batches <= 0:
        raise ValueError("evaluate() needs at least one batch")
    loader = ShardedBatchLoader(dataset, mesh, batch_size, spec=("data",),
                                device=next(state.model.parameters()).device)
    eval_step = make_eval_step(loss_fn=loss_fn, mesh=mesh, rules=rules, **(step_kwargs or {}))
    total = 0.0
    for i in range(num_batches):
        total += float(eval_step(state, loader.batch_at(i)))
    mean = total / num_batches
    return {"loss": mean, "perplexity": math.exp(min(mean, 700.0)), "batches": num_batches}
