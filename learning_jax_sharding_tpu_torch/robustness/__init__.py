"""Fault injection and recovery policies.

Port of ``learning_jax_sharding_tpu/robustness``:

* :mod:`.chaos`: the deterministic fault-injection harness; faults fire
  at named seam points of ``models/serving.py`` on exact invocation
  indices, each logged to the flight recorder;
* :mod:`.policies`: the serving degradation ladder
  (:class:`DegradationLadder`): SLO burn rate drives a hysteresis state
  machine over disable speculation → halve ``token_budget`` → shed new
  admits;
* :mod:`.recovery`: training-side recovery configuration
  (:class:`ResilienceConfig`) and :class:`PreemptionError`, for ``fit``.

``matrix.py`` (the fault × policy matrix) comes with slice E's rest.
"""

from learning_jax_sharding_tpu_torch.robustness.chaos import (
    ChaosInjector,
    Fault,
    InjectedFault,
    chaos_hook,
    corrupt_latest_checkpoint,
)
from learning_jax_sharding_tpu_torch.robustness.policies import DegradationLadder
from learning_jax_sharding_tpu_torch.robustness.recovery import (
    PreemptionError,
    ResilienceConfig,
)

__all__ = [
    "ChaosInjector",
    "DegradationLadder",
    "Fault",
    "InjectedFault",
    "PreemptionError",
    "ResilienceConfig",
    "chaos_hook",
    "corrupt_latest_checkpoint",
]
