"""Serving degradation policy: SLO burn rate → a ladder of load responses.

Port of ``learning_jax_sharding_tpu/robustness/policies.py``.

An overloaded engine has exactly three levers that trade quality of
service for survival, in increasing severity:

1. **disable speculation** — a speculative engine's draft round costs
   extra dispatches per token; under overload the verifier's acceptance
   no longer pays for them. Correctness is unaffected: greedy
   speculative output is the target's greedy output by construction,
   and the split refill still prefills the draft cache, so re-enabling
   speculation later stays sound (stale draft K/V only costs acceptance
   rate, never tokens — the verifier decides).
2. **shrink ``token_budget``** — the mixed scheduler's per-dispatch
   ceiling: smaller dispatches bound the ITL gap decoding rows see
   while prompts stream, at the price of refill throughput.
3. **shed new admits** — admission control's last resort: reject
   arrivals (``AdmissionError``) so the requests already in flight keep
   their SLO instead of everyone missing it together.

:class:`DegradationLadder` is the hysteresis state machine that walks
those levels from the SLO monitor's burn rate: ``patience`` consecutive
evaluations above ``trip`` escalate one level; ``patience`` consecutive
below ``clear`` de-escalate one. The gap between ``trip`` and ``clear``
is the hysteresis band — a burn rate oscillating around 1.0 must not
flap the engine's configuration every step.

The ladder is pure policy (no engine imports — the engine applies the
level; see ``ContinuousEngine(degradation=...)``), so it is unit-testable
as a state machine and reusable by any frontend.
"""

from __future__ import annotations


class DegradationLadder:
    """Burn-rate-driven escalation over the engine's degradation levels.

    Levels (applied by the engine):

    ====  =================  ============================================
    0     ``normal``         full service
    1     ``no_speculation`` draft-verify rounds off (spec engines)
    2     ``reduced_budget`` mixed ``token_budget`` halved (floor: one
                             decode wave)
    3     ``shed``           new admissions rejected
    ====  =================  ============================================
    """

    LEVELS = ("normal", "no_speculation", "reduced_budget", "shed")

    def __init__(
        self,
        *,
        trip: float = 1.0,
        clear: float = 0.5,
        patience: int = 3,
        max_level: int = 3,
    ):
        if not 0.0 <= clear < trip:
            raise ValueError(
                f"need 0 <= clear < trip, got clear={clear} trip={trip}"
            )
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if not 0 <= max_level <= 3:
            raise ValueError(f"max_level must be in [0, 3], got {max_level}")
        self.trip = trip
        self.clear = clear
        self.patience = patience
        self.max_level = max_level
        self.level = 0
        self.transitions: list[dict] = []
        self._hot = 0
        self._cool = 0

    @property
    def name(self) -> str:
        return self.LEVELS[self.level]

    def update(self, burn_rate: float) -> int:
        """Feed one burn-rate evaluation; returns the (possibly new)
        level. Inside the hysteresis band both streaks reset — holding
        steady is a decision too."""
        if burn_rate > self.trip:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.patience and self.level < self.max_level:
                self.level += 1
                self._hot = 0
                self.transitions.append(
                    {"to": self.level, "name": self.name, "burn": burn_rate}
                )
        elif burn_rate < self.clear:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.patience and self.level > 0:
                self.level -= 1
                self._cool = 0
                self.transitions.append(
                    {"to": self.level, "name": self.name, "burn": burn_rate}
                )
        else:
            self._hot = self._cool = 0
        return self.level
