"""The port's ``telemetry.watchdog`` held to the JAX package's
``tests/test_diagnosis.py::TestWatchdog`` and ``::TestHeartbeat``, with
torch scalars in place of JAX arrays: a finite run never trips; a NaN loss
flags its step (registry counter, flight-recorder event); an infinite grad
norm flags ``grad_norm``; a finite spike against the EMA is a spike, not a
trip; everything drains by ``flush()``; late-bound sinks never override
given ones; ``localize_nan`` names the operator that made the NaN (through
``utils.profiling.checking()``) and None for a finite computation; the
probe stays cheap. The heartbeat flags an overrun section from its own
thread, leaves fast sections clean, validates its timeout and reports
whether its thread runs.
"""

import time

import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu_torch.telemetry import FlightRecorder, MetricsRegistry
from learning_jax_sharding_tpu_torch.telemetry.watchdog import (
    Heartbeat,
    NonFiniteError,
    Watchdog,
    localize_nan,
)


def f32(x):
    return torch.tensor(x, dtype=torch.float32)


def test_finite_run_never_trips():
    w = Watchdog(lag=2)
    for i in range(6):
        w.probe(i + 1, f32(1.0 + 0.01 * i), f32(0.5))
    w.flush()
    assert not w.tripped and w.steps_probed == 6


def test_nan_loss_flags_the_step():
    reg, fr = MetricsRegistry(), FlightRecorder()
    w = Watchdog(registry=reg, recorder=fr, lag=2)
    for i, v in enumerate([1.0, 0.9, float("nan"), 0.8]):
        w.probe(i + 1, f32(v))
    w.flush()
    assert w.tripped and w.first_bad_step == 3 and w.bad_what == "loss"
    assert reg.get("watchdog_nonfinite_total").value == 1
    assert reg.get("watchdog_probes_total").value == 4
    assert [e["step"] for e in fr.events("nonfinite")] == [3]


def test_inf_grad_norm_flags_grad_norm():
    w = Watchdog(lag=0)
    w.probe(1, f32(1.0), f32(np.inf))
    w.flush()
    assert w.tripped and w.bad_what == "grad_norm"


def test_loss_spike_against_ema():
    fr = FlightRecorder()
    w = Watchdog(recorder=fr, lag=0, spike_factor=5.0, spike_min_steps=3)
    for i in range(8):
        w.probe(i + 1, f32(1.0))
    w.probe(9, f32(50.0))
    w.flush()
    assert not w.tripped
    assert [s["step"] for s in w.spikes] == [9]
    assert fr.events("loss_spike")


def test_async_window_respects_lag():
    w = Watchdog(lag=3)
    w.probe(1, f32(1.0))
    w.probe(2, f32(float("nan")))
    w.flush()
    assert w.first_bad_step == 2
    with pytest.raises(ValueError, match="lag"):
        Watchdog(lag=-1)


def test_bind_late_attaches_sinks():
    reg, fr = MetricsRegistry(), FlightRecorder()
    w = Watchdog(lag=0)
    w.bind(registry=reg, recorder=fr)
    w.probe(1, f32(float("nan")))
    w.flush()
    assert reg.get("watchdog_nonfinite_total").value == 1
    assert fr.events("nonfinite")
    own = FlightRecorder()
    w2 = Watchdog(recorder=own)
    w2.bind(recorder=fr)
    w2.probe(1, f32(float("nan")))
    w2.flush()
    assert own.events("nonfinite") and not fr.events("nonfinite")[1:]


def test_localize_nan_names_the_operator():
    x = f32(1.0)
    msg = localize_nan(lambda: 0.0 * x / (1.0 - x))
    assert msg is not None and "div" in msg and "non-finite" in msg
    assert localize_nan(lambda: x * 2) is None
    # The trap is scoped: the same NaN passes silently afterwards.
    assert torch.isnan(0.0 * x / (1.0 - x))
    err = NonFiniteError(3, "loss", localized=msg, bundle="b")
    assert err.step == 3 and "step 3" in str(err) and "bundle: b" in str(err)


def test_probe_overhead_is_bounded():
    # A sanity bound, not a performance claim.
    w = Watchdog(lag=2)
    loss, gn = f32(1.0), f32(0.5)
    w.probe(0, loss, gn)
    t0 = time.perf_counter()
    for i in range(30):
        w.probe(i + 1, loss, gn)
    dt = (time.perf_counter() - t0) / 30
    w.flush()
    assert dt < 5e-3, f"watchdog probe cost {dt * 1e3:.2f} ms/step"


def test_overrun_section_is_flagged():
    reg, fr = MetricsRegistry(), FlightRecorder()
    with Heartbeat(timeout=0.05, registry=reg, recorder=fr) as hb:
        with hb.expect("wedged sync"):
            time.sleep(0.25)
    assert len(hb.hangs) == 1
    assert hb.hangs[0]["label"] == "wedged sync" and hb.hangs[0]["overrun"] >= 0
    assert reg.get("watchdog_hangs_total").value == 1
    assert fr.events("hang")


def test_fast_sections_are_clean():
    with Heartbeat(timeout=5.0) as hb:
        for _ in range(3):
            with hb.expect("quick"):
                pass
    assert hb.hangs == []


def test_validation_and_running():
    with pytest.raises(ValueError, match="timeout"):
        Heartbeat(timeout=0.0)
    hb = Heartbeat(timeout=1.0)
    assert not hb.running
    hb.start()
    assert hb.running
    hb.stop()
    assert not hb.running
