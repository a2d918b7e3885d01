"""The port's telemetry and robustness modules against the JAX package's.

Each case drives the same operations through the JAX module and the port's
copy and compares what comes out: the registry's ``snapshot()`` and
``prometheus_text()`` equal; the tracer's events equal with their
timestamps masked; the goodput ledger's ``window_report`` equal under the
manual clock of ``tests/test_goodput.py`` and ``reconcile()`` within its ε;
the SLO monitor's burn rates within 1e-12; ``TraceStore.critical_path``
equal; the chaos injector's firing sequences and the degradation ladder's
levels equal. Then what the port adds: ``utils/profiling.py`` on the
PyTorch profiler, ``utils/bench.py::_sync`` and the count of kernel
libraries in ``ops/_build.py`` that re-buckets an engine's device frame.
"""

import ctypes.util
import json
import math
import time
import types

import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu import robustness as jax_robustness
from learning_jax_sharding_tpu.telemetry import flight_recorder as jax_flight
from learning_jax_sharding_tpu.telemetry import ledger as jax_ledger
from learning_jax_sharding_tpu.telemetry import registry as jax_registry
from learning_jax_sharding_tpu.telemetry import slo as jax_slo
from learning_jax_sharding_tpu.telemetry import spans as jax_spans
from learning_jax_sharding_tpu.telemetry import tracecontext as jax_trace
from learning_jax_sharding_tpu_torch import robustness as port_robustness
from learning_jax_sharding_tpu_torch.ops import _build
from learning_jax_sharding_tpu_torch.telemetry import flight_recorder as port_flight
from learning_jax_sharding_tpu_torch.telemetry import ledger as port_ledger
from learning_jax_sharding_tpu_torch.telemetry import registry as port_registry
from learning_jax_sharding_tpu_torch.telemetry import slo as port_slo
from learning_jax_sharding_tpu_torch.telemetry import spans as port_spans
from learning_jax_sharding_tpu_torch.telemetry import tracecontext as port_trace
from learning_jax_sharding_tpu_torch.utils import bench, profiling
from tests.test_goodput import _Clock

SIDES = {
    "jax": types.SimpleNamespace(
        registry=jax_registry, spans=jax_spans, ledger=jax_ledger, slo=jax_slo,
        trace=jax_trace, flight=jax_flight, robustness=jax_robustness),
    "port": types.SimpleNamespace(
        registry=port_registry, spans=port_spans, ledger=port_ledger, slo=port_slo,
        trace=port_trace, flight=port_flight, robustness=port_robustness),
}


def both(fn):
    """``fn`` run on the JAX modules and on the port's → (jax, port)."""
    return fn(SIDES["jax"]), fn(SIDES["port"])


def _raised(fn):
    """The type name and message ``fn()`` raised, or None."""
    try:
        fn()
    except Exception as exc:        # compared between the two sides
        return type(exc).__name__, str(exc)
    return None


# --- registry ---------------------------------------------------------------


def _registry_ops(m):
    r = m.registry.MetricsRegistry()
    c = r.counter("reqs_total", "requests")
    c.inc()
    c.inc(2.5)
    g = r.gauge("depth", "queue depth")
    for v in (5, 2, 7, 3):
        g.set(v)
    g.dec(0.5)
    h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0, 0.01))
    for v in (0.005, 0.05, 0.5, 9.0, 1.0):
        h.observe(v)
    r.histogram("default_seconds").observe(0.3)
    r.counter(m.registry.labeled_name("slo_burn", tenant='a"b\\c\nd')).inc(4)
    r.counter('ledger_seconds_total{bucket="device"}', "ledger seconds").inc(1.25)
    r.counter('ledger_seconds_total{bucket="sched"}', "ledger seconds").inc(0.5)
    r.histogram('trace_stage_seconds{stage="queue"}', "per stage").observe(0.2)
    errors = [
        _raised(lambda: c.inc(-1)),
        _raised(lambda: r.gauge("reqs_total")),
        _raised(lambda: r.histogram("lat_seconds", buckets=(2.0,))),
        _raised(lambda: r.histogram("empty", buckets=())),
    ]
    assert r.counter("reqs_total") is c
    snap = r.snapshot()
    return dict(snapshot=snap, text=r.prometheus_text(),
                snapshot_text=m.registry.snapshot_prometheus_text(snap),
                escaped=m.registry.escape_label_value('x"\\\n'),
                cumulative=h.cumulative(), high_water=g.high_water, errors=errors,
                names=[x.name for x in r.metrics()])


def test_registry_snapshot_and_prometheus_text_equal():
    want, got = both(_registry_ops)
    assert got == want
    assert got["snapshot"]["depth__high_water"] == 7
    assert all(e is not None for e in got["errors"])


def test_registry_dumps_equal(tmp_path):
    def dumps(m):
        r = m.registry.MetricsRegistry()
        r.counter("a_total", "things").inc(7)
        r.gauge("b").set(1.5)
        r.histogram("c_seconds", buckets=(0.5,)).observe(0.2)
        r.dump_json(tmp_path / "r.json")
        r.dump_prometheus(tmp_path / "r.prom")
        return (tmp_path / "r.json").read_text(), (tmp_path / "r.prom").read_text()

    want, got = both(dumps)
    assert got == want
    assert port_registry.default_registry() is port_registry.default_registry()


# --- tracer -----------------------------------------------------------------


def _masked(events):
    """Trace events with their timestamps, durations and OS pid masked."""
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur")}
        if "args" in ev:
            ev["args"] = {k: v for k, v in ev["args"].items() if k != "os_pid"}
        out.append(ev)
    return out


def _tracer_ops(m):
    t = m.spans.Tracer(max_events=7, name="engine")
    sunk = []
    t.on_event = lambda ev: sunk.append(ev["name"])
    with t.span("outer", phase="demo"):
        with t.span("inner", k=1):
            t.instant("tick", rid=3)
    t.async_begin("request", 5, prompt_len=7)
    t.async_end("request", 5, generated=2)
    t.complete("engine.refill", 0.0, 0.25, retired=1)
    t.instant("a")
    t.instant("b")                       # eight events: the ring drops the oldest
    off = m.spans.Tracer(enabled=False)
    with off.span("s"):
        off.instant("i")
    return dict(events=_masked(t.events), chrome=_masked(t.chrome_trace()["traceEvents"]),
                dropped=t.dropped, other=t.chrome_trace()["otherData"], sunk=sunk,
                disabled=off.events, tids=t.thread_ids())


def test_tracer_events_equal_with_timestamps_masked():
    want, got = both(_tracer_ops)
    assert got == want
    assert got["dropped"] == 1 and got["disabled"] == []


def test_tracer_span_times_nest_and_dump(tmp_path):
    t = port_spans.Tracer()
    with t.span("outer"):
        with t.span("inner"):
            pass
    evs = {e["name"]: e for e in t.events}
    outer, inner = evs["outer"], evs["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["args"]["parent"] == "outer"
    t.dump_chrome_trace(tmp_path / "trace.json")
    t.dump_jsonl(tmp_path / "trace.jsonl")
    assert json.loads((tmp_path / "trace.json").read_text())["displayTimeUnit"] == "ms"
    lines = (tmp_path / "trace.jsonl").read_text().splitlines()
    assert [json.loads(x)["name"] for x in lines] == ["inner", "outer"]


def test_sync_waits_on_cpu_tensors_and_records():
    t = port_spans.Tracer()
    t.sync({"a": [torch.ones(3), (torch.zeros(2), 1)]})
    (ev,) = t.events
    assert ev["name"] == "device_sync" and ev["ph"] == "X"
    bench._sync(None)                    # no tensors: nothing to wait for
    port_spans.device_sync([])


# --- goodput ledger -----------------------------------------------------------


def _ledger_ops(m):
    clk = _Clock()
    reg = m.registry.MetricsRegistry()
    led = m.ledger.GoodputLedger(registry=reg, clock=clk)
    out = {"buckets": list(m.ledger.BUCKETS)}
    with led.measure("sched"):
        clk.tick(1.0)
        with led.measure("device", family="refill_step"):
            clk.tick(2.0)
        with led.measure("device", family="decode_block") as f:
            clk.tick(0.75)
            f.rebucket("compile")
        with led.measure("admission"):
            clk.tick(0.125)
            with led.measure("telemetry"):
                clk.tick(0.0625)
        led.account("recovery", 0.25)
        clk.tick(0.5)
    clk.tick(0.5)                        # idle
    out["first"] = (led.window_report(), led.window_report(roofline_device_s=1.0),
                    led.reconcile(), led.device_families(), led.in_frame)
    led.begin_window()
    clk.tick(0.25)
    with led.measure("device", family="decode_block"):
        clk.tick(1.5)
    with led.measure("custom"):
        clk.tick(0.3)
    led.account("page_alloc", 0.1)
    out["second"] = (led.window_report(), led.reconcile(), led.window_buckets(),
                     led.device_families(), led.totals(), led.window_start)
    out["negative"] = _raised(lambda: led.account("telemetry", -1.0))
    led._totals["sched"] += 5.0          # a booking that never happened
    out["leak"] = led.reconcile()
    open_frame = led.measure("device")
    open_frame.__enter__()
    out["open"] = led.reconcile()
    open_frame.__exit__(None, None, None)
    out["registry"] = reg.snapshot()
    out["text"] = reg.prometheus_text()
    return out


def test_ledger_window_report_equal_under_a_manual_clock():
    want, got = both(_ledger_ops)
    assert got == want
    report, _, rec, families, _ = got["first"]
    assert rec["ok"] and abs(rec["residual_s"]) <= rec["eps"], rec
    assert report["top_contributor"] == "sched"
    assert families["refill_step"] == {"seconds": 2.0, "calls": 1.0}
    assert "decode_block" not in families                  # re-bucketed to compile
    assert got["second"][1]["ok"]
    assert not got["leak"]["ok"] and not got["open"]["ok"]


# --- SLO monitor --------------------------------------------------------------


def _slo_ops(m):
    reg, rec = m.registry.MetricsRegistry(), m.flight.FlightRecorder()
    targets = [m.slo.SLOTarget("ttft", 0.05, objective=0.9),
               m.slo.SLOTarget("itl", 0.01), m.slo.SLOTarget("e2e", 0.2, objective=0.5,
                                                             name="e2e_half")]
    mon = m.slo.SLOMonitor(targets, registry=reg, recorder=rec, window=16)
    rng = np.random.default_rng(8)
    burns, tenant_burns = [], []
    for i in range(60):
        tenant = ("a", "b", None)[i % 3]
        for metric, scale in (("ttft", 0.05), ("itl", 0.01), ("e2e", 0.2), ("tpot", 1.0)):
            mon.observe(metric, float(rng.exponential(scale)), tenant=tenant)
        mon.observe("itl", None)
        burns.append([mon.burn_rate(t.name) for t in targets])
        tenant_burns.append(mon.tenant_burn_rates())
        if i == 40:
            mon.reset_window()
    est = m.slo.StreamingPercentile(window=5)
    for v in (3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0):
        est.observe(v)
    return dict(burns=burns, tenant_burns=tenant_burns, breached=mon.breached(),
                snapshot=mon.snapshot(), registry=reg.snapshot(),
                events=[{k: v for k, v in e.items() if k != "t"} for e in rec.events()],
                est=(est.quantile(0.5), est.snapshot()),
                names=[t.name for t in targets],
                errors=[_raised(lambda: m.slo.SLOTarget("x", 1.0, objective=1.0)),
                        _raised(lambda: m.slo.StreamingPercentile(0)),
                        _raised(lambda: mon.burn_rate("nope"))])


def _close(a, b, tol=1e-12):
    """Equal structures, floats within ``tol``."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k], tol) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= tol or (math.isnan(a) and math.isnan(b))
    return a == b


def test_slo_burn_rates_equal():
    want, got = both(_slo_ops)
    assert _close(got["burns"], want["burns"])
    assert _close(got["tenant_burns"], want["tenant_burns"])
    assert _close(got, want)
    assert got["names"] == ["ttft_le_0.05", "itl_le_0.01", "e2e_half"]
    assert any(b > 1.0 for row in got["burns"] for b in row)


# --- trace store --------------------------------------------------------------


def _trace_ops(m):
    reg = m.registry.MetricsRegistry()
    ts = m.trace.TraceStore(registry=reg, max_done=3, clock=_Clock())
    ids = [ts.mint(7, arrival_t=10.0, tenant="t1"), ts.mint(7), ts.mint(9)]
    ts.leg(7, "queue", 10.0, 11.0, replica="p0")
    ts.leg(7, "prefill", 11.0, 12.5, replica="p0", first_token_t=12.5)
    ts.leg(7, "handoff", 12.5, 12.7)
    ts.leg(7, "decode", 12.8, 14.0, replica="d0")
    ts.instant(7, "reroute", t=12.0, replica="d1", error="killed")
    ts.instant(7, "swap_pin", t=12.1, version=3)
    ts.complete(7, finish_t=14.2)
    ts.complete(7, status="late", finish_t=99.0)
    ts.leg(9, "prefill", 0.0, 1.0, wasted=True)
    ts.leg(9, "prefill", 1.0, 1.5, first_token_t=1.5)
    ts.leg(9, "decode", 2.0, 1.0)        # clipped to zero length
    ts.complete(9, status="deadline", finish_t=2.0)
    early = {rid: ts.critical_path(rid) for rid in (7, 9)}
    for rid in (20, 21, 22):
        ts.mint(rid, arrival_t=0.0)
        ts.complete(rid, finish_t=1.0)
    ts.mint(77)
    paths = {rid: ts.critical_path(rid) for rid in (7, 9, 20, 21, 22, 77, 404)}

    class Ring:
        def __init__(self, t0, events):
            self._t0, self.events = t0, events

    merged = m.trace.merge_tracers(
        {"b": Ring(10.0, [{"name": "x", "ph": "X", "ts": 5.0, "dur": 1.0, "tid": 0}]),
         "a": Ring(12.0, [{"name": "y", "ph": "X", "ts": 5.0, "dur": 1.0, "tid": 0}])},
        extra_events=[{"name": "marker", "ph": "i", "ts": 0.0}])
    return dict(ids=ids, early=early, paths=paths, completed=ts.completed(), rids=ts.rids(),
                chrome=ts.chrome_trace(), registry=reg.snapshot(), merged=merged,
                stages=m.trace.STAGES, record=ts.record(9))


def test_trace_store_critical_paths_equal():
    want, got = both(_trace_ops)
    assert got == want
    cp = got["early"][7]
    assert cp["stages"]["stall"] == pytest.approx(0.3) and cp["ttft_s"] == pytest.approx(2.5)
    assert cp["reroutes"] == 1 and cp["swap_pins"] == [3]
    assert got["early"][9]["wasted_s"] == pytest.approx(1.0)
    # Past max_done the oldest finished traces age out; live ones never.
    assert got["paths"][7] is None and got["paths"][77] is not None


# --- flight recorder ------------------------------------------------------------


def _recorder_ops(m, tmp):
    rec = m.flight.FlightRecorder(max_events=4)
    tracer = m.spans.Tracer()
    rec.attach_tracer(tracer)
    for i in range(5):
        rec.record("engine.admit", rid=i, loss=float("nan") if i == 1 else 1.0)
    with tracer.span("engine.refill"):
        pass
    reg = m.registry.MetricsRegistry()
    reg.gauge("loss").set(float("inf"))
    out = rec.dump(tmp / "bundle", registry=reg, error="boom")
    with pytest.raises(KeyError):
        with rec.capture(tmp / "crash"):
            raise KeyError("lost")
    files = {}
    for name in ("events.json", "registry.json", "error.txt"):
        text = (out / name).read_text()
        files[name] = json.loads(text) if name.endswith(".json") else text
    files["events.json"]["events"] = [{k: v for k, v in e.items() if k not in ("t", "dur_us",
                                                                              "ts_us")}
                                      for e in files["events.json"]["events"]]
    kinds = [e["kind"] for e in rec.events()]
    crash = (tmp / "crash" / "error.txt").read_text().splitlines()[-1]
    rec.clear()
    return dict(files=files, kinds=kinds, dropped_after_clear=rec.dropped, crash=crash,
                spans=sorted(p.name for p in out.iterdir()))


def test_flight_recorder_bundles_equal(tmp_path):
    want = _recorder_ops(SIDES["jax"], tmp_path / "jax")
    got = _recorder_ops(SIDES["port"], tmp_path / "port")
    assert got == want
    assert got["files"]["events.json"]["dropped"] == 2
    assert got["crash"] == "KeyError: 'lost'"
    assert port_flight.artifact_dir("x").is_dir()


# --- chaos injector -------------------------------------------------------------


def _chaos_ops(m):
    r = m.robustness
    rec = m.flight.FlightRecorder()
    out = {"identity": (r.chaos_hook("any.site", value=41), r.chaos_hook("any.site"))}
    faults = [r.Fault("engine.admit", "mutate", at=1, count=2, mutate=lambda x: x + 100),
              r.Fault("engine.dispatch", "hang", rid=5, count=-1),
              r.Fault("engine.dispatch", "raise", at=2, count=1, error=FloatingPointError),
              r.Fault("engine.dispatch", "raise", at=4, count=1),
              r.Fault("engine.page_alloc", "oom", at=1, count=1),
              r.Fault("engine.dispatch", "slow", at=0, count=1, delay_s=0.0),
              r.Fault("train.batch", "nan", at=0, count=1)]
    seq = []
    with r.ChaosInjector(*faults, recorder=rec) as inj:
        for i in range(5):
            seq.append(("admit", r.chaos_hook("engine.admit", value=i, rid=i)))
        for rids in ([1, 2], [5], [1], [3, 5], [1], [2], [5], [4]):
            seq.append(("dispatch", _raised(lambda: r.chaos_hook(
                "engine.dispatch", phase="decode", rids=rids))))
        for free in (3, 2, 1):
            seq.append(("page", _raised(lambda: r.chaos_hook("engine.page_alloc", free=free))))
        seq.append(("batch", str(r.chaos_hook("train.batch", value=1.0))))
        injections = list(inj.injections)
    inner = r.ChaosInjector(r.Fault("a", "mutate", mutate=lambda x: "inner"), recorder=rec)
    outer = r.ChaosInjector(r.Fault("a", "mutate", mutate=lambda x: "outer"), recorder=rec)
    with outer:
        with inner:
            nested = [r.chaos_hook("a", value=0), r.chaos_hook("b", value=0)]
        nested.append(r.chaos_hook("a", value=0))
    nested.append(r.chaos_hook("a", value=0))

    def unknown():
        with r.ChaosInjector(r.Fault("s", "nope"), recorder=rec):
            r.chaos_hook("s")

    errors = [_raised(lambda: r.Fault("s", "mutate")), _raised(lambda: r.Fault("s", "slow", at=-1)),
              _raised(unknown)]
    return dict(out=out, seq=seq, injections=injections, nested=nested, errors=errors,
                counts=[(f.seen, f.fired) for f in faults],
                events=[{k: v for k, v in e.items() if k != "t"} for e in rec.events()])


def test_chaos_firing_sequences_equal():
    want, got = both(_chaos_ops)
    assert got == want
    assert ("dispatch", ("InjectedFault", "chaos: dispatch hang (simulated watchdog-deadline "
                                          "abort)")) in got["seq"]
    assert got["nested"] == ["inner", 0, "outer", 0]


def test_corrupt_checkpoint_waits_for_slice_d(tmp_path):
    """Checkpoints are ported (``tests/test_torch_checkpoint.py`` holds
    the fallback): no step on disk corrupts nothing; the newest numbered
    step is the one corrupted, in JAX's two modes."""
    assert port_robustness.corrupt_latest_checkpoint(tmp_path) is None
    for step in (3, 12):
        (tmp_path / str(step)).mkdir()
        (tmp_path / str(step) / "data").write_bytes(b"x" * 64)
    (tmp_path / "20.partial").mkdir()
    assert port_robustness.corrupt_latest_checkpoint(tmp_path) == 12
    assert (tmp_path / "12" / "data").stat().st_size == 32
    assert port_robustness.corrupt_latest_checkpoint(tmp_path, mode="garble") == 12
    assert (tmp_path / "12" / "data").read_bytes()[:4] == b"\xde\xad\xbe\xef"
    assert (tmp_path / "3" / "data").read_bytes() == b"x" * 64


# --- degradation ladder and recovery config ---------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(patience=1), dict(trip=2.0, clear=0.5, patience=2),
                                dict(patience=1, max_level=2), dict(trip=1.0, clear=0.0)],
                         ids=["default", "patience1", "band", "max2", "clear0"])
def test_ladder_levels_equal_for_a_burn_sequence(kw):
    burns = np.random.default_rng(3).choice([0.0, 0.2, 0.7, 1.0, 1.5, 3.0], size=80).tolist()

    def levels(m):
        lad = m.robustness.DegradationLadder(**kw)
        return [lad.update(b) for b in burns], lad.transitions, lad.name

    want, got = both(levels)
    assert got == want
    assert len(set(got[0])) > 1


def test_ladder_and_resilience_validation_equal():
    def errors(m):
        r = m.robustness
        return [_raised(lambda: r.DegradationLadder(trip=0.5, clear=0.5)),
                _raised(lambda: r.DegradationLadder(patience=0)),
                _raised(lambda: r.DegradationLadder(max_level=4)),
                _raised(lambda: r.ResilienceConfig(max_skips=-1)),
                _raised(lambda: r.ResilienceConfig(spike_factor=1.0)),
                _raised(lambda: r.ResilienceConfig(max_rollbacks=-2)),
                str(r.PreemptionError(12, "/ckpt")), r.DegradationLadder.LEVELS,
                r.ResilienceConfig() == r.ResilienceConfig()]

    want, got = both(errors)
    assert got == want


# --- profiling, sync and the kernel-library count ------------------------------------


def test_profiling_trace_holds_annotations(tmp_path):
    with profiling.trace(tmp_path) as prof:
        with profiling.annotate("engine.refill_step"):
            torch.ones(4) + 1
    assert "engine.refill_step" in (tmp_path / "trace.json").read_text()
    assert any(e.key == "engine.refill_step" for e in prof.key_averages())


def test_checking_traps_non_finite_and_restores():
    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    with pytest.raises(FloatingPointError, match="non-finite"):
        with profiling.checking():
            assert torch.is_anomaly_enabled()
            torch.zeros(2) / torch.zeros(2)
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == before
    with profiling.checking(nans=False, checks=False):
        assert torch.isnan(torch.zeros(1) / torch.zeros(1)).all()
    x = torch.ones(3, requires_grad=True)
    with profiling.checking(nans=False):
        (x * 2).sum().backward()            # a finite backward passes
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == before


def test_a_library_load_rebuckets_the_engine_frame_to_compile(monkeypatch):
    """A kernel library built or loaded inside a device frame: the frame
    books ``compile``, not ``device``."""
    from learning_jax_sharding_tpu_torch.models.serving import ContinuousEngine
    from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY

    eng = ContinuousEngine(CONFIG_TINY, device="cpu", batch_size=1, max_new_tokens=1)
    libc = ctypes.util.find_library("c")
    monkeypatch.setattr(_build, "build", lambda name: libc)
    monkeypatch.setattr(_build, "_loaded", {})
    loads = _build.loads
    eng.ledger.begin_window()
    with eng.ledger.measure("sched"):          # a step's frame around both
        with eng._led_device("refill_step"):
            _build.load_library("probe_count")
            _build.load_library("probe_count")  # loaded once: counted once
            time.sleep(0.01)
        with eng._led_device("decode_block"):
            time.sleep(0.01)
    assert _build.loads == loads + 1
    buckets = eng.ledger.window_buckets()
    assert buckets["compile"] >= 0.01 and buckets["device"] >= 0.01
    assert set(eng.ledger.device_families()) == {"decode_block"}
    assert eng.ledger.reconcile()["ok"]
