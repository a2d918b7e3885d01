"""The port engine's telemetry and recovery policies against the JAX engine's.

The port's ``ContinuousEngine`` on the CPU and the JAX ``ContinuousEngine``
on a one-device mesh (``CONFIG_TINY`` in fp32, dense decode attention, the
blocked backend for the paged cache, the same JAX-initialised weights
carried across by ``from_flax_params``) run
the same scenarios, ported from ``tests/test_zero_downtime.py``
(``TestEnginePolicies`` but its drain test, ``TestDegradedSpeculation``),
``tests/test_telemetry.py::TestEngineTelemetry`` and
``tests/test_goodput.py`` (``TestEngineLedger``, ``TestChaosAttribution``):
the close drain, request and engine deadlines, the bounded queue, the
quarantine of a sticky poison request with probation, degraded
speculation under an unreachable SLO, the registry-backed ``last_stats``
and ``last_latency``, the goodput ledger with a trace sink, and injected
faults booked to ``recovery``. Every scenario compares terminal statuses,
the tokens of every surviving request and every count the registry holds
(counters, gauges, histogram observation counts); seconds are held only
by ``reconcile()``. Each engine is built once per module and side.
"""

import dataclasses
import functools
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu import robustness as jax_robustness
from learning_jax_sharding_tpu import telemetry as jax_telemetry
from learning_jax_sharding_tpu.models import serving as jax_serving
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_TP_SERVING
from learning_jax_sharding_tpu_torch import robustness as port_robustness
from learning_jax_sharding_tpu_torch import telemetry as port_telemetry
from learning_jax_sharding_tpu_torch.models import serving as port_serving
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

COMMON = dict(batch_size=2, max_new_tokens=4, refill_chunk=4)
DRAFT = dict(num_layers=1)
# An injected dispatch delay: long beside a model call on the CPU, so the
# device bucket cannot have absorbed it unnoticed.
SLOW_S = 0.25
JAX_CFG = dataclasses.replace(JAX_TINY, dtype=jnp.float32, decode_attention="dense")
PORT_CFG = dataclasses.replace(CONFIG_TINY, decode_attention="dense")


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CONFIG_TINY.vocab_size, size=(n,)).astype(np.int32) for n in sizes]


def _init(cfg, seed):
    model = JaxTransformer(cfg)
    variables = jax.jit(lambda r, t: model.init({"params": r}, t))(
        jax.random.key(seed), np.zeros((2, 8), np.int32))
    return jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))


@functools.cache
def _trees():
    params, draft = _init(JAX_CFG, 3), _init(dataclasses.replace(JAX_CFG, **DRAFT), 5)
    return {"jax": (params, draft),
            "port": (from_flax_params(params, PORT_CFG),
                     from_flax_params(draft, dataclasses.replace(PORT_CFG, **DRAFT)))}


def _side(name):
    """What a scenario needs of one side: its engine, weights and modules."""
    params, draft = _trees()[name]
    if name == "jax":
        mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
        cfg = JAX_CFG

        def engine(c=cfg, **kw):
            return jax_serving.ContinuousEngine(c, mesh, RULES_TP_SERVING, **kw)

        serving, telemetry, robustness = jax_serving, jax_telemetry, jax_robustness
    else:
        cfg = PORT_CFG

        def engine(c=cfg, **kw):
            return port_serving.ContinuousEngine(c, device="cpu", **kw)

        serving, telemetry, robustness = port_serving, port_telemetry, port_robustness
    return types.SimpleNamespace(engine=engine, cfg=cfg, params=params, draft=draft,
                                 serving=serving, telemetry=telemetry, robustness=robustness)


def _drain(eng, params, draft=None):
    out = {}
    while eng.has_work():
        eng.step(params, draft) if draft is not None else eng.step(params)
        out.update(eng.pop_finished())
    out.update(eng.pop_finished())
    return out


def _results(out):
    """``{rid: (status, tokens or None)}`` of a ``pop_finished`` map."""
    res = {}
    for rid, r in sorted(out.items()):
        if isinstance(r, np.ndarray):
            res[rid] = ("ok", r.tolist())
        else:
            res[rid] = (r.status, None if r.tokens is None else np.asarray(r.tokens).tolist())
    return res


def _counts(registry):
    """Every count the registry holds: counters and gauges (but those of
    seconds), histograms' observation counts."""
    out = {}
    for key, value in registry.snapshot().items():
        if isinstance(value, dict):
            out[key] = value["count"]
        elif "seconds" not in key and "burn_rate" not in key:
            out[key] = value
    return out


def _injections(inj):
    return [{k: v for k, v in rec.items() if k != "free"} for rec in inj.injections]


def _scenarios(side):
    s = side
    tel, rob = s.telemetry, s.robustness
    queue = _prompts(11, (3, 9, 5, 4))
    got = {}

    # --- one engine: close, deadlines, quarantine, telemetry windows ---------
    eng = s.engine(**COMMON)
    for p in queue[:3]:
        eng.add_request(p)
    eng.step(s.params)                       # two admitted, one queued
    eng.close()
    close = dict(fin=_results(eng.pop_finished()), has_work=eng.has_work())
    eng.close()                              # idempotent
    close["reuse"] = [o.tolist() for o in eng.serve(s.params, [queue[0]])]
    close["creations"] = eng.cache_creations
    close["counts"] = _counts(eng.registry)
    got["close"] = close

    eng.add_request(queue[0])
    ref = _drain(eng, s.params)
    eng.add_request(queue[0], deadline_s=60.0)
    eng.add_request(queue[1], deadline_s=1e-6)
    out = _drain(eng, s.params)
    lat = eng.latency_stats()
    got["deadline"] = dict(ref=_results(ref), out=_results(out), counts=_counts(eng.registry),
                           rates=(lat["deadline_miss_rate"], lat["shed_rate"], lat["failed"]))

    for i, p in enumerate(queue):
        eng.add_request(p, rid=10 + i)
    clean = _drain(eng, s.params)
    rec = tel.FlightRecorder()
    for i, p in enumerate(queue):
        eng.add_request(p, rid=20 + i)
    with rob.ChaosInjector(rob.Fault("engine.dispatch", "hang", rid=21, count=-1),
                           recorder=rec) as inj:
        out = _drain(eng, s.params)
    got["quarantine"] = dict(
        clean=_results(clean), out=_results(out), counts=_counts(eng.registry),
        injections=_injections(inj), chaos_events=len(rec.events("chaos.inject")),
        engine_events={k: len(eng.recorder.events(k)) > 0
                       for k in ("engine.quarantine", "engine.dispatch_fault")})

    tprompts = _prompts(31, (3, 9, 5))
    before = _counts(eng.registry)
    n_events = len(eng.tracer.events)
    snap = eng.registry.snapshot()
    before_s = snap["engine_refill_seconds_total"] + snap["engine_decode_seconds_total"]
    outs = eng.serve(s.params, tprompts)
    snap = eng.registry.snapshot()
    in_serve = eng.tracer.events[n_events:]
    tele = dict(
        outs=[o.tolist() for o in outs], before=before, counts=_counts(eng.registry),
        latency_keys=sorted(eng.last_latency),
        # The split last_latency reports is the counters' window delta.
        split=(eng.last_latency["refill_s"] + eng.last_latency["decode_s"],
               snap["engine_refill_seconds_total"] + snap["engine_decode_seconds_total"]
               - before_s),
        names=sorted({e["name"] for e in in_serve}),
        begins=sorted({e["id"] for e in in_serve if e["ph"] == "b"}),
        ends=sorted({e["id"] for e in in_serve if e["ph"] == "e"}),
        text=[line for line in eng.registry.prometheus_text().splitlines()
              if line.startswith("# TYPE engine_")])
    eng.serve(s.params, tprompts[:1])
    tele["window"] = (eng.last_latency["requests"], _counts(eng.registry))
    tele["reconcile"] = eng.ledger.reconcile()
    got["telemetry"] = tele

    # --- engine-level deadline, bounded queue ---------------------------------
    eng = s.engine(**COMMON, deadline_s=1e-6)
    eng.add_request(queue[0])
    eng.step(s.params)
    got["engine_deadline"] = dict(out=_results(eng.pop_finished()), has_work=eng.has_work(),
                                  counts=_counts(eng.registry))

    eng = s.engine(**COMMON, max_queue=2)
    eng.add_request(queue[0])
    eng.add_request(queue[1])
    try:
        eng.add_request(queue[2])
        shed = None
    except s.serving.AdmissionError as exc:
        shed = str(exc)
    out = _drain(eng, s.params)
    got["shed"] = dict(error=shed, out=_results(out), counts=_counts(eng.registry),
                       shed_rate=eng.latency_stats()["shed_rate"])

    # --- degraded speculation ----------------------------------------------------
    spec = dict(COMMON, draft_config=dataclasses.replace(s.cfg, **DRAFT), num_draft=2)
    ref = s.engine(**spec).serve(s.params, queue, draft_params=s.draft)
    eng = s.engine(**spec, slo=tel.SLOMonitor([tel.SLOTarget("ttft", 1e-9, objective=0.5)]),
                   degradation=rob.DegradationLadder(patience=1))
    for p in queue + queue:                  # two waves: degradation bites wave 2
        eng.add_request(p)
    levels, out = [], {}
    while eng.has_work():
        eng.step(s.params, s.draft)
        levels.append(eng.degradation_level)
        out.update(eng.pop_finished())
    got["degraded"] = dict(ref=[o.tolist() for o in ref], out=_results(out), levels=levels,
                           spec_disabled=eng._spec_disabled, counts=_counts(eng.registry),
                           last_latency_requests=eng.latency_stats()["requests"])

    # --- paged + prefix: last_stats from the registry -------------------------------
    eng = s.engine(dataclasses.replace(s.cfg, decode_attention="blocked"), **COMMON,
                   paged_pages=9, page_size=8, prefix_cache=True)
    system = _prompts(9, (16,))[0]
    pq = [np.concatenate([system, t]) for t in _prompts(19, (4, 4, 4))]
    stats = []
    for _ in range(2):
        outs = eng.serve(s.params, pq)
        stats.append((eng.last_stats, {k: v for k, v in eng.last_latency.items()
                                       if k.endswith("_rate")}, [o.tolist() for o in outs]))
    got["paged"] = dict(stats=stats, counts=_counts(eng.registry))

    # --- the ledger with a trace sink, then chaos attribution ---------------------
    eng = s.engine(batch_size=2, max_new_tokens=4, refill_chunk=8)
    eng.trace_sink = tel.TraceStore(registry=eng.registry)
    rng = np.random.default_rng(14)
    lprompts = [rng.integers(1, CONFIG_TINY.vocab_size, size=(n,)).astype(np.int32)
                for n in rng.integers(5, 12, size=6)]
    for p in lprompts:
        eng.add_request(p)
    out = _drain(eng, s.params)
    ledger = dict(out=_results(out), reconcile=eng.ledger.reconcile(),
                  report=eng.ledger.window_report(), paths=eng.trace_sink.completed(),
                  text=eng.registry.prometheus_text(), counts=_counts(eng.registry))
    eng.ledger.begin_window()
    base_device = eng.ledger.totals().get("device", 0.0)
    with rob.ChaosInjector(
            rob.Fault("engine.dispatch", "slow", at=1, count=2, delay_s=SLOW_S),
            rob.Fault("engine.dispatch", "raise", at=3, count=1, error=FloatingPointError),
            recorder=tel.FlightRecorder()) as inj:
        for p in lprompts[:4]:
            eng.add_request(p)
        out = _drain(eng, s.params)
    got["ledger"] = ledger
    got["chaos"] = dict(out=_results(out), injections=_injections(inj),
                        buckets=eng.ledger.window_buckets(), reconcile=eng.ledger.reconcile(),
                        device=eng.ledger.totals()["device"] - base_device,
                        counts=_counts(eng.registry))
    return got


@pytest.fixture(scope="module")
def runs():
    return {name: _scenarios(_side(name)) for name in ("jax", "port")}


def test_close_drains_in_flight_to_terminal_status(runs):
    got, want = runs["port"]["close"], runs["jax"]["close"]
    assert got == want
    assert set(got["fin"]) == {0, 1, 2} and not got["has_work"]
    assert all(status == "shutdown" for status, _ in got["fin"].values())
    assert got["fin"][0][1] is not None and got["fin"][2][1] is None
    assert got["creations"] == 2 and len(got["reuse"][0]) == 3 + 4


def test_request_deadline_evicts_and_keeps_the_others(runs):
    got, want = runs["port"]["deadline"], runs["jax"]["deadline"]
    assert got == want
    ok_rid = min(got["out"])
    assert got["out"][ok_rid + 1][0] == "deadline"
    assert got["out"][ok_rid] == next(iter(got["ref"].values()))
    assert got["counts"]["engine_deadline_evictions_total"] == 1
    assert got["rates"][0] > 0


def test_engine_deadline_applies_to_all(runs):
    got, want = runs["port"]["engine_deadline"], runs["jax"]["engine_deadline"]
    assert got == want
    assert got["out"][0][0] == "deadline" and not got["has_work"]


def test_bounded_queue_sheds_with_admission_error(runs):
    got, want = runs["port"]["shed"], runs["jax"]["shed"]
    assert got == want
    assert "queue full" in got["error"] and set(got["out"]) == {0, 1}
    assert got["counts"]["engine_shed_total"] == 1 and got["shed_rate"] > 0


def test_quarantine_strikes_and_probation(runs):
    got, want = runs["port"]["quarantine"], runs["jax"]["quarantine"]
    assert got == want
    assert got["out"][21][0] == "poisoned"
    for rid, clean in ((20, 10), (22, 12), (23, 13)):
        assert got["out"][rid] == got["clean"][clean]
    assert got["counts"]["engine_quarantined_total"] == 1
    assert got["chaos_events"] > 0 and all(got["engine_events"].values())


def test_degraded_speculation_keeps_greedy_tokens(runs):
    got, want = runs["port"]["degraded"], runs["jax"]["degraded"]
    assert got == want
    assert got["levels"][-1] >= 1 and got["spec_disabled"]
    n = len(got["ref"])
    for i in range(n):
        assert got["out"][i] == ("ok", got["ref"][i])
        assert got["out"][i + n] == ("ok", got["ref"][i])


def test_counters_back_last_stats_and_latency_windows(runs):
    got, want = runs["port"]["telemetry"], runs["jax"]["telemetry"]
    for key in ("outs", "before", "counts", "names", "begins", "ends", "text"):
        assert got[key] == want[key], key
    assert set(want["latency_keys"]) <= set(got["latency_keys"])
    assert got["window"] == want["window"] and got["window"][0] == 1
    counts, before, outs = got["counts"], got["before"], got["outs"]
    assert counts["engine_requests_finished_total"] - before["engine_requests_finished_total"] \
        == len(outs) == counts["engine_ttft_seconds"] - before["engine_ttft_seconds"]
    assert {"request.arrival", "request.admit", "request.first_token", "engine.serve",
            "engine.refill", "engine.decode"} <= set(got["names"])
    assert got["split"][0] == pytest.approx(got["split"][1])
    assert got["reconcile"]["ok"], got["reconcile"]


def test_paged_last_stats_come_from_the_registry(runs):
    got, want = runs["port"]["paged"], runs["jax"]["paged"]
    assert got == want
    assert got["stats"][1][0]["prefix_hits"] == 3


def test_engine_wall_reconciles_with_complete_critical_paths(runs):
    got, want = runs["port"]["ledger"], runs["jax"]["ledger"]
    assert got["out"] == want["out"] and got["counts"] == want["counts"]
    assert got["reconcile"]["ok"], got["reconcile"]
    buckets = got["reconcile"]["buckets"]
    assert buckets["device"] > 0.0 and buckets["sched"] > 0.0
    report = got["report"]
    assert 0.0 < report["host_share"] < 1.0 and report["telemetry_share"] < 0.05
    assert report["top_contributor"] != "device"
    assert [(p["rid"], p["status"], p["legs"]) for p in got["paths"]] == [
        (p["rid"], p["status"], p["legs"]) for p in want["paths"]]
    for cp in got["paths"]:
        assert cp["stages"]["prefill"] > 0.0 and cp["stages"]["decode"] > 0.0
        assert 0.0 < cp["ttft_s"] <= cp["e2e_s"]
    assert 'ledger_seconds_total{bucket="device"}' in got["text"]
    assert 'trace_stage_seconds_bucket{stage="queue",le=' in got["text"]


def test_injected_faults_book_to_recovery_never_device(runs):
    got, want = runs["port"]["chaos"], runs["jax"]["chaos"]
    assert got["out"] == want["out"] and got["injections"] == want["injections"]
    assert got["counts"] == want["counts"]
    assert [f["fault"] for f in got["injections"]] == ["slow", "slow", "raise"]
    assert len(got["out"]) == 4 and all(s == "ok" for s, _ in got["out"].values())
    assert got["buckets"]["recovery"] >= 2 * SLOW_S
    assert got["reconcile"]["ok"], got["reconcile"]
    assert got["device"] < got["buckets"]["recovery"]


@pytest.mark.parametrize("kw,match", [
    (dict(deadline_s=0), "deadline_s must be > 0"),
    (dict(max_queue=0), "max_queue must be >= 1"),
    (dict(max_dispatch_strikes=0), "max_dispatch_strikes must be >= 1"),
    (dict(degradation="ladder"), "degradation needs slo="),
    (dict(request_deadline_s=-1.0), "deadline_s must be > 0"),
], ids=["deadline_0", "max_queue_0", "strikes_0", "degradation_without_slo", "request_deadline"])
def test_validation_errors_are_jaxs(kw, match):
    def message(side):
        kw2 = dict(kw)
        request = kw2.pop("request_deadline_s", None)
        if kw2.get("degradation") == "ladder":
            kw2["degradation"] = side.robustness.DegradationLadder()
        try:
            eng = side.engine(**COMMON, **kw2)
            eng.add_request(np.ones(3, np.int32), deadline_s=request)
        except ValueError as exc:
            return str(exc)
        return None

    want, got = message(_side("jax")), message(_side("port"))
    assert got == want and match in got
