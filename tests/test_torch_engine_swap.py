"""The port engine's weight swaps against the JAX engine's.

``tests/test_ztenancy.py::TestHotSwap`` ported: the port's
``ContinuousEngine`` (``CONFIG_TINY`` in fp32, dense decode attention, the
mixed scheduler, 2 slots, +5 tokens) and the JAX engine run the same
scenarios on one device (JAX on a one-device mesh; over a mesh:
``tests/test_torch_engine_swap_mesh.py``), with the same JAX-initialised
weights and the same new versions (the weights times 1.01 and 0.99 in
fp32), carried across by ``from_flax_params``:

* the saturated drain-mode swap: six requests through two slots, the swap
  staged with both slots busy and four queued, then stepped with the OLD
  params (the installed weights must override them): nothing dropped or
  failed, the two requests in flight finished on version 0 and the queue on
  version 3, each response equal to a solo serve under its version's
  weights, one staging and one commit;
* the preempt-mode swap: committed at once, every request recomputed under
  the new weights, ``step()`` with no params;
* one staged swap at a time, ``step()`` without params refused before any
  swap, the stall histogram's one observation;
* a fault at the ``engine.swap_stage`` chaos seam: the swap aborts into
  ``engine_swap_aborted_total`` and the engine serves its old weights.

Every outcome (tokens, versions, counts) equals JAX's. After the commit
every step serves the installed tensors as they are: steps with stale
params load nothing, and in-place updates of the swapped-in tree (after the
staging and after the commit) never reach the engine. Tolerances:
none; tokens, versions and counts are compared for equality.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu import robustness as jax_robustness
from learning_jax_sharding_tpu.models import serving as jax_serving
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP as JAX_DP_TP
from learning_jax_sharding_tpu_torch import robustness as port_robustness
from learning_jax_sharding_tpu_torch.models import serving as port_serving
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from learning_jax_sharding_tpu_torch.tenancy import serving_shardings, stage_params
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

NEW = 5
ENGINE = dict(batch_size=2, max_new_tokens=NEW, refill_chunk=4, mixed=True)
JAX_CFG = dataclasses.replace(JAX_TINY, dtype=jnp.float32, decode_attention="dense")
PORT_CFG = dataclasses.replace(CONFIG_TINY, decode_attention="dense")


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, CONFIG_TINY.vocab_size, size=(n,)).astype(np.int32)
            for n in (3, 9, 5, 7, 4, 6)]


@functools.cache
def _numpy_trees():
    model = JaxTransformer(JAX_CFG)
    variables = jax.jit(lambda r, t: model.init({"params": r}, t))(
        jax.random.key(3), np.zeros((2, 8), np.int32))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))
    return {name: jax.tree.map(lambda x, f=f: x * np.float32(f), params)
            for name, f in (("v0", 1.0), ("v3", 1.01), ("v9", 0.99))}


def _port_trees():
    return {k: from_flax_params(v, CONFIG_TINY) for k, v in _numpy_trees().items()}


def _drive(eng, params, reqs, *, max_steps=400):
    for rid, p in reqs.items():
        eng.add_request(p, rid=rid)
    out, steps = {}, 0
    while eng.has_work():
        eng.step(params)
        out.update(eng.pop_finished())
        steps += 1
        assert steps <= max_steps, "engine wedged"
    out.update(eng.pop_finished())
    return out


def _tokens(out):
    return {rid: (np.asarray(t).tolist() if isinstance(t, np.ndarray) else t.status)
            for rid, t in sorted(out.items())}


def swap_cases(make, trees, robustness):
    """``TestHotSwap``'s scenarios through engines of ``make(**ENGINE)`` →
    their observables. ``trees``: the weights ``v0`` and the new versions
    ``v3``, ``v9``; ``robustness``: the side's chaos module."""
    prompts = _prompts()
    reqs = dict(enumerate(prompts))
    got = {}

    def solo(tree, rids):
        return _tokens(_drive(make(**ENGINE), tree, {r: reqs[r] for r in rids}))

    eng = make(**ENGINE)
    for rid, p in reqs.items():
        eng.add_request(p, rid=rid)
    eng.step(trees["v0"])                       # slots full, queue deep
    occupied = [r for r in eng._req if r >= 0]
    staged = eng.swap_weights(trees["v3"], version=3)
    draining = (eng.weights_version, eng.swap_pending, eng.queue_depth())
    out, steps = {}, 0
    while eng.has_work():
        eng.step(trees["v0"])                   # stale params: the installed tree wins
        out.update(eng.pop_finished())
        steps += 1
        assert steps <= 400
    out.update(eng.pop_finished())
    versions = {rid: eng.finished_versions[rid] for rid in reqs}
    snap = eng.registry.snapshot()
    got["saturated"] = dict(
        tokens=_tokens(out), occupied=occupied, staged=staged, draining=draining,
        versions=versions, version=eng.weights_version,
        solo={**solo(trees["v0"], [r for r, v in versions.items() if v == 0]),
              **solo(trees["v3"], [r for r, v in versions.items() if v == 3])},
        counts={k: snap[k] for k in ("engine_swap_commits_total", "engine_swap_staged_total",
                                     "engine_swap_aborted_total",
                                     "engine_requests_failed_total")},
        moved=snap["engine_swap_bytes_total"] > 0,
        ledger=(eng.ledger.window_buckets()["swap"] > 0, eng.ledger.reconcile()["ok"]))
    eng.close()

    eng = make(**ENGINE)
    four = {r: prompts[r] for r in range(4)}
    for rid, p in four.items():
        eng.add_request(p, rid=rid)
    eng.step(trees["v0"])
    staged = eng.swap_weights(trees["v9"], version=9, mode="preempt")
    version = eng.weights_version               # committed at once
    out, steps = {}, 0
    while eng.has_work():
        eng.step()                              # the installed weights only
        out.update(eng.pop_finished())
        steps += 1
        assert steps <= 400
    out.update(eng.pop_finished())
    got["preempt"] = dict(tokens=_tokens(out), staged=staged, version=version,
                          versions={r: eng.finished_versions[r] for r in four},
                          solo=solo(trees["v9"], list(four)),
                          preemptions=eng.registry.get("engine_preemptions_total").value)
    eng.close()

    eng = make(**ENGINE)
    refusals = []
    try:
        eng.step()
    except TypeError:
        refusals.append("TypeError")
    eng.add_request(prompts[0], rid=0)
    eng.step(trees["v0"])
    staged = eng.swap_weights(trees["v0"], version=1)
    try:
        eng.swap_weights(trees["v0"], version=2)
    except RuntimeError:
        refusals.append("RuntimeError")
    while eng.has_work():
        eng.step(trees["v0"])
    h = eng.registry.get("engine_swap_stall_seconds")
    got["double"] = dict(refusals=refusals, staged=staged, version=eng.weights_version,
                         stall_observations=h.count, pending=eng.swap_pending)
    eng.close()

    eng = make(**ENGINE)
    with robustness.ChaosInjector(robustness.Fault("engine.swap_stage", "hang")) as inj:
        aborted = eng.swap_weights(trees["v3"], version=3)
    out = _drive(eng, trees["v0"], {0: prompts[0], 1: prompts[1]})
    got["abort"] = dict(staged=aborted, version=eng.weights_version, pending=eng.swap_pending,
                        fired=len(inj.injections), tokens=_tokens(out),
                        solo=solo(trees["v0"], [0, 1]),
                        counts={k: eng.registry.get(k).value for k in (
                            "engine_swap_aborted_total", "engine_swap_staged_total",
                            "engine_swap_commits_total")})
    eng.close()
    return got


def jax_swap_cases(mesh):
    """``swap_cases`` through JAX engines on ``mesh`` under ``RULES_DP_TP``."""
    with jax.default_matmul_precision("float32"):
        return swap_cases(
            lambda **kw: jax_serving.ContinuousEngine(JAX_CFG, mesh, JAX_DP_TP, **kw),
            jax.tree.map(jnp.asarray, _numpy_trees()), jax_robustness)


def port_one_device_cases():
    return swap_cases(lambda **kw: port_serving.ContinuousEngine(PORT_CFG, device="cpu", **kw),
                      _port_trees(), port_robustness)


@pytest.fixture(scope="module")
def jax_side():
    return jax_swap_cases(build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1]))


@pytest.fixture(scope="module")
def one_device():
    return port_one_device_cases()


CASES = ["saturated", "preempt", "double", "abort"]


@pytest.mark.parametrize("case", CASES)
def test_one_device_swap_equals_jax(case, one_device, jax_side):
    assert one_device[case] == jax_side[case]


def test_saturated_swap_drops_nothing_and_pins_versions(one_device):
    got = one_device["saturated"]
    assert got["staged"] and got["draining"] == (0, True, 4)
    assert sorted(got["tokens"]) == list(range(6))
    assert all(isinstance(t, list) for t in got["tokens"].values())
    assert set(got["versions"].values()) == {0, 3}
    assert all(got["versions"][r] == 0 for r in got["occupied"]) and len(got["occupied"]) == 2
    assert all(v == 3 for r, v in got["versions"].items() if r not in got["occupied"])
    assert got["version"] == 3
    assert got["tokens"] == got["solo"]
    assert got["counts"] == {"engine_swap_commits_total": 1, "engine_swap_staged_total": 1,
                             "engine_swap_aborted_total": 0, "engine_requests_failed_total": 0}
    assert got["moved"] and got["ledger"] == (True, True)


def test_preempt_swap_recomputes_on_the_new_version(one_device):
    got = one_device["preempt"]
    assert got["staged"] and got["version"] == 9
    assert set(got["versions"].values()) == {9}
    assert got["tokens"] == got["solo"] and got["preemptions"] == 2


def test_double_stage_refused(one_device):
    assert one_device["double"] == dict(refusals=["TypeError", "RuntimeError"], staged=True,
                                        version=1, stall_observations=1, pending=False)


def test_chaos_at_swap_stage_aborts(one_device):
    got = one_device["abort"]
    assert got["staged"] is False and got["version"] == 0 and not got["pending"]
    assert got["fired"] == 1 and got["tokens"] == got["solo"]
    assert got["counts"] == {"engine_swap_aborted_total": 1, "engine_swap_staged_total": 0,
                             "engine_swap_commits_total": 0}


def test_commit_primes_the_cast_cache():
    """After the commit the installed tensors serve: a step with the stale
    params loads nothing, and the model holds the new weights (as tensors
    of its own: the caller's tree stays apart)."""
    trees = _port_trees()
    eng = port_serving.ContinuousEngine(PORT_CFG, device="cpu", **ENGINE)
    eng.serve(trees["v0"], _prompts()[:1])
    loads = []
    real = eng._load
    eng._load = lambda *a: loads.append(1) or real(*a)
    assert eng.swap_weights(trees["v3"], version=3) and eng.weights_version == 3
    _drive(eng, trees["v0"], {7: _prompts()[1]})
    assert loads == []
    for name, t in eng._model.state_dict().items():
        assert torch.equal(t, trees["v3"][name])
        assert t.untyped_storage().data_ptr() != trees["v3"][name].untyped_storage().data_ptr()


def test_in_place_updates_of_the_swapped_tree_never_reach_the_engine():
    """Torch trains in place (an optimizer step on the tree a
    ``state_dict()`` gave): updating ``new_params`` after the staging and
    again after the commit changes nothing the engine serves. The tokens
    equal a solo serve under the weights as staged, and nothing is loaded
    after the commit."""
    trees, prompts = _port_trees(), _prompts()
    staged_w = {k: t.clone() for k, t in trees["v3"].items()}
    eng = port_serving.ContinuousEngine(PORT_CFG, device="cpu", **ENGINE)
    for rid in (0, 1):
        eng.add_request(prompts[rid], rid=rid)
    eng.step(trees["v0"])
    assert eng.swap_weights(trees["v3"], version=3) and eng.swap_pending
    with torch.no_grad():
        for t in trees["v3"].values():
            t.mul_(0.5)
    out, steps = {}, 0
    while eng.swap_pending:
        eng.step(trees["v0"])
        out.update(eng.pop_finished())
        steps += 1
        assert steps <= 400, "the swap never committed"
    with torch.no_grad():
        for t in trees["v3"].values():
            t.add_(1.0)
    loads = []
    real = eng._load
    eng._load = lambda *a: loads.append(1) or real(*a)
    out.update(_drive(eng, trees["v3"], {r: prompts[r] for r in (2, 3, 4)}))
    assert loads == [] and eng.weights_version == 3
    assert {r: eng.finished_versions[r] for r in range(5)} == {0: 0, 1: 0, 2: 3, 3: 3, 4: 3}
    solo = _drive(port_serving.ContinuousEngine(PORT_CFG, device="cpu", **ENGINE), staged_w,
                  {r: prompts[r] for r in (2, 3, 4)})
    assert _tokens({r: out[r] for r in (2, 3, 4)}) == _tokens(solo)
    for name, t in eng._model.state_dict().items():
        assert torch.equal(t, staged_w[name])


def test_stage_params_helpers():
    """``tenancy.stage_params`` into ``serving_shardings`` of a served tree:
    on one device the device path, leaves kept."""
    trees = _port_trees()
    dst = serving_shardings(trees["v0"])
    staged, stats = stage_params(trees["v3"], dst)
    assert stats["mode"] == "device" and stats["segments"] == len(trees["v3"])
    assert all(staged[k] is trees["v3"][k] for k in staged)
