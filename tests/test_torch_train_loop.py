"""The port's training loop against the JAX package's ``fit`` and
``evaluate``, on one CPU device and over a (2, 2) mesh of thread ranks.

``CONFIG_TINY`` in fp32 (and a width-128 config whose matrices adafactor
factors). Both sides start from JAX's initialisation (``sharded_train_state``
at ``cfg.seed`` on a (1, 1) mesh, carried across with ``from_flax_params``)
and read the same batches (a batch is a pure function of its index):

- ``fit``: per-step losses within rtol 1e-5 of JAX's on the cyclic stream
  (constant rate, AdamW) and the synthetic stream (warmup + cosine), with
  lion and with adafactor (``CONFIG_TINY``, which factors nothing, and the
  factored config); the history's steps and keys, the JSONL lines and the
  final step equal; lion's and adafactor's parameters after 3 steps within
  atol 1e-6 of optax's;
- ``evaluate``: loss and perplexity within rtol 1e-5;
- the optimizers on the same seeded gradients as optax (lion with weight
  decay, adafactor on factored, unfactored and 3-D shapes), 3 steps, atol
  1e-6; their state sizes;
- the skip guard against JAX's guarded step: a poisoned step leaves every
  parameter and moment bit-equal, and the clean step after it (under a
  warmup schedule, so the update count matters) lands within atol 1e-5 of
  JAX's parameters and moments;
- resume (losses within rtol 1e-6 of the uninterrupted run, the state
  bit-equal), prefetch on and off bit-equal, the recovery policies, the
  ledger's reconciliation, and ``fit`` over a (2, 2) mesh of thread ranks
  within rtol 1e-6 of one device, its checkpoint restored on one device
  bit-equal.
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learning_jax_sharding_tpu.data import datasets as jax_datasets
from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu.parallel import build_mesh, mesh_sharding, put
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP as JAX_RULES
from learning_jax_sharding_tpu.training import loop as jax_loop
from learning_jax_sharding_tpu.training import pipeline as jax_pipeline

from learning_jax_sharding_tpu_torch.data import (
    CyclicLMDataset,
    MemmapTokenDataset,
    ShardedBatchLoader,
    SyntheticLMDataset,
    write_token_file,
)
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.robustness import (
    ChaosInjector,
    Fault,
    PreemptionError,
    ResilienceConfig,
)
from learning_jax_sharding_tpu_torch.telemetry import (
    FlightRecorder,
    GoodputLedger,
    MetricsRegistry,
    Tracer,
)
from learning_jax_sharding_tpu_torch.telemetry.watchdog import Heartbeat, NonFiniteError, Watchdog
from learning_jax_sharding_tpu_torch.training import loop, pipeline
from learning_jax_sharding_tpu_torch.training.checkpoint import CheckpointManager
from tests import _torch_mesh_bodies as bodies
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

S = 32
LOSS_RTOL = 1e-5
OPT_ATOL = 1e-6
# AdamW after a few steps: Adam divides each gradient by its own running
# norm, so where a gradient is near zero another sum order moves the update
# by a few percent of the rate (the train step test's bound).
ADAMW_ATOL = 1e-5
FACTORED = dataclasses.replace(CONFIG_TINY, features=128, head_dim=32, hidden=256)
JAX_FACTORED = dataclasses.replace(jax_tf.CONFIG_TINY, features=128, head_dim=32, hidden=256)
JAX_CONFIGS = {id(CONFIG_TINY): jax_tf.CONFIG_TINY, id(FACTORED): JAX_FACTORED}


def _streams(kind):
    """The same stream for JAX and the port."""
    if kind == "cyclic":
        ds = CyclicLMDataset(CONFIG_TINY.vocab_size, S, seed=11)
        return ds, ds
    return (jax_datasets.SyntheticLMDataset(CONFIG_TINY.vocab_size, S, seed=7),
            SyntheticLMDataset(CONFIG_TINY.vocab_size, S, seed=7))


# name: (port config, stream, TrainLoopConfig fields)
RUNS = {
    "cyclic_adamw": (CONFIG_TINY, "cyclic", dict(steps=6, learning_rate=3e-3)),
    "synthetic_warmup_cosine": (CONFIG_TINY, "synthetic", dict(
        steps=6, learning_rate=3e-3, warmup_steps=2, lr_schedule="cosine",
        min_learning_rate=1e-4)),
    "lion": (CONFIG_TINY, "cyclic", dict(steps=3, optimizer="lion", learning_rate=1e-3)),
    "adafactor": (CONFIG_TINY, "cyclic", dict(steps=3, optimizer="adafactor",
                                              learning_rate=1e-2)),
    "adafactor_factored": (FACTORED, "cyclic", dict(steps=3, optimizer="adafactor",
                                                    learning_rate=1e-2)),
}


@functools.cache
def _mesh11():
    return build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])


@functools.cache
def _jax_init(cfg_id, seed=0):
    """JAX's initial parameters of the config (as ``fit`` draws them)."""
    mesh = _mesh11()
    x = put(np.zeros((8, S), np.int32), mesh_sharding(mesh, "data", None))
    state, _ = jax_pipeline.sharded_train_state(
        jax_tf.Transformer(JAX_CONFIGS[cfg_id]), optax.adamw(1e-3), x,
        {"params": jax.random.key(seed)}, mesh, JAX_RULES)
    return jax.tree.map(np.asarray, state.params)


def _model(cfg=CONFIG_TINY, sd=None):
    """A fresh port model on the CPU from JAX's initial parameters."""
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(sd if sd is not None else
                          from_flax_params(_jax_init(id(cfg)), cfg))
    return model


def _cfg(fields, **kw):
    return loop.TrainLoopConfig(global_batch_size=8, **{**fields, **kw})


@functools.cache
def _jax_run(name, metrics_dir):
    cfg, stream, fields = RUNS[name]
    jcfg = jax_loop.TrainLoopConfig(global_batch_size=8,
                                    metrics_path=f"{metrics_dir}/jax_{name}.jsonl", **fields)
    with jax.default_matmul_precision("float32"):
        state, history = jax_loop.fit(jax_tf.Transformer(JAX_CONFIGS[id(cfg)]),
                                      _streams(stream)[0], _mesh11(), JAX_RULES, jcfg)
        ev = jax_loop.evaluate(state, _streams(stream)[0], _mesh11(), JAX_RULES,
                               batch_size=8, num_batches=2)
    lines = [json.loads(s) for s in open(jcfg.metrics_path)]
    return dict(history=history, lines=lines, step=int(state.step), eval=ev,
                params=from_flax_params(jax.tree.map(np.asarray, state.params), cfg))


@pytest.fixture(scope="module")
def metrics_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("metrics"))


@functools.cache
def _port_run(name, metrics_dir):
    cfg, stream, fields = RUNS[name]
    path = f"{metrics_dir}/{name}.jsonl"
    state, history = loop.fit(_model(cfg), _streams(stream)[1], None, None,
                              _cfg(fields, metrics_path=path))
    ev = loop.evaluate(state, _streams(stream)[1], None, None, batch_size=8, num_batches=2)
    return dict(history=history, lines=[json.loads(s) for s in open(path)], state=state,
                eval=ev)


def test_datasets_equal_jax(tmp_path):
    want = jax_datasets.SyntheticLMDataset(256, S, seed=3)
    got = SyntheticLMDataset(256, S, seed=3)
    for index, rows in ((0, None), (5, slice(2, 6))):
        for k, v in want.batch(index, rows=rows, batch_size=8).items():
            np.testing.assert_array_equal(got.batch(index, rows=rows, batch_size=8)[k], v)
    tokens = np.random.default_rng(0).integers(0, 256, 4096)
    write_token_file(tmp_path / "t.bin", tokens)
    jm = jax_datasets.MemmapTokenDataset(tmp_path / "t.bin", S, seed=1)
    pm = MemmapTokenDataset(tmp_path / "t.bin", S, seed=1)
    assert len(pm) == len(jm) == 4096
    for k, v in jm.batch(2, rows=slice(1, 3), batch_size=4).items():
        np.testing.assert_array_equal(pm.batch(2, rows=slice(1, 3), batch_size=4)[k], v)


@pytest.mark.parametrize("name", list(RUNS))
def test_fit_matches_jax(name, metrics_dir):
    want, got = _jax_run(name, metrics_dir), _port_run(name, metrics_dir)
    steps = RUNS[name][2]["steps"]
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]] == list(
        range(1, steps + 1))
    assert [sorted(h) for h in got["history"]] == [sorted(h) for h in want["history"]]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]], rtol=LOSS_RTOL)
    assert got["state"].step == got["state"].updates == want["step"] == steps
    # The JSONL mirror: one line a step, the same steps and keys.
    assert [(r["step"], sorted(r)) for r in got["lines"]] == [
        (r["step"], sorted(r)) for r in want["lines"]]
    if RUNS[name][2].get("optimizer") in ("lion", "adafactor"):
        sd = got["state"].model.state_dict()
        for k, v in want["params"].items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=OPT_ATOL, err_msg=k)
    if name == "cyclic_adamw":
        losses = [h["loss"] for h in got["history"]]
        assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["cyclic_adamw", "synthetic_warmup_cosine"])
def test_evaluate_matches_jax(name, metrics_dir):
    want, got = _jax_run(name, metrics_dir)["eval"], _port_run(name, metrics_dir)["eval"]
    assert got["batches"] == want["batches"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=LOSS_RTOL)


# Shapes of the optimizer oracle: factored (both dims ≥ 128, square and
# not, a 3-D stack), unfactored (a small dim), vectors.
OPT_SHAPES = [(256, 128), (128, 128), (3, 130, 140), (64, 256), (128,), (5,)]


def _opt_pair(name):
    sched = optax.linear_schedule(1e-3, 3e-3, 2)
    if name == "lion":
        return optax.lion(sched, weight_decay=0.01), loop.lion(
            loop._linear(1e-3, 3e-3, 2), weight_decay=0.01)
    return optax.adafactor(sched), loop.adafactor(loop._linear(1e-3, 3e-3, 2))


@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_optimizer_matches_optax(name):
    """Three updates on the same seeded gradients (a schedule that moves),
    parameters within atol 1e-6 of optax's."""
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32) for s in OPT_SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 1e-2 for s in OPT_SHAPES]
             for _ in range(3)]
    tx, desc = _opt_pair(name)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    state = pipeline.TrainState(model=torch.nn.ParameterList(tp), optimizer=desc.create(tp),
                                schedule=desc.schedule)
    for g in grads:
        upd, opt_state = update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.updates)
        state.optimizer.step()
        state.updates += 1
    for shape, a, b in zip(OPT_SHAPES, tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=OPT_ATOL,
                                   err_msg=str(shape))


def test_optimizer_state_sizes():
    """Lion keeps one moment (half of AdamW's two); adafactor keeps a row
    and a column vector for a factored parameter, a full second moment for
    the rest."""
    model = _model(FACTORED)

    def slots(desc):
        opt = desc.create(list(model.parameters()))
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        return {n: {k: tuple(v.shape) for k, v in opt.state[p].items() if k != "step"}
                for n, p in model.named_parameters()}

    snapshot = {n: p.detach().clone() for n, p in model.named_parameters()}
    adamw = slots(loop.adamw(0.0, weight_decay=0.0))
    lion = slots(loop.lion(0.0, weight_decay=0.0))
    ada = slots(loop.adafactor(0.0))
    size = lambda tree: sum(math.prod(s) for slot in tree.values() for s in slot.values())  # noqa: E731
    assert size(lion) * 2 == size(adamw)
    up = "blocks.0.ff.up.weight"              # (256, 128): both dims factored
    assert ada[up] == {"v_row": (128,), "v_col": (256,)}
    assert ada["blocks.0.attn.query.weight"] == {"v_row": (128,), "v_col": (128,)}
    assert ada["pos_embed"] == {"v": (64, 128)}   # 64 < 128: not factored
    assert size(ada) < size(adamw) / 8
    for n, p in model.named_parameters():       # a zero rate moved nothing
        assert torch.equal(p.detach(), snapshot[n]), n


def _poison_loss_jax(y, b):
    poisoned = jnp.sum(b["poison"]) > 0
    return jax_tf.next_token_loss(y, b) * jnp.where(poisoned, jnp.float32(jnp.nan),
                                                   jnp.float32(1.0))


def _poison_loss(y, b):
    poisoned = b["poison"].sum() > 0
    return next_token_loss(y, b) * torch.where(poisoned, torch.tensor(float("nan")),
                                               torch.tensor(1.0))


def _adam_slots(opt_state):
    adam = opt_state[0]
    return adam.mu, adam.nu


def test_skip_guard_matches_jax():
    """Clean, poisoned, clean: the guarded step against JAX's on a (1, 1)
    mesh under a warmup schedule. The poisoned step leaves parameters and
    moments bit-equal and AdamW's count unmoved; the step after it matches
    JAX's parameters and moments (atol 1e-6), which it would not if the
    bias correction or the schedule had counted the skipped step."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CONFIG_TINY.vocab_size, (8, 17)).astype(np.int32)
    clean = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:],
             "poison": np.zeros((8, 1), np.float32)}
    batches = [clean, {**clean, "poison": np.ones((8, 1), np.float32)}, clean]
    sched = optax.linear_schedule(0.0, 3e-3, 4)
    mesh = _mesh11()
    sh = mesh_sharding(mesh, "data", None)
    with jax.default_matmul_precision("float32"):
        jbatch = {k: put(v, sh) for k, v in clean.items()}
        jstate, state_sh = jax_pipeline.sharded_train_state(
            jax_tf.Transformer(jax_tf.CONFIG_TINY), optax.adamw(sched), jbatch["inputs"],
            {"params": jax.random.key(0)}, mesh, JAX_RULES)
        jstep = jax_pipeline.make_train_step(
            state_sh, {k: sh for k in clean}, mesh, JAX_RULES, loss_fn=_poison_loss_jax,
            donate_state=False, skip_nonfinite=True)
        jax_states = []
        for b in batches:
            jstate, _ = jstep(jstate, {k: put(v, sh) for k, v in b.items()})
            jax_states.append(jstate)

    model = _model()
    state = pipeline.sharded_train_state(model, loop.adamw(loop._linear(0.0, 3e-3, 4)))
    step = pipeline.make_train_step(loss_fn=_poison_loss, skip_nonfinite=True)
    snaps = []
    for b in batches:
        state, out = step(state, {k: torch.from_numpy(v.copy()) for k, v in b.items()})
        snaps.append(({n: p.detach().clone() for n, p in model.named_parameters()},
                      {n: {k: v.clone() for k, v in state.optimizer.state[p].items()}
                       for n, p in model.named_parameters()}, state.step, state.updates, out))
    assert set(snaps[1][4]) == {"loss", "grad_norm"}
    assert not math.isfinite(float(snaps[1][4]["loss"]))
    assert snaps[1][2:4] == (2, 1) and snaps[2][2:4] == (3, 2)
    for n in snaps[0][0]:
        assert torch.equal(snaps[1][0][n], snaps[0][0][n]), n
        for k, v in snaps[0][1][n].items():
            assert torch.equal(snaps[1][1][n][k], v), (n, k)
    assert int(jax_states[1].step) == 2
    for (params, slots, *_), js in zip(snaps, jax_states):
        mu, nu = (from_flax_params(jax.tree.map(np.asarray, t), CONFIG_TINY)
                  for t in _adam_slots(js.opt_state))
        want = from_flax_params(jax.tree.map(np.asarray, js.params), CONFIG_TINY)
        for n, v in want.items():
            np.testing.assert_allclose(params[n].numpy(), v.numpy(), atol=ADAMW_ATOL,
                                       err_msg=n)
            np.testing.assert_allclose(slots[n]["exp_avg"].numpy(), mu[n].numpy(),
                                       atol=ADAMW_ATOL, err_msg=n)
            np.testing.assert_allclose(slots[n]["exp_avg_sq"].numpy(), nu[n].numpy(),
                                       atol=ADAMW_ATOL, err_msg=n)
        assert float(slots[n]["step"]) == int(js.opt_state[0].count)


def _cyclic():
    return CyclicLMDataset(CONFIG_TINY.vocab_size, S, seed=11)


def _fit(cfg_fields, **kw):
    return loop.fit(_model(), _cyclic(), None, None, _cfg(cfg_fields), **kw)


BASE = dict(steps=6, learning_rate=3e-3)


def test_resume_is_exact_and_noop_when_done(tmp_path):
    full_state, full = _fit(BASE)
    ckpt = dict(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1)
    _fit({**BASE, "steps": 3, **ckpt})
    state, resumed = _fit({**BASE, **ckpt})
    assert [h["step"] for h in resumed] == [4, 5, 6]
    np.testing.assert_allclose([h["loss"] for h in resumed], [h["loss"] for h in full[3:]],
                               rtol=1e-6)
    assert state.step == 6
    for (n, p), q in zip(state.model.named_parameters(), full_state.model.parameters()):
        assert torch.equal(p, q), n              # bit-equal, not only close
    again, hist = _fit({**BASE, **ckpt})
    assert hist == [] and again.step == 6


def test_prefetch_is_bit_equal():
    off = [h["loss"] for h in _fit({**BASE, "prefetch": 0})[1]]
    on = [h["loss"] for h in _fit({**BASE, "prefetch": 3})[1]]
    assert on == off


def test_loader_places_batches():
    loader = ShardedBatchLoader(_cyclic(), None, 8, device="cpu")
    batch = loader.batch_at(4)
    np.testing.assert_array_equal(batch["inputs"].numpy(), _cyclic().batch(4)["inputs"])
    with loader.prefetched(2, start=4) as it:
        assert torch.equal(next(it)["targets"], batch["targets"])
    it = loader.prefetched(2)
    it.close()                                   # never iterated: still stops
    assert not it._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(it)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedBatchLoader(_cyclic(), None, 8)


def test_fit_telemetry_reconciles():
    reg, tracer, led, rec = MetricsRegistry(), Tracer(), GoodputLedger(), FlightRecorder()
    state, hist = _fit(BASE, registry=reg, tracer=tracer, ledger=led, recorder=rec,
                       watchdog=Watchdog(), heartbeat=Heartbeat(timeout=30.0))
    assert led.reconcile()["ok"]
    assert led.device_families()["train_step"]["calls"] == 6
    assert reg.get("train_steps_total").value == 6
    assert reg.get("watchdog_probes_total").value == 6
    assert [e["step"] for e in rec.events("train_step")] == list(range(1, 7))
    assert {e["name"] for e in rec.events("span")} >= {"fit.setup", "train_step"}
    assert all("grad_norm" not in h for h in hist)


def _poison_batch(b):
    return {**b, "inputs": torch.full_like(b["inputs"], CONFIG_TINY.vocab_size - 1)}


def _poison_row_loss(y, b):
    poisoned = (b["inputs"][0] == CONFIG_TINY.vocab_size - 1).all()
    return next_token_loss(y, b) * torch.where(poisoned, torch.tensor(float("nan")),
                                               torch.tensor(1.0))


def test_fit_skips_a_poisoned_step():
    rec, reg, led = FlightRecorder(), MetricsRegistry(), GoodputLedger()
    with ChaosInjector(Fault("train.batch", "mutate", at=2, mutate=_poison_batch),
                       recorder=rec):
        state, hist = _fit({**BASE, "steps": 5}, loss_fn=_poison_row_loss,
                           resilience=ResilienceConfig(), recorder=rec, registry=reg,
                           ledger=led)
    assert (state.step, state.updates) == (5, 4)
    assert [e["step"] for e in rec.events("step_skipped")] == [3]
    assert reg.get("train_nonfinite_skips_total").value == 1
    assert math.isnan(hist[2]["loss"]) and np.isfinite(hist[-1]["loss"])
    assert led.reconcile()["ok"] and led.window_buckets()["recovery"] > 0


def test_fit_spike_rolls_back_and_replays(tmp_path):
    rec = FlightRecorder()
    _, ref = _fit(BASE)
    res = ResilienceConfig(rollback_on_spike=True, spike_min_steps=2, max_rollbacks=1)
    with ChaosInjector(Fault("train.loss", "mutate", at=3, mutate=lambda x: x * 1e3),
                       recorder=rec):
        _, hist = _fit({**BASE, "checkpoint_dir": str(tmp_path), "checkpoint_every": 1},
                       resilience=res, recorder=rec)
    assert len(rec.events("loss_spike_rollback")) == 1
    assert hist[-1]["loss"] == ref[-1]["loss"]


def test_fit_sigterm_saves_and_resumes(tmp_path):
    rec = FlightRecorder()
    _, full = _fit(BASE)
    c = {**BASE, "checkpoint_dir": str(tmp_path), "checkpoint_every": 100}
    with pytest.raises(PreemptionError) as err:
        with ChaosInjector(Fault("train.step", "sigterm", at=3), recorder=rec):
            _fit(c, resilience=ResilienceConfig(), recorder=rec)
    assert rec.events("emergency_checkpoint")
    _, resumed = _fit(c, resilience=ResilienceConfig(), recorder=rec)
    assert [h["loss"] for h in resumed] == [h["loss"] for h in full[err.value.step:]]


def test_fit_watchdog_escalates_and_localizes(tmp_path):
    rec = FlightRecorder()
    with ChaosInjector(Fault("train.batch", "mutate", at=1, mutate=_poison_batch),
                       recorder=rec):
        with pytest.raises(NonFiniteError) as err:
            _fit(BASE, loss_fn=_poison_row_loss, watchdog=Watchdog(lag=0), recorder=rec)
    assert err.value.step == 2 and err.value.localized
    assert "non-finite" in err.value.localized
    assert rec.events("nan_localized")[0]["step"] == 2


def test_fit_failures_and_options():
    class Boom:
        def batch(self, index, rows=None, batch_size=8):
            raise RuntimeError("boom")

    hb = Heartbeat(timeout=5.0)
    with pytest.raises(RuntimeError, match="boom"):
        loop.fit(_model(), Boom(), None, None, _cfg(dict(steps=1), prefetch=0), heartbeat=hb)
    assert not hb.running
    with pytest.raises(NotImplementedError, match="slice G"):
        _fit(BASE, contract="golden.json")
    with pytest.raises(ValueError, match="unknown optimizer"):
        loop.default_optimizer(_cfg(dict(steps=1), optimizer="sgd"))
    with pytest.raises(ValueError, match="at least one batch"):
        loop.evaluate(None, _cyclic(), None, None, batch_size=8, num_batches=0)


def test_fit_over_mesh_equals_one_device(tmp_path):
    """Four steps of ``fit`` over a (2, 2) mesh of thread ranks under
    RULES_DP_TP (the batch split over the data axis by the loader): losses
    within rtol 1e-6 of one device's; its checkpoint, saved shard by shard,
    restored on one device bit-equal to the mesh's final parameters and
    moments."""
    sd = {k: v.numpy() for k, v in from_flax_params(_jax_init(id(CONFIG_TINY)),
                                                     CONFIG_TINY).items()}
    fields = dict(BASE, steps=4)
    got = run_on_threads(bodies.fit_body, (2, 2), ("data", "model"),
                         args=(sd, _cyclic(), fields, str(tmp_path)))
    _, one = _fit(fields)
    np.testing.assert_allclose(got["losses"], [h["loss"] for h in one], rtol=1e-6)
    state = pipeline.sharded_train_state(Transformer(CONFIG_TINY, device="cpu", seed=5),
                                         loop.default_optimizer(_cfg(fields)))
    with CheckpointManager(tmp_path) as ckpt:
        assert ckpt.all_steps() == [4]
        ckpt.restore_latest(like=state)
    assert (state.step, state.updates) == (4, 4)
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), got["params"][n], err_msg=n)
        np.testing.assert_array_equal(state.optimizer.state[p]["exp_avg"].numpy(),
                                      got["exp_avg"][n], err_msg=n)


def _partial_grad_body(mesh):
    """A lookup in a vocabulary-split table, reduced to replicated, then a
    product with a column-split matrix: the product's gradient reaches the
    lookup as a partial sum. Returns the two gradients, whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from learning_jax_sharding_tpu_torch.parallel.logical import reduce_partial_grad

    table, w = _partial_grad_inputs()
    table = torch.nn.Parameter(distribute_tensor(table, mesh, [Shard(0)]))
    w = torch.nn.Parameter(distribute_tensor(w, mesh, [Shard(1)]))
    tokens = DTensor.from_local(torch.tensor([[1, 9, 3, 14]]), mesh, [Replicate()],
                                run_check=False)
    x = torch.nn.functional.embedding(tokens, table).redistribute(mesh, [Replicate()])
    ((reduce_partial_grad(x) @ w) ** 2).sum().backward()
    return table.grad.full_tensor(), w.grad.full_tensor()


def _partial_grad_inputs():
    rng = np.random.default_rng(3)
    return (torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)))


def test_a_partial_gradient_reaches_a_vocabulary_split_lookup():
    """``parallel.logical.reduce_partial_grad``, which the model puts after
    its token lookup: without it DTensor refuses to turn the partial-sum
    gradient into the lookup's masked partial. The gradients equal one
    device's (atol 1e-5: another order of summation)."""
    got_table, got_w = run_on_threads(_partial_grad_body, (2,), ("model",))
    table, w = (t.requires_grad_() for t in _partial_grad_inputs())
    ((torch.nn.functional.embedding(torch.tensor([[1, 9, 3, 14]]), table) @ w) ** 2).sum().backward()
    np.testing.assert_allclose(got_table.numpy(), table.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), w.grad.numpy(), atol=1e-5)
