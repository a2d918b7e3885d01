"""The port's ZeRO-1 against the JAX package's, on a (2, 2) mesh.

``CONFIG_TINY`` (fp32) on a ``data`` × ``model`` (2, 2) mesh under
``RULES_DP_TP``: JAX's state from ``sharded_train_state(...,
zero1_axis="data")`` under ``with_ema(master_weights(optax.adamw(3e-4)))``
on 4 emulated devices, and the port's on four thread ranks
(``parallel.run_on_threads``), from the same JAX init. The shard shape of
every optimizer-state leaf (each moment, master and EMA) equals JAX's, and
so do those of ``zero1_shardings``' rule on a scalar, a leaf already over
data, an indivisible leaf and a model-split one; the losses of three steps
lie within rtol 1e-5 of JAX's and the parameters after them within atol
1e-5, rtol 1e-4 (``tests/test_torch_sharded_train.py`` says why), and each
rank holds half the replicated state's bytes. Then on the port alone, on a
(2, 1) data mesh of two thread ranks (half the collectives' meetings):
``make_zero1_update`` equals the fused ZeRO-1 step and composes with bf16
parameters under ``master_weights``; a batch the data axis does not divide
and ``quantized_comm=True`` raise; a DCP checkpoint of the
``with_ema(master_weights(adamw))`` ZeRO-1 state resumes bit-equal.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu.parallel import mesh_sharding, put, shard_shapes
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP as JAX_RULES_DP_TP
from learning_jax_sharding_tpu.training import pipeline as jax_pipeline
from learning_jax_sharding_tpu.training.ema import with_ema as jax_with_ema
from learning_jax_sharding_tpu.training.precision import master_weights as jax_master_weights
from learning_jax_sharding_tpu.training.zero import zero1_shardings as jax_zero1_shardings
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_TP
from learning_jax_sharding_tpu_torch.training import ema, loop, pipeline, precision, zero
from learning_jax_sharding_tpu_torch.training.checkpoint import CheckpointManager
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

B, S, STEPS, LR = 8, 32, 3, 3e-4
SLOTS = ("exp_avg", "exp_avg_sq", "master", "ema")
# name → (shape, JAX spec): the rule's cases beyond the model's leaves.
LEAVES = {
    "scalar": ((), PartitionSpec()),
    "over_data": ((4, 6), PartitionSpec("data", None)),
    "indivisible": ((3, 5), PartitionSpec()),
    "model_split": ((8, 6), PartitionSpec("model", None)),
    "model_split_short": ((6, 8), PartitionSpec("model", None)),
}


def _tokens():
    return np.random.default_rng(0).integers(0, CONFIG_TINY.vocab_size, (B, S + 1)).astype(
        np.int32)


def _jax_wrapped():
    return jax_with_ema(jax_master_weights(optax.adamw(LR)))


def _port_shapes(tree):
    """Local shard shapes of a JAX params-shaped tree, in the port's layout."""
    local = jax.tree.map(lambda x: np.zeros(shard_shapes(x)[0], np.float32), tree)
    return {n: tuple(t.shape) for n, t in from_flax_params(local, CONFIG_TINY).items()}


@pytest.fixture(scope="module")
def jax_run(mesh22):
    tokens = _tokens()
    sh = mesh_sharding(mesh22, "data", None)
    batch = {"inputs": put(tokens[:, :-1], sh), "targets": put(tokens[:, 1:], sh)}
    state, state_sh = jax_pipeline.sharded_train_state(
        jax_tf.Transformer(jax_tf.CONFIG_TINY), _jax_wrapped(), batch["inputs"],
        {"params": jax.random.key(0)}, mesh22, JAX_RULES_DP_TP, zero1_axis="data")
    init = jax.tree.map(np.asarray, state.params)
    adam = state.opt_state.inner.inner[0]
    shapes = {"exp_avg": _port_shapes(adam.mu), "exp_avg_sq": _port_shapes(adam.nu),
              "master": _port_shapes(state.opt_state.inner.master),
              "ema": _port_shapes(state.opt_state.ema), "count": shard_shapes(adam.count)[0]}
    step = jax_pipeline.make_train_step(state_sh, {k: sh for k in batch}, mesh22,
                                        JAX_RULES_DP_TP, loss_fn=jax_tf.next_token_loss,
                                        donate_state=False)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    leaves = {}
    for name, (shape, spec) in LEAVES.items():
        dtype = jnp.float32
        out = jax_zero1_shardings(jax.ShapeDtypeStruct(shape, dtype),
                                  NamedSharding(mesh22, spec), mesh22, "data")
        leaves[name] = out.shard_shape(shape)
    return dict(init=init, shapes=shapes, losses=losses, leaves=leaves,
                params=from_flax_params(jax.tree.map(np.asarray, state.params), CONFIG_TINY))


def _local(shape, placements, mesh):
    shape = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            shape[pl.dim] //= mesh.size(i)
    return tuple(shape)


def _fulls(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _zero1_body(mesh, sd, tokens):
    """Rank body: the numbers held against JAX's, on the (2, 2) mesh."""
    batch = {"inputs": torch.from_numpy(tokens[:, :-1]).long(),
             "targets": torch.from_numpy(tokens[:, 1:]).long()}

    def state_of(optimizer, cfg=CONFIG_TINY, seed=0, zero1="data", load=True):
        model = Transformer(cfg, device="cpu", seed=seed)
        if load:
            model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return pipeline.sharded_train_state(model, optimizer, mesh=mesh, rules=RULES_DP_TP,
                                            zero1_axis=zero1)

    def wrapped():
        return ema.with_ema(precision.master_weights(loop.adamw(LR)))

    fused = pipeline.make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=RULES_DP_TP)
    out = {}
    # The ZeRO-1 state against JAX's.
    state = state_of(wrapped())
    out["losses"] = [float(fused(state, batch)[1]) for _ in range(STEPS)]
    named = list(state.model.named_parameters())
    out["params"] = {n: _fulls(p.detach()) for n, p in named}
    out["shapes"] = {slot: {n: tuple(state.optimizer.state[p][slot].to_local().shape)
                            for n, p in named} for slot in SLOTS}
    out["count"] = tuple(state.optimizer.state[named[0][1]]["step"].shape)
    out["bytes"] = zero.state_bytes(state.optimizer)
    out["count_bytes"] = sum(state.optimizer.state[p]["step"].element_size() for _, p in named)
    replicated = state_of(wrapped(), zero1=None)
    fused(replicated, batch)
    out["bytes_replicated"] = zero.state_bytes(replicated.optimizer)
    out["leaves"] = {name: _local(shape, zero.zero1_placements(
        shape, torch.float32, _spec_placements(spec, mesh), mesh, "data"), mesh)
        for name, (shape, spec) in LEAVES.items()}
    return out


def _zero1_data_body(mesh, sd, tokens, ckpt_dir):
    """Rank body: the port-only checks, on a (2, 1) data mesh."""
    batch = {"inputs": torch.from_numpy(tokens[:, :-1]).long(),
             "targets": torch.from_numpy(tokens[:, 1:]).long()}

    def state_of(optimizer, cfg=CONFIG_TINY, seed=0, load=True):
        model = Transformer(cfg, device="cpu", seed=seed)
        if load:
            model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return pipeline.sharded_train_state(model, optimizer, mesh=mesh, rules=RULES_DP_TP,
                                            zero1_axis="data")

    def wrapped():
        return ema.with_ema(precision.master_weights(loop.adamw(LR)))

    fused = pipeline.make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=RULES_DP_TP)
    out = {}
    # make_zero1_update against the fused ZeRO-1 step.
    update = zero.make_zero1_update(loss_fn=next_token_loss, mesh=mesh, rules=RULES_DP_TP)
    runs = {}
    for name, fn in (("fused", fused), ("explicit", update)):
        s = state_of(loop.adamw(3e-3))
        runs[name] = ([float(fn(s, batch)[1]) for _ in range(2)],
                      {n: _fulls(p.detach()) for n, p in s.model.named_parameters()})
    out["update"] = runs
    try:
        update(s, {k: v[:7] for k, v in batch.items()})
    except ValueError as exc:
        out["indivisible"] = str(exc)
    # bf16 parameters under master_weights, through make_zero1_update.
    bf16 = dataclasses.replace(CONFIG_TINY, param_dtype=torch.bfloat16)
    s = state_of(precision.master_weights(loop.adamw(3e-3)), cfg=bf16, load=False)
    emb = s.model.tok_embed.weight
    out["bf16"] = dict(
        master=s.optimizer.slot_tensor(emb, "master").to_local().numel(),
        param=emb.to_local().numel(),
        losses=[float(update(s, batch)[1]) for _ in range(3)])
    # A DCP checkpoint of the wrapped ZeRO-1 state resumes bit-equal.
    a = state_of(wrapped())
    fused(a, batch)
    with CheckpointManager(ckpt_dir) as ckpt:
        assert ckpt.save(1, a)
    tail = float(fused(a, batch)[1])
    b = state_of(wrapped(), seed=7, load=False)
    with CheckpointManager(ckpt_dir) as ckpt:
        ckpt.restore_latest(like=b)
    resumed = float(fused(b, batch)[1])
    pairs = list(zip(a.model.named_parameters(), b.model.named_parameters()))
    ema_a, ema_b = ema.ema_params(a), ema.ema_params(b)
    out["resume"] = dict(
        tail=tail, resumed=resumed, step=b.step,
        params=all(torch.equal(_fulls(p), _fulls(q)) for (_, p), (_, q) in pairs),
        slots=all(torch.equal(_fulls(a.optimizer.state[p][k]), _fulls(b.optimizer.state[q][k]))
                  for (_, p), (_, q) in pairs for k in SLOTS),
        ema=all(torch.equal(_fulls(ema_a[n]), _fulls(ema_b[n])) for n in ema_a))
    return out


def _spec_placements(spec, mesh):
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            out[mesh.mesh_dim_names.index(axis)] = Shard(d)
    return tuple(out)


@pytest.fixture(scope="module")
def port(jax_run):
    sd = {k: t.numpy() for k, t in from_flax_params(jax_run["init"], CONFIG_TINY).items()}
    out = run_on_threads(_zero1_body, (2, 2), ("data", "model"), args=(sd, _tokens()))
    with tempfile.TemporaryDirectory() as tmp:
        out.update(run_on_threads(_zero1_data_body, (2, 1), ("data", "model"),
                                  args=(sd, _tokens(), tmp)))
    return out


@pytest.mark.parametrize("slot", SLOTS)
def test_state_shard_shapes_equal_jax(slot, port, jax_run):
    assert port["shapes"][slot] == jax_run["shapes"][slot]


def test_rule_cases_equal_jax(port, jax_run):
    """A scalar count stays whole; a leaf already over data, and one no dim
    of which divides, keep their placement; a model-split dim takes data
    too where their product divides it, else the next dim does."""
    assert port["count"] == () == jax_run["shapes"]["count"]
    assert port["leaves"] == jax_run["leaves"]


def test_losses_and_params_equal_jax(port, jax_run):
    np.testing.assert_allclose(port["losses"][0], jax_run["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(port["losses"], jax_run["losses"], rtol=1e-5)
    for name, want in jax_run["params"].items():
        np.testing.assert_allclose(port["params"][name].numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_each_rank_holds_half_the_state(port):
    """Every slot tensor halves; the scalar step counts stay whole, as
    JAX's count does."""
    counts = port["count_bytes"]
    assert (port["bytes"] - counts) * 2 == port["bytes_replicated"] - counts


def test_make_zero1_update_equals_the_fused_step(port):
    """The same update up to the order of the gradient sums (two slices'
    sums, then their mean), at the parameter tolerance of the JAX check."""
    (fused, fused_params), (explicit, explicit_params) = (
        port["update"][k] for k in ("fused", "explicit"))
    np.testing.assert_allclose(explicit, fused, rtol=1e-5)
    for name, want in fused_params.items():
        np.testing.assert_allclose(explicit_params[name].numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    assert "not divisible by mesh axis 'data' size 2" in port["indivisible"]


def test_make_zero1_update_composes_with_master_weights(port):
    got = port["bf16"]
    assert got["master"] * 2 == got["param"]
    assert got["losses"][-1] < got["losses"][0]


def test_quantized_comm_names_slice_f():
    with pytest.raises(NotImplementedError, match="slice F"):
        zero.make_zero1_update(loss_fn=next_token_loss, mesh=None, rules=RULES_DP_TP,
                               quantized_comm=True)


def test_checkpoint_resumes_bit_equal(port):
    got = port["resume"]
    assert got["step"] == 2              # restored at 1, then one step
    assert got["resumed"] == got["tail"]
    assert got["params"] and got["slots"] and got["ema"]
