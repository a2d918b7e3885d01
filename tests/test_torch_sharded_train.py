"""The port's train step over a (2, 4) mesh against the JAX package's.

``CONFIG_TINY`` (b=8, s=32, fp32, the kernels' plain versions) trained on a
(2, 4) ``data`` × ``model`` mesh: the JAX side as one SPMD program on 8
emulated devices, the port as 8 ``gloo`` ranks of one spawn
(``parallel.run_on_mesh``), from the same JAX-initialised weights
(``from_flax_params``), under ``RULES_DP_TP_SP``, ``RULES_FSDP`` and
``RULES_REFERENCE``:

- each parameter's local shard shape equals JAX's (a kernel's transposed);
- the first loss within rtol 1e-5, ten losses within rtol 1e-4;
- the parameters after three ``adamw(3e-4)`` steps within atol 1e-5 and
  rtol 1e-4: Adam's update divides each gradient by its own running norm,
  so where a gradient is near zero the sum order of the mesh's reductions
  (another than XLA's) moves the update by a few percent; every element
  but one stays within 1e-5, the one at 1.05e-5 (of a 0.117 weight, under
  RULES_DP_TP_SP).

Then the kernels' path (flash, fused norm, fused loss) over the mesh against
the same steps on one device, and the flash ``attn_fn`` over the mesh (batch
over data, heads over model):
its output and gradients against JAX's, whose Pallas kernels run in
interpret mode under ``shard_map``, atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu.ops.flash_attention import make_flash_attn_fn as jax_flash_fn
from learning_jax_sharding_tpu.parallel import build_mesh, mesh_sharding, put, shard_shapes
from learning_jax_sharding_tpu.parallel import logical as jax_logical
from learning_jax_sharding_tpu.training import pipeline as jax_pipeline
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from learning_jax_sharding_tpu_torch.parallel import run_on_mesh
from tests import _torch_mesh_bodies as bodies

RULES = ["RULES_DP_TP_SP", "RULES_FSDP", "RULES_REFERENCE"]
B, S, STEPS, SNAPSHOT = 8, 32, 10, 3


@functools.cache
def _mesh():
    return build_mesh((2, 4), ("data", "model"))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, CONFIG_TINY.vocab_size, (B, S + 1)).astype(
        np.int32)


@pytest.fixture(scope="module")
def flash_inputs():
    rng = np.random.default_rng(1)
    return {n: rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
            for n in ("q", "k", "v", "dout")}


@pytest.fixture(scope="module")
def jax_runs(tokens):
    """Per rule set: local shapes (port layout), losses, params after the
    snapshot; and the initial params."""
    mesh = _mesh()
    sh = mesh_sharding(mesh, "data", None)
    batch = {"inputs": put(tokens[:, :-1], sh), "targets": put(tokens[:, 1:], sh)}
    out = {}
    for name in RULES:
        rules = getattr(jax_logical, name)
        state, state_sh = jax_pipeline.sharded_train_state(
            jax_tf.Transformer(jax_tf.CONFIG_TINY), optax.adamw(3e-4), batch["inputs"],
            {"params": jax.random.key(0)}, mesh, rules)
        init = jax.tree.map(np.asarray, state.params)
        local = jax.tree.map(lambda p: np.zeros(shard_shapes(p)[0], np.float32), state.params)
        step = jax_pipeline.make_train_step(
            state_sh, {k: sh for k in batch}, mesh, rules, loss_fn=jax_tf.next_token_loss,
            donate_state=False)
        losses, params = [], None
        for i in range(STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
            if i + 1 == SNAPSHOT:
                params = jax.tree.map(np.asarray, state.params)
        out[name] = dict(
            init=init, losses=losses, params=from_flax_params(params, CONFIG_TINY),
            shapes={n: tuple(t.shape) for n, t in from_flax_params(local, CONFIG_TINY).items()})
    return out


@pytest.fixture(scope="module")
def jax_flash(flash_inputs):
    mesh = _mesh()
    fn = jax_flash_fn(mesh, jax_logical.RULES_DP_TP_SP, interpret=True, block_q=16,
                      block_k=16)
    q, k, v, dout = (jnp.asarray(flash_inputs[n]) for n in ("q", "k", "v", "dout"))
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal=True), q, k, v)
    return [np.asarray(t) for t in (out, *vjp(dout))]


@pytest.fixture(scope="module")
def port(jax_runs, tokens, flash_inputs):
    sd = {k: t.numpy() for k, t in
          from_flax_params(jax_runs[RULES[0]]["init"], CONFIG_TINY).items()}
    batch = {"inputs": tokens[:, :-1].astype(np.int64), "targets": tokens[:, 1:].astype(np.int64)}
    return run_on_mesh(bodies.train_body, (2, 4), ("data", "model"),
                       args=(sd, batch, RULES, STEPS, SNAPSHOT, flash_inputs))


def test_one_init_for_every_rule_set(jax_runs):
    first = jax_runs[RULES[0]]["init"]
    for name in RULES[1:]:
        jax.tree.map(np.testing.assert_array_equal, jax_runs[name]["init"], first)


@pytest.mark.parametrize("rules", RULES)
def test_shard_shapes_equal_jax(rules, port, jax_runs):
    assert port[rules]["shapes"] == jax_runs[rules]["shapes"]


@pytest.mark.parametrize("rules", RULES)
def test_losses_equal_jax(rules, port, jax_runs):
    got, want = port[rules]["losses"], jax_runs[rules]["losses"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("rules", RULES)
def test_params_after_three_steps_equal_jax(rules, port, jax_runs):
    got, want = port[rules]["params"], jax_runs[rules]["params"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_kernel_path_over_the_mesh_equals_one_device(port):
    """Flash, the fused norm and the fused loss, each on its shards (the
    norm's gamma/beta gradients partial sums over the rows' shards),
    under RULES_DP_TP_SP: four steps' losses equal to the same steps on one
    device within rtol 1e-5."""
    got = port["kernel_path"]
    np.testing.assert_allclose(got["mesh"], got["one"], rtol=1e-5)


def test_flash_attn_fn_over_the_mesh_equals_jax(port, jax_flash):
    got = port["flash"]
    # Batch over data, heads over model: the kernels ran on (1, 32, 1, 16) shards.
    assert got["placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
    for name, want in zip(("out", "dq", "dk", "dv"), jax_flash):
        np.testing.assert_allclose(got[name], want, atol=1e-5, err_msg=name)
