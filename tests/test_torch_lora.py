"""The port's LoRA against the JAX package's.

``CONFIG_TINY`` (fp32): JAX builds its adapters (``lora_train_state``, rank
4, over the base from ``sharded_train_state`` on a (1, 1) mesh) and trains
them three steps under ``optax.adamw(3e-3)``; the port carries the same
base and the same initial adapters across (``from_flax_params``,
``adapters_from_flax``) and trains them too. The adapted paths are JAX's;
the merge at init is the base bit for bit; the base stays bit-unchanged
while the losses follow JAX's (rtol 1e-5) and the merged weights JAX's
merge of its own trained adapters (atol 1e-5, rtol 1e-4, the tolerance of
``tests/test_torch_sharded_train.py``); a merge uses the alpha the state
trained with, and its tree generates. Over a (2, 2) mesh of thread ranks
(``RULES_DP_TP``) each adapter's shard shape is that of JAX's
``lora_shardings`` and a step's loss equals the one-device step's.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu.parallel import build_mesh, mesh_sharding, put
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP as JAX_RULES_DP_TP
from learning_jax_sharding_tpu.training import lora as jax_lora
from learning_jax_sharding_tpu.training import pipeline as jax_pipeline
from learning_jax_sharding_tpu_torch.models.convert import adapters_from_flax, from_flax_params
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_TP
from learning_jax_sharding_tpu_torch.training import lora, loop, pipeline
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

B, S, RANK, STEPS, LR = 8, 32, 4, 3, 3e-3


def _tokens():
    return np.random.default_rng(0).integers(0, CONFIG_TINY.vocab_size, (B, S + 1)).astype(
        np.int32)


def _batch():
    t = torch.from_numpy(_tokens()).long()
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_side(mesh):
    tokens = _tokens()
    sh = mesh_sharding(mesh, "data", None)
    batch = {"inputs": put(tokens[:, :-1], sh), "targets": put(tokens[:, 1:], sh)}
    model = jax_tf.Transformer(jax_tf.CONFIG_TINY)
    state, state_sh = jax_pipeline.sharded_train_state(
        model, optax.adamw(LR), batch["inputs"], {"params": jax.random.key(0)}, mesh,
        JAX_RULES_DP_TP)
    ls = jax_lora.lora_train_state(jax.random.key(1), state.params, optax.adamw(LR), RANK, mesh)
    return model, state, state_sh, ls, batch, sh


@pytest.fixture(scope="module")
def jax_run(mesh22):
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    model, state, state_sh, ls, batch, sh = _jax_side(mesh)
    init_adapters = _np(ls.adapters)
    step = jax_lora.make_lora_train_step(model, state_sh.params, {k: sh for k in batch}, mesh,
                                         JAX_RULES_DP_TP, optax.adamw(LR),
                                         loss_fn=jax_tf.next_token_loss)
    losses = []
    for _ in range(STEPS):
        ls, loss = step(state.params, ls, batch)
        losses.append(float(loss))
    merged = _np(jax_lora.merge_lora(state.params, ls))
    # The shard shapes of each adapter over the (2, 2) mesh.
    _, state22, _, ls22, _, _ = _jax_side(mesh22)
    shardings = jax_lora.lora_shardings(state22.params, ls22.adapters, mesh22)
    shapes = jax.tree.map(lambda s, a: s.shard_shape(a.shape), shardings, ls22.adapters,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    return dict(base=_np(state.params), adapters=init_adapters, losses=losses,
                merged=from_flax_params(merged, CONFIG_TINY), shapes=shapes)


def _base(jax_run):
    model = Transformer(CONFIG_TINY, device="cpu")
    model.load_state_dict(from_flax_params(jax_run["base"], CONFIG_TINY))
    return model, {n: p.detach() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def port_run(jax_run):
    model, base = _base(jax_run)
    before = {n: t.clone() for n, t in base.items()}
    ls = lora.lora_train_state(None, base, loop.adamw(LR), RANK,
                               adapters=adapters_from_flax(jax_run["adapters"], CONFIG_TINY))
    step = lora.make_lora_train_step(model, loop.adamw(LR), loss_fn=next_token_loss)
    losses = []
    for _ in range(STEPS):
        ls, loss = step(base, ls, _batch())
        losses.append(float(loss))
    return dict(model=model, base=base, before=before, ls=ls, losses=losses)


def test_adapted_paths_equal_jax(jax_run):
    _, base = _base(jax_run)
    ours = lora.init_lora(torch.Generator().manual_seed(0), base, RANK)
    theirs = adapters_from_flax(jax_run["adapters"], CONFIG_TINY)
    assert set(ours) == set(theirs) and len(ours) == 6 * CONFIG_TINY.num_layers + 1
    for name, ab in ours.items():
        out_dim, in_dim = base[name].shape
        assert ab["lora_a"].shape == (in_dim, RANK) and ab["lora_b"].shape == (RANK, out_dim)
        assert torch.equal(ab["lora_b"], torch.zeros_like(ab["lora_b"]))
        assert theirs[name]["lora_a"].shape == ab["lora_a"].shape
    assert not any(lora.default_match(n, t) for n, t in base.items()
                   if "embed" in n or "ln_" in n or n.endswith("bias"))


def test_merge_at_init_is_the_base_bit_for_bit(jax_run):
    _, base = _base(jax_run)
    ls = lora.lora_train_state(torch.Generator().manual_seed(0), base, loop.adamw(LR), RANK)
    merged = lora.merge_lora(base, ls)
    assert set(merged) == set(base)
    for name, t in base.items():
        assert torch.equal(merged[name], t), name
    zero = lora.merge_lora(base, lora.zero_lora(ls.adapters))
    assert all(torch.equal(zero[n], t) for n, t in base.items())


def test_base_frozen_and_losses_follow_jax(port_run, jax_run):
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"], rtol=1e-5)
    assert port_run["losses"][-1] < port_run["losses"][0]
    for name, t in port_run["before"].items():
        assert torch.equal(port_run["base"][name], t), name
        assert port_run["model"].get_parameter(name).grad is None, name


def test_merged_weights_equal_jax_merge(port_run, jax_run):
    merged = lora.merge_lora(port_run["base"], port_run["ls"])
    for name, want in jax_run["merged"].items():
        np.testing.assert_allclose(merged[name].detach().numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_merge_uses_the_trained_alpha(port_run):
    base, ls = port_run["base"], port_run["ls"]
    scaled = ls._replace(alpha=8.0)
    got = lora.merge_lora(base, scaled)
    want = lora.merge_lora(base, ls.adapters, alpha=8.0)
    default = lora.merge_lora(base, ls.adapters)
    name = "blocks.0.attn.query.weight"
    assert torch.equal(got[name], want[name])
    assert not torch.equal(got[name], default[name])
    assert torch.equal(lora.merge_lora(base, ls)[name], default[name])     # trained at 16


def test_merged_tree_generates(port_run):
    merged = {n: t.detach() for n, t in lora.merge_lora(port_run["base"], port_run["ls"]).items()}
    model = Transformer(CONFIG_TINY, device="cpu")
    model.load_state_dict(merged)
    gen = make_generate_fn(CONFIG_TINY, max_new_tokens=4, device="cpu")
    prompt = _batch()["inputs"][:2, :8]
    assert torch.equal(gen(merged, prompt), gen(model.state_dict(), prompt))


def _mesh_lora_body(mesh, sd, adapters, batch):
    """Rank body: the base sharded under RULES_DP_TP, the carried adapters
    placed by ``lora_shardings``, one step → (local shapes, loss)."""
    model = Transformer(CONFIG_TINY, device="cpu")
    model.load_state_dict(sd)
    pipeline.sharded_train_state(model, loop.adamw(LR), mesh=mesh, rules=RULES_DP_TP)
    base = {n: p.detach() for n, p in model.named_parameters()}
    ls = lora.lora_train_state(None, base, loop.adamw(LR), RANK, adapters=adapters)
    shapes = {n: {k: tuple(t.to_local().shape) for k, t in ab.items()}
              for n, ab in ls.adapters.items()}
    step = lora.make_lora_train_step(model, loop.adamw(LR), loss_fn=next_token_loss,
                                     mesh=mesh, rules=RULES_DP_TP)
    _, loss = step(base, ls, batch)
    return shapes, float(loss)


def test_placements_inherited_over_the_mesh(jax_run):
    sd = from_flax_params(jax_run["base"], CONFIG_TINY)
    adapters = adapters_from_flax(jax_run["adapters"], CONFIG_TINY)
    shapes, loss = run_on_threads(_mesh_lora_body, (2, 2), ("data", "model"),
                                  args=(sd, adapters, _batch()))
    want = adapters_from_flax(jax.tree.map(lambda s: np.zeros(s, np.float32), jax_run["shapes"],
                                           is_leaf=lambda x: isinstance(x, tuple)), CONFIG_TINY)
    assert shapes == {n: {k: tuple(t.shape) for k, t in ab.items()} for n, ab in want.items()}
    np.testing.assert_allclose(loss, jax_run["losses"][0], rtol=1e-5)
