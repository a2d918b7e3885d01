"""The port's ``with_ema`` / ``ema_params`` against the JAX package's.

``CONFIG_TINY`` with bf16 parameters under ``with_ema(master_weights(
optax.adamw(3e-4)))``, the composition the card trains: JAX takes three
steps and records its gradients, the port's optimizer takes the same ones
(``tests/_torch_train_oracles.py``). The EMA after them lies within 1e-6
of JAX's, and follows the bf16 parameters the model holds (not the
masters). Training under ``with_ema`` is bit for bit the bare inner
optimizer's; ``ema_params`` gives a tree by parameter name that loads into
the model and generates; the decay is checked and a missing EMA raises.
"""

import numpy as np
import optax
import pytest
import torch

from learning_jax_sharding_tpu.training.ema import with_ema as jax_with_ema
from learning_jax_sharding_tpu.training.precision import master_weights as jax_master_weights
from learning_jax_sharding_tpu_torch.models.convert import (
    from_flax_params,
    load_optimizer_slot_,
)
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.transformer import Transformer, next_token_loss
from learning_jax_sharding_tpu_torch.training import ema, loop, pipeline, precision
from tests._torch_jax import quick_jax_compiles  # noqa: F401
from tests._torch_train_oracles import (
    BF16 as CFG,
    LR,
    as_f32,
    jax_gradient_stream,
    port_batch,
    step_on,
)

torch.set_num_threads(1)

STEPS = 3
DECAY = 0.9          # a fast EMA, so three steps move it well off the init


@pytest.fixture(scope="module")
def jax_run():
    run = jax_gradient_stream(jax_with_ema(jax_master_weights(optax.adamw(LR)), DECAY), STEPS)
    run["ema"] = as_f32(run["opt_state"].ema)
    return run


def _state(init, optimizer):
    model = Transformer(CFG, device="cpu")
    model.load_state_dict(from_flax_params(init, CFG))
    return pipeline.sharded_train_state(model, optimizer)


def _wrapped():
    return ema.with_ema(precision.master_weights(loop.adamw(LR)), DECAY)


@pytest.fixture(scope="module")
def port_run(jax_run):
    state = _state(jax_run["init"], _wrapped())
    for grads in jax_run["grads"]:
        step_on(state, grads)
    return state


def test_ema_within_1e6_of_jax(port_run, jax_run):
    want = from_flax_params(jax_run["ema"], CFG)
    got = ema.ema_params(port_run)
    assert set(got) == set(want)
    assert port_run.optimizer.as_state().ema.keys() == got.keys()   # EmaState, by name
    for name in want:
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_ema_follows_the_bf16_params_not_the_masters(jax_run):
    """Each update averages the parameters the model holds after the inner
    step, in fp32 in JAX's op order: recomputed on the host, bit for bit."""
    state = _state(jax_run["init"], _wrapped())
    opt = state.optimizer
    expect = {n: p.detach().float().clone() for n, p in state.model.named_parameters()}
    for grads in jax_run["grads"]:
        step_on(state, grads)
        for n, p in state.model.named_parameters():
            expect[n] = expect[n] + (1.0 - DECAY) * (p.detach().float() - expect[n])
    for n, p in state.model.named_parameters():
        assert torch.equal(opt.state[p]["ema"], expect[n]), n
        assert not torch.equal(opt.state[p]["ema"], opt.state[p]["master"]), n


def test_training_is_the_bare_inner_optimizers(jax_run):
    """The port's own train step: params and masters under ``with_ema``
    bit-equal to ``master_weights`` alone's."""
    states = [_state(jax_run["init"], opt)
              for opt in (_wrapped(), precision.master_weights(loop.adamw(LR)))]
    step = pipeline.make_train_step(loss_fn=next_token_loss, steps_per_call=2)
    batch = {k: v.expand(2, *v.shape) for k, v in port_batch().items()}
    losses = [step(s, batch)[1] for s in states]
    assert torch.equal(losses[0], losses[1])
    for p, q in zip(states[0].model.parameters(), states[1].model.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(states[0].optimizer.state[p]["master"],
                           states[1].optimizer.state[q]["master"])


def test_ema_params_load_and_generate(port_run):
    """The EMA tree by parameter name: ``load_state_dict`` takes it, and so
    does ``make_generate_fn``, giving the tokens of the loaded model."""
    tree = ema.ema_params(port_run.optimizer)
    model = Transformer(CFG, device="cpu")
    model.load_state_dict(tree)
    prompt = port_batch()["inputs"][:2, :8]
    gen = make_generate_fn(CFG, max_new_tokens=4, device="cpu")
    out = gen(tree, prompt)
    again = gen(model.state_dict(), prompt)
    assert out.shape == (2, 12) and torch.equal(out, again)


def test_decay_checked_and_missing_ema_raises(jax_run):
    for decay in (0.0, 1.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="decay must be in"):
            ema.with_ema(loop.adamw(LR), decay)
    bare = _state(jax_run["init"], precision.master_weights(loop.adamw(LR)))
    with pytest.raises(LookupError):
        ema.ema_params(bare)


def test_jax_ema_carries_across(jax_run):
    state = _state(jax_run["init"], _wrapped())
    want = from_flax_params(jax_run["ema"], CFG)
    load_optimizer_slot_(state.optimizer, state.model, "ema", want)
    got = ema.ema_params(state)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_fit_rollback_restores_masters_and_ema(jax_run):
    """``fit``'s spike rollback (``_snapshot`` / ``_put_back``) on the
    wrapped state: the parameters, masters, moments and EMA come back to the
    snapshot's; a snapshot taken before any update clears the state back to
    what ``create`` made (masters and EMA at the parameters)."""
    state = _state(jax_run["init"], _wrapped())
    opt = state.optimizer
    empty = loop._snapshot(state)
    step_on(state, jax_run["grads"][0])
    snap = loop._snapshot(state)
    want = {p: {k: v.clone() for k, v in opt.state[p].items()} for p in state.model.parameters()}
    params = [p.detach().clone() for p in state.model.parameters()]
    step_on(state, jax_run["grads"][1])
    loop._put_back(state, snap)
    for p, old in zip(state.model.parameters(), params):
        assert torch.equal(p.detach(), old)
        assert set(opt.state[p]) == set(want[p])
        for k, v in want[p].items():
            assert torch.equal(opt.state[p][k], v), k
    loop._put_back(state, empty)
    assert not opt.state
    for p in state.model.parameters():
        assert torch.equal(opt.slot_tensor(p, "master"), p.detach().float())
        assert torch.equal(opt.slot_tensor(p, "ema"), p.detach().float())
