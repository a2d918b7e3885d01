"""The port's ``master_weights`` against the JAX package's.

``CONFIG_TINY`` with bf16 parameters (fp32 compute). JAX trains three
steps under ``master_weights(optax.adamw(3e-4))`` and records each step's
gradients; the port's optimizer takes the same three gradient sets
(``tests/_torch_train_oracles.py`` says why) from the same init. The bf16
parameters after them equal JAX's bit for bit and the fp32 masters lie
within 1e-6. The port's own train step under the wrapper gives JAX's first
loss and learns; its gradients lie within a bf16 ulp of JAX's; the landing is JAX's delta arithmetic (``p +
(m.to(p.dtype) − p)``), held against a plain copy of the rounded master
where the two differ; a step the non-finite guard skips leaves the masters
as they were; JAX's masters carry across into the port's optimizer.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learning_jax_sharding_tpu.training.precision import master_weights as jax_master_weights
from learning_jax_sharding_tpu_torch.models.convert import (
    from_flax_params,
    load_optimizer_slot_,
)
from learning_jax_sharding_tpu_torch.models.transformer import Transformer, next_token_loss
from learning_jax_sharding_tpu_torch.training import loop, pipeline, precision
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


@pytest.fixture(scope="module")
def jax_run():
    run = jax_gradient_stream(jax_master_weights(optax.adamw(LR)), STEPS)
    run["master"] = as_f32(run["opt_state"].master)
    return run


def _port_state(init, optimizer):
    model = Transformer(CFG, device="cpu")
    model.load_state_dict(from_flax_params(init, CFG))
    return pipeline.sharded_train_state(model, optimizer)


@pytest.fixture(scope="module")
def port_run(jax_run):
    state = _port_state(jax_run["init"], precision.master_weights(loop.adamw(LR)))
    for grads in jax_run["grads"]:
        step_on(state, grads)
    return state


def test_params_are_bf16_and_masters_fp32(port_run):
    state = port_run
    opt = state.optimizer
    for p in state.model.parameters():
        assert p.dtype == torch.bfloat16
        assert opt.state[p]["master"].dtype == torch.float32
        assert set(opt.state[p]) == {"master", "exp_avg", "exp_avg_sq", "step"}


def test_train_step_gives_jax_first_loss_and_learns(jax_run):
    """The port's own train step under the wrapper: step 0's loss is JAX's
    (same init) and the loss falls."""
    state = _port_state(jax_run["init"], precision.master_weights(loop.adamw(LR)))
    step = pipeline.make_train_step(loss_fn=next_token_loss, steps_per_call=STEPS)
    batch = {k: v.expand(STEPS, *v.shape) for k, v in port_batch().items()}
    _, losses = step(state, batch)
    np.testing.assert_allclose(float(losses[0]), jax_run["losses"][0], rtol=1e-5)
    assert losses[-1] < losses[0]


def test_bf16_gradients_within_a_bf16_ulp_of_jax(jax_run):
    """The port's own backward on bf16 parameters: each gradient within one
    bf16 ulp (2^-8 of its largest magnitude) of JAX's. The embedding table
    is gathered upcast, as Flax's ``promote_dtype`` does, so a token's
    repeated rows sum in fp32 and round once (gathered in bf16 they summed
    in bf16: 0.000488 apart on ``tok_embed``, ~17 ulps)."""
    state = _port_state(jax_run["init"], precision.master_weights(loop.adamw(LR)))
    batch = port_batch()
    next_token_loss(state.model(batch["inputs"]), batch).backward()
    for name, p in state.model.named_parameters():
        want = jax_run["grads"][0][name].float()
        np.testing.assert_allclose(p.grad.float().numpy(), want.numpy(), rtol=0,
                                   atol=float(want.abs().max()) * 2.0**-8, err_msg=name)


def test_bf16_params_equal_jax_bit_for_bit(port_run, jax_run):
    state = port_run
    want = from_flax_params(jax_run["params"], CFG)
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().float().numpy(), want[name].numpy(),
                                      err_msg=name)


def test_masters_within_1e6_of_jax(port_run, jax_run):
    state = port_run
    want = from_flax_params(jax_run["master"], CFG)
    got = state.optimizer.as_state().master           # MasterWeightsState, by name
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_landing_is_jax_delta_arithmetic_not_a_copy():
    """``p + (m.to(bf16) − p)`` in bf16 against JAX's same arithmetic: equal
    bit for bit; against a plain copy of the rounded master: different
    where the delta is not exact in bf16 (a master far from its
    parameter), equal between neighbours."""
    rng = np.random.default_rng(3)
    p32 = rng.standard_normal(4096).astype(np.float32)
    m32 = np.concatenate([p32[:2048] + 1e-3 * rng.standard_normal(2048).astype(np.float32),
                          1e-3 * rng.standard_normal(2048).astype(np.float32)])
    p = torch.from_numpy(p32).to(torch.bfloat16)
    m = torch.from_numpy(m32)
    landed = p.clone()
    precision.land(landed, m)
    jp = jnp.asarray(p32).astype(jnp.bfloat16)
    want = np.asarray((jp + (jnp.asarray(m32).astype(jnp.bfloat16) - jp)).astype(jnp.float32))
    np.testing.assert_array_equal(landed.float().numpy(), want)
    copy = m.to(torch.bfloat16)
    assert torch.equal(landed[:2048], copy[:2048])
    assert not torch.equal(landed[2048:], copy[2048:])


def test_skipped_step_keeps_masters(jax_run):
    """A non-finite loss: the guard skips the update, and the parameters,
    masters and moments stay as they were."""
    state = _port_state(jax_run["init"], precision.master_weights(loop.adamw(LR)))
    step = pipeline.make_train_step(loss_fn=next_token_loss, skip_nonfinite=True)
    step(state, port_batch())
    opt = state.optimizer
    before = {p: {k: v.clone() for k, v in opt.state[p].items()} for p in state.model.parameters()}
    params = [p.detach().clone() for p in state.model.parameters()]
    poisoned = pipeline.make_train_step(loss_fn=lambda y, b: next_token_loss(y, b) * float("nan"),
                                        skip_nonfinite=True)
    _, out = poisoned(state, port_batch())
    assert not torch.isfinite(out["loss"])
    assert state.updates == 1 and state.step == 2
    for p, old in zip(state.model.parameters(), params):
        assert torch.equal(p.detach(), old)
        for k, v in before[p].items():
            assert torch.equal(opt.state[p][k], v), k


def test_jax_masters_carry_across(jax_run):
    """``load_optimizer_slot_`` writes JAX's masters into the port's
    optimizer (before any step: a resume from a JAX state)."""
    state = _port_state(jax_run["init"], precision.master_weights(loop.adamw(LR)))
    want = from_flax_params(jax_run["master"], CFG)
    load_optimizer_slot_(state.optimizer, state.model, "master", want)
    for name, p in state.model.named_parameters():
        assert torch.equal(state.optimizer.slot_tensor(p, "master"), want[name])
