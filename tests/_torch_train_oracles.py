"""JAX oracles the port's optimizer-wrapper tests share.

:func:`jax_gradient_stream` trains ``CONFIG_TINY`` with bf16 parameters in
JAX under a given optax transformation and records each step's gradients
(bf16, as JAX's ``value_and_grad`` gives them for bf16 parameters), so the
port's optimizer can take the very same gradients: the two packages'
backward passes differ by a bf16 ulp here and there, and Adam's first steps
turn a gradient's last bit into a whole learning-rate step, so the
optimizers are held to each other on one gradient stream.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY

B, S, LR = 4, 32, 3e-4
JAX_BF16 = dataclasses.replace(jax_tf.CONFIG_TINY, param_dtype=jnp.bfloat16)
BF16 = dataclasses.replace(CONFIG_TINY, param_dtype=torch.bfloat16)


def tokens(seed=0):
    return np.random.default_rng(seed).integers(0, BF16.vocab_size, (B, S + 1)).astype(np.int32)


def as_f32(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)), tree)


def jax_gradient_stream(tx: optax.GradientTransformation, steps: int) -> dict:
    """``steps`` updates of ``tx`` on one fixed batch: ``init`` (numpy
    tree), the losses, each step's gradients (port state dicts, bf16), the
    final optimizer state (``opt_state``) and params (fp32 numpy trees)."""
    model = jax_tf.Transformer(JAX_BF16)
    t = tokens()
    batch = {"inputs": jnp.asarray(t[:, :-1]), "targets": jnp.asarray(t[:, 1:])}
    params = nn.meta.unbox(model.init(jax.random.key(0), batch["inputs"])["params"])
    init = jax.tree.map(np.asarray, params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jax_tf.next_token_loss(model.apply({"params": p}, batch["inputs"]), batch)))
    update = jax.jit(tx.update)
    opt_state = tx.init(params)
    losses, grads = [], []
    for _ in range(steps):
        loss, g = grad_fn(params)
        losses.append(float(loss))
        grads.append({n: v.to(torch.bfloat16)
                      for n, v in from_flax_params(as_f32(g), BF16).items()})
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    return dict(init=init, losses=losses, grads=grads, opt_state=opt_state,
                params=as_f32(params))


def port_batch():
    t = torch.from_numpy(tokens()).long()
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}


def step_on(state, grads) -> None:
    """One update of ``state``'s optimizer on the given gradients."""
    for name, p in state.model.named_parameters():
        p.grad = grads[name].clone()
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
