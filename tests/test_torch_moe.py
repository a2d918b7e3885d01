"""The routed MoE feed-forward and its three dispatches against the JAX package's.

The same numpy-seeded inputs and the JAX module's own parameters (router
kernel transposed into ``nn.Linear``, the expert stacks as they are) go
through ``models/moe.py::MoEFeedForward`` of both packages, fp32 on the
CPU, at the JAX tests' bounds (``tests/test_moe.py``): the explicit-mixture
oracle at full capacity, one expert = the plain FF, drops at tiny
capacity, the sown aux loss, the top-k guard, scatter = einsum, the
all-to-all dispatch = the grouped einsum (outputs and gradients, a (2, 2)
mesh of thread ranks) and its guards; ``CONFIG_TINY_MOE`` trained under
``RULES_DP_TP_EP`` (and ``RULES_DP_EP_A2A`` with the all-to-all) against
JAX's step, its remat twin bit-equal, its generate's tokens against JAX's,
and the 3-D quantization byte-equal to JAX's.

Routing near ties: XLA and torch sum the router's products in other
orders, so a top-k choice can flip where two probabilities nearly tie.
:func:`assert_routed_close` requires every token whose choices differ to be
such a tie (and then, the capacity order downstream being another, checks
no further); with no flip, every output within tolerance.
:func:`assign_slots` itself is held bit-equal on JAX's own probabilities.
"""

import dataclasses
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learning_jax_sharding_tpu.models import moe as jax_moe
from learning_jax_sharding_tpu.models import quantize as jax_quantize
from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu.models.generate import make_generate_fn as jax_generate_fn
from learning_jax_sharding_tpu.ops.moe_dispatch import make_moe_a2a_fn as jax_a2a_fn
from learning_jax_sharding_tpu.parallel import build_mesh, mesh_sharding, put
from learning_jax_sharding_tpu.parallel import logical as jax_logical
from learning_jax_sharding_tpu.training import pipeline as jax_pipeline
from learning_jax_sharding_tpu_torch.models import moe
from learning_jax_sharding_tpu_torch.models import quantize as tq
from learning_jax_sharding_tpu_torch.models.convert import (
    from_flax_params,
    param_logical_axes,
    to_flax_params,
)
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY_MOE,
    Transformer,
    TransformerConfig,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops.moe_dispatch import make_moe_a2a_fn
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_EP_A2A, RULES_DP_TP_EP
from learning_jax_sharding_tpu_torch.training.loop import adamw, sgd
from learning_jax_sharding_tpu_torch.training.pipeline import make_train_step, sharded_train_state
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)
B, S, M, H = 2, 16, 8, 32
TIE = 1e-5          # a near tie: the k-th and (k+1)-th probabilities this close
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 32, 3


def _x(seed, b=B, s=S, m=M):
    return np.random.default_rng(seed).standard_normal((b, s, m)).astype(np.float32)


def _jax_module(**kw):
    return jax_moe.MoEFeedForward(**kw)


def _jax_run(mod, x, params=None):
    """(params, output, sown aux, probs) of a JAX MoE module."""
    if params is None:
        params = nn.meta.unbox(mod.init({"params": jax.random.key(0)}, jnp.asarray(x))["params"])
    y, mut = mod.apply({"params": params}, jnp.asarray(x), mutable=("losses",))
    logits = jnp.asarray(x).reshape(-1, x.shape[-1]) @ params["router"]["kernel"]
    return params, np.asarray(y), float(mut["losses"]["load_balancing"]), np.asarray(
        jax.nn.softmax(logits, -1))


def _port_module(params, **kw):
    """A port module carrying the JAX module's parameters."""
    mod = moe.MoEFeedForward(kw.pop("features"), kw.pop("hidden"), device="cpu", **kw)
    with torch.no_grad():
        mod.router.weight.copy_(torch.from_numpy(np.asarray(params["router"]["kernel"]).T))
        mod.up.copy_(torch.from_numpy(np.asarray(params["up"])))
        mod.down.copy_(torch.from_numpy(np.asarray(params["down"])))
    return mod


def _port_run(mod, x):
    with moe.collecting("losses") as aux:
        y = mod(torch.from_numpy(x))
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ mod.router.weight.T, -1)
    return y.detach().numpy(), float(aux[0]), probs.detach().numpy()


def _choices(probs, k):
    """Each token's top-k experts, ties to the lower index (lax.top_k)."""
    order = np.lexsort((np.broadcast_to(np.arange(probs.shape[1]), probs.shape), -probs))
    return np.sort(order[:, :k], axis=1)


def assert_routed_close(got, want, got_probs, want_probs, k, **tol):
    """Outputs within ``tol`` unless a top-k choice flipped; every token
    whose choice differs must be a near tie of its router probabilities."""
    flipped = np.flatnonzero((_choices(got_probs, k) != _choices(want_probs, k)).any(1))
    for t in flipped:
        p = np.sort(want_probs[t])[::-1]
        assert p[k - 1] - p[k] < TIE, f"token {t} flipped without a tie: {p}"
    if flipped.size == 0:
        np.testing.assert_allclose(got.reshape(-1, got.shape[-1]),
                                   want.reshape(-1, want.shape[-1]), **tol)


def _mixture_reference(params, x, top_k):
    """The explicit top-k mixture from the module's parameters (numpy)."""
    wr = np.asarray(params["router"]["kernel"])
    up, down = np.asarray(params["up"]), np.asarray(params["down"])
    xt = x.reshape(-1, x.shape[-1])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt @ wr), axis=-1))
    idx = _choices(probs, top_k)
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        vals = probs[t, idx[t]]
        vals = vals / vals.sum() if top_k > 1 else vals
        for r, e in enumerate(idx[t]):
            h = np.asarray(jax.nn.gelu(jnp.asarray(xt[t] @ up[e])))
            out[t] += vals[r] * (h @ down[e])
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
def test_full_capacity_matches_explicit_mixture(top_k):
    """capacity_factor = E/top_k → C = T: nothing drops, so the routed
    einsum path equals the explicit mixture, and JAX's module."""
    kw = dict(features=M, hidden=H, num_experts=4, top_k=top_k, capacity_factor=4.0 / top_k)
    x = _x(0)
    params, want, _, jprobs = _jax_run(_jax_module(**kw), x)
    got, _, pprobs = _port_run(_port_module(params, **kw), x)
    assert_routed_close(got, want, pprobs, jprobs, top_k, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, _mixture_reference(params, x, top_k), rtol=2e-4, atol=2e-5)


def test_single_expert_is_plain_ff():
    kw = dict(features=M, hidden=H, num_experts=1, top_k=1, capacity_factor=1.0)
    x = _x(0)
    params, want, _, _ = _jax_run(_jax_module(**kw), x)
    got, _, _ = _port_run(_port_module(params, **kw), x)
    up, down = np.asarray(params["up"][0]), np.asarray(params["down"][0])
    xt = x.reshape(-1, M)
    plain = (np.asarray(jax.nn.gelu(jnp.asarray(xt @ up))) @ down).reshape(x.shape)
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_tiny_capacity_drops_tokens():
    """About one slot an expert: most tokens overflow to zero rows, the
    same rows as JAX's."""
    kw = dict(features=M, hidden=H, num_experts=4, top_k=1, capacity_factor=0.05)
    x = _x(0)
    params, want, _, jprobs = _jax_run(_jax_module(**kw), x)
    got, _, pprobs = _port_run(_port_module(params, **kw), x)
    rows = np.linalg.norm(got.reshape(-1, M), axis=-1)
    assert (rows == 0.0).sum() >= rows.size // 2
    assert_routed_close(got, want, pprobs, jprobs, 1, rtol=2e-4, atol=2e-5)


def test_aux_loss_sown_as_jax():
    """Switch eq. 4 on rank-0 choices: the sown value equals JAX's, and
    nothing is sown outside a collecting block."""
    kw = dict(features=M, hidden=H, num_experts=4, top_k=2)
    x = _x(0)
    params, _, want, _ = _jax_run(_jax_module(**kw), x)
    mod = _port_module(params, **kw)
    _, got, _ = _port_run(mod, x)
    assert np.isfinite(got) and got > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with moe.collecting("other") as other:
        mod(torch.from_numpy(x))
    assert other == []


def test_top_k_guard():
    with pytest.raises(ValueError, match="top_k"):
        _jax_module(features=M, hidden=H, num_experts=2, top_k=3).init(
            {"params": jax.random.key(0)}, jnp.asarray(_x(0)))
    with pytest.raises(ValueError, match="top_k"):
        moe.MoEFeedForward(M, H, num_experts=2, top_k=3, device="cpu")(torch.from_numpy(_x(0)))


@pytest.mark.parametrize("top_k,cap", [(1, 1.0), (2, 0.5)])
def test_assign_slots_bit_equal_on_jax_probs(top_k, cap):
    """The slot rule on JAX's own probabilities: every output bit-equal."""
    probs = jax.nn.softmax(jnp.asarray(np.random.default_rng(2).standard_normal((64, 4)),
                                       jnp.float32), -1)
    capacity = max(1, math.ceil(top_k * 64 * cap / 4))
    want = jax_moe.assign_slots(probs, top_k, capacity)
    got = moe.assign_slots(torch.from_numpy(np.asarray(probs)), top_k, capacity)
    for name, g, w in zip(("gate_vals", "gate_idx", "pos", "fits", "masks"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2].dtype == torch.int32
    ids = moe.scatter_slot_ids(*got[2:], got[1], capacity, 4)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jax_moe.scatter_slot_ids(*want[2:], want[1], capacity, 4)))


@pytest.mark.parametrize("top_k,cap", [(1, 1.0), (2, 1.25), (2, 0.5)])
def test_scatter_matches_einsum(top_k, cap):
    """The scatter dispatch: the einsum path's outputs (1e-5), aux (1e-6)
    and gradients (2e-4) under the same parameters, and JAX's scatter."""
    kw = dict(features=32, hidden=64, num_experts=4, top_k=top_k, capacity_factor=cap)
    x = np.random.default_rng(0).normal(size=(2, 16, 32)).astype(np.float32)
    params, want, _, jprobs = _jax_run(_jax_module(dispatch="scatter", **kw), x)
    runs = {}
    for dispatch in ("einsum", "scatter"):
        mod = _port_module(params, dispatch=dispatch, **kw)
        with moe.collecting("losses") as aux:
            out = mod(torch.from_numpy(x))
        torch.sin(out).sum().backward()
        runs[dispatch] = (out.detach().numpy(), float(aux[0]),
                          [p.grad.numpy() for p in mod.parameters()])
    (oe, le, ge), (os_, ls, gs) = runs["einsum"], runs["scatter"]
    np.testing.assert_allclose(os_, oe, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ls, le, rtol=1e-6)
    for a, e in zip(gs, ge):
        np.testing.assert_allclose(a, e, rtol=2e-4, atol=2e-4)
    _, _, pprobs = _port_run(_port_module(params, dispatch="scatter", **kw), x)
    assert_routed_close(os_, want, pprobs, jprobs, top_k, rtol=1e-5, atol=1e-5)


def test_unknown_dispatch_and_missing_dispatch_fn_rejected():
    x = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="dispatch"):
        moe.MoEFeedForward(32, 64, num_experts=4, dispatch="gather-scatter", device="cpu")(x)
    with pytest.raises(ValueError, match="dispatch_fn"):
        moe.MoEFeedForward(32, 64, num_experts=4, dispatch="alltoall", device="cpu")(x)


def test_router_noise_draws_from_the_generator():
    """Multiplicative jitter in training only, from the dropout generator:
    the same generator state gives the same output; deterministic is
    noise-free."""
    mod = moe.MoEFeedForward(M, H, num_experts=4, router_noise=0.5, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(3))
    plain = mod(x)
    a = mod(x, deterministic=False, generator=torch.Generator().manual_seed(7))
    b = mod(x, deterministic=False, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, plain)
    torch.testing.assert_close(mod(x), plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        mod(x, deterministic=False)


# ---------------------------------------------------------------------------
# The all-to-all dispatch on a (2, 2) mesh of thread ranks
# ---------------------------------------------------------------------------

A2A_KW = dict(features=32, hidden=64, num_experts=4, top_k=2)


def _a2a_body(mesh, params, x, cap):
    """The all-to-all module's output and gradients, and the einsum module
    run per token group (one group a data shard: per-group capacity)."""
    torch.set_num_threads(1)
    kw = dict(A2A_KW, capacity_factor=cap)
    a2a = _port_module(params, dispatch="alltoall",
                       dispatch_fn=make_moe_a2a_fn(mesh, RULES_DP_EP_A2A), **kw)
    from learning_jax_sharding_tpu_torch.parallel.logical import activate

    xt = torch.from_numpy(x)
    with activate(mesh, RULES_DP_EP_A2A):
        out = a2a(xt).full_tensor()
        torch.sin(out).sum().backward()
    ein = _port_module(params, dispatch="einsum", **kw)
    ref = torch.cat([ein(xg) for xg in xt.chunk(2)])
    torch.sin(ref).sum().backward()
    errors = []
    for e, t in ((3, 64), (4, 63)):
        try:
            make_moe_a2a_fn(mesh, RULES_DP_EP_A2A)(
                torch.zeros(t, 32), torch.zeros(t, e), torch.zeros(e, 32, 64),
                torch.zeros(e, 64, 32), top_k=2, capacity_factor=1.0, dtype=torch.float32)
        except ValueError as exc:
            errors.append(str(exc))
    return dict(out=out.detach().numpy(), ref=ref.detach().numpy(),
                grads=[p.grad.full_tensor().numpy() if hasattr(p.grad, "full_tensor")
                       else p.grad.numpy() for p in a2a.parameters()],
                ref_grads=[p.grad.numpy() for p in ein.parameters()], errors=errors)


@pytest.fixture(scope="module")
def a2a_runs():
    x = np.random.default_rng(3).normal(size=(4, 16, 32)).astype(np.float32)
    mod = _jax_module(dispatch="einsum", **A2A_KW)
    params = nn.meta.unbox(mod.init({"params": jax.random.key(0)}, jnp.asarray(x))["params"])
    mesh = build_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    jax_out = {}
    for cap in (1.25, 0.5):
        a2a = _jax_module(dispatch="alltoall",
                          dispatch_fn=jax_a2a_fn(mesh, jax_logical.RULES_DP_EP_A2A),
                          capacity_factor=cap, **A2A_KW)
        with jax_logical.activate(mesh, jax_logical.RULES_DP_EP_A2A):
            jax_out[cap] = np.asarray(jax.jit(
                lambda p, x: a2a.apply({"params": p}, x, mutable=("losses",))[0])(
                    params, jnp.asarray(x)))
    port = {cap: run_on_threads(_a2a_body, (2, 2), ("data", "model"), args=(params, x, cap))
            for cap in (1.25, 0.5)}
    return x, params, jax_out, port


@pytest.mark.parametrize("cap", [1.25, 0.5])
def test_a2a_matches_grouped_einsum(cap, a2a_runs):
    """Outputs within 1e-5 of the einsum module run per token group, and
    of JAX's all-to-all path."""
    x, params, jax_out, port = a2a_runs
    got = port[cap]["out"]
    np.testing.assert_allclose(got, port[cap]["ref"], rtol=1e-5, atol=1e-5)
    pprobs = torch.softmax(torch.from_numpy(x).reshape(-1, 32) @ torch.from_numpy(
        np.asarray(params["router"]["kernel"])), -1).numpy()
    jprobs = np.asarray(jax.nn.softmax(jnp.asarray(x).reshape(-1, 32)
                                       @ params["router"]["kernel"], -1))
    assert_routed_close(got, jax_out[cap], pprobs, jprobs, 2, rtol=1e-5, atol=1e-5)


def test_a2a_grads_match_grouped_einsum(a2a_runs):
    _, _, _, port = a2a_runs
    for cap in (1.25, 0.5):
        for a, e in zip(port[cap]["grads"], port[cap]["ref_grads"]):
            np.testing.assert_allclose(a, e, rtol=2e-4, atol=2e-4)


def test_a2a_divisibility_validation(a2a_runs):
    """E % D and T % D: ValueError with JAX's messages."""
    _, _, _, port = a2a_runs
    assert port[1.25]["errors"] == [
        "all-to-all dispatch needs num_experts (3) divisible by the 'data' axis size (2)",
        "all-to-all dispatch needs tokens (63) divisible by the 'data' axis size (2)",
    ]


# ---------------------------------------------------------------------------
# The MoE transformer: config, train step, generate, quantization
# ---------------------------------------------------------------------------


def test_config_counts_equal_jax():
    """``param_count`` (E expert FFs and the router) and the activated
    ``train_step_flops`` (top-k expert FFs and the router) as JAX's."""
    for fields in ({}, dict(num_experts=8, moe_top_k=2), dict(num_experts=8, moe_top_k=1)):
        got = dataclasses.replace(CONFIG_TINY_MOE, **fields)
        want = dataclasses.replace(jax_tf.CONFIG_TINY_MOE, **fields)
        assert got.param_count == want.param_count
        assert got.train_step_flops(8, 1024) == want.train_step_flops(8, 1024)
    assert CONFIG_TINY_MOE.param_count > dataclasses.replace(CONFIG_TINY_MOE,
                                                             num_experts=0).param_count
    assert TransformerConfig(num_experts=8).num_experts == 8


@pytest.fixture(scope="module")
def moe_tokens():
    return np.random.default_rng(0).integers(
        0, CONFIG_TINY_MOE.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_train(moe_tokens):
    """JAX's CONFIG_TINY_MOE steps on a (2, 2) mesh (adamw, aux loss
    summed): under RULES_DP_TP_EP with the einsum dispatch, and under
    RULES_DP_EP_A2A with the all-to-all one (sgd, one step)."""
    mesh = build_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    sh = mesh_sharding(mesh, "data", None)
    batch = {"inputs": put(moe_tokens[:, :-1], sh), "targets": put(moe_tokens[:, 1:], sh)}
    out = {}
    for name, cfg, rules, opt, steps in (
        ("ep", jax_tf.CONFIG_TINY_MOE, jax_logical.RULES_DP_TP_EP, optax.adamw(3e-4),
         TRAIN_STEPS),
        ("a2a", dataclasses.replace(jax_tf.CONFIG_TINY_MOE, moe_dispatch="alltoall",
                                    moe_dispatch_fn=jax_a2a_fn(
                                        mesh, jax_logical.RULES_DP_EP_A2A)),
         jax_logical.RULES_DP_EP_A2A, optax.sgd(1e-2), 1),
    ):
        state, state_sh = jax_pipeline.sharded_train_state(
            jax_tf.Transformer(cfg), opt, batch["inputs"], {"params": jax.random.key(0)},
            mesh, rules)
        out["init"] = jax.tree.map(np.asarray, state.params)
        step = jax_pipeline.make_train_step(
            state_sh, {k: sh for k in batch}, mesh, rules, loss_fn=jax_tf.next_token_loss,
            aux_loss_collection="losses", donate_state=False)
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
        out[name] = losses
        out[name, "up"] = np.asarray(state.params["block_0"]["moe"]["up"])
    return out


def _train_body(mesh, sd, tokens):
    """The port's steps from JAX's init: under RULES_DP_TP_EP (the einsum
    dispatch, three adamw steps) with the expert stacks' local shapes, and
    under RULES_DP_EP_A2A with the all-to-all dispatch (one sgd step)."""
    torch.set_num_threads(1)
    batch = {"inputs": torch.from_numpy(tokens[:, :-1]).long(),
             "targets": torch.from_numpy(tokens[:, 1:]).long()}
    res = {}
    for name, cfg, rules, opt, steps in (
        ("ep", CONFIG_TINY_MOE, RULES_DP_TP_EP, adamw(3e-4), TRAIN_STEPS),
        ("a2a", dataclasses.replace(CONFIG_TINY_MOE, moe_dispatch="alltoall",
                                    moe_dispatch_fn=make_moe_a2a_fn(mesh, RULES_DP_EP_A2A)),
         RULES_DP_EP_A2A, sgd(1e-2), 1),
    ):
        model = Transformer(cfg, device="cpu")
        model.load_state_dict({n: torch.from_numpy(a) for n, a in sd.items()})
        state = sharded_train_state(model, opt, mesh=mesh, rules=rules)
        res[name, "shape"] = tuple(model.blocks[0].moe.up.to_local().shape)
        step = make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=rules,
                               aux_loss_collection="losses")
        res[name] = [float(step(state, batch)[1]) for _ in range(steps)]
        res[name, "up"] = model.blocks[0].moe.up.full_tensor().detach().numpy()
    return res


@pytest.fixture(scope="module")
def port_train(jax_train, moe_tokens):
    sd = {n: t.numpy() for n, t in from_flax_params(jax_train["init"], CONFIG_TINY_MOE).items()}
    return run_on_threads(_train_body, (2, 2), ("data", "model"), args=(sd, moe_tokens))


def test_tiny_moe_train_step_under_ep_rules_equals_jax(port_train, jax_train):
    """Three adamw steps with the aux loss: losses within the mesh train
    tests' rtol (1e-5 first, 1e-4 all) of JAX's; the first above ln(V)
    (the aux term is in); the expert stack split (E/2, M, H) over
    ``model``, as JAX's ``test_expert_kernels_shard_over_model``."""
    got, want = port_train["ep"], jax_train["ep"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] and got[0] > np.log(CONFIG_TINY_MOE.vocab_size)
    cfg = CONFIG_TINY_MOE
    assert port_train["ep", "shape"] == (cfg.num_experts // 2, cfg.features, cfg.hidden)


def test_tiny_moe_trains_with_the_a2a_dispatch_as_jax(port_train, jax_train):
    """The all-to-all dispatch under RULES_DP_EP_A2A: the loss of JAX's
    step (rtol 1e-5), and the expert weights moved as JAX's (atol 1e-6)."""
    np.testing.assert_allclose(port_train["a2a"], jax_train["a2a"], rtol=1e-5)
    assert port_train["a2a", "shape"] == (2, CONFIG_TINY_MOE.features, CONFIG_TINY_MOE.hidden)
    assert not np.array_equal(port_train["a2a", "up"], from_flax_params(
        jax_train["init"], CONFIG_TINY_MOE)["blocks.0.moe.up"].numpy())
    np.testing.assert_allclose(port_train["a2a", "up"], jax_train["a2a", "up"], atol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_remat_moe_step_is_bit_equal(dispatch, moe_tokens):
    """Remat recomputes each block in the backward: the aux losses still
    count once, so the loss and every gradient equal the plain step's bit
    for bit."""
    batch = {"inputs": torch.from_numpy(moe_tokens[:4, :-1]).long(),
             "targets": torch.from_numpy(moe_tokens[:4, 1:]).long()}
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(CONFIG_TINY_MOE, moe_dispatch=dispatch, remat=remat)
        state = sharded_train_state(Transformer(cfg, device="cpu", seed=0), sgd(0.0))
        loss = make_train_step(loss_fn=next_token_loss, aux_loss_collection="losses")(
            state, batch)[1]
        runs[remat] = (loss, {n: p.grad.clone() for n, p in state.model.named_parameters()})
    assert torch.equal(runs[True][0], runs[False][0])
    for name, g in runs[False][1].items():
        assert torch.equal(runs[True][1][name], g), name
    plain = sharded_train_state(Transformer(CONFIG_TINY_MOE, device="cpu", seed=0), sgd(0.0))
    no_aux = make_train_step(loss_fn=next_token_loss)(plain, batch)[1]
    assert float(runs[False][0]) > float(no_aux)


@pytest.fixture(scope="module")
def moe_params():
    prompt = np.random.default_rng(1).integers(0, 256, (4, 8)).astype(np.int32)
    params = nn.meta.unbox(jax_tf.Transformer(jax_tf.CONFIG_TINY_MOE).init(
        jax.random.key(0), jnp.asarray(prompt))["params"])
    return params, prompt


def _generate_body(mesh, sd, prompt):
    torch.set_num_threads(1)
    gen = make_generate_fn(dataclasses.replace(CONFIG_TINY_MOE, decode_attention="blocked"),
                           mesh, RULES_DP_TP_EP, max_new_tokens=6, device="cpu")
    return gen({n: torch.from_numpy(a) for n, a in sd.items()},
               torch.from_numpy(prompt)).cpu().numpy()


def test_moe_generate_under_ep_rules_equals_jax(moe_params):
    """Greedy generation of CONFIG_TINY_MOE on a (2, 4) mesh under
    RULES_DP_TP_EP: the tokens of JAX's generate on its (2, 4) mesh."""
    params, prompt = moe_params
    mesh = build_mesh((2, 4), ("data", "model"), devices=jax.devices())
    want = np.asarray(jax_generate_fn(jax_tf.CONFIG_TINY_MOE, mesh, jax_logical.RULES_DP_TP_EP,
                                      max_new_tokens=6)(params, jnp.asarray(prompt)))
    sd = {n: t.numpy() for n, t in from_flax_params(params, CONFIG_TINY_MOE).items()}
    got = run_on_threads(_generate_body, (2, 4), ("data", "model"), args=(sd, prompt))
    assert got.shape == (4, 14)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_expert_stacks_equal_jax(bits, moe_params):
    """The 3-D stacks quantize byte for byte as JAX's (a scale per expert
    and channel; int4 per expert, group and channel), each slice within
    its bound (scale/2 an element); the router is never quantized; the
    stacks serve dequantized (``dequantize=True``) with JAX's tokens, and
    the fused modes refuse them in both packages."""
    params, prompt = moe_params
    cfg = dataclasses.replace(CONFIG_TINY_MOE, quantization_group=16,
                              decode_attention="blocked")
    sd = from_flax_params(params, cfg)
    got = tq.quantize_tree(sd, bits=bits, group_size=16)
    want = jax_quantize.quantize_tree(params, bits=bits, group_size=16)
    key = "q" if bits == 8 else "q4"
    for i in range(cfg.num_layers):
        node = want[f"block_{i}"]["moe"]
        assert f"blocks.{i}.moe.router.weight" in got and "kernel" in node["router"]
        for name in ("up", "down"):
            for leaf in (key, "scale"):
                np.testing.assert_array_equal(got[f"blocks.{i}.moe.{name}.{leaf}"].numpy(),
                                              np.asarray(node[name][leaf]))
            w = sd[f"blocks.{i}.moe.{name}"]
            err = (tq.dequantize_tree(got, torch.float32)[f"blocks.{i}.moe.{name}"] - w).abs()
            scale = got[f"blocks.{i}.moe.{name}.scale"]
            bound = (scale[:, None, :] if bits == 8 else
                     scale.repeat_interleave(w.shape[1] // scale.shape[1], 1)) / 2
            assert bool((err <= bound + 1e-7).all())
    jax_mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    jcfg = dataclasses.replace(jax_tf.CONFIG_TINY_MOE, quantization_group=16)
    want_tokens = np.asarray(jax_generate_fn(jcfg, jax_mesh, jax_logical.RULES_DP_TP,
                                             max_new_tokens=4, dequantize=True)(
        want, jnp.asarray(prompt)))
    got_tokens = make_generate_fn(cfg, max_new_tokens=4, dequantize=True, device="cpu")(
        got, torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got_tokens, want_tokens)
    if bits == 4:
        with pytest.raises(Exception):
            jax_generate_fn(jcfg, jax_mesh, jax_logical.RULES_DP_TP, max_new_tokens=4,
                            dequantize="fused")(want, jnp.asarray(prompt))
        with pytest.raises(ValueError, match="dequantize=True"):
            make_generate_fn(cfg, max_new_tokens=4, dequantize="fused", device="cpu")


def test_convert_carries_the_moe_tree(moe_params):
    """``from_flax_params`` and ``to_flax_params``: router kernel
    transposed, stacks as they are, round trip exact; the logical axes
    place the stacks (EXPERT, EMBED, MLP) / (EXPERT, MLP, EMBED)."""
    params, _ = moe_params
    sd = from_flax_params(params, CONFIG_TINY_MOE)
    np.testing.assert_array_equal(sd["blocks.0.moe.router.weight"].numpy(),
                                  np.asarray(params["block_0"]["moe"]["router"]["kernel"]).T)
    back = to_flax_params(sd)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))
    assert set(Transformer(CONFIG_TINY_MOE, device="cpu").state_dict()) == set(sd)
    assert param_logical_axes("blocks.0.moe.up") == ("expert", "embed", "mlp")
    assert param_logical_axes("blocks.0.moe.down") == ("expert", "mlp", "embed")
    assert param_logical_axes("blocks.0.moe.router.weight") == ("expert", "embed")


def test_fit_passes_the_aux_losses_through():
    """``fit(step_kwargs={"aux_loss_collection": "losses"})`` trains the MoE
    model with its load-balancing losses added, as JAX's ``fit`` takes them
    through ``step_kwargs``: the same first batch scores higher with them."""
    from learning_jax_sharding_tpu_torch.data import CyclicLMDataset
    from learning_jax_sharding_tpu_torch.training.loop import TrainLoopConfig, fit

    runs = {}
    for name, kw in (("plain", None), ("aux", {"aux_loss_collection": "losses"})):
        _, history = fit(Transformer(CONFIG_TINY_MOE, device="cpu", seed=0),
                         CyclicLMDataset(CONFIG_TINY_MOE.vocab_size, 16, seed=1), None, None,
                         TrainLoopConfig(steps=2, global_batch_size=4, prefetch=0),
                         step_kwargs=kw)
        runs[name] = history[0]["loss"]
    assert runs["aux"] > runs["plain"]
