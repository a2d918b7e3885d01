"""The port's train step against the JAX package's, on converted weights.

``CONFIG_TINY`` in fp32: the JAX state is made by ``sharded_train_state`` on
a (1, 1) mesh under ``RULES_DP_TP`` and carried into the port by
``from_flax_params``; JAX runs the flash kernels in Pallas interpret mode,
the port their plain versions. One step's loss agrees within rtol 1e-5, its
gradients (mapped with ``from_flax_params``) within atol 1e-5 / rtol 1e-4,
the parameters after three ``optax.adamw(3e-4)`` steps within atol 1e-5;
through the flash ``attn_fn`` with the fused loss, and through the dense
path with the logits loss. Also the step's options, the schedules, clipping,
losses and FLOP counts against JAX on fixed inputs, and the three repairs
of this slice (dropout by argument and generator, one card in the chip
smoke's last line, the slice named by unported options).
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu.ops.flash_attention import (
    make_flash_attn_fn as jax_make_flash_attn_fn,
)
from learning_jax_sharding_tpu.parallel import build_mesh, mesh_sharding, put
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP, activate
from learning_jax_sharding_tpu.training import loop as jax_loop
from learning_jax_sharding_tpu.training import pipeline as jax_pipeline
from learning_jax_sharding_tpu_torch.models.attention import MultiHeadAttention
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_125M,
    CONFIG_TINY,
    Transformer,
    TransformerConfig,
    fused_next_token_loss,
    make_next_token_loss,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops.flash_attention import make_flash_attn_fn
from learning_jax_sharding_tpu_torch.training import loop, pipeline

torch.set_num_threads(1)

B, S, CHUNK = 4, 32, 16
PATHS = {
    # path: (port attn_fn, JAX attn_fn, fused loss?)
    "flash_fused": (make_flash_attn_fn, lambda: jax_make_flash_attn_fn(interpret=True), True),
    "dense_logits": (lambda: None, lambda: None, False),
}


def _tokens(seed, b=B, s=S, vocab=CONFIG_TINY.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)


def _batches(tokens):
    np_batch = {"inputs": tokens[..., :-1], "targets": tokens[..., 1:]}
    return np_batch, {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}


@functools.cache
def _mesh():
    return build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])


def _jax_setup(jcfg, optimizer, tokens):
    """JAX state on the (1, 1) mesh → (state, shardings, numpy params)."""
    mesh = _mesh()
    x = put(tokens[:, :-1], mesh_sharding(mesh, "data", None))
    state, state_sh = jax_pipeline.sharded_train_state(
        jax_tf.Transformer(jcfg), optimizer, x, {"params": jax.random.key(0)},
        mesh, RULES_DP_TP,
    )
    return state, state_sh, jax.tree.map(np.asarray, state.params)


def _jax_step(state_sh, fused, **kw):
    mesh = _mesh()
    sh = {k: mesh_sharding(mesh, "data", None) for k in ("inputs", "targets")}
    loss_kw = dict(loss_fn=jax_tf.next_token_loss)
    if fused:
        loss_kw = dict(
            loss_fn=functools.partial(jax_tf.fused_next_token_loss, chunk_size=CHUNK),
            loss_needs_params=True, apply_kwargs={"return_hidden": True},
        )
    return jax_pipeline.make_train_step(
        state_sh, sh, mesh, RULES_DP_TP, donate_state=False, **loss_kw, **kw
    )


def _port_state(cfg, params, optimizer):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(from_flax_params(params, cfg))
    return pipeline.sharded_train_state(model, optimizer)


def _port_step(fused, **kw):
    if fused:
        return pipeline.make_train_step(
            loss_fn=functools.partial(fused_next_token_loss, chunk_size=CHUNK),
            loss_needs_params=True, apply_kwargs={"return_hidden": True}, **kw,
        )
    return pipeline.make_train_step(loss_fn=next_token_loss, **kw)


def _assert_params(model, params, cfg, **tol):
    want = from_flax_params(params, cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("path", list(PATHS))
def test_step_matches_jax(path):
    """One step's loss, grads and grad norm; the params after three."""
    port_fn, jax_fn, fused = PATHS[path]
    cfg = dataclasses.replace(CONFIG_TINY, attn_fn=port_fn())
    jcfg = dataclasses.replace(jax_tf.CONFIG_TINY, attn_fn=jax_fn())
    tokens = _tokens(1)
    np_batch, batch = _batches(tokens)
    with jax.default_matmul_precision("float32"), activate(_mesh(), RULES_DP_TP):
        state, state_sh, params = _jax_setup(jcfg, optax.adamw(3e-4), tokens)
        jstep = _jax_step(state_sh, fused, with_grad_norm=True)
        model = jax_tf.Transformer(jcfg)

        def jloss(p):
            if fused:
                hidden = model.apply({"params": p}, np_batch["inputs"], return_hidden=True)
                return jax_tf.fused_next_token_loss(hidden, np_batch, p, chunk_size=CHUNK)
            return jax_tf.next_token_loss(model.apply({"params": p}, np_batch["inputs"]), np_batch)

        jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(state.params))
        jouts = []
        for _ in range(3):
            state, out = jstep(state, np_batch)
            jouts.append(jax.tree.map(float, out))

    pstate = _port_state(cfg, params, loop.adamw(3e-4))
    pstep = _port_step(fused, with_grad_norm=True)
    _, out = pstep(pstate, batch)
    np.testing.assert_allclose(out["loss"].item(), jouts[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(out["grad_norm"].item(), jouts[0]["grad_norm"], rtol=1e-5)
    want = from_flax_params(jgrads, cfg)
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    for _ in range(2):
        pstep(pstate, batch)
    assert pstate.step == 3
    _assert_params(pstate.model, jax.tree.map(np.asarray, state.params), cfg, atol=1e-5, rtol=0)


@pytest.mark.parametrize("option", ["steps_per_call", "grad_accum", "clip_and_schedule"])
def test_step_options_match_jax(option):
    """``steps_per_call=2`` (two stacked batches, the (2,) losses),
    ``grad_accum_steps=2``, and an AdamW under a warmup + cosine schedule
    behind global-norm clipping (``default_optimizer``): losses and the
    params afterwards against JAX."""
    tokens = _tokens(2)
    jopt, popt, kw, calls = optax.adamw(3e-4), loop.adamw(3e-4), {}, 1
    if option == "steps_per_call":
        tokens = np.stack([tokens, _tokens(3)])
        kw = dict(steps_per_call=2)
    elif option == "grad_accum":
        kw = dict(grad_accum_steps=2)
    else:
        cfg_loop = dict(steps=4, global_batch_size=B, learning_rate=3e-4, warmup_steps=1,
                        lr_schedule="cosine", min_learning_rate=3e-5, grad_clip_norm=0.5)
        jopt = jax_loop.default_optimizer(jax_loop.TrainLoopConfig(**cfg_loop))
        popt = loop.default_optimizer(loop.TrainLoopConfig(**cfg_loop))
        calls = 3
    np_batch, batch = _batches(tokens)
    with jax.default_matmul_precision("float32"), activate(_mesh(), RULES_DP_TP):
        state, state_sh, params = _jax_setup(jax_tf.CONFIG_TINY, jopt, _tokens(2))
        jstep = _jax_step(state_sh, False, **kw)
        jlosses = []
        for _ in range(calls):
            state, loss = jstep(state, np_batch)
            jlosses.append(np.asarray(loss))
    pstate = _port_state(CONFIG_TINY, params, popt)
    pstep = _port_step(False, **kw)
    for want in jlosses:
        _, loss = pstep(pstate, batch)
        assert loss.shape == want.shape
        np.testing.assert_allclose(loss.numpy(), want, rtol=1e-5)
    # The grads' tolerance: Adam's m/√v turns a 1e-7 difference of a grad
    # near zero into a 1e-5 step difference.
    _assert_params(pstate.model, jax.tree.map(np.asarray, state.params), CONFIG_TINY,
                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(kind, warmup):
    fields = dict(steps=10, global_batch_size=8, learning_rate=1e-3, warmup_steps=warmup,
                  lr_schedule=kind, min_learning_rate=1e-4)
    want = jax_loop.lr_schedule(jax_loop.TrainLoopConfig(**fields))
    got = loop.lr_schedule(loop.TrainLoopConfig(**fields))
    for step in range(14):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    pipeline.clip_by_global_norm_(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        pipeline.global_norm([torch.from_numpy(g) for g in grads]).item(),
        float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6,
    )


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(2, 8, 32)) * 3).astype(np.float32)
    hidden = rng.normal(size=(2, 8, 16)).astype(np.float32)
    kernel = (rng.normal(size=(16, 32)) * 0.2).astype(np.float32)
    targets = rng.integers(0, 32, (2, 8)).astype(np.int32)
    jb, tb = {"targets": jnp.asarray(targets)}, {"targets": torch.from_numpy(targets)}
    tl = torch.from_numpy(logits)
    cases = [
        (next_token_loss(tl, tb), jax_tf.next_token_loss(jnp.asarray(logits), jb)),
        (make_next_token_loss(label_smoothing=0.1, z_loss=1e-4)(tl, tb),
         jax_tf.make_next_token_loss(label_smoothing=0.1, z_loss=1e-4)(jnp.asarray(logits), jb)),
        (make_next_token_loss()(tl, tb), jax_tf.next_token_loss(jnp.asarray(logits), jb)),
    ]
    head = torch.nn.Module()
    head.lm_head = torch.nn.Linear(16, 32, bias=False)
    with torch.no_grad():
        head.lm_head.weight.copy_(torch.from_numpy(kernel.T.copy()))
    with jax.default_matmul_precision("float32"):
        cases.append((
            fused_next_token_loss(torch.from_numpy(hidden), tb, head, chunk_size=4),
            jax_tf.fused_next_token_loss(jnp.asarray(hidden), jb,
                                         {"lm_head": {"kernel": jnp.asarray(kernel)}},
                                         chunk_size=4),
        ))
    for got, want in cases:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="chunk_size"):
        fused_next_token_loss(torch.zeros(2, 10, 16), tb, head, chunk_size=4)


@pytest.mark.parametrize("fields", [{}, dict(num_kv_heads=4, rope=True, causal=False)],
                         ids=["125m", "gqa_rope_bidirectional"])
def test_flops_and_param_count_match_jax(fields):
    cfg = dataclasses.replace(CONFIG_125M, **fields)
    jcfg = dataclasses.replace(jax_tf.CONFIG_125M, **fields)
    assert cfg.param_count == jcfg.param_count
    assert cfg.train_step_flops(8, 1024) == jcfg.train_step_flops(8, 1024)


def test_dropout_is_an_argument_not_a_mode():
    """Repair: with ``dropout_rate=0.1`` the default forward (a fresh
    module is in train mode) equals JAX's default ``apply``; dropout on
    draws from the generator it is given."""
    cfg = dataclasses.replace(CONFIG_TINY, dropout_rate=0.1)
    jcfg = dataclasses.replace(jax_tf.CONFIG_TINY, dropout_rate=0.1)
    tokens = _tokens(6)[:, :-1]
    params = jax_tf.Transformer(jcfg).init(jax.random.key(0), jnp.asarray(tokens))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    want = np.asarray(jax_tf.Transformer(jcfg).apply({"params": params}, jnp.asarray(tokens)))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(from_flax_params(params, cfg))
    assert model.training
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        np.testing.assert_allclose(model(t).numpy(), want, atol=1e-5, rtol=0)

        def dropped(seed):
            return model(t, deterministic=False,
                         generator=torch.Generator().manual_seed(seed))

        first, again, other = dropped(0), dropped(0), dropped(1)
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    assert not torch.allclose(first, other)
    assert not torch.allclose(first, model(t))
    with pytest.raises(ValueError, match="generator"):
        model(t, deterministic=False)


def test_train_step_dropout_seed():
    """The step's dropout seed: the same seed gives the same loss, another
    seed another loss, and no seed the deterministic loss."""
    cfg = dataclasses.replace(CONFIG_TINY, dropout_rate=0.3)
    _, batch = _batches(_tokens(7))
    losses = {}
    for seed in (3, 3, 4, None):
        state = pipeline.sharded_train_state(
            Transformer(cfg, device="cpu", seed=0), loop.adamw(3e-4))
        _, loss = pipeline.make_train_step(loss_fn=next_token_loss, dropout_seed=seed)(
            state, batch)
        losses.setdefault(seed, []).append(loss.item())
    assert losses[3][0] == losses[3][1]
    assert len({losses[3][0], losses[4][0], losses[None][0]}) == 3


def test_eval_and_apply_follow_the_state():
    state = pipeline.sharded_train_state(Transformer(CONFIG_TINY, device="cpu"),
                                         loop.adamw(3e-4))
    _, batch = _batches(_tokens(8))
    ev = pipeline.make_eval_step(loss_fn=next_token_loss)
    before = ev(state, batch)
    logits = pipeline.make_apply_fn()(state, batch["inputs"])
    torch.testing.assert_close(next_token_loss(logits, batch), before)
    _, loss = pipeline.make_train_step(loss_fn=next_token_loss)(state, batch)
    torch.testing.assert_close(loss, before)
    assert ev(state, batch) < before


def test_attention_module_routes_attn_fn():
    """A ``supports_gqa`` backend gets k/v at N_kv heads, another backend
    repeated k/v; a window with a backend, and decode with a backend,
    raise as in JAX."""
    seen = []

    def plain(q, k, v, *, causal):
        seen.append(k.shape[2])
        return q

    gqa = make_flash_attn_fn()
    x = torch.randn(2, 8, 32)
    for fn in (plain, gqa):
        mod = MultiHeadAttention(32, 4, 16, num_kv_heads=2, causal=True, attn_fn=fn,
                                 device="cpu")
        mod(x)
    assert seen == [4]
    with pytest.raises(ValueError, match="window with a custom attn_fn"):
        MultiHeadAttention(32, 4, 16, window=4, causal=True, attn_fn=gqa, device="cpu")(x)
    dec = MultiHeadAttention(32, 4, 16, causal=True, attn_fn=gqa, decode=True,
                             max_decode_len=16, device="cpu")
    with pytest.raises(ValueError, match="attn_fn backends"):
        dec(x, cache=dec.init_cache(2, torch.device("cpu")))


def test_unported_parts_name_their_slice():
    """Repair: the messages name the slice that brings each part."""
    for field in ("scan_layers", "remat"):
        with pytest.raises(NotImplementedError, match=rf"{field}: ported with slice D"):
            TransformerConfig(**{field: True})
    with pytest.raises(NotImplementedError, match="slice D"):
        from_flax_params({"blocks": {}}, CONFIG_TINY)
    for name in ("lion", "adafactor"):
        with pytest.raises(NotImplementedError, match="slice D"):
            loop.default_optimizer(loop.TrainLoopConfig(steps=1, global_batch_size=1,
                                                        optimizer=name))
    with pytest.raises(ValueError, match="unknown optimizer"):
        loop.default_optimizer(loop.TrainLoopConfig(steps=1, global_batch_size=1,
                                                    optimizer="sgd"))
    model = Transformer(CONFIG_TINY, device="cpu")
    with pytest.raises(NotImplementedError, match="slice A"):
        pipeline.sharded_train_state(model, loop.adamw(3e-4), mesh=object())
    with pytest.raises(NotImplementedError, match="slice E"):
        pipeline.make_train_step(skip_nonfinite=True)


def test_chip_smoke_reports_the_one_card_it_used():
    """Repair: the last line counts the one card of the run, not every card
    the host shows."""
    assert chip_smoke.result_line("NVIDIA H100 80GB HBM3") == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
