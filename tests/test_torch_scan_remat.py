"""Rematerialisation and stacked layers against the JAX package's.

Same weights (a JAX init carried across with ``from_flax_params``), same
numpy-seeded tokens, fp32: the port's logits and its loss gradients under
``remat`` (every policy), ``remat_attention`` and ``scan_layers`` equal the
JAX model's within ``ATOL`` (the accumulation-order noise between XLA and
torch on the CPU) and the port's own plain model's bit for bit. Each remat
policy recomputes exactly the matmuls JAX's policy would not save (counted
in the backward). Dropout under remat replays the block's generator: the
gradients equal those without remat bit for bit. A stacked model trains on a
(2, 2) mesh of thread ranks as on one device, and its checkpoint restores.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
    next_token_loss as jax_next_token_loss,
)
from learning_jax_sharding_tpu_torch.models import convert
from learning_jax_sharding_tpu_torch.models.convert import (
    from_flax_params,
    param_logical_axes,
    stack_scan_params,
    unstack_scan_params,
)
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    fused_next_token_loss,
    next_token_loss,
    resolve_remat_policy,
)
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import LAYERS, RULES_DP_TP
from learning_jax_sharding_tpu_torch.training.checkpoint import CheckpointManager
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import make_train_step, sharded_train_state

torch.set_num_threads(1)

# XLA and torch sum fp32 products in other orders.
ATOL = 2e-5
VARIANTS = {
    "plain": {},
    "remat": dict(remat=True),
    "remat_nothing": dict(remat=True, remat_policy="nothing"),
    "remat_dots": dict(remat=True, remat_policy="dots"),
    "remat_dots_no_batch": dict(remat=True, remat_policy="dots_no_batch"),
    "remat_attention": dict(remat_attention=True),
    "scan": dict(scan_layers=True),
    "scan_remat_dots": dict(scan_layers=True, remat=True, remat_policy="dots"),
}


@pytest.fixture(scope="module")
def setup():
    """JAX loss, logits and gradients of every variant, from one init (the
    unrolled tree, stacked for the scanned variants)."""
    tokens = np.random.default_rng(0).integers(0, CONFIG_TINY.vocab_size, (4, 16)).astype(np.int32)
    tok = jnp.asarray(tokens)
    params = nn.meta.unbox(JaxTransformer(JAX_TINY).init(jax.random.key(0), tok)["params"])
    stacked = {k: v for k, v in params.items() if not k.startswith("block_")}
    stacked["blocks"] = jax.tree.map(lambda *xs: jnp.stack(xs),
                                     *[params[f"block_{i}"] for i in range(JAX_TINY.num_layers)])
    results = {}
    for name, fields in VARIANTS.items():
        model = JaxTransformer(dataclasses.replace(JAX_TINY, **fields))
        tree = stacked if fields.get("scan_layers") else params

        def loss_fn(p, model=model):
            logits = model.apply({"params": p}, tok)
            return jax_next_token_loss(logits, {"targets": tok}), logits

        with jax.default_matmul_precision("float32"):
            (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
        results[name] = dict(loss=float(loss), logits=np.asarray(logits),
                             grads=jax.tree.map(np.asarray, grads))
    np_params = jax.tree.map(np.asarray, params)
    np_stacked = jax.tree.map(np.asarray, stacked)
    return dict(tokens=tokens, params=np_params, stacked=np_stacked, jax=results)


def _port_model(setup, fields, **kw):
    cfg = dataclasses.replace(CONFIG_TINY, **fields, **kw)
    model = Transformer(cfg, device="cpu")
    tree = setup["stacked"] if cfg.scan_layers else setup["params"]
    model.load_state_dict(from_flax_params(tree, cfg))
    return model


def _loss_and_grads(model, tokens, **kw):
    tok = torch.from_numpy(tokens)
    logits = model(tok, **kw)
    loss = next_token_loss(logits, {"targets": tok})
    loss.backward()
    return loss.item(), logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_and_gradients_match_jax(setup, name):
    fields = VARIANTS[name]
    loss, logits, grads = _loss_and_grads(_port_model(setup, fields), setup["tokens"])
    ref = setup["jax"][name]
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=ATOL, rtol=0)
    assert loss == pytest.approx(ref["loss"], abs=ATOL)
    cfg = dataclasses.replace(CONFIG_TINY, **fields)
    want = from_flax_params(ref["grads"], cfg)
    assert set(want) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=ATOL, rtol=0, err_msg=n)
    # And bit for bit the port's plain model (stacked alike).
    plain = _loss_and_grads(_port_model(setup, {"scan_layers": cfg.scan_layers}),
                            setup["tokens"])
    assert loss == plain[0]
    assert torch.equal(logits, plain[1])
    for n, g in grads.items():
        assert torch.equal(g, plain[2][n]), n


@pytest.mark.parametrize("fused", [False, True])
def test_remat_fused_norm_gradients_bit_equal(setup, fused):
    """The fused residual+norm's ``autograd.Function`` (plain version here)
    under block remat: recomputed, the gradients unchanged."""
    runs = [_loss_and_grads(_port_model(setup, dict(fused_norm=fused, remat=remat)),
                            setup["tokens"]) for remat in (False, True)]
    assert runs[0][0] == runs[1][0]
    for n, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][n]), n


class _MatmulCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.counts["mm"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(setup, fields) -> dict:
    model = _port_model(setup, fields)
    tok = torch.from_numpy(setup["tokens"])
    loss = next_token_loss(model(tok), {"targets": tok})
    with _MatmulCounter() as counter:
        loss.backward()
    return counter.counts


def test_policies_recompute_what_jax_does_not_save(setup):
    """JAX (``print_saved_residuals``) saves under "dots" every Dense output
    and both attention einsums, under "dots_no_batch" the Dense outputs only
    (6 a block), under None nothing. So the backward recomputes, beyond the
    plain backward's products, per layer: the projections and the 2 einsums
    (None), nothing ("dots"), the 2 einsums ("dots_no_batch"). The
    recompute stops at the last tensor the backward needs: the FF's down
    product, whose output no gradient reads, is not rerun (5 of the 6
    projections)."""
    layers = CONFIG_TINY.num_layers
    base = _backward_matmuls(setup, {})
    extra = {}
    for policy in (None, "dots", "dots_no_batch"):
        got = _backward_matmuls(setup, dict(remat=True, remat_policy=policy))
        extra[policy] = {k: got[k] - base[k] for k in got}
    assert extra == {None: {"mm": 5 * layers, "bmm": 2 * layers},
                     "dots": {"mm": 0, "bmm": 0},
                     "dots_no_batch": {"mm": 0, "bmm": 2 * layers}}


def test_remat_policy_names_and_config_errors():
    assert resolve_remat_policy(None) is None
    assert resolve_remat_policy("nothing") is None
    assert resolve_remat_policy("dots") is not None
    with pytest.raises(ValueError, match="remat_policy"):
        resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="remat=False"):
        dataclasses.replace(CONFIG_TINY, remat_policy="dots")
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(CONFIG_TINY, remat=True, remat_policy="dotz")
    dataclasses.replace(CONFIG_TINY, remat_policy="nothing")       # the default's name
    with pytest.raises(NotImplementedError, match="num_experts"):
        dataclasses.replace(CONFIG_TINY, num_experts=4)


def test_scan_decode_rejected():
    cfg = dataclasses.replace(CONFIG_TINY, scan_layers=True, decode=True)
    with pytest.raises(ValueError, match="scan_layers"):
        Transformer(cfg, device="cpu")


def test_stacked_layout_and_init():
    """Stacked names without a layer index, shapes led by the layer dim,
    logical axes led by LAYERS; distinct layers, drawn as the unrolled model
    draws them (the same seed gives its weights, stacked)."""
    scan = Transformer(dataclasses.replace(CONFIG_TINY, scan_layers=True), device="cpu", seed=3)
    unrolled = Transformer(CONFIG_TINY, device="cpu", seed=3)
    q = scan.state_dict()["blocks.attn.query.weight"]
    m = CONFIG_TINY.num_heads * CONFIG_TINY.head_dim
    assert q.shape == (CONFIG_TINY.num_layers, m, CONFIG_TINY.features)
    assert not torch.equal(q[0], q[1])
    stacked = stack_scan_params(unrolled.state_dict())
    assert set(stacked) == set(scan.state_dict())
    for n, t in scan.state_dict().items():
        assert torch.equal(t, stacked[n]), n
    for name, _, _ in convert.layout_tensors(scan):
        if name.startswith("blocks."):
            inner = param_logical_axes("blocks.0." + name.split(".", 1)[1])
            assert param_logical_axes(name) == (LAYERS, *inner), name
    assert param_logical_axes("blocks.ln_ff.bias") == (LAYERS, "embed")


def test_stacked_tree_conversions(setup):
    """The JAX stacked tree converts to ``stack_scan_params`` of the
    unrolled one; unstack/stack are inverses and pass their target layout
    through; both layouts give equal logits; a stage-stacked tree is
    refused."""
    cfg = dataclasses.replace(CONFIG_TINY, scan_layers=True)
    from_stacked = from_flax_params(setup["stacked"], cfg)
    unrolled = from_flax_params(setup["params"], CONFIG_TINY)
    stacked = stack_scan_params(unrolled)
    assert set(stacked) == set(from_stacked)
    for n in stacked:
        assert torch.equal(stacked[n], from_stacked[n]), n
    back = unstack_scan_params(stacked)
    assert set(back) == set(unrolled) and all(torch.equal(back[n], unrolled[n]) for n in back)
    assert set(unstack_scan_params(unrolled)) == set(unrolled)
    assert set(stack_scan_params(stacked)) == set(stacked)
    tok = torch.from_numpy(setup["tokens"])
    with torch.no_grad():
        a = _port_model(setup, {"scan_layers": True})(tok)
        plain = Transformer(CONFIG_TINY, device="cpu")
        plain.load_state_dict(unrolled)
        b = plain(tok)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="stage-stacked"):
        unstack_scan_params({"embed.weight": torch.zeros(2), **stacked})


def test_dropout_under_remat_replays_the_generator(setup):
    """The same generator seed gives bit-equal gradients with and without
    remat, unrolled and stacked: the recompute redraws the forward's
    masks."""
    for scan in (False, True):
        runs = []
        for remat in (False, True):
            model = _port_model(setup, dict(scan_layers=scan, remat=remat, dropout_rate=0.3))
            runs.append(_loss_and_grads(model, setup["tokens"], deterministic=False,
                                        generator=torch.Generator().manual_seed(11)))
        assert runs[0][0] == runs[1][0], f"scan={scan}"
        for n, g in runs[0][2].items():
            assert torch.equal(g, runs[1][2][n]), f"scan={scan}: {n}"


STEPS = 2


def _train(model, batch, *, mesh=None, rules=None):
    """STEPS fused-loss AdamW steps → the losses, the last step's gradients
    (whole) and the state. (The gradients, not the updated weights, are
    compared: Adam's first update is ±rate wherever a gradient is nonzero,
    so a gradient at rounding level takes either sign.)"""
    state = sharded_train_state(model, adamw(1e-3), mesh=mesh, rules=rules)
    step = make_train_step(loss_fn=lambda h, b, m: fused_next_token_loss(h, b, m, chunk_size=8),
                           loss_needs_params=True, apply_kwargs={"return_hidden": True},
                           mesh=mesh, rules=rules)
    losses = [float(step(state, batch)[1]) for _ in range(STEPS)]
    grads = {n: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad).clone()
             for n, p in state.model.named_parameters()}
    return losses, grads, state


def _batch(tokens):
    tok = torch.from_numpy(tokens)
    return {"inputs": tok, "targets": torch.roll(tok, -1, dims=1)}


def _stacked_train_body(mesh, sd, tokens):
    """Rank body: the stacked, rematerialised ("dots") model trained over
    the mesh under RULES_DP_TP; the losses, the last gradients whole and
    each stacked kernel's placements."""
    cfg = dataclasses.replace(CONFIG_TINY, scan_layers=True, remat=True, remat_policy="dots")
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    losses, grads, state = _train(model, _batch(tokens), mesh=mesh, rules=RULES_DP_TP)
    placements = {n: tuple(t.placements) for n, t in state.model.named_parameters()}
    return losses, grads, placements


def test_stacked_train_step_over_thread_mesh(setup):
    cfg = dataclasses.replace(CONFIG_TINY, scan_layers=True, remat=True, remat_policy="dots")
    sd = from_flax_params(setup["stacked"], cfg)
    losses, grads, placements = run_on_threads(
        _stacked_train_body, (2, 2), ("data", "model"), args=(sd, setup["tokens"]))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    one_losses, one_grads, _ = _train(model, _batch(setup["tokens"]))
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
    for n, g in one_grads.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), atol=1e-6, rtol=0, err_msg=n)
    # The layer dim whole, the kernel split as its unrolled counterpart's.
    assert placements["blocks.attn.query.weight"] == (Replicate(), Shard(1))
    assert placements["blocks.ff.down.weight"] == (Replicate(), Shard(2))
    # JAX's loss on the same stacked weights and batch.
    jcfg = dataclasses.replace(JAX_TINY, scan_layers=True)
    tok = jnp.asarray(setup["tokens"])
    with jax.default_matmul_precision("float32"):
        logits = JaxTransformer(jcfg).apply({"params": setup["stacked"]}, tok)
        jax_loss = float(jax_next_token_loss(logits, {"targets": jnp.roll(tok, -1, axis=1)}))
    assert losses[0] == pytest.approx(jax_loss, abs=ATOL)


def test_stacked_checkpoint_round_trip(setup, tmp_path):
    cfg = dataclasses.replace(CONFIG_TINY, scan_layers=True)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(from_flax_params(setup["stacked"], cfg))
    _, _, state = _train(model, _batch(setup["tokens"]))
    fresh = sharded_train_state(Transformer(cfg, device="cpu", seed=9), adamw(1e-3))
    with CheckpointManager(tmp_path) as ckpt:
        assert ckpt.save(STEPS, state)
        ckpt.wait()
        ckpt.restore(STEPS, like=fresh)
    for (n, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state.optimizer.state[p]["exp_avg"],
                           fresh.optimizer.state[q]["exp_avg"]), n
    assert fresh.step == state.step
