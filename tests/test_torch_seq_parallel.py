"""Sequence-parallel attention, ring and Ulysses, against the JAX package's.

The same numpy-seeded ``(B, S, N, H)`` inputs go through JAX's
``ops/ring_attention.py`` and ``ops/ulysses.py`` (on the conftest's
emulated devices) and through the port's (``parallel.run_on_threads``:
each rank a thread of this process), on (2, 4) and (2, 2) ``data`` ×
``model`` meshes under ``RULES_DP_SP`` (the sequence over ``model``),
causal and not: outputs within rtol 2e-4 / atol 2e-5 and gradients within
rtol 5e-4 / atol 5e-5 of JAX's and of dense attention (the JAX tests'
bounds). The output stays sequence-split; the ring hops count as
``collective-permute``s and Ulysses' swaps as ``all-to-all``s; Ulysses
refuses what JAX refuses. Then ``CONFIG_TINY`` trains two steps through
``make_train_step`` under ``RULES_DP_SP`` with each strategy as its
``attn_fn``, losses equal to JAX's step within the mesh train tests' rtol.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu.ops.attention import causal_mask as jax_causal_mask
from learning_jax_sharding_tpu.ops.attention import dot_product_attention as jax_dense
from learning_jax_sharding_tpu.ops.ring_attention import make_ring_attn_fn as jax_ring_fn
from learning_jax_sharding_tpu.ops.ulysses import make_ulysses_attn_fn as jax_ulysses_fn
from learning_jax_sharding_tpu.ops.ulysses import ulysses_attention as jax_ulysses
from learning_jax_sharding_tpu.parallel import build_mesh, mesh_sharding, put
from learning_jax_sharding_tpu.parallel import logical as jax_logical
from learning_jax_sharding_tpu.parallel.hlo import collective_counts as jax_counts
from learning_jax_sharding_tpu.training import pipeline as jax_pipeline
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops.attention import causal_mask, dot_product_attention
from learning_jax_sharding_tpu_torch.ops.ring_attention import make_ring_attn_fn
from learning_jax_sharding_tpu_torch.ops.ulysses import make_ulysses_attn_fn, ulysses_attention
from learning_jax_sharding_tpu_torch.parallel import collective_counts, run_on_mesh, run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import (
    RULES_DP_SP,
    RULES_DP_TP_SP,
    HEADS,
    SEQ,
)
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import make_train_step, sharded_train_state
from tests._torch_jax import quick_jax_compiles  # noqa: F401

B, S, N, H = 4, 64, 4, 16
MESHES = {"2x4": (2, 4), "2x2": (2, 2)}
STRATEGIES = {"ring": (jax_ring_fn, make_ring_attn_fn),
              "ulysses": (jax_ulysses_fn, make_ulysses_attn_fn)}
CASES = [(m, st, c) for m in MESHES for st in STRATEGIES for c in (False, True)]
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 32, 2


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {n: rng.standard_normal((B, S, N, H)).astype(np.float32)
            for n in ("q", "k", "v", "dout")}


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(
        0, CONFIG_TINY.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)


def _jax_mesh(shape):
    return build_mesh(shape, ("data", "model"), devices=jax.devices()[:int(np.prod(shape))])


@pytest.fixture(scope="module")
def jax_side(inputs, tokens):
    """JAX's outputs and gradients of every case, its collective counts, and
    the two-step losses of each strategy's train step (on the (2, 4) mesh)."""
    q, k, v, dout = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "dout"))
    out = {}
    for mesh_name, shape in MESHES.items():
        mesh = _jax_mesh(shape)
        for st, (make_jax, _) in STRATEGIES.items():
            fn = make_jax(mesh, jax_logical.RULES_DP_SP)
            for causal in (False, True):
                run = jax.jit(lambda a, b, c, fn=fn, causal=causal: fn(a, b, c, causal=causal))
                o, vjp = jax.vjp(run, q, k, v)
                out[mesh_name, st, causal] = [np.asarray(t) for t in (o, *vjp(dout))]
            out["counts", mesh_name, st] = jax_counts(
                jax.jit(lambda a, b, c, fn=fn: fn(a, b, c, causal=True)), q, k, v)
    for causal in (False, True):
        mask = jax_causal_mask(S) if causal else None
        o, vjp = jax.vjp(lambda a, b, c, mask=mask: jax_dense(a, b, c, mask=mask), q, k, v)
        out["dense", causal] = [np.asarray(t) for t in (o, *vjp(dout))]

    mesh = _jax_mesh((2, 4))
    sh = mesh_sharding(mesh, "data", None)
    batch = {"inputs": put(tokens[:, :-1], sh), "targets": put(tokens[:, 1:], sh)}
    for st, (make_jax, _) in STRATEGIES.items():
        cfg = dataclasses.replace(jax_tf.CONFIG_TINY,
                                  attn_fn=make_jax(mesh, jax_logical.RULES_DP_SP))
        state, state_sh = jax_pipeline.sharded_train_state(
            jax_tf.Transformer(cfg), optax.adamw(3e-4), batch["inputs"],
            {"params": jax.random.key(0)}, mesh, jax_logical.RULES_DP_SP)
        if st == "ring":
            out["init"] = jax.tree.map(np.asarray, state.params)
        step = jax_pipeline.make_train_step(
            state_sh, {k_: sh for k_ in batch}, mesh, jax_logical.RULES_DP_SP,
            loss_fn=jax_tf.next_token_loss, donate_state=False)
        losses = []
        for _ in range(TRAIN_STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
        out["train", st] = losses
    return out


def _port_body(mesh, inputs, sd, tokens, train):
    """Every case on this mesh: outputs, gradients, the output placements
    and the collectives of one forward; with ``train``, each strategy's
    two-step losses."""
    torch.set_num_threads(1)
    q, k, v, dout = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v", "dout"))
    res = {}
    for st, (_, make) in STRATEGIES.items():
        fn = make(mesh, RULES_DP_SP)
        for causal in (False, True):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, causal=causal)
            grads = torch.autograd.grad(o.full_tensor(), leaves, dout)
            res[st, causal] = [t.detach().numpy() for t in (o.full_tensor(), *grads)]
            res["placements", st, causal] = [repr(p) for p in o.placements]
        res["counts", st] = collective_counts(lambda: fn(q, k, v, causal=True))
    # CommDebugMode's module hooks are global while any rank counts: no rank
    # runs a model until every rank has left it.
    dist.barrier()
    if train:
        batch = {"inputs": torch.from_numpy(tokens[:, :-1]).long(),
                 "targets": torch.from_numpy(tokens[:, 1:]).long()}
        for st, (_, make) in STRATEGIES.items():
            cfg = dataclasses.replace(CONFIG_TINY, attn_fn=make(mesh, RULES_DP_SP))
            model = Transformer(cfg, device="cpu")
            model.load_state_dict({n: torch.from_numpy(a) for n, a in sd.items()})
            state = sharded_train_state(model, adamw(3e-4), mesh=mesh, rules=RULES_DP_SP)
            step = make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=RULES_DP_SP)
            res["train", st] = [float(step(state, batch)[1]) for _ in range(TRAIN_STEPS)]
    return res


@pytest.fixture(scope="module")
def port(inputs, tokens, jax_side):
    sd = {n: t.numpy() for n, t in from_flax_params(jax_side["init"], CONFIG_TINY).items()}
    return {name: run_on_threads(_port_body, shape, ("data", "model"),
                                 args=(inputs, sd, tokens, name == "2x4"))
            for name, shape in MESHES.items()}


@pytest.mark.parametrize("mesh,strategy,causal", CASES)
def test_outputs_equal_jax_and_dense(mesh, strategy, causal, port, jax_side):
    got = port[mesh][strategy, causal][0]
    np.testing.assert_allclose(got, jax_side[mesh, strategy, causal][0], **OUT_TOL)
    np.testing.assert_allclose(got, jax_side["dense", causal][0], **OUT_TOL)


@pytest.mark.parametrize("mesh,strategy,causal", CASES)
def test_gradients_equal_jax_and_dense(mesh, strategy, causal, port, jax_side):
    for i, name in enumerate(("dq", "dk", "dv"), 1):
        got = port[mesh][strategy, causal][i]
        np.testing.assert_allclose(got, jax_side[mesh, strategy, causal][i], err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(got, jax_side["dense", causal][i], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_output_stays_sequence_split(strategy, port):
    for mesh in MESHES:
        for causal in (False, True):
            assert port[mesh]["placements", strategy, causal] == ["Shard(dim=0)", "Shard(dim=1)"]


@pytest.mark.parametrize("mesh", MESHES)
def test_collectives_are_what_the_designs_say(mesh, port, jax_side):
    """The ring: n − 1 hops of k and of v, counted as collective-permutes,
    no all-to-all. Ulysses: four all-to-alls (q, k, v in, the output back),
    no permute. JAX's programs hold the same kinds (its scanned ring counts
    the loop body's two permutes once)."""
    n = MESHES[mesh][1]
    ring, uly = port[mesh]["counts", "ring"], port[mesh]["counts", "ulysses"]
    assert ring["collective-permute"] == 2 * (n - 1) and ring["all-to-all"] == 0
    assert uly["all-to-all"] == 4 and uly["collective-permute"] == 0
    jring, july = jax_side["counts", mesh, "ring"], jax_side["counts", mesh, "ulysses"]
    assert jring["collective-permute"] >= 1 and jring["all-to-all"] == 0
    assert july["all-to-all"] >= 2 and july["collective-permute"] == 0


def _guards(mesh):
    q = torch.zeros(2, 8, 6, 4)
    seen = []
    for call in (
        lambda: ulysses_attention(q, q, q, mesh=mesh, axis="model", heads_axis="model"),
        # 6 heads over a model axis of 4.
        lambda: ulysses_attention(q, q, q, mesh=mesh, axis="model"),
        lambda: make_ulysses_attn_fn(mesh, RULES_DP_TP_SP),
    ):
        try:
            call()
            seen.append(None)
        except ValueError as exc:
            seen.append(str(exc))
    return seen


def test_ulysses_refuses_what_jax_refuses():
    """``heads_axis == axis``, per-rank heads not divisible by the axis,
    rules mapping SEQ and HEADS to one axis: ValueError in both packages,
    with the same messages."""
    got = run_on_threads(_guards, (2, 4), ("data", "model"))
    mesh = _jax_mesh((2, 4))
    q = jnp.zeros((2, 8, 6, 4))
    want = []
    for call in (
        lambda: jax_ulysses(q, q, q, mesh=mesh, axis="model", heads_axis="model"),
        lambda: jax_ulysses(q, q, q, mesh=mesh, axis="model"),
        lambda: jax_ulysses_fn(mesh, jax_logical.RULES_DP_TP_SP),
    ):
        with pytest.raises(ValueError) as exc:
            call()
        want.append(str(exc.value))
    assert got == want


def _heads_axis_body(mesh, inputs):
    """Heads already split over ``data`` (batch whole), the sequence over
    ``model``: Ulysses splits the remaining heads over ``model``."""
    q, k, v = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v"))
    rules = ((SEQ, "model"), (HEADS, "data"))
    out = make_ulysses_attn_fn(mesh, rules)(q, k, v, causal=True)
    return out.full_tensor().numpy(), [repr(p) for p in out.placements]


def test_ulysses_with_a_heads_axis(inputs):
    out, placements = run_on_threads(_heads_axis_body, (2, 2), ("data", "model"),
                                     args=(inputs,))
    assert placements == ["Shard(dim=2)", "Shard(dim=1)"]
    q, k, v = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v"))
    want = dot_product_attention(q, k, v, mask=causal_mask(S)).numpy()
    np.testing.assert_allclose(out, want, **OUT_TOL)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_train_step_under_rules_dp_sp_equals_jax(strategy, port, jax_side):
    """``CONFIG_TINY`` with the strategy as its ``attn_fn``, two adamw
    steps on the (2, 4) mesh from JAX's init: the losses JAX's step gives
    (rtol 1e-5), and descending."""
    got, want = port["2x4"]["train", strategy], jax_side["train", strategy]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_fused_loss_head_gradient_sums_in_fp32():
    """Fault F8: the chunked loss cast ``lm_head`` to the compute dtype once,
    so its chunks' gradients added up in bf16 (at S=8192 over a mesh, 5.7%
    of the head's gradient, relative Frobenius, on the card). It now casts
    inside each chunk, as JAX's ``chunk_total`` does: the head's gradient is
    the fp32 sum of the chunks' own gradients."""
    from learning_jax_sharding_tpu_torch.models.transformer import (
        _chunk_total,
        fused_next_token_loss,
    )

    cfg = dataclasses.replace(CONFIG_TINY, max_seq_len=128, dtype=torch.bfloat16)
    model = Transformer(cfg, device="cpu", seed=0)
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 129)))
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    hidden = model(batch["inputs"], return_hidden=True).detach()
    weight = model.lm_head.weight
    fused_next_token_loss(hidden, batch, model, chunk_size=16).backward()
    want = torch.zeros_like(weight)
    for start in range(0, 128, 16):
        part = _chunk_total(hidden[:, start:start + 16], batch["targets"][:, start:start + 16],
                            weight) / hidden[..., 0].numel()
        want += torch.autograd.grad(part, weight)[0]
    assert weight.grad.dtype == torch.float32
    torch.testing.assert_close(weight.grad, want, rtol=1e-5, atol=1e-9)



def test_backward_runs_on_the_calling_thread_under_a_mesh():
    """Fault F9 (found on four NCCL cards): CUDA autograd ran the backward,
    and a checkpoint's recompute in it, on its device thread, where this
    thread's mesh binding (and on newer torch the implicit-replication
    flag) does not hold: the recomputed chunk logits came out whole where
    the forward had split them over ``model``, and the checkpoint refused
    the mismatch. Under ``activate`` a backward now runs on the calling
    thread (a CPU backward always does, so a gloo rank shows the switch,
    not the failure)."""
    from tests import _torch_mesh_bodies as bodies

    assert run_on_mesh(bodies.backward_thread_body, (1, 2), ("data", "model")) == (
        True, False, True)
