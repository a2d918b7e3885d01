"""The port's beam search against the JAX package's, hypothesis for hypothesis.

Weights: CONFIG_TINY trained a few AdamW steps in JAX once for the module
(random weights give near-uniform logits, where beams tie), carried across
with ``from_flax_params``. Each case runs the JAX ``make_beam_search_fn`` on a
(1, 1) mesh and the port's on the CPU, fp32, and holds the port to JAX's
tokens exactly and its scores within ``SCORE_ATOL``. Every comparison also
reports the smallest gap between the K-th and the (K+1)-th candidate of any
live top-k the port took, so a near tie shows in the failure message
instead of passing for a fault. The blocked backend runs the decode
attention kernel's plain version here; JAX's dense path is its oracle (the
two backends compute one function, which ``tests/test_torch_generate.py``
holds against JAX's Pallas kernel).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learning_jax_sharding_tpu.models import beam as jax_beam
from learning_jax_sharding_tpu.models import quantize as jq
from learning_jax_sharding_tpu.models.generate import make_generate_fn as jax_generate_fn
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
    next_token_loss as jax_next_token_loss,
)
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP as JAX_RULES_DP_TP
from learning_jax_sharding_tpu_torch.models import beam
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_TP

torch.set_num_threads(1)

NEW = 6
# fp32 logits differ between the packages by accumulation order (~1e-6);
# a score sums NEW log-probabilities.
SCORE_ATOL = 1e-4
LENGTHS = [8, 5, 3, 7]


@pytest.fixture(scope="module")
def setup():
    """Trained JAX params (5 AdamW steps on a fixed batch), their port
    state dict, prompts, and a one-device JAX mesh."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, JAX_TINY.vocab_size, size=(8, 33)).astype(np.int32)
    model = JaxTransformer(JAX_TINY)
    params = nn.meta.unbox(model.init(jax.random.key(0), jnp.asarray(tokens[:, :-1]))["params"])
    opt = optax.adamw(3e-3)
    opt_state = opt.init(params)
    batch = {"inputs": jnp.asarray(tokens[:, :-1]), "targets": jnp.asarray(tokens[:, 1:])}

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: jax_next_token_loss(model.apply({"params": p}, batch["inputs"]), batch)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(5):
        params, opt_state = step(params, opt_state)
    params = jax.tree.map(np.asarray, params)
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    prompt = tokens[:4, :8].copy()
    ragged = prompt.copy()
    for b, n in enumerate(LENGTHS):
        ragged[b, n:] = 0
    # EOS: the id row 0's greedy decode emits second, so the pool fills.
    greedy = jax_generate_fn(JAX_TINY, mesh, JAX_RULES_DP_TP, max_new_tokens=NEW)
    eos = int(np.asarray(greedy(params, jnp.asarray(prompt)))[0, 9])
    return dict(params=params, sd=from_flax_params(params, CONFIG_TINY), mesh=mesh,
                prompt=prompt, ragged=ragged, eos=eos)


class GapRecorder:
    """Wraps ``beam.top_k`` to record, for each top-k over live
    candidates, the gap between its K-th and (K+1)-th value."""

    def __init__(self, monkeypatch):
        self.gaps = []
        inner = beam.top_k

        def recorded(x, k):
            values, _ = torch.sort(x, dim=-1, descending=True, stable=True)
            if values.shape[-1] > k:
                kth, nxt = values[..., k - 1], values[..., k]
                live = kth > beam.NEG_INF / 2
                if live.any():
                    self.gaps.append(float((kth - nxt)[live].min()))
            return inner(x, k)

        monkeypatch.setattr(beam, "top_k", recorded)

    @property
    def smallest(self) -> float:
        return min(self.gaps) if self.gaps else float("inf")


def _jax(setup, cfg=JAX_TINY, tree=None, lengths=None, **kw):
    fn = jax_beam.make_beam_search_fn(cfg, setup["mesh"], JAX_RULES_DP_TP, **kw)
    prompt = setup["ragged" if lengths is not None else "prompt"]
    tree = setup["params"] if tree is None else tree
    with jax.default_matmul_precision("float32"):
        if lengths is None:
            out, scores = fn(tree, jnp.asarray(prompt))
        else:
            out, scores = fn(tree, jnp.asarray(prompt), lengths=jnp.asarray(lengths, jnp.int32))
    return np.asarray(out), np.asarray(scores)


def _port(setup, cfg=CONFIG_TINY, sd=None, lengths=None, **kw):
    fn = beam.make_beam_search_fn(cfg, device="cpu", **kw)
    prompt = setup["ragged" if lengths is not None else "prompt"]
    out, scores = fn(setup["sd"] if sd is None else sd, prompt, lengths=lengths)
    return out.numpy(), scores.numpy()


def _held(port, ref, gaps, what):
    msg = f"{what}; smallest K-th/(K+1)-th live gap {gaps.smallest:.3e}"
    np.testing.assert_array_equal(port[0], ref[0], err_msg=msg)
    np.testing.assert_allclose(port[1], ref[1], atol=SCORE_ATOL, rtol=0, err_msg=msg)


@pytest.mark.parametrize("backend", ["dense", "blocked"])
@pytest.mark.parametrize("beam_size", [1, 3, 4])
def test_beam_matches_jax(setup, monkeypatch, beam_size, backend):
    gaps = GapRecorder(monkeypatch)
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention=backend, decode_block_k=16)
    port = _port(setup, cfg, beam_size=beam_size, max_new_tokens=NEW)
    ref = _jax(setup, beam_size=beam_size, max_new_tokens=NEW)
    _held(port, ref, gaps, f"beam {beam_size}, {backend}")


def test_beam1_is_greedy(setup):
    greedy = make_generate_fn(CONFIG_TINY, max_new_tokens=NEW, device="cpu")
    out, _ = _port(setup, beam_size=1, max_new_tokens=NEW)
    np.testing.assert_array_equal(out, greedy(setup["sd"], setup["prompt"]).numpy())


@pytest.mark.parametrize("backend", ["dense", "blocked"])
def test_eos_finished_pool_matches_jax(setup, monkeypatch, backend):
    gaps = GapRecorder(monkeypatch)
    eos = setup["eos"]
    kw = dict(beam_size=3, max_new_tokens=NEW, eos_id=eos, length_penalty=0.6)
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention=backend, decode_block_k=16)
    port = _port(setup, cfg, **kw)
    ref = _jax(setup, **kw)
    _held(port, ref, gaps, f"eos {eos}, {backend}")
    assert (port[0][:, 8:] == eos).any(), "no hypothesis finished"


@pytest.mark.parametrize("backend", ["dense", "blocked"])
def test_ragged_matches_jax(setup, monkeypatch, backend):
    gaps = GapRecorder(monkeypatch)
    eos = setup["eos"]
    kw = dict(beam_size=2, max_new_tokens=NEW, eos_id=eos, ragged=True)
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention=backend, decode_block_k=16)
    port = _port(setup, cfg, lengths=LENGTHS, **kw)
    ref = _jax(setup, lengths=LENGTHS, **kw)
    _held(port, ref, gaps, f"ragged, {backend}")


def test_int8_dequantize_matches_jax(setup, monkeypatch):
    """An int8 tree dequantized inside every model call, both packages on
    the same quantized tree."""
    gaps = GapRecorder(monkeypatch)
    jtree = jax.tree.map(np.asarray, _jax_int8_tree(setup["params"], jax.jit(jq.quantize_leaf)))
    kw = dict(beam_size=3, max_new_tokens=NEW, dequantize=True)
    port = _port(setup, sd=from_flax_params(jtree, CONFIG_TINY), **kw)
    ref = _jax(setup, tree=jtree, **kw)
    _held(port, ref, gaps, "int8 dequantize")


def _jax_int8_tree(params, leaf):
    """``quantize_tree``'s walk with a jitted int8 leaf (its eager ops
    compile one by one)."""

    def walk(node, prefix):
        return {
            k: leaf(v) if not isinstance(v, dict) and jq.default_match(prefix + (k,), v)
            else walk(v, prefix + (k,)) if isinstance(v, dict) else v
            for k, v in node.items()
        }

    return walk(params, ())


def test_errors(setup):
    with pytest.raises(ValueError, match="beam_size"):
        beam.make_beam_search_fn(CONFIG_TINY, beam_size=0, max_new_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="2\\*beam_size"):
        beam.make_beam_search_fn(CONFIG_TINY, beam_size=129, max_new_tokens=2, device="cpu")
    paged = dataclasses.replace(CONFIG_TINY, decode_paged=True)
    with pytest.raises(ValueError, match="paged"):
        beam.make_beam_search_fn(paged, beam_size=2, max_new_tokens=2, device="cpu")
    ragged = beam.make_beam_search_fn(CONFIG_TINY, beam_size=2, max_new_tokens=2, ragged=True,
                                      device="cpu")
    with pytest.raises(ValueError, match="lengths"):
        ragged(setup["sd"], setup["prompt"])
    rect = beam.make_beam_search_fn(CONFIG_TINY, beam_size=2, max_new_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="lengths"):
        rect(setup["sd"], setup["prompt"], lengths=[8] * 4)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        beam.make_beam_search_fn(CONFIG_TINY, beam_size=2, max_new_tokens=60,
                                 device="cpu")(setup["sd"], setup["prompt"])


def test_top_k_breaks_ties_as_jax():
    x = np.array([[0.5, -1e9, 0.5, 2.0, -1e9, 0.5, -1e9]], np.float32)
    values, idx = beam.top_k(torch.from_numpy(x), 5)
    j_values, j_idx = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(j_values))


def _mesh_beam_body(mesh, sd, prompt, lengths, kw):
    """Rank body: the port's beam search over a (2, 2) mesh (RULES_DP_TP),
    rectangular and ragged, each rank's result."""
    fn = beam.make_beam_search_fn(CONFIG_TINY, mesh, RULES_DP_TP, **kw)
    out, scores = fn(sd, prompt)
    rfn = beam.make_beam_search_fn(CONFIG_TINY, mesh, RULES_DP_TP, ragged=True, **kw)
    r_out, r_scores = rfn(sd, prompt, lengths=lengths)
    return out, scores, r_out, r_scores


def test_mesh_threads_match_one_device(setup):
    """Four thread ranks on a (2, 2) data × model mesh: the cache split over
    rows and heads, the reorder on each rank's rows, the logits gathered
    whole. Tokens equal to one device's (and so to JAX's), scores within
    the tolerance."""
    eos = setup["eos"]
    kw = dict(beam_size=3, max_new_tokens=NEW, eos_id=eos)
    ragged = setup["ragged"]
    out, scores, r_out, r_scores = run_on_threads(
        _mesh_beam_body, (2, 2), ("data", "model"),
        args=(setup["sd"], setup["prompt"], LENGTHS, kw))
    one = _port(setup, **kw)
    np.testing.assert_array_equal(out.numpy(), one[0])
    np.testing.assert_allclose(scores.numpy(), one[1], atol=SCORE_ATOL, rtol=0)
    r_one = beam.make_beam_search_fn(CONFIG_TINY, device="cpu", ragged=True, **kw)(
        setup["sd"], ragged, lengths=LENGTHS)
    np.testing.assert_array_equal(r_out.numpy(), r_one[0].numpy())
    np.testing.assert_allclose(r_scores.numpy(), r_one[1].numpy(), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(one[0], _jax(setup, **kw)[0])


def _mesh_refusal_body(mesh, sd, prompt):
    """Rank body: a batch of 3 rows over a data axis of 2 → the error."""
    fn = beam.make_beam_search_fn(CONFIG_TINY, mesh, RULES_DP_TP, beam_size=2,
                                  max_new_tokens=2)
    try:
        fn(sd, prompt[:3])
    except ValueError as exc:
        return str(exc)
    return None


def test_mesh_refuses_batch_not_a_multiple_of_the_data_axis(setup):
    """A row's beams must stay in its rank: B not a multiple of the data
    axis is refused on every rank before any collective."""
    msg = run_on_threads(_mesh_refusal_body, (2, 2), ("data", "model"),
                         args=(setup["sd"], setup["prompt"]))
    assert msg is not None and "B=3" in msg and "(2)" in msg, msg
