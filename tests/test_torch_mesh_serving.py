"""The port's continuous engine over a mesh against the JAX engine over one.

``CONFIG_TINY`` in fp32 with the blocked decode backend, on a (2, 2)
``data`` × ``model`` mesh: the JAX ``make_continuous_engine(cfg, mesh22,
rules, ...)`` (decode attention and the int4 kernels under ``shard_map``,
Pallas in interpret mode) and the port's, its four ranks threads of this
process (``parallel.run_on_threads``, the way one card carries a (2, 2)
mesh), serve the same queues with the same JAX-initialised weights (and
int4 tree), carried across by ``from_flax_params``. Each case compares the
tokens request for request and the whole of JAX's ``last_stats``; the split,
mixed (horizon 2), self-draft speculative, sampled and int4-fused cases run
under ``RULES_DP_TP``, the paged ones (a warm prefix on a second serve, and
recompute preemption over a small pool with the int8 KV cache) under
``RULES_TP_SERVING``. Sampled cases draw from the same key on both sides
and require equal tokens, as ``tests/test_torch_serving_modes.py`` does.

Then: every rank serves the same tokens and stats; the mesh engine equals
the port's one-device engine (tokens, stats, model and draft calls,
dispatches) and, fed requests stamped out of add order under a starving
token budget, retires each at the same step; the recovery policies (a
deadline eviction, a shed, a sticky-fault quarantine) take the one-device
engine's decisions on every rank, and on a mesh smaller than its world (a
second thread world); a fault raised inside a mesh dispatch propagates;
paged serving under ``RULES_DP_TP`` raises ``ValueError`` as
JAX's does; ragged ``make_generate_fn`` and ragged speculative generate over
the mesh give JAX's tokens. The JAX side runs once a module, the port's
mesh side in one thread world.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import generate as jax_generate
from learning_jax_sharding_tpu.models import speculative as jax_spec
from learning_jax_sharding_tpu.models.serving import make_continuous_engine as jax_engine
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.parallel import logical as jax_logical
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.serving import make_continuous_engine
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from tests import _torch_mesh_bodies as bodies
from tests.test_torch_quantized_generate import GROUP, _jax_quantize_tree

torch.set_num_threads(1)

NEW = 4
COMMON = dict(batch_size=2, max_new_tokens=NEW, refill_chunk=4, decode_block_steps=4)
SAMPLED = dict(temperature=0.8, top_k=16, top_p=0.9, min_p=0.05)
DRAFT = dict(num_layers=1, hidden=64)
# Arrival stamps out of add order (one request unstamped) under a starving
# token budget: the refill queue's order decides each retirement step.
STAMPED = dict(engine=dict(COMMON, mixed=True, token_budget=3, batch_size=4),
               stamps=(None, 3.0, 1.0, 2.0))
JAX_CFG = dataclasses.replace(JAX_TINY, dtype=jnp.float32, decode_attention="blocked",
                              quantization_group=GROUP)
BASE = dict(decode_attention="blocked", quantization_group=GROUP)

# name → (rules, queue, engine arguments, case fields): the tree served
# ("float" or "int4"), the draft, the sampling key, the int8 KV cache and
# the serve calls.
CASES = {
    "split": ("RULES_DP_TP", "mixed", {}, {}),
    "mixed_horizon2": ("RULES_DP_TP", "mixed", dict(mixed=True, horizon=2), {}),
    "spec_self_draft": ("RULES_DP_TP", "mixed", dict(num_draft=2), dict(draft="self")),
    "sampled": ("RULES_DP_TP", "mixed", SAMPLED, dict(rng=5)),
    "int4_fused": ("RULES_DP_TP", "mixed", dict(dequantize="fused"), dict(tree="int4")),
    "paged_prefix_warm": ("RULES_TP_SERVING", "system",
                          dict(paged_pages=16, page_size=8, prefix_cache=True, refill_chunk=8),
                          dict(calls=2)),
    "paged_preempt_int8": ("RULES_TP_SERVING", "mixed", dict(paged_pages=3, page_size=8),
                           dict(kv_int8=True)),
}


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CONFIG_TINY.vocab_size, size=(n,)).astype(np.int32) for n in sizes]


def _queues():
    system = _prompts(9, (16,))[0]
    return {"mixed": _prompts(11, (3, 9, 5, 12)),
            "system": [np.concatenate([system, tail]) for tail in _prompts(19, (4,) * 4)]}


def _init(cfg, seed):
    model = JaxTransformer(cfg)
    probe = np.zeros((2, 8), np.int32)
    variables = jax.jit(lambda r, t: model.init({"params": r}, t))(jax.random.key(seed), probe)
    return jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))


@functools.cache
def _jax_trees():
    params = _init(JAX_CFG, 3)
    return {"float": params, "int4": _jax_quantize_tree(params, 4),
            "draft": _init(dataclasses.replace(JAX_CFG, **DRAFT), 7)}


@functools.cache
def _port_trees():
    trees = _jax_trees()
    cfg = dataclasses.replace(CONFIG_TINY, **BASE)
    return {"float": from_flax_params(trees["float"], cfg),
            "int4": from_flax_params(trees["int4"], cfg),
            "draft": from_flax_params(trees["draft"], dataclasses.replace(cfg, **DRAFT))}


def _ragged_inputs():
    prompt = np.random.default_rng(5).integers(1, CONFIG_TINY.vocab_size, (4, 8)).astype(np.int32)
    return prompt, np.array([3, 8, 5, 1], np.int32)


def _port_cases():
    """The cases as ``bodies.serve_cases`` reads them."""
    out = {}
    for name, (rules, queue, engine, fields) in CASES.items():
        cfg = dict(BASE, **({"kv_cache_dtype": torch.int8} if fields.get("kv_int8") else {}))
        out[name] = dict(rules=rules, queue=queue, cfg=cfg, engine={**COMMON, **engine},
                         tree=fields.get("tree", "float"), draft=fields.get("draft"),
                         draft_cfg=DRAFT, rng=fields.get("rng"), calls=fields.get("calls", 1))
    return out


@pytest.fixture(scope="module")
def jax_results(mesh22):
    trees, queues = _jax_trees(), _queues()
    out = {"engine": {}}
    with jax.default_matmul_precision("float32"):
        for name, (rules, queue, engine, fields) in CASES.items():
            cfg = JAX_CFG
            if fields.get("kv_int8"):
                cfg = dataclasses.replace(cfg, kv_cache_dtype=jnp.int8)
            kw = {**COMMON, **engine}
            if fields.get("draft") == "self":
                kw["draft_config"] = cfg
            serve = jax_engine(cfg, mesh22, getattr(jax_logical, rules), **kw)
            params = trees[fields.get("tree", "float")]
            key = None if fields.get("rng") is None else jax.random.key(fields["rng"])
            got = {"tokens": [], "stats": []}
            for _ in range(fields.get("calls", 1)):
                got["tokens"].append(bodies._lists(serve(
                    params, queues[queue], rng=key,
                    draft_params=params if fields.get("draft") else None)))
                got["stats"].append(serve.last_stats)
            out["engine"][name] = got
        paged = jax_engine(JAX_CFG, mesh22, jax_logical.RULES_DP_TP, paged_pages=9,
                           page_size=16, **COMMON)
        with pytest.raises(ValueError, match="cannot shard the batch"):
            paged(trees["float"], queues["mixed"])
        prompt, lengths = _ragged_inputs()
        out["ragged"] = np.asarray(jax_generate.make_generate_fn(
            JAX_CFG, mesh22, jax_logical.RULES_DP_TP, max_new_tokens=NEW, ragged=True,
        )(trees["float"], jnp.asarray(prompt), jax.random.key(0), lengths))
        out["spec_ragged"] = np.asarray(jax_spec.make_speculative_generate_fn(
            JAX_CFG, dataclasses.replace(JAX_CFG, **DRAFT), mesh22, jax_logical.RULES_DP_TP,
            max_new_tokens=NEW, num_draft=2, ragged=True,
        )(trees["float"], trees["draft"], jnp.asarray(prompt), lengths=lengths))
    return out


@pytest.fixture(scope="module")
def port():
    prompt, lengths = _ragged_inputs()
    generate = dict(cfg=BASE, engine=COMMON, prompt=prompt, lengths=lengths, new=NEW,
                    draft_cfg=DRAFT)
    stamped = dict(STAMPED, prompts=_queues()["mixed"])
    policies = dict(engine=COMMON, prompts=_queues()["mixed"])
    return run_on_threads(bodies.mesh_serving_body, (2, 2), ("data", "model"),
                          args=(_port_cases(), _port_trees(), _queues(), generate, stamped,
                                policies))


@pytest.fixture(scope="module")
def one_device():
    return bodies.serve_cases(None, _port_cases(), _port_trees(), _queues())


@pytest.mark.parametrize("case", list(CASES))
def test_engine_over_the_mesh_equals_jax(case, port, jax_results):
    got, want = port[0]["engine"][case], jax_results["engine"][case]
    assert got["tokens"] == want["tokens"]
    for g, w in zip(got["stats"], want["stats"]):
        if w is None:
            assert g is None
        else:
            assert {k: g[k] for k in w} == w
    if case == "paged_prefix_warm":
        assert got["stats"][1]["prefix_hits"] == len(_queues()["system"])
    if case == "paged_preempt_int8":
        assert got["stats"][0]["preemptions"] > 0
    if case == "spec_self_draft":
        assert got["stats"][0]["spec_accept_rate"] == 1.0


@pytest.mark.parametrize("case", [*CASES, "stamped", "policies"])
def test_every_rank_serves_the_same(case, port):
    ranks = port[1]
    assert len(ranks) == 4
    for rank in ranks[1:]:
        assert rank[case] == ranks[0][case]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_equals_one_device_engine(case, port, one_device):
    assert port[0]["engine"][case] == one_device[case]


def test_stamped_arrivals_over_the_mesh_equal_one_device(port):
    """``add_request(arrival_t=...)`` out of add order: the mesh engine
    retires each request at the step the one-device engine does (which
    ``test_torch_serving_modes`` holds to JAX's)."""
    cfg = dataclasses.replace(CONFIG_TINY, **BASE)
    eng = make_continuous_engine(cfg, device="cpu", **STAMPED["engine"]).engine
    want = bodies.stamped_stream(eng, _port_trees()["float"], _queues()["mixed"],
                                 STAMPED["stamps"])
    assert port[0]["stamped"] == want


def test_policies_over_the_mesh_equal_one_device(port):
    """A deadline eviction, a shed and a sticky-fault quarantine on the
    (2, 2) thread ranks: every rank takes the one-device engine's decisions
    (statuses, surviving tokens, every count of the registry), which
    ``test_torch_engine_policies`` holds to the JAX engine's."""
    want = bodies.policy_cases(None, BASE, COMMON, _port_trees()["float"], _queues()["mixed"])
    got = port[0]["policies"]
    assert got == want
    assert got["deadline"][0][1][0] == "deadline" and got["deadline"][0][0][0] == "ok"
    assert got["shed"][1]["engine_shed_total"] == 1 and len(got["shed"][2]) == 1
    statuses = {rid: r[0] for rid, r in got["quarantine"][0].items()}
    assert statuses == {0: "ok", 1: "poisoned", 2: "ok", 3: "ok"}
    assert got["quarantine"][1]["engine_quarantined_total"] == 1


def test_policies_on_a_mesh_smaller_than_the_world():
    """The policies' agreements run in the mesh's own groups: a (1, 2) mesh
    engine on two of four thread ranks serves, evicts, sheds and
    quarantines while the other two ranks each serve alone, and every rank
    takes the one-device engine's decisions."""
    want = bodies.policy_cases(None, BASE, COMMON, _port_trees()["float"], _queues()["mixed"])
    ranks = run_on_threads(bodies.small_mesh_policy_body, (2, 2), ("data", "model"),
                           args=(BASE, COMMON, _port_trees()["float"], _queues()["mixed"]))
    assert [inside for inside, _ in ranks] == [True, True, False, False]
    for _, got in ranks:
        assert got == want
    assert {rid: r[0] for rid, r in want["quarantine"][0].items()} == {
        0: "ok", 1: "poisoned", 2: "ok", 3: "ok"}


def test_a_fault_inside_a_mesh_dispatch_propagates():
    """A NaN trap raised past the dispatch seam is quarantined on one device
    but propagates over a mesh, where the other ranks may already wait in
    the dispatch's next collective."""
    args = (BASE, COMMON, _port_trees()["float"], _queues()["mixed"][:2])
    assert bodies.mid_dispatch_fault(None, *args) == ("recovered", 1)
    ranks = run_on_threads(bodies.mid_dispatch_fault_body, (1, 2), ("data", "model"),
                           args=args)
    assert ranks == [("raised", "non-finite values in a model call's output")] * 2


def test_paged_under_dp_tp_raises_as_jax(port, jax_results):
    assert "cannot shard the batch" in port[0]["paged_dp_tp"]


@pytest.mark.parametrize("fn", ["ragged", "spec_ragged"])
def test_ragged_generate_over_the_mesh_equals_jax(fn, port, jax_results):
    np.testing.assert_array_equal(port[0][fn], jax_results[fn])
