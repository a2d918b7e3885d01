"""The engine's decoding modes against the JAX engine: speculative decoding,
the mixed refill+decode scheduler, the multi-step horizon and keyed
sampling.

Both engines serve the same queues with the same weights (``CONFIG_TINY``
in fp32, a JAX init carried across by ``from_flax_params``) through two
slots, and every case compares tokens request for request and the whole of
JAX's ``last_stats`` (page high-water, preemptions, prefix hits and reuse,
``spec_accepted`` / ``spec_proposed`` / ``spec_accept_rate``). The JAX
engine runs on a one-device mesh with ``RULES_TP_SERVING`` (its blocked
backend through the Pallas kernel in interpret mode); each JAX run is made
once a module. The port runs on the CPU, where decode attention takes its
plain version.

Sampled cases draw from the same key (``rng=5``) on both sides and require
EQUAL tokens. The rule behind that: the port's threefry bits and uniforms
are bit-equal to JAX's, its Gumbel noise within 2e-6 (``test_torch_prng``)
and its fp32 logits within about 1e-6 of JAX's, so a draw can differ only
where the two best Gumbel-perturbed scores lie within about 1e-5 of each
other, a chance near 1e-5 a draw; these queues draw a few hundred tokens
and meet none.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models.serving import make_continuous_engine as jax_engine
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_TP_SERVING
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.serving import make_continuous_engine
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from tests import _torch_mesh_bodies as bodies
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

NEW = 6
COMMON = dict(batch_size=2, max_new_tokens=NEW, refill_chunk=4)
SAMPLED = dict(temperature=0.8, top_k=16, top_p=0.9, rng=5)
JAX_F32 = dataclasses.replace(JAX_TINY, dtype=jnp.float32)
JAX_DRAFT = dataclasses.replace(JAX_F32, num_layers=1, hidden=64)
PORT_DRAFT = dataclasses.replace(CONFIG_TINY, num_layers=1, hidden=64)


def _init(cfg, seed):
    model = JaxTransformer(cfg)
    probe = np.zeros((2, 8), np.int32)
    variables = jax.jit(lambda r, t: model.init({"params": r}, t))(jax.random.key(seed), probe)
    return jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))


@functools.cache
def _jax_params(draft=False):
    return _init(JAX_DRAFT, 7) if draft else _init(JAX_F32, 3)


@functools.cache
def _params(draft=False):
    return from_flax_params(_jax_params(draft), PORT_DRAFT if draft else CONFIG_TINY)


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CONFIG_TINY.vocab_size, size=(n,)).astype(np.int32) for n in sizes]


def _queue(name):
    if name == "mixed":                    # the JAX tests' seven prompts
        return _prompts(11, (3, 9, 5, 1, 12, 7, 4))
    if name == "prefix":                   # repeats and a same-first-page variant
        base = _prompts(9, (20,))[0]
        variant = base.copy()
        variant[17] += 1
        return [base, variant, base, base.copy(), variant.copy()]
    if name == "long":                     # a 44-token prompt through 8-token chunks
        return _prompts(5, (44,)) + _prompts(11, (3, 5))
    if name == "system":                   # a shared 16-token system prompt
        system = _prompts(9, (16,))[0]
        return [np.concatenate([system, tail]) for tail in _prompts(19, (4,) * 4)]
    raise KeyError(name)


def _draft_kw(draft, jax_side, cfg_mods):
    """The draft's engine arguments and params: ``"weak"`` is a 1-layer
    draft of its own init, ``"self"`` the target itself."""
    if draft is None:
        return {}, None
    if jax_side:
        base = JAX_F32 if draft == "self" else JAX_DRAFT
        params = _jax_params(draft != "self")
    else:
        base = CONFIG_TINY if draft == "self" else PORT_DRAFT
        params = _params(draft != "self")
    return dict(draft_config=dataclasses.replace(base, **cfg_mods)), params


def _serve(jax_side, queue, *, backend="dense", kv_int8=False, draft=None, rng=None,
           calls=1, **kw):
    """Serve ``queue`` ``calls`` times through one engine of either side →
    (outputs of each call, last_stats of each call)."""
    mods = dict(decode_attention=backend)
    if kv_int8:
        mods["kv_cache_dtype"] = jnp.int8 if jax_side else torch.int8
    dkw, dparams = _draft_kw(draft, jax_side, mods)
    if jax_side:
        mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
        serve = jax_engine(dataclasses.replace(JAX_F32, **mods), mesh, RULES_TP_SERVING,
                           **{**COMMON, **kw, **dkw})
        key = None if rng is None else jax.random.key(rng)
        params = _jax_params()
    else:
        serve = make_continuous_engine(dataclasses.replace(CONFIG_TINY, **mods),
                                       device="cpu", **{**COMMON, **kw, **dkw})
        key, params = rng, _params()
    outs, stats = [], []
    for _ in range(calls):
        outs.append([np.asarray(o) for o in serve(params, _queue(queue), rng=key,
                                                  draft_params=dparams)])
        stats.append(serve.last_stats)
    return outs, stats


@functools.cache
def _jax_run(queue, **kw):
    return _serve(True, queue, **kw)


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def _kw(*parts, **extra):
    """The engine arguments of several groups merged."""
    out = {}
    for part in parts:
        out.update(part)
    return {**out, **extra}


WEAK, SELF = dict(draft="weak"), dict(draft="self")
PAGED = dict(backend="blocked", paged_pages=9, page_size=16)
LONG = dict(backend="blocked", paged_pages=16, page_size=8, refill_chunk=8)

# (queue, engine arguments): each case serves its queue through both
# engines and compares tokens and last_stats.
CASES = {
    # speculative decode blocks in the split engine
    "spec_nd1": ("mixed", _kw(WEAK, num_draft=1)),
    "spec_nd2": ("mixed", _kw(WEAK, num_draft=2)),
    "spec_nd3_blocked": ("mixed", _kw(WEAK, num_draft=3, backend="blocked")),
    "spec_nd4": ("mixed", _kw(WEAK, num_draft=4)),
    "spec_self_draft": ("mixed", _kw(SELF, num_draft=2)),
    "spec_paged": ("mixed", _kw(WEAK, PAGED, num_draft=3)),
    "spec_prefix": ("prefix", _kw(WEAK, PAGED, num_draft=2, prefix_cache=True)),
    "spec_int8_kv": ("mixed", _kw(WEAK, num_draft=2, backend="blocked", kv_int8=True)),
    "spec_chained": ("mixed", _kw(WEAK, num_draft=2, decode_block_steps=2, decode_chain=3)),
    # the mixed scheduler
    "mixed": ("mixed", _kw(mixed=True)),
    "mixed_budget_starved": ("mixed", _kw(mixed=True, token_budget=1)),
    "mixed_budget_5": ("mixed", _kw(mixed=True, token_budget=5)),
    "mixed_chained": ("mixed", _kw(mixed=True, decode_chain=3)),
    "mixed_paged_long": ("long", _kw(LONG, mixed=True)),
    "mixed_spec": ("mixed", _kw(WEAK, mixed=True, num_draft=3)),
    "mixed_spec_paged": ("long", _kw(WEAK, LONG, mixed=True, num_draft=2)),
    # the multi-step horizon
    "horizon_budget_3": ("mixed", _kw(mixed=True, token_budget=3, horizon=4)),
    "horizon_paged_long": ("long", _kw(LONG, mixed=True, horizon=4)),
    "horizon_prefix_two_calls": ("system", _kw(LONG, mixed=True, prefix_cache=True,
                                                horizon=4, calls=2)),
    "horizon_spec": ("mixed", _kw(WEAK, mixed=True, num_draft=3, horizon=4)),
    # keyed sampling
    "sampled_split": ("mixed", _kw(SAMPLED)),
    "sampled_spec": ("mixed", _kw(SAMPLED, **WEAK, num_draft=3)),
    "sampled_mixed": ("mixed", _kw(SAMPLED, mixed=True, token_budget=5)),
    "sampled_horizon": ("mixed", _kw(SAMPLED, mixed=True, horizon=4, batch_size=3)),
    "sampled_spec_horizon_paged": ("long", _kw(SAMPLED, **WEAK, **LONG, mixed=True,
                                                num_draft=2, horizon=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_engine(case):
    queue, kw = CASES[case]
    want, want_stats = _jax_run(queue, **kw)
    got, got_stats = _serve(False, queue, **kw)
    for g, w in zip(got, want):
        _assert_same(g, w)
    for g, w in zip(got_stats, want_stats):
        if w is None:
            assert g is None
        else:
            assert {k: g[k] for k in w} == w
    if case == "spec_self_draft":
        assert got_stats[0]["spec_accept_rate"] == 1.0
    if case == "horizon_prefix_two_calls":
        assert got_stats[1]["prefix_hits"] == len(_queue("system"))


@pytest.mark.parametrize("horizon", range(1, 9))
def test_horizon_sweep_matches_mixed(horizon):
    """Every horizon serves the JAX mixed engine's tokens: the plan pads
    nothing and runs only planned links."""
    want, _ = _jax_run("mixed", mixed=True)
    got, _ = _serve(False, "mixed", mixed=True, horizon=horizon)
    _assert_same(got[0], want[0])


def test_horizon_self_draft_fast_forward():
    """Self-draft at horizon 4: rows advance num_draft + 1 tokens a link,
    faster than the planner's optimistic chain cap, and the planned links
    past their drain run with every row frozen: tokens stay the JAX mixed
    engine's and every proposal is accepted."""
    want, _ = _jax_run("mixed", mixed=True)
    got, stats = _serve(False, "mixed", **SELF, mixed=True, num_draft=2, horizon=4)
    _assert_same(got[0], want[0])
    assert stats[0]["spec_accept_rate"] == 1.0


def _eos():
    """A token the dense engine emits as request 0's second generated token."""
    want, _ = _jax_run("mixed")
    return int(want[0][0][len(_queue("mixed")[0]) + 1])


@pytest.mark.parametrize("kw", [dict(mixed=True), dict(WEAK, num_draft=3),
                                dict(WEAK, mixed=True, num_draft=3, horizon=4),
                                dict(mixed=True, horizon=4)],
                         ids=["mixed", "spec", "spec_horizon", "horizon"])
def test_eos_mid_stream(kw):
    """EOS inside a link, a round or a horizon retires the row exactly where
    the JAX mixed engine does (whose tokens the JAX tests pin to every
    mode's)."""
    eos = _eos()
    want, _ = _jax_run("mixed", eos_id=eos, mixed=True)
    got, _ = _serve(False, "mixed", eos_id=eos, **kw)
    _assert_same(got[0], want[0])
    assert any(g[-1] == eos and len(g) < len(p) + NEW
               for g, p in zip(got[0], _queue("mixed")))


def _stream(eng, prompts, order, params, draft_params=None, late_after=1):
    """Add two requests, then one more after every ``late_after`` steps
    (admissions while links and horizons are in flight); → {rid: tokens}."""
    pending = list(order)
    for rid in pending[:2]:
        eng.add_request(prompts[rid], rid=rid)
    pending = pending[2:]
    results, steps = {}, 0
    while eng.has_work() or pending:
        eng.step(params, draft_params)
        steps += 1
        results.update(eng.pop_finished())
        if pending and steps % late_after == 0:
            rid = pending.pop(0)
            eng.add_request(prompts[rid], rid=rid)
    return results


@pytest.mark.parametrize("kw", [dict(mixed=True), dict(mixed=True, horizon=4),
                                dict(WEAK, mixed=True, num_draft=2, horizon=3)],
                         ids=["mixed", "horizon", "spec_horizon"])
def test_streaming_mid_admits(kw):
    """Requests admitted while links and horizons are in flight (the staged
    plan misses and the boundary plans live): the served tokens do not
    move."""
    want, _ = _jax_run("mixed", mixed=True)
    kw = dict(kw)
    dkw, dparams = _draft_kw(kw.pop("draft", None), False, dict(decode_attention="dense"))
    eng = make_continuous_engine(dataclasses.replace(CONFIG_TINY, decode_attention="dense"),
                                 device="cpu", **COMMON, **kw, **dkw).engine
    prompts = _queue("mixed")
    got = _stream(eng, prompts, range(len(prompts)), _params(), dparams)
    for rid, w in enumerate(want[0]):
        np.testing.assert_array_equal(got[rid], w, err_msg=f"request {rid}")


def test_arrival_stamps_order_the_refill_queue():
    """Requests stamped out of add order (``add_request(arrival_t=...)``, the
    first unstamped: the clock, later than every stamp) under a starving
    token budget: the refill queue streams them in stamp order, so each
    request retires at the step JAX's engine retires it, with its tokens."""
    prompts = _queue("mixed")[:4]
    stamps = (None, 3.0, 1.0, 2.0)
    kw = dict(COMMON, mixed=True, token_budget=3, batch_size=4)
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    jax_eng = jax_engine(dataclasses.replace(JAX_F32, decode_attention="dense"), mesh,
                         RULES_TP_SERVING, **kw).engine
    want = bodies.stamped_stream(jax_eng, _jax_params(), prompts, stamps)
    eng = make_continuous_engine(dataclasses.replace(CONFIG_TINY, decode_attention="dense"),
                                 device="cpu", **kw).engine
    assert bodies.stamped_stream(eng, _params(), prompts, stamps) == want
    unstamped = make_continuous_engine(
        dataclasses.replace(CONFIG_TINY, decode_attention="dense"), device="cpu", **kw).engine
    assert bodies.stamped_stream(unstamped, _params(), prompts, (None,) * 4)[0] != want[0]


def test_sampled_schedule_independence():
    """A sampled request's tokens depend on its id and the key only: the
    split engine, the mixed engine under a starving budget at batch 4, a
    horizon at batch 3, and the queue admitted in REVERSE order under its
    own ids all draw the same tokens."""
    sampled = {k: v for k, v in SAMPLED.items() if k != "rng"}
    ref, _ = _serve(False, "mixed", **SAMPLED)
    for kw in (dict(mixed=True, token_budget=3, batch_size=4),
               dict(mixed=True, horizon=4, batch_size=3, refill_chunk=8)):
        got, _ = _serve(False, "mixed", **SAMPLED, **kw)
        _assert_same(got[0], ref[0])
    eng = make_continuous_engine(dataclasses.replace(CONFIG_TINY, decode_attention="dense"),
                                 device="cpu", **{**COMMON, **sampled}).engine
    eng.serve(_params(), [], rng=SAMPLED["rng"])         # re-keys the engine
    prompts = _queue("mixed")
    got = _stream(eng, prompts, reversed(range(len(prompts))), _params())
    for rid, w in enumerate(ref[0]):
        np.testing.assert_array_equal(got[rid], w, err_msg=f"request {rid}")


@pytest.mark.parametrize("draft", [None, "weak"], ids=["plain", "spec"])
def test_serve_then_stream(draft):
    """``serve(rng=...)`` re-keys the engine, and later streaming samples
    from that key, as the JAX engine does: a serve of two prompts, then
    three streamed ones with automatic ids, give JAX's tokens."""
    prompts = _queue("mixed")
    kw = dict(temperature=0.8, top_k=16, **({"num_draft": 2} if draft else {}))
    out = {}
    for jax_side in (True, False):
        dkw, dparams = _draft_kw(draft, jax_side, dict(decode_attention="dense"))
        if jax_side:
            mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
            serve = jax_engine(dataclasses.replace(JAX_F32, decode_attention="dense"), mesh,
                               RULES_TP_SERVING, **COMMON, **kw, **dkw)
            params, key = _jax_params(), jax.random.key(9)
        else:
            serve = make_continuous_engine(
                dataclasses.replace(CONFIG_TINY, decode_attention="dense"), device="cpu",
                **COMMON, **kw, **dkw)
            params, key = _params(), 9
        first = serve(params, prompts[:2], rng=key, draft_params=dparams)
        eng = serve.engine
        rids = [eng.add_request(p) for p in prompts[2:5]]
        results = {}
        while eng.has_work():
            eng.step(params, dparams)
            results.update(eng.pop_finished())
        out[jax_side] = [np.asarray(o) for o in first] + [np.asarray(results[r]) for r in rids]
    _assert_same(out[False], out[True])


def test_forward_counts_and_decode_attention_launches(monkeypatch):
    """A speculative round makes num_draft + 1 draft calls (the proposals
    and the feed of the last one) and one verify call; every model call,
    target or draft, calls decode attention once a layer: the counts the
    chip run holds the kernel's launches to."""
    from learning_jax_sharding_tpu_torch.models import attention

    calls = []
    inner = attention.decode_attention
    monkeypatch.setattr(attention, "decode_attention",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    nd, steps = 2, 3
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention="blocked")
    dcfg = dataclasses.replace(PORT_DRAFT, decode_attention="blocked")
    serve = make_continuous_engine(cfg, device="cpu", draft_config=dcfg, num_draft=nd,
                                   decode_block_steps=steps, **COMMON)
    serve(_params(), _queue("mixed"), draft_params=_params(True))
    eng, lat = serve.engine, serve.last_latency
    refills, rounds = lat["refill_dispatches"], steps * lat["decode_dispatches"]
    assert eng.model_forwards == refills + rounds
    assert eng.draft_forwards == refills + (nd + 1) * rounds
    assert len(calls) == (cfg.num_layers * eng.model_forwards
                          + dcfg.num_layers * eng.draft_forwards)


def test_one_readback_per_horizon(monkeypatch):
    """The horizon queues every planned link and reads the device once."""
    serve = make_continuous_engine(dataclasses.replace(CONFIG_TINY, decode_attention="dense"),
                                   device="cpu", mixed=True, horizon=4, **COMMON)
    eng = serve.engine
    reads, multis = [], []
    read, multi = eng._read_links, eng._multi_dispatch
    monkeypatch.setattr(eng, "_read_links", lambda: reads.append(1) or read())
    monkeypatch.setattr(eng, "_multi_dispatch", lambda *a, **k: multis.append(1) or multi(*a, **k))
    serve(_params(), _queue("mixed"))
    lat = serve.last_latency
    assert multis and len(reads) == len(multis) == lat["multi_dispatches"]
    assert 1 < lat["steps_per_dispatch"] <= 4
    assert 0 <= lat["plan_reuse_rate"] <= 1


def test_runtime_tunable_knobs():
    """``horizon`` and ``token_budget`` are read at each dispatch: one engine
    serves at the defaults, then retuned, with the same tokens."""
    want, _ = _jax_run("mixed", mixed=True)
    serve = make_continuous_engine(dataclasses.replace(CONFIG_TINY, decode_attention="dense"),
                                   device="cpu", mixed=True, **COMMON)
    _assert_same(serve(_params(), _queue("mixed")), want[0])
    assert "multi_dispatches" not in serve.last_latency
    serve.engine.horizon, serve.engine.token_budget = 4, 3
    _assert_same(serve(_params(), _queue("mixed")), want[0])
    assert serve.last_latency["multi_dispatches"] >= 1


def test_mixed_removes_decode_stall():
    """The split engine parks decoding rows behind refills; the mixed engine
    never does."""
    split = make_continuous_engine(dataclasses.replace(CONFIG_TINY, decode_attention="dense"),
                                   device="cpu", **COMMON)
    split(_params(), _queue("mixed"))
    mixed = make_continuous_engine(dataclasses.replace(CONFIG_TINY, decode_attention="dense"),
                                   device="cpu", mixed=True, **COMMON)
    mixed(_params(), _queue("mixed"))
    assert split.last_latency["decode_stall_share"] > 0
    assert mixed.last_latency["decode_stall_share"] == 0
    assert mixed.last_latency["mixed_dispatches"] > 0
