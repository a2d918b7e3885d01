"""The port's continuous engine (``models/serving.py``) against the JAX engine.

Both engines serve the same queues with the same weights (``CONFIG_TINY``
in fp32, a JAX init carried across by ``from_flax_params``) through two
slots: greedy tokens must be EQUAL request for request, and the paged
engines' ``last_stats`` (page high-water, prefix hits and reuse,
preemptions) equal to JAX's. The JAX engine runs on a one-device mesh with
``RULES_TP_SERVING``, its blocked backend through the Pallas kernel in
interpret mode; each JAX reference is computed once per module. The port
runs on the CPU, where decode attention takes its plain version.
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
from learning_jax_sharding_tpu_torch.models.serving import (
    ContinuousEngine,
    RequestFailure,
    make_continuous_engine,
)
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

NEW = 6
PAGE = 16
COMMON = dict(batch_size=2, max_new_tokens=NEW, refill_chunk=4)
STAT_KEYS = ("page_high_water", "pages_total", "page_size", "preemptions", "prefix_hits",
             "prefix_pages_reused", "prefix_pages_retained")


@functools.cache
def _jax_params():
    cfg = dataclasses.replace(JAX_TINY, dtype=jnp.float32)
    model = JaxTransformer(cfg)
    probe = np.zeros((2, 8), np.int32)
    variables = jax.jit(lambda r, t: model.init({"params": r}, t))(jax.random.key(3), probe)
    return jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))


@functools.cache
def _params():
    return from_flax_params(_jax_params(), CONFIG_TINY)


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CONFIG_TINY.vocab_size, size=(n,)).astype(np.int32) for n in sizes]


def _queue(name):
    """The test queues, by name."""
    if name == "mixed":                    # test_serving.py's seven prompts
        return _prompts(11, (3, 9, 5, 1, 12, 7, 4))
    if name == "prefix":                   # repeats and a same-first-page variant
        base = _prompts(9, (20,))[0]
        variant = base.copy()
        variant[PAGE + 1] += 1
        return [base, variant, base, base.copy(), variant.copy()]
    if name == "distinct":                 # eviction under a tight pool
        return _prompts(10, (20,) * 6)
    if name == "pressure":                 # two 2-page requests, 3 pages
        return _prompts(23, (14, 14))
    if name == "long":                     # 44 tokens through 8-token chunks
        return _prompts(26, (44,))
    raise KeyError(name)


@functools.cache
def _jax_run(queue, backend="blocked", kv_int8=False, **kw):
    """The JAX engine's outputs and last_stats for a queue (cached: each
    costs seconds in interpret mode)."""
    cfg = dataclasses.replace(JAX_TINY, dtype=jnp.float32, decode_attention=backend)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=jnp.int8)
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    serve = jax_engine(cfg, mesh, RULES_TP_SERVING, **{**COMMON, **kw})
    outs = serve(_jax_params(), _queue(queue))
    return [np.asarray(o) for o in outs], serve.last_stats


def _jax_case(name):
    """The JAX engine's outputs and stats for one of ``CASES``."""
    queue, kw = CASES[name]
    return _jax_run(queue, **kw)


def _port(backend="blocked", kv_int8=False, **kw):
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention=backend)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=torch.int8)
    return make_continuous_engine(cfg, device="cpu", **{**COMMON, **kw})


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def _assert_stats(got, want):
    assert {k: got[k] for k in STAT_KEYS if k in want} == {
        k: want[k] for k in STAT_KEYS if k in want}


# (queue, JAX/port engine arguments): every case serves its queue through
# both engines and compares tokens and stats.
CASES = {
    "unpaged_dense": ("mixed", dict(backend="dense")),
    "unpaged_blocked": ("mixed", dict()),
    "paged_p16": ("mixed", dict(paged_pages=9, page_size=16)),
    "paged_p8": ("mixed", dict(paged_pages=17, page_size=8)),
    "paged_int8_kv": ("mixed", dict(kv_int8=True, paged_pages=9, page_size=16)),
    "prefix_repeat_variant": ("prefix", dict(paged_pages=9, page_size=16, prefix_cache=True)),
    "prefix_eviction": ("distinct", dict(paged_pages=5, page_size=16, prefix_cache=True)),
    "preemption": ("pressure", dict(paged_pages=4, page_size=16)),
    "long_prompt_chunked": ("long", dict(paged_pages=11, page_size=16, refill_chunk=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_engine(case):
    queue, kw = CASES[case]
    want, want_stats = _jax_run(queue, **kw)
    serve = _port(**kw)
    _assert_same(serve(_params(), _queue(queue)), want)
    if want_stats is None:
        assert serve.last_stats is None
    else:
        _assert_stats(serve.last_stats, want_stats)
    if case == "preemption":
        assert serve.last_stats["preemptions"] >= 1
    if case == "prefix_repeat_variant":
        assert serve.last_stats["prefix_hits"] >= 2


def test_eos_retires_and_refills():
    """An EOS that one request emits early: its slot retires there and
    serves the rest of the queue, as the JAX engine's does."""
    eos = int(_jax_case("unpaged_dense")[0][0][len(_queue("mixed")[0]) + 1])
    want, _ = _jax_run("mixed", backend="dense", eos_id=eos)
    got = _port(eos_id=eos, paged_pages=9, page_size=PAGE)(_params(), _queue("mixed"))
    _assert_same(got, want)
    assert any(len(g) < len(p) + NEW and g[-1] == eos for g, p in zip(got, _queue("mixed")))


@pytest.mark.parametrize("steps,chain", [(1, 1), (4, 3), (6, 2)])
def test_decode_blocks_and_chains(steps, chain):
    """Decode-block length and chaining change dispatches, never tokens."""
    want, _ = _jax_case("unpaged_dense")
    for kw in (dict(), dict(paged_pages=9, page_size=PAGE)):
        got = _port(decode_block_steps=steps, decode_chain=chain, **kw)(_params(),
                                                                        _queue("mixed"))
        _assert_same(got, want)


def test_prefix_hit_spans_serve_calls():
    """A second call with the same prompt reuses the pages the first call
    retired: no hit in call 1, one in call 2, both outputs equal to JAX's."""
    base = _queue("prefix")[0]
    want, _ = _jax_case("prefix_repeat_variant")
    eng = _port(paged_pages=9, page_size=PAGE, prefix_cache=True).engine
    got1 = eng.serve(_params(), [base])
    assert eng.last_stats["prefix_hits"] == 0
    assert eng.last_stats["prefix_pages_retained"] >= 1
    got2 = eng.serve(_params(), [base.copy()])
    assert eng.last_stats["prefix_hits"] == 1
    assert eng.last_stats["prefix_pages_reused"] >= 1
    np.testing.assert_array_equal(got1[0], want[0])
    np.testing.assert_array_equal(got2[0], want[0])


def test_flush_prefix_cache():
    base = _queue("prefix")[0]
    eng = _port(paged_pages=9, page_size=PAGE, prefix_cache=True).engine
    got1 = eng.serve(_params(), [base])
    eng.flush_prefix_cache()
    assert len(eng._cached_lru) == 0 and len(eng._free_pages) == 8
    got2 = eng.serve(_params(), [base.copy()])
    assert eng.last_stats["prefix_hits"] == 0
    np.testing.assert_array_equal(got2[0], got1[0])


@pytest.mark.parametrize("paged", [False, True])
def test_streaming_matches_serve(paged):
    """add_request / step / pop_finished, with arrivals while serving: the
    same tokens per request as the one-shot serve (and JAX's)."""
    want, _ = _jax_case("unpaged_dense")
    prompts = _queue("mixed")
    kw = dict(paged_pages=9, page_size=PAGE) if paged else {}
    eng = _port(**kw).engine
    rids = {eng.add_request(p): i for i, p in enumerate(prompts[:2])}
    late = list(enumerate(prompts))[2:]
    results, steps = {}, 0
    while eng.has_work() or late:
        eng.step(_params())
        results.update(eng.pop_finished())
        steps += 1
        if late and steps >= 2:
            i, p = late.pop(0)
            rids[eng.add_request(p)] = i
    assert set(results) == set(rids)
    for rid, i in rids.items():
        np.testing.assert_array_equal(results[rid], want[i])


def test_cache_created_once_across_calls():
    for kw in (dict(), dict(paged_pages=9, page_size=PAGE)):
        eng = _port(**kw).engine
        eng.serve(_params(), _queue("mixed")[:2])
        eng.serve(_params(), _queue("mixed")[2:4])
        assert eng.cache_creations == 1


def test_close_releases_and_recreates():
    eng = _port(paged_pages=9, page_size=PAGE).engine
    a = eng.serve(_params(), _queue("mixed")[:1])
    eng.add_request(_queue("mixed")[1], rid=5)
    eng.step(_params())
    eng.close()
    assert eng._cache is None and not eng.has_work()
    failed = eng.pop_finished()[5]
    assert isinstance(failed, RequestFailure) and failed.status == "shutdown"
    b = eng.serve(_params(), _queue("mixed")[:1])
    assert eng.cache_creations == 2
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("paged", [False, True])
def test_model_forwards_count_every_call(paged, monkeypatch):
    """One model call per refill chunk and per decode step, each calling
    decode attention once per layer: the count the chip run holds the
    kernel's launches to."""
    from learning_jax_sharding_tpu_torch.models import attention

    calls = []
    inner = attention.decode_attention
    monkeypatch.setattr(attention, "decode_attention",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    kw = dict(paged_pages=9, page_size=PAGE) if paged else {}
    serve = _port(decode_block_steps=4, **kw)
    serve(_params(), _queue("mixed"))
    eng, lat = serve.engine, serve.last_latency
    assert eng.model_forwards == lat["refill_dispatches"] + 4 * lat["decode_dispatches"]
    assert len(calls) == CONFIG_TINY.num_layers * eng.model_forwards


def test_latency_telemetry():
    serve = _port()
    serve(_params(), _queue("mixed"))
    lat = serve.last_latency
    assert lat["requests"] == len(_queue("mixed"))
    for k in ("ttft_p50", "ttft_p99", "tpot_p50", "queue_wait_p50", "e2e_p50", "itl_p50"):
        assert k in lat, k
    assert 0 < lat["ttft_p50"] <= lat["ttft_p99"]
    assert lat["ttft_p50"] <= lat["e2e_p50"]
    assert 0 < lat["refill_frac"] < 1


def test_pool_exhaustion_raises_and_engine_recovers():
    prompts = _queue("mixed")
    eng = _port(paged_pages=2, page_size=PAGE).engine
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        eng.serve(_params(), [prompts[4], prompts[1]])
    want, _ = _jax_case("unpaged_dense")
    np.testing.assert_array_equal(eng.serve(_params(), [prompts[3]])[0], want[3])


def test_busy_guards_and_duplicate_rid():
    prompts = _queue("mixed")
    eng = _port(paged_pages=9, page_size=PAGE, prefix_cache=True).engine
    eng.add_request(prompts[0], rid=7)
    with pytest.raises(ValueError, match="already in use"):
        eng.add_request(prompts[1], rid=7)
    with pytest.raises(RuntimeError, match="idle"):
        eng.flush_prefix_cache()
    with pytest.raises(RuntimeError, match="idle"):
        eng.serve(_params(), prompts[:1])
    while eng.has_work():
        eng.step(_params())
    assert set(eng.pop_finished()) == {7}


def test_construction_errors():
    """The JAX engine's ValueErrors, with its words."""
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention="blocked")
    bad = [
        (dict(batch_size=0), "batch_size"),
        (dict(max_new_tokens=0), "max_new_tokens"),
        (dict(refill_chunk=cfg.max_seq_len + 1), "refill_chunk"),
        (dict(decode_chain=0), "decode_chain"),
        (dict(vocab_limit=0), "vocab_limit"),
        (dict(dequantize="int3"), "dequantize must be"),
        (dict(prefix_cache=True), "prefix_cache requires the paged KV cache"),
        (dict(paged_pages=1), "page 0 is the scratch page"),
        (dict(paged_pages=8, page_size=48), "multiple of page_size"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            ContinuousEngine(cfg, **{**COMMON, "device": "cpu", **kw})
    with pytest.raises(ValueError, match="blocked decode backend"):
        ContinuousEngine(dataclasses.replace(cfg, decode_attention="dense"), paged_pages=8,
                         page_size=PAGE, device="cpu", **COMMON)
    serve = make_continuous_engine(cfg, batch_size=2, max_new_tokens=cfg.max_seq_len,
                                   device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        serve(_params(), [np.ones((8,), np.int32)])
    with pytest.raises(ValueError, match="draft_params requires draft_config"):
        serve(_params(), [np.ones((2,), np.int32)], draft_params={})


@pytest.mark.parametrize("kw", [
    dict(adapter_pool=object()), dict(comm_compression=True),
], ids=lambda kw: next(iter(kw)))
def test_unported_arguments_raise(kw):
    name = next(iter(kw))
    with pytest.raises(NotImplementedError, match=name):
        ContinuousEngine(CONFIG_TINY, device="cpu", **COMMON, **kw)


@pytest.mark.parametrize("arg", ["deadline_s", "max_queue", "max_dispatch_strikes",
                                 "degradation", "registry", "tracer"])
def test_ported_policy_and_telemetry_arguments(arg):
    """The recovery policies' arguments raise JAX's ``ValueError`` with its
    words; a supplied registry and tracer become the engine's own."""
    from learning_jax_sharding_tpu.models.serving import ContinuousEngine as JaxEngine
    from learning_jax_sharding_tpu.robustness import DegradationLadder as JaxLadder
    from learning_jax_sharding_tpu_torch.robustness import DegradationLadder
    from learning_jax_sharding_tpu_torch.telemetry import MetricsRegistry, Tracer

    if arg in ("registry", "tracer"):
        given = MetricsRegistry() if arg == "registry" else Tracer()
        eng = ContinuousEngine(CONFIG_TINY, device="cpu", **COMMON, **{arg: given})
        assert getattr(eng, arg) is given
        assert "engine_requests_total" in eng.registry.snapshot()
        return
    bad = {"deadline_s": 0, "max_queue": 0, "max_dispatch_strikes": 0}.get(arg)
    kw = {arg: bad}
    if arg == "degradation":
        jax_kw, kw = dict(degradation=JaxLadder()), dict(degradation=DegradationLadder())
    else:
        jax_kw = kw
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    cfg = dataclasses.replace(JAX_TINY, dtype=jnp.float32)
    with pytest.raises(ValueError) as want:
        JaxEngine(cfg, mesh, RULES_TP_SERVING, **COMMON, **jax_kw)
    with pytest.raises(ValueError) as got:
        ContinuousEngine(CONFIG_TINY, device="cpu", **COMMON, **kw)
    assert str(got.value) == str(want.value) and arg in str(got.value)


@pytest.mark.parametrize("kw,match", [
    (dict(horizon=2), "horizon > 1 requires mixed=True"),
    (dict(horizon=0, mixed=True), "horizon must be >= 1"),
    (dict(token_budget=8), "token_budget requires mixed=True"),
    (dict(token_budget=0, mixed=True), "token_budget must be >= 1"),
    (dict(draft_config=CONFIG_TINY, num_draft=0), "num_draft must be >= 1"),
    (dict(draft_config=dataclasses.replace(CONFIG_TINY, vocab_size=128)),
     "target vocab 256 != draft vocab 128"),
    (dict(draft_dequantize=True), "draft_dequantize requires draft_config"),
], ids=["horizon_without_mixed", "horizon_0", "budget_without_mixed", "budget_0",
        "num_draft_0", "draft_vocab", "draft_dequantize_alone"])
def test_mode_validation_errors(kw, match):
    """The decoding modes' construction errors, with the JAX engine's words."""
    with pytest.raises(ValueError, match=match):
        ContinuousEngine(CONFIG_TINY, device="cpu", **COMMON, **kw)


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "speculative"])
def test_draft_params_must_match_draft_config(speculative):
    """``draft_params`` without ``draft_config`` raises, and so does a
    speculative engine served without them, as the JAX engine's do."""
    kw = dict(draft_config=CONFIG_TINY) if speculative else {}
    serve = make_continuous_engine(CONFIG_TINY, device="cpu", **COMMON, **kw)
    match = "pass draft_params" if speculative else "draft_params requires draft_config"
    with pytest.raises(ValueError, match=match):
        serve(_params(), [np.ones((2,), np.int32)],
              draft_params=None if speculative else _params())


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(CONFIG_TINY, **COMMON)


# Engine modes that cache a cast of the served dict: (quantized tree bits,
# engine arguments). The float mode loads the dict into the model; the
# inference_dtype mode casts first; dequantize=True keeps the cast int8
# tree (bf16 embeddings and norms) for every model call; the int4 fused
# mode loads the packed tree into the model's int4 projections.
CAST_MODES = {
    "float": (None, dict()),
    "inference_dtype": (None, dict(inference_dtype=torch.bfloat16)),
    "dequantize": (8, dict(dequantize=True, inference_dtype=torch.bfloat16)),
    "int4_fused": (4, dict(dequantize="fused")),
}


def _mode_params(bits):
    """A private copy of the served dict (the tests mutate it in place)."""
    from learning_jax_sharding_tpu_torch.models.quantize import quantize_tree

    params = {k: v.clone() for k, v in _params().items()}
    return params if bits is None else quantize_tree(params, bits=bits, group_size=16)


def _update_in_place(params, seed):
    """Change every tensor of the dict in place, as an optimizer step does
    to a ``state_dict()``'s aliases; quantized codes stay in range."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in params.items():
            if t.is_floating_point():
                noise = rng.standard_normal(tuple(t.shape)) * 0.5 * float(t.float().std() + 0.1)
                t.add_(torch.from_numpy(noise).to(t.dtype))
            elif t.dtype == torch.uint8:
                t.bitwise_xor_(0x11)          # flip the low bit of both nibbles
            else:
                t.neg_()


@pytest.mark.parametrize("mode", list(CAST_MODES))
def test_second_serve_sees_in_place_updates(mode, monkeypatch):
    """Serve, update every tensor of the same dict in place, serve the same
    dict again: the tokens are a fresh engine's on the updated weights. An
    unchanged dict is still cast (and loaded) once."""
    bits, kw = CAST_MODES[mode]
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention="blocked", quantization_group=16)
    params = _mode_params(bits)
    prompts = _queue("mixed")[:3]
    eng = make_continuous_engine(cfg, device="cpu", **COMMON, **kw).engine
    casts, loads = [], []
    cast, load = eng._maybe_cast, eng._model.load_state_dict
    monkeypatch.setattr(eng, "_maybe_cast", lambda p: casts.append(1) or cast(p))
    monkeypatch.setattr(eng._model, "load_state_dict", lambda w: loads.append(1) or load(w))

    before = eng.serve(params, prompts)
    again = eng.serve(params, prompts)
    assert len(casts) == 1 and len(loads) == (0 if kw.get("dequantize") is True else 1)
    _assert_same(again, before)

    _update_in_place(params, seed=4)
    after = eng.serve(params, prompts)
    fresh = make_continuous_engine(cfg, device="cpu", **COMMON, **kw)(params, prompts)
    _assert_same(after, fresh)
    assert len(casts) == 2
    assert any(not np.array_equal(a, b) for a, b in zip(after, before)), \
        "the update must change the tokens, or the test shows nothing"


@pytest.mark.parametrize("mode", list(CAST_MODES))
def test_serves_inference_mode_params(mode, monkeypatch):
    """A dict built under ``torch.inference_mode()`` (its tensors track no
    in-place version) serves as the same dict built outside it, twice, with
    one cast."""
    bits, kw = CAST_MODES[mode]
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention="blocked", quantization_group=16)
    params = _mode_params(bits)
    with torch.inference_mode():
        frozen = {k: v.clone() for k, v in params.items()}
    assert all(t.is_inference() for t in frozen.values())
    prompts = _queue("mixed")[:3]
    eng = make_continuous_engine(cfg, device="cpu", **COMMON, **kw).engine
    casts = []
    cast = eng._maybe_cast
    monkeypatch.setattr(eng, "_maybe_cast", lambda p: casts.append(1) or cast(p))

    first = eng.serve(frozen, prompts)
    again = eng.serve(frozen, prompts)
    assert len(casts) == 1
    _assert_same(first, make_continuous_engine(cfg, device="cpu", **COMMON, **kw)(params, prompts))
    _assert_same(again, first)
