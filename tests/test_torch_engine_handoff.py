"""The port engine's drain, KV handoff and KV tier against the JAX engine's.

The port's ``ContinuousEngine`` on the CPU and the JAX ``ContinuousEngine`` on
a one-device mesh (``CONFIG_TINY`` in fp32, the same JAX-initialised weights
carried across by ``from_flax_params``) run the same scenarios, ported from
``tests/test_zfleet.py::TestDisaggregatedHandoff`` and
``tests/test_zkv_economy.py::TestEngineTier``. The fleet router is slice F,
so one function (:func:`handoff`) moves each request by hand, alike on both
sides: a prefill engine (``max_new_tokens=1``) retires it, ``export_kv``
hands its row to ``transfer_tree`` in the decode engine's
``kv_row_shardings`` layout, clipped at the row's valid length along
``kv_row_seq_dims``, and the decode engine ``ingest_kv``s it and decodes the
rest. Held equal, on both sides and to a single engine's serve of each whole
request: greedy and sampled tokens (dense backend), the blocked backend's
head-major rows with a prompt shorter than ``n_kv``, and each handoff's
bytes and segments. Then a decode engine over a (1, 2) mesh of thread ranks
under ``RULES_TP_SERVING`` ingests rows from a one-device prefill engine on
every rank: tokens equal to JAX's engine on a (1, 2) mesh, the rows
delivered in the decode cache's own row layout, every rank alike; a paged
mesh engine spills, fills and spills a page (rows whole and equal on every
rank, the round trip bit-stable, the K/V within ``ROWS_ATOL`` of a
one-device engine's). ``drain_requests``: records, statuses and counts equal
to JAX's, the drained requests recomputed exactly elsewhere. The tier on one
device: ``tests/test_torch_engine_tier.py``. Tolerances: ``ROWS_ATOL`` for
K/V values computed apart; tokens, rows, counts and stats otherwise equal.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import serving as jax_serving
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel import logical as jax_logical
from learning_jax_sharding_tpu.parallel import resharding as jax_rs
from learning_jax_sharding_tpu_torch.fleet import transfer_tree as port_transfer_tree
from learning_jax_sharding_tpu_torch.models import serving as port_serving
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.utils import prng
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

COMMON = dict(batch_size=2, max_new_tokens=4, refill_chunk=8)
SAMPLED = dict(temperature=0.8)
PAGE = 4
TIER = dict(batch_size=2, max_new_tokens=4, refill_chunk=8, paged_pages=12, page_size=PAGE,
            prefix_cache=True)
JAX_CFG = dataclasses.replace(JAX_TINY, dtype=jnp.float32)

#: The spilled K/V against JAX's: XLA's and torch's CPU matmuls sum the
#: projections in different orders, so the fp32 values differ in their last
#: bits (about 1e-6 at magnitudes near 1); the tokens above are equal.
ROWS_ATOL = 1e-5


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, CONFIG_TINY.vocab_size, size=(n,)).astype(np.int32)
            for n in (5, 9, 4, 7)]


def _short():
    """A prompt shorter than ``n_kv`` first: the sharpest probe of a
    sequence dim taken for the heads dim."""
    return [np.asarray([3, 5], np.int32)] + _prompts()[:2]


def _tier_prompts():
    rng = np.random.default_rng(23)
    base = rng.integers(1, CONFIG_TINY.vocab_size, size=(9,)).astype(np.int32)
    other = np.concatenate([base[:6], rng.integers(1, CONFIG_TINY.vocab_size, size=(3,))
                            .astype(np.int32)])
    return base, other


@functools.cache
def _trees():
    model = JaxTransformer(JAX_CFG)
    variables = jax.jit(lambda r, t: model.init({"params": r}, t))(
        jax.random.key(3), np.zeros((2, 8), np.int32))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))
    return {"jax": params, "port": from_flax_params(params, CONFIG_TINY)}


def _jax_make(backend, mesh_shape=(1, 1), rules="RULES_DP_TP"):
    mesh = build_mesh(mesh_shape, ("data", "model"),
                      devices=jax.devices()[:int(np.prod(mesh_shape))])
    cfg = dataclasses.replace(JAX_CFG, decode_attention=backend)
    return lambda **kw: jax_serving.ContinuousEngine(cfg, mesh, getattr(jax_logical, rules),
                                                     **kw)


def _port_make(backend):
    cfg = dataclasses.replace(CONFIG_TINY, decode_attention=backend)
    return lambda **kw: port_serving.ContinuousEngine(cfg, device="cpu", **kw)


def _lists(out):
    return {rid: np.asarray(t).tolist() for rid, t in sorted(out.items())}


def _drain(eng, params):
    out = {}
    while eng.has_work():
        eng.step(params)
        out.update(eng.pop_finished())
    out.update(eng.pop_finished())
    return out


def handoff(pre, dec, params, prompts, transfer_tree, rng=None):
    """Serve ``prompts`` (ids 0, 1, ...) disaggregated, the same on either
    side: every request prefilled and retired on ``pre``, its exported row
    moved by ``transfer_tree`` into ``dec``'s row layout (clipped at its
    valid length along ``dec``'s sequence dims, plans cached) as soon as
    ``dec`` has a free slot, ingested and decoded there. ``rng``: both
    engines' sampling key. → ``({rid: tokens}, [(rid, length, bytes,
    segments, skipped)], the last ingested rows)``."""
    if rng is not None:
        pre.rng = dec.rng = rng
    dec.ensure_cache(params)
    dst, dims = dec.kv_row_shardings(), dec.kv_row_seq_dims()
    for i, p in enumerate(prompts):
        pre.add_request(p, rid=i)
    parked, out, stats, cache, moved = [], {}, [], {}, None
    for _ in range(400):
        if not (pre.has_work() or parked or dec.has_work()):
            break
        if pre.has_work():
            done = pre.step(params)
            fin = pre.pop_finished()
            for rid in done:
                rows, length = pre.export_kv(rid)
                parked.append((rid, rows, length, int(np.asarray(fin[rid])[-1])))
        while parked and dec.free_slots():
            rid, rows, length, first = parked.pop(0)
            moved, st = transfer_tree(rows, dst, stop=length, seq_dims=dims, plan_cache=cache)
            stats.append((rid, length, st["bytes"], st["segments"], st["segments_skipped"]))
            dec.ingest_kv(params, prompts[rid], first, moved, rid=rid)
        if dec.has_work():
            dec.step(params)
        out.update(dec.pop_finished())
    else:
        raise AssertionError("handoff wedged")
    return _lists(out), stats, moved


def _handoff_cases(make, params, transfer_tree, key):
    """Greedy and sampled handoffs (dense backend) and the blocked
    backend's, each beside one engine's serve of the whole requests."""
    got = {}
    for name, backend, prompts, sample in (("greedy", "dense", _prompts(), {}),
                                           ("sampled", "dense", _prompts(), SAMPLED),
                                           ("blocked", "blocked", _short(), {})):
        mk = make(backend)
        ref = mk(**COMMON, **sample).serve(params, prompts, rng=key if sample else None)
        pre = mk(**dict(COMMON, max_new_tokens=1), **sample)
        dec = mk(**COMMON, **sample)
        tokens, stats, _ = handoff(pre, dec, params, prompts, transfer_tree,
                                   rng=key if sample else None)
        got[name] = dict(ref=_lists(dict(enumerate(ref))), tokens=tokens, stats=stats,
                         dims=dec.kv_row_seq_dims(),
                         counts=(dec.registry.get("engine_kv_ingests_total").value,
                                 pre.registry.get("engine_kv_exports_total").value),
                         ledger=(pre.ledger.window_buckets()["kv_handoff"] > 0,
                                 dec.ledger.window_buckets()["kv_handoff"] > 0,
                                 dec.ledger.reconcile()["ok"]))
    return got


def _drain_case(make, params):
    mk = make("dense")
    prompts = _prompts()
    eng = mk(**COMMON)
    eng.serve(params, [prompts[3]])
    for i, p in enumerate(prompts[:3]):
        eng.add_request(p, rid=10 + i, deadline_s=600.0 if i == 2 else None)
    eng.step(params)                        # two admitted, one queued
    records = eng.drain_requests()
    fin = eng.pop_finished()
    got = dict(
        records=[(r["rid"], np.asarray(r["prompt"]).tolist(), r["deadline_s"],
                  isinstance(r["arrival_t"], float)) for r in records],
        statuses={rid: (r.status, r.tokens is not None) for rid, r in sorted(fin.items())},
        rerouted=(eng.registry.get("engine_rerouted_total").value,
                  eng.latency_stats()["rerouted"], eng.has_work()))
    # Requeued on a fresh engine with their original arrival stamps:
    # recomputed exactly.
    other = mk(**COMMON)
    for r in records:
        other.add_request(r["prompt"], rid=r["rid"], deadline_s=r["deadline_s"],
                          arrival_t=r["arrival_t"])
    got["requeued"] = _lists(_drain(other, params))
    got["clean"] = _lists(dict(zip((10, 11, 12), mk(**COMMON).serve(params, prompts[:3]))))
    return got


@pytest.fixture(scope="module")
def jax_side():
    params = _trees()["jax"]
    with jax.default_matmul_precision("float32"):
        return dict(
            handoff=_handoff_cases(_jax_make, params, jax_rs.transfer_tree,
                                   jax.random.key(0)),
            drain=_drain_case(_jax_make, params),
            mesh12=_lists(dict(enumerate(_jax_make("dense", (1, 2), "RULES_TP_SERVING")(
                **COMMON).serve(params, _prompts())))),
        )


@pytest.fixture(scope="module")
def port_side():
    params = _trees()["port"]
    return dict(
        handoff=_handoff_cases(_port_make, params, port_transfer_tree, prng.key(0)),
        drain=_drain_case(_port_make, params),
    )


@pytest.mark.parametrize("case", ["greedy", "sampled", "blocked"])
def test_handoff_tokens_equal_one_engine_and_jax(case, port_side, jax_side):
    got, want = port_side["handoff"][case], jax_side["handoff"][case]
    assert got["tokens"] == got["ref"]
    assert got["tokens"] == want["tokens"] == want["ref"]
    assert got["counts"] == want["counts"] == (len(got["ref"]), len(got["ref"]))
    assert got["ledger"] == (True, True, True)


@pytest.mark.parametrize("case", ["greedy", "blocked"])
def test_handoff_bytes_and_segments_equal_jax(case, port_side, jax_side):
    got, want = port_side["handoff"][case], jax_side["handoff"][case]
    assert got["stats"] == want["stats"]
    # Bytes past each row's valid length never moved: each handoff moves
    # less than a whole row (K and V of every layer, the counters).
    c = CONFIG_TINY
    whole = c.num_layers * 2 * c.max_seq_len * c.num_heads * c.head_dim * 4 + (c.num_layers + 1) * 4
    assert all(nbytes < whole for _, _, nbytes, _, _ in got["stats"])


def test_blocked_rows_are_head_major(port_side, jax_side):
    """The blocked backend's rows are ``(n_kv, L, h)``: the sequence dim is
    read off the shapes (1), never assumed (a dim-0 clip would zero heads;
    the short prompt is held equal above)."""
    got = port_side["handoff"]["blocked"]["dims"]
    assert [(l["key"], l["value"], l["index"]) for l in got["layers"]] == [(1, 1, -1)] * 2
    assert port_side["handoff"]["greedy"]["dims"]["layers"][0]["key"] == 0
    jax_dims = jax_side["handoff"]["blocked"]["dims"]
    assert jax_dims["block_0"]["attn"]["cached_key"] == 1 and jax_dims["position"] == -1


def test_drain_requests_equal_jax(port_side, jax_side):
    got, want = port_side["drain"], jax_side["drain"]
    assert got["records"] == want["records"]
    assert [r[0] for r in got["records"]] == [10, 11, 12]          # slots, then the queue
    assert got["statuses"] == want["statuses"] == {
        10: ("rerouted", True), 11: ("rerouted", True), 12: ("rerouted", False)}
    assert got["rerouted"] == want["rerouted"] == (3, 3, False)
    assert got["requeued"] == want["requeued"] == got["clean"]


def test_handoff_refusals():
    make = _port_make("dense")
    params = _trees()["port"]
    eng = make(**COMMON)
    with pytest.raises(RuntimeError, match="ensure_cache"):
        eng.kv_row_shardings()
    eng.serve(params, _prompts()[:3])
    with pytest.raises(KeyError, match="not exportable"):
        eng.export_kv(7)
    # Requests 0 and 1 retired in slots reused by request 2: only the last
    # retirement in each slot is exportable.
    exportable = sorted(eng._export_ok)
    with pytest.raises(KeyError):
        eng.export_kv(next(r for r in range(3) if r not in exportable))
    rows, length = eng.export_kv(exportable[-1])
    assert length == _prompts()[exportable[-1]].size + COMMON["max_new_tokens"] - 1
    eng.ingest_kv(params, _prompts()[0], 1, rows, rid=20)
    with pytest.raises(ValueError, match="already in use"):
        eng.ingest_kv(params, _prompts()[0], 1, rows, rid=20)
    eng.ingest_kv(params, _prompts()[0], 1, rows, rid=21)
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.ingest_kv(params, _prompts()[0], 1, rows, rid=22)
    for kw in (dict(paged_pages=8, page_size=8), dict(draft_config=CONFIG_TINY)):
        other = _port_make("blocked")(**COMMON, **kw)
        with pytest.raises(ValueError, match="not supported"):
            other.export_kv(0)
    with pytest.raises(RuntimeError, match="prefix_cache"):
        eng.spill_page(b"")
    with pytest.raises(NotImplementedError, match="slice F"):
        eng.spill_page(b"", base_rows=[])


# --- over a mesh: a (1, 2) decode engine of thread ranks ---------------------


def _mesh_body(mesh, params, prompts, common, tier, base):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from learning_jax_sharding_tpu_torch.parallel import logical

    cfg = dataclasses.replace(CONFIG_TINY, decode_attention="dense")
    pre = port_serving.ContinuousEngine(cfg, device="cpu", **dict(common, max_new_tokens=1))
    dec = port_serving.ContinuousEngine(cfg, mesh, logical.RULES_TP_SERVING, **common)
    tokens, stats, moved = handoff(pre, dec, params, prompts, port_transfer_tree)
    want = dec.kv_row_shardings()
    layout = all(
        isinstance(m, DTensor) and m.device_mesh == w.mesh
        and list(m.placements) == list(w.placements)
        for m, w in zip([moved["position"]] + [v for lay in moved["layers"] for v in lay.values()],
                        [want["position"]] + [v for lay in want["layers"] for v in lay.values()]))
    heads = str(want["layers"][0]["key"].placements)
    single = _lists(dict(enumerate(port_serving.ContinuousEngine(
        cfg, mesh, logical.RULES_TP_SERVING, **common).serve(params, prompts))))
    # The tier over the mesh: whole host rows on every rank, a bit-stable
    # spill → fill → spill, the filled page serving warm.
    bcfg = dataclasses.replace(CONFIG_TINY, decode_attention="blocked")
    eng = port_serving.ContinuousEngine(bcfg, mesh, logical.RULES_TP_SERVING, **tier)
    ref = eng.serve(params, [base])[0]
    key = eng.retained_prefixes()[0]
    rows, st = eng.spill_page(key, drop=True)
    eng.fill_page(key, rows)
    again = eng.serve(params, [base])[0]
    rows2, _ = eng.spill_page(key, drop=False)
    local = [tuple(x.to_local().shape) for x in eng._page_leaves()]
    mesh_tier = dict(warm=np.asarray(again).tolist() == np.asarray(ref).tolist(),
                     hits=eng.last_stats["prefix_hits"], bytes=st["bytes"],
                     stable=all(torch.equal(a, b) for a, b in zip(rows, rows2)),
                     rows=[r.numpy() for r in rows], local=local)
    one = port_serving.ContinuousEngine(bcfg, device="cpu", **tier)
    one.serve(params, [base])
    one_rows, _ = one.spill_page(one.retained_prefixes()[0], drop=False)
    mesh_tier["one_device_rows"] = [r.numpy() for r in one_rows]
    out = dict(tokens=tokens, stats=stats, layout=layout, heads=heads, single=single,
               tier=mesh_tier)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    return ranks


@pytest.fixture(scope="module")
def mesh_side():
    base, _ = _tier_prompts()
    return run_on_threads(_mesh_body, (1, 2), ("data", "model"),
                          args=(_trees()["port"], _prompts(), COMMON, TIER, base))


def test_mesh_decode_engine_ingests_one_device_rows(mesh_side, port_side, jax_side):
    got = mesh_side[0]
    assert got["tokens"] == jax_side["mesh12"] == got["single"]
    assert got["tokens"] == port_side["handoff"]["greedy"]["tokens"]
    # Rows land in the decode cache's own row layout (heads over model).
    assert got["layout"] and got["heads"] == "(Replicate(), Shard(dim=1))"
    # Each K/V element lands once (half the heads a rank); the replicated
    # counters' rows land twice.
    extra = (CONFIG_TINY.num_layers + 1) * 4
    one_device = {s[0]: s[2] + extra for s in port_side["handoff"]["greedy"]["stats"]}
    assert {s[0]: s[2] for s in got["stats"]} == one_device


def test_mesh_ranks_agree(mesh_side):
    a, b = mesh_side
    assert a["tokens"] == b["tokens"] and a["stats"] == b["stats"]
    for x, y in zip(a["tier"]["rows"], b["tier"]["rows"]):
        np.testing.assert_array_equal(x, y)


def test_mesh_tier_round_trip(mesh_side):
    got = mesh_side[0]["tier"]
    assert got["warm"] and got["hits"] == 1 and got["stable"]
    # Each rank holds 2 of the 4 KV heads of a page; the host rows are whole.
    assert got["local"][0] == (12, 2, PAGE, 16)
    assert [r.shape for r in got["rows"]] == [(4, PAGE, 16)] * 4
    assert got["bytes"] == 4 * 4 * PAGE * 16 * 4
    # The mesh's K/V against a one-device engine's, within ROWS_ATOL: a
    # rank's projection over its two heads may sum apart from the whole.
    for x, y in zip(got["rows"], got["one_device_rows"]):
        np.testing.assert_allclose(x, y, rtol=0, atol=ROWS_ATOL)
