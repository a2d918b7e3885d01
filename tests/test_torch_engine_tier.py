"""The port engine's KV tier against the JAX engine's.

``tests/test_zkv_economy.py::TestEngineTier`` ported: the port's
``ContinuousEngine`` on the CPU and the JAX ``ContinuousEngine`` on a
one-device mesh (``CONFIG_TINY`` in fp32, the blocked decode backend, paged
with the prefix cache, pages of 4 tokens; the same JAX-initialised weights
carried across by ``from_flax_params``) run the same scenarios: a spill,
fill and spill round trip with every byte booked to the ledger's
``kv_handoff`` bucket (the second spill bit-equal to the first, the filled
page serving warm with the cold serve's tokens), the spilled rows against
JAX's, the digest's epochs and page-aligned keys at a partial page, the
refusals, a partial-page overlap realizing whole pages only, a predicted hit
evicted before admission re-prefilled and counted as a tier miss, and a
swap's commit dropping the registry and the digest. Tolerances:
``ROWS_ATOL`` for the spilled K/V against JAX's (computed apart); every
token, count, epoch and stat is compared for equality.
"""

import jax
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.parallel import build_mesh
from tests.test_torch_engine_handoff import (
    PAGE,
    ROWS_ATOL,
    TIER,
    _drain,
    _jax_make,
    _port_make,
    _tier_prompts,
    _trees,
)

torch.set_num_threads(1)


def _tier_cases(make, params, swap_params):
    """``TestEngineTier``'s scenarios → their observables (rows as numpy)."""
    mk = make("blocked")
    base, other = _tier_prompts()
    got = {}
    eng = mk(**TIER)
    ref = eng.serve(params, [base])[0]
    keys = eng.retained_prefixes()
    key = keys[0]
    epoch0, digest0 = eng.prefix_digest()
    rows, st = eng.spill_page(key, drop=True)
    epoch1, digest1 = eng.prefix_digest()
    st2 = eng.fill_page(key, rows)
    epoch2, digest2 = eng.prefix_digest()
    again = eng.serve(params, [base])[0]
    rows2, st3 = eng.spill_page(key, drop=False)
    got["round_trip"] = dict(
        keys=[np.frombuffer(k, np.int32).tolist() for k in keys],
        epochs=(epoch0, epoch1, epoch2), in_digest=(eng.prefix_hash(key) in digest0,
                                                    eng.prefix_hash(key) in digest1,
                                                    eng.prefix_hash(key) in digest2),
        spill=st, fill={k: v for k, v in st2.items() if k != "pid"}, spill_again=st3,
        ref=np.asarray(ref).tolist(), again=np.asarray(again).tolist(),
        stats=eng.last_stats, reconcile=eng.ledger.reconcile()["ok"],
        kv_handoff=eng.ledger.window_report()["buckets"]["kv_handoff"] > 0,
        counts={k: eng.registry.get(k).value for k in (
            "engine_kv_page_spills_total", "engine_kv_page_fills_total",
            "engine_kv_page_spill_bytes_total", "engine_kv_page_fill_bytes_total",
            "engine_kv_raw_bytes_total")})
    got["rows"] = ([np.asarray(r) for r in rows], [np.asarray(r) for r in rows2])

    eng = mk(**TIER)
    eng.serve(params, [base])
    (key, *_) = eng.retained_prefixes()
    rows, _ = eng.spill_page(key, drop=False)
    errors = []
    for call, exc in ((lambda: eng.fill_page(key, rows), ValueError),
                      (lambda: eng.spill_page(b"nope", drop=False), KeyError)):
        try:
            call()
            errors.append(None)
        except exc:
            errors.append(exc.__name__)
    _, digest = eng.prefix_digest()
    got["errors"] = errors
    # touch_prefix refreshes a resident key in the LRU (the oldest moves
    # last); an unknown key is refused.
    before = eng.retained_prefixes()
    got["touch"] = (eng.touch_prefix(before[0]), eng.touch_prefix(b"nope"),
                    eng.retained_prefixes() == before[1:] + before[:1])
    got["aligned"] = ([eng.prefix_hash(base[:n].tobytes()) in digest for n in (4, 8, 9)],
                      sorted(len(k) // 4 // PAGE for k in eng.retained_prefixes()))

    eng = mk(**TIER)
    eng.serve(params, [base])
    solo = mk(**TIER).serve(params, [other])[0]
    rid = eng.add_request(other)
    eng.expected_prefix[rid] = 2 * PAGE     # the router predicted [:8]
    out = _drain(eng, params)[rid]
    got["partial"] = (np.asarray(out).tolist(), np.asarray(solo).tolist(),
                      eng.prefix_realized.pop(rid), eng.registry.get(
                          "engine_tier_misses_total").value)

    eng = mk(**TIER)
    ref = eng.serve(params, [base])[0]
    rid = eng.add_request(base)
    eng.expected_prefix[rid] = 2 * PAGE
    eng.spill_page(base[:8].tobytes(), drop=True)     # gone before admission
    out = _drain(eng, params)[rid]
    got["evicted"] = (np.asarray(out).tolist(), np.asarray(ref).tolist(),
                      eng.prefix_realized.pop(rid),
                      eng.registry.get("engine_tier_misses_total").value,
                      eng.latency_stats()["tier_miss_rate"])

    eng = mk(**TIER)
    eng.serve(params, [base])
    epoch0, digest0 = eng.prefix_digest()
    staged = eng.swap_weights(swap_params, version=5)
    epoch1, digest1 = eng.prefix_digest()
    got["swap"] = (bool(digest0), staged, eng.weights_version, len(digest1), epoch1 > epoch0,
                   eng.retained_prefixes(), eng.swap_pending)
    return got


def _on_device(trees):
    """JAX trees committed to the one-device mesh (a swap reshards into the
    served tree's layout, which numpy leaves lack)."""
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    return jax.device_put(trees, NamedSharding(mesh, PartitionSpec()))


@pytest.fixture(scope="module")
def jax_side():
    params = _trees()["jax"]
    swap = jax.tree.map(lambda x: x * np.float32(1.001), params)
    with jax.default_matmul_precision("float32"):
        return dict(tier=_tier_cases(_jax_make, *_on_device((params, swap))))


@pytest.fixture(scope="module")
def port_side():
    params = _trees()["port"]
    return dict(tier=_tier_cases(_port_make, params, {k: v * 1.001 for k, v in params.items()}))


def test_spill_fill_round_trip_bit_identical_and_ledgered(port_side, jax_side):
    got, want = port_side["tier"]["round_trip"], jax_side["tier"]["round_trip"]
    assert got == want
    assert got["in_digest"] == (True, False, True)
    assert got["again"] == got["ref"] and got["stats"]["prefix_hits"] == 1
    assert got["spill"]["bytes"] > 0 and got["fill"] == got["spill"] == got["spill_again"]
    assert got["reconcile"] and got["kv_handoff"]
    rows, rows2 = port_side["tier"]["rows"]
    for a, b in zip(rows, rows2):
        np.testing.assert_array_equal(a, b)            # the second spill: bit for bit


def test_spilled_rows_equal_jax(port_side, jax_side):
    """Layer by layer, K then V: the JAX engine's flatten order of its page
    leaves at two layers (``block_0``, ``block_1``), the pool layouts alike
    (``(n_kv, page, h)``); within ``ROWS_ATOL``."""
    for got, want in zip(port_side["tier"]["rows"][0], jax_side["tier"]["rows"][0]):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=ROWS_ATOL)


def test_tier_refusals(port_side, jax_side):
    assert port_side["tier"]["errors"] == jax_side["tier"]["errors"] == ["ValueError",
                                                                         "KeyError"]


def test_touch_prefix_refreshes_the_lru(port_side, jax_side):
    assert port_side["tier"]["touch"] == jax_side["tier"]["touch"] == (True, False, True)


def test_digest_is_page_aligned(port_side, jax_side):
    assert port_side["tier"]["aligned"] == jax_side["tier"]["aligned"] == (
        [True, True, False], [1, 2])


def test_partial_page_overlap_realizes_whole_pages(port_side, jax_side):
    got = port_side["tier"]["partial"]
    assert got == jax_side["tier"]["partial"]
    assert got[0] == got[1] and got[2] == PAGE and got[3] == 1


def test_evicted_mid_route_is_a_counted_re_prefill(port_side, jax_side):
    got = port_side["tier"]["evicted"]
    assert got == jax_side["tier"]["evicted"]
    assert got[0] == got[1] and got[2] == PAGE and got[3] == 1 and got[4] == 1.0


def test_swap_commit_drops_registry_and_digest(port_side, jax_side):
    got = port_side["tier"]["swap"]
    assert got == jax_side["tier"]["swap"] == (True, True, 5, 0, True, [], False)
