"""The port's per-shard decode attention in the engine's call forms against
the JAX package's.

``ops.decode_attention.make_decode_attn_fn`` on a (2, 2) ``data`` ×
``model`` mesh, the port's four ranks threads of this process
(``parallel.run_on_threads``), against the JAX
``make_decode_attn_fn(mesh22, rules, interpret=True)`` (the Pallas kernel
under ``shard_map``) on the same numpy-seeded fp32 inputs: the folded write
(float, and int8 with its scales, each with ``write_enable``), per-row
``(B,)`` indices on a chunk of queries, and paged pools (alone, and under
the folded write in float and int8) under ``RULES_TP_SERVING``. Outputs
within atol = rtol = 1e-5 (``tests/test_torch_decode_attention.py``'s
tolerance), the folded caches bit-equal, and every output laid out as
JAX's. Paged pools under ``RULES_DP_TP`` raise ``ValueError`` on both sides.
Grouped heads (4 query heads over 2 kv heads) leave each ``model`` shard
one kv head.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.ops.decode_attention import make_decode_attn_fn
from learning_jax_sharding_tpu.parallel import logical as jax_logical
from learning_jax_sharding_tpu_torch.models.attention import quantize_kv_chunk
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from tests import _torch_mesh_bodies as bodies
from tests.test_torch_paged_decode_attention import _new, _pools

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
B, N, NKV, H, L, PAGE = 4, 4, 2, 16, 64, 16
ROWS = np.array([5, 20, 0, 63], np.int32)        # per-row write positions
ENABLE = np.array([1, 0, 1, 1], np.int32)


def _caches(rng, int8):
    """Contiguous ``(B, N_kv, L, H)`` caches (and int8 scales)."""
    out = {}
    for name in ("k", "v"):
        x = rng.standard_normal((B, NKV, L, H)).astype(np.float32)
        if int8:
            sc, q = quantize_kv_chunk(torch.from_numpy(x))
            out[f"{name}c"], out[f"{name}s"] = q.to(torch.int8).numpy(), sc.numpy()
        else:
            out[f"{name}c"] = x
    return out


def _call(rules, q, caches, index, new=None, **kw):
    """One call's arguments: positional q, caches and index; the scales,
    folded write and table as keywords."""
    kwargs = {k: v for k, v in (("k_scale", caches.get("ks")), ("v_scale", caches.get("vs")))
              if v is not None}
    kwargs.update(new or {})
    kwargs.update(kw)
    return dict(rules=rules, args=(q, caches["kc"], caches["vc"], index), kwargs=kwargs)


def _calls():
    rng = np.random.default_rng(21)
    q1 = rng.standard_normal((B, 1, N, H)).astype(np.float32)
    q4 = rng.standard_normal((B, 4, N, H)).astype(np.float32)
    calls = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "float"
        calls[f"fold_{tag}"] = _call("RULES_DP_TP", q1, _caches(rng, int8), ROWS,
                                     _new(rng, int8=int8, b=B, n_kv=NKV, h=H),
                                     write_enable=ENABLE)
    calls["rows_chunk"] = _call("RULES_DP_TP", q4, _caches(rng, False),
                                np.array([0, 10, 30, 60], np.int32))
    pools, table = _pools(rng, b=B, n_kv=NKV, page=PAGE, t_cap=L // PAGE, h=H)
    calls["paged_rows"] = _call("RULES_TP_SERVING", q1, pools, ROWS + 1, block_table=table)
    for int8 in (False, True):
        tag = "int8" if int8 else "float"
        pools, table = _pools(rng, int8=int8, b=B, n_kv=NKV, page=PAGE, t_cap=L // PAGE, h=H)
        calls[f"paged_fold_{tag}"] = _call("RULES_TP_SERVING", q1, pools, ROWS,
                                           _new(rng, int8=int8, b=B, n_kv=NKV, h=H),
                                           write_enable=ENABLE, block_table=table)
    calls["paged_dp_tp"] = dict(calls["paged_rows"], rules="RULES_DP_TP")
    return calls


CALLS = _calls()
RESULTS = [name for name in CALLS if name != "paged_dp_tp"]


def _spec(spec, ndim):
    """A ``PartitionSpec`` as a tuple of ``ndim`` entries."""
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def jax_results(mesh22):
    out = {}
    for name, call in CALLS.items():
        fn = make_decode_attn_fn(mesh22, getattr(jax_logical, call["rules"]), interpret=True)
        args = [jnp.asarray(a) for a in call["args"]]
        kwargs = {k: jnp.asarray(v) for k, v in call["kwargs"].items()}
        try:
            got = fn(*args, **kwargs)
        except ValueError as exc:
            out[name] = str(exc)
            continue
        got = got if isinstance(got, tuple) else (got,)
        out[name] = ([np.asarray(g) for g in got],
                     [_spec(g.sharding.spec, g.ndim) for g in got])
    return out


@pytest.fixture(scope="module")
def port():
    return run_on_threads(bodies.mesh_decode_attention_body, (2, 2), ("data", "model"),
                          args=(CALLS,))


@pytest.mark.parametrize("name", RESULTS)
def test_per_shard_decode_attention_equals_jax(name, port, jax_results):
    (got, got_specs), (want, want_specs) = port[name], jax_results[name]
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):            # the folded caches and scales
        np.testing.assert_array_equal(g, w)
    assert got_specs == want_specs


@pytest.mark.parametrize("name", [n for n in RESULTS if "fold" in n])
def test_write_enable_leaves_disabled_rows(name, port):
    """The disabled row's caches come back as they went in, and the enabled
    rows' new tokens sit at their slots."""
    got, _ = port[name]
    call = CALLS[name]
    paged = "block_table" in call["kwargs"]
    k_in, k_new = np.asarray(call["args"][1]), call["kwargs"]["k_new"]
    k_out = got[1]
    if paged:
        table = call["kwargs"]["block_table"]
        pages = [table[b, ROWS[b] // PAGE] for b in range(B)]
        np.testing.assert_array_equal(k_out[pages[1]], k_in[pages[1]])
        for b in (0, 2, 3):
            np.testing.assert_array_equal(k_out[pages[b], :, ROWS[b] % PAGE], k_new[b, :, 0])
    else:
        np.testing.assert_array_equal(k_out[1], k_in[1])
        for b in (0, 2, 3):
            np.testing.assert_array_equal(k_out[b, :, ROWS[b]], k_new[b, :, 0])


def test_paged_pools_under_dp_tp_raise_as_jax(port, jax_results):
    assert "cannot shard the batch" in jax_results["paged_dp_tp"]
    assert "cannot shard the batch" in port["paged_dp_tp"]
