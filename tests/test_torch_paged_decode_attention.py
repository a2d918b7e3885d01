"""Decode attention's paged mode in the port (plain version) against the JAX
kernel's, and the paged cache of the attention module against JAX's.

The JAX kernel runs in Pallas interpret mode, as the JAX package's own
tests run it on the CPU; the port's wrapper takes its plain PyTorch version
for CPU tensors. Same numpy-seeded inputs and block tables, fp32: outputs
within 1e-6 (the JAX paged tests' tolerance), folded writes bit-equal at
the mapped page and slot, pools bit-equal everywhere else. The CUDA kernel's
paged mode is held against this plain version, and against its own
contiguous mode, by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from learning_jax_sharding_tpu.models.attention import (
    MultiHeadAttention as JaxMultiHeadAttention,
)
from learning_jax_sharding_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
)
from learning_jax_sharding_tpu_torch.models.attention import (
    MultiHeadAttention,
    paged_write,
    quantize_kv_chunk,
)
from learning_jax_sharding_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
B, NKV, PAGE, H, T = 3, 2, 16, 8, 4
L = T * PAGE


def _pools(rng, *, int8=False, b=B, n_kv=NKV, page=PAGE, t_cap=T, h=H):
    """Seeded pools with a shuffled table over pages 1..P-1 (page 0 scratch)
    → numpy ``{"kc", "vc"[, "ks", "vs"]}`` and the ``(b, t_cap)`` table."""
    pages = b * t_cap + 1
    table = rng.permutation(np.arange(1, pages)).reshape(b, t_cap).astype(np.int32)
    shape = (pages, n_kv, page, h)
    if int8:
        arrays = {}
        for name in ("k", "v"):
            sc, q = quantize_kv_chunk(torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
            arrays[f"{name}c"] = q.to(torch.int8).numpy()
            arrays[f"{name}s"] = sc.numpy()
        return arrays, table
    return {n: rng.normal(size=shape).astype(np.float32) for n in ("kc", "vc")}, table


def _new(rng, *, int8=False, b=B, n_kv=NKV, h=H):
    """A new token's k/v chunk (and its int8 scales) → numpy arrays."""
    out = {}
    for name in ("k", "v"):
        x = rng.normal(size=(b, n_kv, 1, h)).astype(np.float32)
        if int8:
            sc, q = quantize_kv_chunk(torch.from_numpy(x))
            out[f"{name}_new"] = q.to(torch.int8).numpy()
            out[f"{name}s_new"] = sc.numpy()
        else:
            out[f"{name}_new"] = x
    return out


def _both(q, pools, table, index, new=None, write_enable=None, **kw):
    """The JAX kernel and the port on the same paged inputs → (JAX results,
    port results), numpy, outputs first then the pools (folded)."""
    new = new or {}
    names = {"kc": "k_cache", "vc": "v_cache", "ks": "k_scale", "vs": "v_scale"}
    scale_kw = {names[n]: v for n, v in pools.items() if n in ("ks", "vs")}
    jx = dict(
        {k: jnp.asarray(v) for k, v in {**scale_kw, **new}.items()},
        block_table=jnp.asarray(table),
    )
    pt = dict(
        {k: torch.from_numpy(v.copy()) for k, v in {**scale_kw, **new}.items()},
        block_table=torch.from_numpy(table.copy()),
    )
    if write_enable is not None:
        jx["write_enable"] = jnp.asarray(write_enable, jnp.int32)
        pt["write_enable"] = torch.tensor(write_enable, dtype=torch.int32)
    ref = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(pools["kc"]), jnp.asarray(pools["vc"]),
        jnp.asarray(index, jnp.int32), interpret=True, **jx, **kw,
    )
    out = decode_attention(
        torch.from_numpy(q), torch.from_numpy(pools["kc"].copy()),
        torch.from_numpy(pools["vc"].copy()), torch.tensor(index, dtype=torch.int32),
        **pt, **kw,
    )
    if isinstance(ref, tuple):
        return [np.asarray(r) for r in ref], [o.numpy() for o in out]
    return [np.asarray(ref)], [out.numpy()]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s,group", [(1, 1), (1, 2), (5, 1)])
def test_read_parity(s, group, int8):
    rng = np.random.default_rng(0)
    pools, table = _pools(rng, int8=int8)
    q = rng.normal(size=(B, s, NKV * group, H)).astype(np.float32)
    (ref,), (out,) = _both(q, pools, table, [17, 33, 5])
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_window(int8):
    rng = np.random.default_rng(2)
    pools, table = _pools(rng, int8=int8)
    q = rng.normal(size=(B, 3, NKV * 2, H)).astype(np.float32)
    (ref,), (out,) = _both(q, pools, table, [40, 57, 20], window=12)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_folded_write_parity(int8):
    """The folded write lands at each row's mapped page and slot, bit-equal
    to JAX's; every other pool value is unchanged."""
    rng = np.random.default_rng(1)
    pools, table = _pools(rng, int8=int8)
    new = _new(rng, int8=int8)
    q = rng.normal(size=(B, 1, NKV, H)).astype(np.float32)
    index = [17, 9, 63]
    ref, out = _both(q, pools, table, index, new=new)
    np.testing.assert_allclose(out[0], ref[0], **TOL)
    written = ["k_new", "v_new"] + (["ks_new", "vs_new"] if int8 else [])
    for got, want, key, name in zip(out[1:], ref[1:], ("kc", "vc", "ks", "vs"), written):
        np.testing.assert_array_equal(got, want)
        before = pools[key]
        for row, i in enumerate(index):
            page, slot = table[row, i // PAGE], i % PAGE
            np.testing.assert_array_equal(got[page, :, slot], new[name][row, :, 0])
        touched = {(table[row, i // PAGE], i % PAGE) for row, i in enumerate(index)}
        for page in range(before.shape[0]):
            for slot in range(PAGE):
                if (page, slot) not in touched:
                    np.testing.assert_array_equal(got[page, :, slot], before[page, :, slot])


@pytest.mark.parametrize("int8", [False, True])
def test_write_enable_zero_leaves_pool(int8):
    """A disabled row writes nothing: its pages, and page 0, keep their
    bits; the enabled rows write as JAX's do."""
    rng = np.random.default_rng(3)
    pools, table = _pools(rng, int8=int8)
    new = _new(rng, int8=int8)
    q = rng.normal(size=(B, 1, NKV, H)).astype(np.float32)
    ref, out = _both(q, pools, table, [20, 41, 7], new=new, write_enable=[1, 0, 1])
    np.testing.assert_allclose(out[0], ref[0], **TOL)
    for got, want, key in zip(out[1:], ref[1:], ("kc", "vc", "ks", "vs")):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[table[1]], pools[key][table[1]])
        np.testing.assert_array_equal(got[0], pools[key][0])


def test_plain_paged_equals_plain_contiguous():
    """The table changes addresses, not arithmetic: the plain paged version
    gives the contiguous plain version's bits on the same values laid out
    per row, with the entries past each row's frontier naming the scratch
    page."""
    rng = np.random.default_rng(4)
    pools, table = _pools(rng)
    index = [17, 33, 5]
    for row, i in enumerate(index):
        table[row, i // PAGE + 1:] = 0
    contig = {n: np.zeros((B, NKV, L, H), np.float32) for n in ("kc", "vc")}
    for n, cache in contig.items():
        for row in range(B):
            for t in range(T):
                cache[row, :, t * PAGE:(t + 1) * PAGE] = pools[n][table[row, t]]
    q = torch.from_numpy(rng.normal(size=(B, 1, NKV * 2, H)).astype(np.float32))
    idx = torch.tensor(index, dtype=torch.int32)
    paged = decode_attention_reference(q, torch.from_numpy(pools["kc"]),
                                       torch.from_numpy(pools["vc"]), idx,
                                       block_table=torch.from_numpy(table))
    plain = decode_attention_reference(q, torch.from_numpy(contig["kc"]),
                                       torch.from_numpy(contig["vc"]), idx)
    torch.testing.assert_close(paged, plain, rtol=0, atol=0)


def test_validation_errors():
    """The JAX wrapper's ValueErrors, with its words."""
    q = torch.zeros(1, 1, 1, 8)
    pool = torch.zeros(5, 1, 16, 8)
    table = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="must equal the page size"):
        decode_attention(q, pool, pool, 3, block_table=table, block_k=8)
    with pytest.raises(ValueError, match=r"must be \(B, T\)"):
        decode_attention(q, pool, pool, 3, block_table=torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(P, N_kv, page, H\)"):
        decode_attention(q, pool, torch.zeros(5, 1, 8, 8), 3, block_table=table)
    ones = torch.ones(5, 1, 8)
    with pytest.raises(ValueError, match="k_scale must be"):
        decode_attention(q, pool.to(torch.int8), pool.to(torch.int8), 3, block_table=table,
                         k_scale=ones, v_scale=ones)


def test_paged_write_matches_jax_layout():
    """A chunk written through the table lands at (table[b, pos // page],
    pos % page); positions past a row's chunk length go to page 0 and no
    live page changes."""
    rng = np.random.default_rng(5)
    pool = torch.from_numpy(rng.normal(size=(9, NKV, PAGE, H)).astype(np.float32))
    before = pool.clone()
    table = torch.tensor([[3, 7, 1, 0], [2, 5, 0, 0]], dtype=torch.int32)
    chunk = torch.from_numpy(rng.normal(size=(2, NKV, 8, H)).astype(np.float32))
    idx = torch.tensor([12, 3], dtype=torch.int32)
    lengths = torch.tensor([8, 2], dtype=torch.int32)
    paged_write(pool, chunk, idx, table, lengths)
    for t in range(8):
        p = 12 + t
        torch.testing.assert_close(pool[table[0, p // PAGE], :, p % PAGE], chunk[0, :, t],
                                   rtol=0, atol=0)
    for t in range(2):
        torch.testing.assert_close(pool[2, :, 3 + t], chunk[1, :, t], rtol=0, atol=0)
    live = torch.ones(9, PAGE, dtype=torch.bool)
    live[0] = False
    live[3, 12:] = live[7, :4] = live[2, 3:5] = False
    assert torch.equal(pool.transpose(1, 2)[live], before.transpose(1, 2)[live])


@pytest.mark.parametrize("int8", [False, True])
def test_attention_module_paged_matches_jax(int8):
    """The attention module over page pools: a ragged 6-token chunk (one row
    3 valid) written through the table, then a folded single-token step with
    one row frozen; outputs and the pools after both calls against the JAX
    module's."""
    page, pages = 8, 12
    fields = dict(
        features=32, num_heads=4, head_dim=8, num_kv_heads=2, rope=True,
        causal=True, decode=True, max_decode_len=32, decode_attention="blocked",
        decode_block_k=page, decode_ragged=True, decode_paged=True,
        decode_page_count=pages,
    )
    if int8:
        fields["kv_cache_dtype"] = jnp.int8
    rng = np.random.default_rng(6)
    x_pre = rng.normal(size=(2, 6, 32)).astype(np.float32)
    x_step = rng.normal(size=(2, 1, 32)).astype(np.float32)
    table = np.array([[4, 9, 0, 0], [2, 7, 11, 0]], np.int32)
    pre_len = np.array([6, 3], np.int32)
    step_len = np.array([1, 0], np.int32)

    jmod = JaxMultiHeadAttention(**fields)
    variables = jmod.init(jax.random.key(1), jnp.asarray(x_pre),
                          chunk_lengths=jnp.asarray(pre_len))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))
    # The cache as created (init ran a call): zeros, scales ones, our table.
    cache = {k: jnp.ones_like(v) if "scale" in k else jnp.zeros_like(v)
             for k, v in nn.meta.unbox(variables["cache"]).items()}
    cache["block_table"] = jnp.asarray(table)
    ref_pre, mut = jmod.apply({"params": params, "cache": cache}, jnp.asarray(x_pre),
                              chunk_lengths=jnp.asarray(pre_len), mutable=["cache"])
    ref_step, mut = jmod.apply({"params": params, **mut}, jnp.asarray(x_step),
                               chunk_lengths=jnp.asarray(step_len), mutable=["cache"])

    torch_fields = dict(fields, kv_cache_dtype=torch.int8 if int8 else None)
    mod = MultiHeadAttention(device="cpu", **torch_fields)
    mod.load_state_dict({f"{n}.weight": torch.from_numpy(params[n]["kernel"].T.copy())
                         for n in ("query", "key", "value", "out")})
    kv = mod.init_cache(2, torch.device("cpu"),
                        block_table=torch.from_numpy(table.copy()))
    with torch.no_grad():
        out_pre = mod(torch.from_numpy(x_pre), cache=kv,
                      chunk_lengths=torch.from_numpy(pre_len))
        out_step = mod(torch.from_numpy(x_step), cache=kv,
                       chunk_lengths=torch.from_numpy(step_len))
    # Row 1's padded queries read the scratch page: only valid rows compare.
    np.testing.assert_allclose(out_pre.numpy()[0], np.asarray(ref_pre)[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_pre.numpy()[1, :3], np.asarray(ref_pre)[1, :3],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_step.numpy()[0], np.asarray(ref_step)[0], atol=1e-5, rtol=0)
    jcache = mut["cache"]
    assert kv.index.tolist() == np.asarray(jcache["cache_index"]).tolist() == [7, 3]
    live = np.ones(pages, bool)
    live[0] = False                       # the scratch page takes the masked writes
    for ours, theirs in ((kv.key, "cached_key"), (kv.value, "cached_value"),
                         (kv.key_scale, "key_scale"), (kv.value_scale, "value_scale")):
        if ours is None:
            continue
        want = np.asarray(jcache[theirs])[live]
        if int8 and theirs.startswith("cached"):
            # int8 values may round one step apart where the fp32
            # projections differ in the last bits.
            assert np.abs(ours.numpy()[live].astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(ours.numpy()[live], want, atol=1e-5, rtol=1e-5)
