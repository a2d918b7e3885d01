"""The port's int8 KV cache against the JAX package's.

``quantize_kv_chunk`` must give the eager JAX function's scales and values
byte for byte (under ``jit`` XLA turns ``absmax / 127`` into a multiply by
1/127, one ulp off in a few percent of the scales; the port matches the
eager function). The plain int8 ``decode_attention`` (what the port runs on
CPU tensors) agrees with the JAX kernel in Pallas interpret mode within
rtol 1e-5 and an atol of 1e-5 of the largest output (the values span 0.01
to 10 per token and head, to exercise the scales), with and without the
folded write (caches and scales then bit-equal), with GQA and a window.
Greedy generation with ``kv_cache_dtype=int8`` emits JAX's tokens on ``CONFIG_TINY`` in fp32, for
the dense and the blocked backend, rectangular and ragged. The CUDA kernel's
int8 mode is held against the plain version on the card by
``chip_smoke.py``.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import generate as jax_generate
from learning_jax_sharding_tpu.models.attention import quantize_kv_chunk as jax_quantize
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
)
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP
from learning_jax_sharding_tpu_torch.models import generate
from learning_jax_sharding_tpu_torch.models.attention import KVCache, quantize_kv_chunk
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from learning_jax_sharding_tpu_torch.ops.decode_attention import decode_attention

torch.set_num_threads(1)

B, L, NKV, H = 2, 64, 2, 16


def _assert_close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _chunk(seed, shape):
    """Normal values with a per-(token, head) magnitude, one all-zero
    vector (its scale is 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * rng.uniform(0.01, 10.0, size=shape[:-1] + (1,))
    x = x.astype(np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 33, 3, 16), (4, 8, 12, 64)])
def test_quantize_kv_chunk_byte_equal_to_eager_jax(shape, dtype):
    x = torch.from_numpy(_chunk(3, shape)).to(getattr(torch, dtype))
    scale, q = quantize_kv_chunk(x)
    want_scale, want_q = jax_quantize(jnp.asarray(x.float().numpy()).astype(dtype))
    assert scale.dtype == torch.float32 and q.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(want_scale).view(np.uint32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    assert float(scale.reshape(-1)[0]) == 1.0          # the all-zero vector


def test_jitted_jax_scales_within_one_ulp():
    """What ``jit`` does to the JAX function: scales at most one ulp from
    the eager ones the port matches."""
    x = _chunk(4, (4, 64, 8, 64))
    scale, _ = quantize_kv_chunk(torch.from_numpy(x))
    jit_scale, _ = jax.jit(jax_quantize)(jnp.asarray(x))
    ulps = np.abs(scale.numpy().view(np.int32) - np.asarray(jit_scale).view(np.int32))
    assert ulps.max() <= 1


def _int8_cache(seed):
    """A quantized (B, N_kv, L, H) cache: int8 values and fp32 scales."""
    scale, q = quantize_kv_chunk(torch.from_numpy(_chunk(seed, (B, NKV, L, H))))
    return q.to(torch.int8).numpy(), scale.numpy()


def _inputs(seed, s, group, *, fold=False):
    rng = np.random.default_rng(seed)
    arrays = {"q": rng.normal(size=(B, s, NKV * group, H)).astype(np.float32)}
    arrays["kc"], arrays["ks"] = _int8_cache(seed + 100)
    arrays["vc"], arrays["vs"] = _int8_cache(seed + 200)
    if fold:
        for i, name in enumerate(("k", "v")):
            sc, q = quantize_kv_chunk(torch.from_numpy(_chunk(seed + 7 + i, (B, NKV, 1, H))))
            arrays[f"{name}_new"] = q.to(torch.int8).numpy()
            arrays[f"{name}s_new"] = sc.numpy()
    return arrays


_ARG_NAMES = {"ks": "k_scale", "vs": "v_scale", "k_new": "k_new", "v_new": "v_new",
              "ks_new": "ks_new", "vs_new": "vs_new"}


def _both(arrays, index, write_enable=None, **kw):
    """The JAX kernel (interpret mode) and the port on the same inputs."""
    jx = {k: jnp.asarray(v) for k, v in arrays.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    extra_j = {_ARG_NAMES[k]: jx[k] for k in arrays if k in _ARG_NAMES}
    extra_t = {_ARG_NAMES[k]: pt[k] for k in arrays if k in _ARG_NAMES}
    if write_enable is not None:
        extra_j["write_enable"] = jnp.asarray(write_enable, jnp.int32)
        extra_t["write_enable"] = torch.tensor(write_enable, dtype=torch.int32)
    ref = jax_decode_attention(jx["q"], jx["kc"], jx["vc"], jnp.asarray(index, jnp.int32),
                               interpret=True, **extra_j, **kw)
    out = decode_attention(pt["q"], pt["kc"], pt["vc"], torch.tensor(index, dtype=torch.int32),
                           **extra_t, **kw)
    if isinstance(ref, tuple):
        return [np.asarray(r) for r in ref], [o.numpy() for o in out]
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("s", [1, 5])
def test_plain_int8_matches_jax_kernel(s, per_row, group, window):
    index = [3, 40] if per_row else 20
    ref, out = _both(_inputs(s * 7 + group, s, group), index, window=window, block_k=16)
    _assert_close(out, ref)


@pytest.mark.parametrize("write_enable", [None, [1, 0]])
def test_int8_folded_write(write_enable):
    arrays = _inputs(5, 1, 2, fold=True)
    ref, out = _both(arrays, [17, 9], write_enable=write_enable, block_k=16)
    assert len(out) == len(ref) == 5                       # out, caches, scales
    _assert_close(out[0], ref[0])
    for got, want in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(out[1][0, :, 17], arrays["k_new"][0, :, 0])
    np.testing.assert_array_equal(out[3][0, :, 17], arrays["ks_new"][0, :, 0])
    if write_enable is not None:                           # the frozen row is untouched
        for got, name in zip(out[1:], ("kc", "vc", "ks", "vs")):
            np.testing.assert_array_equal(got[1], arrays[name][1])


def test_int8_cache_layouts():
    """Scales start at one, shaped like the cache without its head dim."""
    for shape in ((2, 16, 3, 8), (2, 3, 16, 8)):
        cache = KVCache.create(shape, torch.int8, ragged=False, device="cpu")
        assert cache.key.dtype == torch.int8
        assert cache.key_scale.shape == shape[:-1] and cache.value_scale.dtype == torch.float32
        assert bool((cache.key_scale == 1).all())
    assert KVCache.create((2, 16, 3, 8), torch.float32, ragged=False, device="cpu").key_scale is None


LENGTHS = [3, 8, 5, 1]
NEW = 6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, JAX_TINY.vocab_size, size=(4, 8)).astype(np.int32)
    params = JaxTransformer(JAX_TINY).init(jax.random.key(0), jnp.asarray(prompt))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    return prompt, params, mesh


@pytest.mark.parametrize("backend,ragged", [("dense", False), ("blocked", False),
                                            ("dense", True), ("blocked", True)])
def test_int8_greedy_tokens_match_jax(setup, backend, ragged):
    """Ragged blocked steps take the int8 folded write."""
    prompt, params, mesh = setup
    mods = dict(decode_attention=backend, decode_block_k=16)
    jgen = jax_generate.make_generate_fn(
        dataclasses.replace(JAX_TINY, kv_cache_dtype=jnp.int8, **mods), mesh, RULES_DP_TP,
        max_new_tokens=NEW, ragged=ragged,
    )
    cfg = dataclasses.replace(CONFIG_TINY, kv_cache_dtype=torch.int8, **mods)
    tgen = generate.make_generate_fn(cfg, max_new_tokens=NEW, device="cpu", ragged=ragged)
    kw = dict(lengths=LENGTHS) if ragged else {}
    ref = jgen(params, jnp.asarray(prompt), **{k: np.asarray(v) for k, v in kw.items()})
    out = tgen(from_flax_params(params, cfg), prompt, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
