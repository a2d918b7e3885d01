"""The port's transformer against the JAX one, on converted weights.

``from_flax_params`` carries a JAX ``Transformer.init`` tree into the port;
full-forward logits must then agree within atol 1e-5 (fp32), on
``CONFIG_TINY`` and on a GQA + RoPE + window + RMSNorm + bias variant. One
``MultiHeadAttention`` prefill + decode step must agree too, for the dense
and the blocked cache backends.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models.attention import (
    MultiHeadAttention as JaxMultiHeadAttention,
)
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu_torch.models.attention import MultiHeadAttention
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    TransformerConfig,
)

torch.set_num_threads(1)

ATOL = 1e-5
VARIANT = dict(num_kv_heads=2, rope=True, window=8, norm="rmsnorm", use_bias=True)


def _tokens(seed, b=2, s=12, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _jax_params(cfg, tokens):
    params = JaxTransformer(cfg).init(jax.random.key(0), jnp.asarray(tokens))["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


@pytest.mark.parametrize("variant", ["tiny", "gqa_rope_window_rms_bias"])
def test_forward_logits_match_jax(variant):
    mods = {} if variant == "tiny" else VARIANT
    jcfg = dataclasses.replace(JAX_TINY, **mods)
    cfg = dataclasses.replace(CONFIG_TINY, **mods)
    tokens = _tokens(1)
    params = _jax_params(jcfg, tokens)
    ref = np.asarray(JaxTransformer(jcfg).apply({"params": params}, jnp.asarray(tokens)))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(from_flax_params(params, cfg))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_seeded_init_has_the_flax_tree():
    """The port's own init (no JAX) yields the state dict that
    ``from_flax_params`` produces: same names, shapes and scales."""
    tokens = _tokens(2)
    converted = from_flax_params(_jax_params(JAX_TINY, tokens), CONFIG_TINY)
    own = Transformer(CONFIG_TINY, device="cpu", seed=3).state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in converted.items()
    }
    for name in ("tok_embed.weight", "pos_embed", "lm_head.weight"):
        assert abs(own[name].std().item() - 0.02) < 0.002, name
    w = own["blocks.0.attn.query.weight"]
    assert abs(w.std().item() - CONFIG_TINY.features**-0.5) < 0.2 * CONFIG_TINY.features**-0.5


def test_device_default_is_the_gpu():
    """No GPU here: the entry point raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(CONFIG_TINY)


def test_unported_options_raise():
    # MoE is ported (tests/test_torch_moe.py holds it against JAX): a block
    # of a config with experts holds the routed FF in place of the dense one.
    moe_block = Transformer(TransformerConfig(num_experts=4, num_layers=1, vocab_size=64,
                                              features=32, num_heads=2, head_dim=16,
                                              hidden=64, max_seq_len=16),
                            device="cpu").blocks[0]
    assert hasattr(moe_block, "moe") and not hasattr(moe_block, "ff")
    # remat and scan_layers are ported (tests/test_torch_scan_remat.py holds
    # them against JAX).
    TransformerConfig(scan_layers=True, remat=True, remat_policy="dots")
    # The fused norm, int8 caches and the paged cache are ported; the paged
    # cache's preconditions raise the JAX module's errors when the cache is
    # made.
    TransformerConfig(fused_norm=True, decode_paged=True)
    MultiHeadAttention(64, 4, 16, kv_cache_dtype=torch.int8, device="cpu")
    paged = dict(decode=True, max_decode_len=32, decode_paged=True, decode_page_count=5,
                 device="cpu")
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="blocked decode backend"):
        MultiHeadAttention(64, 4, 16, decode_ragged=True, decode_block_k=8,
                           **paged).init_cache(2, cpu)
    with pytest.raises(ValueError, match="requires decode_ragged"):
        MultiHeadAttention(64, 4, 16, decode_attention="blocked", decode_block_k=8,
                           **paged).init_cache(2, cpu)
    with pytest.raises(ValueError, match="dividing max_decode_len"):
        MultiHeadAttention(64, 4, 16, decode_attention="blocked", decode_ragged=True,
                           decode_block_k=12, **paged).init_cache(2, cpu)
    cache = MultiHeadAttention(64, 4, 16, decode_attention="blocked", decode_ragged=True,
                               decode_block_k=8, **paged).init_cache(2, cpu)
    assert cache.key.shape == (5, 4, 8, 16) and cache.block_table.shape == (2, 4)
    assert cache.index.shape == (2,)
    # Quantized projections are ported: int4 builds, an unknown mode raises
    # as the JAX dispatch does.
    TransformerConfig(quantization="int4")
    with pytest.raises(ValueError, match="unknown quantization 'int3'"):
        MultiHeadAttention(64, 4, 16, quantization="int3", device="cpu")


@pytest.mark.parametrize("backend", ["dense", "blocked"])
def test_attention_decode_step_matches_jax(backend):
    """Prefill of 5 tokens, then one single-token step, GQA + RoPE."""
    fields = dict(
        features=32, num_heads=4, head_dim=8, num_kv_heads=2, rope=True,
        causal=True, decode=True, max_decode_len=32,
        decode_attention=backend, decode_block_k=16,
    )
    rng = np.random.default_rng(4)
    x_pre = rng.normal(size=(2, 5, 32)).astype(np.float32)
    x_step = rng.normal(size=(2, 1, 32)).astype(np.float32)

    jmod = JaxMultiHeadAttention(**fields)
    params = jmod.init(jax.random.key(1), jnp.asarray(x_pre))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    ref_pre, mut = jmod.apply({"params": params}, jnp.asarray(x_pre), mutable=["cache"])
    ref_step, _ = jmod.apply(
        {"params": params, **mut}, jnp.asarray(x_step), mutable=["cache"]
    )

    mod = MultiHeadAttention(device="cpu", **fields)
    sd = {}
    for name in ("query", "key", "value", "out"):
        sd[f"{name}.weight"] = torch.from_numpy(params[name]["kernel"].T.copy())
    mod.load_state_dict(sd)
    cache = mod.init_cache(2, torch.device("cpu"))
    with torch.no_grad():
        out_pre = mod(torch.from_numpy(x_pre), cache=cache)
        out_step = mod(torch.from_numpy(x_step), cache=cache)
    np.testing.assert_allclose(out_pre.numpy(), np.asarray(ref_pre), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out_step.numpy(), np.asarray(ref_step), atol=ATOL, rtol=0)
    assert int(cache.index) == 6
