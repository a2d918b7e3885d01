"""The port's quantized serving against the JAX package's, token for token.

``CONFIG_TINY`` with ``quantization_group=16`` in fp32: the layout on which
the JAX model runs q/k/v through one ``int4_matmul3`` and each feed-forward
through ``int4_ff``. The same JAX-initialised weights, quantized by the JAX
package's leaf functions and carried across by ``from_flax_params``, go through the
JAX ``make_generate_fn`` on a one-device mesh (Pallas kernels in interpret
mode) and the port's on ``device="cpu"`` (the kernels' plain versions), for
``dequantize=True`` (int8 and int4 trees), ``"fused"`` and ``"fused_w4a8"``:
greedy tokens must be equal and prefill logits within 1e-4. The port must
take the JAX routes: the q/k/v triple and the whole-FF kernel under
``"fused"``, neither under w4a8.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import attention as jax_attention
from learning_jax_sharding_tpu.models import decoding as jax_decoding
from learning_jax_sharding_tpu.models import generate as jax_generate
from learning_jax_sharding_tpu.models import quantize as jq
from learning_jax_sharding_tpu.models import transformer as jax_transformer
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP
from learning_jax_sharding_tpu_torch.models import attention, decoding, generate, transformer
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params

torch.set_num_threads(1)

GROUP = 16
NEW = 6
JAX_CFG = dataclasses.replace(jax_transformer.CONFIG_TINY, quantization_group=GROUP)
CFG = dataclasses.replace(transformer.CONFIG_TINY, quantization_group=GROUP)
# (tree bits, dequantize mode)
MODES = {"int8_dequant": (8, True), "int4_dequant": (4, True), "int4_fused": (4, "fused"),
         "int4_w4a8": (4, "fused_w4a8")}


def _jax_quantize_tree(params, bits):
    """``jq.quantize_tree``'s walk with jitted leaves: its eager ops compile
    one by one. Both packages get this tree; ``tests/test_torch_quantize.py``
    holds the port's quantization against the eager JAX functions."""
    leaf = jax.jit(jq.quantize_leaf) if bits == 8 else jax.jit(
        lambda w: jq.quantize_leaf_int4(w, GROUP))

    def walk(node, prefix):
        return {
            k: leaf(v) if not isinstance(v, dict) and jq.default_match(prefix + (k,), v)
            else walk(v, prefix + (k,)) if isinstance(v, dict) else v
            for k, v in node.items()
        }

    return walk(params, ())


@pytest.fixture(scope="module")
def trees():
    prompt = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    params = nn.meta.unbox(jax.jit(jax_transformer.Transformer(JAX_CFG).init)(
        jax.random.key(0), jnp.asarray(prompt))["params"])
    jtrees = {bits: _jax_quantize_tree(params, bits) for bits in (8, 4)}
    ttrees = {bits: from_flax_params(jax.tree.map(np.asarray, t), CFG)
              for bits, t in jtrees.items()}
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    return prompt, jtrees, ttrees, mesh


@pytest.fixture(scope="module")
def jax_results(trees):
    """The JAX side of every mode, built once: greedy tokens and the
    prefill logits of the decode model's cached apply."""
    prompt, jtrees, _, mesh = trees
    out = {}
    with jax.default_matmul_precision("float32"):
        for name, (bits, mode) in MODES.items():
            tokens = jax_generate.make_generate_fn(
                JAX_CFG, mesh, RULES_DP_TP, max_new_tokens=NEW, dequantize=mode
            )(jtrees[bits], jnp.asarray(prompt))
            cfg = jax_decoding.derive_decode_config(JAX_CFG, None, mesh=mesh, rules=RULES_DP_TP)
            cfg, fused = jax_decoding.apply_dequantize_policy(cfg, mode, mesh, RULES_DP_TP)
            apply = jax_decoding.make_cached_apply(
                jax_transformer.Transformer(cfg), dequantize=bool(mode) and not fused,
                dequant_dtype=cfg.param_dtype,
            )
            logits = jax.jit(lambda p, x: apply(p, None, x)[0])(jtrees[bits], jnp.asarray(prompt))
            out[name] = np.asarray(tokens), np.asarray(logits)
    return out


def _port_prefill_logits(tree, mode, prompt):
    cfg, fused = decoding.apply_dequantize_policy(decoding.derive_decode_config(CFG), mode)
    model = transformer.Transformer(cfg, device="cpu").eval()
    in_apply = bool(mode) and not fused
    weights = decoding.make_param_caster(None, "cpu", dequantize=True)(tree)
    if not in_apply:
        model.load_state_dict(weights)
    apply = decoding.make_cached_apply(model, dequantize=in_apply, dequant_dtype=cfg.param_dtype)
    with torch.no_grad():
        logits, _ = apply(None, torch.from_numpy(prompt), params=weights)
    return logits.numpy()


@pytest.mark.parametrize("name", list(MODES))
def test_greedy_tokens_match_jax(trees, jax_results, name):
    prompt, _, ttrees, _ = trees
    bits, mode = MODES[name]
    out = generate.make_generate_fn(CFG, max_new_tokens=NEW, device="cpu", dequantize=mode)(
        ttrees[bits], prompt)
    np.testing.assert_array_equal(out.numpy(), jax_results[name][0])


@pytest.mark.parametrize("name", list(MODES))
def test_prefill_logits_match_jax(trees, jax_results, name):
    prompt, _, ttrees, _ = trees
    bits, mode = MODES[name]
    got = _port_prefill_logits(ttrees[bits], mode, prompt)
    np.testing.assert_allclose(got, jax_results[name][1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode,triple,ff,single", [("fused", 1, 1, 1), ("fused_w4a8", 0, 0, 6)])
def test_port_takes_the_jax_routes(trees, monkeypatch, mode, triple, ff, single):
    """Per block and forward: ``"fused"`` runs q/k/v as one
    ``int4_matmul3``, the FF as one ``int4_ff`` and the out projection
    alone (plus the lm_head once); w4a8 runs all six projections alone."""
    prompt, _, ttrees, _ = trees
    calls = {"triple": 0, "ff": 0, "single": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    from learning_jax_sharding_tpu_torch.models import quantize

    monkeypatch.setattr(attention, "int4_matmul3", spy("triple", attention.int4_matmul3))
    monkeypatch.setattr(transformer, "int4_ff", spy("ff", transformer.int4_ff))
    monkeypatch.setattr(quantize, "int4_matmul", spy("single", quantize.int4_matmul))
    generate.make_generate_fn(CFG, max_new_tokens=NEW, device="cpu", dequantize=mode)(
        ttrees[4], prompt)
    forwards = CFG.num_layers * NEW
    assert calls == {"triple": triple * forwards, "ff": ff * forwards,
                     "single": single * forwards + NEW}


@pytest.mark.parametrize(
    "quantization,group,kv_heads,bias",
    [("int4", 16, None, False), ("int4", 64, None, False), ("int4", 128, None, False),
     ("int4", 24, None, False), ("int4", 16, 2, False), ("int4", 16, None, True),
     ("int4_w4a8", 16, None, False), (None, 16, None, False)],
)
def test_routing_rules_match_jax(quantization, group, kv_heads, bias):
    """``_fused_qkv`` and ``_use_fused_ff`` decide as the JAX modules do,
    over tileable, whole-K, odd-count, GQA, bias and w4a8 layouts."""
    common = dict(features=64, num_heads=4, head_dim=16, num_kv_heads=kv_heads,
                  use_bias=bias, quantization=quantization, quantization_group=group)
    jattn = jax_attention.MultiHeadAttention(**common)
    tattn = attention.MultiHeadAttention(dtype=torch.float32, device="cpu", **common)
    assert tattn._fused_qkv(64) == jattn._fused_qkv(64)
    ff_kw = dict(use_bias=bias, quantization=quantization, quantization_group=group)
    jff = jax_transformer.FeedForward(features=64, hidden=128, **ff_kw)
    tff = transformer.FeedForward(64, 128, device="cpu", **ff_kw)
    assert tff._use_fused_ff(64) == jff._use_fused_ff(64)


def test_dequantize_policy_matches_jax(trees):
    _, _, _, mesh = trees
    with pytest.raises(ValueError) as want:
        jax_decoding.apply_dequantize_policy(JAX_CFG, "fused_int8", mesh, RULES_DP_TP)
    with pytest.raises(ValueError) as got:
        decoding.apply_dequantize_policy(CFG, "fused_int8")
    assert str(got.value) == str(want.value)
    for mode, quantization in ((False, None), (True, None), ("fused", "int4"),
                               ("fused_w4a8", "int4_w4a8")):
        cfg, fused = decoding.apply_dequantize_policy(CFG, mode)
        jcfg, jfused = jax_decoding.apply_dequantize_policy(JAX_CFG, mode, mesh, RULES_DP_TP)
        assert (cfg.quantization, fused) == (jcfg.quantization, jfused) == (
            quantization, mode in ("fused", "fused_w4a8"))
