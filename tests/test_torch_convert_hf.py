"""HF GPT-2 interop of the port against the torch model and the JAX package.

Randomly initialised ``transformers.GPT2LMHeadModel``s (no download), built
as the JAX package's ``tests/test_convert.py`` builds them. The port's
converted weights give the HF model's logits and the JAX package's
(``LOGIT_ATOL``, the reference's bound, and the argmax exactly), its config
and state dict are the JAX conversion's, the export round-trips, and case 13
runs on the CPU.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from learning_jax_sharding_tpu.models import convert as jax_convert  # noqa: E402
from learning_jax_sharding_tpu.models.transformer import Transformer as JaxTransformer  # noqa: E402
from learning_jax_sharding_tpu_torch.cases import case13_hf_interop  # noqa: E402
from learning_jax_sharding_tpu_torch.models.convert import (  # noqa: E402
    config_from_hf_gpt2,
    from_flax_params,
    params_from_hf_gpt2,
    stack_scan_params,
    state_dict_from_params,
)
from learning_jax_sharding_tpu_torch.models.transformer import Transformer  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 5e-3     # the reference's: torch, the port and XLA sum in other orders
EXPORT_ATOL = 1e-5


@pytest.fixture(scope="module")
def hf_pair():
    torch.manual_seed(0)
    hf_cfg = transformers.GPT2Config(
        n_layer=2, n_embd=64, n_head=4, vocab_size=128, n_positions=64,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    return hf, config_from_hf_gpt2(hf_cfg), params_from_hf_gpt2(hf)


def _tokens(b=2, s=16, seed=0, v=128):
    return np.random.default_rng(seed).integers(0, v, (b, s))


def _port_logits(cfg, sd, tok):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        return model(torch.from_numpy(tok)).numpy()


def _hf_logits(hf, tok):
    with torch.no_grad():
        return hf(torch.from_numpy(tok)).logits.numpy()


def test_logits_match_hf_and_jax(hf_pair):
    hf, cfg, sd = hf_pair
    tok = _tokens()
    want = _hf_logits(hf, tok)
    got = _port_logits(cfg, sd, tok)
    jparams = jax_convert.params_from_hf_gpt2(hf)
    jcfg = jax_convert.config_from_hf_gpt2(hf.config)
    with jax.default_matmul_precision("float32"):
        jgot = np.asarray(JaxTransformer(jcfg).apply({"params": jparams},
                                                     jnp.asarray(tok, jnp.int32)), np.float32)
    for other in (want, jgot):
        np.testing.assert_allclose(got, other, atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), other.argmax(-1))
    # The port's state dict is the JAX conversion carried across, bit for bit.
    via_jax = from_flax_params(jparams, cfg)
    assert set(via_jax) == set(sd)
    for name, t in sd.items():
        assert torch.equal(t, via_jax[name]), name


def test_config_mapping_matches_jax(hf_pair):
    hf, cfg, _ = hf_pair
    assert cfg.vocab_size == 128 and cfg.num_layers == 2
    assert cfg.features == 64 and cfg.num_heads == 4 and cfg.head_dim == 16
    assert cfg.hidden == 256 and cfg.max_seq_len == 64
    assert cfg.use_bias and cfg.norm_eps == hf.config.layer_norm_epsilon
    assert not cfg.rope and cfg.dtype == torch.float32
    jcfg = jax_convert.config_from_hf_gpt2(hf.config)
    for field in ("vocab_size", "num_layers", "features", "num_heads", "head_dim", "hidden",
                  "max_seq_len", "use_bias", "norm_eps", "norm", "rope", "causal"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    bf16 = config_from_hf_gpt2(hf.config, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and bf16.param_dtype == torch.float32


@pytest.mark.parametrize("fields,match", [
    (dict(activation_function="relu"), "activation"),
    (dict(scale_attn_by_inverse_layer_idx=True), "scale_attn_by_inverse_layer_idx"),
    (dict(reorder_and_upcast_attn=True), "reorder_and_upcast_attn"),
    (dict(scale_attn_weights=False), "scale_attn_weights=False"),
])
def test_config_guards(fields, match):
    with pytest.raises(ValueError, match=match):
        config_from_hf_gpt2(transformers.GPT2Config(**fields))


def test_fractional_head_dim_rejected():
    """Any object with GPT-2's config fields serves; HF checks n_embd %
    n_head only when a model is built."""
    fields = dict(activation_function="gelu_new", n_embd=66, n_head=4, n_layer=1,
                  vocab_size=64, n_positions=32, layer_norm_epsilon=1e-5, n_inner=None)
    with pytest.raises(ValueError, match="not divisible by n_head"):
        config_from_hf_gpt2(types.SimpleNamespace(**fields))
    cfg = config_from_hf_gpt2(types.SimpleNamespace(**{**fields, "n_embd": 64}))
    assert cfg.head_dim == 16 and cfg.hidden == 256


def test_n_inner_and_untied_head(hf_pair):
    torch.manual_seed(2)
    hf_cfg = transformers.GPT2Config(
        n_layer=1, n_embd=32, n_head=2, vocab_size=64, n_positions=32,
        n_inner=96, tie_word_embeddings=False,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg = config_from_hf_gpt2(hf_cfg)
    assert cfg.hidden == 96
    sd = params_from_hf_gpt2(hf)
    assert sd["blocks.0.ff.up.weight"].shape == (96, 32)
    assert not torch.equal(sd["lm_head.weight"], sd["tok_embed.weight"])
    tok = _tokens(b=2, s=8, seed=4, v=64)
    want = _hf_logits(hf, tok)
    np.testing.assert_allclose(_port_logits(cfg, sd, tok), want, atol=LOGIT_ATOL, rtol=0)
    # A diverged head exported as tied would drop trained weights.
    with pytest.raises(ValueError, match="tie_head=False"):
        state_dict_from_params(sd)
    hf2 = transformers.GPT2LMHeadModel(hf_cfg).eval()
    hf2.load_state_dict(state_dict_from_params(sd, tie_head=False), strict=False)
    np.testing.assert_allclose(_hf_logits(hf2, tok), want, atol=EXPORT_ATOL, rtol=0)


def test_export_round_trip(hf_pair):
    """The port's state dict → a fresh HF model: the original's logits (the
    tied head re-tied by HF); a stacked (``scan_layers``) state dict
    exports the same tensors; the export equals the JAX package's."""
    hf, _, sd = hf_pair
    out = state_dict_from_params(sd)
    hf2 = transformers.GPT2LMHeadModel(hf.config).eval()
    hf2.load_state_dict(out, strict=False)
    hf2.tie_weights()
    tok = _tokens(seed=9)
    np.testing.assert_allclose(_hf_logits(hf2, tok), _hf_logits(hf, tok), atol=EXPORT_ATOL,
                               rtol=0)
    stacked = state_dict_from_params(stack_scan_params(sd))
    assert set(stacked) == set(out) and all(torch.equal(stacked[k], out[k]) for k in out)
    jout = jax_convert.state_dict_from_params(jax_convert.params_from_hf_gpt2(hf))
    assert set(jout) == set(out)
    for name, t in out.items():
        assert torch.equal(t, jout[name]), name
    with pytest.raises(ValueError, match="no blocks"):
        state_dict_from_params({k: v for k, v in sd.items() if not k.startswith("blocks.")})


def test_decode_cache_matches_full_forward(hf_pair):
    """Chunked cached decode of the converted model equals its own full
    forward: the biases and the norm eps ride the cache path too."""
    _, cfg, sd = hf_pair
    tok = torch.from_numpy(_tokens(b=2, s=12, seed=5))
    full = Transformer(cfg, device="cpu")
    full.load_state_dict(sd)
    dec = Transformer(dataclasses.replace(cfg, decode=True), device="cpu")
    dec.load_state_dict(sd)
    with torch.no_grad():
        want = full(tok)
        cache = dec.init_cache(2)
        outs = [dec(tok[:, :6], cache=cache)]
        outs += [dec(tok[:, i:i + 1], cache=cache) for i in range(6, 12)]
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), want.numpy(), atol=2e-4, rtol=0)


def test_case13_on_the_cpu():
    out = case13_hf_interop.main(device_type="cpu")
    assert out["logit_diff"] < LOGIT_ATOL and out["round_trip_diff"] < EXPORT_ATOL
    assert out["tokens"].shape == (2, 8 + case13_hf_interop.NEW)
