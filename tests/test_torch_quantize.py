"""The port's quantization and int4 kernels against the JAX package's.

Same numpy inputs on both sides: the port's ``quantize_leaf`` /
``quantize_leaf_int4`` / ``quantize_rows_int8`` must give byte-equal packed
weights, codes and scales; its ``quantize_tree`` over a state dict must equal
the JAX tree carried across by ``from_flax_params``; the plain versions of
the four CUDA kernels (w4a16, the q/k/v triple, w4a8, the whole FF) must
match the Pallas kernels run in interpret mode, at the JAX tests' own
tolerances; the validation errors must match; and the serving caster must
leave quantized nodes (fp32 scales) as they are.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import decoding as jax_decoding
from learning_jax_sharding_tpu.models import quantize as jq
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.ops import int4_ff as jff
from learning_jax_sharding_tpu.ops import int4_matmul as jmm
from learning_jax_sharding_tpu_torch.models import quantize as tq
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.decoding import make_param_caster
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
from learning_jax_sharding_tpu_torch.ops import int4_ff as tff
from learning_jax_sharding_tpu_torch.ops import int4_matmul as tmm

torch.set_num_threads(1)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jnode(w, group):
    # Eager, as users call it: under jit XLA divides by 7 as a multiply by
    # 1/7, which moves some scales by one ulp.
    node = jq.quantize_leaf_int4(jnp.asarray(w), group_size=group)
    return {k: np.asarray(v) for k, v in node.items()}


@pytest.mark.parametrize(
    "shape,group",
    [((64, 48), 16), ((64, 48), 64), ((256, 128), 128), ((64, 40), 128),
     ((96, 8), 32), ((2, 16, 24), 8)],
)
def test_int4_leaf_byte_equal(shape, group):
    """Split-half packing and group scales, byte for byte (a whole-K group
    where ``group`` ≥ K); ``dequantize_leaf_int4`` equal too."""
    w = _normal(1, *shape)
    w[..., 0, 0] = 0.0
    w[..., :, 1] = 0.0        # an all-zero channel: scale 1
    want = _jnode(w, group)
    got = tq.quantize_leaf_int4(torch.from_numpy(w), group_size=group)
    assert got["q4"].dtype == torch.uint8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q4"].numpy(), want["q4"])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    deq = jq.dequantize_leaf_int4({k: jnp.asarray(v) for k, v in want.items()}, jnp.float32)
    np.testing.assert_array_equal(
        tq.dequantize_leaf_int4(got, torch.float32).numpy(), np.asarray(deq)
    )


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 16), (128, 1)])
def test_int8_leaf_byte_equal(shape):
    w = _normal(2, *shape)
    w[..., :, 0] = 0.0
    want = jq.quantize_leaf(jnp.asarray(w))
    got = tq.quantize_leaf(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        tq.dequantize_leaf(got, torch.float32).numpy(),
        np.asarray(jq.dequantize_leaf(want, jnp.float32)),
    )


def test_quantize_rows_int8_byte_equal():
    x = _normal(3, 5, 64) * 3
    x[2] = 0.0
    xq, sx = tmm.quantize_rows_int8(torch.from_numpy(x))
    jxq, jsx = jmm.quantize_rows_int8(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


@pytest.fixture(scope="module")
def tiny_params():
    prompt = jnp.zeros((1, 8), jnp.int32)
    return nn.meta.unbox(jax.jit(JaxTransformer(JAX_TINY).init)(jax.random.key(0), prompt)["params"])


@pytest.fixture(scope="module")
def jax_trees(tiny_params):
    """The eager JAX ``quantize_tree`` of the tiny model, by (bits, group),
    built once per module."""
    cache = {}

    def get(bits, group):
        if (bits, group) not in cache:
            cache[bits, group] = jq.quantize_tree(tiny_params, bits=bits, group_size=group)
        return cache[bits, group]

    return get


@pytest.mark.parametrize("bits,group", [(8, 128), (4, 16)])
def test_quantize_tree_matches_jax(tiny_params, jax_trees, bits, group):
    """The port's ``quantize_tree`` over its state dict equals the JAX tree
    carried across by ``from_flax_params`` (no transpose of quantized
    nodes), key for key and byte for byte; the dequantized state dict and
    the served bytes agree too."""
    sd = from_flax_params(tiny_params, CONFIG_TINY)
    got = tq.quantize_tree(sd, bits=bits, group_size=group)
    jtree = jax_trees(bits, group)
    want = from_flax_params(jax.tree.map(np.asarray, jtree), CONFIG_TINY)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    assert "blocks.0.attn.query.weight" not in got and "tok_embed.weight" in got
    assert tq.quantized_bytes(got) == jq.quantized_bytes(jtree)
    deq = tq.dequantize_tree(got, torch.float32)
    want_deq = from_flax_params(
        jax.tree.map(np.asarray, jq.dequantize_tree(jtree, jnp.float32)), CONFIG_TINY
    )
    assert sorted(deq) == sorted(want_deq)
    for name in want_deq:
        np.testing.assert_array_equal(deq[name].numpy(), want_deq[name].numpy(), err_msg=name)


def test_quantize_tree_rejects():
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        tq.quantize_tree({}, bits=2)
    with pytest.raises(NotImplementedError, match="MoE slice"):
        tq.quantize_tree({"blocks.0.moe.up": torch.zeros(2, 4, 4)}, bits=4)
    for fn in (jq.quantize_leaf_int4, tq.quantize_leaf_int4):
        lib = jnp if fn is jq.quantize_leaf_int4 else torch
        with pytest.raises(ValueError, match="even contraction dim"):
            fn(lib.zeros((3, 4)), 1)
        with pytest.raises(ValueError, match="not divisible by group_size"):
            fn(lib.zeros((12, 4)), 8)
        with pytest.raises(ValueError, match="group_size must be >= 1"):
            fn(lib.zeros((4, 4)), 0)


def test_caster_keeps_quantized_nodes(tiny_params, jax_trees):
    """The serving caster with ``dequantize``: packed bytes and fp32 scales
    stay as they are, embeddings and norms cast; the JAX caster gives the
    same dtype to every leaf. Without ``dequantize`` every float casts."""
    jtree = jax_trees(4, 16)
    qsd = tq.quantize_tree(from_flax_params(tiny_params, CONFIG_TINY), bits=4, group_size=16)
    got = make_param_caster(torch.bfloat16, "cpu", dequantize=True)(qsd)
    jcast = jax_decoding.make_param_caster(jnp.bfloat16, dequantize=True)(jtree)
    assert sorted(str(a.dtype) for a in jax.tree.leaves(jcast)) == sorted(
        str(t.dtype).replace("torch.", "") for t in got.values())
    assert got["blocks.0.attn.query.scale"].dtype == torch.float32
    assert got["lm_head.scale"].dtype == torch.float32
    assert got["blocks.1.ff.down.q4"].dtype == torch.uint8
    assert got["tok_embed.weight"].dtype == torch.bfloat16
    assert got["blocks.0.ln_attn.weight"].dtype == torch.bfloat16
    assert list(got) == list(qsd)
    torch.testing.assert_close(got["lm_head.scale"], qsd["lm_head.scale"], rtol=0, atol=0)
    plain = make_param_caster(torch.bfloat16, "cpu")(qsd)
    assert plain["lm_head.scale"].dtype == torch.bfloat16


MATMUL_SHAPES = [(4, 64, 48, 16), (4, 256, 128, 128), (4, 64, 48, 64), (37, 64, 96, 16)]


@pytest.mark.parametrize("m,k,n,g", MATMUL_SHAPES)
def test_int4_matmul_plain_matches_pallas(m, k, n, g):
    w, x = _normal(10, k, n), _normal(11, m, k)
    node = _jnode(w, g)
    gg = min(g, k)
    with jax.default_matmul_precision("float32"):
        want = jmm.int4_matmul(jnp.asarray(x), node["q4"], node["scale"], group=gg,
                               interpret=True)
    got = tmm.int4_matmul(torch.from_numpy(x), _t(node["q4"]), _t(node["scale"]), group=gg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("m,k,n,g", MATMUL_SHAPES)
def test_int4_matmul_w4a8_plain_matches_pallas(m, k, n, g):
    """An integer computation with an fp32 epilogue: float tolerance."""
    w, x = _normal(12, k, n), _normal(13, m, k)
    node = _jnode(w, g)
    gg = min(g, k)
    want = jmm.int4_matmul(jnp.asarray(x), node["q4"], node["scale"], group=gg,
                           interpret=True, w4a8=True)
    got = tmm.int4_matmul(torch.from_numpy(x), _t(node["q4"]), _t(node["scale"]), group=gg,
                          w4a8=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize("m,k,n,g", [(4, 64, 48, 16), (9, 256, 128, 128)])
def test_int4_matmul3_plain_matches_pallas(m, k, n, g):
    x = _normal(14, m, k)
    nodes = [_jnode(_normal(15 + i, k, n), g) for i in range(3)]
    gg = min(g, k)
    with jax.default_matmul_precision("float32"):
        want = jmm.int4_matmul3(jnp.asarray(x), [(a["q4"], a["scale"]) for a in nodes],
                                group=gg, interpret=True)
    got = tmm.int4_matmul3(torch.from_numpy(x), [(_t(a["q4"]), _t(a["scale"])) for a in nodes],
                           group=gg)
    for g_out, w_out in zip(got, want):
        np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), atol=1e-4)


def test_odd_long_prefill_rows_match_pallas():
    """M = 1001 rows at K = 3072: past the JAX kernel's row budget and not a
    multiple of 8 (its padded row tiles); the JAX test's tolerance."""
    w, x = _normal(20, 3072, 128), _normal(21, 1001, 3072)
    node = _jnode(w, 128)
    with jax.default_matmul_precision("float32"):
        want = jmm.int4_matmul(jnp.asarray(x), node["q4"], node["scale"], interpret=True)
    got = tmm.int4_matmul(torch.from_numpy(x), _t(node["q4"]), _t(node["scale"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=1e-4)


@pytest.mark.parametrize(
    "m,block_m,k,hidden,g",
    [(4, 128, 64, 256, 16), (4, 128, 128, 256, 128), (37, 16, 64, 128, 64)],
)
def test_int4_ff_plain_matches_pallas(m, block_m, k, hidden, g):
    """``block_m`` is the JAX kernel's row tile (M=37 over tiles of 16);
    the port's kernel picks its own tiles."""
    n1, n2 = _jnode(_normal(30, k, hidden), g), _jnode(_normal(31, hidden, k), g)
    x = _normal(32, m, k)
    with jax.default_matmul_precision("float32"):
        want = jff.int4_ff(jnp.asarray(x), n1["q4"], n1["scale"], n2["q4"], n2["scale"],
                           group=g, block_h=64, block_m=block_m, interpret=True)
    got = tff.int4_ff(torch.from_numpy(x), _t(n1["q4"]), _t(n1["scale"]), _t(n2["q4"]),
                      _t(n2["scale"]), group=g, block_h=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-4)


@pytest.fixture(scope="module")
def bf16_cases():
    """bf16 x through w4a16 (M=37, group 64), the q/k/v triple (M=8, group
    16) and the whole FF (M=37, group 64): each kernel's JAX output, computed
    once, and the port's call on the same packed weights."""
    x = _normal(50, 37, 256)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    mm = _jnode(_normal(51, 256, 128), 64)
    qkv = [_jnode(_normal(52 + i, 256, 128), 16) for i in range(3)]
    ff = [_jnode(_normal(55, 128, 256), 64), _jnode(_normal(56, 256, 128), 64)]
    ff_args = [a[key] for a in ff for key in ("q4", "scale")]
    calls = {
        "int4_matmul": (
            lambda: jmm.int4_matmul(xj[:37], mm["q4"], mm["scale"], group=64, interpret=True),
            lambda: tmm.int4_matmul(xt[:37], _t(mm["q4"]), _t(mm["scale"]), group=64)),
        "int4_matmul3": (
            lambda: jnp.concatenate(jmm.int4_matmul3(
                xj[:8], [(a["q4"], a["scale"]) for a in qkv], group=16, interpret=True), -1),
            lambda: torch.cat(tmm.int4_matmul3(
                xt[:8], [(_t(a["q4"]), _t(a["scale"])) for a in qkv], group=16), -1)),
        "int4_ff": (
            lambda: jff.int4_ff(xj[:, :128], *ff_args, group=64, block_h=64, interpret=True),
            lambda: tff.int4_ff(xt[:, :128], *map(_t, ff_args), group=64, block_h=64)),
    }
    return {name: (np.asarray(jcall().astype(jnp.float32)), tcall)
            for name, (jcall, tcall) in calls.items()}


def _within_one_bf16_ulp(got: torch.Tensor, want: np.ndarray) -> bool:
    """Every element within one bf16 ulp of the JAX one: the fp32 sums may
    differ in order and round the other way, nothing more."""
    assert got.dtype == torch.bfloat16
    ulp = np.spacing(np.abs(want)) * 2.0**16     # fp32 spacing → bf16's
    return bool(np.all(np.abs(got.float().numpy() - want) <= ulp))


@pytest.mark.parametrize("kernel", ["int4_matmul", "int4_matmul3", "int4_ff"])
def test_bf16_plain_matches_pallas(bf16_cases, kernel):
    """The bf16 numerics: w4a16 rounds each dequantized weight to x's dtype;
    the FF rounds its up weights but keeps u and the down weights in fp32.
    The plain versions agree with the Pallas kernels to one bf16 ulp."""
    want, port = bf16_cases[kernel]
    assert _within_one_bf16_ulp(port(), want)


def _dequant_halves_to(dtype):
    """A ``_dequant_halves`` that rounds to ``dtype``, whatever it is asked
    for, and hands back fp32 (every caller multiplies in fp32)."""
    real = tmm._dequant_halves
    return lambda q4, scale, group, _asked: tuple(
        h.float() for h in real(q4, scale, group, dtype))


_gelu = torch.nn.functional.gelu


def _gelu_in_bf16(v, approximate="none"):
    return _gelu(v, approximate=approximate).bfloat16().float()


@pytest.mark.parametrize(
    "kernel,module,name,mutant",
    [("int4_matmul", tmm, "_dequant_halves", _dequant_halves_to(torch.float32)),
     ("int4_ff", tff, "_dequant_halves", _dequant_halves_to(torch.bfloat16)),
     ("int4_ff", torch.nn.functional, "gelu", _gelu_in_bf16)],
    ids=["w4a16-weights-unrounded", "ff-down-weights-bf16", "ff-u-bf16"],
)
def test_bf16_check_catches_misrounding(bf16_cases, monkeypatch, kernel, module, name, mutant):
    """The one-ulp check above is sharp enough: a plain version that skips
    the weight rounding, or rounds the FF's down weights or u to bf16,
    fails it."""
    want, port = bf16_cases[kernel]
    monkeypatch.setattr(module, name, mutant)
    assert not _within_one_bf16_ulp(port(), want)


@pytest.mark.parametrize(
    "k,hidden,group,block_h",
    [(64, 128, 16, 256), (768, 3072, 128, 256), (64, 128, 128, 256), (96, 128, 32, 256),
     (64, 96, 64, 256), (64, 200, 16, 24), (62, 128, 16, 256), (64, 130, 16, 256),
     (64, 384, 48, 256)],
)
def test_int4_ff_eligibility_matches_jax(k, hidden, group, block_h):
    """Routing decides numerics: the port's eligibility and hidden tiling
    are the JAX functions' exactly."""
    assert tff.int4_ff_eligible(k, hidden, group, block_h) == jff.int4_ff_eligible(
        k, hidden, group, block_h)
    for g_dn in (1, 16, 48):
        assert tff._pick_block_h(hidden // 2, g_dn, block_h) == jff._pick_block_h(
            hidden // 2, g_dn, block_h)


def _raises_same(jax_call, torch_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        torch_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "x_shape,q_shape,s_rows,group,block_n",
    [((2, 64), (16, 8), 4, 128, None),         # contraction dim
     ((2, 96), (48, 8), 3, 32, None),          # group does not divide K/2
     ((2, 256), (128, 8), 4, 128, None),       # quantized with another group
     ((2, 64), (32, 24), 4, 16, 16)],          # block_n does not divide N
)
def test_validation_errors_match_jax(x_shape, q_shape, s_rows, group, block_n):
    for kw in ({}, {"w4a8": True}):
        _raises_same(
            lambda: jmm.int4_matmul(jnp.zeros(x_shape), jnp.zeros(q_shape, jnp.uint8),
                                    jnp.ones((s_rows, q_shape[1])), group=group,
                                    block_n=block_n, interpret=True, **kw),
            lambda: tmm.int4_matmul(torch.zeros(x_shape), torch.zeros(q_shape, dtype=torch.uint8),
                                    torch.ones(s_rows, q_shape[1]), group=group,
                                    block_n=block_n, **kw),
        )


def test_triple_and_ff_validation_errors_match_jax():
    jw = [(jnp.zeros((32, 8), jnp.uint8), jnp.ones((4, 8)))] * 2
    tw = [(torch.zeros(32, 8, dtype=torch.uint8), torch.ones(4, 8))] * 2
    x_j, x_t = jnp.zeros((2, 64)), torch.zeros(2, 64)
    _raises_same(lambda: jmm.int4_matmul3(x_j, jw, group=16, interpret=True),
                 lambda: tmm.int4_matmul3(x_t, tw, group=16))
    jw3 = jw + [(jnp.zeros((32, 16), jnp.uint8), jnp.ones((4, 16)))]
    tw3 = tw + [(torch.zeros(32, 16, dtype=torch.uint8), torch.ones(4, 16))]
    _raises_same(lambda: jmm.int4_matmul3(x_j, jw3, group=16, interpret=True),
                 lambda: tmm.int4_matmul3(x_t, tw3, group=16))
    jw3 = jw + [(jnp.zeros((32, 8), jnp.uint8), jnp.ones((2, 8)))]
    tw3 = tw + [(torch.zeros(32, 8, dtype=torch.uint8), torch.ones(2, 8))]
    _raises_same(lambda: jmm.int4_matmul3(x_j, jw3, group=16, interpret=True),
                 lambda: tmm.int4_matmul3(x_t, tw3, group=16))
    for dn_shape in ((64, 32), (60, 64)):      # shape mismatches: K out, hidden
        args_j = [jnp.zeros((32, 128), jnp.uint8), jnp.ones((4, 128)),
                  jnp.zeros(dn_shape, jnp.uint8), jnp.ones((8, dn_shape[1]))]
        args_t = [torch.zeros(32, 128, dtype=torch.uint8), torch.ones(4, 128),
                  torch.zeros(dn_shape, dtype=torch.uint8), torch.ones(8, dn_shape[1])]
        _raises_same(lambda: jff.int4_ff(x_j, *args_j, group=16, interpret=True),
                     lambda: tff.int4_ff(x_t, *args_t, group=16))
    _raises_same(  # not eligible: group 24 does not divide K/2 = 32
        lambda: jff.int4_ff(x_j, jnp.zeros((32, 128), jnp.uint8), jnp.ones((2, 128)),
                            jnp.zeros((64, 64), jnp.uint8), jnp.ones((5, 64)), group=24,
                            interpret=True),
        lambda: tff.int4_ff(x_t, torch.zeros(32, 128, dtype=torch.uint8), torch.ones(2, 128),
                            torch.zeros(64, 64, dtype=torch.uint8), torch.ones(5, 64), group=24),
    )


def test_kernel_wrappers_reject_other_devices():
    """A CPU tensor runs the plain version, a CUDA tensor the kernel; any
    other device raises instead of falling back."""
    q4, s = torch.zeros(32, 8, dtype=torch.uint8, device="meta"), torch.ones(1, 8, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmm.int4_matmul(torch.zeros(2, 64, device="meta"), q4, s)
    with pytest.raises(NotImplementedError, match="slice A"):
        tmm.make_int4_matmul_fn(None, None)


@pytest.mark.parametrize("activation_bits", [16, 8])
def test_int4_linear_matches_int4_dense(activation_bits):
    """``Int4Linear`` against the JAX ``Int4Dense``: the kernel route
    (group dividing K/2, with a bias) and the layout route of an odd group
    count (dequantize + plain product), where w4a8 raises the same error."""
    for k, n, g in ((64, 24, 16), (96, 8, 32)):
        node = _jnode(_normal(40, k, n), g)
        bias = _normal(41, n)
        x = _normal(42, 3, k)
        jmod = jq.Int4Dense(features=n, use_bias=True, dtype=jnp.float32, group_size=g,
                            activation_bits=activation_bits)
        variables = {"params": {"kernel": node, "bias": bias}}
        tmod = tq.Int4Linear(k, n, use_bias=True, dtype=torch.float32, group_size=g,
                             activation_bits=activation_bits, device="cpu")
        tmod.load_state_dict({"q4": _t(node["q4"]), "scale": _t(node["scale"]),
                              "bias": _t(bias)})
        if activation_bits == 8 and (k // 2) % g:
            _raises_same(lambda: jmod.apply(variables, jnp.asarray(x)),
                         lambda: tmod(torch.from_numpy(x)))
            continue
        with jax.default_matmul_precision("float32"):
            want = jmod.apply(variables, jnp.asarray(x))
        np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(want), rtol=2e-6, atol=1e-4)


def test_projection_dense_dispatch():
    dense = tq.projection_dense(quantization=None, in_features=8, features=4, use_bias=False,
                                dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    assert isinstance(dense, torch.nn.Linear)
    q = tq.projection_dense(quantization="int4_w4a8", in_features=8, features=4,
                            use_bias=False, dtype=torch.bfloat16,
                            param_dtype=torch.bfloat16, group_size=4, device="cpu")
    assert isinstance(q, tq.Int4Linear) and q.activation_bits == 8
    assert q.scale.dtype == torch.float32 and tuple(q.q4.shape) == (4, 4)
    with pytest.raises(ValueError, match="unknown quantization 'int2'"):
        tq.projection_dense(quantization="int2", in_features=8, features=4, use_bias=False,
                            dtype=torch.float32, param_dtype=torch.float32)
    cfg = dataclasses.replace(CONFIG_TINY, quantization="int4")
    assert cfg.quantization_group == 128
