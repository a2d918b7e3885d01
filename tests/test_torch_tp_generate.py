"""The port's tensor-parallel generate against the JAX package's.

``CONFIG_TINY`` with ``quantization_group=16`` in fp32 and the blocked
decode backend, on a (2, 2) ``data`` × ``model`` mesh under ``RULES_DP_TP``:
the JAX ``make_generate_fn(cfg, mesh22, RULES_DP_TP)`` (its kernels under
``shard_map``, Pallas in interpret mode) and the port's, four ``gloo``
ranks of one spawn, on the same JAX-initialised weights and int4 tree
(``from_flax_params``). Greedy tokens identical in float, ``"fused"`` and
``"fused_w4a8"``. Then the per-shard kernel wrappers on seeded inputs:
``make_decode_attn_fn`` (atol = rtol = 1e-5, as
``tests/test_torch_decode_attention.py``) and ``make_int4_matmul_fn`` at a
column-parallel and a row-parallel site (against JAX at
``tests/test_torch_int4_decode.py``'s tolerances: w4a16 atol 1e-4, w4a8 rtol
2e-6 / atol 1e-5), each output laid out as JAX's; w4a8 also bit-equal to
the port's unsharded product (the activations quantized after the gather:
the same per-row scales, the same exact int32 sums).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import generate as jax_generate
from learning_jax_sharding_tpu.models import transformer as jax_transformer
from learning_jax_sharding_tpu.ops.decode_attention import make_decode_attn_fn
from learning_jax_sharding_tpu.ops.int4_matmul import make_int4_matmul_fn
from learning_jax_sharding_tpu.parallel.logical import EMBED, HEADS, RULES_DP_TP
from learning_jax_sharding_tpu_torch.models import transformer
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4
from learning_jax_sharding_tpu_torch.parallel import run_on_mesh, run_on_threads
from tests import _torch_mesh_bodies as bodies
from tests.test_torch_quantized_generate import _jax_quantize_tree

GROUP, NEW = 16, 6
JAX_CFG = dataclasses.replace(jax_transformer.CONFIG_TINY, quantization_group=GROUP,
                              decode_attention="blocked")
CFG = dataclasses.replace(transformer.CONFIG_TINY, quantization_group=GROUP)
MODES = {"float": False, "fused": "fused", "fused_w4a8": "fused_w4a8"}
SITES = {"column": (EMBED, HEADS), "row": (HEADS, EMBED)}


@pytest.fixture(scope="module")
def trees():
    prompt = np.random.default_rng(5).integers(0, CFG.vocab_size, (4, 8)).astype(np.int32)
    params = nn.meta.unbox(jax.jit(jax_transformer.Transformer(JAX_CFG).init)(
        jax.random.key(0), jnp.asarray(prompt))["params"])
    return prompt, {"float": params, "int4": _jax_quantize_tree(params, 4)}


@pytest.fixture(scope="module")
def kernel_inputs():
    rng = np.random.default_rng(3)
    decode = {"q": rng.standard_normal((4, 1, 4, 16)).astype(np.float32),
              "kc": rng.standard_normal((4, 4, 64, 16)).astype(np.float32),
              "vc": rng.standard_normal((4, 4, 64, 16)).astype(np.float32),
              "index": np.array(20, np.int32)}
    q4 = rng.integers(0, 256, (32, 64)).astype(np.uint8)
    scale = (0.05 + 0.1 * rng.random((4, 64))).astype(np.float32)
    x = rng.standard_normal((4, 2, 64)).astype(np.float32)
    return decode, {(name, axes): (x, q4, scale) for name, axes in SITES.items()}


@pytest.fixture(scope="module")
def jax_results(trees, kernel_inputs, mesh22):
    prompt, jtrees = trees
    decode, int4 = kernel_inputs
    out = {"tokens": {}, "int4": {}}
    with jax.default_matmul_precision("float32"):
        for mode, dq in MODES.items():
            tree = jtrees["float" if mode == "float" else "int4"]
            out["tokens"][mode] = np.asarray(jax_generate.make_generate_fn(
                JAX_CFG, mesh22, RULES_DP_TP, max_new_tokens=NEW, dequantize=dq,
            )(tree, jnp.asarray(prompt), jax.random.key(0)))
        fn = make_decode_attn_fn(mesh22, RULES_DP_TP, interpret=True)
        out["decode"] = np.asarray(fn(*(jnp.asarray(decode[n]) for n in ("q", "kc", "vc")),
                                      jnp.asarray(decode["index"])))
        for (name, axes), args in int4.items():
            for w4a8 in (False, True):
                got = make_int4_matmul_fn(mesh22, RULES_DP_TP, w4a8=w4a8)(
                    *(jnp.asarray(a) for a in args), group=GROUP, kernel_axes=axes)
                out["int4"][name, w4a8] = (np.asarray(got), got.sharding.spec)
    return out


@pytest.fixture(scope="module")
def port(trees, kernel_inputs):
    prompt, jtrees = trees
    float_sd, q4_sd = ({k: t.numpy() for k, t in
                        from_flax_params(jax.tree.map(np.asarray, jtrees[w]), CFG).items()}
                       for w in ("float", "int4"))
    return run_on_mesh(bodies.generate_body, (2, 2), ("data", "model"),
                       args=(float_sd, q4_sd, prompt, NEW, GROUP, *kernel_inputs))


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_equal_jax(mode, port, jax_results):
    np.testing.assert_array_equal(port["tokens"][mode], jax_results["tokens"][mode])


@pytest.fixture(scope="module")
def port_threads(trees, kernel_inputs):
    """The same body with the four ranks as threads of this process (how
    one card carries a (2, 2) mesh)."""
    prompt, jtrees = trees
    float_sd, q4_sd = ({k: t.numpy() for k, t in
                        from_flax_params(jax.tree.map(np.asarray, jtrees[w]), CFG).items()}
                       for w in ("float", "int4"))
    return run_on_threads(bodies.generate_body, (2, 2), ("data", "model"),
                          args=(float_sd, q4_sd, prompt, NEW, GROUP, *kernel_inputs))


@pytest.mark.parametrize("mode", list(MODES))
def test_ranks_as_threads_give_jax_tokens(mode, port_threads, port, jax_results):
    np.testing.assert_array_equal(port_threads["tokens"][mode], jax_results["tokens"][mode])
    np.testing.assert_array_equal(port_threads["decode"], port["decode"])
    for key, (got, placements) in port_threads["int4"].items():
        np.testing.assert_array_equal(got, port["int4"][key][0])
        assert placements == port["int4"][key][1]


def test_decode_attn_fn_over_the_mesh_equals_jax(port, jax_results):
    np.testing.assert_allclose(port["decode"], jax_results["decode"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("w4a8", [False, True], ids=["w4a16", "w4a8"])
@pytest.mark.parametrize("site", list(SITES))
def test_int4_matmul_fn_over_the_mesh_equals_jax(site, w4a8, port, jax_results, kernel_inputs):
    got, placements = port["int4"][site, w4a8]
    want, spec = jax_results["int4"][site, w4a8]
    if w4a8:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-5)
        x, q4, scale = next(v for (n, _), v in kernel_inputs[1].items() if n == site)
        whole = mm4.int4_matmul(*(torch.from_numpy(a) for a in (x, q4, scale)), group=GROUP,
                                w4a8=True)
        np.testing.assert_array_equal(got, whole.numpy())
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)
    # Column-parallel: the output's columns stay over model, no collective;
    # row-parallel: the activation columns gathered, the output whole.
    assert spec[-1] == ("model" if site == "column" else None)
    assert placements[1] == ("Shard(dim=2)" if site == "column" else "Replicate()")
    assert placements[0] == "Shard(dim=0)" and spec[0] == "data"
