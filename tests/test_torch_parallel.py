"""The port's sharding layer against the JAX package's.

In-process (no ranks): every ``RULES_*`` tuple equal to JAX's, the port's
resolver equal to flax's ``logical_to_mesh_axes`` for every rule set and
every parameter of ``CONFIG_TINY`` (the parameters' logical axes equal to
those the JAX model declares), ``MeshSpec`` and ``_infer_shape``.

One 8-rank ``gloo`` spawn (``parallel.run_on_mesh``) on the (2, 4) ``x`` ×
``y`` mesh of the conftest's ``mesh24``: cases 1a–4's shard shapes, distinct
shards and replication equal to JAX's ``shard_shapes`` /
``unique_shard_count`` / ``is_fully_replicated``, their collectives, and
the five collective matmuls against JAX's on the same numpy inputs (fp32,
atol 1e-5), each issuing the collective kind of its JAX counterpart.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import transformer as jax_transformer
from learning_jax_sharding_tpu.parallel import collectives as jax_coll
from learning_jax_sharding_tpu.parallel import logical as jax_logical
from learning_jax_sharding_tpu.parallel import mesh as jax_mesh
from learning_jax_sharding_tpu.parallel import (
    collective_counts as jax_counts,
    is_fully_replicated as jax_replicated,
    put as jax_put,
    shard_dims as jax_shard_dims,
    shard_shapes as jax_shard_shapes,
    unique_shard_count as jax_unique,
)
from learning_jax_sharding_tpu_torch import parallel
from learning_jax_sharding_tpu_torch.models import transformer
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params, param_logical_axes
from learning_jax_sharding_tpu_torch.parallel import logical, mesh
from tests import _torch_mesh_bodies as bodies

RULE_SETS = [name for name in dir(jax_logical) if name.startswith("RULES_")]


def test_rule_sets_and_names_equal_jax():
    assert RULE_SETS == [name for name in dir(logical) if name.startswith("RULES_")]
    for name in RULE_SETS:
        assert getattr(logical, name) == getattr(jax_logical, name), name
    for name in ("BATCH", "SEQ", "EMBED", "HEADS", "KV", "HIDDEN", "MLP", "VOCAB", "STAGE",
                 "EXPERT", "LAYERS"):
        assert getattr(logical, name) == getattr(jax_logical, name), name


@pytest.fixture(scope="module")
def jax_param_axes():
    """Each CONFIG_TINY parameter's logical axes as the JAX model declares
    them, keyed by the port's name, in the port's layout (an ``(in, out)``
    kernel's axes reversed for the ``(out, in)`` weight)."""
    model = jax_transformer.Transformer(jax_transformer.CONFIG_TINY)
    abstract = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((2, 8), jnp.int32))
    specs = nn.get_partition_spec(abstract)["params"]
    # Walk the spec tree with from_flax_params's name map: numbered leaves.
    index = {}

    def number(node, path=()):
        if isinstance(node, dict):
            return {k: number(v, path + (k,)) for k, v in node.items()}
        index[len(index)] = tuple(node)
        return np.full((1, 1) if len(node) == 2 else (1,), len(index) - 1, np.float32)

    numbered = from_flax_params(number(specs), transformer.CONFIG_TINY)
    # from_flax_params transposes the Dense kernels (2-D ``.weight``s but
    # the embedding), whose axes then read reversed.
    transposed = {n for n, t in numbered.items()
                  if t.ndim == 2 and n.endswith(".weight") and n != "tok_embed.weight"}
    return {name: index[int(t.flatten()[0])][::-1 if name in transposed else 1]
            for name, t in numbered.items()}


def test_param_axes_equal_the_jax_model(jax_param_axes):
    names = set(transformer.Transformer(transformer.CONFIG_TINY, device="cpu").state_dict())
    assert set(jax_param_axes) == names
    for name, axes in jax_param_axes.items():
        assert param_logical_axes(name) == axes, name


@pytest.mark.parametrize("rules", RULE_SETS)
def test_resolved_specs_equal_flax_for_every_parameter(rules, jax_param_axes):
    from flax.linen import partitioning as nnp

    for name, axes in jax_param_axes.items():
        want = tuple(nnp.logical_to_mesh_axes(axes, getattr(jax_logical, rules)))
        assert tuple(logical.logical_to_mesh_axes(axes, getattr(logical, rules))) == want, name
    # Activation specs too, where duplicate mesh axes are dropped.
    for axes in ((logical.BATCH, logical.SEQ, logical.EMBED),
                 (logical.BATCH, logical.SEQ, logical.VOCAB),
                 (logical.BATCH, logical.SEQ, logical.HEADS, logical.KV),
                 (logical.EXPERT, logical.EMBED, logical.MLP)):
        want = tuple(nnp.logical_to_mesh_axes(axes, getattr(jax_logical, rules)))
        assert tuple(logical.logical_to_mesh_axes(axes, getattr(logical, rules))) == want


def test_mesh_spec_and_inferred_shapes_equal_jax():
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 64):
        for ndim in (1, 2):
            assert mesh._infer_shape(n, ndim) == jax_mesh._infer_shape(n, ndim)
    with pytest.raises(ValueError, match="1D/2D"):
        mesh._infer_shape(8, 3)
    spec, jspec = mesh.MeshSpec((2, 4)), jax_mesh.MeshSpec((2, 4))
    assert (spec.shape, spec.axis_names, spec.size) == (jspec.shape, jspec.axis_names,
                                                        jspec.size)
    assert mesh.DEFAULT_AXIS_NAMES == jax_mesh.DEFAULT_AXIS_NAMES


def test_spec_to_placements_and_back():
    class Mesh:
        mesh_dim_names = ("x", "y")
        ndim = 2

    from torch.distributed.tensor import Replicate, Shard

    from learning_jax_sharding_tpu_torch.parallel.sharding import P, spec_to_placements

    assert spec_to_placements(Mesh, P(None, ("x", "y"))) == (Shard(1), Shard(1))
    assert spec_to_placements(Mesh, P("y", "x")) == (Shard(1), Shard(0))
    assert spec_to_placements(Mesh, P()) == (Replicate(), Replicate())
    with pytest.raises(NotImplementedError, match="mesh order"):
        spec_to_placements(Mesh, P(("y", "x")))
    with pytest.raises(ValueError, match="no axis"):
        spec_to_placements(Mesh, P("data"))


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 16)).astype(np.float32),
            rng.standard_normal((16, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def port(operands):
    return parallel.run_on_mesh(bodies.parallel_body, (2, 4), ("x", "y"), args=operands)


def _kinds(counts):
    return {k for k, n in counts.items() if n}


@pytest.mark.parametrize("case", list(bodies.CASES))
def test_case_layouts_equal_jax(case, port, operands, mesh24):
    sa, sb, _ = bodies.CASES[case]
    a_host, b_host = operands
    a, b = jax_put(a_host, jax_shard_dims(mesh24, 2, **sa)), jax_put(
        b_host, jax_shard_dims(mesh24, 2, **sb))
    c = jax.jit(jax.lax.dot)(a, b)
    got = port["cases"][case]
    assert got["a"] == jax_shard_shapes(a)
    assert got["b"] == jax_shard_shapes(b)
    assert got["c"] == jax_shard_shapes(c)
    assert got["unique"] == jax_unique(c)
    assert got["replicated"] == jax_replicated(c)
    np.testing.assert_allclose(got["value"], a_host @ b_host, atol=1e-5)
    want = jax_counts(jax.lax.dot, a, b)
    if case in ("1a", "4"):
        assert got["counts"] == want            # one all-reduce; none
    elif case in ("1b", "3"):
        assert "all-gather" in _kinds(got["counts"]) & _kinds(want)
    else:   # 2: the y-split contraction reduced, then C laid out over x
        assert "all-reduce" in _kinds(got["counts"]) & _kinds(want)


MATMULS = {
    "psum": lambda a, b, m: jax_coll.psum_matmul(a, b, mesh=m, axis="y"),
    "allgather": lambda a, b, m: jax_coll.allgather_matmul(a, b, mesh=m, a_axis="y",
                                                          b_axis="x"),
    "reduce_scatter": lambda a, b, m: jax_coll.reduce_scatter_matmul(a, b, mesh=m, axis="y"),
    "dp_tp": lambda a, b, m: jax_coll.dp_tp_matmul(a, b, mesh=m, dp_axis="x", tp_axis="y"),
    "ring": lambda a, b, m: jax_coll.ring_allgather_matmul(a, b, mesh=m, axis="y"),
}


@pytest.mark.parametrize("name", list(MATMULS))
def test_collective_matmuls_equal_jax(name, port, operands, mesh24):
    a, b = operands
    fn = MATMULS[name]
    want = fn(a, b, mesh24)
    got = port["matmuls"][name]
    np.testing.assert_allclose(got["value"], np.asarray(want), atol=1e-5)
    assert got["c"] == jax_shard_shapes(want)
    assert _kinds(got["counts"]) == _kinds(jax_counts(lambda a, b: fn(a, b, mesh24), a, b))


def test_later_slices_raise_naming_them():
    with pytest.raises(NotImplementedError, match="slice D"):
        parallel.build_hybrid_mesh((1, 4), (2, 1))
    with pytest.raises(NotImplementedError, match="slice F"):
        parallel.collectives.quantized_all_reduce(torch.zeros(8, 4), mesh=None, axis="x")
    with pytest.raises(NotImplementedError, match="slice G"):
        parallel.compiled_hlo(lambda: None)


def test_run_on_mesh_raises_a_rank_failure_with_its_traceback():
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank one's own failure"):
        parallel.run_on_mesh(bodies.failing_body, (1, 2), ("data", "model"), timeout=120)


def test_run_on_threads_raises_a_rank_failure_with_its_traceback():
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank one's own failure"):
        parallel.run_on_threads(bodies.failing_body, (1, 2), ("data", "model"))


def test_run_on_threads_equals_run_on_mesh(port, operands):
    """Cases 1a-4 and the collective matmuls with the eight ranks as threads
    of this process: the same layouts, values and collectives. The ring
    matmul stays out: the threaded group has no point-to-point sends."""
    got = parallel.run_on_threads(bodies.parallel_body, (2, 4), ("x", "y"),
                                  args=(*operands, False))
    assert set(got["matmuls"]) == set(port["matmuls"]) - {"ring"}
    for kind in ("cases", "matmuls"):
        for name, row in port[kind].items():
            if name not in got[kind]:
                continue
            for key, want in row.items():
                if key == "value":
                    np.testing.assert_allclose(got[kind][name][key], want, atol=1e-6)
                else:
                    assert got[kind][name][key] == want, (kind, name, key)
