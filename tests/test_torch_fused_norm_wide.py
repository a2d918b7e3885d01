"""The port's fused residual+norm at every width the JAX kernel takes.

The JAX kernel puts no bound on the feature width, and neither do the
port's kernels: 16-byte loads where the width is a multiple of 16 bytes,
one-element loads otherwise; a row past ``PASS_FEATURES`` (one pass of the
widest row group) in several passes. Here, on the CPU:

- the plain versions (what the port runs for CPU tensors, and what the
  kernels are held to on the card) against the Pallas kernels in interpret
  mode at the 1.4B width (2048) and at an odd width (1001), forward and
  VJP: fp32 within rtol 1e-5 (gradients 3e-4), bf16 within one bf16 ulp
  with the new residual bit-equal; and past one pass (16385, 20000) in
  fp32;
- the wrapper's checks at those widths, and past one pass;
- ``_design``'s geometry and the grids at the main paths' shapes, and the
  instantiations ``csrc/fused_norm.cu`` holds for every geometry it picks.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.ops.fused_norm import fused_residual_norm as jax_fused
from learning_jax_sharding_tpu_torch.ops import fused_norm as fn
from tests.test_torch_fused_norm import _jax_side, _port_side, _within_one_bf16_ulp
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

CASES = [("layernorm", True, True), ("rmsnorm", False, False)]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, dtype, m, resid, beta, shape=(2, 4)):
    """numpy inputs and cotangents of ``shape + (m,)``; row tensors exactly
    representable in ``dtype``, gamma/beta fp32 as model params."""
    rng = np.random.default_rng(seed)
    names = ["x", "dy", "dr"] + (["res"] if resid else [])
    out = {}
    for name in names:
        a = torch.from_numpy(rng.normal(size=(*shape, m)).astype(np.float32))
        out[name] = a.to(TORCH_DTYPES[dtype]).float().numpy()
    out["g"] = rng.normal(size=m).astype(np.float32)
    if beta:
        out["b"] = rng.normal(size=m).astype(np.float32)
    return out


@pytest.mark.parametrize("m", [2048, 1001])
@pytest.mark.parametrize("kind,resid,beta", CASES, ids=["layernorm-resid-beta", "rmsnorm-plain"])
def test_fp32_plain_matches_pallas_wide(m, kind, resid, beta):
    a = _arrays(m, "float32", m, resid, beta)
    want, got = _jax_side(a, "float32", kind), _port_side(a, "float32", kind)
    for name in ("y", "r"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("dx", "dres", "dg", "db"):
        assert (got[name] is None) == (want[name] is None), name
        if want[name] is not None:
            np.testing.assert_allclose(got[name], want[name], rtol=3e-4, atol=3e-4,
                                       err_msg=name)


@pytest.mark.parametrize("m", [2048, 1001])
@pytest.mark.parametrize("kind,resid,beta", CASES, ids=["layernorm-resid-beta", "rmsnorm-plain"])
def test_bf16_plain_matches_pallas_wide(m, kind, resid, beta):
    """bf16 rows, fp32 params: y and dx within one bf16 ulp, the new
    residual bit-equal, dgamma/dbeta (fp32 sums) within rtol 1e-5."""
    a = _arrays(m + 1, "bfloat16", m, resid, beta)
    want, got = _jax_side(a, "bfloat16", kind), _port_side(a, "bfloat16", kind)
    np.testing.assert_array_equal(got["r"], want["r"])
    for name in ("y", "dx", "dres"):
        if want[name] is not None:
            assert _within_one_bf16_ulp(got[name], want[name]), name
    for name in ("dg", "db"):
        if want[name] is not None:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-5 * np.abs(want[name]).max(), err_msg=name)


def test_odd_width_without_residual_matches_pallas():
    """12 features (the width the first design refused): one whole tile."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 12)).astype(np.float32)
    g = rng.normal(size=12).astype(np.float32)
    want, _ = jax_fused(jnp.asarray(x), None, jnp.asarray(g), kind="layernorm", interpret=True)
    got, _ = fn.fused_residual_norm(torch.from_numpy(x), None, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [12, 1000, 1001, 2048, 8192, fn.PASS_FEATURES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_cuda_takes_every_width_up_to_the_widest(m, dtype):
    rows = 3
    x = torch.zeros(rows, m, dtype=dtype)
    fn._check_cuda(x, torch.ones(m), resid=x.clone(), beta=torch.zeros(m), y=x.clone())


def test_check_cuda_refuses_past_the_widest_with_the_width():
    """Past one pass every width is taken (the wide kernels); an empty row
    and the first design's limit are refused, with the width."""
    for m in (fn.PASS_FEATURES + 1, 32768):
        fn._check_cuda(torch.zeros(2, m), torch.ones(m), resid=torch.zeros(2, m))
    with pytest.raises(ValueError, match="at least 1 feature, got 0"):
        fn._check_cuda(torch.zeros(2, 0), torch.ones(0))
    with pytest.raises(ValueError, match="warp_row design takes features a multiple of 8 up "
                                         "to 1024, got 2048"):
        fn._check_cuda(torch.zeros(2, 2048), torch.ones(2048), warp_row=True)


# Main-path shapes → (forward, backward) geometry: the 125M width (768) and
# the 1.4B width (2048) in bf16 (the models' compute dtype) and fp32.
DESIGNS = {
    (torch.bfloat16, 768): (fn.Design(8, 1, 96, 1), fn.Design(8, 1, 96, 3)),
    (torch.float32, 768): (fn.Design(4, 1, 192, 1), fn.Design(4, 1, 192, 1)),
    (torch.bfloat16, 2048): (fn.Design(8, 1, 256, 1), fn.Design(8, 1, 256, 1)),
    (torch.float32, 2048): (fn.Design(4, 1, 512, 1), fn.Design(4, 1, 512, 1)),
}


@pytest.mark.parametrize("rows", [8, 37, 512, 1024, 8192])
@pytest.mark.parametrize("dtype,m", list(DESIGNS), ids=["bf16-768", "fp32-768", "bf16-2048",
                                                        "fp32-2048"])
def test_design_at_the_main_path_shapes(rows, dtype, m):
    """A row spreads over as many warps as 16-byte loads take, one load a
    thread: the 8 rows of a decode step are 8 blocks of 96 (768) or 256
    (2048) threads. The backward packs row groups into blocks of up to 288
    threads, never more than the rows."""
    fwd, bwd = DESIGNS[dtype, m]
    assert fn._design(rows, m, dtype) == fwd
    assert fn._design(rows, m, dtype, backward=True) == bwd._replace(
        groups=min(bwd.groups, rows))


@pytest.mark.parametrize("rows,per_sm,blocks", [(8, 16, 8), (37, 16, 37), (1024, 16, 1024),
                                                (8192, 16, 2112), (8192, 5, 660)])
def test_forward_grid_spreads_rows_then_streams(rows, per_sm, blocks):
    """One block a row while the card holds them all; past that every
    resident block streams rows."""
    assert fn._fwd_blocks(rows, 132, per_sm) == blocks
    assert fn._fwd_blocks(rows, 114, per_sm) == min(rows, 114 * per_sm)   # an H100 PCIe


@pytest.mark.parametrize("rows,cluster,clusters,blocks", [
    (1, 1, 40, 1), (8, 2, 40, 4), (37, 8, 40, 16), (8192, 8, 33, 264), (8192, 8, 60, 480),
])
def test_backward_grid_in_whole_clusters(rows, cluster, clusters, blocks):
    """Blocks come in clusters of up to 8 (fewer when the rows do not fill
    them: 8 rows are 3 blocks of 3 row groups, so clusters of 2), one block
    for every 3 rows at 768 bf16 features, rounded up to whole clusters, at
    most as many clusters as the card holds at once."""
    d = fn._design(rows, 768, torch.bfloat16, backward=True)
    assert fn._bwd_cluster(rows, d) == cluster
    assert fn._bwd_blocks(rows, d, cluster, clusters) == blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_design_covers_every_width_with_an_instantiated_kernel(dtype):
    """For every width up to the widest: the row group covers the row with
    whole warps of at most 512 threads, wasting less than one warp's loads,
    and ``csrc/fused_norm.cu`` instantiates its (vec, vectors) pair."""
    source = (Path(fn.__file__).parent.parent / "csrc" / "fused_norm.cu").read_text()
    picked = re.search(r"auto pick_nv\(int nv\).*?return nullptr;", source, re.S).group(0)
    cases = [tuple(map(int, re.findall(r"NV_CASE\((\d+)\)", branch)))
             for branch in re.findall(r"\{\s*(NV_CASE[^}]*)\}", picked)]
    elements, bf16_vectors, fp32_vectors = cases
    assert elements == fn.ELEMENT_CHOICES
    assert {torch.bfloat16: bf16_vectors, torch.float32: fp32_vectors}[dtype] == \
        fn.VECTOR_CHOICES[dtype]
    full = 16 // torch.tensor([], dtype=dtype).element_size()
    for m in list(range(1, 2100)) + list(range(2100, fn.PASS_FEATURES + 1, 97)) + [
            fn.PASS_FEATURES]:
        d = fn._design(1, m, dtype)
        assert d.vec == (full if m % full == 0 else 1), m
        per_warp = 32 * d.vec * d.vectors
        assert d.threads % 32 == 0 and 32 <= d.threads <= fn.MAX_THREADS, (m, d)
        assert m <= d.threads * d.vec * d.vectors < m + per_warp, (m, d)
        choices = fn.VECTOR_CHOICES[dtype] if d.vec > 1 else fn.ELEMENT_CHOICES
        assert d.vectors in choices, (m, d)
        assert d.passes == 1, (m, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [16385, 20000, 24576, 32768, 50001])
def test_design_past_one_pass_takes_the_widest_geometry_in_passes(dtype, m):
    """Past one pass: 512 threads with the most loads a thread (a wide kernel
    of ``csrc/fused_norm.cu`` for each load width), one row group a block,
    forward and backward, and just enough segments to cover the row."""
    full = 16 // torch.tensor([], dtype=dtype).element_size()
    vec = full if m % full == 0 else 1
    choices = fn.VECTOR_CHOICES[dtype] if vec > 1 else fn.ELEMENT_CHOICES
    for backward in (False, True):
        d = fn._design(64, m, dtype, backward=backward)
        seg = d.threads * d.vec * d.vectors
        assert (d.vec, d.vectors, d.threads, d.groups) == (vec, choices[-1], fn.MAX_THREADS, 1)
        assert seg == fn.PASS_FEATURES
        assert seg * (d.passes - 1) < m <= seg * d.passes, (m, d)
    source = (Path(fn.__file__).parent.parent / "csrc" / "fused_norm.cu").read_text()
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert re.search(rf"WIDE_CASE\({code}, \w+, {vec}, {choices[-1]}\)", source)


@pytest.mark.parametrize("m", [16385, 20000])
@pytest.mark.parametrize("kind,resid,beta", CASES, ids=["layernorm-resid-beta", "rmsnorm-plain"])
def test_fp32_plain_matches_pallas_past_one_pass(m, kind, resid, beta):
    """The plain versions the wide kernels are held to, against the Pallas
    kernels in interpret mode, a few rows past one pass."""
    a = _arrays(m, "float32", m, resid, beta, shape=(1, 8))
    want, got = _jax_side(a, "float32", kind), _port_side(a, "float32", kind)
    for name in ("y", "r"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("dx", "dres", "dg", "db"):
        assert (got[name] is None) == (want[name] is None), name
        if want[name] is not None:
            np.testing.assert_allclose(got[name], want[name], rtol=3e-4, atol=3e-4,
                                       err_msg=name)


def test_a_cpu_call_launches_nothing():
    fn.fused_residual_norm.launches = dict.fromkeys(fn.fused_residual_norm.launches, 0)
    x = torch.randn(4, 2048, requires_grad=True)
    y, r = fn.fused_residual_norm(x, torch.randn(4, 2048), torch.ones(2048), torch.zeros(2048))
    y.sum().backward()
    assert fn.fused_residual_norm.launches == {"fwd": 0, "fwd_nostats": 0, "bwd": 0}
