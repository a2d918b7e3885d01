"""The port's decode attention (plain version) against the JAX kernel.

The JAX kernel runs in Pallas interpret mode, as the JAX package's own tests
run it on the CPU; the port's wrapper takes its plain PyTorch version for CPU
tensors. Same numpy-seeded inputs, fp32, atol = rtol = 1e-5. The CUDA kernel
itself is held against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.ops.decode_attention import (
    auto_block_k as jax_auto_block_k,
    decode_attention as jax_decode_attention,
)
from learning_jax_sharding_tpu_torch.ops import _build
from learning_jax_sharding_tpu_torch.ops.decode_attention import (
    auto_block_k,
    decode_attention,
)

torch.set_num_threads(1)

B, L, NKV, H = 2, 64, 2, 16
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, s, group, *, fold=False):
    rng = np.random.default_rng(seed)
    arrays = {
        "q": rng.normal(size=(B, s, NKV * group, H)),
        "kc": rng.normal(size=(B, NKV, L, H)),
        "vc": rng.normal(size=(B, NKV, L, H)),
    }
    if fold:
        arrays["k_new"] = rng.normal(size=(B, NKV, 1, H))
        arrays["v_new"] = rng.normal(size=(B, NKV, 1, H))
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _both(arrays, index, **kw):
    """Run the JAX kernel and the port on the same inputs → numpy results."""
    jx = {k: jnp.asarray(v) for k, v in arrays.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    extra_j, extra_t = {}, {}
    for name in ("k_new", "v_new"):
        if name in arrays:
            extra_j[name], extra_t[name] = jx[name], pt[name]
    if "write_enable" in kw:
        we = kw.pop("write_enable")
        extra_j["write_enable"] = jnp.asarray(we, jnp.int32)
        extra_t["write_enable"] = torch.tensor(we, dtype=torch.int32)
    ref = jax_decode_attention(
        jx["q"], jx["kc"], jx["vc"], jnp.asarray(index, jnp.int32),
        interpret=True, **extra_j, **kw,
    )
    out = decode_attention(
        pt["q"], pt["kc"], pt["vc"], torch.tensor(index, dtype=torch.int32),
        **extra_t, **kw,
    )
    if isinstance(ref, tuple):
        return [np.asarray(r) for r in ref], [o.numpy() for o in out]
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("s", [1, 5, 24])
def test_plain_matches_jax_kernel(s, per_row, group, window):
    index = [3, 40] if per_row else 20
    ref, out = _both(_inputs(s * 7 + group, s, group), index, window=window, block_k=16)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("s,block_q,group", [(7, 4, 1), (9, 2, 2), (24, 8, 2)])
def test_block_q_tiling(s, block_q, group):
    ref, out = _both(_inputs(s, s, group), 20, block_k=16, block_q=block_q)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("write_enable", [None, [1, 0]])
def test_folded_write(write_enable):
    arrays = _inputs(5, 1, 2, fold=True)
    kw = {} if write_enable is None else {"write_enable": write_enable}
    (ref, ref_k, ref_v), (out, out_k, out_v) = _both(arrays, [17, 9], block_k=16, **kw)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(out_k, ref_k)
    np.testing.assert_array_equal(out_v, ref_v)
    if write_enable is not None:
        np.testing.assert_array_equal(out_k[1], arrays["kc"][1])
        np.testing.assert_array_equal(out_v[1], arrays["vc"][1])
    np.testing.assert_array_equal(out_k[0, :, 17], arrays["k_new"][0, :, 0])


def test_folded_write_is_in_place():
    arrays = _inputs(6, 1, 1, fold=True)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    _, k_out, v_out = decode_attention(
        t["q"], t["kc"], t["vc"], 4, k_new=t["k_new"], v_new=t["v_new"]
    )
    assert k_out is t["kc"] and v_out is t["vc"]
    torch.testing.assert_close(t["kc"][:, :, 4], t["k_new"][:, :, 0], rtol=0, atol=0)


def test_validation_errors():
    t = {k: torch.from_numpy(v) for k, v in _inputs(0, 1, 1).items()}
    with pytest.raises(ValueError, match="not divisible"):
        decode_attention(t["q"], t["kc"], t["vc"], 0, block_k=48)
    q3 = torch.zeros(B, 1, 3, H)
    kc3 = torch.zeros(B, 2, L, H)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        decode_attention(q3, kc3, kc3, 0)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        decode_attention(t["q"], t["kc"], t["vc"], 0, k_scale=torch.ones(B, NKV, L))
    with pytest.raises(ValueError, match="write_enable"):
        decode_attention(t["q"], t["kc"], t["vc"], 0, write_enable=torch.ones(B))
    # int8 caches are ported: the folded write without the new scales is a
    # JAX ValueError. So is the paged table, with the JAX paged mode's errors:
    # a (B, L) cache read as a pool has L-slot pages, which block_k must equal.
    ones = torch.ones(B, NKV, L)
    kc8 = torch.zeros(B, NKV, L, H, dtype=torch.int8)
    new8 = torch.zeros(B, NKV, 1, H, dtype=torch.int8)
    with pytest.raises(ValueError, match="ks_new and vs_new"):
        decode_attention(t["q"], kc8, kc8, 0, k_scale=ones, v_scale=ones, k_new=new8,
                         v_new=new8)
    table = torch.zeros(B, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="must equal the page size"):
        decode_attention(t["q"], t["kc"], t["vc"], 0, block_table=table, block_k=16)
    with pytest.raises(ValueError, match=r"must be \(B, T\)"):
        decode_attention(t["q"], t["kc"], t["vc"], 0, block_table=table[:1])


def test_auto_block_k_matches_jax():
    for length in (1024, 64, 96, 100, 8, 24):
        assert auto_block_k(length) == jax_auto_block_k(length)


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel or raises; it never runs the
    plain version (a meta tensor stands in for a device tensor here)."""
    q = torch.empty(B, 1, NKV, H, device="meta")
    kc = torch.empty(B, NKV, L, H, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        decode_attention(q, kc, kc, 0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("decode_attention")
