"""The port's flash attention (plain versions) against the JAX kernels.

The JAX kernels run in Pallas interpret mode under float32 matmul
precision, as the JAX package's own tests run them on the CPU; the port's
wrappers take their plain PyTorch versions for CPU tensors. The same
numpy-seeded inputs go to both; forward ``out`` and ``lse`` and the
gradients ``dq``/``dk``/``dv`` (torch autograd against ``jax.grad``, with a
fixed random cotangent) agree within atol 1e-5 in fp32, and in bf16 within
1e-2 of the largest reference magnitude. The CUDA kernels (in bf16 the
tensor-core design of each, and the CUDA-core one) are held against the
plain versions on the card by ``chip_smoke.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.ops import flash_attention as jax_flash
from learning_jax_sharding_tpu_torch.ops import _build
from learning_jax_sharding_tpu_torch.parallel import compiled_hlo, single_device_mesh
from learning_jax_sharding_tpu_torch.parallel import logical as port_logical
from learning_jax_sharding_tpu_torch.ops.attention import (
    causal_mask,
    dot_product_attention,
    sliding_window_mask,
)
from learning_jax_sharding_tpu_torch.ops.flash_attention import (
    _auto_block,
    _bwd_design,
    _fwd,
    _fwd_design,
    flash_attention,
    flash_attention_fwd_reference,
    make_flash_attn_fn,
)
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
# bf16: both sides round out, p, ds and the grads to bf16 (2^-8 relative),
# at other points of the sum (the JAX kernels tile by tile, the plain
# version over the dense score matrix), so an element can differ by a few
# bf16 steps of the largest magnitude. Relative to the largest |ref|.
BF16_RTOL = 1e-2

# (n_kv, group, causal, window, S, blocks): blocks are (block_q, block_k,
# bwd_block_q, bwd_block_k), None for auto / inherited.
CASES = {
    "mha_causal": (4, 1, True, None, 64, (16, 16, None, None)),
    "mha_bidirectional": (4, 1, False, None, 64, (16, 16, None, None)),
    "gqa_causal": (2, 3, True, None, 64, (16, 16, None, None)),
    "gqa_bidirectional": (4, 2, False, None, 64, (16, 16, None, None)),
    "gqa_window": (2, 2, True, 16, 64, (16, 16, None, None)),
    "mqa_causal": (1, 4, True, None, 64, (16, 16, None, None)),
    "auto_blocks": (2, 2, True, None, 64, (None, None, None, None)),
    "bwd_blocks": (4, 1, True, None, 64, (16, 16, 32, 8)),
    # window 5 < block: rows at a tile's edge see no key of some k tiles.
    "window_tile_edges": (2, 2, True, 5, 48, (16, 16, None, None)),
    # S_q != S_kv (no GQA): rows compare with key indices from 0.
    "unequal_lengths": (4, 1, True, None, (32, 48), (16, 16, None, None)),
}


def _inputs(seed, b, s, n_kv, group, h=16, dtype=np.float32):
    """q, k, v and a cotangent; ``s`` is S or ``(S_q, S_kv)``. ``dtype``
    ``"bfloat16"``: the fp32 draws rounded to bf16 (as ml_dtypes arrays)."""
    s_q, s_kv = (s, s) if isinstance(s, int) else s
    rng = np.random.default_rng(seed)
    n = n_kv * group
    return [
        rng.normal(size=shape).astype(np.float32).astype(jnp.dtype(dtype))
        for shape in ((b, s_q, n, h), (b, s_kv, n_kv, h), (b, s_kv, n_kv, h), (b, s_q, n, h))
    ]


def _to_torch(x):
    """A numpy array (fp32, or bf16 from ml_dtypes) as a torch tensor."""
    if x.dtype == np.float32:
        return torch.from_numpy(x)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _assert_close(got, ref, dtype, name):
    """fp32: within ATOL; bf16: within BF16_RTOL of the largest |ref|."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=name)
    else:
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= BF16_RTOL, f"{name}: {err:.3e} of the largest |ref| > {BF16_RTOL}"


def _jax_side(q, k, v, cot, *, causal, window, blocks):
    """JAX interpret-mode out, lse (on the folded rows) and grads."""
    bq, bk, bbq, bbk = blocks
    kw = dict(causal=causal, window=window, block_q=bq, block_k=bk,
              bwd_block_q=bbq, bwd_block_k=bbk, interpret=True)
    b, s, n, h = q.shape
    s_kv, n_kv = k.shape[1], k.shape[2]
    group = n // n_kv
    with jax.default_matmul_precision("float32"):
        jq, jk, jv, jc = map(jnp.asarray, (q, k, v, cot))
        out = jax_flash.flash_attention(jq, jk, jv, **kw)
        grads = jax.grad(
            lambda a, b_, c: jnp.sum(jax_flash.flash_attention(a, b_, c, **kw) * jc),
            argnums=(0, 1, 2),
        )(jq, jk, jv)
        rows = s * group
        q_rows = jq.reshape(b, s, n_kv, group, h).transpose(0, 2, 1, 3, 4)
        kv = lambda x: x.transpose(0, 2, 1, 3).reshape(b * n_kv, s_kv, h)
        _, lse = jax_flash._fwd(
            q_rows.reshape(b * n_kv, rows, h), kv(jk), kv(jv), scale=h**-0.5,
            causal=causal, window=window,
            block_q=bq or jax_flash._auto_block(rows),
            block_k=bk or jax_flash._auto_block(s_kv), interpret=True, group=group,
        )
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


# Every case in fp32 (ids as the case names) and in bf16 (``<case>-bf16``).
DTYPE_CASES = [pytest.param(c, "float32", id=c) for c in CASES] + [
    pytest.param(c, "bfloat16", id=f"{c}-bf16") for c in CASES
]


@pytest.mark.parametrize("case,dtype", DTYPE_CASES)
def test_plain_matches_jax_kernels(case, dtype):
    n_kv, group, causal, window, s, blocks = CASES[case]
    q, k, v, cot = _inputs(len(case), 2, s, n_kv, group, dtype=dtype)
    ref_out, ref_lse, ref_grads = _jax_side(q, k, v, cot, causal=causal,
                                            window=window, blocks=blocks)

    tq, tk, tv = (_to_torch(x).requires_grad_() for x in (q, k, v))
    bq, bk, bbq, bbk = blocks
    out = flash_attention(tq, tk, tv, causal=causal, window=window, block_q=bq,
                          block_k=bk, bwd_block_q=bbq, bwd_block_k=bbk)
    assert out.dtype == tq.dtype
    (out * _to_torch(cot)).sum().backward()
    _assert_close(out.detach().float(), ref_out, dtype, "out")
    for name, t, ref in zip("qkv", (tq, tk, tv), ref_grads):
        assert t.grad.dtype == tq.dtype
        _assert_close(t.grad.float(), ref, dtype, f"d{name}")

    b, _, n, h = q.shape
    fold = lambda x, g: (_to_torch(x).reshape(b, x.shape[1], x.shape[2] // g, g, h)
                         .permute(0, 2, 1, 3, 4).reshape(-1, x.shape[1] * g, h))
    _, lse = flash_attention_fwd_reference(
        fold(q, group), fold(k, 1), fold(v, 1), scale=h**-0.5, causal=causal,
        window=window, group=group,
    )
    _assert_close(lse, ref_lse, dtype, "lse")


@pytest.mark.parametrize("h", [64, 128])
def test_bwd_design_by_dtype(h):
    """bf16 takes the backward's tensor-core design, fp32 the CUDA-core one
    (tensor cores take fp32 only as TF32), at both head dims."""
    assert _bwd_design(torch.bfloat16, h) == "tensor_core"
    assert _bwd_design(torch.float32, h) == "cuda_core"


@pytest.mark.parametrize("h", [64, 128])
def test_fwd_design_by_dtype(h):
    """The forward takes the same rule: bf16 the tensor-core design, fp32
    the CUDA-core one, at both head dims."""
    assert _fwd_design(torch.bfloat16, h) == "tensor_core"
    assert _fwd_design(torch.float32, h) == "cuda_core"


def test_cpu_backward_moves_no_launch_counter():
    """The counters ``chip_smoke.py`` reads exist, the tensor-core ones
    beside the totals, and a CPU forward and backward (the plain versions)
    launch nothing, in either dtype; nor does a CPU forward asked for the
    tensor-core design, which takes the plain version too."""
    assert set(flash_attention.launches) == {
        "fwd", "bwd_dkv", "bwd_dq", "fwd_tensor_core", "bwd_dkv_tensor_core",
        "bwd_dq_tensor_core"}
    before = dict(flash_attention.launches)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, cot = (_to_torch(x).to(dtype).requires_grad_()
                        for x in _inputs(3, 1, 32, 2, 2, h=64))
        (flash_attention(q, k, v, causal=True) * cot).sum().backward()
        assert q.grad is not None and k.grad is not None and v.grad is not None
        # Shaped as the folded layout (rows of q = 2 x those of k); which row
        # is which does not matter here: both sides get the same tensors.
        folded = [x.detach().reshape(1, -1, 64) for x in (q, k, v)]
        out, lse = _fwd(*folded, 0.125, True, None, 2, design="tensor_core")
        want_out, want_lse = flash_attention_fwd_reference(*folded, scale=0.125, causal=True,
                                                           group=2)
        torch.testing.assert_close(out, want_out, atol=0, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    assert flash_attention.launches == before


BAD_CALLS = {
    "mask": (dict(mask=np.ones((64, 64), bool)), 64, 64, 4, 4),
    "window_without_causal": (dict(window=8), 64, 64, 4, 4),
    "window_below_one": (dict(causal=True, window=0), 64, 64, 4, 4),
    "heads_not_multiple": (dict(), 64, 64, 3, 2),
    "gqa_lengths": (dict(), 64, 32, 4, 2),
    "indivisible_blocks": (dict(block_q=48, block_k=48), 160, 160, 2, 2),
    "indivisible_bwd_block": (dict(bwd_block_q=24), 64, 64, 2, 2),
    "indivisible_bwd_block_k": (dict(bwd_block_k=24), 64, 64, 2, 2),
    "auto_block_no_factor": (dict(), 1030, 1030, 1, 1),
}


@pytest.mark.parametrize("case", list(BAD_CALLS))
def test_validation_errors_match_jax(case):
    kw, s_q, s_kv, n, n_kv = BAD_CALLS[case]
    shapes = ((1, s_q, n, 8), (1, s_kv, n_kv, 8), (1, s_kv, n_kv, 8))
    jax_kw = {k: (jnp.asarray(v) if k == "mask" else v) for k, v in kw.items()}
    with pytest.raises((ValueError, NotImplementedError)) as jax_err:
        jax_flash.flash_attention(*(jnp.zeros(s) for s in shapes), interpret=True, **jax_kw)
    torch_kw = {k: (torch.from_numpy(v) if k == "mask" else v) for k, v in kw.items()}
    with pytest.raises(jax_err.type) as port_err:
        flash_attention(*(torch.zeros(s) for s in shapes), **torch_kw)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("s", [8, 64, 96, 200, 1024, 1000, 7, 999])
def test_auto_block_matches_jax(s):
    assert _auto_block(s) == jax_flash._auto_block(s)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_equal_the_dense_op(causal):
    """The plain flash path and the dense ``dot_product_attention`` give the
    same outputs and gradients (GQA via ``repeat_kv`` on the dense side)."""
    q, k, v, cot = _inputs(9, 2, 32, 2, 2)
    grads = {}
    for path in ("flash", "dense"):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        if path == "flash":
            out = flash_attention(tq, tk, tv, causal=causal)
        else:
            mask = causal_mask(32) if causal else None
            out = dot_product_attention(tq, tk.repeat_interleave(2, 2),
                                        tv.repeat_interleave(2, 2), mask=mask)
        (out * torch.from_numpy(cot)).sum().backward()
        grads[path] = [out.detach()] + [t.grad for t in (tq, tk, tv)]
    for got, want in zip(grads["flash"], grads["dense"]):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-5)


def test_window_matches_the_dense_window_mask():
    q, k, v, _ = _inputs(10, 1, 32, 4, 1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True, window=5)
    want = dot_product_attention(tq, tk, tv, mask=sliding_window_mask(32, 5))
    torch.testing.assert_close(out, want, atol=ATOL, rtol=1e-5)


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernels or raises; it never runs the
    plain version (a meta tensor stands in for a device tensor here)."""
    q = torch.empty(1, 64, 2, 64, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        flash_attention(q, q, q, causal=True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("flash_attention")


def test_import_builds_nothing():
    code = (
        "import sys\n"
        "import learning_jax_sharding_tpu_torch.ops.flash_attention\n"
        "import learning_jax_sharding_tpu_torch.training.pipeline\n"
        "import learning_jax_sharding_tpu_torch.training.loop\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "from learning_jax_sharding_tpu_torch.ops import _build\n"
        "assert not _build._loaded, 'a kernel was built at import'\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )


def test_attn_fn_over_a_mesh_is_not_ported():
    """Ported since (slice A; the name is kept): over a one-rank CPU mesh
    the attn_fn runs the kernel's plain version on the shard (the whole),
    output and gradients equal to the unsharded call's; a mesh wants rules;
    the HLO analysis names slice G."""
    fn = make_flash_attn_fn(block_q=16)
    assert fn.supports_gqa
    mesh = single_device_mesh(device_type="cpu")
    sharded = make_flash_attn_fn(mesh, port_logical.RULES_DP_TP, block_q=16)
    assert sharded.supports_gqa
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 4, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    with port_logical.activate(mesh, port_logical.RULES_DP_TP):
        out = sharded(q, k, v, causal=True).full_tensor()
    out.square().sum().backward()
    got = [out.detach()] + [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    want = fn(q, k, v, causal=True)
    want.square().sum().backward()
    for a, b in zip(got, [want.detach()] + [t.grad for t in (q, k, v)]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="rules are required"):
        make_flash_attn_fn(mesh=mesh)
    with pytest.raises(NotImplementedError, match="slice G"):
        compiled_hlo(lambda: None)
