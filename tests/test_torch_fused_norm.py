"""The port's fused residual+norm against the JAX one.

Kernel level: the plain versions (what the port's wrapper runs for CPU
tensors) against the Pallas kernels in interpret mode, forward and the
custom-VJP backward on the same numpy-seeded inputs and cotangents, for
LayerNorm with and without beta, RMSNorm, with and without a residual: fp32
within rtol 1e-5 (gradients 3e-4, as the JAX package's own fused-norm test)
and bf16 within one bf16 ulp per element, the new residual bit-equal. A
plain version that normalises the ROUNDED residual fails the bf16 check.
Also the validation errors, the inference path that writes no statistics,
and the backward that adds nothing for an unused residual output.

Model level: ``CONFIG_TINY`` with ``fused_norm=True`` keeps the state-dict
names of the plain model, and its loss and every gradient agree with the
JAX fused model's (fp32). The CUDA kernels are held against the plain
versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
    next_token_loss as jax_next_token_loss,
)
from learning_jax_sharding_tpu.ops.fused_norm import fused_residual_norm as jax_fused
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops import fused_norm as fn

torch.set_num_threads(1)

SHAPE = (2, 24, 128)
CASES = [  # kind, residual, beta
    ("layernorm", True, True),
    ("layernorm", False, True),
    ("layernorm", True, False),
    ("rmsnorm", True, False),
    ("rmsnorm", False, False),
]
CASE_IDS = [f"{k}-{'resid' if r else 'plain'}-{'beta' if b else 'nobeta'}" for k, r, b in CASES]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, dtype, resid, beta):
    """numpy inputs and cotangents; row tensors exactly representable in
    ``dtype`` (rounded once, by torch), gamma/beta fp32 as model params."""
    rng = np.random.default_rng(seed)
    rows = {"x": None, "dy": None, "dr": None}
    if resid:
        rows["res"] = None
    out = {}
    for name in rows:
        a = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32))
        out[name] = a.to(TORCH_DTYPES[dtype]).float().numpy()
    out["g"] = rng.normal(size=SHAPE[-1]).astype(np.float32)
    if beta:
        out["b"] = rng.normal(size=SHAPE[-1]).astype(np.float32)
    return out


def _jax_side(a, dtype, kind):
    """Pallas kernels in interpret mode: forward and VJP → numpy."""
    jd = jnp.dtype(dtype)
    x = jnp.asarray(a["x"], jd)
    res = jnp.asarray(a["res"], jd) if "res" in a else None
    g = jnp.asarray(a["g"])
    b = jnp.asarray(a["b"]) if "b" in a else None
    (y, r), vjp = jax.vjp(
        lambda x, res, g, b: jax_fused(x, res, g, b, kind=kind, interpret=True), x, res, g, b
    )
    grads = vjp((jnp.asarray(a["dy"], jd), jnp.asarray(a["dr"], jd)))
    out = {"y": y, "r": r, "dx": grads[0], "dres": grads[1], "dg": grads[2], "db": grads[3]}
    return {k: None if v is None else np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _port_side(a, dtype, kind):
    """The port's wrapper on CPU tensors (the plain versions) → numpy."""
    td = TORCH_DTYPES[dtype]
    x = torch.tensor(a["x"], dtype=td, requires_grad=True)
    res = torch.tensor(a["res"], dtype=td, requires_grad=True) if "res" in a else None
    g = torch.tensor(a["g"], requires_grad=True)
    b = torch.tensor(a["b"], requires_grad=True) if "b" in a else None
    y, r = fn.fused_residual_norm(x, res, g, b, kind=kind)
    inputs = [t for t in (x, res, g, b) if t is not None]
    grads = iter(torch.autograd.grad(
        (y, r), inputs, (torch.tensor(a["dy"], dtype=td), torch.tensor(a["dr"], dtype=td))
    ))
    out = {"y": y, "r": r, "dx": next(grads), "dres": next(grads) if res is not None else None,
           "dg": next(grads), "db": next(grads) if b is not None else None}
    return {k: None if v is None else v.detach().float().numpy() for k, v in out.items()}


def _within_one_bf16_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    """Every element within one bf16 ulp of the JAX one: the fp32 sums may
    differ in order and round the other way, nothing more."""
    ulp = np.spacing(np.abs(want)) * 2.0**16     # fp32 spacing → bf16's
    return bool(np.all(np.abs(got - want) <= ulp))


@pytest.mark.parametrize("kind,resid,beta", CASES, ids=CASE_IDS)
def test_fp32_plain_matches_pallas(kind, resid, beta):
    a = _arrays(0, "float32", resid, beta)
    want, got = _jax_side(a, "float32", kind), _port_side(a, "float32", kind)
    for name in ("y", "r"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("dx", "dres", "dg", "db"):
        assert (got[name] is None) == (want[name] is None), name
        if want[name] is not None:
            np.testing.assert_allclose(got[name], want[name], rtol=3e-4, atol=3e-4,
                                       err_msg=name)


@pytest.mark.parametrize("kind,resid,beta", CASES, ids=CASE_IDS)
def test_bf16_plain_matches_pallas(kind, resid, beta):
    """bf16 rows, fp32 params: the normed output and dx within one bf16 ulp
    (fp32 sums in another order), the new residual bit-equal (one rounding
    of the same fp32 sum), dgamma/dbeta (fp32 sums) within rtol 1e-5."""
    a = _arrays(1, "bfloat16", resid, beta)
    want, got = _jax_side(a, "bfloat16", kind), _port_side(a, "bfloat16", kind)
    np.testing.assert_array_equal(got["r"], want["r"])
    for name in ("y", "dx", "dres"):
        if want[name] is not None:
            assert _within_one_bf16_ulp(got[name], want[name]), name
    for name in ("dg", "db"):
        if want[name] is not None:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-5 * np.abs(want[name]).max(), err_msg=name)


def _normalises_rounded_sum(x2, r2, gamma, beta, **kw):
    """Forward mutant: the norm of the residual ROUNDED to x's dtype."""
    rounded = (x2.float() + r2.float()).to(x2.dtype)
    y, _, mean, rstd = _REAL_FWD(rounded, None, gamma, beta, **kw)
    return y, rounded, mean, rstd


def _rounds_dx_once(dy, r, gamma, mean, rstd, dr, **kw):
    """Backward mutant: dx + dr from the unrounded fp32 dx, one rounding."""
    dx32, dgamma, dbeta = _REAL_BWD(dy.float(), r, gamma, mean, rstd, None, **kw)
    return (dx32 + dr.float()).to(dy.dtype), dgamma, dbeta


_REAL_FWD = fn.fused_residual_norm_reference
_REAL_BWD = fn.fused_residual_norm_bwd_reference


@pytest.mark.parametrize("name,mutant,output", [
    ("fused_residual_norm_reference", _normalises_rounded_sum, "y"),
    ("fused_residual_norm_bwd_reference", _rounds_dx_once, "dx"),
])
def test_bf16_check_catches_misrounding(monkeypatch, name, mutant, output):
    """The one-ulp check is sharp enough: a forward that normalises the
    residual rounded to bf16 (not the fp32 sum), or a backward that adds dr
    to the unrounded dx (JAX rounds dx to bf16 first), fails it."""
    a = _arrays(1, "bfloat16", True, True)
    want = _jax_side(a, "bfloat16", "layernorm")
    monkeypatch.setattr(fn, name, mutant)
    got = _port_side(a, "bfloat16", "layernorm")
    np.testing.assert_array_equal(got["r"], want["r"])
    assert not _within_one_bf16_ulp(got[output], want[output])


def test_validation_errors_match_jax():
    x, g = torch.zeros(2, 8, 16), torch.ones(16)
    with pytest.raises(ValueError, match="rmsnorm has no beta"):
        fn.fused_residual_norm(x, None, g, torch.zeros(16), kind="rmsnorm")
    with pytest.raises(ValueError, match="unknown kind 'batchnorm'"):
        fn.fused_residual_norm(x, None, g, kind="batchnorm")
    with pytest.raises(ValueError, match="divisible"):
        fn.fused_residual_norm(torch.zeros(2, 10, 16), None, g, kind="rmsnorm", block_r=8)
    with pytest.raises(ValueError, match="divisible"):
        jax_fused(jnp.zeros((2, 10, 16)), None, jnp.ones(16), kind="rmsnorm", block_r=8,
                  interpret=True)


def test_odd_rows_match_pallas():
    """18 rows (no power-of-two factor ≥ 8): one whole tile in JAX."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 128)).astype(np.float32)
    g = rng.normal(size=128).astype(np.float32)
    want, _ = jax_fused(jnp.asarray(x), None, jnp.asarray(g), kind="rmsnorm", interpret=True)
    got, _ = fn.fused_residual_norm(torch.from_numpy(x), None, torch.from_numpy(g),
                                    kind="rmsnorm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _record(monkeypatch, name, pick):
    """Wrap the plain version ``fn.<name>`` to record ``pick(args, kw)`` of
    each call."""
    real, seen = getattr(fn, name), []

    def wrapped(*args, **kw):
        seen.append(pick(args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(fn, name, wrapped)
    return seen


def test_inference_writes_no_statistics(monkeypatch):
    """The JAX primal path: with no gradient to take (grad mode off, or no
    input that needs one) the forward computes no mean/rstd."""
    seen = _record(monkeypatch, "fused_residual_norm_reference",
                   lambda args, kw: kw["needs_stats"])
    x, res, g = torch.randn(4, 16), torch.randn(4, 16), torch.ones(16)
    fn.fused_residual_norm(x, res, g)
    with torch.no_grad():
        fn.fused_residual_norm(x, res, g.requires_grad_())
    fn.fused_residual_norm(x, res, g)
    assert seen == [False, False, True]


@pytest.mark.parametrize("use_resid_output", [False, True])
def test_unused_residual_output_adds_nothing(monkeypatch, use_resid_output):
    """``ln_attn``/``ln_out`` drop the second output: the backward then gets
    no tensor of zeros to add (``set_materialize_grads(False)``); both
    inputs of the add get the same gradient."""
    seen = _record(monkeypatch, "fused_residual_norm_bwd_reference",
                   lambda args, kw: args[5] is not None)
    x = torch.randn(4, 16, requires_grad=True)
    res = torch.randn(4, 16, requires_grad=True)
    y, r = fn.fused_residual_norm(x, res, torch.ones(16), torch.zeros(16))
    (y.sin().sum() + (r.sum() if use_resid_output else 0)).backward()
    assert seen == [use_resid_output]
    torch.testing.assert_close(x.grad, res.grad, rtol=0, atol=0)


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernels or raises; it never runs the
    plain version (a meta tensor stands in for a device tensor here)."""
    x = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        fn.fused_residual_norm(x, None, torch.empty(16, device="meta"))


def test_kernel_checks_refuse_what_it_cannot_take():
    """The wrapper's checks before a launch (they run on any device)."""
    g = torch.ones(12)
    with pytest.raises(ValueError, match="multiple of 8"):
        fn._check_cuda(torch.zeros(4, 12), g)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fn._check_cuda(torch.zeros(4, 16, dtype=torch.float16), torch.ones(16))
    with pytest.raises(ValueError, match="resid must be"):
        fn._check_cuda(torch.zeros(4, 16), torch.ones(16),
                       resid=torch.zeros(4, 16, dtype=torch.bfloat16))


def _tokens(seed, b=2, s=17):
    return np.random.default_rng(seed).integers(0, CONFIG_TINY.vocab_size, (b, s)).astype(
        np.int32)


def test_state_dict_identical_across_the_flag():
    plain = Transformer(CONFIG_TINY, device="cpu", seed=0).state_dict()
    fused = Transformer(dataclasses.replace(CONFIG_TINY, fused_norm=True), device="cpu",
                        seed=0).state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in plain.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in fused.items()
    }
    for name in plain:
        torch.testing.assert_close(fused[name], plain[name], rtol=0, atol=0)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_fused_model_loss_and_grads_match_jax(norm):
    """fp32 ``CONFIG_TINY`` with ``fused_norm=True``: the loss within rtol
    1e-5 and every gradient (mapped with ``from_flax_params``) within
    atol 1e-5 / rtol 1e-4 of the JAX fused model (Pallas in interpret
    mode)."""
    jcfg = dataclasses.replace(JAX_TINY, norm=norm, fused_norm=True, dtype=jnp.float32)
    cfg = dataclasses.replace(CONFIG_TINY, norm=norm, fused_norm=True)
    tokens = _tokens(3)
    np_batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    jmodel = JaxTransformer(jcfg)
    params = jax.tree.map(np.asarray, nn.meta.unbox(
        jmodel.init(jax.random.key(0), jnp.asarray(np_batch["inputs"]))["params"]))

    def jax_loss(p):
        return jax_next_token_loss(jmodel.apply({"params": p}, np_batch["inputs"]), np_batch)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(from_flax_params(params, cfg))
    batch = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}
    loss = next_token_loss(model(batch["inputs"]), batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = from_flax_params(jax.tree.map(np.asarray, want_grads), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
