"""The probe kernels (``csrc/probes.cu``) and the port's probe scripts on the
CPU: the kernels' plain versions against the JAX scripts' Pallas kernels,
the ablation's kernel order against the plain version, and the launch
audit's 1.4B configuration and variants against the JAX package's.

The JAX probe scripts run their whole probe (the 1.4B model included) when
imported, so their kernel bodies (``copy_kernel``, ``mm_kernel``,
``_ablate_kernel``) are taken from the source with ``ast``, only their
function definitions, and run through ``pl.pallas_call(..., interpret=True)``
with the scripts' BlockSpecs at reduced sizes: the copy at (8, 128); the
matmul at K=256 in 512-column blocks, one call over N=1024 and four calls
of 512 columns; the ablation at blocks of 128 rows (h 64 and 128, two
blocks) and one block of 1024 at h=64. Tolerances: the copy bit-equal; the
plain matmul and ablation within 2⁻⁸ of the largest |ref| with at most
0.3% of their bf16 outputs differing (both sum in fp32 and round the same
values; only the order of the fp32 sums and an ulp of an exp differ); the
ablation in its kernel's order (``ablate_probe_online_reference``: p
rounded to bf16 before the division) within 2⁻⁷ of the plain version, its
differing share unbounded (it rounds other values by design). The kernels
themselves run only on the card: ``chip_smoke.py`` holds them to these
plain versions there.
"""

import ast
import dataclasses
import functools
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from learning_jax_sharding_tpu.models import generate as jax_generate
from learning_jax_sharding_tpu.models import quantize as jq
from learning_jax_sharding_tpu.models import transformer as jax_transformer
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.quantize import map_unquantized, quantized_bytes
from learning_jax_sharding_tpu_torch.models.transformer import TransformerConfig
from learning_jax_sharding_tpu_torch.ops import probes
from learning_jax_sharding_tpu_torch.scripts import perf_call_floor, perf_launch_audit
from learning_jax_sharding_tpu_torch.utils import bench
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
TIGHT, LOOSE, FLIPS = 2.0**-8, 2.0**-7, 0.003


def _kernel_source(script: str, name: str) -> ast.FunctionDef:
    tree = ast.parse((SCRIPTS / script).read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _kernel(script: str, name: str):
    """The function ``name`` of ``scripts/{script}``, defined alone."""
    module = ast.Module(body=[_kernel_source(script, name)], type_ignores=[])
    namespace = {"jax": jax, "jnp": jnp}
    exec(compile(module, f"scripts/{script}", "exec"), namespace)
    return namespace[name]


def _bf16(rng, *shape, scale=1.0):
    """numpy-seeded normals rounded to bf16: (jax array, torch tensor)."""
    a = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def _close(got: torch.Tensor, want, tol: float, flips: float | None):
    want = torch.from_numpy(np.array(jnp.asarray(want).astype(jnp.float32)))
    got = got.float()
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= tol, f"max err {err:.3e} of max |ref| > {tol:.3e}"
    if flips is not None:
        share = (got != want).float().mean().item()
        assert share <= flips, f"{share:.4%} of outputs differ (limit {flips:.1%})"
    return err


@pytest.fixture(autouse=True)
def _no_launch_counted():
    """On CPU tensors the wrappers run their plain versions and count no
    launch."""
    probes.reset_launches()
    yield
    assert (probes.copy_probe.launches, probes.matmul_probe.launches,
            probes.ablate_probe.launches) == (0, 0, 0)


@pytest.mark.parametrize("script", ["perf_call_floor.py", "perf_launch_audit.py"])
def test_copy_probe_is_the_pallas_copy(script):
    x, xt = _bf16(np.random.default_rng(0), 8, 128)
    noop = pl.pallas_call(_kernel(script, "copy_kernel"),
                          out_shape=jax.ShapeDtypeStruct((8, 128), jnp.bfloat16), interpret=True)
    want = torch.from_numpy(np.array(noop(x).astype(jnp.float32))).to(torch.bfloat16)
    got = probes.copy_probe(xt)
    assert torch.equal(got, want) and torch.equal(got, xt)
    out = torch.empty_like(xt)
    assert probes.copy_probe(xt, out) is out and torch.equal(out, want)


def _pmm(n: int, k: int):
    """The script's ``pmm``: 512-column blocks of ``(8, k) x (k, n)``."""
    return pl.pallas_call(
        _kernel("perf_call_floor.py", "mm_kernel"), grid=(n // 512,),
        in_specs=[pl.BlockSpec((8, k), lambda j: (0, 0)),
                  pl.BlockSpec((k, 512), lambda j: (0, j))],
        out_specs=pl.BlockSpec((8, 512), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((8, n), jnp.bfloat16), interpret=True)


@pytest.mark.parametrize("calls", [1, 4])
def test_matmul_probe_matches_pallas(calls):
    """One call over N=1024, or the four-call form over N=2048 (each call a
    512-column slice of one w into a slice of one output, as the script's
    ``four_calls`` and the port's ``perf_call_floor.four_calls``)."""
    k, n = 256, 1024 if calls == 1 else 2048
    rng = np.random.default_rng(calls)
    w, wt = _bf16(rng, k, n, scale=0.02)
    x, xt = _bf16(rng, 8, k)
    step = n // calls
    want = jnp.concatenate([_pmm(step, k)(x, w[:, j * step:(j + 1) * step])
                            for j in range(calls)], axis=1)
    if calls == 1:
        got = probes.matmul_probe(xt, wt)
    else:
        got = perf_call_floor.four_calls(xt, wt, torch.empty(8, n, dtype=torch.bfloat16))
    assert got.shape == (8, n) and got.dtype == torch.bfloat16
    _close(got, want, TIGHT, FLIPS)


def _pallas_ablate(script, mode, block, blocks, h):
    kernel = functools.partial(_kernel(script, "_ablate_kernel"), mode=mode)
    spec = pl.BlockSpec((block, h), lambda i: (i, 0))
    return pl.pallas_call(kernel, grid=(blocks,), in_specs=[spec] * 3, out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct((blocks * block, h), jnp.bfloat16),
                          interpret=True)


ABLATE_CASES = [(64, 128, 2), (128, 128, 2), (64, 1024, 1)]


@pytest.mark.parametrize("mode", list(probes.ABLATE_MODES))
@pytest.mark.parametrize("h,block,blocks", ABLATE_CASES)
def test_ablate_probe_matches_pallas(h, block, blocks, mode):
    rng = np.random.default_rng(h + block + blocks)
    (q, qt), (k, kt), (v, vt) = (_bf16(rng, blocks * block, h) for _ in range(3))
    want = _pallas_ablate("perf_flash_ceiling.py", mode, block, blocks, h)(q, k, v)
    got = probes.ablate_probe(qt, kt, vt, block=block, mode=mode)
    _close(got, want, TIGHT, FLIPS)
    _close(probes.ablate_probe_reference(qt, kt, vt, block=block, mode=mode), want, TIGHT, FLIPS)


@pytest.mark.parametrize("mode", list(probes.ABLATE_MODES))
@pytest.mark.parametrize("h,block,blocks", ABLATE_CASES + [(128, 1024, 2)])
def test_ablate_kernel_order_within_bound(h, block, blocks, mode):
    """The kernel's order (online softmax over the flash forward's key
    tiles, p rounded before the division; noexp's additive correction of the
    moving max) against the TPU kernel's order."""
    rng = np.random.default_rng(2 * h + block)
    _, qt = _bf16(rng, blocks * block, h)
    _, kt = _bf16(rng, blocks * block, h)
    _, vt = _bf16(rng, blocks * block, h)
    want = probes.ablate_probe_reference(qt, kt, vt, block=block, mode=mode)
    got = probes.ablate_probe_online_reference(qt, kt, vt, block=block, mode=mode)
    err = _close(got, want.float().numpy(), LOOSE, None)
    if mode == "dots":
        assert err == 0.0


def test_the_two_ceiling_scripts_share_the_ablation_kernel():
    bodies = [ast.dump(_kernel_source(s, "_ablate_kernel")) for s in
              ("perf_flash_ceiling.py", "perf_flash_ceiling2.py")]
    assert bodies[0] == bodies[1]


def test_ablate_probe_refuses_what_the_kernel_cannot_take():
    x = torch.zeros(256, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mode"):
        probes.ablate_probe(x, x, x, block=128, mode="exp")
    with pytest.raises(ValueError, match="whole blocks"):
        probes.ablate_probe(x, x, x, block=96 * 2 + 1, mode="full")


def test_matmul_columns_cover_the_card():
    """N=8192 (one call) takes 32-column blocks, 256 of them; N=2048 (each
    of four calls) 16-column blocks, 128: at least one block an SM of a
    132-SM H100 either way."""
    assert probes.matmul_columns(8192, 132) == 32
    assert probes.matmul_columns(2048, 132) == 16
    assert 8192 // 32 >= 132 and 2048 // 16 < 132 < 2048 // 8


def test_device_timers_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for timer in (bench.eager_time, bench.graph_time):
        with pytest.raises(RuntimeError, match="CUDA"):
            timer(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.queued_time(lambda: None)


def test_raw_events_pin_the_profiler_api():
    """``device_profile`` counts kernels from the profiler's raw events, no
    public API: on the CPU the same reader finds the ops a run made, with
    their durations, and nothing on the CUDA device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    events = bench.raw_events(prof, DeviceType.CPU)
    assert "aten::mm" in [name for name, _ in events]
    assert all(isinstance(ns, int) and ns >= 0 for _, ns in events)
    assert bench.raw_events(prof, DeviceType.CUDA) == []


def test_raw_events_refuse_a_profiler_without_them():
    class Bare:
        profiler = object()

    with pytest.raises(RuntimeError, match="kineto_results"):
        bench.raw_events(Bare(), None)


def test_bound_takes_the_larger_time():
    ms, by = bench.bound(2 * (8 * 2048 + 2048 * 8192 + 8 * 8192), 2 * 8 * 2048 * 8192,
                         peak=989e12)
    assert by == "bytes" and abs(ms - 33.7e6 / 3.35e12 * 1e3) < 1e-4
    ms, by = bench.bound(4 * 16 * 1024 * 128 * 2, probes.ablate_flops(16, 1024, 128),
                         peak=989e12)
    assert by == "operations" and abs(ms / 16 - 0.543e-3) < 1e-5


# ---------------------------------------------------------------- the audit

JAX_1P4B = jax_transformer.TransformerConfig(
    num_layers=24, features=2048, num_heads=16, head_dim=128, hidden=8192, max_seq_len=256)


def test_1p4b_config_is_the_jax_scripts():
    cfg = perf_launch_audit.CONFIG_1P4B
    for field in ("num_layers", "features", "num_heads", "head_dim", "hidden", "max_seq_len",
                  "vocab_size", "num_kv_heads"):
        assert getattr(cfg, field) == getattr(JAX_1P4B, field), field
    assert cfg.param_count == JAX_1P4B.param_count
    assert 1.3e9 < cfg.param_count < 1.5e9


# The audit's shape at narrow width: head_dim 128 as at 1.4B.
NARROW = dict(num_layers=2, features=256, num_heads=2, head_dim=128, hidden=1024,
              vocab_size=512, max_seq_len=32)
B, PROMPT, NEW = 2, 16, 8


@pytest.fixture(scope="module")
def narrow():
    jcfg = jax_transformer.TransformerConfig(**NARROW)
    cfg = TransformerConfig(**NARROW)
    prompt = np.random.default_rng(3).integers(0, NARROW["vocab_size"], (B, PROMPT))
    prompt = prompt.astype(np.int32)
    params = nn.meta.unbox(jax.jit(jax_transformer.Transformer(jcfg).init)(
        jax.random.key(0), jnp.asarray(prompt))["params"])
    params = jax.tree.map(np.asarray, params)
    return jcfg, cfg, prompt, params, from_flax_params(params, cfg)


def _jax_variants(params):
    def to_bf16(x):
        return x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x

    tree = jax.tree.map(jnp.asarray, params)
    return {"bf16": (jax.tree.map(to_bf16, tree), False),
            "int8 dequant": (jq.quantize_tree(tree), True),
            "int4 fused": (jq.quantize_tree(tree, bits=4), "fused")}


def test_audit_variants_serve_the_jax_bytes(narrow):
    """The roofline's served bytes: the port's three variants against the
    JAX script's on the same (converted) weights."""
    _, _, _, params, state = narrow
    jax_trees = _jax_variants(params)
    for label, tree, deq in perf_launch_audit.variants(state):
        jtree, jdeq = jax_trees[label]
        assert deq == jdeq
        want = jq.quantized_bytes(jq.map_unquantized(
            lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            jtree))
        got = quantized_bytes(map_unquantized(perf_launch_audit.to_bf16, tree))
        assert got == want, label


@pytest.mark.parametrize("label", ["bf16", "int8 dequant", "int4 fused"])
def test_audit_variants_generate_the_jax_tokens(narrow, label):
    """Each variant's trees and ``dequantize`` mode, greedy (b=2, prompt
    16 + 8): the port's generate on the CPU (the kernels' plain versions)
    against the JAX ``make_generate_fn`` on a one-device mesh (Pallas in
    interpret mode). In fp32 compute, as the other token tests: at bf16
    compute the int4 variant's logits tie in their top two (both packages
    round them to bf16) and the two argmaxes may part on an ulp."""
    jcfg, cfg, prompt, params, state = narrow
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    jtree, deq = _jax_variants(params)[label]
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    with jax.default_matmul_precision("float32"):
        want = jax_generate.make_generate_fn(
            jcfg, mesh, RULES_DP_TP, max_new_tokens=NEW, dequantize=deq)(
                jtree, jnp.asarray(prompt))
    tree = dict((lbl, t) for lbl, t, _ in perf_launch_audit.variants(state))[label]
    got = make_generate_fn(cfg, max_new_tokens=NEW, dequantize=deq, device="cpu")(tree, prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_audit_token_step_is_the_generate_loop(narrow):
    """``token_step`` (the profiled step) advances as ``make_generate_fn``'s
    loop does: from the prompt's cache, its picks are the generate's new
    tokens, int4 fused as in bf16."""
    _, cfg, prompt, _, state = narrow
    for label, tree, deq in perf_launch_audit.variants(state)[::2]:
        full = make_generate_fn(cfg, max_new_tokens=4, inference_dtype=torch.bfloat16,
                                dequantize=deq, device="cpu")(tree, prompt)
        advance = perf_launch_audit.token_step(cfg, tree, deq, torch.from_numpy(prompt),
                                               device="cpu")
        picks = [advance.state["tok"].clone()]
        for _ in range(3):
            advance()
            picks.append(advance.state["tok"].clone())
        assert torch.equal(torch.stack(picks, 1), full[:, PROMPT:]), label


def test_cache_bytes_follow_the_jax_script():
    """bf16 K and V at the mean valid length, as the JAX audit counts them
    (``cache_bytes = layers · b · n_kv · (prompt + new/2) · head_dim · 4``)."""
    cfg = perf_launch_audit.CONFIG_1P4B
    want = cfg.num_layers * 8 * cfg.num_heads * (64 + 64 / 2) * cfg.head_dim * 4
    assert perf_launch_audit.cache_bytes(cfg, 8, 64, 64) == want


# The design rules at the audit's 1.4B sites on a 132-SM H100, against the
# designs chip_smoke.py's 1.4B sweep timed there (queued µs, bf16, group
# 128; PERF.md slice 12). Every pick is the fastest design, or within 7% of
# the fastest split of it where the sweep's own split-to-split noise is of
# that size (the q/k/v triple at M=8: 6 pieces 10.81 µs, 10 pieces 10.31,
# 8 pieces 10.36, 4 pieces 10.78; the lm_head at M=8: 1 piece 45.01, 4
# pieces 42.53, 3 pieces 45.31, 2 pieces 46.84; the FF's down launch at
# M=512: 2 pieces 357.95, 1 piece 348.36).
H100_SMS = 132
SITES_1P4B = {"qkv": (2048, 2048, 3), "out": (2048, 2048, 1), "lm_head": (2048, 50304, 1)}


@pytest.mark.parametrize("site", list(SITES_1P4B))
def test_int4_matmul_rules_at_1p4b(site):
    from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4

    k, n, nw = SITES_1P4B[site]
    ng, bf16 = k // 128, torch.bfloat16
    # M=8: small-M (qkv 10.81 µs against tensor-core 49.29 and CUDA-core
    # 43.63; out 7.01 / 46.87 / 39.07; lm_head 45.01 / 111.67 / 186.14).
    assert mm4._variant(8, k, n * nw, ng, 128, bf16, False, H100_SMS) == "small_m"
    assert mm4._splits(8, k, n, nw, ng, 128, H100_SMS) == {"qkv": 6, "out": 16, "lm_head": 1}[site]
    # M=512: tensor cores at the faster tile (qkv 128 rows 88.35 µs against
    # 117.96 at 96; out 96 rows 49.07 against 58.84; lm_head 128 rows 503.87
    # against 610.63; CUDA-core 1306.94 / 449.27 / 10765.02).
    assert mm4._variant(512, k, n * nw, ng, 128, bf16, False, H100_SMS) == "tensor_core"
    assert mm4._tile_rows(512, n, nw, H100_SMS) == {"qkv": 128, "out": 96, "lm_head": 128}[site]


def test_int4_ff_rules_at_1p4b():
    """The FF 2048 → 8192 → 2048: small-M at M=8 (45.50 µs against 88.79
    on the CUDA cores and 75.55 at the tensor-core design's best split),
    tensor cores at M=512 (357.95 against 2634.52), 128-row up tiles
    (377.84 at 96 rows), two down pieces, a cluster of 8."""
    from learning_jax_sharding_tpu_torch.ops import int4_ff as ff4
    from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4

    bf16 = torch.bfloat16
    assert ff4._design(8, 2048, 8192, 128, bf16, H100_SMS) == "small_m"
    assert ff4._cluster(2048, 8192) == 8
    assert ff4._design(512, 2048, 8192, 128, bf16, H100_SMS) == "tensor_core"
    assert mm4._tile_rows(512, 8192, 1, H100_SMS) == 128
    assert ff4._down_splits(512, 2048, 8192, 128, H100_SMS) == 2
