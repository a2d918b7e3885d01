"""The whole-FF int4 kernel's tensor-core designs (``csrc/int4_ff.cu``) on
the CPU: their arithmetic (plain versions), the rule that routes shapes to
them, and their counters.

Both tensor-core designs keep the down product exact in fp32: ``u`` is cut
into three bf16 parts that add up to it exactly (``split_parts``), the down
weights' integers ``q - 8`` are exact in bf16, each scale group's products
sum in fp32 apart and are scaled after the group ends, the low-nibble group
before the high one. ``int4_ff_split_reference`` computes exactly that. It is
held here to ``int4_ff_reference`` (fp32, within 1e-5 of the largest
|ref|) and to the JAX Pallas kernel in interpret mode, as the JAX package's
own tests run it on the CPU (bf16, one bf16 ulp), on numpy-seeded inputs at
K 128-256, H 256-512, groups 16, 64, 128 and whole-K/H, M = 1, 8, 16, 37,
64; a one-part split (u rounded to bf16) must fail that check. Then
``_design`` at the 125M model's sites on a 132-SM H100, and the counters
``chip_smoke.py`` reads. The kernels themselves run only on the card:
``chip_smoke.py`` holds every design to these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import quantize as jq
from learning_jax_sharding_tpu.ops import int4_ff as jff
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_125M
from learning_jax_sharding_tpu_torch.ops import int4_ff as ff4
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

H100_SMS = 132
D, HID = CONFIG_125M.features, CONFIG_125M.hidden
# (K, H, group): every group layout; the last two are whole-K and whole-H
# (one scale row for up, down or both).
SHAPES = [(128, 256, 16), (256, 512, 64), (256, 256, 128), (128, 512, 128), (256, 512, 4096)]
ROWS = (1, 8, 16, 37, 64)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(seed, k, hidden, group):
    """Both packed weights, quantized eagerly by the JAX package, as numpy:
    (q4_up, s_up, q4_dn, s_dn)."""
    up = jq.quantize_leaf_int4(jnp.asarray(_normal(seed, k, hidden)), group_size=group)
    dn = jq.quantize_leaf_int4(jnp.asarray(_normal(seed + 1, hidden, k)), group_size=group)
    return [np.asarray(node[key]) for node in (up, dn) for key in ("q4", "scale")]


def _within_one_bf16_ulp(got: torch.Tensor, want: np.ndarray) -> bool:
    """Every element within one bf16 ulp of the JAX one: the fp32 sums may
    differ in order and round the other way, nothing more."""
    assert got.dtype == torch.bfloat16
    ulp = np.spacing(np.abs(want)) * 2.0**16     # fp32 spacing → bf16's
    return bool(np.all(np.abs(got.float().numpy() - want) <= ulp))


def test_split_parts_rebuild_u_exactly():
    """Three bf16 parts carry fp32's 24 significant bits: their fp32 sum (in
    order) is u exactly, over magnitudes from 1e-30 to 1e30 and GELU's
    range; one or two parts do not."""
    rng = np.random.default_rng(7)
    u = torch.from_numpy(np.concatenate([
        rng.normal(size=4096), rng.normal(size=4096) * 1e-3,
        np.exp(rng.uniform(-69, 69, size=4096)) * rng.choice([-1, 1], size=4096),
        [0.0, -0.0, 1.0, -0.17],
    ]).astype(np.float32))
    parts = ff4.split_parts(u)
    assert parts.shape == (3, *u.shape) and parts.dtype == torch.bfloat16
    p = parts.float()
    assert torch.equal(p[0] + p[1] + p[2], u)
    assert torch.equal(p.double().sum(0), u.double())
    assert not torch.equal(p[0] + p[1], u)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,hidden,group", SHAPES)
def test_split_reference_matches_reference(m, k, hidden, group):
    """fp32: the same exact products as ``int4_ff_reference`` (its fp32 down
    weights times u, here u's parts times the integers, scaled after each
    group), summed in another order: within 1e-5 of the largest |ref|."""
    args = [_t(a) for a in _weights(10 + m, k, hidden, group)]
    x = torch.from_numpy(_normal(20 + m, m, k))
    want = ff4.int4_ff_reference(x, *args, group=group)
    got = ff4.int4_ff_split_reference(x, *args, group=group)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.fixture(scope="module")
def bf16_pallas():
    """bf16 x through the JAX Pallas kernel in interpret mode at M = 8 and
    37 for every shape: (x, weights, JAX output as fp32 numpy), computed
    once."""
    cases = {}
    for m in (8, 37):
        for k, hidden, group in SHAPES:
            weights = _weights(30 + m, k, hidden, group)
            x = _normal(40 + m, m, k)
            want = jff.int4_ff(jnp.asarray(x, jnp.bfloat16), *weights, group=group,
                               block_h=64, interpret=True)
            cases[m, k, hidden, group] = (torch.from_numpy(x).bfloat16(),
                                          [_t(a) for a in weights],
                                          np.asarray(want.astype(jnp.float32)))
    return cases


@pytest.mark.parametrize("m", (8, 37))
@pytest.mark.parametrize("k,hidden,group", SHAPES)
def test_split_reference_matches_pallas(bf16_pallas, m, k, hidden, group):
    """bf16: the up weights rounded to bf16, u and the down product exact in
    fp32 on both sides, one rounding to bf16 at the end: one bf16 ulp."""
    x, args, want = bf16_pallas[m, k, hidden, group]
    got = ff4.int4_ff_split_reference(x, *args, group=group)
    assert _within_one_bf16_ulp(got, want)


def test_one_part_split_fails_the_ulp_check(bf16_pallas, monkeypatch):
    """The check is sharp: u rounded to bf16 (its first part alone) moves
    the fp32 sums by ~2^-9 and lands outside one ulp, on the case where the
    JAX package's own misrounding test looks (M = 37, group 64)."""
    x, args, want = bf16_pallas[37, 256, 512, 64]
    real = ff4.split_parts
    monkeypatch.setattr(ff4, "split_parts", lambda u: real(u)[:1])
    assert not _within_one_bf16_ulp(ff4.int4_ff_split_reference(x, *args, group=64), want)


@pytest.mark.parametrize(
    "m,dtype,group,design",
    [(1, torch.bfloat16, 128, "small_m"), (8, torch.bfloat16, 128, "small_m"),
     (16, torch.bfloat16, 128, "small_m"), (17, torch.bfloat16, 128, "tensor_core"),
     (512, torch.bfloat16, 128, "tensor_core"), (1024, torch.bfloat16, 128, "tensor_core"),
     (8, torch.bfloat16, 64, "small_m"), (1024, torch.bfloat16, 64, "tensor_core"),
     (8, torch.bfloat16, 4096, "small_m"), (1024, torch.bfloat16, 4096, "tensor_core"),
     (8, torch.float32, 128, "cuda_core"), (1024, torch.float32, 128, "cuda_core"),
     (8, torch.bfloat16, 16, "cuda_core"), (1024, torch.bfloat16, 16, "cuda_core")],
)
def test_design_at_the_125m_sites(m, dtype, group, design):
    """The 125M FF (768 → 3072 → 768) on an H100: decode rows (generate's
    token steps, 8; the engine's decode calls) → small-M; the prefill (1024)
    and the engine's refill chunks (512) → tensor cores; fp32 x, and groups
    that are not whole 32-row chunks (16) → CUDA cores."""
    assert ff4._design(m, D, HID, group, dtype, H100_SMS) == design


def test_layouts_and_tiles():
    """What each design's layout takes, the small-M cluster and workspace,
    and the down launch's split at the 125M shapes."""
    assert ff4._small_m_layout(D, HID, 128) and ff4._tensor_core_layout(D, HID, 128)
    assert not ff4._small_m_layout(D, HID, 16) and not ff4._tensor_core_layout(D, HID, 16)
    assert ff4._small_m_layout(D, 3040, 4096) and not ff4._tensor_core_layout(D, 3040, 4096)
    assert ff4._layout(D, HID, 128) == (6, 128, 24, 128)
    assert ff4._layout(D, HID, 4096) == (1, D, 1, HID)
    assert ff4._cluster(D, HID) == 8
    assert ff4._cluster(D, 3040) == 1        # 95 blocks: no cluster of 2, 4 or 8 divides them
    assert ff4._cluster(96, 256) == 8 and ff4._cluster(24, 256) == 2
    blocks = HID // 2 // ff4.SMALL_M_PAIRS
    assert blocks // ff4._cluster(D, HID) * 8 * D * 4 == 294_912   # workspace bytes at decode
    assert ff4.down_split_choices(D, HID, 128) == (1, 2, 3, 4, 6, 12)
    assert ff4.down_split_choices(D, HID, 4096) == (1,)
    # The down launch's split: two pieces at generate's prefill, four at the
    # refill chunk (2.5 blocks an SM), every group apart at fewer rows.
    assert [ff4._down_splits(m, D, HID, 128, H100_SMS) for m in (1024, 512, 64, 8)] == [
        2, 4, 12, 12]
    assert ff4._down_splits(8, D, HID, 4096, H100_SMS) == 1


def test_counters_and_cpu_calls_launch_nothing(monkeypatch):
    """The counters ``chip_smoke.py`` reads exist and start as ints; a CPU
    call runs the plain version, launches nothing and moves none of them."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU call reached a kernel launch")
    monkeypatch.setattr(ff4, "_launch_cuda", no_launch)
    monkeypatch.setattr(ff4, "_kernel_entries", no_launch)
    before = (ff4.int4_ff.launches, ff4.int4_ff.small_m_launches,
              ff4.int4_ff.tensor_core_launches)
    assert all(isinstance(v, int) for v in before)
    args = [_t(a) for a in _weights(3, 128, 256, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(_normal(4, 2, 8, 128)).to(dtype)
        got = ff4.int4_ff(x, *args, group=64)
        want = ff4.int4_ff_reference(x.reshape(16, 128), *args, group=64).reshape(2, 8, 128)
        assert torch.equal(got, want)
    assert (ff4.int4_ff.launches, ff4.int4_ff.small_m_launches,
            ff4.int4_ff.tensor_core_launches) == before


def test_launcher_refuses_what_a_design_cannot_take(monkeypatch):
    """``_launch_cuda(design=...)`` (the yardstick's way to force a design)
    refuses, before any launch, a design that cannot take the shape, an
    unknown design, a down split that is not whole groups and other
    dtypes."""
    def no_launch(*args, **kwargs):
        raise AssertionError("reached a kernel launch")
    monkeypatch.setattr(ff4, "_kernel_entries", no_launch)
    monkeypatch.setattr(ff4, "_sm_count", lambda index: H100_SMS)
    args = [_t(a) for a in _weights(5, 128, 256, 64)]
    x = torch.from_numpy(_normal(6, 17, 128)).bfloat16()
    for design, kw, xs in (("small_m", {}, x), ("fast", {}, x),
                           ("tensor_core", {"down_splits": 3}, x),
                           ("tensor_core", {}, x.float()), ("cuda_core", {}, x.double())):
        with pytest.raises(ValueError):
            ff4._launch_cuda(xs, *args, group=64, design=design, **kw)
    g16 = [_t(a) for a in _weights(7, 128, 256, 16)]
    with pytest.raises(ValueError, match="tensor_core design cannot take"):
        ff4._launch_cuda(x, *g16, group=16, design="tensor_core")
