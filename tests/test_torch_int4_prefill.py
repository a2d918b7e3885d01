"""Which int4 kernel design takes which product (``ops/int4_matmul.py::_variant``).

``csrc/int4_matmul.cu`` holds three designs of the w4a16 kernel (one weight,
or the q/k/v triple) and of the w4a8 kernel: small-M tensor cores for
decode and small row counts of bf16 or int8 activations, tensor cores for
prefill rows, CUDA cores for fp32 activations, the rows between, and the
layouts the tensor cores do not take. The rule is a pure function of the
shape, layout and SM count, checked here on the CPU at every int4 site of
the 125M model against the designs an H100 timed faster; the kernels
themselves run only on the card (``chip_smoke.py`` holds both designs
against the plain versions there). Also here: the launch
counters that ``chip_smoke.py`` reads, which the CPU path must leave alone.
"""

import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu_torch.models.quantize import quantize_leaf_int4
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_125M
from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4

torch.set_num_threads(1)

GROUP = CONFIG_125M.quantization_group
D, H, V = CONFIG_125M.features, CONFIG_125M.hidden, CONFIG_125M.vocab_size
# (K, N) of each int4 projection of the 125M model; "qkv" is the q/k/v
# triple, one launch over three 768 x 768 weights (3N columns).
SITES = {"qkv_out": (D, D), "ff_up": (D, H), "ff_down": (H, D), "lm_head": (D, V),
         "qkv": (D, 3 * D)}
# Activations: bf16 and fp32 through w4a16, and w4a8 (int8 rows whatever x's dtype).
KINDS = {"fp32": (torch.float32, False), "bf16": (torch.bfloat16, False),
         "w4a8": (torch.bfloat16, True)}
H100_SMS = 132
# Up to this many rows, bf16 and w4a8 products at every site take the
# small-M design: an H100 timed it faster than both other designs there.
SMALL_M_ROWS = 16
# Past them, the fewest rows, of those timed on an H100 (16, 32, 64, 512),
# at which each site takes the tensor cores: where the tensor-core design
# timed faster than the CUDA-core one. fp32 never does.
FIRST_TENSOR_CORE_ROWS = {
    ("qkv_out", "bf16"): 512, ("ff_up", "bf16"): 32, ("ff_down", "bf16"): 512,
    ("lm_head", "bf16"): 9, ("qkv", "bf16"): 32,
    ("qkv_out", "w4a8"): 64, ("ff_up", "w4a8"): 9, ("ff_down", "w4a8"): 64,
    ("lm_head", "w4a8"): 9,
}


def _expected(site, m, kind):
    if kind != "fp32" and m <= SMALL_M_ROWS:
        return "small_m"
    first = FIRST_TENSOR_CORE_ROWS.get((site, kind))
    return "tensor_core" if first is not None and m >= first else "cuda_core"


@pytest.mark.parametrize("m", [8, 9, 16, 32, 64, 512, 1024])
@pytest.mark.parametrize("site,kind", [
    (site, kind) for site in SITES for kind in KINDS
    if not (site == "qkv" and kind == "w4a8")])    # the triple is a w4a16 kernel
def test_variant_at_125m_sites(site, m, kind):
    k, n = SITES[site]
    dtype, w4a8 = KINDS[kind]
    for ng, group in ((k // GROUP, GROUP), (1, k)):       # grouped and one whole-K group
        got = mm4._variant(m, k, n, ng, group, dtype, w4a8, H100_SMS)
        assert got == _expected(site, m, kind), (ng, group)


@pytest.mark.parametrize("w4a8,per_sm", [(False, 2), (True, 1)])
def test_variant_grid_boundary(w4a8, per_sm):
    """Past the small-M rows, the tensor cores take over once the CUDA-core
    grid (N/32 × M/8 blocks) is larger than ``per_sm`` blocks an SM; up to
    them the small-M design takes every grid."""
    sms = 12
    n = 32 * per_sm * sms             # one row tile of blocks reaches the limit
    m = mm4.SMALL_M_ROWS + 1          # 3 row tiles of 8
    assert mm4._variant(m, 768, n, 6, 128, torch.bfloat16, w4a8, sms) == "tensor_core"
    assert mm4._variant(m, 768, n // 3, 6, 128, torch.bfloat16, w4a8, sms) == "cuda_core"
    assert mm4._variant(m + 8, 768, n // 3, 6, 128, torch.bfloat16, w4a8, sms) == "tensor_core"
    assert mm4._variant(8, 768, 100 * n, 6, 128, torch.bfloat16, w4a8, sms) == "small_m"


@pytest.mark.parametrize("k,group,dtype,w4a8,want", [
    # w4a8: a group must end on the int8 MMA's 32 of depth, in packed rows.
    (768, 16, torch.bfloat16, True, "cuda_core"),
    (768, 48, torch.bfloat16, True, "cuda_core"),
    (768, 64, torch.bfloat16, True, "tensor_core"),
    (768, 96, torch.float32, True, "tensor_core"),        # int8 rows from fp32 x
    # w4a16 takes any group that divides K/2 ...
    (768, 48, torch.bfloat16, False, "tensor_core"),
    (768, 16, torch.bfloat16, False, "tensor_core"),
    # ... but fp32 stays on the CUDA cores (TF32 would break its tolerance),
    (768, 128, torch.float32, False, "cuda_core"),
    # and K/2 must be whole 32-row stages, for both kernels.
    (48, 8, torch.bfloat16, False, "cuda_core"),
    (48, 8, torch.bfloat16, True, "cuda_core"),
    (96, 16, torch.bfloat16, False, "cuda_core"),
])
def test_variant_layouts(k, group, dtype, w4a8, want):
    assert mm4._tensor_core_layout(k, k // group, group, dtype, w4a8) == (want == "tensor_core")
    assert mm4._variant(1024, k, D, k // group, group, dtype, w4a8, H100_SMS) == want


@pytest.mark.parametrize("k", [48, 96, 768])
def test_variant_whole_k_group_w4a8(k):
    """One whole-K group: the tensor cores need K/2 in 32-row stages."""
    want = "tensor_core" if (k // 2) % 32 == 0 else "cuda_core"
    assert mm4._variant(512, k, D, 1, k, torch.bfloat16, True, H100_SMS) == want


# The w4a16 tensor-core tile by site and rows on a 132-SM H100 (NW = 1, and
# the triple NW = 3 at 768²), as timed there: the tile whose busiest SM
# multiplies fewer rows (ceil(blocks / 132) blocks of 128 or 96 rows).
TILES_132 = [
    ("qkv_out", 1, 1024, 96),     # 48 blocks of 128 (128 rows) / 66 of 96 (96)
    ("qkv_out", 3, 1024, 96),     # the triple: 144 (256) / 198 (192)
    ("qkv_out", 3, 512, 96),      # 72 (128) / 108 (96)
    ("ff_up", 1, 1024, 96),       # 192 (256) / 264 (192)
    ("ff_up", 1, 512, 128),       # 96 (128) / 144 (192)
    ("ff_down", 1, 1024, 96),     # 48 (128) / 66 (96)
    ("lm_head", 1, 1024, 128),    # 3144 (3072) / 4323 (3168)
    ("lm_head", 1, 512, 128),     # 1572 (1536) / 2358 (1728)
    ("lm_head", 1, 64, 96),       # 393 (384) / 393 (288)
    ("lm_head", 1, 8, 96),
]


@pytest.mark.parametrize("site,nw,m,want", TILES_132)
def test_tile_rows_at_125m_sites(site, nw, m, want):
    _, n = SITES[site]
    assert mm4._tile_rows(m, n, nw, H100_SMS) == want


def test_tile_rows_boundary():
    """A tie in the busiest SM's rows takes the 128-row tile."""
    assert mm4._tile_rows(384, 128, 1, 1) == 128     # 3 × 128 against 4 × 96
    assert mm4._tile_rows(96, 128, 1, 1) == 96       # 128 against 96
    assert mm4._tile_rows(384, 128, 1, 3) == 128     # 1 × 128 against 2 × 96
    assert mm4._tile_rows(288, 128, 1, 3) == 96      # 3 blocks of 128 or of 96: 128 / 96


def test_launch_counters_chip_smoke_reads():
    """The totals per kernel and, beside them, the tensor-core and small-M
    launches."""
    assert set(mm4.int4_matmul.launches) == {
        "w4a16", "w4a8", "w4a16_tensor_core", "w4a8_tensor_core", "w4a16_small_m",
        "w4a8_small_m"}
    assert all(isinstance(v, int) for v in mm4.int4_matmul.launches.values())
    assert isinstance(mm4.int4_matmul3.launches, int)
    assert isinstance(mm4.int4_matmul3.tensor_core_launches, int)


@pytest.mark.parametrize("w4a8", [False, True])
def test_cpu_path_launches_nothing(w4a8):
    """On CPU tensors the wrappers run the plain versions: no count moves,
    whatever design the shape would take on the card."""
    rng = np.random.default_rng(0)
    node = quantize_leaf_int4(torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)), 16)
    x = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32)).to(torch.bfloat16)
    before = (dict(mm4.int4_matmul.launches), mm4.int4_matmul3.launches,
              mm4.int4_matmul3.tensor_core_launches)
    out = mm4.int4_matmul(x, node["q4"], node["scale"], group=16, w4a8=w4a8)
    outs = mm4.int4_matmul3(x, [(node["q4"], node["scale"])] * 3, group=16)
    assert out.shape == (16, 32) and all(o.shape == (16, 32) for o in outs)
    assert (dict(mm4.int4_matmul.launches), mm4.int4_matmul3.launches,
            mm4.int4_matmul3.tensor_core_launches) == before


def test_aligned_copies_only_an_offset_view():
    """The tensor-core design copies x in 16-byte pieces: a view that starts
    off a 16-byte boundary is copied, an aligned tensor passes as it is."""
    x = torch.zeros(4, 72, dtype=torch.bfloat16)
    assert mm4._aligned(x) is x
    view = x.reshape(-1)[2:2 + 64].reshape(1, 64)
    copy = mm4._aligned(view)
    assert copy is not view and copy.data_ptr() % 16 == 0
    torch.testing.assert_close(copy, view, rtol=0, atol=0)
