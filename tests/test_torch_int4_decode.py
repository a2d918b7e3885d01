"""The small-M design of the int4 matmuls (``csrc/int4_matmul.cu`` design 3)
on the CPU: its split over K (plain versions), the rule that routes decode
rows to it, and its counters.

A small-M launch cuts the packed rows into pieces (``split_pieces``, the
twin of the kernel's ``sm::piece_span``): w4a16 pieces write fp32 partials
that a combine adds in piece order; w4a8 pieces keep each scale group's
int32 sums whole (whole groups a piece, or equal parts of every group) and
the combine adds a group's parts in int32 before design 1's fp32 epilogue.
``int4_matmul_split_reference`` and ``int4_matmul_w4a8_split_reference``
compute exactly that. Both are held here to the unsplit plain versions (w4a8
bit-equal; w4a16 within 1e-5 in fp32, 2^-7 in bf16) and to the JAX Pallas
kernels in interpret mode, as the JAX package's own tests run them on the
CPU, for every split the rule can pick, on numpy-seeded inputs at M = 1, 8,
16 with groups of 64 and 128 rows and one whole-K group. Then ``_variant``
and ``_splits`` at the 125M model's sites on a 132-SM H100. The kernels
themselves run only on the card: ``chip_smoke.py`` holds every design,
split and unsplit, to these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import quantize as jq
from learning_jax_sharding_tpu.ops import int4_matmul as jmm
from learning_jax_sharding_tpu_torch.models.quantize import quantize_leaf_int4
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_125M
from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4

torch.set_num_threads(1)

K, N = 256, 96            # four 32-row chunks a half
ROWS = (1, 8, 16)
GROUPS = (64, 128, K)     # K: one whole-K group
H100_SMS = 132
D, H, V = CONFIG_125M.features, CONFIG_125M.hidden, CONFIG_125M.vocab_size


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _node(seed, group):
    """A (K, N) weight quantized eagerly by the JAX package, as numpy."""
    node = jq.quantize_leaf_int4(jnp.asarray(_normal(seed, K, N)), group_size=group)
    return {k: np.asarray(v) for k, v in node.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _every_split(group, w4a8):
    ng = 1 if group == K else K // group
    return mm4.split_choices(K // 2, ng, group, w4a8)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("w4a8", [False, True])
def test_split_pieces_tile_the_packed_rows(group, w4a8):
    """Every split's pieces run back to back over [0, K/2) in whole chunks;
    w4a8 pieces never cross a scale group unless they take it whole."""
    ng = 1 if group == K else K // group
    rows = K // 2 if ng == 1 else group
    for splits in _every_split(group, w4a8):
        pieces = mm4.split_pieces(K // 2, ng, group, splits, w4a8)
        assert len(pieces) == splits
        assert pieces[0][0] == 0 and pieces[-1][1] == K // 2
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        assert all(r1 > r0 and r0 % 32 == 0 and r1 % 32 == 0 for r0, r1 in pieces)
        if w4a8:
            for r0, r1 in pieces:
                whole = r0 % rows == 0 and r1 % rows == 0
                assert whole or r0 // rows == (r1 - 1) // rows, (splits, r0, r1)


@pytest.mark.parametrize("k_half,ng,group,w4a8,want", [
    (128, 4, 64, False, [1, 2, 3, 4]),           # w4a16 cuts at any chunk
    (128, 4, 64, True, [1, 2, 4]),               # 2 groups of 2 chunks
    (384, 6, 128, True, [1, 2, 3, 6, 9, 12]),    # the 768-row sites: 3 groups of 4 chunks
    (128, 1, 256, True, [1, 2, 3, 4]),           # one whole-K group: any chunk
])
def test_split_choices(k_half, ng, group, w4a8, want):
    assert mm4.split_choices(k_half, ng, group, w4a8) == want


def test_split_rejects_other_layouts():
    with pytest.raises(ValueError, match="chunks"):
        mm4.split_pieces(48, 6, 8, 1)
    with pytest.raises(ValueError, match="not one of"):
        mm4.split_pieces(128, 4, 64, 3, w4a8=True)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", ROWS)
def test_w4a16_split_matches_unsplit_and_pallas(m, group):
    node = _node(30 + group, group)
    q4, s = _t(node["q4"]), _t(node["scale"])
    x = _normal(31, m, K)
    with jax.default_matmul_precision("float32"):
        pallas = np.asarray(jmm.int4_matmul(jnp.asarray(x), node["q4"], node["scale"],
                                            group=group, interpret=True))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
        xt = torch.from_numpy(x).to(dtype)
        unsplit = mm4.int4_matmul_reference(xt, q4, s, group=group)
        for splits in _every_split(group, False):
            got = mm4.int4_matmul_split_reference(xt, q4, s, group=group, splits=splits)
            assert got.dtype == dtype and got.shape == (m, N)
            assert _rel(got, unsplit) <= tol, (dtype, splits)
            if dtype == torch.float32:
                np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", ROWS)
def test_w4a16_triple_split_matches_pallas(m, group):
    nodes = [_node(40 + i, group) for i in range(3)]
    x = _normal(43, m, K)
    with jax.default_matmul_precision("float32"):
        pallas = jmm.int4_matmul3(jnp.asarray(x), [(a["q4"], a["scale"]) for a in nodes],
                                  group=group, interpret=True)
    for splits in _every_split(group, False):
        for node, want in zip(nodes, pallas):
            got = mm4.int4_matmul_split_reference(torch.from_numpy(x), _t(node["q4"]),
                                                  _t(node["scale"]), group=group, splits=splits)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", ROWS)
def test_w4a8_split_bit_equal_and_matches_pallas(m, group):
    """The int32 group sums are exact on both sides and the fp32 epilogue
    runs the same operations in the same order: bit-equal to the unsplit
    plain version; against Pallas, the JAX tests' float tolerance."""
    node = _node(50 + group, group)
    q4, s = _t(node["q4"]), _t(node["scale"])
    x = _normal(51, m, K)
    pallas = np.asarray(jmm.int4_matmul(jnp.asarray(x), node["q4"], node["scale"], group=group,
                                        interpret=True, w4a8=True))
    for dtype in (torch.float32, torch.bfloat16):
        xq, sx = mm4.quantize_rows_int8(torch.from_numpy(x).to(dtype))
        unsplit = mm4.int4_matmul_w4a8_reference(xq, sx, q4, s, group=group, out_dtype=dtype)
        for splits in _every_split(group, True):
            got = mm4.int4_matmul_w4a8_split_reference(xq, sx, q4, s, group=group,
                                                       splits=splits, out_dtype=dtype)
            assert torch.equal(got, unsplit), (dtype, splits)
            if dtype == torch.float32:
                np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-6, atol=1e-5)


# (K, N) of each int4 projection of the 125M model; "qkv" is the q/k/v
# triple (three 768 x 768 weights, one launch).
SITES = {"qkv_out": (D, D), "ff_up": (D, H), "ff_down": (H, D), "lm_head": (D, V), "qkv": (D, D)}
GROUP = CONFIG_125M.quantization_group


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("site,kind", [
    (site, kind) for site in SITES for kind in ("bf16", "w4a8", "fp32")
    if not (site == "qkv" and kind == "w4a8")])    # the triple is a w4a16 kernel
def test_decode_rows_take_small_m(site, kind, m):
    """Every 125M site at decode rows (bf16 and w4a8) takes the small-M
    design, which an H100 timed faster than the CUDA-core design there;
    fp32 activations stay on the CUDA cores (tensor cores would take them
    as TF32)."""
    k, n = SITES[site]
    nw = 3 if site == "qkv" else 1
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    for ng, group in ((k // GROUP, GROUP), (1, k)):
        got = mm4._variant(m, k, nw * n, ng, group, dtype, kind == "w4a8", H100_SMS)
        assert got == ("cuda_core" if kind == "fp32" else "small_m")


@pytest.mark.parametrize("k,group,dtype,w4a8,want", [
    (768, 16, torch.bfloat16, False, "cuda_core"),    # groups of half a chunk
    (768, 48, torch.bfloat16, True, "cuda_core"),
    (768, 64, torch.bfloat16, True, "small_m"),
    (768, 96, torch.float32, True, "small_m"),        # int8 rows from fp32 x
    (96, 16, torch.bfloat16, False, "cuda_core"),     # K/2 = 48: no whole chunks
    (768, 128, torch.float32, False, "cuda_core"),
])
def test_small_m_layouts(k, group, dtype, w4a8, want):
    assert mm4._small_m_layout(k, k // group, group, dtype, w4a8) == (want == "small_m")
    assert mm4._variant(8, k, D, k // group, group, dtype, w4a8, H100_SMS) == want


def test_small_m_rows_bound():
    """Past ``SMALL_M_ROWS`` rows the earlier rule decides."""
    limit = mm4.SMALL_M_ROWS
    assert mm4._variant(limit, D, D, 6, 128, torch.bfloat16, False, H100_SMS) == "small_m"
    assert mm4._variant(limit + 1, D, D, 6, 128, torch.bfloat16, False, H100_SMS) != "small_m"


# The split at M = 8 on a 132-SM H100, group 128 (the 125M quantization):
# the fewest pieces whose grid holds SMALL_M_WARPS_PER_SM (8) warps an SM,
# as an H100's sweep over every split found best or within 0.15 us of it.
SPLITS_132 = [
    ("qkv_out", False, 1, 12),    # 24 warps a piece: every chunk its own piece
    ("qkv_out", True, 1, 12),
    ("qkv", False, 3, 12),        # 72 warps a piece
    ("ff_up", False, 1, 11),      # 96 warps a piece
    ("ff_up", True, 1, 12),       # w4a8: 9 is not enough, 12 = parts of all 3 groups
    ("ff_down", False, 1, 16),    # 24 warps a piece, at most MAX_SMALL_M_SPLITS
    ("ff_down", True, 1, 12),     # one piece a group
    ("lm_head", False, 1, 1),     # 1572 warps: the card is full
    ("lm_head", True, 1, 1),
]


@pytest.mark.parametrize("site,w4a8,nw,want", SPLITS_132)
def test_splits_at_125m_sites(site, w4a8, nw, want):
    k, n = SITES[site]
    got = mm4._splits(8, k, n, nw, k // GROUP, GROUP, H100_SMS, w4a8)
    assert got == want
    assert got in mm4.split_choices(k // 2, k // GROUP, GROUP, w4a8)


def test_splits_bounds():
    """The fewest pieces that fill the card, within the layout's choices and
    ``MAX_SMALL_M_SPLITS``; one piece once a piece alone fills it."""
    per_sm = mm4.SMALL_M_WARPS_PER_SM
    cols = mm4.SMALL_M_COLS
    assert mm4._splits(8, 768, cols, 1, 6, 128, 1, False) == per_sm       # one warp a piece
    assert mm4._splits(8, 768, cols * per_sm * 132, 1, 6, 128, 132, True) == 1
    assert mm4._splits(8, 768, cols * per_sm * 132 - cols, 1, 6, 128, 132, False) == 2
    assert mm4._splits(8, 64, 64, 1, 1, 64, 132, False) == 1              # one chunk: one piece
    assert mm4._splits(8, 6144, 64, 1, 48, 128, 132, False) == mm4.MAX_SMALL_M_SPLITS


def test_launch_counters_chip_smoke_reads():
    assert {"w4a16_small_m", "w4a8_small_m"} <= set(mm4.int4_matmul.launches)
    assert isinstance(mm4.int4_matmul3.small_m_launches, int)
    assert mm4._DESIGN_CODES["small_m"] == 2


@pytest.mark.parametrize("w4a8", [False, True])
def test_cpu_call_at_decode_rows_launches_nothing(w4a8):
    """A decode-size product on CPU tensors, which the card would run on
    the small-M design, runs the plain version: no count moves."""
    rng = np.random.default_rng(0)
    node = quantize_leaf_int4(torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)), 64)
    x = torch.from_numpy(rng.normal(size=(8, 256)).astype(np.float32)).to(torch.bfloat16)
    assert mm4._variant(8, 256, 64, 4, 64, torch.bfloat16, w4a8, H100_SMS) == "small_m"
    before = (dict(mm4.int4_matmul.launches), mm4.int4_matmul3.launches,
              mm4.int4_matmul3.small_m_launches)
    out = mm4.int4_matmul(x, node["q4"], node["scale"], group=64, w4a8=w4a8)
    outs = mm4.int4_matmul3(x, [(node["q4"], node["scale"])] * 3, group=64)
    assert out.shape == (8, 64) and all(o.shape == (8, 64) for o in outs)
    assert (dict(mm4.int4_matmul.launches), mm4.int4_matmul3.launches,
            mm4.int4_matmul3.small_m_launches) == before
