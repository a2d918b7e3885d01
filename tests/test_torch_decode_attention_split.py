"""The split of decode attention over the cache length (plain version)
against the unsplit plain version and the JAX kernel.

``split_ranges`` gives the cache slots each block of a split launch attends
(its q tile's span cut into pieces of whole 64-slot tiles, as the CUDA
kernels cut it on the device) and ``decode_attention_split_reference``
merges the pieces' partial softmaxes in fixed order, as the combine kernel
does. Both are held here, in fp32 within 1e-5, to ``decode_attention_reference``
and to the JAX kernel in Pallas interpret mode (as the JAX package's own
tests run it on the CPU), on numpy-seeded inputs: splits 1-8, ragged
per-row indices, windows, GQA, several q tiles, int8 caches, page pools,
pieces left empty, and the folded write, whose slot lies in exactly one
piece. Then the wrapper's rules for the design and the split. The CUDA
kernels themselves are held to these plain versions by ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
)
from learning_jax_sharding_tpu_torch.models.attention import quantize_kv_chunk
from learning_jax_sharding_tpu_torch.ops import decode_attention as da
from learning_jax_sharding_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
    decode_attention_split_reference,
    split_ranges,
)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
B, NKV, H, L = 3, 2, 16, 320       # five 64-slot tiles a row
PAGE, T_CAP = 32, 10               # page pools of the same capacity
INDEX = [5, 150, 270]              # ragged: 1, 3 and 5 tiles of prefix
# name: (s, group, window, tile_rows)
CONFIGS = {
    "token": (1, 1, None, None),
    "gqa_window": (5, 2, 90, None),
    "tiles": (24, 2, None, 16),
}


def _cache(rng, shape, int8):
    """Seeded float cache values, or int8 values and their fp32 scales."""
    x = rng.normal(size=shape).astype(np.float32)
    if not int8:
        return {"c": x}
    scale, q = quantize_kv_chunk(torch.from_numpy(x))
    return {"c": q.to(torch.int8).numpy(), "s": scale.numpy()}


def _inputs(seed, s, group, *, int8=False, paged=False, fold=False):
    """numpy q and caches (or page pools and a table), and new-token k/v."""
    rng = np.random.default_rng(seed)
    shape = (B * T_CAP + 1, NKV, PAGE, H) if paged else (B, NKV, L, H)
    arrays = {"q": rng.normal(size=(B, s, NKV * group, H)).astype(np.float32)}
    for name in ("k", "v"):
        cache = _cache(rng, shape, int8)
        arrays[f"{name}_cache"] = cache["c"]
        if int8:
            arrays[f"{name}_scale"] = cache["s"]
        if fold:
            new = _cache(rng, (B, NKV, 1, H), int8)
            arrays[f"{name}_new"] = new["c"]
            if int8:
                arrays[f"{name}s_new"] = new["s"]
    if paged:
        table = rng.permutation(np.arange(1, B * T_CAP + 1)).reshape(B, T_CAP)
        arrays["block_table"] = table.astype(np.int32)
    return arrays


def _torch(arrays):
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


@functools.cache
def _jax(seed, s, group, window, int8=False, paged=False, fold=False, write_enable=None):
    """The JAX kernel in interpret mode → numpy results (out, then the
    folded caches and scales)."""
    arrays = _inputs(seed, s, group, int8=int8, paged=paged, fold=fold)
    jx = {k: jnp.asarray(v) for k, v in arrays.items() if k != "q"}
    if write_enable is not None:
        jx["write_enable"] = jnp.asarray(write_enable, jnp.int32)
    q, kc, vc = jnp.asarray(arrays["q"]), jx.pop("k_cache"), jx.pop("v_cache")
    out = jax_decode_attention(q, kc, vc, jnp.asarray(INDEX, jnp.int32), window=window,
                               block_k=PAGE if paged else 64, interpret=True, **jx)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else (np.asarray(out),)


def _split(arrays, splits, *, window=None, tile_rows=None, write_enable=None):
    """The split plain version on fresh tensors → numpy results."""
    t = _torch(arrays)
    q, kc, vc = t.pop("q"), t.pop("k_cache"), t.pop("v_cache")
    if write_enable is not None:
        t["write_enable"] = torch.tensor(write_enable, dtype=torch.int32)
    out = decode_attention_split_reference(
        q, kc, vc, torch.tensor(INDEX, dtype=torch.int32), splits=splits, window=window,
        tile_rows=tile_rows, **t)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else (out.numpy(),)


def _plain(arrays, *, window=None, write_enable=None):
    t = _torch(arrays)
    q, kc, vc = t.pop("q"), t.pop("k_cache"), t.pop("v_cache")
    if write_enable is not None:
        t["write_enable"] = torch.tensor(write_enable, dtype=torch.int32)
    out = decode_attention_reference(q, kc, vc, torch.tensor(INDEX, dtype=torch.int32),
                                     window=window, **t)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else (out.numpy(),)


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("config", CONFIGS)
def test_split_matches_plain_and_jax(config, splits):
    s, group, window, tile_rows = CONFIGS[config]
    arrays = _inputs(11, s, group)
    (out,) = _split(arrays, splits, window=window, tile_rows=tile_rows)
    (plain,) = _plain(arrays, window=window)
    np.testing.assert_allclose(out, plain, **TOL)
    np.testing.assert_allclose(out, _jax(11, s, group, window)[0], **TOL)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_int8_matches_jax(splits):
    arrays = _inputs(12, 5, 2, int8=True)
    (out,) = _split(arrays, splits, window=90)
    np.testing.assert_allclose(out, _plain(arrays, window=90)[0], **TOL)
    np.testing.assert_allclose(out, _jax(12, 5, 2, 90, int8=True)[0], **TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("splits", [1, 4, 7])
def test_split_paged_matches_jax(splits, int8):
    arrays = _inputs(13, 3, 2, int8=int8, paged=True)
    (out,) = _split(arrays, splits, tile_rows=4)
    np.testing.assert_allclose(out, _plain(arrays)[0], **TOL)
    np.testing.assert_allclose(out, _jax(13, 3, 2, None, int8=int8, paged=True)[0], **TOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_split_folded_write(int8, paged):
    """The split plain version's folded write equals the JAX kernel's bit
    for bit (caches and scales, the disabled row untouched) and its output
    the JAX kernel's, at a split with more pieces than some rows' tiles."""
    arrays = _inputs(14, 1, 2, int8=int8, paged=paged, fold=True)
    enable = (1, 0, 1)
    got = _split(arrays, 6, write_enable=enable)
    want = _jax(14, 1, 2, None, int8=int8, paged=paged, fold=True, write_enable=enable)
    assert len(got) == len(want) == (5 if int8 else 3)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def _span(index, s, group, window, length, tile_rows):
    """Each (row, q tile)'s attended slots [first, last], by position."""
    total = s * group
    spans = []
    for idx in index:
        row = []
        for row0 in range(0, total, tile_rows):
            first_pos = idx + row0 // group
            last = min(idx + (min(row0 + tile_rows, total) - 1) // group, length - 1)
            row.append((max(0, first_pos - window + 1) if window else 0, last))
        spans.append(row)
    return spans


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("s,group,window,tile_rows", [(1, 1, None, None), (5, 2, 100, None),
                                                      (24, 2, None, 16), (64, 1, 37, 64)])
def test_split_ranges_partition_the_span(s, group, window, tile_rows, splits):
    """The pieces of each block's span are in order, disjoint, cover it
    exactly, start and end on 64-slot tiles inside it, and number
    min(splits, its tiles); the rest are empty."""
    index = [0, 63, 64, 200, 700, 1000]
    length = 1024
    tr = s * group if tile_rows is None else tile_rows
    ranges = split_ranges(torch.tensor(index), s, group, window, length, splits, tile_rows)
    assert ranges.shape == (len(index), -(-s * group // tr), splits, 2)
    for b, row in enumerate(_span(index, s, group, window, length, tr)):
        for t, (first, last) in enumerate(row):
            pieces = [tuple(p) for p in ranges[b, t].tolist()]
            full = [p for p in pieces if p[1] > p[0]]
            tiles = last // 64 - first // 64 + 1
            assert len(full) == min(splits, tiles)
            assert full[0][0] == first and full[-1][1] == last + 1
            for (_, end), (start, _) in zip(full, full[1:]):
                assert end == start and start % 64 == 0
            assert all(p[1] == p[0] for p in pieces if p not in full)
            ends = [p[1] for p in pieces]
            assert ends == sorted(ends)


@pytest.mark.parametrize("splits", range(1, 9))
def test_exactly_one_writer_piece(splits):
    """A token step's folded-write slot index_b lies in exactly one piece:
    the last that is not empty, so one block writes it before its reads."""
    index = torch.tensor([0, 5, 63, 64, 130, 319])
    for window in (None, 40):
        ranges = split_ranges(index, 1, 1, window, L, splits)[:, 0]     # (B, splits, 2)
        holds = (ranges[..., 0] <= index[:, None]) & (index[:, None] < ranges[..., 1])
        assert holds.sum(dim=1).tolist() == [1] * len(index)
        last_full = (ranges[..., 1] > ranges[..., 0]).long().cumsum(1).argmax(1)
        assert holds.long().argmax(1).tolist() == last_full.tolist()


def test_empty_pieces_leave_the_output():
    """More pieces than the prefix has tiles: the empty pieces (l = 0) drop
    out of the merge; the result is the unsplit one."""
    arrays = _inputs(15, 1, 1)
    ranges = split_ranges(torch.tensor(INDEX), 1, 1, None, L, 8)
    assert (ranges[0, 0, :, 1] == ranges[0, 0, :, 0]).sum() == 7      # row 0: one tile
    np.testing.assert_allclose(_split(arrays, 8)[0], _plain(arrays)[0], **TOL)


def test_design_rule():
    """Tensor cores for bf16 chunks of at least 16 folded rows at H = 64 or
    128 (the engine's refill, the prompt's prefill, an MQA token step of 16
    heads); the CUDA cores for the token step, fp32 and other head dims."""
    bf16, fp32 = torch.bfloat16, torch.float32
    assert da._design(bf16, 64, 64) == "tensor_core"        # refill chunk, S = 64
    assert da._design(bf16, 128, 64) == "tensor_core"       # prefill, S = 128
    assert da._design(bf16, 16, 128) == "tensor_core"       # S = 1, group 16
    assert da._design(bf16, 1, 64) == "cuda_core"           # token step
    assert da._design(bf16, 15, 64) == "cuda_core"
    assert da._design(fp32, 128, 64) == "cuda_core"
    assert da._design(bf16, 128, 80) == "cuda_core"


def test_splits_rule():
    """The 125M shapes (b = 8, 12 kv heads, 1024 slots) as an H100 timed
    them fastest: the token step in 4 pieces (384 blocks), the refill's one
    q tile in 2 (192), the prefill's two q tiles unsplit (192); a grid
    already past the target and a one-tile cache stay unsplit, and every
    shape within [1, MAX_SPLITS]."""
    assert da._splits(8, 12, 1, 1024, "cuda_core") == 4
    assert da._splits(8, 12, 1, 1024, "tensor_core") == 2
    assert da._splits(8, 12, 2, 1024, "tensor_core") == 1
    assert da._splits(64, 12, 1, 1024, "cuda_core") == 1
    assert da._splits(1, 1, 1, 64, "cuda_core") == 1
    assert da._splits(1, 1, 1, 100, "cuda_core") == 2
    assert da._splits(1, 1, 1, 1 << 20, "cuda_core") == da.MAX_SPLITS
    for b in (1, 3, 8, 32):
        for design in ("cuda_core", "tensor_core"):
            sp = da._splits(b, 12, 1, 4096, design)
            assert 1 <= sp <= da.MAX_SPLITS
            assert b * 12 * sp >= da.SPLIT_TARGET_BLOCKS[design] or sp == da.MAX_SPLITS


def test_wrapper_checks_design_and_splits():
    """``design=``/``splits=`` are checked before anything runs; on CPU
    tensors the plain version runs whatever they say, and no kernel
    counter moves."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(16, 1, 1).items()}
    idx = torch.tensor(INDEX, dtype=torch.int32)
    with pytest.raises(ValueError, match="design must be one of"):
        decode_attention(t["q"], t["k_cache"], t["v_cache"], idx, design="wgmma")
    for splits in (0, da.MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="splits must be in"):
            decode_attention(t["q"], t["k_cache"], t["v_cache"], idx, splits=splits)
    counters = ("launches", "paged_launches", "tensor_core_launches", "split_launches")
    before = {c: getattr(decode_attention, c) for c in counters}
    out = decode_attention(t["q"], t["k_cache"], t["v_cache"], idx, design="tensor_core",
                           splits=5)
    np.testing.assert_array_equal(out.numpy(), _plain(_inputs(16, 1, 1))[0])
    assert {c: getattr(decode_attention, c) for c in counters} == before


def test_plan_at_the_main_path_shapes():
    """The launches of the 125M paths (b = 8, 12 heads, 1024 slots): the
    generate prefill and the engine's refill on the tensor cores, the
    token step and fp32 chunks on the CUDA cores, each split as
    ``_splits`` says for its design's q tiles; a forced design keeps the
    split of its own tiles."""
    bf16, fp32 = torch.bfloat16, torch.float32
    assert da._plan(bf16, 8, 128, 12, 12, 64, 1024) == ("tensor_core", 1, 128)
    assert da._plan(bf16, 8, 64, 12, 12, 64, 1024) == ("tensor_core", 2, 64)
    assert da._plan(bf16, 8, 1, 12, 12, 64, 1024) == ("cuda_core", 4, 1)
    assert da._plan(fp32, 8, 128, 12, 12, 64, 1024) == ("cuda_core", 4, 128)
    assert da._plan(bf16, 8, 64, 12, 12, 64, 1024, design="cuda_core") == ("cuda_core", 4, 64)
    assert da._plan(bf16, 8, 1, 12, 12, 64, 1024, splits=1) == ("cuda_core", 1, 1)
    assert da._plan(bf16, 4, 64, 16, 4, 128, 1024, block_q=32) == ("tensor_core", 3, 32)
