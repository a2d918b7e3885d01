"""Length-aware KV-cache attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``learning_jax_sharding_tpu/ops/decode_attention.py``. Queries of a
chunk (S = 1 for a token step, the prompt for prefill) attend to the valid
prefix of a ``(B, N_kv, L, H)`` cache; the frontier is per row, so a ragged
batch pays per-row traffic. The GQA group folds into the query rows (q head
``n`` reads kv head ``n // group``), so the cache is never expanded.

int8 caches carry fp32 per-(token, head) scales: the score columns are
scaled by ``k_scale`` after the q·k contraction, the probabilities by
``v_scale`` after the softmax sum ``l`` took them unscaled, and the folded
write merges the new token's scales as well.

For CUDA tensors :func:`decode_attention` launches the hand-written kernel
in ``csrc/decode_attention.cu`` (built at first use, see ``_build``); for CPU
tensors it runs :func:`decode_attention_reference`, the plain version the
tests hold against the JAX kernel. Nothing falls back from one to the other.

Paged mode (``block_table``): the caches are ``(P, N_kv, page, H)`` pools
shared by every row (scales ``(P, N_kv, page)``), and row ``b``'s logical
cache position ``i`` lives at ``(block_table[b, i // page], :, i % page)``;
the logical capacity is ``T·page``. Both versions translate each logical row
through the table and compute what the contiguous layout computes; the
continuous engine (``models/serving.py``) owns the table.

The kernel has two designs (:func:`_design`): ``"tensor_core"`` (bf16
``mma.sync`` products into fp32) for chunks of at least 16 folded rows in
bf16 (the engine's refill, the prompt's prefill), ``"cuda_core"`` (fp32
FMAs) otherwise. Both split the cache span into ``splits`` pieces
(:func:`_splits`, flash-decoding): each block attends one piece and writes
its partial softmax, and a second kernel merges the pieces in fixed order.
:func:`split_ranges` and :func:`decode_attention_split_reference` are the
plain versions of the pieces and of that merge.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library

_NEG_INF = -1e30  # large-negative instead of -inf: keeps exp/max NaN-free
_BLOCK_Q = 128    # q rows per tile, as the JAX kernel
_MAX_TILE_ROWS = 128   # kMaxRows in csrc/decode_attention.cu
_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGN_CODES = {"cuda_core": 0, "tensor_core": 1}
TILE_K = 64          # cache slots a tile (kTileK); pieces are whole tiles
TC_ROWS = 64         # folded q rows a tensor-core block (tcd::kTcRows)
TC_MIN_ROWS = 16     # one mma.sync tile of rows
MAX_SPLITS = 16      # kMaxSplits
# Blocks a launch should reach through its split, per design: fitted on an
# H100 (132 SMs) by chip_smoke.py's split sweeps (PERF.md section 6). The
# tensor-core design (a chunk) splits only a grid short of one block an SM:
# the 125M refill's 96 blocks gain from 2 pieces, while the 1.4B prefill
# chunk's 128 blocks (16 heads of 128) run fastest whole over caches of 4 to
# 12 tiles, at index 0 and as the cache's last chunk alike. Any target in
# (96, 128] gives both; the 125M prefill (192 blocks) stays whole under all.
SPLIT_TARGET_BLOCKS = {"tensor_core": 128, "cuda_core": 384}


def auto_block_k(length: int, cap: int = 256) -> int:
    """Largest power of two ≤ ``cap`` dividing ``length``; one full-length
    block when ``length`` has no power-of-two factor ≥ 8."""
    blk = 1
    while blk < cap and length % (blk * 2) == 0:
        blk *= 2
    return blk if blk >= 8 else length


def _row_index(index, b: int, device) -> torch.Tensor:
    """Scalar or ``(B,)`` index → contiguous ``(B,)`` int32 on ``device``."""
    idx = torch.as_tensor(index, dtype=torch.int32, device=device)
    return idx.expand(b).contiguous()


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    index,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    k_new: torch.Tensor | None = None,
    v_new: torch.Tensor | None = None,
    ks_new: torch.Tensor | None = None,
    vs_new: torch.Tensor | None = None,
    write_enable: torch.Tensor | None = None,
    block_table: torch.Tensor | None = None,
    window: int | None = None,
    scale: float | None = None,
):
    """The plain version of the kernel: dense masked fp32 attention over the
    whole cache, with the kernel's fold, ``write_enable``, ``-1e30`` mask and
    ``l == 0`` guard, and its int8 scaling (score columns by ``k_scale``,
    probabilities by ``v_scale`` after ``l``). The folded write updates the
    caches (and scales) IN PLACE. Paged pools go through the table: the
    folded write lands at each row's mapped page and slot, then every row's
    logical view is gathered and attended as a contiguous cache. Takes
    validated arguments (see :func:`decode_attention`)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _fold(q.shape[0], k_cache, v_cache, index, k_new=k_new, v_new=v_new, ks_new=ks_new,
          vs_new=vs_new, k_scale=k_scale, v_scale=v_scale, write_enable=write_enable,
          block_table=block_table)
    out = _attend(q, *_logical(k_cache, v_cache, k_scale, v_scale, block_table), index,
                  window, scale)
    return _with_caches(out, k_new, k_cache, v_cache, k_scale, v_scale)


def _with_caches(out, k_new, k_cache, v_cache, k_scale, v_scale):
    """The public return: ``out``, or with the folded write the caches too."""
    if k_new is None:
        return out
    return (out, k_cache, v_cache) + ((k_scale, v_scale) if k_scale is not None else ())


def _fold(b, k_cache, v_cache, index, *, k_new, v_new, ks_new, vs_new, k_scale, v_scale,
          write_enable, block_table):
    """The folded write, IN PLACE: each enabled row's new k/v (and int8
    scales) at slot ``index_b`` of its cache, or of its mapped page."""
    if k_new is None:
        return
    merges = [(k_cache, k_new), (v_cache, v_new)]
    if k_scale is not None:
        merges += [(k_scale, ks_new), (v_scale, vs_new)]
    if block_table is not None:
        page = k_cache.shape[2]
        length = block_table.shape[1] * page
        rows = _fold_keep(index, write_enable, b, length, k_cache.device).nonzero()[:, 0]
        at = _row_index(index, b, k_cache.device)[rows].long()
        pages = block_table[rows, at // page].long()
        for pool, new in merges:
            pool[pages, :, at % page] = new[rows, :, 0].to(pool.dtype)
        return
    length = k_cache.shape[2]
    idx = _row_index(index, b, k_cache.device)
    slot = idx.long().clamp(0, length - 1)
    keep = _fold_keep(idx, write_enable, b, length, k_cache.device)
    for cache, new in merges:
        lead = (b,) + (1,) * (cache.ndim - 1)          # per row, at dim 2
        at = slot.view(lead).expand(*new.shape)
        merged = torch.where(keep.view(lead), new.to(cache.dtype), cache.gather(2, at))
        cache.scatter_(2, at, merged)


def _logical(k_cache, v_cache, k_scale, v_scale, block_table):
    """Each row's logical caches (and scales): the caches themselves, or
    gathered from page pools through the table (copies)."""
    if block_table is None:
        return k_cache, v_cache, k_scale, v_scale
    return tuple(None if t is None else _paged_view(t, block_table)
                 for t in (k_cache, v_cache, k_scale, v_scale))


def _scores(q, k_cache, k_scale, index, window, scale):
    """fp32 scores ``(B, N, S, L)`` of the folded heads (int8: times the k
    scales) and the kept mask ``(B, 1, S, L)``: causal from each row's
    index, the window, the cache's end."""
    b, s, n, _ = q.shape
    n_kv, length = k_cache.shape[1], k_cache.shape[2]
    group = n // n_kv
    idx = _row_index(index, b, q.device)
    k = k_cache.float().repeat_interleave(group, dim=1)       # (B, N, L, H)
    scores = torch.einsum("bsnh,bnlh->bnsl", q.float() * scale, k)
    if k_scale is not None:
        # Per-(token, head) scales are constant over H: they scale the
        # score columns after the contraction.
        scores = scores * k_scale.repeat_interleave(group, dim=1)[:, :, None, :]
    qpos = idx[:, None].long() + torch.arange(s, device=q.device)   # (B, S)
    cols = torch.arange(length, device=q.device)
    mask = cols[None, None, :] <= qpos[:, :, None]                   # (B, S, L)
    if window is not None:
        mask = mask & (cols[None, None, :] > qpos[:, :, None] - window)
    return scores, mask[:, None]


def _attend(q, k_cache, v_cache, k_scale, v_scale, index, window, scale):
    """Dense masked attention over contiguous caches → ``(B, S, N, H)``."""
    group = q.shape[2] // k_cache.shape[1]
    scores, mask = _scores(q, k_cache, k_scale, index, window, scale)
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        # l sums the unscaled p; the v scales weight the probability columns.
        p = p * v_scale.repeat_interleave(group, dim=1)[:, :, None, :]
    v = v_cache.float().repeat_interleave(group, dim=1)
    out = torch.einsum("bnsl,bnlh->bsnh", p / torch.where(l == 0, 1.0, l), v)
    return out.to(q.dtype)


def _fold_keep(index, write_enable, b: int, length: int, device) -> torch.Tensor:
    """``(B,)`` bool: the rows whose folded write lands (a slot inside the
    cache, and ``write_enable`` on)."""
    idx = _row_index(index, b, device)
    keep = (idx >= 0) & (idx < length)
    if write_enable is not None:
        keep = keep & (_row_index(write_enable, b, device) != 0)
    return keep


def _paged_view(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Each row's logical cache from a page pool: ``(P, N_kv, page, ...)``
    through the ``(B, T)`` table → ``(B, N_kv, T·page, ...)`` (a copy)."""
    view = pool[block_table.long()].transpose(1, 2)        # (B, N_kv, T, page, ...)
    return view.reshape(*view.shape[:2], -1, *view.shape[4:])


def split_ranges(index, s: int, group: int, window: int | None, length: int,
                 splits: int, tile_rows: int | None = None) -> torch.Tensor:
    """The cache slots each block of a split launch attends, as the kernels
    compute them on the device (``piece_tiles``) → ``(B, tiles, splits, 2)``
    int64 ``[start, end)``. Block (q tile, piece) takes its rows' span, from
    the first row's window start to the last row's causal frontier (clipped
    to the cache), cut into ``splits`` pieces of whole ``TILE_K``-slot tiles
    as evenly as whole tiles allow; a piece with no tile is empty
    (``start == end``). ``index``: an int or ``(B,)``; folded row ``g`` of a
    row is query ``g // group``, at ``index_b + g // group``; ``tile_rows``
    folded rows a q tile (default: all ``s·group`` in one)."""
    idx = torch.as_tensor(index, dtype=torch.int64).reshape(-1)
    total = s * group
    tile_rows = total if tile_rows is None else tile_rows
    row0 = torch.arange(0, total, tile_rows, device=idx.device)
    row_last = (row0 + tile_rows).clamp(max=total) - 1
    first_pos = idx[:, None] + row0 // group                       # (B, tiles)
    last_col = (idx[:, None] + row_last // group).clamp(max=length - 1)
    first_col = ((first_pos - window + 1).clamp(min=0) if window
                 else torch.zeros_like(first_pos))
    first_kt = first_col // TILE_K
    n = torch.where(last_col >= first_col, last_col // TILE_K - first_kt + 1, 0)
    piece = torch.arange(splits, device=idx.device)
    kt0 = first_kt[..., None] + piece * n[..., None] // splits     # (B, tiles, splits)
    kt1 = first_kt[..., None] + (piece + 1) * n[..., None] // splits
    start = torch.maximum(first_col[..., None], kt0 * TILE_K)
    end = torch.where(kt1 > kt0, torch.minimum(last_col[..., None] + 1, kt1 * TILE_K), start)
    return torch.stack([start, end], dim=-1)


def decode_attention_split_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    index,
    *,
    splits: int,
    tile_rows: int | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    k_new: torch.Tensor | None = None,
    v_new: torch.Tensor | None = None,
    ks_new: torch.Tensor | None = None,
    vs_new: torch.Tensor | None = None,
    write_enable: torch.Tensor | None = None,
    block_table: torch.Tensor | None = None,
    window: int | None = None,
    scale: float | None = None,
):
    """The plain version of a split launch: the folded write as
    :func:`decode_attention_reference`, then per (q tile, piece) of
    :func:`split_ranges` a partial softmax over the piece's kept slots (m,
    l of the unscaled p, acc = p·v_scale·V; a piece a row attends nowhere
    gives l = 0), and per folded row the pieces merged in piece order over
    those with l > 0: m the largest of their m, out = Σ acc·e^(m_p - m) /
    Σ l·e^(m_p - m), l == 0 guarded to 1. Arguments as
    :func:`decode_attention_reference`."""
    b, s, n, h = q.shape
    scale = h**-0.5 if scale is None else scale
    _fold(b, k_cache, v_cache, index, k_new=k_new, v_new=v_new, ks_new=ks_new,
          vs_new=vs_new, k_scale=k_scale, v_scale=v_scale, write_enable=write_enable,
          block_table=block_table)
    kc, vc, ks, vs = _logical(k_cache, v_cache, k_scale, v_scale, block_table)
    n_kv, length = kc.shape[1], kc.shape[2]
    group = n // n_kv
    scores, kept = _scores(q, kc, ks, index, window, scale)           # (B, N, S, L)
    ranges = split_ranges(_row_index(index, b, q.device), s, group, window, length, splits,
                          tile_rows)                                  # (B, tiles, P, 2)
    rows = (torch.arange(s, device=q.device)[None, :] * group
            + torch.arange(n, device=q.device)[:, None] % group)      # (N, S) folded row
    tile = rows // (s * group if tile_rows is None else tile_rows)
    bounds = ranges[:, tile]                                          # (B, N, S, P, 2)
    cols = torch.arange(length, device=q.device)
    keep = (kept[:, :, :, None, :] & (cols >= bounds[..., :1])
            & (cols < bounds[..., 1:]))                               # (B, N, S, P, L)
    masked = torch.where(keep, scores[:, :, :, None, :], _NEG_INF)
    m = masked.amax(dim=-1)                                           # (B, N, S, P)
    p = torch.where(keep, torch.exp(masked - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if vs is not None:
        p = p * vs.repeat_interleave(group, dim=1)[:, :, None, None, :]
    v = vc.float().repeat_interleave(group, dim=1)
    acc = torch.einsum("bnspl,bnlh->bnsph", p, v)
    seen = l > 0
    m_max = torch.where(seen, m, -torch.inf).amax(dim=-1)
    m_max = torch.where(seen.any(dim=-1), m_max, 0.0)
    l_all = torch.zeros_like(m_max)
    acc_all = torch.zeros_like(acc[..., 0, :])
    for piece in range(splits):                                      # fixed order
        w = torch.where(seen[..., piece], torch.exp(m[..., piece] - m_max), 0.0)
        l_all = l_all + l[..., piece] * w
        acc_all = acc_all + acc[..., piece, :] * w[..., None]
    out = acc_all / torch.where(l_all == 0, 1.0, l_all)[..., None]
    out = out.permute(0, 2, 1, 3).to(q.dtype)                         # (B, S, N, H)
    return _with_caches(out, k_new, k_cache, v_cache, k_scale, v_scale)


def _design(dtype: torch.dtype, rows: int, head_dim: int) -> str:
    """The kernel's design for a launch of ``rows`` folded query rows
    (S·group) a (batch row, kv head): ``"tensor_core"`` (bf16 ``mma.sync``
    products into fp32, 64-row q tiles) for bf16 chunks of at least one
    16-row MMA tile -- the engine's refill, the prompt's prefill; otherwise
    ``"cuda_core"``: fp32, whose products tensor cores would take only as
    TF32, and the token step's few rows, which an MMA tile would mostly
    pad."""
    if dtype == torch.bfloat16 and rows >= TC_MIN_ROWS and head_dim in _HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def _splits(b: int, n_kv: int, tiles: int, length: int, design: str) -> int:
    """Pieces of the cache span a launch cuts: enough that the grid of
    ``b · n_kv · tiles`` blocks reaches ``SPLIT_TARGET_BLOCKS[design]``, at
    most one a ``TILE_K``-slot tile of the capacity ``length`` and at most
    ``MAX_SPLITS``. From the host's shapes alone: the valid prefix lives on
    the device, and a piece past it is empty and exits at once."""
    want = -(-SPLIT_TARGET_BLOCKS[design] // (b * n_kv * tiles))
    return max(1, min(MAX_SPLITS, -(-length // TILE_K), want))


def _plan(dtype, b, s, n, n_kv, h, length, block_q=_BLOCK_Q, design=None, splits=None):
    """The launch :func:`decode_attention` makes for a shape → ``(design,
    splits, tile_rows)``: the design :func:`_design` picks (or the one
    given), the q tile rows of the CUDA-core design (``block_q // group``
    whole queries, at most ``_MAX_TILE_ROWS``; the tensor-core design takes
    ``TC_ROWS``), and the split :func:`_splits` picks for that design's q
    tiles (or the one given)."""
    group = n // n_kv
    tile_rows = min(min(s, max(1, block_q // group)) * group, _MAX_TILE_ROWS)
    design = design or _design(dtype, s * group, h)
    tiles = -(-s * group // (TC_ROWS if design == "tensor_core" else tile_rows))
    return design, splits or _splits(b, n_kv, tiles, length, design), tile_rows


@functools.cache
def _kernel_entry():
    """The C entry point of ``csrc/decode_attention.cu``, typed for ctypes."""
    fn = load_library("decode_attention").decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_float] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def _launch_cuda(q, k_cache, v_cache, idx, k_new, v_new, write_enable,
                 window, scale, tile_rows, scales, block_table=None, *,
                 design="cuda_core", splits=1):
    """Check what the kernel takes, then launch it on the current stream.
    ``scales``: ``(k_scale, v_scale, ks_new, vs_new)`` of an int8 cache, or
    Nones. ``block_table``: the paged table (the caches are then pools).
    ``design`` and ``splits`` as :func:`_design` and :func:`_splits` give
    them; above one piece the partials go to a workspace made here."""
    b, s, n, h = q.shape
    n_kv = k_cache.shape[1]
    if block_table is None:
        t_cap, page, length = 0, 0, k_cache.shape[2]
    else:
        if block_table.dtype != torch.int32 or not block_table.is_contiguous():
            raise ValueError("block_table must be contiguous int32")
        if block_table.device != q.device:
            raise ValueError(f"block_table is on {block_table.device}, q on {q.device}")
        t_cap, page = block_table.shape[1], k_cache.shape[2]
        length = t_cap * page
    quantized = scales[0] is not None
    store = torch.int8 if quantized else q.dtype
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    if k_new is not None:
        tensors.update(k_new=k_new, v_new=v_new)
    named = dict(zip(("k_scale", "v_scale", "ks_new", "vs_new"), scales))
    tensors.update({k: t for k, t in named.items() if t is not None})
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        want = q.dtype if name == "q" else torch.float32 if name in named else store
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"decode_attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    if h not in _HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim 64 or 128, got {h}")
    if design == "tensor_core" and q.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core design takes bfloat16 q, got {q.dtype}")
    aligned = ("q", "k_cache", "v_cache") if design == "tensor_core" else ("k_cache", "v_cache")
    for name in aligned:
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = _kernel_entry()
    out = torch.empty_like(q)
    # Partials of each (piece, row, kv head, folded row): m and l, then acc.
    workspace = (torch.empty(splits * b * n * s * (h + 2), dtype=torch.float32,
                             device=q.device) if splits > 1 else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), idx.data_ptr(),
            ptr(k_new), ptr(v_new), ptr(write_enable), *map(ptr, scales),
            out.data_ptr(), ptr(block_table), ptr(workspace), _DTYPE_CODES[q.dtype],
            int(quantized), b, s, n, n_kv, length, h, 0 if window is None else window, scale,
            tile_rows, t_cap, page, _DESIGN_CODES[design], splits, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed ({design}, splits {splits}): error {err}"
        )
    decode_attention.launches += 1
    if block_table is not None:
        decode_attention.paged_launches += 1
    if design == "tensor_core":
        decode_attention.tensor_core_launches += 1
    if splits > 1:
        decode_attention.split_launches += 1
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    index,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    k_new: torch.Tensor | None = None,
    v_new: torch.Tensor | None = None,
    ks_new: torch.Tensor | None = None,
    vs_new: torch.Tensor | None = None,
    write_enable: torch.Tensor | None = None,
    block_table: torch.Tensor | None = None,
    window: int | None = None,
    scale: float | None = None,
    block_k: int | None = None,
    block_q: int = _BLOCK_Q,
    design: str | None = None,
    splits: int | None = None,
):
    """Attend chunk queries against the valid prefix of a KV cache.

    Args:
        q: ``(B, S, N, H)`` chunk queries; N may exceed the cache's heads (GQA).
        k_cache / v_cache: ``(B, N_kv, L, H)`` caches (paged: pools, see
            ``block_table``): float, or int8 with ``k_scale``/``v_scale``.
        index: int32 scalar, or ``(B,)`` for ragged batches: the absolute
            position of each row's first chunk query. Without the folded
            write the chunk's own k/v must already be at
            ``[index_b, index_b + S)``. Slots past a row's frontier are never
            read by the kernel.
        k_new / v_new: folded write (S = 1 only): ``(B, N_kv, 1, H)`` new-token
            k/v, written at slot ``index_b`` of each row before attention.
            The caches are updated IN PLACE and returned as the same tensors.
        write_enable: folded write only: ``(B,)``, 0 leaves that row's cache
            (and scales) bit-unchanged.
        k_scale / v_scale: ``(B, N_kv, L)`` fp32 per-(token, head) scales of
            int8 caches (both or neither).
        ks_new / vs_new: the int8 folded write's ``(B, N_kv, 1)`` scales of
            the new token.
        window: causal sliding window; query at ``p`` attends ``(p - window, p]``.
        block_k: the JAX kernel's cache block; validated as there (it must
            divide L). The CUDA kernel tiles the cache in its own 64-slot
            tiles, and the result does not depend on either.
        block_q: query rows per tile (``block_q // group`` whole queries).
        block_table: PAGED cache: ``(B, T)`` int32 mapping row ``b``'s
            logical block ``t`` (positions ``[t·page, (t+1)·page)``) to a
            page of the pools; the caches are then ``(P, N_kv, page, H)``
            pools (scales ``(P, N_kv, page)``), the logical capacity is
            ``T·page`` and ``block_k`` must equal the page size. The folded
            write lands at the row's mapped page and slot. Entries past a
            row's frontier are never read; they should name a scratch page
            (the engine's page 0) for the masked writes of chunk prefill.
        design / splits: the kernel's design (``"tensor_core"``, bf16 only,
            or ``"cuda_core"``) and the pieces of the cache span; None takes
            :func:`_design` and :func:`_splits`. Given only to hold one
            design or split against another; CPU tensors run the plain
            version whatever they say.

    Returns:
        ``(B, S, N, H)`` in ``q.dtype``, or ``(out, k_cache, v_cache)`` with
        the folded write (``(out, k_cache, v_cache, k_scale, v_scale)`` with
        int8 caches).
    """
    b, s, n, h = q.shape
    paged = block_table is not None
    if paged:
        _, n_kv, page, hk = k_cache.shape
        if block_table.ndim != 2 or block_table.shape[0] != b:
            raise ValueError(
                f"block_table {tuple(block_table.shape)} must be (B, T) = ({b}, *)"
            )
        if block_k is not None and block_k != page:
            raise ValueError(
                f"paged cache: block_k ({block_k}) must equal the page size ({page})"
            )
        block_k = page
        length = block_table.shape[1] * page               # logical per-row capacity
        bk = b
    else:
        bk, n_kv, length, hk = k_cache.shape
    if (bk, hk) != (b, h) or v_cache.shape != k_cache.shape:
        layout = "(P, N_kv, page, H)" if paged else "(B, N_kv, L, H)"
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not "
            f"match queries {tuple(q.shape)} (want {layout} with H = {h})"
        )
    if n % n_kv:
        raise ValueError(f"num_heads {n} not a multiple of kv heads {n_kv}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    quantized = k_scale is not None
    group = n // n_kv
    scale = h**-0.5 if scale is None else scale
    block_k = auto_block_k(length) if block_k is None else block_k
    if length % block_k:
        raise ValueError(f"cache length {length} not divisible by block_k {block_k}")
    fold = k_new is not None
    if fold:
        if v_new is None:
            raise ValueError("k_new and v_new must be given together")
        if s != 1:
            raise ValueError(f"folded cache write requires S = 1, got {s}")
        if tuple(k_new.shape) != (b, n_kv, 1, h) or v_new.shape != k_new.shape:
            raise ValueError(
                f"k_new/v_new must be (B, N_kv, 1, H) = {(b, n_kv, 1, h)}"
            )
        if quantized and (ks_new is None or vs_new is None):
            raise ValueError("int8 folded write needs ks_new and vs_new")
    elif write_enable is not None:
        raise ValueError("write_enable requires the folded write (k_new)")
    if quantized:
        for name, t, want in (("k_scale", k_scale, tuple(k_cache.shape[:3])),
                              ("v_scale", v_scale, tuple(k_cache.shape[:3])),
                              ("ks_new", ks_new if fold else None, (b, n_kv, 1)),
                              ("vs_new", vs_new if fold else None, (b, n_kv, 1))):
            if t is not None and tuple(t.shape) != want:
                raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    else:
        ks_new = vs_new = None
    scales = dict(k_scale=k_scale, v_scale=v_scale, ks_new=ks_new, vs_new=vs_new)
    if design is not None and design not in _DESIGN_CODES:
        raise ValueError(f"design must be one of {tuple(_DESIGN_CODES)}, got {design!r}")
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be in [1, {MAX_SPLITS}], got {splits}")

    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, index, k_new=k_new, v_new=v_new,
            write_enable=write_enable, block_table=block_table, window=window,
            scale=scale, **scales,
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"decode_attention runs on CUDA (the kernel) or the CPU (its plain "
            f"version), got a tensor on {q.device}"
        )
    idx = _row_index(index, b, q.device)
    enable = None if write_enable is None else _row_index(write_enable, b, q.device)
    design, splits, tile_rows = _plan(q.dtype, b, s, n, n_kv, h, length, block_q, design,
                                      splits)
    out = _launch_cuda(
        q, k_cache, v_cache, idx, k_new, v_new, enable, window, scale, tile_rows,
        (k_scale, v_scale, ks_new, vs_new), block_table, design=design, splits=splits,
    )
    if fold:
        return (out, k_cache, v_cache) + ((k_scale, v_scale) if quantized else ())
    return out


#: Kernel launches since the last reset; the wrapper adds one per call that
#: launches, and one to ``paged_launches`` too when the launch reads a block
#: table, to ``tensor_core_launches`` when it runs the tensor-core design, to
#: ``split_launches`` when it cuts the cache span into pieces (its merge is
#: part of the same call).
decode_attention.launches = 0
decode_attention.paged_launches = 0
decode_attention.tensor_core_launches = 0
decode_attention.split_launches = 0
