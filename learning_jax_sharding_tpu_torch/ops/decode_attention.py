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

Not ported yet (it comes with the continuous-engine slice): the paged block
table.
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
    window: int | None = None,
    scale: float | None = None,
):
    """The plain version of the kernel: dense masked fp32 attention over the
    whole cache, with the kernel's fold, ``write_enable``, ``-1e30`` mask and
    ``l == 0`` guard, and its int8 scaling (score columns by ``k_scale``,
    probabilities by ``v_scale`` after ``l``). The folded write updates the
    caches (and scales) IN PLACE. Takes validated arguments (see
    :func:`decode_attention`)."""
    b, s, n, h = q.shape
    n_kv, length = k_cache.shape[1], k_cache.shape[2]
    group = n // n_kv
    scale = h**-0.5 if scale is None else scale
    idx = _row_index(index, b, q.device)
    quantized = k_scale is not None
    if k_new is not None:
        slot = idx.long().clamp(0, length - 1)
        keep = (idx >= 0) & (idx < length)
        if write_enable is not None:
            keep = keep & (_row_index(write_enable, b, q.device) != 0)
        merges = [(k_cache, k_new), (v_cache, v_new)]
        if quantized:
            merges += [(k_scale, ks_new), (v_scale, vs_new)]
        for cache, new in merges:
            lead = (b,) + (1,) * (cache.ndim - 1)          # per row, at dim 2
            at = slot.view(lead).expand(*new.shape)
            merged = torch.where(keep.view(lead), new.to(cache.dtype), cache.gather(2, at))
            cache.scatter_(2, at, merged)
    k = k_cache.float().repeat_interleave(group, dim=1)       # (B, N, L, H)
    v = v_cache.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bsnh,bnlh->bnsl", q.float() * scale, k)
    if quantized:
        # Per-(token, head) scales are constant over H: they scale the
        # score columns after the contraction.
        scores = scores * k_scale.repeat_interleave(group, dim=1)[:, :, None, :]
    qpos = idx[:, None].long() + torch.arange(s, device=q.device)   # (B, S)
    cols = torch.arange(length, device=q.device)
    mask = cols[None, None, :] <= qpos[:, :, None]                   # (B, S, L)
    if window is not None:
        mask = mask & (cols[None, None, :] > qpos[:, :, None] - window)
    scores = torch.where(mask[:, None], scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    if quantized:
        # l sums the unscaled p; the v scales weight the probability columns.
        p = p * v_scale.repeat_interleave(group, dim=1)[:, :, None, :]
    out = torch.einsum("bnsl,bnlh->bsnh", p / torch.where(l == 0, 1.0, l), v)
    out = out.to(q.dtype)
    if k_new is not None:
        if quantized:
            return out, k_cache, v_cache, k_scale, v_scale
        return out, k_cache, v_cache
    return out


@functools.cache
def _kernel_entry():
    """The C entry point of ``csrc/decode_attention.cu``, typed for ctypes."""
    fn = load_library("decode_attention").decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _launch_cuda(q, k_cache, v_cache, idx, k_new, v_new, write_enable,
                 window, scale, tile_rows, scales):
    """Check what the kernel takes, then launch it on the current stream.
    ``scales``: ``(k_scale, v_scale, ks_new, vs_new)`` of an int8 cache, or
    Nones."""
    b, s, n, h = q.shape
    n_kv, length = k_cache.shape[1], k_cache.shape[2]
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
    for name in ("k_cache", "v_cache"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = _kernel_entry()
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), idx.data_ptr(),
            ptr(k_new), ptr(v_new), ptr(write_enable), *map(ptr, scales),
            out.data_ptr(), _DTYPE_CODES[q.dtype], int(quantized), b, s, n, n_kv, length,
            h, 0 if window is None else window, scale, tile_rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: error {err}")
    decode_attention.launches += 1
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
):
    """Attend chunk queries against the valid prefix of a KV cache.

    Args:
        q: ``(B, S, N, H)`` chunk queries; N may exceed the cache's heads (GQA).
        k_cache / v_cache: ``(B, N_kv, L, H)`` caches: float, or int8 with
            ``k_scale``/``v_scale``.
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
        block_table: the paged table, not ported yet
            (``NotImplementedError``).

    Returns:
        ``(B, S, N, H)`` in ``q.dtype``, or ``(out, k_cache, v_cache)`` with
        the folded write (``(out, k_cache, v_cache, k_scale, v_scale)`` with
        int8 caches).
    """
    b, s, n, h = q.shape
    if block_table is not None:
        raise NotImplementedError(
            "paged KV cache (block_table): ported with the continuous-engine slice"
        )
    bk, n_kv, length, hk = k_cache.shape
    if (bk, hk) != (b, h) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not "
            f"match queries {tuple(q.shape)} (want (B, N_kv, L, H) with H = {h})"
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
        for name, t, want in (("k_scale", k_scale, (b, n_kv, length)),
                              ("v_scale", v_scale, (b, n_kv, length)),
                              ("ks_new", ks_new if fold else None, (b, n_kv, 1)),
                              ("vs_new", vs_new if fold else None, (b, n_kv, 1))):
            if t is not None and tuple(t.shape) != want:
                raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    else:
        ks_new = vs_new = None
    scales = dict(k_scale=k_scale, v_scale=v_scale, ks_new=ks_new, vs_new=vs_new)

    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, index, k_new=k_new, v_new=v_new,
            write_enable=write_enable, window=window, scale=scale, **scales,
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"decode_attention runs on CUDA (the kernel) or the CPU (its plain "
            f"version), got a tensor on {q.device}"
        )
    idx = _row_index(index, b, q.device)
    enable = None if write_enable is None else _row_index(write_enable, b, q.device)
    qb = min(s, max(1, block_q // group))
    tile_rows = min(qb * group, _MAX_TILE_ROWS)
    out = _launch_cuda(
        q, k_cache, v_cache, idx, k_new, v_new, enable, window, scale, tile_rows,
        (k_scale, v_scale, ks_new, vs_new),
    )
    if fold:
        return (out, k_cache, v_cache) + ((k_scale, v_scale) if quantized else ())
    return out


#: Kernel launches since the last reset; the wrapper adds one per launch.
decode_attention.launches = 0
