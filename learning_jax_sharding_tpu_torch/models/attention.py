"""Multi-head attention with a KV cache for decoding.

Port of ``learning_jax_sharding_tpu/models/attention.py``. The module holds
the q/k/v/out projections; in decode mode it writes each chunk's k/v into a
per-layer :class:`KVCache` and attends the queries against it, through one
of two backends:

* ``"dense"``: attend the whole ``(B, L, N_kv, H)`` buffer with a mask;
* ``"blocked"``: the length-aware kernel (``ops/decode_attention.py``) over a
  ``(B, N_kv, L, H)`` buffer, reading only each row's valid prefix; ragged
  single-token steps fold the cache write into the kernel. With
  ``decode_paged`` the buffers are ``(P, N_kv, page, H)`` page pools
  (``decode_page_count`` pages of ``decode_block_k`` tokens) reached through
  a ``(B, T)`` block table that the continuous engine
  (``models/serving.py``) owns; page 0 is the scratch target of masked
  writes, and this module never changes the table.

Outside decode mode attention runs through the dense op with a mask, or
through a custom ``attn_fn`` backend (the flash kernels,
``ops/flash_attention.py::make_flash_attn_fn``). Dropout on the output
projection is a function of ``deterministic`` and an explicit generator, as
Flax's is of ``deterministic`` and a ``"dropout"`` key; the module's
train/eval mode plays no part.

Under ``quantization="int4"`` / ``"int4_w4a8"`` the projections consume an
int4 state dict (``models/quantize.py::quantize_tree``) through the fused
kernels; int4 MHA without biases runs q/k/v through one ``int4_matmul3``
launch, as the JAX module routes it.

``remat_attention=True`` recomputes the dense attention core in the backward
(``torch.utils.checkpoint``, nothing saved); a custom ``attn_fn`` (the flash
kernels, which save only their output and log-sum-exp) is left as it is.

``kv_cache_dtype=torch.int8`` stores the caches as int8 with a fp32 scale
per (token, kv head), both backends writing through the one
:func:`quantize_kv_chunk`: the dense backend dequantizes the whole buffer
on read, the blocked one hands the scales to the kernel, which dequantizes
only the valid prefix it reads.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from learning_jax_sharding_tpu_torch.models.convert import KERNEL_AXES
from learning_jax_sharding_tpu_torch.models.quantize import Int4Linear, projection_dense
from learning_jax_sharding_tpu_torch.ops.attention import (
    causal_mask,
    dot_product_attention,
    sliding_window_mask,
)
from learning_jax_sharding_tpu_torch.ops.decode_attention import (
    check_paged_batch,
    decode_attention,
)
from learning_jax_sharding_tpu_torch.ops.int4_matmul import int4_matmul3
from learning_jax_sharding_tpu_torch.ops.rope import apply_rope
from learning_jax_sharding_tpu_torch.parallel.logical import (
    BATCH,
    EMBED,
    HEADS,
    KV,
    SEQ,
    active_mesh,
    constrain,
    local_call,
    logical_placements,
    on_whole_shards,
    whole_call,
)
from learning_jax_sharding_tpu_torch.parallel.sharding import local_rows


def _local(t):
    """A DTensor's local shard (the same storage: in-place writes land in
    it); anything else as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _local_shape(shape, mesh, placements) -> tuple:
    shape = list(shape)
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            if shape[pl.dim] % mesh.size(mdim):
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not split "
                                 f"{mesh.size(mdim)} ways")
            shape[pl.dim] //= mesh.size(mdim)
    return tuple(shape)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for size in reversed(shape):
        stride.append(acc)
        acc *= size
    return tuple(reversed(stride))


def resolve_decode_backend(mode: str, device: torch.device) -> str:
    """``"auto"`` → the blocked kernel on a GPU, the dense path elsewhere.
    Explicit ``"dense"`` / ``"blocked"`` force a backend."""
    if mode == "auto":
        return "blocked" if device.type == "cuda" else "dense"
    if mode not in ("dense", "blocked"):
        raise ValueError(
            f"unknown decode_attention {mode!r}: expected 'auto', 'dense', "
            f"or 'blocked'"
        )
    return mode


def repeat_kv(kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Broadcast grouped k/v heads ``(B, S, N_kv, H)`` to ``num_heads``: kv
    head ``j`` serves query heads ``j·group … (j+1)·group - 1``."""
    n_kv = kv.shape[2]
    if n_kv == num_heads:
        return kv
    if num_heads % n_kv:
        raise ValueError(f"num_heads {num_heads} not a multiple of kv heads {n_kv}")
    return kv.repeat_interleave(num_heads // n_kv, dim=2)


def _seq_index(pos: torch.Tensor, like: torch.Tensor, seq_dim: int) -> torch.Tensor:
    """``(B, S)`` positions → an index shaped like ``like`` for
    ``gather``/``scatter_`` along ``seq_dim`` (1 or 2)."""
    shape = [pos.shape[0], 1, 1, 1][: like.ndim]
    shape[seq_dim] = pos.shape[1]
    return pos.reshape(shape).expand(like.shape)


def quantize_kv_chunk(chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of a K/V chunk along its last (head-dim)
    axis → ``(scale, q)``: per-(token, head) fp32 scales ``absmax / 127`` (1
    where the absmax is 0) and the values divided by them, rounded half to
    even and clipped to ±127 (fp32; the caller casts to int8). The one
    definition both cache backends write with, byte-equal to the eager JAX
    function."""
    c = chunk.float()
    absmax = c.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(c / scale[..., None]), -127, 127)
    return scale, q


def row_update(
    buf: torch.Tensor, chunk: torch.Tensor, idx: torch.Tensor, *, seq_dim: int
) -> torch.Tensor:
    """Write ``chunk`` into ``buf`` IN PLACE at a per-row offset along
    ``seq_dim``: row ``b``'s chunk lands at ``idx[b]``, the start clamped
    into the buffer as ``dynamic_update_slice`` clamps it."""
    s, cap = chunk.shape[seq_dim], buf.shape[seq_dim]
    start = idx.long().clamp(0, cap - s)
    pos = start[:, None] + torch.arange(s, device=buf.device)
    return buf.scatter_(seq_dim, _seq_index(pos, chunk, seq_dim), chunk)


def row_update_masked(
    buf: torch.Tensor, chunk: torch.Tensor, idx: torch.Tensor,
    lengths: torch.Tensor, *, seq_dim: int,
) -> torch.Tensor:
    """Length-aware :func:`row_update`, IN PLACE: row ``b`` writes only its
    first ``lengths[b]`` chunk positions at ``idx[b]``; the rest of the
    window writes back the buffer's own values, so a zero-length row (or a
    window clamped at the buffer's end) never disturbs existing cache."""
    s, cap = chunk.shape[seq_dim], buf.shape[seq_dim]
    idx = idx.long()
    start = idx.clamp(max=cap - s)
    off = idx - start                                      # 0 unless clamped
    j = torch.arange(s, device=buf.device)
    pos = start[:, None] + j                               # window, (B, S)
    keep = (j >= off[:, None]) & (j < off[:, None] + lengths.long()[:, None])
    src = (j - off[:, None]).clamp(0, s - 1)               # the roll by off
    rolled = chunk.gather(seq_dim, _seq_index(src, chunk, seq_dim))
    index = _seq_index(pos, chunk, seq_dim)
    keep = _seq_index(keep, chunk, seq_dim)
    merged = torch.where(keep, rolled, buf.gather(seq_dim, index))
    return buf.scatter_(seq_dim, index, merged)


def paged_write(pool: torch.Tensor, chunk: torch.Tensor, idx: torch.Tensor,
                block_table: torch.Tensor, chunk_lengths: torch.Tensor | None) -> torch.Tensor:
    """Write a sequence-major chunk ``(B, N_kv, S, ...)`` into a page pool
    ``(P, N_kv, page, ...)`` IN PLACE through the block table: position
    ``idx_b + t`` lives at ``(block_table[b, pos // page], :, pos % page)``.
    Positions past a row's ``chunk_lengths`` (or, without them, past the
    logical capacity) go to the scratch page 0, so masked writes never touch
    live pages; the JAX module's ``paged_write``."""
    page, s = pool.shape[2], chunk.shape[2]
    t_cap = block_table.shape[1]
    steps = torch.arange(s, device=pool.device)
    pos = idx.long()[:, None] + steps                             # (B, S)
    pages = block_table.long().gather(1, (pos // page).clamp(max=t_cap - 1))
    if chunk_lengths is not None:
        valid = steps[None, :] < chunk_lengths.long()[:, None]
    else:
        valid = pos < t_cap * page
    pages = torch.where(valid, pages, 0)
    pool[pages, :, pos % page] = chunk.movedim(2, 1).to(pool.dtype)
    return pool


@dataclasses.dataclass
class KVCache:
    """One layer's decode cache: preallocated buffers, updated IN PLACE by
    every decode call (the JAX module threads a functional cache instead).

    ``key``/``value`` are ``(B, L, N_kv, H)`` for the dense backend and
    ``(B, N_kv, L, H)`` for the blocked one; paged, ``(P, N_kv, page, H)``
    pools with the ``(B, T)`` int32 ``block_table``. ``index`` is the int32
    write position on the device: a scalar, or ``(B,)`` when ragged. int8
    caches carry fp32 ``key_scale``/``value_scale`` (ones at first), ``(B,
    L, N_kv)`` dense, ``(B, N_kv, L)`` blocked and ``(P, N_kv, page)``
    paged; float caches carry none."""

    key: torch.Tensor
    value: torch.Tensor
    index: torch.Tensor
    key_scale: torch.Tensor | None = None
    value_scale: torch.Tensor | None = None
    block_table: torch.Tensor | None = None

    @classmethod
    def create(cls, shape, dtype, *, ragged: bool, device, batch: int | None = None,
               block_table: torch.Tensor | None = None) -> "KVCache":
        """Zeroed buffers of ``shape``; ``batch`` rows of index (default
        ``shape[0]``; a page pool's leading axis counts pages)."""
        batch = shape[0] if batch is None else batch
        scales = {}
        if dtype == torch.int8:
            sc_shape = shape[:-1]
            scales = dict(
                key_scale=torch.ones(sc_shape, dtype=torch.float32, device=device),
                value_scale=torch.ones(sc_shape, dtype=torch.float32, device=device),
            )
        return cls(
            key=torch.zeros(shape, dtype=dtype, device=device),
            value=torch.zeros(shape, dtype=dtype, device=device),
            index=torch.zeros(
                (batch,) if ragged else (), dtype=torch.int32, device=device
            ),
            block_table=block_table,
            **scales,
        )


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """Flax's ``lecun_normal``: truncated normal (±2σ) with variance
    1/fan_in, σ corrected for the truncation."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(
        weight, 0.0, std, -2 * std, 2 * std, generator=generator
    )


def make_linear(in_features, out_features, *, bias, dtype, device, generator=None,
                init=lecun_normal_):
    """``nn.Linear`` with Flax Dense's init (lecun-normal kernel by default,
    zero bias); ``init(weight, generator)`` draws the kernel."""
    layer = nn.Linear(in_features, out_features, bias=bias, dtype=dtype, device=device)
    with torch.no_grad():
        init(layer.weight, generator)
        if bias:
            layer.bias.zero_()
    return layer


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    (a Bernoulli draw from ``generator``) and scale the kept ones by
    ``1 / (1 - rate)``. The masks cannot match JAX's bits (Philox against
    threefry); the same generator state gives the same mask."""
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    probs = torch.full(x.shape, keep_prob, dtype=torch.float32, device=x.device)
    mask = torch.bernoulli(probs, generator=generator).bool()
    return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _one_split_row_dim(x):
    """A DTensor whose leading (row) dims are split over two mesh dims (the
    batch over data and the sequence over model: sequence parallelism),
    with the later split gathered: the product flattens its rows, which
    DTensor cannot do across two splits (GSPMD gathers the sequence for a
    column-parallel weight the same way). Anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    rows = [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim < x.ndim - 1]
    if len({x.placements[i].dim for i in rows}) < 2:
        return x
    first = min(x.placements[i].dim for i in rows)
    keep = [p if not (isinstance(p, Shard) and first < p.dim < x.ndim - 1) else Replicate()
            for p in x.placements]
    return x.redistribute(x.device_mesh, keep)


def linear(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax Dense semantics: input and params cast to the compute dtype. An
    :class:`Int4Linear` (built with this ``dtype``) runs its own product."""
    x = _one_split_row_dim(x)
    if isinstance(layer, Int4Linear):
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype), bias)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention, with GQA, RoPE, a sliding window, and a KV
    cache in decode mode. Field names follow the JAX module."""

    def __init__(
        self,
        features: int,
        num_heads: int = 8,
        head_dim: int = 64,
        *,
        num_kv_heads: int | None = None,
        rope: bool = False,
        rope_theta: float = 10_000.0,
        window: int | None = None,
        dropout_rate: float = 0.0,
        causal: bool = False,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        attn_fn=None,
        decode: bool = False,
        max_decode_len: int = 0,
        kv_cache_dtype: torch.dtype | None = None,
        decode_attention: str = "auto",
        decode_block_k: int | None = None,
        decode_ragged: bool = False,
        decode_paged: bool = False,
        decode_page_count: int = 0,
        quantization: str | None = None,
        quantization_group: int = 128,
        quantized_matmul_fn=None,
        remat_attention: bool = False,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        n_kv = num_heads if num_kv_heads is None else num_kv_heads
        if num_heads % n_kv:
            raise ValueError(f"num_kv_heads {n_kv} must divide num_heads {num_heads}")
        self.features, self.num_heads, self.head_dim = features, num_heads, head_dim
        self.kv_heads = n_kv
        self.rope, self.rope_theta, self.window = rope, rope_theta, window
        self.causal, self.dtype = causal, dtype
        self.attn_fn, self.dropout_rate = attn_fn, dropout_rate
        self.decode, self.max_decode_len = decode, max_decode_len
        self.kv_cache_dtype = kv_cache_dtype
        self.decode_attention = decode_attention
        self.decode_block_k = decode_block_k
        self.decode_ragged = decode_ragged
        self.decode_paged, self.decode_page_count = decode_paged, decode_page_count
        self.quantization, self.quantization_group = quantization, quantization_group
        self.use_bias = use_bias
        self.remat_attention = remat_attention
        kw = dict(quantization=quantization, use_bias=use_bias, dtype=dtype,
                  param_dtype=param_dtype, group_size=quantization_group, device=device,
                  generator=generator, matmul_fn=quantized_matmul_fn)
        self.query = projection_dense(in_features=features, features=num_heads * head_dim,
                                      kernel_axes=KERNEL_AXES["query"], **kw)
        self.key = projection_dense(in_features=features, features=n_kv * head_dim,
                                    kernel_axes=KERNEL_AXES["key"], **kw)
        self.value = projection_dense(in_features=features, features=n_kv * head_dim,
                                      kernel_axes=KERNEL_AXES["value"], **kw)
        self.out = projection_dense(in_features=num_heads * head_dim, features=features,
                                    kernel_axes=KERNEL_AXES["out"], **kw)

    def _fused_qkv(self, m: int) -> bool:
        """Route q/k/v through one ``int4_matmul3`` launch: int4 serving
        (not w4a8) not split over a mesh (one whose axes are all of size 1
        keeps it), MHA (equal projection widths), no biases, and a group
        layout the kernel can tile; the JAX module's rule."""
        if (
            self.quantization != "int4"
            or not on_whole_shards()
            or self.use_bias
            or self.kv_heads != self.num_heads
            or m % 2
        ):
            return False
        g = min(self.quantization_group, m)
        return g == m or (m // 2) % g == 0

    def init_cache(self, batch: int, device, block_table: torch.Tensor | None = None) -> KVCache:
        """Zeroed cache for ``batch`` rows in this module's backend layout.
        Paged: ``decode_page_count`` pages and a zeroed ``(batch,
        max_decode_len // page)`` table, or the ``block_table`` given (the
        model hands every layer the one table)."""
        if self.max_decode_len <= 0:
            raise ValueError("decode=True requires max_decode_len > 0")
        store = self.kv_cache_dtype if self.kv_cache_dtype is not None else self.dtype
        n_kv, h, length = self.kv_heads, self.head_dim, self.max_decode_len
        blocked = resolve_decode_backend(self.decode_attention, device) == "blocked"
        mesh, rules = active_mesh()
        if self.decode_paged:
            page = self._check_paged(blocked)
            if block_table is None:
                block_table = torch.zeros(
                    (batch, length // page), dtype=torch.int32, device=device
                )
            shape, axes = (self.decode_page_count, n_kv, page, h), (None, HEADS, None, KV)
        elif blocked:
            shape, axes = (batch, n_kv, length, h), (BATCH, HEADS, None, KV)
        else:
            shape, axes = (batch, length, n_kv, h), (BATCH, None, HEADS, KV)
        ragged = self.decode_ragged
        if mesh is None:
            return KVCache.create(shape, store, ragged=ragged, device=device, batch=batch,
                                  block_table=block_table)
        # Over a mesh each rank holds its shard of the buffers, as the JAX
        # module constrains them (``kv_axes``; page pools over heads only).
        # The per-row index and the block table stay whole on every rank.
        placements = logical_placements(mesh, rules, axes)
        local = KVCache.create(_local_shape(shape, mesh, placements), store, ragged=ragged,
                               device=device, batch=batch, block_table=block_table)
        wrap = lambda t, pl: DTensor.from_local(  # noqa: E731
            t, mesh, pl, run_check=False,
            shape=torch.Size(shape[:t.ndim]), stride=_contiguous_stride(shape[:t.ndim]))
        scales = {}
        if local.key_scale is not None:
            sc_pl = logical_placements(mesh, rules, axes[:-1])
            scales = dict(key_scale=wrap(local.key_scale, sc_pl),
                          value_scale=wrap(local.value_scale, sc_pl))
        return dataclasses.replace(local, key=wrap(local.key, placements),
                                   value=wrap(local.value, placements), **scales)

    def _check_paged(self, blocked: bool) -> int:
        """The paged mode's preconditions (the JAX module's errors) → the
        page size."""
        if not blocked:
            raise ValueError(
                "decode_paged requires the blocked decode backend (the "
                "dense path attends per-row buffers, not page pools)"
            )
        if not self.decode_ragged:
            raise ValueError("decode_paged requires decode_ragged")
        page = self.decode_block_k
        if not page or self.max_decode_len % page:
            raise ValueError(
                f"decode_paged needs decode_block_k (page size) dividing "
                f"max_decode_len ({self.max_decode_len}); got {page}"
            )
        return page

    def forward(
        self,
        x: torch.Tensor,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
        cache: KVCache | None = None,
        chunk_lengths: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``deterministic=False`` applies dropout (``dropout_rate > 0``),
        drawn from ``generator``. ``cache``: decode mode only, updated in
        place. ``chunk_lengths``: ragged decode only: per-row count of valid
        tokens in this chunk (prefill passes the prompt lengths, a frozen
        row 0)."""
        b, s, m = x.shape
        if chunk_lengths is not None and not self.decode_ragged:
            raise ValueError("chunk_lengths requires decode_ragged=True")
        if self.decode != (cache is not None):
            raise ValueError("decode mode takes a KVCache, and only decode mode does")
        x = constrain(x, BATCH, SEQ, EMBED)
        if self._fused_qkv(m):
            g = min(self.quantization_group, m)
            weights = [t for p in (self.query, self.key, self.value) for t in (p.q4, p.scale)]
            q, k, v = whole_call(
                lambda x_, *w: int4_matmul3(x_, list(zip(w[::2], w[1::2])), group=g),
                (x.to(self.dtype), *weights), ((BATCH, SEQ, HEADS),) * 3)
        else:
            q, k, v = (linear(p, x, self.dtype) for p in (self.query, self.key, self.value))
        q, k, v = (constrain(t, BATCH, SEQ, HEADS) for t in (q, k, v))
        q = q.reshape(b, s, self.num_heads, self.head_dim)
        k = k.reshape(b, s, self.kv_heads, self.head_dim)
        v = v.reshape(b, s, self.kv_heads, self.head_dim)
        q, k, v = (constrain(t, BATCH, SEQ, HEADS, KV) for t in (q, k, v))

        if self.rope:
            # Rotate before caching: cached keys carry their absolute positions.
            steps = torch.arange(s, device=x.device)
            if cache is None:
                positions = steps
            elif self.decode_ragged:
                positions = cache.index[:, None] + steps
            else:
                positions = cache.index + steps
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)

        if cache is not None:
            out = self._cached_attention(q, k, v, cache, chunk_lengths)
        elif self.attn_fn is None:
            if self.window is not None:
                if not self.causal:
                    raise ValueError("window (sliding-window attention) requires causal=True")
                mask = sliding_window_mask(s, self.window, device=x.device)
            else:
                mask = causal_mask(s, device=x.device) if self.causal else None
            dense = functools.partial(self._dense_attention, mask=mask)
            if self.remat_attention and torch.is_grad_enabled():
                # Only the O(S²) core is recomputed, and nothing in it saved
                # (JAX's nothing_saveable policy).
                out = checkpoint(dense, q, k, v, use_reentrant=False)
            else:
                out = dense(q, k, v)
        else:
            if self.window is not None:
                raise ValueError(
                    "window with a custom attn_fn: configure the backend "
                    "instead (e.g. make_flash_attn_fn(window=...))"
                )
            # A backend takes the structural causal flag, never a mask; one
            # that reads grouped k/v at N_kv heads (the flash kernels) gets
            # them unrepeated.
            if not getattr(self.attn_fn, "supports_gqa", False):
                k, v = repeat_kv(k, self.num_heads), repeat_kv(v, self.num_heads)
            out = self.attn_fn(q, k, v, causal=self.causal)
        out = constrain(out, BATCH, SEQ, HEADS, KV)
        out = linear(self.out, out.reshape(b, s, -1), self.dtype)
        out = constrain(out, BATCH, SEQ, EMBED)
        if self.dropout_rate > 0.0 and not deterministic:
            out = dropout(out, self.dropout_rate, generator)
        return out

    def _dense_attention(self, q, k, v, *, mask):
        """The dense attention core (k/v repeated to every query head): on
        each shard's batch rows and heads over a mesh."""
        k, v = repeat_kv(k, self.num_heads), repeat_kv(v, self.num_heads)
        if active_mesh()[0] is None:
            return dot_product_attention(q, k, v, mask=mask)
        spec = (BATCH, None, HEADS, None)
        return local_call(lambda q_, k_, v_: dot_product_attention(q_, k_, v_, mask=mask),
                          (q, k, v), (spec,) * 3, spec)

    @staticmethod
    def _advance(cache: KVCache, s: int, chunk_lengths) -> torch.Tensor:
        """The write position of this chunk; the cache index then advances
        by the chunk's valid length (``s``, or per-row ``chunk_lengths``)."""
        idx = cache.index.clone()
        cache.index += s if chunk_lengths is None else chunk_lengths.to(torch.int32)
        return idx

    @staticmethod
    def _store(chunk: torch.Tensor, store: torch.dtype):
        """A chunk as the cache stores it → ``(values, scales or None)``:
        int8 through :func:`quantize_kv_chunk`, otherwise a cast."""
        if store != torch.int8:
            return chunk.to(store), None
        sc, q = quantize_kv_chunk(chunk)
        return q.to(torch.int8), sc

    def _write(self, buf, chunk, idx, chunk_lengths, *, seq_dim: int) -> None:
        """Write a chunk into a cache buffer in place at the write position:
        one scalar offset, or per row (length-aware when ``chunk_lengths``
        rides the call, so frozen rows leave their cache untouched)."""
        if not self.decode_ragged:
            pos = idx.long() + torch.arange(chunk.shape[seq_dim], device=buf.device)
            buf.index_copy_(seq_dim, pos, chunk)
        elif chunk_lengths is not None:
            row_update_masked(buf, chunk, idx, chunk_lengths, seq_dim=seq_dim)
        else:
            row_update(buf, chunk, idx, seq_dim=seq_dim)

    def _cached_attention(self, q, k, v, cache: KVCache, chunk_lengths):
        if self.attn_fn is not None:
            raise ValueError(
                "decode mode uses the cached paths (dense or blocked); "
                "attn_fn backends (flash/ring) are for training-length "
                "sequences"
            )
        blocked = resolve_decode_backend(self.decode_attention, q.device) == "blocked"
        if self.decode_paged:
            self._check_paged(blocked)
        mesh, rules = active_mesh()
        if mesh is not None:
            return self._sharded_cached_attention(q, k, v, cache, chunk_lengths, blocked,
                                                  mesh, rules)
        if blocked:
            return self._blocked_cached_attention(q, k, v, cache, chunk_lengths)
        return self._dense_cached_attention(q, k, v, cache, chunk_lengths)

    def _dense_cached_attention(self, q, k, v, cache: KVCache, chunk_lengths, idx=None):
        """Write the chunk into the ``(B, L, N_kv, H)`` buffers, then attend
        the whole buffer under a mask. ``idx``: the write position, where the
        caller has advanced the index itself (a mesh shard's rows)."""
        _, s, n, _ = q.shape
        length = cache.key.shape[1]
        idx = self._advance(cache, s, chunk_lengths) if idx is None else idx
        for buf, sc_buf, chunk in ((cache.key, cache.key_scale, k),
                                   (cache.value, cache.value_scale, v)):
            chunk, sc = self._store(chunk, buf.dtype)
            if sc is not None:
                self._write(sc_buf, sc, idx, chunk_lengths, seq_dim=1)
            self._write(buf, chunk, idx, chunk_lengths, seq_dim=1)

        def read(buf, sc_buf):
            full = buf if sc_buf is None else buf.float() * sc_buf[..., None]
            return repeat_kv(full.to(self.dtype), n)

        k_full = read(cache.key, cache.key_scale)
        v_full = read(cache.value, cache.value_scale)
        # Query i sits at absolute position idx + i: attend every slot at or
        # before it (which also hides the zeroed tail).
        steps = torch.arange(s, device=q.device)
        k_pos = torch.arange(length, device=q.device)
        if self.decode_ragged:
            q_pos = idx[:, None, None] + steps[None, :, None]       # (B, S, 1)
            mask = k_pos[None, None, :] <= q_pos
        else:
            q_pos = idx + steps[:, None]                             # (S, 1)
            mask = k_pos[None, :] <= q_pos
        if self.window is not None:
            mask = mask & (k_pos > q_pos - self.window)
        mask = mask[:, None] if self.decode_ragged else mask[None, None]
        return dot_product_attention(q, k_full, v_full, mask=mask)

    def _sharded_cached_attention(self, q, k, v, cache: KVCache, chunk_lengths, blocked,
                                  mesh, rules):
        """Cached attention over a mesh: each rank writes its (batch, heads)
        shard of the chunk into its shard of the cache and attends it, the
        kernel (blocked) or the masked product (dense) on the local shards
        (``ops.decode_attention.make_decode_attn_fn`` is the same per-shard
        call for a caller holding DTensors)."""
        if self.decode_paged:
            check_paged_batch(mesh, rules)
        spec = (BATCH, None, HEADS, KV)
        placements = logical_placements(mesh, rules, spec)
        q, k, v = (constrain(t, *spec) for t in (q, k, v))
        local = dataclasses.replace(
            cache, **{f: _local(getattr(cache, f))
                      for f in ("key", "value", "key_scale", "value_scale")})
        idx = None
        if self.decode_ragged:
            # The per-row counters, the chunk lengths and the block table
            # stay whole on every rank (the host resets and rolls them back
            # alike on each): advance the whole index here, and hand the
            # shard's attention its batch rows of each.
            rows = functools.partial(local_rows, mesh=mesh, placements=placements)
            idx = rows(self._advance(cache, q.shape[1], chunk_lengths))
            local = dataclasses.replace(
                local, block_table=None if cache.block_table is None else rows(cache.block_table))
            chunk_lengths = None if chunk_lengths is None else rows(chunk_lengths)
        attend = self._blocked_cached_attention if blocked else self._dense_cached_attention
        out = attend(q.to_local(), k.to_local(), v.to_local(), local, chunk_lengths, idx=idx)
        return DTensor.from_local(out.contiguous(), mesh, placements, run_check=False,
                                  shape=q.shape, stride=_contiguous_stride(q.shape))

    def _blocked_cached_attention(self, q, k, v, cache: KVCache, chunk_lengths, idx=None):
        """The length-aware kernel over the ``(B, N_kv, L, H)`` cache (or the
        page pools through the block table). Ragged single-token steps fold
        the write into the kernel; other chunks are written first. ``idx`` as
        in ``_dense_cached_attention``."""
        s = q.shape[1]
        idx = self._advance(cache, s, chunk_lengths) if idx is None else idx

        def seq_major(chunk):                       # (B, N_kv, S, H), (B, N_kv, S)
            chunk, sc = self._store(chunk, cache.key.dtype)
            sc = None if sc is None else sc.transpose(1, 2).contiguous()
            return chunk.transpose(1, 2).contiguous(), sc

        (k_sm, ks_sm), (v_sm, vs_sm) = seq_major(k), seq_major(v)
        kwargs = dict(window=self.window, block_k=self.decode_block_k,
                      k_scale=cache.key_scale, v_scale=cache.value_scale,
                      block_table=cache.block_table)
        if self.decode_ragged and s == 1:
            out = decode_attention(
                q, cache.key, cache.value, idx, k_new=k_sm, v_new=v_sm, ks_new=ks_sm,
                vs_new=vs_sm, write_enable=chunk_lengths, **kwargs,
            )
            return out[0]
        for buf, sc_buf, chunk, sc in ((cache.key, cache.key_scale, k_sm, ks_sm),
                                       (cache.value, cache.value_scale, v_sm, vs_sm)):
            for target, values in ((sc_buf, sc), (buf, chunk)):
                if values is None:
                    continue
                if cache.block_table is not None:
                    paged_write(target, values, idx, cache.block_table, chunk_lengths)
                else:
                    self._write(target, values, idx, chunk_lengths, seq_dim=2)
        return decode_attention(q, cache.key, cache.value, idx, **kwargs)
