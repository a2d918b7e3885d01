"""Flash attention: the CUDA kernels' wrappers, their plain PyTorch versions,
and the autograd function that ties forward and backward together.

Port of ``learning_jax_sharding_tpu/ops/flash_attention.py``. Scores are
computed tile by tile with an online softmax, so device memory holds O(S·H)
per head instead of the (S, S) score matrix. The forward saves only the
per-row logsumexp; the backward recomputes the probabilities in two sweeps
that write disjoint outputs: dK/dV over a k-major sweep (summing the GQA
group for free, since the group's heads are rows of the same sweep) and dQ
over a q-major one.

Layout: ``(B, S, N, H)`` at the public function. Inside, each (batch, kv
head) is one slab of ``(B·N_kv, S·group, H)`` rows for q and ``(B·N_kv, S,
H)`` for k/v: under GQA the group's query heads fold into the rows (row
``r`` is position ``r // group``), so k/v are never repeated.

For CUDA tensors the three kernels of ``csrc/flash_attention.cu`` run
(built at first use, see ``_build``), each on tensor cores in bf16 and on
CUDA cores in fp32 (``_fwd_design``, ``_bwd_design``); for CPU tensors the
plain versions :func:`flash_attention_fwd_reference` and
:func:`flash_attention_bwd_reference` run, which the tests hold against
the JAX kernels. Nothing falls back from one to the other, nor from one
design to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library

_NEG_INF = -1e30  # large-negative instead of -inf: keeps exp/max NaN-free
_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _auto_block(s: int, cap: int = 1024) -> int:
    """Largest power of two ≤ ``cap`` that divides ``s``; one full-length
    block when ``s`` has no power-of-two factor ≥ 8, and an error when such
    an ``s`` is longer than ``cap``. The JAX kernel's tile choice: here it
    only decides which sequence lengths are accepted."""
    blk = 1
    while blk < cap and s % (blk * 2) == 0:
        blk *= 2
    if blk < 8:
        if s > cap:
            raise ValueError(
                f"sequence length {s} has no usable power-of-two block "
                f"factor; pad the sequence or pass block_q/block_k explicitly"
            )
        blk = s
    return blk


def _keep_mask(rows_q, s_kv, group, causal, window, device) -> torch.Tensor:
    """``(rows_q, s_kv)`` True where row ``r`` (position ``r // group``) may
    attend key ``c``: causal keeps ``c ≤ pos``, a window ``c > pos - window``."""
    pos = torch.arange(rows_q, device=device)[:, None] // group
    cols = torch.arange(s_kv, device=device)[None, :]
    keep = torch.ones(rows_q, s_kv, dtype=torch.bool, device=device)
    if causal:
        keep = keep & (cols <= pos)
    if window is not None:
        keep = keep & (cols > pos - window)
    return keep


def _scores(q, k, scale, keep):
    """fp32 ``q·kᵀ·scale`` on the folded layout, masked with ``-1e30``."""
    s = torch.einsum("brh,bch->brc", q.float(), k.float()) * scale
    return torch.where(keep, s, _NEG_INF)


def flash_attention_fwd_reference(q, k, v, *, scale, causal=False, window=None, group=1):
    """The forward kernel's plain version on the folded layout: ``q`` is
    ``(B·N_kv, S·group, H)``, ``k``/``v`` are ``(B·N_kv, S_kv, H)``. Dense
    fp32 scores with the kernel's arithmetic: ``-1e30`` masking, masked
    probabilities exactly 0, ``p`` rounded to the input dtype before
    ``p·V``, and the ``l == 0`` guard.

    Returns ``(out, lse)``: ``out`` in ``q.dtype``, ``lse`` fp32 ``(B·N_kv,
    S·group, 1)``."""
    keep = _keep_mask(q.shape[1], k.shape[1], group, causal, window, q.device)
    s = _scores(q, k, scale, keep)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, 1.0, l)
    acc = torch.einsum("brc,bch->brh", p.to(v.dtype).float(), v.float())
    return (acc / safe_l).to(q.dtype), m + torch.log(safe_l)


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``Σ_h dO·O`` per row, fp32 ``(B·N_kv, rows, 1)``: the backward's
    softmax-Jacobian term, computed outside the kernels (as in JAX)."""
    return (do.float() * out.float()).sum(dim=-1, keepdim=True)


def flash_attention_bwd_reference(
    q, k, v, out, lse, do, *, scale, causal=False, window=None, group=1
):
    """The two backward kernels' plain version on the folded layout.

    Recomputes ``p = exp(s - lse)`` (masked entries exactly 0), then
    ``dv = pᵀ·dO`` with ``p`` rounded to the input dtype, ``dp = dO·Vᵀ``,
    ``ds = p∘(dp − delta)`` with ``delta = Σ dO·O`` in fp32, and ``dk =
    dsᵀ·Q·scale``, ``dq = ds·K·scale`` with ``ds`` rounded to the input
    dtype. Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    keep = _keep_mask(q.shape[1], k.shape[1], group, causal, window, q.device)
    p = torch.where(keep, torch.exp(_scores(q, k, scale, keep) - lse), 0.0)
    dv = torch.einsum("brc,brh->bch", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("brh,bch->brc", do.float(), v.float())
    ds = p * (dp - _delta(out, do))
    dk = torch.einsum("brc,brh->bch", ds.to(q.dtype).float(), q.float()) * scale
    dq = torch.einsum("brc,bch->brh", ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _kernel_entries():
    """The C entry points of ``csrc/flash_attention.cu``, typed: the three
    kernels, and the tensor-core design of each (``_tc``)."""
    lib = load_library("flash_attention")
    tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    entries = {}
    for name, n_ptrs in (("fwd", 5), ("bwd_dkv", 8), ("bwd_dq", 7), ("fwd_tc", 5),
                         ("bwd_dkv_tc", 8), ("bwd_dq_tc", 7)):
        fn = getattr(lib, f"flash_{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + tail
        entries[name] = fn
    return entries


def _check_cuda(**tensors: torch.Tensor) -> None:
    """What the kernels take: CUDA tensors on one device, contiguous,
    16-byte aligned; q/k/v/out/do in one dtype (fp32 or bf16), lse/delta
    fp32; head_dim 64 or 128."""
    q = tensors["q"]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernels take float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take head_dim 64 or 128, got {q.shape[-1]}")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _bwd_design(dtype: torch.dtype, head_dim: int) -> str:
    """The design of the two backward kernels for a dtype: ``"tensor_core"``
    (bf16 ``mma.sync`` products into fp32) for bf16, ``"cuda_core"`` (fp32
    FMAs) for fp32, whose products tensor cores would take only as TF32.
    Both designs take head_dim 64 and 128."""
    del head_dim
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def _fwd_design(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel's design for a dtype, by the rule of
    :func:`_bwd_design` (and apart from it, so that one can be forced
    without the other): ``"tensor_core"`` for bf16, ``"cuda_core"`` for
    fp32, at head_dim 64 and 128."""
    del head_dim
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def _launch(name: str, pointers, q, k, scale, causal, window, group,
            design: str = "cuda_core") -> None:
    """Launch one kernel of ``design`` on the current stream; raise on a
    refused launch (the tensor-core design refuses anything but bf16)."""
    bn, rows_q, h = q.shape
    entry = f"{name}_tc" if design == "tensor_core" else name
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_entries()[entry](
            *pointers, _DTYPE_CODES[q.dtype], bn, rows_q, k.shape[1], h, group,
            int(causal), 0 if window is None else window, scale, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention {name} ({design}) kernel launch failed: error {err}"
        )
    flash_attention.launches[name] += 1
    if design == "tensor_core":
        flash_attention.launches[f"{name}_tensor_core"] += 1


def _fwd(q, k, v, scale, causal, window, group, design=None):
    """Folded forward → ``(out, lse)``: for CUDA tensors the kernel of the
    design :func:`_fwd_design` picks (``design`` overrides it, to hold one
    design against the other); the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(
            q, k, v, scale=scale, causal=causal, window=window, group=group
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention runs on CUDA (the kernels) or the CPU (their "
            f"plain versions), got a tensor on {q.device}"
        )
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[1], 1, dtype=torch.float32, device=q.device)
    _check_cuda(q=q, k=k, v=v, out=out, lse=lse)
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse)]
    design = design or _fwd_design(q.dtype, q.shape[-1])
    _launch("fwd", ptrs, q, k, scale, causal, window, group, design)
    return out, lse


def _bwd(q, k, v, out, lse, do, scale, causal, window, group, design=None):
    """Folded backward → ``(dq, dk, dv)``: ``delta`` in torch, then the
    dK/dV kernel and the dQ kernel for CUDA tensors, of the design
    :func:`_bwd_design` picks (``design`` overrides it, to hold one design
    against the other); the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, out, lse, do, scale=scale, causal=causal, window=window,
            group=group,
        )
    design = design or _bwd_design(q.dtype, q.shape[-1])
    delta = _delta(out, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check_cuda(q=q, k=k, v=v, do=do, lse=lse, delta=delta, dq=dq, dk=dk, dv=dv)
    common = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    args = (q, k, scale, causal, window, group, design)
    _launch("bwd_dkv", common + [dk.data_ptr(), dv.data_ptr()], *args)
    _launch("bwd_dq", common + [dq.data_ptr()], *args)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The counterpart of the JAX ``_flash`` custom VJP, on folded tensors:
    saves ``q, k, v, out, lse``; the backward recomputes from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, group):
        out, lse = _fwd(q, k, v, scale, causal, window, group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, group)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    mask: torch.Tensor | None = None,
    scale: float | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
    bwd_block_q: int | None = None,
    bwd_block_k: int | None = None,
) -> torch.Tensor:
    """Blockwise-softmax attention over ``(B, S, N, H)`` inputs,
    differentiable through the flash backward.

    ``k``/``v`` may carry fewer heads (``N_kv`` dividing ``N``, GQA/MQA);
    they are read at their own head count. ``window``: each query attends
    the last ``window`` positions including itself; requires ``causal``.
    ``mask`` is accepted for the JAX signature and refused: only the
    structural causal mask is supported.

    ``block_q``/``block_k``/``bwd_block_q``/``bwd_block_k`` are the JAX
    kernel's tile sizes (None: auto, and the backward's inherit the
    forward's). They are validated as there, so the same calls succeed and
    fail; the CUDA kernels tile in their own 64-row tiles and mask a partial
    last tile, so the result does not depend on them.

    Returns ``(B, S, N, H)`` in ``q.dtype``.
    """
    if mask is not None:
        raise NotImplementedError(
            "flash_attention supports only the structural causal mask "
            "(causal=True); use dot_product_attention for arbitrary masks"
        )
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    b, s_q, n, h = q.shape
    s_kv, n_kv = k.shape[1], k.shape[2]
    if n % n_kv:
        raise ValueError(f"num_heads {n} not a multiple of kv heads {n_kv}")
    group = n // n_kv
    if group > 1 and s_q != s_kv:
        raise ValueError("GQA flash requires matching q/kv sequence lengths")
    rows_q = s_q * group
    block_q = _auto_block(rows_q) if block_q is None else block_q
    block_k = _auto_block(s_kv) if block_k is None else block_k
    if rows_q % block_q or s_kv % block_k:
        block_q, block_k = min(block_q, rows_q), min(block_k, s_kv)
        if rows_q % block_q or s_kv % block_k:
            raise ValueError(
                f"sequence lengths ({s_q}, {s_kv}) must be divisible by "
                f"block sizes ({block_q}, {block_k})"
            )
    for bwd_blk, rows in ((bwd_block_q, rows_q), (bwd_block_k, s_kv)):
        if bwd_blk is not None and rows % bwd_blk:
            raise ValueError(
                f"sequence rows ({rows}) must be divisible by the backward "
                f"block size ({bwd_blk})"
            )
    scale = h**-0.5 if scale is None else scale

    q_rows = (
        q.reshape(b, s_q, n_kv, group, h).permute(0, 2, 1, 3, 4)
        .reshape(b * n_kv, rows_q, h).contiguous()
    )
    k_rows = k.permute(0, 2, 1, 3).reshape(b * n_kv, s_kv, h).contiguous()
    v_rows = v.permute(0, 2, 1, 3).reshape(b * n_kv, s_kv, h).contiguous()
    out = _Flash.apply(q_rows, k_rows, v_rows, scale, causal, window, group)
    return (
        out.reshape(b, n_kv, s_q, group, h).permute(0, 2, 1, 3, 4)
        .reshape(b, s_q, n, h)
    )


#: Kernel launches since the last reset; each wrapper adds one per launch.
#: ``fwd``/``bwd_dkv``/``bwd_dq`` count both designs, ``*_tensor_core`` the
#: launches of the tensor-core design among them.
flash_attention.launches = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0, "fwd_tensor_core": 0,
                            "bwd_dkv_tensor_core": 0, "bwd_dq_tensor_core": 0}


def make_flash_attn_fn(mesh=None, rules=None, **kwargs):
    """An ``attn_fn`` for :class:`models.attention.MultiHeadAttention`:
    ``attn_fn(q, k, v, *, causal)`` routed to :func:`flash_attention` with
    ``kwargs`` (``window``, block sizes). It reads grouped k/v at their own
    head count (``attn_fn.supports_gqa``), so the module skips ``repeat_kv``.

    With ``mesh``/``rules`` the kernels run on each rank's shard, batch and
    heads split as the rules place ``(BATCH, None, HEADS, None)``; the
    sequence stays whole (flash needs every key). Gradients flow through:
    the backward kernels run on the same shards. Grouped k/v whose head
    count the heads axis cannot divide are repeated to full heads first.
    """
    if mesh is None:
        def attn_fn(q, k, v, *, causal: bool = False):
            return flash_attention(q, k, v, causal=causal, **kwargs)

        attn_fn.supports_gqa = True
        return attn_fn
    if rules is None:
        raise ValueError("rules are required when a mesh is given")
    from learning_jax_sharding_tpu_torch.parallel.logical import (
        BATCH,
        HEADS,
        activate,
        local_call,
        logical_to_mesh_axes,
    )

    rules = tuple(rules)
    spec = (BATCH, None, HEADS, None)
    heads_entry = logical_to_mesh_axes(spec, rules)[2]
    heads_axes = () if heads_entry is None else (
        (heads_entry,) if isinstance(heads_entry, str) else tuple(heads_entry))
    heads_axis_size = 1
    for a in heads_axes:
        heads_axis_size *= mesh.size(mesh.mesh_dim_names.index(a))

    def attn_fn(q, k, v, *, causal: bool = False):
        if k.shape[2] != q.shape[2] and k.shape[2] % heads_axis_size:
            reps = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(reps, dim=2)
            v = v.repeat_interleave(reps, dim=2)
        with activate(mesh, rules):
            return local_call(
                lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal, **kwargs),
                (q, k, v), (spec,) * 3, spec,
            )

    attn_fn.supports_gqa = True
    return attn_fn
