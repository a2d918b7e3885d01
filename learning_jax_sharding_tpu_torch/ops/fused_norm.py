"""Fused residual add + LayerNorm/RMSNorm: the CUDA kernels' wrapper and
their plain PyTorch versions.

Port of ``learning_jax_sharding_tpu/ops/fused_norm.py``. The transformer
block boundary ``x = x + sublayer(h); h' = norm(x)`` in one pass over the
rows: read ``x`` and ``resid`` once, form the sum in fp32, normalise it, and
write both the normed output and the new residual stream. Numerics, as the
TPU kernels: the norm runs on the UNROUNDED fp32 sum while the residual is
stored rounded to x's dtype; LayerNorm takes the centred two-pass variance;
the backward recomputes xhat from the ROUNDED residual and the saved fp32
mean/rstd; dgamma/dbeta are summed in fp32 and cast to gamma's dtype.

For CUDA tensors :func:`fused_residual_norm` launches the hand-written
kernels of ``csrc/fused_norm.cu`` (built at first use, see ``_build``); for
CPU tensors it runs :func:`fused_residual_norm_reference` and
:func:`fused_residual_norm_bwd_reference`, the plain versions the tests hold
against the JAX kernels. Nothing falls back from one to the other.
Gradients go through :class:`_FusedNorm`, the counterpart of the JAX
``_fused`` custom VJP; with no gradient to take, the forward writes no
statistics (the JAX primal path).

The kernels take every width. Their geometry is
:func:`_design`'s, picked before the launch: a row group of threads a row,
each thread holding 16-byte loads of it (one-element loads where the width
is no multiple of 16 bytes), the forward's grid from the rows and the
card's SMs (:func:`_fwd_blocks`), the backward's blocks in clusters whose
column sums meet in the same launch (:func:`_bwd_blocks`). A row past
``PASS_FEATURES`` (one pass of the widest row group) takes the wide
kernels: the widest geometry in ``passes`` segments a row, the backward's
column sums split by segment over a second grid dimension. The first design
(``design="warp_row"``: a warp a row, features a multiple of 8 up to 1024,
the backward's sums in one or two more launches) stays reachable for
comparison; the public path never takes it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library
from learning_jax_sharding_tpu_torch.ops.int4_ff import _zero_counters
from learning_jax_sharding_tpu_torch.ops.int4_matmul import _DTYPE_CODES, _on_cuda, _sm_count

#: The widest row one pass of a row group holds (kMaxM in csrc/fused_norm.cu:
#: the backward keeps 2M fp32 column sums in one block's shared memory);
#: wider rows take several passes.
PASS_FEATURES = 16384
#: Threads a block, and so a row group, at most.
MAX_THREADS = 512
#: Row groups a backward block at most (one named barrier each).
MAX_GROUPS = 8
#: Threads a backward block aims at: row groups are added up to it (three
#: of 96 threads at 768 bf16 features: 27 warps an SM, the fastest of 1-5
#: groups on an H100).
BWD_BLOCK_THREADS = 288
#: Values a thread holds past which the backward keeps no row in flight and
#: takes one row group a block (kBwdHeld).
BWD_HELD = 8
#: Blocks a cluster at most (the portable limit).
MAX_CLUSTER = 8
#: Loads a thread holds, as instantiated in csrc/fused_norm.cu: 16-byte loads
#: by dtype, and one-element loads.
VECTOR_CHOICES = {torch.bfloat16: (1, 2, 4), torch.float32: (1, 2, 4, 8)}
ELEMENT_CHOICES = (1, 4, 32)
#: The first design: a multiple of 8 features up to 32 values a lane.
WARP_ROW_MAX_FEATURES = 1024


class Design(NamedTuple):
    """The geometry of a ``"row_group"`` launch: ``vec`` elements a load (16
    bytes of the row's dtype, or 1), ``vectors`` loads a thread, ``threads``
    threads a row (a multiple of 32), ``groups`` row groups a block,
    ``passes`` segments of ``threads · vectors · vec`` columns a row (more
    than one: the wide kernels)."""

    vec: int
    vectors: int
    threads: int
    groups: int
    passes: int = 1


def _pick_block_r(rows: int, m: int, tile_bytes: int = 2 << 20) -> int:
    """Rows per tile of the JAX kernel: the largest power of two dividing
    ``rows`` whose fp32 tile stays under ``tile_bytes``, or one whole tile
    while that fits. Validated as there, so the same calls succeed and fail;
    the CUDA kernels stride rows over warps and do not depend on it."""
    cap = max(8, tile_bytes // (m * 4))
    blk = 1
    while blk < cap and rows % (blk * 2) == 0:
        blk *= 2
    if blk >= 8:
        return blk
    if rows <= cap:
        return rows
    raise ValueError(
        f"row count {rows} (features {m}) has no power-of-two factor >= 8 "
        f"and one whole tile would exceed VMEM; pad batch*seq or pass a "
        f"dividing block_r"
    )


def fused_residual_norm_reference(x2, r2, gamma, beta, *, eps: float, kind: str,
                                  needs_stats: bool):
    """The plain version of the forward kernel on ``(rows, M)`` inputs →
    ``(y, new_resid or None, mean or None, rstd or None)``; the statistics
    are ``(rows, 1)`` fp32, mean for LayerNorm only."""
    s = x2.float()
    r = None
    if r2 is not None:
        s = s + r2.float()
        r = s.to(x2.dtype)
    mean = None
    if kind == "layernorm":
        mean = s.mean(-1, keepdim=True)
        xc = s - mean
        rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        y = xc * rstd * gamma.float()
        if beta is not None:
            y = y + beta.float()
    else:
        rstd = torch.rsqrt((s * s).mean(-1, keepdim=True) + eps)
        y = s * rstd * gamma.float()
    if not needs_stats:
        mean = rstd = None
    return y.to(x2.dtype), r, mean, rstd


def fused_residual_norm_bwd_reference(dy, r, gamma, mean, rstd, dr, *, kind: str,
                                      has_beta: bool):
    """The plain version of the backward kernel on ``(rows, M)`` tensors →
    ``(dx, dgamma, dbeta or None)``: dx in dy's dtype (plus ``dr`` in that
    dtype when given), dgamma/dbeta summed in fp32, cast to gamma's dtype."""
    do = dy.float()
    x = r.float()
    xhat = (x - mean) * rstd if kind == "layernorm" else x * rstd
    dgamma = (do * xhat).sum(0).to(gamma.dtype)
    dbeta = do.sum(0).to(gamma.dtype) if has_beta else None
    dxhat = do * gamma.float()
    c2 = (dxhat * xhat).mean(-1, keepdim=True)
    if kind == "layernorm":
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * c2)
    else:
        dx = rstd * (dxhat - xhat * c2)
    dx = dx.to(dy.dtype)
    if dr is not None:
        dx = dx + dr
    return dx, dgamma, dbeta


@functools.cache
def _design(rows: int, m: int, dtype: torch.dtype, backward: bool = False) -> Design:
    """The ``"row_group"`` geometry of ``rows`` rows of ``m`` features in
    ``dtype``: 16-byte loads where ``m`` is a multiple of 16 bytes (every
    row then starts aligned), else one-element loads; the fewest loads a
    thread (of those instantiated) that keep a row within ``MAX_THREADS``
    threads, so that a row spreads over as many warps as that takes (the 768
    features of a bf16 row: 96 threads, one load each; 2048: 256). The
    forward's block is one row group. The backward adds row groups up to
    ``BWD_BLOCK_THREADS`` threads while a thread holds at most ``BWD_HELD``
    values, and never more than ``rows`` needs. A row that no row group
    holds in one pass takes the widest (``MAX_THREADS`` threads, the most
    loads a thread) in ``passes`` segments, one row group a block. A choice
    made before the launch: nothing falls back."""
    _check_width(m)
    full = 128 // torch.finfo(dtype).bits
    vec = full if m % full == 0 else 1
    loads = -(-m // vec)
    choices = VECTOR_CHOICES[dtype] if vec > 1 else ELEMENT_CHOICES
    widest = choices[-1]
    if loads > MAX_THREADS * widest:
        return Design(vec, widest, MAX_THREADS, 1, -(-loads // (MAX_THREADS * widest)))
    vectors = next(v for v in choices if -(-loads // v) <= MAX_THREADS)
    threads = 32 * -(-loads // (32 * vectors))
    groups = 1
    if backward and vec * vectors <= BWD_HELD:
        groups = max(1, min(MAX_GROUPS, BWD_BLOCK_THREADS // threads, rows))
    return Design(vec, vectors, threads, groups)


def _fwd_blocks(rows: int, sms: int, per_sm: int) -> int:
    """The forward's grid: one block a row while the card holds them all
    (``per_sm`` blocks on each of ``sms`` SMs), else every resident block,
    each streaming rows ``b, b + grid, ...``."""
    return max(1, min(rows, sms * per_sm))


def _bwd_cluster(rows: int, design: Design) -> int:
    """Blocks a backward cluster: ``MAX_CLUSTER``, or the largest power of
    two the rows fill."""
    need = -(-rows // design.groups)
    c = MAX_CLUSTER
    while c > 1 and c > need:
        c //= 2
    return c


def _bwd_blocks(rows: int, design: Design, cluster: int, clusters: int) -> int:
    """The backward's grid: one block for every ``groups`` rows, rounded up
    to whole clusters, at most the ``clusters`` the card holds at once."""
    need = -(-rows // design.groups)
    return min(-(-need // cluster), max(1, clusters)) * cluster


@functools.cache
def _kernel_entries():
    """The C entry points of ``csrc/fused_norm.cu``, typed for ctypes."""
    lib = load_library("fused_norm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for name, args in {
        "fwd_occupancy": [i32] * 5,
        "fwd_launch": [ptr] * 8 + [i32] * 5 + [ctypes.c_float] + [i32] * 5 + [ptr],
        "bwd_occupancy": [i32] * 8,
        "bwd_launch": [ptr] * 11 + [i32] * 12 + [ptr],
        "warp_row_fwd_launch": [ptr] * 8 + [i32] * 5 + [ctypes.c_float, i32, ptr],
        "warp_row_bwd_launch": [ptr] * 11 + [i32] * 6 + [ptr],
    }.items():
        fn = getattr(lib, f"fused_norm_{name}")
        fn.restype, fn.argtypes = i32, args
        entries[name] = fn
    return entries


@functools.cache
def _fwd_per_sm(index: int, dtype: torch.dtype, design: Design) -> int:
    """Forward blocks an SM of device ``index`` holds (the occupancy API)."""
    with torch.cuda.device(index):
        n = _kernel_entries()["fwd_occupancy"](_DTYPE_CODES[dtype], design.vec, design.vectors,
                                               design.threads, design.passes)
    if n < 1:
        raise RuntimeError(f"fused_norm forward {design}: occupancy query gave {n}")
    return n


@functools.cache
def _bwd_clusters(index: int, dtype: torch.dtype, design: Design, m: int, cluster: int) -> int:
    """Backward clusters of ``cluster`` blocks device ``index`` holds at once."""
    with torch.cuda.device(index):
        n = _kernel_entries()["bwd_occupancy"](_DTYPE_CODES[dtype], design.vec, design.vectors,
                                               design.threads, design.groups, m, cluster,
                                               design.passes)
    if n < 1:
        raise RuntimeError(f"fused_norm backward {design}, M={m}, cluster {cluster}: occupancy "
                           f"query gave {n}")
    return n


def _check_width(m: int, warp_row: bool = False) -> None:
    if warp_row and (m % 8 or m > WARP_ROW_MAX_FEATURES):
        raise ValueError(f"the warp_row design takes features a multiple of 8 up to "
                         f"{WARP_ROW_MAX_FEATURES}, got {m}")
    if m < 1:
        raise ValueError(f"fused_norm kernels take at least 1 feature, got {m}")


def _check_cuda(x2: torch.Tensor, gamma: torch.Tensor, *, warp_row: bool = False,
                **tensors) -> None:
    """What the kernels take: one device; row tensors contiguous, in x's
    dtype (fp32 or bf16); any width (``warp_row``: a
    multiple of 8 up to 1024); gamma/beta ``(M,)`` contiguous fp32 or bf16,
    in one dtype. Where the width is a multiple of 16 bytes the kernels load
    16 bytes at a time, and row tensors and parameters must be 16-byte
    aligned."""
    rows, m = x2.shape
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_norm kernels take float32 or bfloat16, got {x2.dtype}")
    if gamma.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_norm kernels take float32 or bfloat16 gamma, got {gamma.dtype}")
    _check_width(m, warp_row)
    vectors = warp_row or m * x2.element_size() % 16 == 0
    for name, t in {"x": x2, "gamma": gamma, **tensors}.items():
        if t is None:
            continue
        if t.device != x2.device:
            raise ValueError(f"fused_norm: {name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_norm: {name} must be contiguous")
        if name in ("gamma", "beta", "dgamma", "dbeta"):
            if tuple(t.shape) != (m,) or t.dtype != gamma.dtype:
                raise ValueError(f"fused_norm: {name} must be ({m},) {gamma.dtype}")
        elif name in ("mean", "rstd", "part_g", "part_b"):
            if t.dtype != torch.float32:
                raise ValueError(f"fused_norm: {name} must be float32")
            continue
        elif tuple(t.shape) != (rows, m) or t.dtype != x2.dtype:
            raise ValueError(f"fused_norm: {name} must be {(rows, m)} {x2.dtype}")
        if vectors and t.data_ptr() % 16:
            raise ValueError(f"fused_norm: {name} must be 16-byte aligned")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(x2, r2, gamma, beta, *, eps, kind, needs_stats, design=None):
    """The forward kernel on CUDA ``(rows, M)`` tensors: ``design`` None (the
    public path: :func:`_design`), a :class:`Design` (that geometry) or
    ``"warp_row"`` (the first design)."""
    rows, m = x2.shape
    y = torch.empty_like(x2)
    r = None if r2 is None else torch.empty_like(x2)
    stat = lambda: torch.empty(rows, 1, dtype=torch.float32, device=x2.device)
    mean = stat() if needs_stats and kind == "layernorm" else None
    rstd = stat() if needs_stats else None
    warp_row = design == "warp_row"
    _check_cuda(x2, gamma, warp_row=warp_row, resid=r2, beta=beta, y=y, r=r, mean=mean,
                rstd=rstd)
    index = x2.device.index
    args = (x2.data_ptr(), _ptr(r2), gamma.data_ptr(), _ptr(beta), y.data_ptr(), _ptr(r),
            _ptr(mean), _ptr(rstd), _DTYPE_CODES[x2.dtype], _DTYPE_CODES[gamma.dtype],
            int(kind == "layernorm"), rows, m, eps)
    with torch.cuda.device(index):
        if warp_row:
            err = _kernel_entries()["warp_row_fwd_launch"](*args, _sm_count(index),
                                                           _stream(x2.device))
        else:
            d = design or _design(rows, m, x2.dtype)
            blocks = _fwd_blocks(rows, _sm_count(index), _fwd_per_sm(index, x2.dtype, d))
            err = _kernel_entries()["fwd_launch"](*args, d.vec, d.vectors, d.threads, blocks,
                                                  d.passes, _stream(x2.device))
    if err != 0:
        raise RuntimeError(f"fused_norm forward kernel launch failed: error {err}")
    fused_residual_norm.launches["fwd" if needs_stats else "fwd_nostats"] += 1
    return y, r, mean, rstd


def _launch_bwd(dy, r, gamma, mean, rstd, dr, *, kind, has_beta, design=None):
    """The backward on CUDA ``(rows, M)`` tensors, ``design`` as in
    :func:`_launch_fwd`: one launch (``"warp_row"``: two or three)."""
    rows, m = r.shape
    index = r.device.index
    dx = torch.empty_like(r)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma) if has_beta else None
    codes = (_DTYPE_CODES[r.dtype], _DTYPE_CODES[gamma.dtype], int(kind == "layernorm"), rows, m)
    stream = _stream(r.device)
    if design == "warp_row":
        blocks = min(-(-rows // 8), _sm_count(index))
        part = torch.empty(2 if has_beta else 1, blocks, m, dtype=torch.float32, device=r.device)
        part_b = part[1] if has_beta else None
        _check_cuda(r, gamma, warp_row=True, dy=dy, dr=dr, dx=dx, mean=mean, rstd=rstd,
                    part_g=part[0], part_b=part_b, dgamma=dgamma, dbeta=dbeta)
        with torch.cuda.device(index):
            err = _kernel_entries()["warp_row_bwd_launch"](
                dy.data_ptr(), r.data_ptr(), gamma.data_ptr(), _ptr(mean), rstd.data_ptr(),
                _ptr(dr), dx.data_ptr(), part[0].data_ptr(), _ptr(part_b), dgamma.data_ptr(),
                _ptr(dbeta), *codes, blocks, stream)
    else:
        _check_cuda(r, gamma, dy=dy, dr=dr, dx=dx, mean=mean, rstd=rstd, dgamma=dgamma,
                    dbeta=dbeta)
        d = design or _design(rows, m, r.dtype, backward=True)
        cluster = _bwd_cluster(rows, d)
        blocks = _bwd_blocks(rows, d, cluster, _bwd_clusters(index, r.dtype, d, m, cluster))
        # The clusters' column sums: a row of them each (per segment, wide).
        cols = m if d.passes == 1 else d.threads * d.vec * d.vectors
        ws = torch.empty(d.passes * (blocks // cluster if blocks > cluster else 0),
                         -(-2 * cols // 32) * 32, dtype=torch.float32, device=r.device)
        with torch.cuda.device(index):
            err = _kernel_entries()["bwd_launch"](
                dy.data_ptr(), r.data_ptr(), gamma.data_ptr(), _ptr(mean), rstd.data_ptr(),
                _ptr(dr), dx.data_ptr(), ws.data_ptr(),
                _zero_counters(r.device, stream, MAX_CLUSTER * d.passes).data_ptr(),
                dgamma.data_ptr(), _ptr(dbeta), *codes, d.vec, d.vectors, d.threads, d.groups,
                blocks, cluster, d.passes, stream)
    if err != 0:
        raise RuntimeError(f"fused_norm backward kernel launch failed: error {err}")
    fused_residual_norm.launches["bwd"] += 1
    return dx, dgamma, dbeta


def _fwd(x2, r2, gamma, beta, *, eps, kind, needs_stats, design=None):
    """``(rows, M)`` forward → ``(y, new_resid, mean, rstd)``: the kernel for
    CUDA tensors (``design`` as in :func:`_launch_fwd`), the plain version
    for CPU tensors."""
    if _on_cuda(x2, "fused_residual_norm"):
        return _launch_fwd(x2.contiguous(), None if r2 is None else r2.contiguous(), gamma,
                           beta, eps=eps, kind=kind, needs_stats=needs_stats, design=design)
    return fused_residual_norm_reference(x2, r2, gamma, beta, eps=eps, kind=kind,
                                         needs_stats=needs_stats)


def _bwd(dy, r, gamma, mean, rstd, dr, *, kind, has_beta, design=None):
    """``(rows, M)`` backward → ``(dx, dgamma, dbeta)``: the kernel for CUDA
    tensors (``design`` as in :func:`_launch_fwd`), the plain version for
    CPU tensors."""
    if _on_cuda(r, "fused_residual_norm"):
        return _launch_bwd(dy.contiguous(), r, gamma, mean, rstd,
                           None if dr is None else dr.contiguous(), kind=kind,
                           has_beta=has_beta, design=design)
    return fused_residual_norm_bwd_reference(dy, r, gamma, mean, rstd, dr, kind=kind,
                                             has_beta=has_beta)


class _FusedNorm(torch.autograd.Function):
    """The counterpart of the JAX ``_fused`` custom VJP, on ``(rows, M)``
    tensors: the forward saves the residual (rounded), gamma and the fp32
    statistics; the backward recomputes xhat from them. Returns ``(y,
    new_resid)``, ``new_resid`` None without a residual input (the caller
    hands back x itself)."""

    @staticmethod
    def forward(ctx, x2, r2, gamma, beta, eps, kind):
        y, r, mean, rstd = _fwd(x2, r2, gamma, beta, eps=eps, kind=kind, needs_stats=True)
        ctx.save_for_backward(x2 if r is None else r, gamma, mean, rstd)
        ctx.kind, ctx.has_beta, ctx.has_resid = kind, beta is not None, r2 is not None
        # An unused residual output (ln_attn, ln_out) brings None, and the
        # backward then adds nothing instead of a tensor of zeros.
        ctx.set_materialize_grads(False)
        return y, r

    @staticmethod
    def backward(ctx, dy, dr):
        r, gamma, mean, rstd = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        dx, dgamma, dbeta = _bwd(dy, r, gamma, mean, rstd, dr, kind=ctx.kind,
                                 has_beta=ctx.has_beta)
        # The residual output passes straight through the sum: its gradient
        # (already in dx) reaches both inputs of the add.
        return dx, dx if ctx.has_resid else None, dgamma, dbeta, None, None


def fused_residual_norm(
    x: torch.Tensor,
    resid: torch.Tensor | None,
    gamma: torch.Tensor,
    beta: torch.Tensor | None = None,
    *,
    eps: float = 1e-6,
    kind: str = "layernorm",
    block_r: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(norm(x + resid) * gamma [+ beta], x + resid)`` in one pass.

    Args:
        x: ``(..., M)`` sublayer output (fp32 math inside).
        resid: the incoming residual stream, same shape, or ``None`` for a
            plain norm, in which case the second return is ``x`` itself.
        gamma: ``(M,)`` scale. beta: ``(M,)`` shift (layernorm only; None
            for scale-only layernorm or rmsnorm).
        kind: ``"layernorm"`` | ``"rmsnorm"``.
        block_r: the JAX kernel's rows per tile, validated as there (it
            must divide the row count); the result does not depend on it.

    Returns:
        ``(normed, new_resid)`` in x's dtype. Differentiable; when no input
        needs a gradient (or grad mode is off) the forward writes no
        statistics.
    """
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "rmsnorm" and beta is not None:
        raise ValueError("rmsnorm has no beta")
    shape = x.shape
    m = shape[-1]
    rows = x.numel() // m
    br = _pick_block_r(rows, m) if block_r is None else block_r
    if rows % br:
        raise ValueError(f"rows ({rows} = batch*seq) must be divisible by block_r ({br})")
    x2 = x.reshape(rows, m)
    r2 = None if resid is None else resid.reshape(rows, m)
    inputs = [t for t in (x, resid, gamma, beta) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        y, r = _FusedNorm.apply(x2, r2, gamma, beta, eps, kind)
    else:
        y, r, _, _ = _fwd(x2, r2, gamma, beta, eps=eps, kind=kind, needs_stats=False)
    return y.reshape(shape), x if r is None else r.reshape(shape)


#: Kernel launches since the last reset: forwards that write the statistics
#: (a gradient is taken), forwards that do not, and backwards (dx, dgamma and
#: dbeta in one launch; the warp_row design's also runs its ordered
#: reduction launches).
fused_residual_norm.launches = {"fwd": 0, "fwd_nostats": 0, "bwd": 0}
