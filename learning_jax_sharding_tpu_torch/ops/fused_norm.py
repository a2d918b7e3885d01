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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library
from learning_jax_sharding_tpu_torch.ops.int4_matmul import _DTYPE_CODES, _on_cuda

_MAX_FEATURES = 1024      # kMaxM in csrc/fused_norm.cu: 32 values a lane
_BWD_MAX_BLOCKS = 132     # one block a streaming multiprocessor (H100 SXM)


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
def _kernel_entries():
    """The C entry points of ``csrc/fused_norm.cu``, typed for ctypes."""
    lib = load_library("fused_norm")
    fwd = lib.fused_norm_fwd_launch
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    bwd = lib.fused_norm_bwd_launch
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fwd, bwd


def _check_cuda(x2: torch.Tensor, gamma: torch.Tensor, **tensors) -> None:
    """What the kernels take: one device; row tensors contiguous, 16-byte
    aligned, in x's dtype (fp32 or bf16); M a multiple of 8, at most 1024;
    gamma/beta ``(M,)`` contiguous fp32 or bf16, in one dtype."""
    rows, m = x2.shape
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_norm kernels take float32 or bfloat16, got {x2.dtype}")
    if gamma.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_norm kernels take float32 or bfloat16 gamma, got {gamma.dtype}")
    if m % 8 or m > _MAX_FEATURES:
        raise ValueError(
            f"fused_norm kernels take features a multiple of 8 up to {_MAX_FEATURES}, got {m}"
        )
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
        else:
            if tuple(t.shape) != (rows, m) or t.dtype != x2.dtype:
                raise ValueError(f"fused_norm: {name} must be {(rows, m)} {x2.dtype}")
            if t.data_ptr() % 16:
                raise ValueError(f"fused_norm: {name} must be 16-byte aligned")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(x2, r2, gamma, beta, *, eps, kind, needs_stats):
    rows, m = x2.shape
    y = torch.empty_like(x2)
    r = None if r2 is None else torch.empty_like(x2)
    stat = lambda: torch.empty(rows, 1, dtype=torch.float32, device=x2.device)
    mean = stat() if needs_stats and kind == "layernorm" else None
    rstd = stat() if needs_stats else None
    _check_cuda(x2, gamma, resid=r2, beta=beta, y=y, r=r, mean=mean, rstd=rstd)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x2.device):
        err = _kernel_entries()[0](
            x2.data_ptr(), ptr(r2), gamma.data_ptr(), ptr(beta), y.data_ptr(), ptr(r),
            ptr(mean), ptr(rstd), _DTYPE_CODES[x2.dtype], _DTYPE_CODES[gamma.dtype],
            int(kind == "layernorm"), rows, m, eps, _stream(x2.device),
        )
    if err != 0:
        raise RuntimeError(f"fused_norm forward kernel launch failed: error {err}")
    fused_residual_norm.launches["fwd" if needs_stats else "fwd_nostats"] += 1
    return y, r, mean, rstd


def _launch_bwd(dy, r, gamma, mean, rstd, dr, *, kind, has_beta):
    rows, m = r.shape
    blocks = min(-(-rows // 8), _BWD_MAX_BLOCKS)
    dx = torch.empty_like(r)
    part = torch.empty(2 if has_beta else 1, blocks, m, dtype=torch.float32, device=r.device)
    part_b = part[1] if has_beta else None
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma) if has_beta else None
    _check_cuda(r, gamma, dy=dy, dr=dr, dx=dx, mean=mean, rstd=rstd, part_g=part[0],
                part_b=part_b, dgamma=dgamma, dbeta=dbeta)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(r.device):
        err = _kernel_entries()[1](
            dy.data_ptr(), r.data_ptr(), gamma.data_ptr(), ptr(mean), rstd.data_ptr(),
            ptr(dr), dx.data_ptr(), part[0].data_ptr(), ptr(part_b), dgamma.data_ptr(),
            ptr(dbeta), _DTYPE_CODES[r.dtype], _DTYPE_CODES[gamma.dtype],
            int(kind == "layernorm"), rows, m, blocks, _stream(r.device),
        )
    if err != 0:
        raise RuntimeError(f"fused_norm backward kernel launch failed: error {err}")
    fused_residual_norm.launches["bwd"] += 1
    return dx, dgamma, dbeta


def _fwd(x2, r2, gamma, beta, *, eps, kind, needs_stats):
    """``(rows, M)`` forward → ``(y, new_resid, mean, rstd)``: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if _on_cuda(x2, "fused_residual_norm"):
        return _launch_fwd(x2.contiguous(), None if r2 is None else r2.contiguous(), gamma,
                           beta, eps=eps, kind=kind, needs_stats=needs_stats)
    return fused_residual_norm_reference(x2, r2, gamma, beta, eps=eps, kind=kind,
                                         needs_stats=needs_stats)


def _bwd(dy, r, gamma, mean, rstd, dr, *, kind, has_beta):
    """``(rows, M)`` backward → ``(dx, dgamma, dbeta)``: the kernels for
    CUDA tensors, the plain version for CPU tensors."""
    if _on_cuda(r, "fused_residual_norm"):
        return _launch_bwd(dy.contiguous(), r, gamma, mean, rstd,
                           None if dr is None else dr.contiguous(), kind=kind,
                           has_beta=has_beta)
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
#: (a gradient is taken), forwards that do not, and backwards (each backward
#: also runs the ordered dgamma/dbeta reduction).
fused_residual_norm.launches = {"fwd": 0, "fwd_nostats": 0, "bwd": 0}
