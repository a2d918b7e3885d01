"""Whole-FF fused int4: up-project → GELU → down-project in one call. The
CUDA kernel's wrapper and its plain PyTorch version.

Port of ``learning_jax_sharding_tpu/ops/int4_ff.py``: ``gelu(x @ W1) @ W2``
with both weights int4-packed (``models/quantize.py::quantize_leaf_int4``),
the hidden activation ``u`` kept out of device memory. Numerics, as the TPU
kernel: the up weights round to x's dtype, ``u`` and the GELU (tanh) stay in
fp32, the down weights stay fp32 (not rounded), the down product sums in
fp32, and the output is written in x's dtype. That differs from the
per-projection path (which rounds the hidden activation to x's dtype), so
which path a layer takes is decided exactly as in JAX
(:func:`int4_ff_eligible`).

For CUDA tensors :func:`int4_ff` launches the hand-written kernel of
``csrc/int4_ff.cu`` (built at first use); for CPU tensors it runs
:func:`int4_ff_reference`, which the tests hold against the JAX kernel.
Nothing falls back from one to the other. Inference only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library
from learning_jax_sharding_tpu_torch.ops.int4_matmul import (
    _DTYPE_CODES,
    _check_cuda,
    _dequant_halves,
    _on_cuda,
)

# Packed down rows per block: a multiple of 16 (32-column up chunks), grown
# from 16 by doubling until the fp32 partials of all blocks fit this size.
_MIN_ROWS_PER_BLOCK = 16
_PARTIAL_BYTES = 64 << 20


def _pick_block_h(h_half: int, g_dn: int, block_h: int) -> int | None:
    """Hidden rows per grid step (per half) of the JAX kernel: ≤ ``block_h``
    when possible, rounded to cover whole down-scale groups, dividing
    ``h_half``. None when no such block exists."""
    bh = min(block_h, h_half)
    if g_dn > 1:
        if h_half % g_dn:
            return None
        bh = max(bh - bh % g_dn, g_dn)
    while h_half % bh:
        bh -= g_dn if g_dn > 1 else 1
        if bh <= 0:
            return None
    return bh


def int4_ff_eligible(k: int, hidden: int, group: int, block_h: int = 256) -> bool:
    """Shapes the fused kernel can tile: even dims, scale groups dividing
    each packed half, hidden half splitting into whole blocks that cover
    whole down-scale groups. Routing follows it exactly as in JAX."""
    if k % 2 or hidden % 2:
        return False
    g_up = min(group, k)
    if g_up < k and (k // 2) % g_up:   # g_up == k → one whole-K group
        return False
    g_dn = min(group, hidden)
    if g_dn == hidden:                 # one whole-H group: any block works
        g_dn = 1
    return _pick_block_h(hidden // 2, g_dn, block_h) is not None


def int4_ff_reference(x2, q4_up, s_up, q4_dn, s_dn, *, group: int) -> torch.Tensor:
    """The plain version of the kernel: ``(M, K)`` → ``(M, K)`` in x's
    dtype. Takes validated arguments."""
    k_half, hidden = q4_up.shape
    k = 2 * k_half
    up_lo, up_hi = _dequant_halves(q4_up, s_up, min(group, k), x2.dtype)
    u = x2[:, :k_half].float() @ up_lo.float() + x2[:, k_half:].float() @ up_hi.float()
    u = torch.nn.functional.gelu(u, approximate="tanh")
    dn_lo, dn_hi = _dequant_halves(q4_dn, s_dn, min(group, hidden), torch.float32)
    h_half = hidden // 2
    out = u[:, :h_half] @ dn_lo + u[:, h_half:] @ dn_hi
    return out.to(x2.dtype)


@functools.cache
def _kernel_entry():
    """The C entry point of ``csrc/int4_ff.cu``, typed for ctypes."""
    fn = load_library("int4_ff").int4_ff_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return fn


def rows_per_block(m: int, k: int, hidden: int) -> int:
    """Packed down rows (hidden pairs) per CUDA block: 16, doubled while
    the blocks' fp32 partials ``(H/2 / P) · M · K`` would pass 64 MiB."""
    h_half = hidden // 2
    p = _MIN_ROWS_PER_BLOCK
    while (h_half // p) * m * k * 4 > _PARTIAL_BYTES and h_half % (2 * p) == 0:
        p *= 2
    return p


def _launch_cuda(x2, q4_up, s_up, q4_dn, s_dn, *, group: int) -> torch.Tensor:
    """Check what the kernel takes, then launch it on the current stream."""
    m, k = x2.shape
    hidden = q4_up.shape[1]
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"int4_ff kernel takes float32 or bfloat16 x, got {x2.dtype}")
    _check_cuda("int4_ff", x2, q4_up=q4_up, scale_up=s_up, q4_dn=q4_dn, scale_dn=s_dn)
    if (hidden // 2) % _MIN_ROWS_PER_BLOCK:
        raise ValueError(
            f"int4_ff kernel needs H/2 a multiple of {_MIN_ROWS_PER_BLOCK}, got H={hidden}"
        )
    p = rows_per_block(m, k, hidden)
    partial = torch.empty(hidden // 2 // p, m, k, dtype=torch.float32, device=x2.device)
    out = torch.empty(m, k, dtype=x2.dtype, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = _kernel_entry()(
            x2.data_ptr(), q4_up.data_ptr(), s_up.data_ptr(), q4_dn.data_ptr(),
            s_dn.data_ptr(), partial.data_ptr(), out.data_ptr(), _DTYPE_CODES[x2.dtype],
            m, k, hidden, s_up.shape[0], min(group, k), s_dn.shape[0], min(group, hidden),
            p, stream,
        )
    if err != 0:
        raise RuntimeError(f"int4_ff kernel launch failed: error {err}")
    return out


def int4_ff(
    x: torch.Tensor,
    q4_up: torch.Tensor,
    s_up: torch.Tensor,
    q4_dn: torch.Tensor,
    s_dn: torch.Tensor,
    *,
    group: int = 128,
    block_h: int = 256,
) -> torch.Tensor:
    """``gelu(x @ W1) @ W2`` with both weights int4-packed, one kernel call.

    Args:
        x: ``(..., K)`` activations.
        q4_up / s_up: packed ``(K/2, H)`` + scales ``(K/group or 1, H)``.
        q4_dn / s_dn: packed ``(H/2, K)`` + scales ``(H/group or 1, K)``.
        group: quantization group of both trees.
        block_h: the JAX kernel's hidden tile; it decides eligibility as
            there and does not change the result. The CUDA kernel picks its
            own tiles (:func:`rows_per_block`).

    Returns:
        ``(..., K)`` in ``x.dtype``.
    """
    *lead, k = x.shape
    k_half, hidden = q4_up.shape
    h_half, k_out = q4_dn.shape
    if k != 2 * k_half or k_out != k or hidden != 2 * h_half:
        raise ValueError(
            f"shape mismatch: x K={k}, up {tuple(q4_up.shape)}, down {tuple(q4_dn.shape)}"
        )
    if not int4_ff_eligible(k, hidden, group, block_h):
        raise ValueError(
            f"int4_ff cannot tile K={k}, H={hidden}, group={group}; use the "
            f"per-projection int4_matmul path"
        )
    m = 1
    for d in lead:
        m *= d
    x2 = x.reshape(m, k).contiguous()
    if _on_cuda(x, "int4_ff"):
        out = _launch_cuda(x2, q4_up, s_up, q4_dn, s_dn, group=group)
        int4_ff.launches += 1
    else:
        out = int4_ff_reference(x2, q4_up, s_up, q4_dn, s_dn, group=group)
    return out.reshape(*lead, k)


#: Kernel launches since the last reset; the wrapper adds one per launch.
int4_ff.launches = 0
