"""Fused int4 dequant-matmul: the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``learning_jax_sharding_tpu/ops/int4_matmul.py``. ``x @ dequant(q4,
scale)`` without a dequantized weight array in device memory: the packed
nibbles stream straight into the product.

Layout contract = ``models/quantize.py::quantize_leaf_int4``: split-half
packing (byte row r holds kernel rows r (low nibble) and r + K/2 (high),
offset-binary +8), group-wise fp32 scales over ``group`` contraction rows
(``(K/group, N)``, or ``(1, N)`` for one whole-K group).

Numerics, as the TPU kernels: the w4a16 product rounds each dequantized
weight ``(q - 8)·s`` to x's dtype, accumulates in fp32 and writes x's dtype;
w4a8 quantizes x per row to int8 (:func:`quantize_rows_int8`), sums each
scale group's int8 × int4 products exactly in int32, scales the partials in
fp32, sums the groups in order and multiplies by the row scale.

For CUDA tensors the wrappers launch the hand-written kernels of
``csrc/int4_matmul.cu`` (built at first use, see ``_build``); for CPU tensors
they run the plain versions, which the tests hold against the JAX kernels.
Nothing falls back from one to the other. Inference only: no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dequant_halves(q4: torch.Tensor, scale: torch.Tensor, group: int, dtype):
    """Packed ``(R, N)`` + scales ``(2·R/group or 1, N)`` → the two scaled
    halves ``(R, N)`` (lo = kernel rows ``[0, R)``, hi = rows ``[R, 2R)``),
    ``(q - 8)·s`` in fp32 rounded to ``dtype``."""
    rows, n = q4.shape
    p = q4.to(torch.int32)
    lo = ((p & 0xF) - 8).float()
    hi = ((p >> 4) - 8).float()
    if scale.shape[0] == 1:
        return (lo * scale).to(dtype), (hi * scale).to(dtype)
    ng = rows // group
    lo = (lo.reshape(ng, group, n) * scale[:ng, None, :]).reshape(rows, n)
    hi = (hi.reshape(ng, group, n) * scale[ng:, None, :]).reshape(rows, n)
    return lo.to(dtype), hi.to(dtype)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activations: ``(xq int8 same shape, sx fp32
    (..., 1))`` with ``x ≈ xq · sx``; a zero row gets scale 1."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(amax > 0, amax / 127.0, 1.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def _idot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 × int4 → int32 product. Float64 holds every partial sum
    exactly (|sum| ≤ 127·8·K ≪ 2⁵³), and unlike an integer matmul it runs
    on the card too."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def int4_matmul_reference(x2, q4, scale, *, group: int) -> torch.Tensor:
    """The plain version of the w4a16 kernel: ``(M, K)`` → ``(M, N)`` in
    x's dtype. Takes validated arguments."""
    k_half = q4.shape[0]
    lo, hi = _dequant_halves(q4, scale, group, x2.dtype)
    acc = x2[:, :k_half].float() @ lo.float() + x2[:, k_half:].float() @ hi.float()
    return acc.to(x2.dtype)


def int4_matmul_w4a8_reference(xq, sx, q4, scale, *, group: int, out_dtype) -> torch.Tensor:
    """The plain version of the w4a8 kernel on per-row int8 activations
    ``xq (M, K)`` with scales ``sx (M, 1)`` → ``(M, N)`` in ``out_dtype``."""
    k_half, n = q4.shape
    p = q4.to(torch.int32)
    lo, hi = (p & 0xF) - 8, (p >> 4) - 8
    if scale.shape[0] == 1:
        acc = _idot(xq[:, :k_half], lo) + _idot(xq[:, k_half:], hi)
        out = acc.float() * scale
    else:
        ng = k_half // group
        out = torch.zeros(xq.shape[0], n, dtype=torch.float32, device=xq.device)
        for g in range(ng):
            rows = slice(g * group, (g + 1) * group)
            hi_rows = slice(k_half + g * group, k_half + (g + 1) * group)
            out = out + _idot(xq[:, rows], lo[rows]).float() * scale[g]
            out = out + _idot(xq[:, hi_rows], hi[rows]).float() * scale[ng + g]
    return (out * sx).to(out_dtype)


def _validate(x, k_half: int, n: int, ng: int, group: int, block_n):
    """The JAX wrapper's layout checks, with its errors → ``(lead, x2)``,
    ``x2`` the ``(M, K)`` contiguous activations. A given
    ``block_n`` (the JAX kernel's column tile) must divide N, as there; the
    CUDA kernel tiles 32 columns per block whatever it is."""
    *lead, k = x.shape
    if k != 2 * k_half:
        raise ValueError(f"x contraction dim {k} != 2 × packed rows {k_half}")
    if ng > 1 and k_half % group:
        raise ValueError(
            f"group {group} must divide half the contraction dim {k_half} "
            f"(split-half packing puts rows r and r + K/2 in one byte)"
        )
    if ng != 1 and ng * group != k:
        raise ValueError(
            f"scale rows {ng} inconsistent with group {group} over K={k}: "
            f"expected K/group = {k // group} groups (or 1 whole-K group). "
            f"The tree was likely quantized with a different group_size."
        )
    if block_n is not None and n % block_n:
        raise ValueError(f"N {n} not divisible by block_n {block_n}")
    m = 1
    for d in lead:
        m *= d
    return lead, x.reshape(m, k).contiguous()


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(
            f"{what} runs on CUDA (the kernel) or the CPU (its plain version), "
            f"got a tensor on {x.device}"
        )
    return True


def _check_cuda(what: str, x: torch.Tensor, **tensors: torch.Tensor) -> None:
    """What the kernels take: one device, contiguous; packed weights uint8
    (4-byte aligned) and scales fp32 (16-byte aligned), N a multiple of 4
    (one 32-bit word of 4 columns per thread); row scales fp32."""
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        want, align = {"q4": (torch.uint8, 4), "sc": (torch.float32, 16)}.get(
            name[:2], (torch.float32, 4))
        if t.dtype != want:
            raise ValueError(f"{what}: {name} is {t.dtype}, want {want}")
        if t.data_ptr() % align:
            raise ValueError(f"{what}: {name} must be {align}-byte aligned")
        if name[:2] in ("q4", "sc") and t.shape[-1] % 4:
            raise ValueError(f"{what} kernel needs N a multiple of 4, got {t.shape[-1]}")


@functools.cache
def _kernel_entries():
    """The C entry points of ``csrc/int4_matmul.cu``, typed for ctypes."""
    lib = load_library("int4_matmul")
    w4a16 = lib.int4_matmul_launch
    w4a16.restype = ctypes.c_int
    w4a16.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    w4a8 = lib.int4_matmul_w4a8_launch
    w4a8.restype = ctypes.c_int
    w4a8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return {"w4a16": w4a16, "w4a8": w4a8}


def _launch_w4a16(x2, weights, *, group: int) -> list[torch.Tensor]:
    """One launch of the w4a16 kernel over one (``int4_matmul``) or three
    (``int4_matmul3``) same-shape packed weights."""
    what = "int4_matmul3" if len(weights) == 3 else "int4_matmul"
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16 x, got {x2.dtype}")
    tensors = {}
    for i, (q4, scale) in enumerate(weights):
        tensors.update({f"q4_{i}": q4, f"scale_{i}": scale})
    _check_cuda(what, x2, **tensors)
    m, k = x2.shape
    n, ng = weights[0][0].shape[1], weights[0][1].shape[0]
    outs = [torch.empty(m, n, dtype=x2.dtype, device=x2.device) for _ in weights]
    pointers = []   # three (q4, scale, out) slots; one weight fills all three
    for (q4, scale), out in (list(zip(weights, outs)) * 3)[:3]:
        pointers += [q4.data_ptr(), scale.data_ptr(), out.data_ptr()]
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = _kernel_entries()["w4a16"](
            x2.data_ptr(), *pointers, _DTYPE_CODES[x2.dtype], len(weights),
            m, k, n, ng, group, stream,
        )
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: error {err}")
    return outs


def _launch_w4a8(xq, sx, q4, scale, *, group: int, out_dtype) -> torch.Tensor:
    """One launch of the w4a8 kernel; its layout limits raise here."""
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int4_matmul w4a8 kernel writes float32 or bfloat16, got {out_dtype}")
    _check_cuda("int4_matmul w4a8", xq, q4=q4, scale=scale, sx=sx)
    m, k = xq.shape
    n, ng = q4.shape[1], scale.shape[0]
    rows = k // 2 if ng == 1 else group
    if k % 8 or rows % 4:
        raise ValueError(
            f"int4_matmul w4a8 kernel needs K a multiple of 8 and groups of a "
            f"multiple of 4 packed rows (4-row int8 dot products), got K={k}, "
            f"group {group}"
        )
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _kernel_entries()["w4a8"](
            xq.data_ptr(), sx.data_ptr(), q4.data_ptr(), scale.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[out_dtype], m, k, n, ng, group, stream,
        )
    if err != 0:
        raise RuntimeError(f"int4_matmul w4a8 kernel launch failed: error {err}")
    return out


def int4_matmul(
    x: torch.Tensor,
    q4: torch.Tensor,
    scale: torch.Tensor,
    *,
    group: int = 128,
    block_n: int | None = None,
    w4a8: bool = False,
) -> torch.Tensor:
    """``x @ dequant(q4, scale)`` without materializing the weights.

    Args:
        x: ``(..., K)`` activations (float32 or bfloat16 on the card).
        q4: ``(K/2, N)`` split-half packed nibbles (uint8).
        scale: ``(K/group, N)`` fp32 group scales (``(1, N)`` for one group
            over all of K).
        group: contraction rows per scale group (must divide K/2, or cover
            all of K).
        block_n: the JAX kernel's column tile; when given it must divide
            N, as there. The CUDA kernel tiles 32 columns per block.
        w4a8: quantize the activations per row to int8 and contract int8 ×
            int4 → int32 per scale group.

    Returns:
        ``(..., N)`` in ``x.dtype``.
    """
    k_half, n = q4.shape
    ng = scale.shape[0]
    lead, x2 = _validate(x, k_half, n, ng, group, block_n)
    cuda = _on_cuda(x, "int4_matmul")
    if w4a8:
        xq, sx = quantize_rows_int8(x2)
        if cuda:
            out = _launch_w4a8(xq, sx, q4, scale, group=group, out_dtype=x.dtype)
            int4_matmul.launches["w4a8"] += 1
        else:
            out = int4_matmul_w4a8_reference(xq, sx, q4, scale, group=group, out_dtype=x.dtype)
    elif cuda:
        (out,) = _launch_w4a16(x2, [(q4, scale)], group=group)
        int4_matmul.launches["w4a16"] += 1
    else:
        out = int4_matmul_reference(x2, q4, scale, group=group)
    return out.reshape(*lead, n)


#: Kernel launches since the last reset, by kernel; the wrapper adds one per launch.
int4_matmul.launches = {"w4a16": 0, "w4a8": 0}


def int4_matmul3(
    x: torch.Tensor,
    weights: list[tuple[torch.Tensor, torch.Tensor]],
    *,
    group: int = 128,
    block_n: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Three same-shape fused dequant-matmuls of one input in one kernel
    launch: the attention q/k/v triple.

    Args:
        x: ``(..., K)`` activations.
        weights: three ``(q4, scale)`` pairs, all ``(K/2, N)`` /
            ``(K/group or 1, N)`` with the same N (MHA).
        group / block_n: as :func:`int4_matmul`.

    Returns:
        Three ``(..., N)`` tensors in ``x.dtype``.
    """
    if len(weights) != 3:
        raise ValueError(f"int4_matmul3 takes exactly 3 weights, got {len(weights)}")
    k_half, n = weights[0][0].shape
    ng = weights[0][1].shape[0]
    for q4, scale in weights:
        if tuple(q4.shape) != (k_half, n):
            raise ValueError(
                f"all packed weights must share one shape; got {tuple(q4.shape)} "
                f"vs {(k_half, n)}"
            )
        if scale.shape[0] != ng:
            raise ValueError("all three scales must share one group layout")
    lead, x2 = _validate(x, k_half, n, ng, group, block_n)
    if _on_cuda(x, "int4_matmul3"):
        outs = _launch_w4a16(x2, list(weights), group=group)
        int4_matmul3.launches += 1
    else:
        outs = [int4_matmul_reference(x2, q4, s, group=group) for q4, s in weights]
    return tuple(o.reshape(*lead, n) for o in outs)


#: Kernel launches since the last reset; the wrapper adds one per launch.
int4_matmul3.launches = 0


def make_int4_matmul_fn(mesh, rules, *, w4a8: bool = False):
    """The mesh-aware (tensor-parallel) int4 matmul of the JAX package."""
    raise NotImplementedError(
        "make_int4_matmul_fn (tensor-parallel int4 serving over a mesh): "
        "ported with slice A (the sharding lessons)"
    )
