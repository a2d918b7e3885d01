"""The probe kernels: a one-block copy, a one-call matmul at decode rows and
the flash block's ablation. The CUDA kernels' wrappers and their plain
PyTorch versions.

Port of the six Pallas launch sites of the JAX package's probe scripts:
``scripts/perf_call_floor.py`` (``copy_kernel`` launched as ``noop``, and
``mm_kernel`` launched as ``pmm`` and in ``four_calls``),
``scripts/perf_launch_audit.py`` (``copy_kernel`` as ``noop``) and
``scripts/perf_flash_ceiling.py`` / ``perf_flash_ceiling2.py``
(``_ablate_kernel``). Three kernel bodies in ``csrc/probes.cu``:

* :func:`copy_probe`: an ``(8, 128)`` bf16 copy in one block, the price of
  a launch with no work;
* :func:`matmul_probe`: ``x @ w`` for up to 8 rows of bf16 x, fp32 sums, a
  bf16 output; ``w`` and ``out`` may be column slices of larger matrices,
  so the four-call form writes one output without a copy;
* :func:`ablate_probe`: per block of ``block`` rows, ``softmax(q kᵀ) v``
  with no scale (``"full"``), its exponentials knocked out (``"noexp"``:
  ``p = (s − m) / Σ(s − m)``) or its whole softmax (``"dots"``: ``p = s``),
  on the bf16 flash forward's loop; the time differences between the modes
  split the flash block between the softmax and the products. noexp's end
  correction reads the column sums of v, :func:`column_sums` (a kernel of
  its own in the same source).

For CUDA tensors each wrapper launches its kernel (built at first use) and
counts the launch; for CPU tensors it runs the plain version. Nothing falls
back from one to the other. The ablation's kernel rounds ``p`` to bf16
before dividing by the row sum (the flash forward's order), where the TPU
kernel divides first: :func:`ablate_probe_online_reference` computes the
kernel's order, and the tests hold it to :func:`ablate_probe_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library
from learning_jax_sharding_tpu_torch.ops.int4_matmul import _on_cuda, _sm_count

#: The ablation's modes, as the kernel's template argument.
ABLATE_MODES = {"full": 0, "noexp": 1, "dots": 2}
#: Keys a tile of the ablation's loop, by head dim: the bf16 flash forward's
#: tiles (``flash_fwd_tc_kernel<64, 64, 4>``, ``<128, 32, 3>``).
ABLATE_KEY_TILE = {64: 64, 128: 32}
#: Rows of q a block of the ablation kernel takes: ``block`` is a multiple.
ABLATE_ROWS = 64
#: The matmul kernel's limits: rows of x, and the multiple K must be (8
#: warps a block, each a piece of whole 32-row stages).
MATMUL_MAX_ROWS, MATMUL_K_MULTIPLE = 8, 256
_LOG2E = 1.4426950408889634


@functools.cache
def _kernel_entries():
    """The C entry points of ``csrc/probes.cu``, typed for ctypes."""
    lib = load_library("probes")
    copy = lib.probe_copy_launch
    copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    matmul = lib.probe_matmul_launch
    matmul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    ablate = lib.probe_ablate_launch
    ablate.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    colsum = lib.probe_colsum_launch
    colsum.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    entries = {"copy": copy, "matmul": matmul, "ablate": ablate, "colsum": colsum}
    for fn in entries.values():
        fn.restype = ctypes.c_int
    return entries


def _check_cuda(name: str, **tensors: torch.Tensor) -> None:
    """What the kernels take: bf16 tensors on one CUDA device, 16-byte
    aligned."""
    device = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} is {t.dtype}, the kernel takes bfloat16")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")


# ---------------------------------------------------------------- copy

def copy_probe_reference(x: torch.Tensor) -> torch.Tensor:
    """The copy kernel's plain version: a copy."""
    return x.clone()


def copy_probe(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` copied into ``out`` (a new tensor by default) by one launch of
    ``probe_copy_kernel``: one block of 128 threads, 16 bytes a thread, at
    the probe's (8, 128) bf16. ``x`` and ``out`` contiguous, whole 16-byte
    chunks."""
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape or out.dtype != x.dtype:
        raise ValueError(f"copy_probe: out {tuple(out.shape)} {out.dtype}, x {tuple(x.shape)} "
                         f"{x.dtype}")
    if not _on_cuda(x, "copy_probe"):
        out.copy_(copy_probe_reference(x))
        return out
    _check_cuda("copy_probe", x=x, out=out)
    nbytes = x.numel() * x.element_size()
    if not (x.is_contiguous() and out.is_contiguous()) or nbytes % 16:
        raise ValueError("copy_probe: contiguous tensors of whole 16-byte chunks")
    with torch.cuda.device(x.device):
        err = _kernel_entries()["copy"](x.data_ptr(), out.data_ptr(), nbytes // 16, _stream(x))
    _raise_on(err, "copy_probe")
    copy_probe.launches += 1
    return out


# ---------------------------------------------------------------- matmul

def matmul_probe_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The matmul kernel's plain version: ``x @ w`` summed in fp32, in x's
    dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def matmul_columns(n: int, sms: int) -> int:
    """Output columns a block of ``probe_matmul_kernel`` takes for ``n``
    columns on ``sms`` SMs: 32 while that leaves at least a block an SM
    (N = 8192: 256 blocks, two an SM), else 16 (N = 2048: 128 blocks where
    32 columns would leave half the SMs idle)."""
    return 32 if -(-n // 32) >= sms else 16


def matmul_probe(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` → ``(M, N)`` bf16 by one launch of
    ``probe_matmul_kernel``: M ≤ 8 rows, K a multiple of 256, fp32 sums.
    ``w`` and ``out`` may be column slices of larger matrices (unit column
    stride, a row stride and N that are multiples of 8): four calls on
    ``w[:, j·n:(j+1)·n]`` into ``out[:, j·n:(j+1)·n]`` compute one product
    with four launches and no copy."""
    m, k = x.shape
    k_w, n = w.shape
    if k_w != k:
        raise ValueError(f"matmul_probe: x {tuple(x.shape)} against w {tuple(w.shape)}")
    if out is None:
        out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if out.shape != (m, n):
        raise ValueError(f"matmul_probe: out {tuple(out.shape)}, want {(m, n)}")
    if not _on_cuda(x, "matmul_probe"):
        out.copy_(matmul_probe_reference(x, w))
        return out
    _check_cuda("matmul_probe", w=w, out=out)
    if x.device != w.device or x.dtype != torch.bfloat16 or not x.is_contiguous() or \
            x.data_ptr() % 4:
        raise ValueError("matmul_probe: x must be contiguous, 4-byte aligned bfloat16 on w's "
                         "device")
    if not 1 <= m <= MATMUL_MAX_ROWS or k % MATMUL_K_MULTIPLE or n % 8:
        raise ValueError(f"matmul_probe takes 1..{MATMUL_MAX_ROWS} rows, K a multiple of "
                         f"{MATMUL_K_MULTIPLE} and N of 8, got M={m}, K={k}, N={n}")
    if w.stride(1) != 1 or w.stride(0) % 8 or out.stride(1) != 1:
        raise ValueError("matmul_probe: w and out need unit column strides, w a row stride "
                         "that is a multiple of 8")
    bn = matmul_columns(n, _sm_count(x.device.index))
    with torch.cuda.device(x.device):
        err = _kernel_entries()["matmul"](x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                                          w.stride(0), out.stride(0), bn, _stream(x))
    _raise_on(err, "matmul_probe")
    matmul_probe.launches += 1
    return out


# ---------------------------------------------------------------- ablation

def _blocks(q, k, v, block):
    """(blocks, block, h) fp32 views of q, k, v after checking their shapes."""
    n, h = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ablate_probe: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if block < 1 or n % block:
        raise ValueError(f"ablate_probe: {n} rows are not whole blocks of {block}")
    return [t.float().reshape(n // block, block, h) for t in (q, k, v)]


def ablate_probe_reference(q, k, v, *, block: int, mode: str) -> torch.Tensor:
    """The TPU kernel's function on ``(blocks · block, h)`` q, k, v: per
    block ``s = q kᵀ`` in fp32 (no scale); ``"full"``: ``p = softmax(s)``;
    ``"noexp"``: ``p = (s − m) / Σ(s − m)``; ``"dots"``: ``p = s``; then
    ``p`` rounded to v's dtype and ``p @ v`` in fp32, in q's dtype."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"ablate_probe mode {mode!r} is not one of {list(ABLATE_MODES)}")
    qb, kb, vb = _blocks(q, k, v, block)
    s = qb @ kb.transpose(1, 2)
    if mode == "full":
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
    elif mode == "noexp":
        p = s - s.amax(-1, keepdim=True)
        p = p / p.sum(-1, keepdim=True)
    else:
        p = s
    out = p.to(v.dtype).float() @ vb
    return out.to(q.dtype).reshape(q.shape)


def ablate_probe_online_reference(q, k, v, *, block: int, mode: str) -> torch.Tensor:
    """The ablation kernel's own order, on the CPU: ``"full"`` as the bf16
    flash forward at scale 1 (key tiles of ``ABLATE_KEY_TILE[h]``, a running
    max in log2 units, unnormalised ``p`` rounded to bf16 before ``p·V``,
    the accumulator rescaled as the max moves, divided by the row sum at the
    end); ``"noexp"`` with ``p = s − c`` rounded to bf16, ``c`` the row's
    max over the first key tile, and the moving max corrected additively
    at the end, ``Σ(s − m)v = Σ(s − c)v − (m − c)Σv``; ``"dots"`` as the
    plain version."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"ablate_probe mode {mode!r} is not one of {list(ABLATE_MODES)}")
    qb, kb, vb = _blocks(q, k, v, block)
    h = q.shape[1]
    bk = ABLATE_KEY_TILE[h]
    s = qb @ kb.transpose(1, 2)

    def bf16(x):
        return x.to(v.dtype).float()

    if mode == "full":
        acc = torch.zeros_like(qb)
        m = torch.full(s.shape[:2] + (1,), -1e30, device=s.device)
        l = torch.zeros_like(m)
        for c0 in range(0, block, bk):
            tile = s[..., c0:c0 + bk]
            m_new = torch.maximum(m, tile.amax(-1, keepdim=True) * _LOG2E)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(tile * _LOG2E - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + bf16(p) @ vb[:, c0:c0 + bk]
            m = m_new
        out = acc / l
    elif mode == "noexp":
        c = s[..., :bk].amax(-1, keepdim=True)
        m = s.amax(-1, keepdim=True)
        p = s - c
        acc = bf16(p) @ vb - (m - c) * vb.sum(1, keepdim=True)
        out = acc / (p.sum(-1, keepdim=True) - block * (m - c))
    else:
        out = bf16(s) @ vb
    return out.to(q.dtype).reshape(q.shape)


def ablate_flops(blocks: int, block: int, h: int) -> int:
    """The two products of the ablation: ``2 · block² · h`` each, a block."""
    return blocks * 2 * 2 * block * block * h


def column_sums_reference(v: torch.Tensor, block: int) -> torch.Tensor:
    """The column-sum kernel's plain version: ``(blocks, h)`` fp32 sums of
    each block's rows of ``v``."""
    n, h = v.shape
    return v.float().reshape(n // block, block, h).sum(1)


def column_sums(v: torch.Tensor, block: int) -> torch.Tensor:
    """``(blocks, h)`` fp32 column sums of each ``block``-row block of
    ``v`` by one launch of ``probe_colsum_kernel``: the ``Σv`` that the
    ablation's noexp end correction reads."""
    n, h = v.shape
    if block < 1 or n % block:
        raise ValueError(f"column_sums: {n} rows are not whole blocks of {block}")
    if not _on_cuda(v, "column_sums"):
        return column_sums_reference(v, block)
    _check_cuda("column_sums", v=v)
    if h not in ABLATE_KEY_TILE or not v.is_contiguous():
        raise ValueError(f"column_sums takes contiguous (rows, 64 or 128) bf16, got "
                         f"{tuple(v.shape)}")
    vsum = torch.empty(n // block, h, dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        err = _kernel_entries()["colsum"](v.data_ptr(), vsum.data_ptr(), n // block, block, h,
                                          _stream(v))
    _raise_on(err, "column_sums")
    column_sums.launches += 1
    return vsum


def ablate_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block: int, mode: str,
                 out: torch.Tensor | None = None, vsum: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The ablation over ``(blocks · block, h)`` bf16 q, k, v (h 64 or 128,
    ``block`` a multiple of 64) by one launch of ``probe_ablate_kernel`` in
    ``mode``. ``"noexp"`` reads the column sums of v (``vsum``, from
    :func:`column_sums`; launched here first when None). → ``(blocks ·
    block, h)`` bf16."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"ablate_probe mode {mode!r} is not one of {list(ABLATE_MODES)}")
    n, h = q.shape
    if out is None:
        out = torch.empty_like(q)
    if not _on_cuda(q, "ablate_probe"):
        out.copy_(ablate_probe_reference(q, k, v, block=block, mode=mode))
        return out
    _check_cuda("ablate_probe", q=q, k=k, v=v, out=out)
    if h not in ABLATE_KEY_TILE or block % ABLATE_ROWS or n % block or not all(
            t.is_contiguous() and t.shape == q.shape for t in (k, v, out)):
        raise ValueError(f"ablate_probe takes contiguous (blocks · block, 64 or 128) tensors of "
                         f"one shape, block a multiple of {ABLATE_ROWS}; got q "
                         f"{tuple(q.shape)}, block {block}")
    blocks = n // block
    if mode == "noexp":
        vsum = column_sums(v, block) if vsum is None else vsum
        if (vsum.shape != (blocks, h) or vsum.dtype != torch.float32 or not vsum.is_contiguous()
                or vsum.device != q.device):
            raise ValueError(f"ablate_probe: vsum must be contiguous fp32 {(blocks, h)} on "
                             f"{q.device}")
    vsum_ptr = vsum.data_ptr() if mode == "noexp" else None
    with torch.cuda.device(q.device):
        err = _kernel_entries()["ablate"](q.data_ptr(), k.data_ptr(), v.data_ptr(), vsum_ptr,
                                          out.data_ptr(), blocks, block, h, ABLATE_MODES[mode],
                                          _stream(q))
    _raise_on(err, f"ablate_probe {mode}")
    ablate_probe.launches += 1
    return out


#: Kernel launches since the last reset; each wrapper adds one per launch.
copy_probe.launches = 0
matmul_probe.launches = 0
ablate_probe.launches = 0
column_sums.launches = 0


def reset_launches() -> None:
    copy_probe.launches = matmul_probe.launches = ablate_probe.launches = 0
    column_sums.launches = 0
