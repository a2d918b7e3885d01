"""Whole-FF fused int4: up-project → GELU → down-project in one call. The
CUDA kernels' wrapper and their plain PyTorch versions.

Port of ``learning_jax_sharding_tpu/ops/int4_ff.py``: ``gelu(x @ W1) @ W2``
with both weights int4-packed (``models/quantize.py::quantize_leaf_int4``).
Numerics, as the TPU kernel: the up weights round to x's dtype, ``u`` and the
GELU (tanh) stay in fp32, the down weights stay fp32 (not rounded), the down
product sums in fp32, and the output is written in x's dtype. That differs
from the per-projection path (which rounds the hidden activation to x's
dtype), so which path a layer takes is decided exactly as in JAX
(:func:`int4_ff_eligible`).

For CUDA tensors :func:`int4_ff` launches the hand-written kernels of
``csrc/int4_ff.cu`` (built at first use); for CPU tensors it runs
:func:`int4_ff_reference`, which the tests hold against the JAX kernel.
Nothing falls back from one to the other. Inference only.

The source has three designs, and :func:`_design` picks one by shape before
the launch: ``"small_m"`` (bf16 x, up to ``SMALL_M_ROWS`` rows: the token
steps of generation and of the engine) runs both products on the tensor
cores in one launch, the blocks' partials summed through a cluster's
distributed shared memory and then by the last cluster to finish;
``"tensor_core"`` (bf16 x past those rows: the prefill, M = 1024, and the
engine's refill chunks, M = 512) runs the up product with the GELU in one
launch and the down product in a second, ``u`` passing between them as three
bf16 parts; ``"cuda_core"`` (fp32 x, and the layouts the other two do not
take) is the first design. Both tensor-core designs keep the down product
exact in fp32: ``u`` is cut into three bf16 parts that add up to it exactly
(:func:`split_parts`), the weights' integers ``q - 8`` are exact in bf16, so
every product is exact and each scale group's sum is scaled after it ends
(:func:`int4_ff_split_reference` is their plain version).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library
from learning_jax_sharding_tpu_torch.ops.int4_matmul import (
    _DTYPE_CODES,
    SMALL_M_ROWS,
    TENSOR_CORE_DEPTH,
    _aligned,
    _check_cuda,
    _dequant_halves,
    _on_cuda,
    _sm_count,
    _tile_rows,
)

# The CUDA-core design: packed down rows per block, a multiple of 16
# (32-column up chunks), grown from 16 by doubling until the fp32 partials of
# all blocks fit this size.
_MIN_ROWS_PER_BLOCK = 16
_PARTIAL_BYTES = 64 << 20
#: The small-M design: packed down rows a block (its 32 hidden units are one
#: up tile), and the most blocks a cluster.
SMALL_M_PAIRS, MAX_CLUSTER = 16, 8
#: The tensor-core design's down launch: rows of x and output columns a
#: block (two blocks fit an SM); it splits the scale groups into pieces
#: (whole groups each) until its grid holds DOWN_BLOCKS_PER_SM blocks an SM
#: (fitted to an H100 sweep of the 125M FF at M = 8 to 1024: short of it
#: SMs idle; a grid just past whole waves of two blocks an SM, three pieces
#: at M = 512, leaves its last wave's few blocks running alone).
DOWN_TILE_ROWS, DOWN_TILE_COLS, DOWN_BLOCKS_PER_SM = 32, 128, 2.5


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


def split_parts(u: torch.Tensor) -> torch.Tensor:
    """fp32 ``u`` → ``(3, *u.shape)`` bf16 parts whose fp32 sum is ``u``
    exactly: each part is the bf16 rounding of what the parts before it
    leave (8 + 8 + 8 significant bits carry fp32's 24)."""
    parts, rest = [], u
    for _ in range(3):
        part = rest.to(torch.bfloat16)
        parts.append(part)
        rest = rest - part.float()
    return torch.stack(parts)


def int4_ff_split_reference(x2, q4_up, s_up, q4_dn, s_dn, *, group: int) -> torch.Tensor:
    """The plain version of the tensor-core designs' arithmetic: the up
    product as :func:`int4_ff_reference`'s, u through the GELU in fp32 and
    cut into :func:`split_parts`; then for each scale group of the down
    weights in order, the parts times the integers ``q - 8`` of the group's
    packed rows, summed in fp32 (every product exact) apart for the low
    nibbles' group and the high nibbles', each multiplied by its scale and
    added into the total, the low one first. Takes validated arguments."""
    k_half, hidden = q4_up.shape
    k, h_half = 2 * k_half, hidden // 2
    up_lo, up_hi = _dequant_halves(q4_up, s_up, min(group, k), x2.dtype)
    u = x2[:, :k_half].float() @ up_lo.float() + x2[:, k_half:].float() @ up_hi.float()
    parts = split_parts(torch.nn.functional.gelu(u, approximate="tanh")).float()
    q = q4_dn.to(torch.int32)
    ints = (((q & 0xF) - 8).float(), ((q >> 4) - 8).float())
    ng = s_dn.shape[0]
    rows = h_half if ng == 1 else min(group, hidden)
    total = torch.zeros(x2.shape[0], q4_dn.shape[1], dtype=torch.float32, device=x2.device)
    for gi in range(h_half // rows):
        r0, r1 = gi * rows, (gi + 1) * rows
        for half, s_row in ((0, 0 if ng == 1 else gi), (1, 0 if ng == 1 else ng // 2 + gi)):
            u0 = half * h_half
            acc = sum(p[:, u0 + r0:u0 + r1] @ ints[half][r0:r1] for p in parts)
            total = total + acc * s_dn[s_row]
    return total.to(x2.dtype)


def _layout(k: int, hidden: int, group: int) -> tuple[int, int, int, int]:
    """``(ng_up, g_up, ng_dn, g_dn)``: the scale rows and groups of both
    weights as ``quantize_leaf_int4`` lays them out."""
    g_up, g_dn = min(group, k), min(group, hidden)
    return (1 if g_up == k else k // g_up, g_up, 1 if g_dn == hidden else hidden // g_dn, g_dn)


@functools.cache
def _small_m_layout(k: int, hidden: int, group: int) -> bool:
    """Whether the small-M design takes these shapes: K/2 in whole 32-row
    chunks, each in one up group; H/2 in whole blocks of ``SMALL_M_PAIRS``
    packed rows, each in one down group of each half."""
    ng_up, g_up, ng_dn, g_dn = _layout(k, hidden, group)
    return ((k // 2) % TENSOR_CORE_DEPTH == 0 and (ng_up == 1 or g_up % TENSOR_CORE_DEPTH == 0)
            and (hidden // 2) % SMALL_M_PAIRS == 0 and (ng_dn == 1 or g_dn % SMALL_M_PAIRS == 0))


@functools.cache
def _tensor_core_layout(k: int, hidden: int, group: int) -> bool:
    """Whether the tensor-core design takes these shapes: K/2 and H/2 in
    whole 32-row stages, and each stage of W2 in one down group of each
    half."""
    _, _, ng_dn, g_dn = _layout(k, hidden, group)
    return ((k // 2) % TENSOR_CORE_DEPTH == 0 and (hidden // 2) % TENSOR_CORE_DEPTH == 0
            and (ng_dn == 1 or g_dn % TENSOR_CORE_DEPTH == 0))


@functools.cache
def _design(m: int, k: int, hidden: int, group: int, dtype: torch.dtype, sms: int) -> str:
    """Which design takes an ``(m, k)`` FF launch through ``hidden`` units
    with quantization ``group`` on a card of ``sms`` SMs: ``"small_m"`` for
    bf16 x of up to ``SMALL_M_ROWS`` rows where :func:`_small_m_layout`
    holds; ``"tensor_core"`` for bf16 x where :func:`_tensor_core_layout`
    holds; else ``"cuda_core"``. A choice made before the launch: nothing
    falls back. ``sms`` does not enter: an H100 sweep of the 125M FF at 8 to
    1024 rows found no grid size at which another design wins (at 32 rows
    the tensor-core and CUDA-core designs tie; from 64 the tensor-core one
    wins). Cached: it runs before every decode launch."""
    del sms
    if dtype != torch.bfloat16:
        return "cuda_core"
    if m <= SMALL_M_ROWS and _small_m_layout(k, hidden, group):
        return "small_m"
    return "tensor_core" if _tensor_core_layout(k, hidden, group) else "cuda_core"


@functools.cache
def _cluster(k: int, hidden: int) -> int:
    """Blocks a small-M cluster: the most, up to ``MAX_CLUSTER``, that divide
    the grid (H/2 / ``SMALL_M_PAIRS`` blocks) and leave each rank a slice of
    whole 4-column groups of K (``int4_ff_small_m_kernel``'s rule)."""
    blocks, c = hidden // 2 // SMALL_M_PAIRS, MAX_CLUSTER
    while c > 1 and (blocks % c or (k // c) % 4):
        c //= 2
    return c


def _down_tiles(m: int, k: int) -> int:
    """Output tiles of the tensor-core down launch: its grid before the
    split, and the counters it needs."""
    return -(-m // DOWN_TILE_ROWS) * -(-k // DOWN_TILE_COLS)


@functools.cache
def down_split_choices(k: int, hidden: int, group: int) -> tuple[int, ...]:
    """Every split of the down launch: the divisors of the scale groups of
    a half (one piece for a whole-H group), so each piece takes whole
    groups."""
    _, _, ng_dn, _ = _layout(k, hidden, group)
    groups = 1 if ng_dn == 1 else ng_dn // 2
    return tuple(d for d in range(1, groups + 1) if groups % d == 0)


@functools.cache
def _down_splits(m: int, k: int, hidden: int, group: int, sms: int) -> int:
    """Pieces the tensor-core down launch cuts the scale groups into: the
    fewest of :func:`down_split_choices` whose grid reaches
    ``DOWN_BLOCKS_PER_SM`` blocks an SM, else the most."""
    tiles, choices = _down_tiles(m, k), down_split_choices(k, hidden, group)
    return next((d for d in choices if tiles * d >= DOWN_BLOCKS_PER_SM * sms), choices[-1])


@functools.cache
def _kernel_entries():
    """The C entry points of ``csrc/int4_ff.cu``, typed for ctypes."""
    lib = load_library("int4_ff")
    cuda_core = lib.int4_ff_launch
    cuda_core.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    small_m = lib.int4_ff_small_m_launch
    small_m.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    tensor_core = lib.int4_ff_tc_launch
    tensor_core.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    entries = {"cuda_core": cuda_core, "small_m": small_m, "tensor_core": tensor_core}
    for fn in entries.values():
        fn.restype = ctypes.c_int
    return entries


_counters: dict[tuple[int, int], torch.Tensor] = {}


def _zero_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device`` for launches on ``stream``:
    the small-M design's slice counters, the split down launch's tile
    counters and the fused-norm backward's slice counters
    (``ops/fused_norm.py``). Every launch leaves them zero (the last block to
    arrive resets its counter), so one buffer serves every launch in stream
    order."""
    key = (device.index, stream)
    if key not in _counters or _counters[key].numel() < n:
        _counters[key] = torch.zeros(max(n, MAX_CLUSTER), dtype=torch.int32, device=device)
    return _counters[key]


def rows_per_block(m: int, k: int, hidden: int) -> int:
    """The CUDA-core design's packed down rows (hidden pairs) per block: 16,
    doubled while the blocks' fp32 partials ``(H/2 / P) · M · K`` would pass
    64 MiB."""
    h_half = hidden // 2
    p = _MIN_ROWS_PER_BLOCK
    while (h_half // p) * m * k * 4 > _PARTIAL_BYTES and h_half % (2 * p) == 0:
        p *= 2
    return p


def _launch_cuda(x2, q4_up, s_up, q4_dn, s_dn, *, group: int, design: str | None = None,
                 up_rows: int | None = None, down_splits: int | None = None
                 ) -> tuple[torch.Tensor, str]:
    """Check what the kernels take, then launch ``design`` (by default
    :func:`_design`'s) on the current stream → ``(out, design)``. The
    tensor-core design's up block takes ``up_rows`` rows of x (by default
    ``int4_matmul``'s :func:`_tile_rows`), its down launch ``down_splits``
    pieces (by default :func:`_down_splits`'s). A yardstick's override of
    the design or tiles raises here when the shape does not fit it."""
    m, k = x2.shape
    hidden = q4_up.shape[1]
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"int4_ff kernel takes float32 or bfloat16 x, got {x2.dtype}")
    _check_cuda("int4_ff", x2, q4_up=q4_up, scale_up=s_up, q4_dn=q4_dn, scale_dn=s_dn)
    sms = _sm_count(x2.device.index)
    design = design or _design(m, k, hidden, group, x2.dtype, sms)
    ng_up, g_up, ng_dn, g_dn = s_up.shape[0], min(group, k), s_dn.shape[0], min(group, hidden)
    if design == "small_m":
        fits = m <= SMALL_M_ROWS and _small_m_layout(k, hidden, group)
    elif design == "tensor_core":
        fits = _tensor_core_layout(k, hidden, group)
    elif design == "cuda_core":
        fits = (hidden // 2) % _MIN_ROWS_PER_BLOCK == 0
    else:
        raise ValueError(f"int4_ff has no design {design!r}")
    if not fits or (design != "cuda_core" and x2.dtype != torch.bfloat16):
        raise ValueError(f"int4_ff {design} design cannot take {x2.dtype} x of M={m}, K={k}, "
                         f"H={hidden}, group={group}")
    if design == "tensor_core":
        up_rows = up_rows or _tile_rows(m, hidden, 1, sms)
        down_splits = down_splits or _down_splits(m, k, hidden, group, sms)
        if down_splits not in down_split_choices(k, hidden, group):
            raise ValueError(f"int4_ff down split {down_splits} is not one of "
                             f"{down_split_choices(k, hidden, group)}")
    if design != "cuda_core":
        x2 = _aligned(x2)
    out = torch.empty(m, k, dtype=x2.dtype, device=x2.device)
    pointers = (x2.data_ptr(), q4_up.data_ptr(), s_up.data_ptr(), q4_dn.data_ptr(),
                s_dn.data_ptr())
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        if design == "small_m":
            cluster = _cluster(k, hidden)
            ws = torch.empty(hidden // 2 // SMALL_M_PAIRS // cluster, m, k, dtype=torch.float32,
                             device=x2.device)
            counters = _zero_counters(x2.device, stream, cluster)
            err = _kernel_entries()["small_m"](
                *pointers, ws.data_ptr(), counters.data_ptr(), out.data_ptr(), m, k, hidden,
                ng_up, g_up, ng_dn, g_dn, cluster, stream)
        elif design == "tensor_core":
            u = torch.empty(m, 3 * hidden, dtype=torch.bfloat16, device=x2.device)
            ws = torch.empty(down_splits if down_splits > 1 else 0, m, k, dtype=torch.float32,
                             device=x2.device)
            counters = _zero_counters(x2.device, stream, _down_tiles(m, k))
            err = _kernel_entries()["tensor_core"](
                *pointers, u.data_ptr(), ws.data_ptr(), counters.data_ptr(), out.data_ptr(), m,
                k, hidden, ng_up, g_up, ng_dn, g_dn, up_rows, down_splits, stream)
        else:
            p = rows_per_block(m, k, hidden)
            partial = torch.empty(hidden // 2 // p, m, k, dtype=torch.float32,
                                  device=x2.device)
            err = _kernel_entries()["cuda_core"](
                *pointers, partial.data_ptr(), out.data_ptr(), _DTYPE_CODES[x2.dtype], m, k,
                hidden, ng_up, g_up, ng_dn, g_dn, p, stream)
    if err != 0:
        raise RuntimeError(f"int4_ff {design} kernel launch failed: error {err}")
    return out, design


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
            there and does not change the result. The CUDA kernels pick
            their own design (:func:`_design`) and tiles.

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
        out, launched = _launch_cuda(x2, q4_up, s_up, q4_dn, s_dn, group=group)
        int4_ff.launches += 1
        int4_ff.small_m_launches += launched == "small_m"
        int4_ff.tensor_core_launches += launched == "tensor_core"
    else:
        out = int4_ff_reference(x2, q4_up, s_up, q4_dn, s_dn, group=group)
    return out.reshape(*lead, k)


#: Kernel launches since the last reset (every design; a tensor-core
#: launch is its up and down kernels), and the small-M and tensor-core
#: designs' among them; the wrapper adds one per launch.
int4_ff.launches = 0
int4_ff.small_m_launches = 0
int4_ff.tensor_core_launches = 0
