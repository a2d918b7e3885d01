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

The source has three designs of each kernel, and :func:`_variant` picks
one by shape before the launch: the small-M design (``mma.sync`` with the
operands swapped: the dequantized weights are the A operand, up to 8 rows
of x the B operand, a warp a 32-column tile of a piece of the packed rows,
split over K by :func:`_splits` into the warps of one block, whose partials
meet in shared memory) for decode and small row counts in bf16 (w4a16) or
int8 (w4a8); the tensor-core design
(``mma.sync``; tiles of 128 or 96 rows (:func:`_tile_rows`) for w4a16, 64
for w4a8, each dequantizing its weight tile once per block) for prefill
rows once the CUDA-core grid outgrows the card; the CUDA-core design (up to
8 rows a block, fp32 FMA or ``dp4a``) for fp32 activations and the layouts
the tensor cores do not take. All three compute the same function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from learning_jax_sharding_tpu_torch.ops._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGN_CODES = {"cuda_core": 0, "tensor_core": 1, "small_m": 2}
#: Rows of a decode step.
DECODE_ROWS = 8
#: Packed rows a tensor-core stage covers, the int8 MMA's depth, and the
#: packed rows of a small-M chunk (the unit its pieces are cut in).
TENSOR_CORE_DEPTH = 32
#: The small-M design: output columns a warp takes, rows of x it takes (the
#: MMA's n; more rows run more row tiles), and the most rows it is chosen
#: for (fitted to H100 timings of every 125M site at M = 8, 16, 32, 64).
SMALL_M_COLS, SMALL_M_TILE_ROWS, SMALL_M_ROWS = 32, 8, 16
#: Its split over K: pieces enough that the grid holds this many warps an
#: SM, at most MAX_SMALL_M_SPLITS, the warps of one block (fitted to an H100
#: sweep of every 125M site at M = 8, 16 and 32).
SMALL_M_WARPS_PER_SM, MAX_SMALL_M_SPLITS = 8, 16
#: Rows of x a tensor-core w4a16 block takes, and its columns.
TILE_ROWS, SMALL_TILE_ROWS, TILE_COLS = 128, 96, 128
#: Output columns and rows of x a CUDA-core block takes.
CUDA_CORE_COLS, CUDA_CORE_ROWS = 32, 8
#: CUDA-core blocks an SM up to which that design keeps its decode time,
#: by w4a8. Past it the design slows with M while the tensor-core one stays
#: flat up to hundreds of rows. Fitted to H100 timings of every 125M site at
#: M = 16, 32 and 64. The w4a16 kernel (64 registers a thread) holds twice
#: the blocks an SM that the w4a8 one (128) does.
CUDA_CORE_BLOCKS_PER_SM = {False: 2, True: 1}


def _tensor_core_layout(k: int, ng: int, group: int, dtype: torch.dtype, w4a8: bool) -> bool:
    """Whether the tensor-core design takes this layout: bf16 (w4a16) or
    int8 (w4a8) activations whose K/2 is a multiple of 32 packed rows
    (whole stages) and, for w4a8, whose groups (or the one whole-K group)
    are too, since a group's int32 partial must end on an MMA's 32 of
    depth."""
    k_half = k // 2
    if k_half % TENSOR_CORE_DEPTH:
        return False
    if w4a8:
        return (k_half if ng == 1 else group) % TENSOR_CORE_DEPTH == 0
    return dtype == torch.bfloat16


def _small_m_layout(k: int, ng: int, group: int, dtype: torch.dtype, w4a8: bool) -> bool:
    """Whether the small-M design takes this layout: bf16 (w4a16) or int8
    (w4a8) activations whose K/2 is whole 32-row chunks and whose groups
    (or the one whole-K group) are too, so that a chunk lies in one group."""
    k_half = k // 2
    if k % 2 or k_half % TENSOR_CORE_DEPTH:
        return False
    if ng != 1 and group % TENSOR_CORE_DEPTH:
        return False
    return w4a8 or dtype == torch.bfloat16


def _variant(m: int, k: int, n: int, ng: int, group: int, dtype: torch.dtype, w4a8: bool,
             sms: int) -> str:
    """Which kernel design takes an ``(m, k) × (k, n)`` launch (``n`` over
    all its weights: 3N for the triple) with ``ng`` scale rows of ``group``
    contraction rows on a card of ``sms`` SMs: ``"small_m"`` for up to
    ``SMALL_M_ROWS`` rows where :func:`_small_m_layout` holds;
    ``"tensor_core"`` where :func:`_tensor_core_layout` holds, there are
    more than ``DECODE_ROWS`` rows, and the CUDA-core grid (N/32 × M/8
    blocks) exceeds ``CUDA_CORE_BLOCKS_PER_SM`` an SM; else
    ``"cuda_core"``. A choice between three kernels by shape, made before
    the launch: nothing falls back."""
    if m <= SMALL_M_ROWS and _small_m_layout(k, ng, group, dtype, w4a8):
        return "small_m"
    if m <= DECODE_ROWS or not _tensor_core_layout(k, ng, group, dtype, w4a8):
        return "cuda_core"
    blocks = -(-n // CUDA_CORE_COLS) * -(-m // CUDA_CORE_ROWS)
    return "tensor_core" if blocks > CUDA_CORE_BLOCKS_PER_SM[w4a8] * sms else "cuda_core"


def _tile_rows(m: int, n: int, nw: int, sms: int) -> int:
    """Rows of x a tensor-core w4a16 block takes for ``nw`` ``(m, ·) ×
    (·, n)`` products on a card of ``sms`` SMs: of 128 and 96, the tile
    whose busiest SM multiplies the fewest rows (its ceil(blocks / sms)
    blocks of that many rows; 128 on a tie). 96 evens out grids of a few
    blocks an SM and pads fewer rows at small M."""
    def load(rows):
        blocks = -(-m // rows) * -(-n // TILE_COLS) * nw
        return -(-blocks // sms) * rows
    return SMALL_TILE_ROWS if load(SMALL_TILE_ROWS) < load(TILE_ROWS) else TILE_ROWS


def _split_groups(k_half: int, ng: int, group: int, w4a8: bool) -> tuple[int, int]:
    """The runs a small-M split cuts along: ``(runs, chunks a run)``. w4a8
    keeps each scale group's int32 sums whole, so its runs are the groups
    (one for a whole-K group); w4a16 cuts anywhere, so its runs are the
    chunks."""
    if k_half % TENSOR_CORE_DEPTH or (ng != 1 and group % TENSOR_CORE_DEPTH):
        raise ValueError(f"a small-M split needs K/2 ({k_half}) and the groups ({group}) "
                         f"in whole {TENSOR_CORE_DEPTH}-row chunks")
    chunks = k_half // TENSOR_CORE_DEPTH
    if not w4a8:
        return chunks, 1
    groups = 1 if ng == 1 else ng // 2
    return groups, chunks // groups


def split_choices(k_half: int, ng: int, group: int, w4a8: bool = False) -> list[int]:
    """Every split a small-M launch over ``k_half`` packed rows takes: up to
    one piece a run (:func:`_split_groups`), then (w4a8) d equal parts of
    every group, at most one a chunk."""
    runs, per_run = _split_groups(k_half, ng, group, w4a8)
    return list(range(1, runs + 1)) + [runs * d for d in range(2, per_run + 1)]


def split_pieces(k_half: int, ng: int, group: int, splits: int,
                 w4a8: bool = False) -> list[tuple[int, int]]:
    """The packed rows ``[r0, r1)`` of each piece of a small-M launch in
    ``splits`` pieces, as the kernel cuts them (``sm::piece_span``): up to
    one piece a run, a piece takes whole runs, as evenly as whole runs
    allow; past that (w4a8) each group is cut into ``splits / groups``
    parts. The plain twin of the device's split."""
    if splits not in split_choices(k_half, ng, group, w4a8):
        raise ValueError(f"split {splits} is not one of {split_choices(k_half, ng, group, w4a8)}")
    runs, per_run = _split_groups(k_half, ng, group, w4a8)
    pieces = []
    for p in range(splits):
        if splits <= runs:
            c0, c1 = p * runs // splits * per_run, (p + 1) * runs // splits * per_run
        else:
            d = splits // runs
            g, j = divmod(p, d)
            c0, c1 = g * per_run + j * per_run // d, g * per_run + (j + 1) * per_run // d
        pieces.append((c0 * TENSOR_CORE_DEPTH, c1 * TENSOR_CORE_DEPTH))
    return pieces


@functools.cache
def _splits(m: int, k: int, n: int, nw: int, ng: int, group: int, sms: int,
            w4a8: bool = False) -> int:
    """Pieces a small-M launch of ``nw`` ``(m, k) × (k, n)`` products cuts
    K into: the fewest of :func:`split_choices` (at most
    ``MAX_SMALL_M_SPLITS``) whose grid of ``nw · ⌈m/8⌉ · ⌈n/32⌉`` warps a
    piece reaches ``SMALL_M_WARPS_PER_SM`` warps an SM, else the most. The
    768-column sites leave 24 warps a piece, the lm_head 1572. Cached: it
    runs before every decode launch."""
    warps = nw * -(-m // SMALL_M_TILE_ROWS) * -(-n // SMALL_M_COLS)
    want = -(-SMALL_M_WARPS_PER_SM * sms // warps)
    choices = [s for s in split_choices(k // 2, ng, group, w4a8) if s <= MAX_SMALL_M_SPLITS]
    return next((s for s in choices if s >= want), choices[-1])


@functools.cache
def _sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def int4_matmul_split_reference(x2, q4, scale, *, group: int, splits: int) -> torch.Tensor:
    """The plain version of a small-M w4a16 launch in ``splits`` pieces
    (:func:`split_pieces`): each piece's fp32 partial over its packed rows,
    then the partials added in piece order, rounded to x's dtype."""
    k_half = q4.shape[0]
    lo, hi = _dequant_halves(q4, scale, group, x2.dtype)
    acc = None
    for r0, r1 in split_pieces(k_half, scale.shape[0], group, splits):
        part = (x2[:, r0:r1].float() @ lo[r0:r1].float()
                + x2[:, k_half + r0:k_half + r1].float() @ hi[r0:r1].float())
        acc = part if acc is None else acc + part
    return acc.to(x2.dtype)


def int4_matmul_w4a8_split_reference(xq, sx, q4, scale, *, group: int, splits: int,
                                     out_dtype) -> torch.Tensor:
    """The plain version of a small-M w4a8 launch in ``splits`` pieces: per
    piece and scale group it touches, the exact int32 sums of the low and
    high halves (a slot in the block's shared memory: the group, or the
    piece past one piece a group); then per group its slots added in int32
    and folded into fp32 in :func:`int4_matmul_w4a8_reference`'s order.
    Bit-equal to it."""
    k_half, n = q4.shape
    ng = scale.shape[0]
    groups, rows = (1, k_half) if ng == 1 else (ng // 2, group)
    d = 1 if splits <= groups else splits // groups
    p = q4.to(torch.int32)
    lo, hi = (p & 0xF) - 8, (p >> 4) - 8
    slots = {}
    for piece, (r0, r1) in enumerate(split_pieces(k_half, ng, group, splits, w4a8=True)):
        for g in range(r0 // rows, -(-r1 // rows)):
            a, b = max(r0, g * rows), min(r1, (g + 1) * rows)
            slots[g if d == 1 else piece] = (_idot(xq[:, a:b], lo[a:b]),
                                             _idot(xq[:, k_half + a:k_half + b], hi[a:b]))
    out = torch.zeros(xq.shape[0], n, dtype=torch.float32, device=xq.device)
    for g in range(groups):
        s_lo = sum(slots[g * d + j][0] for j in range(d))
        s_hi = sum(slots[g * d + j][1] for j in range(d))
        if ng == 1:
            out = (s_lo + s_hi).float() * scale
        else:
            out = out + s_lo.float() * scale[g]
            out = out + s_hi.float() * scale[ng // 2 + g]
    return (out * sx).to(out_dtype)


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
    w4a16.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    w4a8 = lib.int4_matmul_w4a8_launch
    w4a8.restype = ctypes.c_int
    w4a8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return {"w4a16": w4a16, "w4a8": w4a8}


def _aligned(x2: torch.Tensor) -> torch.Tensor:
    """``x2``, or a fresh copy when it starts off a 16-byte boundary (a view
    at an offset): the tensor-core design copies x in 16-byte pieces, the
    small-M one reads it in 4-byte words."""
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


def _launch_w4a16(x2, weights, *, group: int, variant: str, tile_rows: int | None = None,
                  splits: int | None = None) -> list[torch.Tensor]:
    """One launch of the w4a16 kernel's ``variant`` design over one
    (``int4_matmul``) or three (``int4_matmul3``) same-shape packed
    weights; the tensor-core design with ``tile_rows`` rows a block, by
    default :func:`_tile_rows`'s; the small-M design in ``splits`` pieces,
    by default :func:`_splits`'s."""
    what = "int4_matmul3" if len(weights) == 3 else "int4_matmul"
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16 x, got {x2.dtype}")
    tensors = {}
    for i, (q4, scale) in enumerate(weights):
        tensors.update({f"q4_{i}": q4, f"scale_{i}": scale})
    _check_cuda(what, x2, **tensors)
    if variant != "cuda_core":
        x2 = _aligned(x2)
    m, k = x2.shape
    n, ng = weights[0][0].shape[1], weights[0][1].shape[0]
    sms = _sm_count(x2.device.index)
    if variant != "tensor_core":
        tile_rows = 0
    elif tile_rows is None:
        tile_rows = _tile_rows(m, n, len(weights), sms)
    if variant != "small_m":
        splits = 1
    elif splits is None:
        splits = _splits(m, k, n, len(weights), ng, group, sms)
    outs = [torch.empty(m, n, dtype=x2.dtype, device=x2.device) for _ in weights]
    pointers = []   # three (q4, scale, out) slots; one weight fills all three
    for (q4, scale), out in (list(zip(weights, outs)) * 3)[:3]:
        pointers += [q4.data_ptr(), scale.data_ptr(), out.data_ptr()]
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = _kernel_entries()["w4a16"](
            x2.data_ptr(), *pointers, _DTYPE_CODES[x2.dtype], len(weights),
            m, k, n, ng, group, _DESIGN_CODES[variant], tile_rows, splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"{what} {variant} kernel launch failed: error {err}")
    return outs


def _launch_w4a8(xq, sx, q4, scale, *, group: int, out_dtype, variant: str,
                 splits: int | None = None) -> torch.Tensor:
    """One launch of the w4a8 kernel's ``variant`` design (the small-M one
    in ``splits`` pieces, by default :func:`_splits`'s); its layout limits
    raise here."""
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
    if variant != "cuda_core":
        xq = _aligned(xq)
    if variant != "small_m":
        splits = 1
    elif splits is None:
        splits = _splits(m, k, n, 1, ng, group, _sm_count(xq.device.index), w4a8=True)
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _kernel_entries()["w4a8"](
            xq.data_ptr(), sx.data_ptr(), q4.data_ptr(), scale.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[out_dtype], m, k, n, ng, group,
            _DESIGN_CODES[variant], splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"int4_matmul w4a8 {variant} kernel launch failed: error {err}")
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
    if cuda:
        variant = _variant(x2.shape[0], 2 * k_half, n, ng, group, x.dtype, w4a8,
                           _sm_count(x.device.index))
    if w4a8:
        xq, sx = quantize_rows_int8(x2)
        if cuda:
            out = _launch_w4a8(xq, sx, q4, scale, group=group, out_dtype=x.dtype,
                               variant=variant)
            _count(int4_matmul.launches, "w4a8", variant)
        else:
            out = int4_matmul_w4a8_reference(xq, sx, q4, scale, group=group, out_dtype=x.dtype)
    elif cuda:
        (out,) = _launch_w4a16(x2, [(q4, scale)], group=group, variant=variant)
        _count(int4_matmul.launches, "w4a16", variant)
    else:
        out = int4_matmul_reference(x2, q4, scale, group=group)
    return out.reshape(*lead, n)


def _count(launches: dict, kernel: str, variant: str) -> None:
    """One launch of ``kernel``: its total, and its design's count (none
    for the CUDA-core design)."""
    launches[kernel] += 1
    if variant != "cuda_core":
        launches[f"{kernel}_{variant}"] += 1


#: Kernel launches since the last reset, by kernel; the wrapper adds one per
#: launch. ``w4a16``/``w4a8``
#: count every design, ``*_tensor_core`` and ``*_small_m`` the launches of
#: those designs among them.
int4_matmul.launches = {"w4a16": 0, "w4a8": 0, "w4a16_tensor_core": 0, "w4a8_tensor_core": 0,
                        "w4a16_small_m": 0, "w4a8_small_m": 0}


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
        variant = _variant(x2.shape[0], 2 * k_half, 3 * n, ng, group, x.dtype, False,
                           _sm_count(x.device.index))
        outs = _launch_w4a16(x2, list(weights), group=group, variant=variant)
        int4_matmul3.launches += 1
        int4_matmul3.tensor_core_launches += variant == "tensor_core"
        int4_matmul3.small_m_launches += variant == "small_m"
    else:
        outs = [int4_matmul_reference(x2, q4, s, group=group) for q4, s in weights]
    return tuple(o.reshape(*lead, n) for o in outs)


#: Kernel launches since the last reset (every design), and the tensor-core
#: and small-M designs' among them; the wrapper adds one per launch.
int4_matmul3.launches = 0
int4_matmul3.tensor_core_launches = 0
int4_matmul3.small_m_launches = 0


def make_int4_matmul_fn(mesh, rules, *, w4a8: bool = False):
    """The mesh-aware int4 matmul for tensor-parallel fused serving (the
    JAX package's, there under ``shard_map``).

    The returned ``fn(x, q4, scale, *, group, kernel_axes)`` takes DTensors
    (or full tensors) and runs :func:`int4_matmul` on each shard, laid out
    by the projection's logical kernel axes: a column-parallel site (output
    axis mapped) keeps its q4 columns local and emits a column-split output
    with no collective; a row-parallel site (contraction axis mapped)
    all-gathers its ACTIVATION columns and runs the q4 whole (split-half
    packing never splits the contraction dim); w4a8 quantizes after the
    gather. A weight axis that collides with the batch axis (FSDP's
    EMBED→data) is dropped everywhere, as in JAX."""
    import torch.distributed._functional_collectives as funcol

    from learning_jax_sharding_tpu_torch.parallel.collectives import all_gather
    from learning_jax_sharding_tpu_torch.parallel.logical import (
        BATCH,
        activate,
        local_call,
        logical_to_mesh_axes,
    )

    rules = tuple(rules)

    def to_axis(logical):
        return None if logical is None else logical_to_mesh_axes((logical,), rules)[0]

    def names(ax):
        if ax is None:
            return set()
        return {ax} if isinstance(ax, str) else set(ax)

    def fn(x, q4, scale, *, group, kernel_axes):
        ax_in, ax_out = to_axis(kernel_axes[0]), to_axis(kernel_axes[1])
        batch_ax = to_axis(BATCH)
        if names(ax_in) & names(batch_ax):
            ax_in = None
        if names(ax_out) & names(batch_ax):
            ax_out = None
        if ax_in is not None and not isinstance(ax_in, str):
            raise NotImplementedError(f"a contraction split over several mesh axes: {ax_in}")
        mid = (None,) * (x.ndim - 2)
        # Logical specs in mesh-axis terms: rules mapping each name to itself.
        x_spec, w_spec = ("b", *mid, "i"), (None, "o")
        out_spec = ("b", *mid, "o")
        identity = tuple((k, v) for k, v in (("b", batch_ax), ("i", ax_in), ("o", ax_out))
                         if v is not None)

        def body(x_l, q4_l, s_l):
            if ax_in is not None:
                # Row-parallel: gather the activation columns so the kernel
                # sees the whole contraction against the replicated q4.
                x_l = funcol.wait_tensor(
                    all_gather(x_l.contiguous(), x_l.ndim - 1,
                                             mesh.get_group(ax_in)))
            return int4_matmul(x_l, q4_l, s_l, group=group, w4a8=w4a8)

        with activate(mesh, identity):
            return local_call(body, (x, q4, scale), (x_spec, w_spec, w_spec), out_spec)

    return fn
