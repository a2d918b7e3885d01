"""Array redistribution between layouts: the shared resharding core.

Port of ``learning_jax_sharding_tpu/parallel/resharding.py``. Moving an array
from one layout to another (a parameter tree into the serving layout, a
finished prefill's KV row onto a decode engine, a KV page to host memory and
back) decomposes into block copies between the source's shard boxes and the
destination's: :func:`plan_transfer` intersects them into one
:class:`Segment` per overlapping block (optionally split into pages along a
sequence dim), :func:`execute_transfer` runs a plan, :func:`transfer_tree`
maps both over a KV-row tree with per-leaf sequence dims and ``stop``
clipping, :func:`reshard_tree` over a tree of whole leaves, and
:func:`device_reshard` is the path that stays on the destination's devices.

**Layouts.** A layout (the JAX package's "sharding") is one of:

* a :class:`~learning_jax_sharding_tpu_torch.parallel.sharding.NamedSharding`
  (a ``DeviceMesh`` and a ``PartitionSpec``), whose devices are the mesh's
  global ranks; each rank's box comes from the mesh's shape and the spec
  (:func:`devices_indices_map`), split as DTensor's ``Shard`` splits: ceil
  blocks, major mesh axis first, the last blocks short or empty, which is
  JAX's box wherever JAX accepts the shape (every split even);
* a ``torch.device``: the whole array on that one device (a plain tensor);
* a :class:`HostBuffer`: the whole array in host memory, a CPU tensor (numpy
  has no bfloat16).

:func:`sharding_of` gives a tensor's own layout (a DTensor's mesh and
placements, or its device).

**What each rank moves.** JAX runs one controller that reads every shard and
commits through ``jax.make_array_from_callback``; here every rank of a mesh
runs the same call (SPMD) and holds only its own shard, so each rank first
obtains the source blocks its destination boxes need, then copies the plan's
segments into its own destination buffers:

* a plain or host source is whole on every rank already;
* a DTensor source whose destination is host memory, a device, or the same
  mesh is gathered whole with ``full_tensor()``, a collective in the source
  mesh's own groups (ranks outside that mesh take no part);
* a DTensor source bound for ANOTHER mesh is gathered over the default
  group (every rank's shard to every rank), so the two meshes must hold
  every rank of the world between them, each of which makes the call; a
  move between two meshes that leave a rank out raises ``ValueError`` on
  every rank that makes it. Torch makes a group of part of the world only
  with every rank's call, or (``use_local_synchronization``) under a name
  hashed from each member's own count of groups, which differs between
  ranks of different meshes, so no group of just the two meshes can be
  made at the move.

A device destination then takes each rank's box with no further collective;
a host destination hands every rank the whole array. The plan's ``bytes``
and ``segments``, and the stats an execution reports, are JAX's count: every
segment once, however the ranks obtained their blocks.

The compression codecs (``codec=``) come with slice F
(``parallel/compression.py``) and :meth:`TransferPlan.domain_split` with slice
G's two-tier topology (``analysis/topology.py``); both raise
``NotImplementedError`` naming their slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial
from torch.utils import _pytree as pytree

from learning_jax_sharding_tpu_torch.parallel.sharding import (
    NamedSharding,
    _names,
    placements_to_spec,
)

#: Default streaming unit along the sequence dim: the serving engine's
#: default KV page (``page_size=64``); a segment is one page of one shard.
DEFAULT_PAGE_TOKENS = 64

Box = tuple[tuple[int, int], ...]   # per-dim half-open (start, stop)


@dataclasses.dataclass(frozen=True)
class HostBuffer:
    """The host-memory endpoint of a transfer plan: one "device" holding the
    whole array as a single box. A device→host plan prices the spilled bytes
    through the same counted segments as a device→device move, and
    :func:`execute_transfer` returns a CPU tensor; host→device runs the plan
    the other way, reading segments out of the host buffer. ``tag`` keys the
    plan cache."""

    tag: str = "host"

    def devices_indices_map(self, shape: Sequence[int]) -> dict:
        return {self: tuple(slice(0, int(d)) for d in shape)}


@dataclasses.dataclass(frozen=True)
class Segment:
    """One block copy: the intersection ``box`` (global coordinates) of a
    source shard and a destination shard, with the owning devices (global
    ranks, a ``torch.device`` or the :class:`HostBuffer`) and each shard's
    origin."""

    src_device: Any
    dst_device: Any
    box: Box
    src_origin: tuple[int, ...]
    dst_box: Box                       # the destination shard's full box

    @property
    def elements(self) -> int:
        return math.prod(hi - lo for lo, hi in self.box)


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """The checked, reusable decomposition of one leaf's redistribution,
    deterministic in its inputs (shape, itemsize and the two layouts).
    ``bytes_total`` is the whole-array wire volume; a ``stop``-clipped
    execution reports its own, smaller, count."""

    shape: tuple[int, ...]
    itemsize: int
    src_sharding: Any
    dst_sharding: Any
    seq_dim: int | None
    page_tokens: int | None
    segments: tuple[Segment, ...]
    codec: Any = None

    @property
    def bytes_total(self) -> int:
        return sum(s.elements for s in self.segments) * self.itemsize

    def describe(self) -> dict:
        """JSON-able summary for artifacts and flight-recorder payloads."""
        return {
            "shape": list(self.shape),
            "itemsize": self.itemsize,
            "segments": len(self.segments),
            "bytes_total": self.bytes_total,
            "seq_dim": self.seq_dim,
            "page_tokens": self.page_tokens,
            "codec": getattr(self.codec, "name", None),
        }

    def domain_split(self, topology: Any) -> dict:
        """The plan's bytes by interconnect tier under a two-tier topology:
        comes with slice G (``analysis/topology.py``)."""
        raise NotImplementedError(
            "domain_split: ported with slice G (analysis/topology.py)")


def _check_codec(codec) -> None:
    if codec is not None:
        raise NotImplementedError("codec: ported with slice F (parallel/compression.py)")


def _device(d) -> torch.device:
    """A ``torch.device`` with its index: ``cuda`` means the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def sharding_of(x) -> Any:
    """A tensor's own layout: a DTensor's mesh and spec as a
    :class:`NamedSharding`, a plain tensor's device; host arrays (numpy, a
    Python number) → :class:`HostBuffer`. A ``Partial`` DTensor has no box
    layout (reduce it first)."""
    if isinstance(x, DTensor):
        if any(isinstance(p, Partial) for p in x.placements):
            raise ValueError(f"a Partial DTensor has no shard boxes: {x.placements}")
        return NamedSharding(x.device_mesh,
                             placements_to_spec(x.device_mesh, x.placements, x.ndim))
    if isinstance(x, torch.Tensor):
        return _device(x.device)
    return HostBuffer()


def devices_indices_map(sharding, shape: Sequence[int]) -> dict:
    """``{device: per-dim slices}`` of every shard of a ``shape`` array under
    ``sharding``, in mesh order: JAX's ``devices_indices_map``. A mesh's
    devices are its global ranks; a dim split over several mesh axes splits
    major axis first, each split in ceil blocks (DTensor's ``Shard``)."""
    shape = tuple(int(s) for s in shape)
    if isinstance(sharding, HostBuffer):
        return sharding.devices_indices_map(shape)
    if isinstance(sharding, NamedSharding):
        mesh, spec = sharding.mesh, tuple(sharding.spec)
        names, sizes = mesh.mesh_dim_names, tuple(mesh.mesh.shape)
        out = {}
        for i, rank in enumerate(mesh.mesh.flatten().tolist()):
            coord = np.unravel_index(i, sizes)
            box = []
            for d, n in enumerate(shape):
                lo, hi = 0, n
                for axis in _names(spec[d] if d < len(spec) else None):
                    m = names.index(axis)
                    step = -(-(hi - lo) // sizes[m])
                    lo, hi = min(lo + int(coord[m]) * step, hi), min(lo + (int(coord[m]) + 1) * step, hi)
                box.append(slice(lo, hi))
            out[int(rank)] = tuple(box)
        return out
    return {_device(sharding): tuple(slice(0, d) for d in shape)}


def _norm_box(idx: Sequence, shape: Sequence[int]) -> Box:
    return tuple(tuple(sl.indices(d)[:2]) for sl, d in zip(idx, shape))


def plan_transfer(
    shape: Sequence[int],
    itemsize: int,
    src_sharding: Any,
    dst_sharding: Any,
    *,
    seq_dim: int | None = None,
    page_tokens: int | None = DEFAULT_PAGE_TOKENS,
    codec: Any = None,
) -> TransferPlan:
    """Decompose ``src_sharding → dst_sharding`` into block copies: for every
    destination shard box, its intersections with the DEDUPLICATED source
    boxes (a replicated source block has one elected owner, the first in
    mesh order, so the blocks tile the array and each destination element is
    written once; a replicated destination costs one copy a holder). With
    ``seq_dim``, segments split into ``page_tokens`` pages along it, page
    boundaries in global coordinates."""
    _check_codec(codec)
    shape = tuple(int(s) for s in shape)
    src_map = devices_indices_map(src_sharding, shape)
    dst_map = devices_indices_map(dst_sharding, shape)
    blocks: dict[Box, Any] = {}
    for dev, idx in src_map.items():
        blocks.setdefault(_norm_box(idx, shape), dev)
    segments: list[Segment] = []
    for ddev, didx in dst_map.items():
        dbox = _norm_box(didx, shape)
        for sbox, sdev in blocks.items():
            inter = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in zip(sbox, dbox))
            if any(lo >= hi for lo, hi in inter):
                continue
            src_origin = tuple(lo for lo, _ in sbox)
            if seq_dim is not None and page_tokens:
                lo, hi = inter[seq_dim]
                for p0 in range((lo // page_tokens) * page_tokens, hi, page_tokens):
                    plo, phi = max(lo, p0), min(hi, p0 + page_tokens)
                    if plo < phi:
                        box = tuple((plo, phi) if d == seq_dim else rng
                                    for d, rng in enumerate(inter))
                        segments.append(Segment(sdev, ddev, box, src_origin, dbox))
            else:
                segments.append(Segment(sdev, ddev, inter, src_origin, dbox))
    return TransferPlan(shape=shape, itemsize=int(itemsize), src_sharding=src_sharding,
                        dst_sharding=dst_sharding, seq_dim=seq_dim, page_tokens=page_tokens,
                        segments=tuple(segments), codec=codec)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _as_tensor(x) -> torch.Tensor:
    """A host array (numpy, a number, a CPU tensor) as a tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def _whole(plan: TransferPlan, x) -> torch.Tensor:
    """The whole source array, where this rank's destination boxes need it
    (see the module docstring for the collectives each case makes)."""
    if not isinstance(x, DTensor):
        return _as_tensor(x)
    dst = plan.dst_sharding
    if not isinstance(dst, NamedSharding) or dst.mesh == x.device_mesh:
        return x.full_tensor()
    # Two meshes: every rank's shard to every rank, over the default group,
    # which must then be the two meshes' ranks.
    world = dist.get_world_size()
    ranks = set(x.device_mesh.mesh.flatten().tolist()) | set(dst.mesh.mesh.flatten().tolist())
    if len(ranks) != world:
        raise ValueError(
            f"a move between two meshes gathers over the default group: the meshes hold "
            f"ranks {sorted(ranks)} of a world of {world}, and must hold them all")
    shards = [None] * world
    dist.all_gather_object(shards, (_rank(), x.to_local().cpu()))
    whole = torch.empty(plan.shape, dtype=x.dtype)
    boxes = devices_indices_map(plan.src_sharding, plan.shape)
    for rank, local in shards:
        if rank in boxes and local.numel():
            whole[boxes[rank]] = local
    return whole


def _follows(prev: Box, box: Box, seq_dim: int | None) -> bool:
    """Whether ``box`` continues ``prev`` along the sequence dim, every other
    dim alike: the pages of one block, which one copy moves."""
    return seq_dim is not None and prev[seq_dim][1] == box[seq_dim][0] and all(
        a == b for d, (a, b) in enumerate(zip(prev, box)) if d != seq_dim)


def execute_transfer(
    plan: TransferPlan, x, *, stop: int | None = None, topology: Any | None = None,
) -> tuple[Any, dict]:
    """Run ``plan`` on ``x``: assemble this rank's destination shards from
    the plan's segments and lay them out under the destination layout (a
    DTensor on a mesh, ``None`` on a rank outside it; a tensor on a device;
    a CPU tensor in host memory).
    ``stop`` (sequence positions ``< stop`` are valid) skips whole pages past
    the bound and clips the straddling one; skipped regions stay zero, which
    the engine's causal-at-index masks never read. Consecutive pages of one
    block move in one copy (each still counts as its segment).

    → ``(array, stats)``, ``stats = {"bytes", "raw_bytes", "segments",
    "segments_skipped"}``: THIS transfer's volume, every segment counted
    once. ``topology`` (and JAX's ``base``, the delta codecs' reference)
    come with slices G and F."""
    if topology is not None:
        raise NotImplementedError("topology: ported with slice G (analysis/topology.py)")
    shape = plan.shape
    if tuple(x.shape) != shape:
        raise ValueError(f"plan is for shape {shape}, array is {tuple(x.shape)}")
    dst = plan.dst_sharding
    me = _rank()
    full = _whole(plan, x)
    if isinstance(dst, HostBuffer):
        device, mine = torch.device("cpu"), None
    elif isinstance(dst, NamedSharding):
        device, mine = torch.device(dst.mesh.device_type), me
        if device.type == "cuda":
            device = _device(device)
    else:
        device, mine = _device(dst), None
    bufs: dict[Box, torch.Tensor] = {}
    for ddev, didx in devices_indices_map(dst, shape).items():
        dbox = _norm_box(didx, shape)
        if (mine is None or ddev == mine) and dbox not in bufs:
            bufs[dbox] = torch.zeros(tuple(hi - lo for lo, hi in dbox), dtype=full.dtype,
                                     device=device)
    copied = skipped = nbytes = 0
    runs: list[list] = []              # [destination box, box]: the copies this rank makes
    for seg in plan.segments:
        box = seg.box
        if stop is not None and plan.seq_dim is not None:
            lo, hi = box[plan.seq_dim]
            hi = min(hi, int(stop))
            if lo >= hi:
                skipped += 1
                continue
            box = tuple((lo, hi) if d == plan.seq_dim else rng for d, rng in enumerate(box))
        copied += 1
        nbytes += math.prod(hi - lo for lo, hi in box) * plan.itemsize
        if mine is not None and seg.dst_device != mine:
            continue                   # another rank's copy: counted, not made here
        if runs and runs[-1][0] == seg.dst_box and _follows(runs[-1][1], box, plan.seq_dim):
            # The next page of the same block: one copy takes both.
            runs[-1][1] = tuple((a[0], b[1]) if d == plan.seq_dim else a
                                for d, (a, b) in enumerate(zip(runs[-1][1], box)))
        else:
            runs.append([seg.dst_box, box])
    for dbox, box in runs:
        dst_sl = tuple(slice(lo - dlo, hi - dlo) for (lo, hi), (dlo, _) in zip(box, dbox))
        bufs[dbox][dst_sl].copy_(full[tuple(slice(lo, hi) for lo, hi in box)])
    stats = {"bytes": nbytes, "raw_bytes": nbytes, "segments": copied,
             "segments_skipped": skipped}
    if not isinstance(dst, NamedSharding):
        (out,) = bufs.values()
        return out, stats
    box = devices_indices_map(dst, shape).get(me)
    if box is None:
        return None, stats             # this rank holds no part of the destination
    local = bufs[_norm_box(box, shape)]
    return DTensor.from_local(local, dst.mesh, dst.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride()), stats


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else np.asarray(x).itemsize


def transfer_tree(
    rows: Any,
    dst_shardings: Any,
    *,
    stop: int | None = None,
    seq_dims: Any | None = None,
    page_tokens: int | None = DEFAULT_PAGE_TOKENS,
    plan_cache: dict | None = None,
    topology: Any | None = None,
    codec: Any = None,
) -> tuple[Any, dict]:
    """Redistribute a whole exported cache-row tree (the engine's
    ``export_kv``) into ``dst_shardings`` (the destination engine's
    ``kv_row_shardings``). ``seq_dims`` names each leaf's sequence dim (a
    matching tree of ints, ``-1`` = none: the destination's
    ``kv_row_seq_dims``, which reads it off the row shapes); ``stop`` (the
    row's valid length) clips those leaves' plans and ``-1`` leaves move
    whole. Without ``seq_dims`` every leaf of two or more dims is assumed
    sequence-major on dim 0. ``plan_cache`` (any dict) keeps plans across
    handoffs of one layout. → ``(tree, summed stats)``."""
    _check_codec(codec)
    if topology is not None:
        raise NotImplementedError("topology: ported with slice G (analysis/topology.py)")
    totals = {"bytes": 0, "raw_bytes": 0, "segments": 0, "segments_skipped": 0}
    if seq_dims is None:
        seq_dims = pytree.tree_map(lambda x: 0 if np.ndim(x) >= 2 else -1, rows)

    def one(x, dst, seq_dim):
        seq_dim = None if seq_dim is None or seq_dim < 0 else int(seq_dim)
        src = sharding_of(x)
        key = (tuple(x.shape), str(x.dtype), src, dst, seq_dim, page_tokens, None)
        plan = plan_cache.get(key) if plan_cache is not None else None
        if plan is None:
            plan = plan_transfer(x.shape, _itemsize(x), src, dst, seq_dim=seq_dim,
                                 page_tokens=page_tokens)
            if plan_cache is not None:
                plan_cache[key] = plan
        out, stats = execute_transfer(plan, x, stop=stop if seq_dim is not None else None)
        for k in totals:
            totals[k] += stats[k]
        return out

    return pytree.tree_map(one, rows, dst_shardings, seq_dims), totals


# --- whole-tree resharding (weight swaps) ---------------------------------


def _same_device_set(x, dst) -> bool:
    """Whether ``x`` already lives on the destination's devices: a DTensor on
    the destination's own mesh, or a plain tensor on its device."""
    if isinstance(x, DTensor):
        return isinstance(dst, NamedSharding) and dst.mesh == x.device_mesh
    if isinstance(x, torch.Tensor) and not isinstance(dst, (NamedSharding, HostBuffer)):
        return _device(x.device) == _device(dst)
    return False


def device_reshard(tree: Any, dst_shardings: Any, *, jit_cache: dict | None = None):
    """Reshard a tree whose leaves already live on the destination's devices,
    with no host round trip: each DTensor is redistributed into its
    destination placements (``DTensor.redistribute``, whose collectives run
    in the mesh's own groups), each plain tensor stays on its device. Raises
    ``ValueError`` when a leaf lives on another device set. ``jit_cache``
    (JAX's cache of its compiled mover) is accepted and ignored: a
    redistribute compiles nothing.

    → ``(tree, stats)``, ``stats["mode"] == "device"`` and ``bytes`` /
    ``segments`` the summed leaf sizes and count (what could have moved)."""
    leaves, spec = pytree.tree_flatten(tree)
    dst_leaves = pytree.tree_flatten(dst_shardings)[0]
    if len(dst_leaves) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(dst_leaves)} destinations")
    for x, d in zip(leaves, dst_leaves):
        if not _same_device_set(x, d):
            raise ValueError(
                f"device_reshard: a leaf on {sharding_of(x)} is not on the destination's "
                f"devices ({d}); take the host path (reshard_tree(mode='host'))")
    out = [x.redistribute(d.mesh, d.placements) if isinstance(x, DTensor) else x
           for x, d in zip(leaves, dst_leaves)]
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    stats = {"bytes": nbytes, "raw_bytes": nbytes, "segments": len(leaves),
             "segments_skipped": 0, "mode": "device"}
    return pytree.tree_unflatten(out, spec), stats


def _commit_host(buf: np.ndarray, dst):
    """A host array laid out under ``dst`` with nothing sent: each rank of a
    mesh takes its own box."""
    t = torch.from_numpy(np.ascontiguousarray(buf))
    if isinstance(dst, HostBuffer):
        return t.clone()
    if not isinstance(dst, NamedSharding):
        return t.to(_device(dst))
    box = devices_indices_map(dst, buf.shape).get(_rank())
    if box is None:
        return None
    device = torch.device(dst.mesh.device_type)
    local = t[box].contiguous().to(_device(device) if device.type == "cuda" else device)
    return DTensor.from_local(local, dst.mesh, dst.placements, run_check=False,
                              shape=torch.Size(buf.shape),
                              stride=torch.empty(buf.shape, device="meta").stride())


def reshard_tree(
    tree: Any,
    dst_shardings: Any,
    *,
    plan_cache: dict | None = None,
    jit_cache: dict | None = None,
    mode: str = "auto",
    codec: Any = None,
) -> tuple[Any, dict]:
    """Redistribute a parameter tree into ``dst_shardings``: leaves move
    WHOLE (no sequence dim, no clipping) and keep their dtypes exactly (an
    int8 or uint8 tree reshards bit for bit; nothing here casts).

    ``mode``: ``"auto"`` takes :func:`device_reshard` when every leaf is a
    tensor already on its destination's devices, else the host plan path;
    ``"host"`` forces the segment plans (every byte counted); ``"device"``
    forces :func:`device_reshard` (raising for a leaf elsewhere). On the host
    path a numpy leaf (a checkpoint restore) is laid out under its
    destination directly, each rank of a mesh taking its own box. → ``(tree,
    stats)`` with the summed ``bytes``/``segments`` and ``stats["mode"]``."""
    if mode not in ("auto", "host", "device"):
        raise ValueError(f"reshard_tree: unknown mode {mode!r}")
    _check_codec(codec)
    leaves, spec = pytree.tree_flatten(tree)
    dst_leaves = pytree.tree_flatten(dst_shardings)[0]
    if mode == "device" or (mode == "auto" and leaves and all(
            _same_device_set(x, d) for x, d in zip(leaves, dst_leaves))):
        return device_reshard(tree, dst_shardings, jit_cache=jit_cache)
    totals = {"bytes": 0, "raw_bytes": 0, "segments": 0, "segments_skipped": 0}
    out = []
    for x, dst in zip(leaves, dst_leaves):
        if not isinstance(x, torch.Tensor):
            buf = np.asarray(x)
            out.append(_commit_host(buf, dst))
            totals["bytes"] += buf.nbytes
            totals["raw_bytes"] += buf.nbytes
            totals["segments"] += 1
            continue
        src = sharding_of(x)
        key = (tuple(x.shape), str(x.dtype), src, dst, None, None, None)
        plan = plan_cache.get(key) if plan_cache is not None else None
        if plan is None:
            plan = plan_transfer(x.shape, x.element_size(), src, dst, seq_dim=None,
                                 page_tokens=None)
            if plan_cache is not None:
                plan_cache[key] = plan
        moved, stats = execute_transfer(plan, x)
        out.append(moved)
        for k in totals:
            totals[k] += stats[k]
    totals["mode"] = "host"
    return pytree.tree_unflatten(out, spec), totals
