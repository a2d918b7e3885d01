"""The port's ``parallel/resharding.py`` against the JAX package's.

Every plan of ``tests/test_resharding.py`` (44-190) and of
``tests/test_zfleet.py::TestTransferPlan``, at its mesh shapes and specs
((2, 4), (1, 3), (1, 4) and two (1, 2) meshes on other devices; replicated,
split over two mesh axes, misaligned 3-way against 2-way boundaries; host
memory at either end), is made on both sides: JAX's ``plan_transfer`` over
the 8 emulated CPU devices of the conftest, the port's over ``DeviceMesh``
layouts of 8 thread ranks (``parallel.run_on_threads``), each JAX device
standing for the rank of its index. Their segments (devices, boxes, origins)
and bytes must be equal. Then the executions run on the thread ranks: the
round trips bit for bit (fp32, int8, uint8 and bf16 leaves; numpy leaves
from the host), ``"auto"`` taking the device path on one mesh and the host
path across meshes, the plan cache reused, ``stop`` clipping the pages past
a row's valid length, and the stats of every execution equal to JAX's. A
move between two meshes gathers over the default group, so it runs in a
thread world that the two meshes make up (4 or 6 ranks), and one between
meshes that leave ranks out is refused. Bit-equal everywhere: nothing here
computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxSharding, PartitionSpec as JaxP

from learning_jax_sharding_tpu.parallel import build_mesh as jax_build_mesh
from learning_jax_sharding_tpu.parallel import resharding as jax_rs
from learning_jax_sharding_tpu_torch.parallel import resharding as rs
from learning_jax_sharding_tpu_torch.parallel import run_on_threads

torch.set_num_threads(1)

#: name → (mesh shape, axis names, the devices (ranks) it spans).
MESHES = {
    "mesh24": ((2, 4), ("x", "y"), range(8)),
    "mesh13": ((1, 3), ("data", "model"), range(3)),
    "mesh14": ((1, 4), ("data", "model"), range(4)),
    "a": ((1, 2), ("data", "model"), range(2)),
    "b": ((1, 4), ("data", "model"), range(2, 6)),
    "c": ((1, 2), ("data", "model"), range(2, 4)),
}
HOST = ("host",)

#: name → (shape, itemsize, source layout, destination layout, plan keywords).
PLANS = {
    "uneven_1d": ((6,), 4, ("mesh13", ("model",)), ("mesh24", ("x",)), {}),
    "uneven_2d": ((6, 4), 4, ("mesh13", ("model", None)), ("mesh24", ("x", "y")), {}),
    "replicated_to_sharded": ((4, 4), 4, ("mesh24", ()), ("mesh24", ("x", "y")), {}),
    "sharded_to_replicated": ((4, 4), 4, ("mesh24", ("x", "y")), ("mesh24", ()), {}),
    "whole_leaf": ((8, 8), 4, ("mesh24", ("x", "y")), ("mesh24", ("y", None)), {}),
    "int8_columns": ((4, 4), 1, ("mesh24", ("x", None)), ("mesh24", (None, "y")), {}),
    "two_axes_one_dim": ((16, 2), 2, ("mesh24", (("x", "y"), None)),
                         ("mesh14", ("model", None)), {}),
    "cross_mesh": ((8,), 4, ("mesh24", ("x",)), ("mesh14", ("model",)), {}),
    "cross_mesh_pages": ((16, 4, 8), 4, ("a", (None, "model", None)),
                         ("b", (None, None, "model")), dict(seq_dim=0, page_tokens=8)),
    "pages_of_4": ((16, 4), 4, ("a", (None, "model")), ("c", (None, "model")),
                   dict(seq_dim=0, page_tokens=4)),
    "replicated_destination": ((8, 4), 4, ("a", (None, "model")), ("c", ()),
                               dict(seq_dim=0)),
    "to_host": ((4, 4), 4, ("mesh24", ("x", None)), HOST, {}),
    "from_host": ((4, 4), 4, HOST, ("mesh24", ("x", "y")), {}),
}


def _seg_key(dev):
    return "host" if dev == "host" else int(dev)


# --- the JAX side ------------------------------------------------------------


def _jax_layout(layout):
    if layout == HOST:
        return jax_rs.HostBuffer()
    name, spec = layout
    shape, names, devs = MESHES[name]
    mesh = jax_build_mesh(shape, names, devices=[jax.devices()[i] for i in devs])
    return JaxSharding(mesh, JaxP(*spec))


def _jax_segments(plan):
    ids = {d: i for i, d in enumerate(jax.devices())}

    def dev(d):
        return "host" if isinstance(d, jax_rs.HostBuffer) else ids[d]

    return [(dev(s.src_device), dev(s.dst_device), s.box, s.src_origin, s.dst_box)
            for s in plan.segments]


def _jax_put(x, layout):
    return jax.device_put(x, _jax_layout(layout))


def _stats(st):
    return {k: st[k] for k in ("bytes", "segments", "segments_skipped")}


@pytest.fixture(scope="module")
def jax_side():
    out = {"plans": {}}
    for name, (shape, itemsize, src, dst, kw) in PLANS.items():
        plan = jax_rs.plan_transfer(shape, itemsize, _jax_layout(src), _jax_layout(dst), **kw)
        out["plans"][name] = (_jax_segments(plan), plan.bytes_total)
    runs = {}
    x6 = jnp.arange(6, dtype=jnp.float32)
    _, st = jax_rs.reshard_tree([_jax_put(x6, ("mesh13", ("model",)))],
                                [_jax_layout(("mesh24", ("x",)))], mode="host")
    runs["uneven_1d"] = _stats(st)
    x24 = jnp.arange(24, dtype=jnp.float32).reshape(6, 4)
    _, st = jax_rs.reshard_tree({"w": _jax_put(x24, ("mesh13", ("model", None)))},
                                {"w": _jax_layout(("mesh24", ("x", "y")))}, mode="host")
    runs["uneven_2d"] = _stats(st)
    x16 = jnp.arange(16, dtype=jnp.float32).reshape(4, 4)
    for name, (a, b) in {"replicated_to_sharded": ((), ("x", "y")),
                         "sharded_to_replicated": (("x", "y"), ())}.items():
        _, st = jax_rs.reshard_tree([_jax_put(x16, ("mesh24", a))],
                                    [_jax_layout(("mesh24", b))], mode="host")
        runs[name] = _stats(st)
    w = np.arange(32, dtype=np.float32).reshape(4, 8)
    _, st = jax_rs.reshard_tree({"w": w, "b": np.float32(3.0)},
                                {"w": _jax_layout(("mesh24", ("x", "y"))),
                                 "b": _jax_layout(("mesh24", ()))})
    runs["host_leaves"] = _stats(st)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    a = _jax_put(x, ("a", (None, "model")))
    plan = jax_rs.plan_transfer(x.shape, 4, a.sharding, _jax_layout(("c", (None, "model"))),
                                seq_dim=0, page_tokens=4)
    _, st = jax_rs.execute_transfer(plan, a, stop=5)
    runs["stop"] = _stats(st)
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    _, st = jax_rs.transfer_tree(
        {"k": _jax_put(x, ("a", (None, "model"))),
         "idx": _jax_put(jnp.int32(7), ("a", ()))},
        {"k": _jax_layout(("c", (None, "model"))), "idx": _jax_layout(("c", ()))}, stop=8)
    runs["transfer_tree"] = _stats(st)
    out["runs"] = runs
    return out


# --- the port side: thread worlds of 8 ranks, and of 4 and 6 for the moves
# between two meshes, which must hold every rank of the world between them ---


def _tools():
    """The meshes of ``MESHES`` that fit this thread world, and helpers over
    them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from learning_jax_sharding_tpu_torch.parallel.sharding import NamedSharding, P

    meshes = {name: DeviceMesh("cpu", torch.tensor(list(devs)).reshape(shape),
                               mesh_dim_names=names)
              for name, (shape, names, devs) in MESHES.items()
              if max(devs) < dist.get_world_size()}

    def layout(lay):
        return rs.HostBuffer() if lay == HOST else NamedSharding(meshes[lay[0]], P(*lay[1]))

    def put(x, lay):
        """``x`` (the same whole array on every rank) laid out under ``lay``:
        this rank's box of it, or nothing on a rank outside the mesh."""
        t = torch.as_tensor(x)
        sh = layout(lay)
        box = rs.devices_indices_map(sh, t.shape).get(dist.get_rank())
        # Outside the mesh: an empty local (a 0-d one for a scalar, whose
        # empty shape from_local would not take as given).
        local = (t[box].contiguous() if box is not None
                 else t.new_empty(0) if t.ndim else t.new_zeros(()))
        return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                                  shape=t.shape, stride=t.contiguous().stride())

    def whole(x):
        """A result whole on every rank of its mesh (None elsewhere)."""
        if x is None or not isinstance(x, DTensor):
            return x
        if x.device_mesh.get_coordinate() is None:
            return None
        return x.full_tensor()

    def anywhere(x):
        """A result whole on rank 0 too, from the ranks of its mesh."""
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, whole(x))
        return next(g for g in got if g is not None)

    return meshes, layout, put, whole, anywhere


def _port_body(_mesh):
    import torch.distributed as dist

    meshes, layout, put, whole, anywhere = _tools()
    out = {"plans": {}, "runs": {}}
    for name, (shape, itemsize, src, dst, kw) in PLANS.items():
        plan = rs.plan_transfer(shape, itemsize, layout(src), layout(dst), **kw)
        segs = [(_seg_key("host" if isinstance(s.src_device, rs.HostBuffer) else s.src_device),
                 _seg_key("host" if isinstance(s.dst_device, rs.HostBuffer) else s.dst_device),
                 s.box, s.src_origin, s.dst_box) for s in plan.segments]
        out["plans"][name] = (segs, plan.bytes_total)
    runs = out["runs"]

    # tests/test_resharding.py: uneven boundaries, there and back.
    x6 = torch.arange(6, dtype=torch.float32)
    moved, st = rs.reshard_tree([put(x6, ("mesh13", ("model",)))],
                                [layout(("mesh24", ("x",)))], mode="host")
    back, _ = rs.reshard_tree(moved, [layout(("mesh13", ("model",)))], mode="host")
    runs["uneven_1d"] = dict(stats=_stats(st), moved=whole(moved[0]), back=whole(back[0]),
                             placements=moved[0].placements)
    x24 = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    moved, st = rs.reshard_tree({"w": put(x24, ("mesh13", ("model", None)))},
                                {"w": layout(("mesh24", ("x", "y")))}, mode="host")
    runs["uneven_2d"] = dict(stats=_stats(st), moved=whole(moved["w"]))
    x16 = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    for name, (a, b) in {"replicated_to_sharded": ((), ("x", "y")),
                         "sharded_to_replicated": (("x", "y"), ())}.items():
        moved, st = rs.reshard_tree([put(x16, ("mesh24", a))], [layout(("mesh24", b))],
                                    mode="host")
        runs[name] = dict(stats=_stats(st), moved=whole(moved[0]))
    dtypes = {}
    for dtype in (torch.int8, torch.uint8, torch.bfloat16):
        vals = torch.arange(-8, 8).reshape(4, 4)
        q = (vals + 8 if dtype == torch.uint8 else vals).to(dtype)
        tree = {"q": put(q, ("mesh24", ("x", None))),
                "scale": put(torch.tensor(0.5), ("mesh24", ()))}
        moved, _ = rs.reshard_tree(tree, {"q": layout(("mesh24", (None, "y"))),
                                          "scale": layout(("mesh24", ()))}, mode="host")
        dtypes[str(dtype)] = (moved["q"].dtype, moved["scale"].dtype,
                              torch.equal(whole(moved["q"]), q), moved["q"].placements)
    runs["dtypes"] = dtypes
    w = np.arange(32, dtype=np.float32).reshape(4, 8)
    moved, st = rs.reshard_tree({"w": w, "b": np.float32(3.0)},
                                {"w": layout(("mesh24", ("x", "y"))),
                                 "b": layout(("mesh24", ()))})
    runs["host_leaves"] = dict(stats=_stats(st), mode=st["mode"], w=whole(moved["w"]),
                               b=float(whole(moved["b"])), placements=moved["w"].placements)

    # "auto": one mesh → the device path (JAX's jit_cache accepted); across
    # meshes → host.
    x64 = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    src = put(x64, ("mesh24", ("x", None)))
    dst = {"w": layout(("mesh24", (None, "y")))}
    dev_out, st = rs.reshard_tree({"w": src}, dst, jit_cache={})
    host_out, _ = rs.reshard_tree({"w": src}, dst, mode="host")
    again, _ = rs.reshard_tree({"w": src}, dst)
    runs["auto_same_mesh"] = dict(mode=st["mode"],
                                  device=whole(dev_out["w"]), host=whole(host_out["w"]),
                                  again=whole(again["w"]),
                                  placements=dev_out["w"].placements)
    x8 = torch.arange(8, dtype=torch.float32)
    moved, st = rs.reshard_tree([put(x8, ("mesh24", ("x",)))], [layout(("mesh14", ("model",)))])
    runs["auto_cross_mesh"] = dict(mode=st["mode"], moved=whole(moved[0]),
                                   outside=moved[0] is None)
    try:
        rs.device_reshard([put(x8, ("mesh24", ("x",)))], [layout(("mesh14", ("model",)))])
        runs["device_foreign"] = None
    except ValueError as exc:
        runs["device_foreign"] = str(exc)
    ones = torch.ones(4, 4)
    trees = [put(ones, ("mesh24", ("x", None))), put(ones, ("mesh24", ("x", None))),
             put(torch.ones(2, 4), ("mesh24", ()))]
    dsts = [layout(("mesh24", (None, "y"))), layout(("mesh24", (None, "y"))),
            layout(("mesh24", ("x", "y")))]
    cache: dict = {}
    rs.reshard_tree(trees, dsts, plan_cache=cache, mode="host")
    first = len(cache)
    rs.reshard_tree(trees, dsts, plan_cache=cache, mode="host")
    runs["plan_cache"] = (first, len(cache))

    # Host memory at either end: every rank gets the whole rows.
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    host_plan = rs.plan_transfer(x.shape, 4, layout(("mesh24", ("x", None))), rs.HostBuffer())
    rows, st = rs.execute_transfer(host_plan, put(x, ("mesh24", ("x", None))))
    fill_plan = rs.plan_transfer(x.shape, 4, rs.HostBuffer(), layout(("mesh24", ("x", "y"))))
    filled, st2 = rs.execute_transfer(fill_plan, rows)
    runs["host"] = dict(rows=rows, stats=(_stats(st), _stats(st2)), filled=whole(filled),
                        local=tuple(filled.to_local().shape))
    # Two meshes that leave ranks out ("a", ranks 0-1, to "mesh13", ranks
    # 0-2): the ranks of the move refuse it, with no collective; ranks 4-7
    # run one of their own meanwhile, rank 3 nothing.
    x = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 4)
    side = None
    if dist.get_rank() < 3:
        try:
            rs.reshard_tree([put(x, ("a", ("model", None)))],
                            [layout(("mesh13", (None, "model")))], mode="host")
        except ValueError as exc:
            side = str(exc)
    elif dist.get_rank() >= 4:
        t = torch.ones(1)
        dist.all_reduce(t, group=meshes["mesh24"].get_group("y"))
        side = float(t)
    sides = [None] * dist.get_world_size()
    dist.all_gather_object(sides, side)
    runs["part_of_world"] = sides
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (runs["host"]["rows"], runs["auto_cross_mesh"]["outside"]))
    out["ranks"] = ranks
    return out


def _pairs_body(_mesh):
    """tests/test_zfleet.py::TestTransferPlan's moves between two meshes that
    make up this world: pages from "a" to "b" in a world of 6; stop
    clipping, a replicated destination priced per copy and scalar leaves
    from "a" to "c" in a world of 4."""
    import torch.distributed as dist

    _, layout, put, _, anywhere = _tools()
    runs = {}
    if dist.get_world_size() == 6:
        x = torch.arange(16 * 4 * 8, dtype=torch.float32).reshape(16, 4, 8)
        xa = put(x, ("a", (None, "model", None)))
        plan = rs.plan_transfer(x.shape, 4, rs.sharding_of(xa),
                                layout(("b", (None, None, "model"))), seq_dim=0, page_tokens=8)
        moved, st = rs.execute_transfer(plan, xa)
        back_plan = rs.plan_transfer(x.shape, 4, layout(("b", (None, None, "model"))),
                                     layout(("a", (None, "model", None))), seq_dim=0)
        back, _ = rs.execute_transfer(back_plan, moved if moved is not None else put(
            x, ("b", (None, None, "model"))))
        runs["cross_mesh_pages"] = dict(stats=_stats(st), bytes_total=plan.bytes_total,
                                        moved=anywhere(moved), back=anywhere(back))
        return runs
    x = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    plan = rs.plan_transfer(x.shape, 4, layout(("a", (None, "model"))),
                            layout(("c", (None, "model"))), seq_dim=0, page_tokens=4)
    moved, st = rs.execute_transfer(plan, put(x, ("a", (None, "model"))), stop=5)
    runs["stop"] = dict(stats=_stats(st), moved=anywhere(moved))
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    plan = rs.plan_transfer(x.shape, 4, layout(("a", (None, "model"))), layout(("c", ())),
                            seq_dim=0)
    moved, st = rs.execute_transfer(plan, put(x, ("a", (None, "model"))))
    runs["replicated_destination"] = dict(stats=_stats(st), moved=anywhere(moved))
    tree = {"k": put(x, ("a", (None, "model"))), "idx": put(torch.tensor(7, dtype=torch.int32),
                                                            ("a", ()))}
    dst = {"k": layout(("c", (None, "model"))), "idx": layout(("c", ()))}
    cache = {}
    moved, st = rs.transfer_tree(tree, dst, stop=8, plan_cache=cache)
    n_plans = len(cache)
    again, _ = rs.transfer_tree(tree, dst, stop=8, plan_cache=cache)
    runs["transfer_tree"] = dict(stats=_stats(st), idx=anywhere(moved["idx"]),
                                 k=anywhere(moved["k"]), again=anywhere(again["k"]),
                                 plans=(n_plans, len(cache)))
    return runs


@pytest.fixture(scope="module")
def port_side():
    out = run_on_threads(_port_body, (2, 4), ("x", "y"))
    for world in (4, 6):
        out["runs"].update(run_on_threads(_pairs_body, (1, world), ("x", "y")))
    return out


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_segments_and_bytes_equal_jax(name, port_side, jax_side):
    got, want = port_side["plans"][name], jax_side["plans"][name]
    assert got[1] == want[1]
    assert got[0] == want[0]


@pytest.mark.parametrize("name", ["uneven_1d", "uneven_2d", "replicated_to_sharded",
                                  "sharded_to_replicated", "host_leaves", "stop",
                                  "transfer_tree"])
def test_execution_stats_equal_jax(name, port_side, jax_side):
    assert port_side["runs"][name]["stats"] == jax_side["runs"][name]


def test_uneven_boundaries_round_trip(port_side):
    run = port_side["runs"]["uneven_1d"]
    x = torch.arange(6, dtype=torch.float32)
    assert torch.equal(run["moved"], x) and torch.equal(run["back"], x)
    # Dim 0 over x (2 ways) and replicated over y (4): 4 copies a byte.
    assert run["stats"]["bytes"] == 4 * x.nbytes
    assert str(run["placements"]) == "(Shard(dim=0), Replicate())"


def test_uneven_2d_cross_axis(port_side):
    run = port_side["runs"]["uneven_2d"]
    assert torch.equal(run["moved"], torch.arange(24, dtype=torch.float32).reshape(6, 4))
    assert run["stats"]["segments"] == 16 and run["stats"]["bytes"] == 24 * 4


@pytest.mark.parametrize("name,copies", [("replicated_to_sharded", 1),
                                         ("sharded_to_replicated", 8)])
def test_replication_priced(name, copies, port_side):
    run = port_side["runs"][name]
    assert torch.equal(run["moved"], torch.arange(16, dtype=torch.float32).reshape(4, 4))
    assert run["stats"]["bytes"] == copies * 16 * 4


@pytest.mark.parametrize("dtype", ["torch.int8", "torch.uint8", "torch.bfloat16"])
def test_dtype_preserved_bit_for_bit(dtype, port_side):
    q_dtype, scale_dtype, equal, placements = port_side["runs"]["dtypes"][dtype]
    assert str(q_dtype) == dtype and scale_dtype == torch.float32
    assert equal
    assert str(placements) == "(Replicate(), Shard(dim=1))"


def test_host_numpy_leaves_committed(port_side):
    run = port_side["runs"]["host_leaves"]
    assert run["mode"] == "host"
    np.testing.assert_array_equal(run["w"].numpy(), np.arange(32, dtype=np.float32).reshape(4, 8))
    assert run["b"] == 3.0
    assert str(run["placements"]) == "(Shard(dim=0), Shard(dim=1))"


def test_auto_picks_device_path_on_one_mesh(port_side):
    run = port_side["runs"]["auto_same_mesh"]
    assert run["mode"] == "device"
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    for key in ("device", "host", "again"):
        assert torch.equal(run[key], x)
    assert str(run["placements"]) == "(Replicate(), Shard(dim=1))"


def test_auto_takes_host_path_across_meshes(port_side):
    run = port_side["runs"]["auto_cross_mesh"]
    assert run["mode"] == "host"
    assert torch.equal(run["moved"], torch.arange(8, dtype=torch.float32))
    # Ranks 4-7 hold no part of the (1, 4) destination.
    assert [outside for _, outside in port_side["ranks"]] == [False] * 4 + [True] * 4


def test_move_between_meshes_that_leave_ranks_out_is_refused(port_side):
    sides = port_side["runs"]["part_of_world"]
    for msg in sides[:3]:
        assert "ranks [0, 1, 2] of a world of 8" in msg
    assert sides[3:] == [None] + [4.0] * 4


def test_device_reshard_rejects_foreign_devices(port_side):
    assert "not on the destination's devices" in port_side["runs"]["device_foreign"]


def test_plan_cache_reused_across_trees(port_side):
    assert port_side["runs"]["plan_cache"] == (2, 2)


def test_cross_mesh_pages_round_trip(port_side):
    run = port_side["runs"]["cross_mesh_pages"]
    x = torch.arange(16 * 4 * 8, dtype=torch.float32).reshape(16, 4, 8)
    assert torch.equal(run["moved"], x) and torch.equal(run["back"], x)
    assert run["stats"]["bytes"] == x.nbytes == run["bytes_total"]


def test_stop_clips_pages_and_counts_less(port_side):
    run = port_side["runs"]["stop"]
    x = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    assert torch.equal(run["moved"][:5], x[:5])
    assert not run["moved"][8:].any()
    assert run["stats"]["segments_skipped"] > 0 and run["stats"]["bytes"] < x.nbytes


def test_replicated_destination_priced_per_copy(port_side):
    run = port_side["runs"]["replicated_destination"]
    assert torch.equal(run["moved"], torch.arange(32, dtype=torch.float32).reshape(8, 4))
    assert run["stats"]["bytes"] == 2 * 32 * 4


def test_transfer_tree_scalars_and_plan_cache(port_side):
    run = port_side["runs"]["transfer_tree"]
    assert int(run["idx"]) == 7
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    assert torch.equal(run["k"], x) and torch.equal(run["again"], x)
    assert run["plans"][0] == run["plans"][1] == 2


def test_host_endpoints_give_every_rank_the_rows(port_side):
    run = port_side["runs"]["host"]
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    assert run["rows"].device.type == "cpu" and torch.equal(run["rows"], x)
    assert torch.equal(run["filled"], x) and run["local"] == (2, 1)
    assert run["stats"][0]["bytes"] == run["stats"][1]["bytes"] == x.nbytes
    for rows, _ in port_side["ranks"]:
        assert torch.equal(rows, x)


def test_one_device_layouts():
    """A plain tensor's layout is its device: the device path keeps it, the
    host path moves it whole, a ``stop`` clips it; host memory at either
    end returns a CPU tensor."""
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    assert rs.sharding_of(x) == torch.device("cpu")
    out, st = rs.reshard_tree({"w": x}, {"w": torch.device("cpu")})
    assert st["mode"] == "device" and out["w"] is x
    out, st = rs.reshard_tree({"w": x}, {"w": torch.device("cpu")}, mode="host")
    assert st == {"bytes": x.nbytes, "raw_bytes": x.nbytes, "segments": 1,
                  "segments_skipped": 0, "mode": "host"}
    assert torch.equal(out["w"], x) and out["w"] is not x
    rows, st = rs.transfer_tree({"k": x}, {"k": torch.device("cpu")}, stop=3, page_tokens=2)
    assert torch.equal(rows["k"][:3], x[:3]) and not rows["k"][4:].any()
    assert st["segments"] == 2 and st["segments_skipped"] == 1
    plan = rs.plan_transfer(x.shape, 4, torch.device("cpu"), rs.HostBuffer())
    host, _ = rs.execute_transfer(plan, x)
    assert torch.equal(host, x)


def test_later_slices_raise_naming_them():
    plan = rs.plan_transfer((4,), 4, torch.device("cpu"), rs.HostBuffer())
    with pytest.raises(NotImplementedError, match="slice G"):
        plan.domain_split(None)
    with pytest.raises(NotImplementedError, match="slice F"):
        rs.plan_transfer((4,), 4, torch.device("cpu"), rs.HostBuffer(), codec="int8")
    with pytest.raises(ValueError, match="unknown mode"):
        rs.reshard_tree([], [], mode="fast")
