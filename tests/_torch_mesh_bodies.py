"""Rank bodies of the port's mesh tests (not a test module).

``parallel.run_on_mesh`` spawns one process a rank and runs a function of
this module there (``parallel.run_on_threads`` runs it on thread ranks of
the test process), so it imports torch and the port only (no JAX): the
test modules compute the JAX side in their own process and compare with
what rank 0 returns here.
"""

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.parallel import (
    collective_counts,
    is_fully_replicated,
    put,
    shard_dims,
    shard_shapes,
    unique_shard_count,
)
from learning_jax_sharding_tpu_torch.parallel import collectives as coll
from learning_jax_sharding_tpu_torch.parallel import logical
from learning_jax_sharding_tpu_torch.parallel.hlo import counting

# Cases 1a-4 on the (2, 4) x × y mesh: the operands' placements (shard_dims
# keywords) and C's placement as GSPMD lays it out.
CASES = {
    "1a": (dict(y=1), dict(y=0), ()),
    "1b": (dict(y=1), dict(x=0), ()),
    "2": (dict(x=0, y=1), dict(x=0), ("x", None)),
    "3": (dict(x=0, y=1), dict(x=0, y=1), ("x", "y")),
    "4": (dict(x=0), dict(y=1), ("x", "y")),
}


def _fulls(x):
    return x.full_tensor().detach().numpy().copy()


def parallel_body(mesh, a_host, b_host):
    """Every case's shard shapes, distinct shards, replication and
    collectives; the five collective matmuls' results and collectives."""
    out = {"cases": {}, "matmuls": {}}
    for name, (sa, sb, sc) in CASES.items():
        a = put(a_host, shard_dims(mesh, 2, **sa))
        b = put(b_host, shard_dims(mesh, 2, **sb))
        target = shard_dims(mesh, 2, **{ax: d for d, ax in enumerate(sc) if ax})

        def matmul(a, b, target=target):
            return (a @ b).redistribute(mesh, target.placements)

        c = matmul(a, b)
        out["cases"][name] = dict(
            a=shard_shapes(a), b=shard_shapes(b), c=shard_shapes(c),
            unique=unique_shard_count(c), replicated=is_fully_replicated(c),
            counts=collective_counts(matmul, a, b), value=_fulls(c),
        )
    a_y, b_x = put(a_host, shard_dims(mesh, 2, y=1)), put(b_host, shard_dims(mesh, 2, x=0))
    calls = {
        "psum": lambda: coll.psum_matmul(a_host, b_host, mesh=mesh, axis="y"),
        "allgather": lambda: coll.allgather_matmul(a_y, b_x, mesh=mesh, a_axis="y", b_axis="x"),
        "reduce_scatter": lambda: coll.reduce_scatter_matmul(a_host, b_host, mesh=mesh, axis="y"),
        "dp_tp": lambda: coll.dp_tp_matmul(a_host, b_host, mesh=mesh, dp_axis="x", tp_axis="y"),
        "ring": lambda: coll.ring_allgather_matmul(a_host, b_host, mesh=mesh, axis="y"),
    }
    for name, call in calls.items():
        with counting() as counts:
            c = call()
        out["matmuls"][name] = dict(value=_fulls(c), counts=counts, c=shard_shapes(c))
    return out


def train_body(mesh, state_dict, batch, rules_names, steps, snapshot, flash):
    """The sharded CONFIG_TINY train step under each rule set: rank 0's local
    shape of every parameter, ``steps`` losses, and the parameters after
    ``snapshot`` steps; then the flash attn_fn over the mesh, its output and
    gradients."""
    from learning_jax_sharding_tpu_torch.models.transformer import (
        CONFIG_TINY,
        Transformer,
        next_token_loss,
    )
    from learning_jax_sharding_tpu_torch.ops.flash_attention import make_flash_attn_fn
    from learning_jax_sharding_tpu_torch.training.loop import adamw
    from learning_jax_sharding_tpu_torch.training.pipeline import (
        make_train_step,
        sharded_train_state,
    )

    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name in rules_names:
        model = Transformer(CONFIG_TINY, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
        rules = getattr(logical, name)
        state = sharded_train_state(model, adamw(3e-4), mesh=mesh, rules=rules)
        shapes = {n: tuple(p.to_local().shape) for n, p in state.model.named_parameters()}
        step = make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=rules)
        losses, params = [], None
        for i in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
            if i + 1 == snapshot:
                params = {n: _fulls(p.detach()) for n, p in state.model.named_parameters()}
        out[name] = dict(shapes=shapes, losses=losses, params=params)
    # The kernels' path (flash, fused norm, fused loss) over the mesh, and
    # the same steps on one device from the same weights.
    import dataclasses
    import functools

    from learning_jax_sharding_tpu_torch.models.transformer import fused_next_token_loss

    fused_loss = dict(loss_fn=functools.partial(fused_next_token_loss, chunk_size=16),
                      loss_needs_params=True, apply_kwargs={"return_hidden": True})
    kernel_losses = {}
    for name, m in (("mesh", mesh), ("one", None)):
        rules = logical.RULES_DP_TP_SP if m is not None else None
        attn = (make_flash_attn_fn(m, rules, block_q=16, block_k=16) if m is not None
                else make_flash_attn_fn(block_q=16, block_k=16))
        model = Transformer(dataclasses.replace(CONFIG_TINY, attn_fn=attn, fused_norm=True),
                            device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
        state = sharded_train_state(model, adamw(3e-4), mesh=m, rules=rules)
        fused_step = make_train_step(mesh=m, rules=rules, **fused_loss)
        kernel_losses[name] = [float(fused_step(state, batch)[1]) for _ in range(snapshot + 1)]
    out["kernel_path"] = kernel_losses
    q, k, v, dout = (torch.from_numpy(flash[n]).requires_grad_(n != "dout")
                     for n in ("q", "k", "v", "dout"))
    attn = make_flash_attn_fn(mesh, logical.RULES_DP_TP_SP, block_q=16, block_k=16)
    with logical.activate(mesh, logical.RULES_DP_TP_SP):
        o = attn(q, k, v, causal=True)
        placements = o.placements
        o = o.full_tensor()
    (o * dout).sum().backward()
    out["flash"] = dict(out=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(),
                        dv=v.grad.numpy(), placements=[repr(p) for p in placements])
    return out


def generate_body(mesh, float_sd, q4_sd, prompt, new, group, decode_args, int4_args):
    """Tensor-parallel greedy generate of CONFIG_TINY (the blocked decode
    backend, int4 group ``group``) in float, "fused" and "fused_w4a8"; then
    the per-shard decode-attention and int4 wrappers on given inputs."""
    import dataclasses

    from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
    from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
    from learning_jax_sharding_tpu_torch.ops import decode_attention as da
    from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4

    rules = logical.RULES_DP_TP
    cfg = dataclasses.replace(CONFIG_TINY, quantization_group=group, decode_attention="blocked")
    trees = {"float": float_sd, "fused": q4_sd, "fused_w4a8": q4_sd}
    out = {"tokens": {}}
    for mode, tree in trees.items():
        gen = make_generate_fn(cfg, mesh, rules, max_new_tokens=new,
                               dequantize=False if mode == "float" else mode)
        params = {k: torch.from_numpy(v) for k, v in tree.items()}
        out["tokens"][mode] = gen(params, torch.from_numpy(prompt)).numpy()
    t = {k: torch.from_numpy(v) for k, v in decode_args.items()}
    attn = da.make_decode_attn_fn(mesh, rules)
    out["decode"] = _fulls(attn(t["q"], t["kc"], t["vc"], torch.tensor(t["index"].item())))
    out["int4"] = {}
    for (name, axes), (x, q4, sc) in int4_args.items():
        for w4a8 in (False, True):
            fn = mm4.make_int4_matmul_fn(mesh, rules, w4a8=w4a8)
            got = fn(torch.from_numpy(x), torch.from_numpy(q4), torch.from_numpy(sc),
                     group=group, kernel_axes=axes)
            out["int4"][name, w4a8] = (_fulls(got), [repr(p) for p in got.placements])
    return out


def failing_body(mesh):
    """Rank 1 raises; the others wait in a collective that never completes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one's own failure")
    dist.barrier()


def _lists(tokens):
    return [np.asarray(t).tolist() for t in tokens]


def stamped_stream(eng, params, prompts, stamps):
    """Add ``prompts`` under ids 0, 1, ... with the arrival stamps ``stamps``
    (None: unstamped), then step ``eng`` (the port's engine or JAX's) until
    it is idle → (the ids each step retired, {id: tokens})."""
    for rid, (p, t) in enumerate(zip(prompts, stamps)):
        eng.add_request(p, rid=rid, arrival_t=t)
    steps, done = [], {}
    while eng.has_work():
        steps.append(sorted(eng.step(params)))
        done.update(eng.pop_finished())
    return steps, {rid: np.asarray(t).tolist() for rid, t in sorted(done.items())}


def serve_cases(mesh, cases, trees, queues):
    """Serve each case's queue through one port engine, over ``mesh`` (under
    the case's rules) or on the CPU (``mesh=None``) → ``{case: {"tokens",
    "stats", "forwards", "dispatches"}}``, one entry a ``serve`` call for
    the tokens, stats and dispatch counts. A case is a dict of ``rules``
    (a ``parallel.logical`` name), ``queue``, ``cfg`` (config fields),
    ``engine`` (engine arguments), ``tree`` (a key of ``trees``), ``draft``
    (``None``, ``"self"`` or a key of ``trees``), ``rng`` and ``calls``."""
    import dataclasses

    from learning_jax_sharding_tpu_torch.models.serving import make_continuous_engine
    from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY

    out = {}
    for name, case in cases.items():
        cfg = dataclasses.replace(CONFIG_TINY, **case["cfg"])
        engine = dict(case["engine"])
        draft = case.get("draft")
        if draft is not None:
            engine["draft_config"] = cfg if draft == "self" else dataclasses.replace(
                cfg, **case["draft_cfg"])
        rules = None if mesh is None else getattr(logical, case["rules"])
        serve = make_continuous_engine(cfg, mesh, rules, device="cpu" if mesh is None else None,
                                       **engine)
        params = trees[case["tree"]]
        d_params = None if draft is None else params if draft == "self" else trees[draft]
        got = {"tokens": [], "stats": [], "dispatches": []}
        for _ in range(case.get("calls", 1)):
            got["tokens"].append(_lists(serve(params, queues[case["queue"]], rng=case.get("rng"),
                                              draft_params=d_params)))
            got["stats"].append(serve.last_stats)
            lat = serve.last_latency
            got["dispatches"].append({k: lat[k] for k in ("refill_dispatches",
                                                          "decode_dispatches",
                                                          "mixed_dispatches")})
        got["forwards"] = (serve.engine.model_forwards, serve.engine.draft_forwards)
        out[name] = got
    return out


def registry_counts(registry):
    """Every count a metrics registry holds: counters and gauges (but those
    of seconds and burn rates), histograms' observation counts."""
    out = {}
    for key, value in registry.snapshot().items():
        if isinstance(value, dict):
            out[key] = value["count"]
        elif "seconds" not in key and "burn_rate" not in key:
            out[key] = value
    return out


def policy_cases(mesh, cfg_fields, engine, params, prompts, threads=None):
    """The recovery policies through port engines of ``engine`` arguments,
    over ``mesh`` under ``RULES_DP_TP`` (or on the CPU, ``mesh=None``): a
    request past its deadline beside one within it, a bounded queue's shed,
    and a sticky fault on request 1's dispatches (quarantine with
    probation). → ``{case: (each request's (status, tokens), the registry's
    counts)}``. On thread ranks (``threads``, by default whether ``mesh`` is
    given) the one chaos injector is the process's: the world's first rank
    installs it between barriers of the world."""
    import dataclasses

    import torch.distributed as dist

    from learning_jax_sharding_tpu_torch.models.serving import AdmissionError, ContinuousEngine
    from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY
    from learning_jax_sharding_tpu_torch.robustness import ChaosInjector, Fault
    from learning_jax_sharding_tpu_torch.telemetry import FlightRecorder

    cfg = dataclasses.replace(CONFIG_TINY, **cfg_fields)
    rules = None if mesh is None else logical.RULES_DP_TP

    def make(**extra):
        return ContinuousEngine(cfg, mesh, rules, device="cpu" if mesh is None else None,
                                **engine, **extra)

    def drain(eng):
        done = {}
        while eng.has_work():
            eng.step(params)
            done.update(eng.pop_finished())
        return {rid: ("ok", r.tolist()) if isinstance(r, np.ndarray) else
                (r.status, None if r.tokens is None else np.asarray(r.tokens).tolist())
                for rid, r in sorted(done.items())}

    out = {}
    eng = make()
    eng.add_request(prompts[0], rid=0, deadline_s=60.0)
    eng.add_request(prompts[1], rid=1, deadline_s=1e-6)
    out["deadline"] = (drain(eng), registry_counts(eng.registry))
    eng = make(max_queue=2)
    shed = []
    for rid, p in enumerate(prompts[:3]):
        try:
            eng.add_request(p, rid=rid)
        except AdmissionError as exc:
            shed.append(str(exc))
    out["shed"] = (drain(eng), registry_counts(eng.registry), shed)
    eng = make()
    for rid, p in enumerate(prompts):
        eng.add_request(p, rid=rid)
    inj = ChaosInjector(Fault("engine.dispatch", "hang", rid=1, count=-1),
                        recorder=FlightRecorder())
    threads = mesh is not None if threads is None else threads
    first = not threads or dist.get_rank() == 0
    if threads:
        dist.barrier()
    if first:
        inj.__enter__()
    if threads:
        dist.barrier()
    try:
        out["quarantine"] = (drain(eng), registry_counts(eng.registry))
    finally:
        if threads:
            dist.barrier()
        if first:
            inj.__exit__(None, None, None)
    return out


def mid_dispatch_fault(mesh, cfg_fields, engine, params, prompts):
    """A ``FloatingPointError`` (a NaN trap's) raised by the second model
    call of a serve, inside the dispatch and past its chaos seam, through a
    port engine of ``engine`` arguments over ``mesh`` under ``RULES_DP_TP``
    (or on the CPU, ``mesh=None``). → ``("raised", the error)`` when it left
    ``step()``, else ``("recovered", the dispatch faults counted)``."""
    import dataclasses

    from learning_jax_sharding_tpu_torch.models.serving import ContinuousEngine
    from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY

    cfg = dataclasses.replace(CONFIG_TINY, **cfg_fields)
    eng = ContinuousEngine(cfg, mesh, None if mesh is None else logical.RULES_DP_TP,
                           device="cpu" if mesh is None else None, **engine)
    forward, calls = eng._forward, []

    def trapped(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise FloatingPointError("non-finite values in a model call's output")
        return forward(*args, **kwargs)

    eng._forward = trapped
    for rid, p in enumerate(prompts):
        eng.add_request(p, rid=rid)
    try:
        while eng.has_work():
            eng.step(params)
    except FloatingPointError as exc:
        return "raised", str(exc)
    return "recovered", eng.registry.snapshot()["engine_dispatch_faults_total"]


def mid_dispatch_fault_body(mesh, cfg_fields, engine, params, prompts):
    """``mid_dispatch_fault`` over the thread ranks' ``mesh``. → every
    rank's result."""
    import torch.distributed as dist

    out = mid_dispatch_fault(mesh, cfg_fields, engine, params, prompts)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    return ranks


def small_mesh_policy_body(mesh, cfg_fields, engine, params, prompts):
    """``policy_cases`` on a (1, 2) mesh of the first two ranks of the
    world ``mesh`` spans, while every other rank serves alone on its CPU:
    the mesh engine's agreements must stay inside its own groups. → every
    rank's results."""
    import warnings

    import torch.distributed as dist

    from learning_jax_sharding_tpu_torch.parallel import build_mesh

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # "uses only 2 of 4 devices"
        sub = build_mesh((1, 2), mesh.mesh_dim_names, device_type="cpu")
    inside = sub.get_coordinate() is not None
    out = policy_cases(sub if inside else None, cfg_fields, engine, params, prompts,
                       threads=True)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (inside, out))
    return ranks


def mesh_serving_body(mesh, cases, trees, queues, generate, stamped, policies):
    """The engine cases over the mesh; ``stamped_stream`` under
    ``RULES_DP_TP`` through an engine of ``stamped["engine"]`` arguments;
    ``policy_cases`` with the ``policies`` arguments;
    paged serving under ``RULES_DP_TP`` (which must raise ``ValueError``);
    ragged greedy ``make_generate_fn`` and ragged speculative generate over
    the mesh. Every rank's results are gathered: → ``(rank 0's results,
    every rank's engine and stamped results)``."""
    import dataclasses

    import torch.distributed as dist

    from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
    from learning_jax_sharding_tpu_torch.models.serving import make_continuous_engine
    from learning_jax_sharding_tpu_torch.models.speculative import make_speculative_generate_fn
    from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY

    out = {"engine": serve_cases(mesh, cases, trees, queues)}
    cfg = dataclasses.replace(CONFIG_TINY, **generate["cfg"])
    eng = make_continuous_engine(cfg, mesh, logical.RULES_DP_TP, **stamped["engine"]).engine
    out["stamped"] = stamped_stream(eng, trees["float"], stamped["prompts"], stamped["stamps"])
    out["policies"] = policy_cases(mesh, generate["cfg"], policies["engine"], trees["float"],
                                   policies["prompts"])
    serve = make_continuous_engine(cfg, mesh, logical.RULES_DP_TP, paged_pages=9, page_size=16,
                                   **generate["engine"])
    try:
        serve(trees["float"], queues["mixed"])
        out["paged_dp_tp"] = None
    except ValueError as exc:
        out["paged_dp_tp"] = str(exc)
    prompt, lengths = (torch.from_numpy(generate[k]) for k in ("prompt", "lengths"))
    gen = make_generate_fn(cfg, mesh, logical.RULES_DP_TP, max_new_tokens=generate["new"],
                           ragged=True)
    out["ragged"] = gen(trees["float"], prompt, lengths=lengths).numpy()
    spec = make_speculative_generate_fn(
        cfg, dataclasses.replace(cfg, **generate["draft_cfg"]), mesh, logical.RULES_DP_TP,
        max_new_tokens=generate["new"], num_draft=2, ragged=True)
    out["spec_ragged"] = spec(trees["float"], trees["draft"], prompt, lengths=lengths).numpy()
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {**out["engine"], "stamped": out["stamped"],
                                   "policies": out["policies"]})
    return out, ranks


def mesh_decode_attention_body(mesh, calls):
    """``make_decode_attn_fn`` over the mesh on each call's numpy inputs
    (``{"rules", "args", "kwargs"}``; the folded write's caches are passed as
    full tensors) → ``{name: (outputs, specs)}``: the outputs whole and the
    ``PartitionSpec`` each is laid out as; a call that raises ``ValueError``
    gives its message."""
    from learning_jax_sharding_tpu_torch.ops import decode_attention as da
    from learning_jax_sharding_tpu_torch.parallel.sharding import placements_to_spec

    out = {}
    for name, call in calls.items():
        fn = da.make_decode_attn_fn(mesh, getattr(logical, call["rules"]))
        args = [torch.from_numpy(np.asarray(a)) for a in call["args"]]
        kwargs = {k: torch.from_numpy(np.asarray(v)) for k, v in call["kwargs"].items()}
        try:
            got = fn(*args, **kwargs)
        except ValueError as exc:
            out[name] = str(exc)
            continue
        got = got if isinstance(got, tuple) else (got,)
        out[name] = ([_fulls(g) for g in got],
                     [tuple(placements_to_spec(mesh, g.placements, g.ndim)) for g in got])
    return out


def fit_body(mesh, state_dict, dataset, fields, ckpt_dir):
    """``training.loop.fit`` of CONFIG_TINY over the mesh under
    RULES_DP_TP from ``state_dict``, checkpointing its last step into
    ``ckpt_dir``: the losses, the final parameters and AdamW first moments
    (whole)."""
    from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY, Transformer
    from learning_jax_sharding_tpu_torch.training.loop import TrainLoopConfig, fit

    model = Transformer(CONFIG_TINY, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    cfg = TrainLoopConfig(global_batch_size=8, checkpoint_dir=ckpt_dir,
                          checkpoint_every=fields["steps"], **fields)
    state, history = fit(model, dataset, mesh, logical.RULES_DP_TP, cfg)
    named = list(state.model.named_parameters())
    return dict(losses=[h["loss"] for h in history],
                params={n: _fulls(p.detach()) for n, p in named},
                exp_avg={n: _fulls(state.optimizer.state[p]["exp_avg"]) for n, p in named})


def checkpoint_body(mesh, state_dict, batch, save_dir, load_dir):
    """CONFIG_TINY under RULES_DP_TP over the mesh: two AdamW steps saved
    into ``save_dir`` (every rank its shards), and a fresh mesh state
    restored from ``load_dir`` (saved on one device): both whole, with the
    restored parameters' local shapes on this rank."""
    from learning_jax_sharding_tpu_torch.models.transformer import (
        CONFIG_TINY,
        Transformer,
        next_token_loss,
    )
    from learning_jax_sharding_tpu_torch.training.checkpoint import CheckpointManager
    from learning_jax_sharding_tpu_torch.training.loop import adamw
    from learning_jax_sharding_tpu_torch.training.pipeline import (
        make_train_step,
        sharded_train_state,
    )

    def state_of(seed):
        model = Transformer(CONFIG_TINY, device="cpu", seed=seed)
        if seed == 0:
            model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
        return sharded_train_state(model, adamw(3e-3), mesh=mesh, rules=logical.RULES_DP_TP)

    def whole(state):
        named = list(state.model.named_parameters())
        return dict(step=state.step,
                    params={n: _fulls(p.detach()) for n, p in named},
                    exp_avg_sq={n: _fulls(state.optimizer.state[p]["exp_avg_sq"])
                                for n, p in named})

    state = state_of(0)
    step = make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=logical.RULES_DP_TP)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        step(state, batch)
    with CheckpointManager(save_dir) as ckpt:
        assert ckpt.save(2, state)
    saved = whole(state)
    fresh = state_of(7)
    with CheckpointManager(load_dir) as ckpt:
        ckpt.restore_latest(like=fresh)
    restored = whole(fresh)
    restored["local"] = {n: tuple(p.to_local().shape) for n, p in fresh.model.named_parameters()}
    return dict(saved=saved, restored=restored)



def backward_thread_body(mesh):
    """Fault F9: whether a backward may run on another thread (CUDA
    autograd's device thread) before, inside and after ``activate``."""
    from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_SP, activate

    before = torch._C._is_multithreading_enabled()
    with activate(mesh, RULES_DP_SP):
        inside = torch._C._is_multithreading_enabled()
    return before, inside, torch._C._is_multithreading_enabled()
