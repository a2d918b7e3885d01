"""The mesh paths across cards: a (2, 2) data × model mesh, one NCCL rank a card.

    python -m learning_jax_sharding_tpu_torch.scripts.mesh_cards [--parts all|base|seq,moe]

Needs four GPUs (``chip_smoke.py`` runs :func:`run` with the four ranks as
threads of one process on one card). On card 0 the parent runs the
unsharded calls: the 125M fused-norm train call (b=8, s=1024, bf16, flash,
fused loss, AdamW, ``STEPS`` steps) and the float and
int4-fused greedy generates (b=8, 128 + 128). Then four spawned ranks
(``parallel.run_on_mesh``, NCCL) run the same calls over the mesh from the
same seeded weights: the train step under ``RULES_DP_TP_SP``, the generates
under ``RULES_DP_TP``, the kernels on each rank's shard. Printed: the
losses against the one-card losses (bf16, another order of reduction:
within ``LOSS_RTOL`` relative), the generated tokens against the one-card
tokens (the share equal and the first step that differs) and held to
the dense bf16 model on one card, teacher-forced (the generated token's
logit within ``TF_GAP`` of its position's max: a greedy pick among
near-ties, as bf16 partial sums reduced across ranks can flip), rank 0's
kernel launches (held to :func:`tp_launches`), and host-clock ms a step and
a token step on both sides with the cards' name and power limit. The last
line is one JSON object of all of it; the run fails when a loss, a gap or
the launches leave their bounds, or a rank fails.

The sequence-parallel and MoE parts (``seq``, ``moe``): the long-context
train step (``bench.py::bench_longcontext``'s shape: 6 heads x 128,
S=8192, b=2, sgd) on card 0 with the flash kernels, then on the (2, 2)
mesh under ``RULES_DP_SP`` with ring attention (under remat) and with
Ulysses over the flash kernels (losses within ``SEQ_LOSS_RTOL`` of card
0's, every rank equal, ms a step); and ``moe_a2a_ff`` at the 125M MoE
layer's widths (fp32, 4 x 1024 tokens, E=8, top-2) under
``RULES_DP_EP_A2A`` (experts over ``data``), each rank holding the output
and the gradients to the einsum dispatch run per token group on its own
card (``A2A_TOL``), and ms of the forward and backward. ``--parts seq,moe``
runs only those (``base``: only the train call and the generates).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.quantize import dequantize_tree, quantize_tree
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_125M,
    Transformer,
    fused_next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops import decode_attention as da
from learning_jax_sharding_tpu_torch.ops import flash_attention as flash
from learning_jax_sharding_tpu_torch.ops import fused_norm as norm_ops
from learning_jax_sharding_tpu_torch.ops import int4_ff as ff4
from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4
from learning_jax_sharding_tpu_torch.parallel import logical, run_on_mesh
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import (
    make_train_step,
    sharded_train_state,
)

SHAPE = (2, 2)
B, S, STEPS, CHUNK = 8, 1024, 4, 128
PROMPT, NEW = 128, 128
LOSS_RTOL = 1e-3
TF_GAP = 0.1
TRAIN_RULES, GENERATE_RULES = "RULES_DP_TP_SP", "RULES_DP_TP"
ROUNDS = 3
# The sequence-parallel steps (bench.py::bench_longcontext) and the MoE
# layer of the all-to-all dispatch (bench.py::bench_moe_125m's widths).
SEQ_B, SEQ_FIELDS, SEQ_LR = 2, dict(num_heads=6, head_dim=128, max_seq_len=8192), 3e-4
SEQ_LOSS_RTOL = 1e-2
A2A_TOKENS, A2A_EXPERTS, A2A_TOL = 4 * 1024, 8, dict(out=(1e-5, 1e-5), grad=(2e-4, 2e-4))
PARTS = ("base", "seq", "moe")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _launches() -> dict:
    """Every counter of the kernels on these paths."""
    return {**{f"flash_{k}": v for k, v in flash.flash_attention.launches.items()},
            **{f"fused_norm_{k}": v for k, v in norm_ops.fused_residual_norm.launches.items()},
            "decode_attention": da.decode_attention.launches,
            "int4_matmul": mm4.int4_matmul.launches["w4a16"],
            "int4_matmul3": mm4.int4_matmul3.launches, "int4_ff": ff4.int4_ff.launches}


def _reset() -> None:
    flash.flash_attention.launches = dict.fromkeys(flash.flash_attention.launches, 0)
    norm_ops.fused_residual_norm.launches = dict.fromkeys(
        norm_ops.fused_residual_norm.launches, 0)
    da.decode_attention.launches = 0
    mm4.int4_matmul.launches = dict.fromkeys(mm4.int4_matmul.launches, 0)
    mm4.int4_matmul3.launches = 0
    ff4.int4_ff.launches = 0


def _timed(call) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _inputs():
    """Seeded on the host, the same on every process."""
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, CONFIG_125M.vocab_size, (B, S + 1), generator=gen)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    stacked = {k: v.expand(STEPS, *v.shape).contiguous() for k, v in batch.items()}
    prompt = torch.randint(0, CONFIG_125M.vocab_size, (B, PROMPT), generator=gen,
                           dtype=torch.int32)
    return stacked, prompt


def teacher_forced_gap(trees: dict, mode: str, tokens: torch.Tensor) -> float:
    """Largest gap between a generated token's logit and its position's max
    logit under the dense bf16 model (int4: on the dequantized weights)."""
    cfg = dataclasses.replace(CONFIG_125M, param_dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", seed=1).eval()
    tree = trees[mode]
    model.load_state_dict(dequantize_tree(tree, torch.bfloat16) if mode != "float" else
                          {k: v.to(torch.bfloat16) for k, v in tree.items()})
    tokens = tokens.cuda()
    with torch.no_grad():
        logits = model(tokens[:, :-1]).float()[:, PROMPT - 1:]
    chosen = logits.gather(-1, tokens[:, PROMPT:, None].long())[..., 0]
    return (logits.amax(-1) - chosen).max().item()


def run(mesh=None, *, steps: int = STEPS, new: int = NEW, rounds: int = ROUNDS,
        count: bool = True) -> dict:
    """The train call (``steps`` steps) and the two generates (``new``
    tokens), over ``mesh`` or on one card → losses, tokens, launches, host
    seconds (the first call of each warms up; ``rounds`` more are timed).
    ``count=False`` leaves the launch counters alone (ranks that share a
    process share them); over a mesh rank 0 alone teacher-forces."""
    rules_t = getattr(logical, TRAIN_RULES) if mesh is not None else None
    rules_g = getattr(logical, GENERATE_RULES) if mesh is not None else None
    stacked, prompt = _inputs()
    stacked = {k: v[:steps] for k, v in stacked.items()}
    fn = flash.make_flash_attn_fn(mesh, rules_t) if mesh is not None else \
        flash.make_flash_attn_fn()
    cfg = dataclasses.replace(CONFIG_125M, attn_fn=fn, fused_norm=True)
    state = sharded_train_state(Transformer(cfg, device="cuda", seed=0), adamw(3e-4),
                                mesh=mesh, rules=rules_t)
    step = make_train_step(steps_per_call=steps, loss_fn=functools.partial(
        fused_next_token_loss, chunk_size=CHUNK), loss_needs_params=True,
        apply_kwargs={"return_hidden": True}, mesh=mesh, rules=rules_t)
    batch = {k: v.cuda() for k, v in stacked.items()}
    reset, launches = (_reset, _launches) if count else (lambda: None, lambda: None)
    reset()
    (_, losses), _ = _timed(lambda: step(state, batch))
    out = {"losses": losses.tolist(), "train_launches": launches()}
    out["train_seconds"] = [_timed(lambda: step(state, batch))[1] for _ in range(rounds)]
    del state
    torch.cuda.empty_cache()
    params = Transformer(CONFIG_125M, device="cuda", seed=0).state_dict()
    trees = {"float": params, "fused": quantize_tree(params, bits=4)}
    for mode, tree in trees.items():
        gen = make_generate_fn(CONFIG_125M, mesh, rules_g, max_new_tokens=new,
                               inference_dtype=torch.bfloat16,
                               dequantize=False if mode == "float" else mode,
                               device=None if mesh is not None else "cuda")
        reset()
        tokens, _ = _timed(lambda: gen(tree, prompt.cuda()))
        out[f"{mode}_tokens"] = tokens.cpu()
        out[f"{mode}_launches"] = launches()
        out[f"{mode}_seconds"] = [_timed(lambda: gen(tree, prompt.cuda()))[1]
                                  for _ in range(rounds)]
        if mesh is not None and dist.get_rank() == 0:
            out[f"{mode}_gap"] = teacher_forced_gap(trees, mode, tokens)
    return out


def _seq_batch(device, cfg):
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SEQ_B, cfg.max_seq_len + 1), generator=gen)
    return {"inputs": tokens[:, :-1].to(device), "targets": tokens[:, 1:].to(device)}


def run_seq(mesh=None, *, device_type: str = "cuda", cfg=None, rounds: int = ROUNDS) -> dict:
    """The long-context train step: on one card with the flash kernels, or
    over ``mesh`` (``RULES_DP_SP``) with ring attention (under remat: one
    layer's score blocks at a time) and with Ulysses over the flash
    kernels → each one's first loss, every rank's (over a mesh), and the
    host seconds of ``rounds`` more steps."""
    from learning_jax_sharding_tpu_torch.ops.ring_attention import make_ring_attn_fn
    from learning_jax_sharding_tpu_torch.ops.ulysses import make_ulysses_attn_fn
    from learning_jax_sharding_tpu_torch.training.loop import sgd

    base = cfg or dataclasses.replace(CONFIG_125M, **SEQ_FIELDS)
    batch = _seq_batch(device_type, base)
    rules = logical.RULES_DP_SP if mesh is not None else None
    if mesh is None:
        variants = {"flash": dict(attn_fn=flash.make_flash_attn_fn())}
    else:
        variants = {"ring": dict(attn_fn=make_ring_attn_fn(mesh, rules), remat=True),
                    "ulysses": dict(attn_fn=make_ulysses_attn_fn(
                        mesh, rules, attn_fn=flash.make_flash_attn_fn()))}
    loss_fn = functools.partial(fused_next_token_loss, chunk_size=CHUNK)
    out = {}
    for name, fields in variants.items():
        state = sharded_train_state(
            Transformer(dataclasses.replace(base, **fields), device=device_type, seed=0),
            sgd(SEQ_LR), mesh=mesh, rules=rules)
        step = make_train_step(loss_fn=loss_fn, loss_needs_params=True,
                               apply_kwargs={"return_hidden": True}, mesh=mesh, rules=rules)
        loss = float(step(state, batch)[1])
        ranks = [loss]
        if mesh is not None:
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, loss)
        out[name] = {"loss": loss, "rank_losses": ranks,
                     "seconds": [_timed(lambda: step(state, batch))[1] for _ in range(rounds)]}
        del state
        if device_type == "cuda":
            torch.cuda.empty_cache()
    return out


def _a2a_layer(dispatch, device_type, features, hidden, **kw):
    from learning_jax_sharding_tpu_torch.models.moe import MoEFeedForward

    return MoEFeedForward(features, hidden, num_experts=A2A_EXPERTS, top_k=2,
                          capacity_factor=1.25, dtype=torch.float32, dispatch=dispatch,
                          device=device_type,
                          generator=torch.Generator(device=device_type).manual_seed(1), **kw)


def _err(got, want, rtol, atol) -> float:
    """How far ``got`` is past ``rtol`` of ``want`` (within: ≤ ``atol``)."""
    return ((got - want).abs() - rtol * want.abs()).max().item()


def run_moe_a2a(mesh, *, device_type: str = "cuda", features: int = CONFIG_125M.features,
                hidden: int = CONFIG_125M.hidden, tokens: int = A2A_TOKENS,
                rounds: int = ROUNDS) -> dict:
    """``moe_a2a_ff`` over ``mesh`` (experts over ``data``): the output and
    every gradient, gathered whole, against the einsum dispatch run per
    token group on this rank's own card → the excesses past ``A2A_TOL``
    (within: ≤ its atol) and the host seconds of a forward and backward."""
    from learning_jax_sharding_tpu_torch.ops.moe_dispatch import make_moe_a2a_fn

    rules = logical.RULES_DP_EP_A2A
    x = torch.randn(4, tokens // 4, features,
                    generator=torch.Generator().manual_seed(2)).to(device_type)
    layer = _a2a_layer("alltoall", device_type, features, hidden,
                       dispatch_fn=make_moe_a2a_fn(mesh, rules))

    def call():
        layer.zero_grad(set_to_none=True)
        with logical.activate(mesh, rules):
            out = layer(x).full_tensor()
            torch.sin(out).sum().backward()
        return out.detach()

    out = call()
    grads = {n: p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad
             for n, p in layer.named_parameters()}
    ref_layer = _a2a_layer("einsum", device_type, features, hidden)
    groups = mesh.size(mesh.mesh_dim_names.index("data"))
    ref = torch.cat([ref_layer(xg) for xg in x.chunk(groups)])
    torch.sin(ref).sum().backward()
    return {"out_excess": _err(out, ref.detach(), *A2A_TOL["out"]),
            "grad_excess": max(_err(grads[n], p.grad, *A2A_TOL["grad"])
                               for n, p in ref_layer.named_parameters()),
            "seconds": [_timed(call)[1] for _ in range(rounds)]}


def run_new(mesh=None, *, parts=("seq", "moe")) -> dict:
    """The parts ``seq`` and ``moe`` of one process: on one card (no mesh)
    the flash step; over a mesh the ring and Ulysses steps and the
    all-to-all dispatch."""
    out = {}
    if "seq" in parts:
        out["seq"] = run_seq(mesh)
    if "moe" in parts and mesh is not None:
        out["moe"] = run_moe_a2a(mesh)
    return out


def compare_new(mesh: dict, one: dict) -> tuple[dict, list[str]]:
    """The ring and Ulysses losses against card 0's flash step, every
    rank's loss equal; the all-to-all's excesses → (result, failures)."""
    result, bad = {}, []
    if "seq" in mesh:
        ref = one["seq"]["flash"]
        result["seq_one_card_ms_per_step"] = statistics.median(ref["seconds"]) * 1e3
        for name, row in mesh["seq"].items():
            rel = abs(row["loss"] - ref["loss"]) / abs(ref["loss"])
            result[f"seq_{name}"] = dict(loss=row["loss"], one_card_loss=ref["loss"],
                                         rel_diff=rel, rank_losses=row["rank_losses"],
                                         ms_per_step=statistics.median(row["seconds"]) * 1e3)
            if not rel <= SEQ_LOSS_RTOL or len(set(row["rank_losses"])) != 1:
                bad.append(f"{name}: loss {row['rank_losses']} vs one card {ref['loss']}")
    if "moe" in mesh:
        row = mesh["moe"]
        result["moe_a2a"] = dict(row, ms=statistics.median(row["seconds"]) * 1e3)
        if not (row["out_excess"] <= A2A_TOL["out"][1]
                and row["grad_excess"] <= A2A_TOL["grad"][1]):
            bad.append(f"moe a2a past its bounds: {row}")
    return result, bad


def compare(mesh: dict, one: dict, new: int = NEW) -> dict:
    """The mesh run against the one-card run: the losses' largest relative
    difference, and per generate the share of equal new tokens, the first
    step that differs and the teacher-forced gap."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(mesh["losses"], one["losses"]))
    result = {"loss_max_rel_diff": rel,
              "losses": {"mesh": mesh["losses"], "one": one["losses"]}}
    for mode in ("float", "fused"):
        a, b = mesh[f"{mode}_tokens"], one[f"{mode}_tokens"]
        same = a[:, PROMPT:PROMPT + new] == b[:, PROMPT:PROMPT + new]
        differs = (~same).any(0).nonzero()
        result[mode] = dict(
            equal_share=same.float().mean().item(),
            first_differing_step=int(differs[0]) if len(differs) else None,
            teacher_forced_max_gap=mesh[f"{mode}_gap"])
    return result


def tp_launches(one: dict, ranks: int) -> dict:
    """The launches ``ranks`` ranks of the mesh make in all, from the
    one-card run's: each rank launches what one card does, but every int4
    q/k/v triple as three matmuls and every whole FF as two (up and down:
    the per-projection path under tensor parallelism, the JAX rule)."""
    sections = [one[f"{name}_launches"] for name in ("train", "float", "fused")]
    want = {k: ranks * sum(sec[k] for sec in sections) for k in sections[0]}
    fused = one["fused_launches"]
    want["int4_matmul"] = ranks * (fused["int4_matmul"] + 3 * fused["int4_matmul3"]
                                   + 2 * fused["int4_ff"])
    want["int4_matmul3"] = want["int4_ff"] = 0
    return want


def failures(result: dict) -> list[str]:
    """What leaves its bound: the losses past ``LOSS_RTOL``, a generate's
    teacher-forced gap past ``TF_GAP``."""
    out = []
    if not result["loss_max_rel_diff"] <= LOSS_RTOL:
        out.append(f"losses differ by {result['loss_max_rel_diff']} relative > {LOSS_RTOL}")
    gaps = {mode: result[mode]["teacher_forced_max_gap"] for mode in ("float", "fused")}
    if not all(g <= TF_GAP for g in gaps.values()):
        out.append(f"teacher-forced gaps {gaps} > {TF_GAP}")
    return out


def main() -> int:
    if torch.cuda.device_count() < SHAPE[0] * SHAPE[1]:
        print(f"mesh_cards: needs {SHAPE[0] * SHAPE[1]} GPUs, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = PARTS
    if "--parts" in sys.argv:
        arg = sys.argv[sys.argv.index("--parts") + 1]
        parts = PARTS if arg == "all" else tuple(arg.split(","))
    result, bad = {"cards": card.splitlines(), "shape": SHAPE}, []
    new_parts = tuple(p for p in parts if p != "base")
    if new_parts:
        one_new = run_new(parts=new_parts)
        mesh_new = run_on_mesh(functools.partial(run_new, parts=new_parts), SHAPE,
                               device_type="cuda", backend="nccl", timeout=1500, threads=None)
        new_result, bad = compare_new(mesh_new, one_new)
        result.update(new_result)
    if "base" in parts:
        bad += _run_base(result)
    for key, val in result.items():
        print(f"[mesh_cards] {key}: {val}", flush=True)
    print(json.dumps(result, default=str))
    for failure in bad:
        print(f"mesh_cards: {failure}", file=sys.stderr)
    return 1 if bad else 0


def _run_base(result: dict) -> list[str]:
    """The train call and the generates on card 0 and over the mesh,
    into ``result`` → the failures."""
    one = run()
    mesh = run_on_mesh(run, SHAPE, device_type="cuda", backend="nccl", timeout=1500,
                       threads=None)
    rank0 = {k: sum(mesh[f"{name}_launches"][k] for name in ("train", "float", "fused"))
             for k in mesh["train_launches"]}
    result.update({**compare(mesh, one), "launches_rank0": rank0,
                   "launches_rank0_want": tp_launches(one, 1),
                   "train_launches_rank0": mesh["train_launches"],
                   "train_ms_per_step": {k: statistics.median(r["train_seconds"]) / STEPS * 1e3
                                         for k, r in (("mesh", mesh), ("one", one))}})
    for mode in ("float", "fused"):
        result[mode].update(
            launches_rank0=mesh[f"{mode}_launches"],
            ms_per_token_step={k: statistics.median(r[f"{mode}_seconds"]) / NEW * 1e3
                               for k, r in (("mesh", mesh), ("one", one))})
    bad = failures(result)
    if rank0 != result["launches_rank0_want"]:
        bad.append(f"rank 0 launched {rank0}, want {result['launches_rank0_want']}")
    return bad


if __name__ == "__main__":
    sys.exit(main())
