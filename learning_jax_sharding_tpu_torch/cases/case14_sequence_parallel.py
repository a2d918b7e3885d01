"""Case 14: sequence-parallel attention, ring against Ulysses.

Port of ``cases/case14_sequence_parallel.py``. Both strategies for
sequences too long for one device, on a (2, 4) ``data`` × ``model`` mesh
under ``RULES_DP_SP`` (the sequence over ``model``, heads unmapped, which
Ulysses needs):

* ring attention (``ops/ring_attention.py``): the sequence stays split;
  k/v blocks hop around the axis (n − 1 hops, counted as
  ``collective-permute``s) under an online softmax;
* Ulysses (``ops/ulysses.py``): one all-to-all each way swaps the sequence
  shard for a head shard, so each rank computes whole-sequence attention
  for its heads (four ``all-to-all``s, no permute); needs heads % axis = 0.

Both equal single-device dense attention, and both drive the same
transformer through a sharded train step: the strategy is one config
field (``attn_fn``). The ranks are threads of this process; the card
unless the caller asks for the CPU (no flash call here: the dense op runs
inside each strategy):

    python -m learning_jax_sharding_tpu_torch.cases.case14_sequence_parallel [--cpu]
"""

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops.attention import causal_mask, dot_product_attention
from learning_jax_sharding_tpu_torch.ops.ring_attention import make_ring_attn_fn
from learning_jax_sharding_tpu_torch.ops.ulysses import make_ulysses_attn_fn
from learning_jax_sharding_tpu_torch.parallel import collective_counts, run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_SP
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import make_train_step, sharded_train_state

B, S, N, H = 4, 64, 4, 16


def body(mesh, device_type):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, N, H)).astype(np.float32)).to(device_type)
               for _ in range(3))
    want = dot_product_attention(q, k, v, mask=causal_mask(S, device=q.device))
    ring = make_ring_attn_fn(mesh, RULES_DP_SP)
    uly = make_ulysses_attn_fn(mesh, RULES_DP_SP)

    # 1. Op-level parity: both strategies == single-device dense.
    for name, fn in (("ring", ring), ("ulysses", uly)):
        err = float((fn(q, k, v, causal=True).full_tensor() - want).abs().max())
        assert err <= 2e-5, f"{name}: max abs err {err:.3g}"
    say(f"parity vs dense (B{B} S{S} N{N} H{H}): ring OK, ulysses OK")

    # 2. The collectives are what the designs say they are.
    counts_ring = collective_counts(lambda: ring(q, k, v, causal=True))
    counts_uly = collective_counts(lambda: uly(q, k, v, causal=True))
    say(f"ring:    {counts_ring}")
    say(f"ulysses: {counts_uly}")
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    assert counts_ring["collective-permute"] == 2 * (n - 1), "ring must hop k/v n - 1 times"
    assert counts_ring["all-to-all"] == 0
    assert counts_uly["all-to-all"] == 4, "Ulysses swaps q, k, v in and the output back"
    assert counts_uly["collective-permute"] == 0
    # CommDebugMode's module hooks are global while any rank counts: no rank
    # trains until every rank has left it.
    dist.barrier()

    # 3. Both drive a full sharded train step.
    losses = {}
    tokens = torch.from_numpy(rng.integers(0, CONFIG_TINY.vocab_size, (8, 33)).astype(np.int64))
    batch = {"inputs": tokens[:, :-1].to(device_type), "targets": tokens[:, 1:].to(device_type)}
    for name, fn in (("ring", ring), ("ulysses", uly)):
        cfg = dataclasses.replace(CONFIG_TINY, attn_fn=fn)
        state = sharded_train_state(Transformer(cfg, device=device_type, seed=0), adamw(3e-4),
                                    mesh=mesh, rules=RULES_DP_SP)
        step = make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=RULES_DP_SP)
        losses[name] = float(step(state, batch)[1])
        assert np.isfinite(losses[name])
        say(f"{name} train step on the dp x sp mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
            f": loss {losses[name]:.4f}")
    # One init, one batch, the same function: the two losses agree.
    assert abs(losses["ring"] - losses["ulysses"]) <= 1e-5 * abs(losses["ring"])
    say("PASS: ring and Ulysses sequence parallelism, op parity through train step")
    return dict(ring=counts_ring, ulysses=counts_uly, losses=losses)


def main(device_type: str = "cuda"):
    """Run the case on a (2, 4) mesh of thread ranks on ``device_type``."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    return run_on_threads(body, (2, 4), ("data", "model"), device_type=device_type,
                          args=(device_type,))


if __name__ == "__main__":
    main(device_type="cpu" if "--cpu" in sys.argv[1:] else "cuda")
