"""Case 6: sharded multi-head attention: init, train and apply on the mesh.

Port of ``cases/case6_attention.py`` on a (2, 2) ``data`` × ``model`` mesh
of 4 CPU ranks under ``RULES_DP_TP_SP``: batch over data, the sequence over
model between the blocks, heads over model inside.

    python -m learning_jax_sharding_tpu_torch.cases.case6_attention
"""

import statistics
import time

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.models.attention import MultiHeadAttention
from learning_jax_sharding_tpu_torch.parallel import put, run_on_mesh, shard_shapes, visualize
from learning_jax_sharding_tpu_torch.parallel.logical import (
    BATCH,
    EMBED,
    RULES_DP_TP_SP,
    SEQ,
    logical_sharding,
)
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import (
    make_apply_fn,
    make_train_step,
    sharded_train_state,
)

B, S, M = 8, 256, 640


def body(mesh):
    rules = RULES_DP_TP_SP
    model = MultiHeadAttention(M, num_heads=8, head_dim=64, dropout_rate=0.1, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    x = put(np.random.default_rng(0).standard_normal((B, S, M)).astype(np.float32),
            logical_sharding(mesh, rules, BATCH, SEQ, EMBED))
    say(f"x{tuple(x.shape)} shard: {shard_shapes(x)[0]}  (batch over data, seq over model)")
    visualize(x[:, :, 0])

    state = sharded_train_state(model, adamw(1e-3), mesh=mesh, rules=rules)
    wq = state.model.query.weight
    say(f"Wq {tuple(wq.shape)} shard: {shard_shapes(wq)[0]}  (born sharded)")

    step = make_train_step(mesh=mesh, rules=rules)
    for i in range(3):
        state, loss = step(state, x)
        say(f"train step {i}: loss={float(loss):.2f}")

    apply_fn = make_apply_fn(mesh=mesh, rules=rules)
    y = apply_fn(state, x)
    say(f"y{tuple(y.shape)} shard: {shard_shapes(y)[0]}")
    assert shard_shapes(y)[0] == (B // 2, S // 2, M)

    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        apply_fn(state, x)
        samples.append(time.perf_counter() - t0)
    say(f"apply: {statistics.median(samples) * 1e3:.2f} ms/iter (host clock, CPU ranks)")
    say("PASS: sharded MHA init/train/apply on the data×model mesh")
    return shard_shapes(y)[0]


def main():
    return run_on_mesh(body, (2, 2), ("data", "model"))


if __name__ == "__main__":
    main()
