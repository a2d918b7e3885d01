"""Case 5: logical rules place a Q projection's kernel, not the model.

Port of ``cases/case5_attention_dense.py`` on a (2, 2) ``data`` × ``model``
mesh of 4 CPU ranks: the reference's minimal attention (its Q projection),
whose kernel carries the logical axes ``(EMBED, KV)``; two rule sets split
it two ways, and a train step runs under each.

    python -m learning_jax_sharding_tpu_torch.cases.case5_attention_dense
"""

import numpy as np
import torch
from torch import nn

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.models.attention import make_linear
from learning_jax_sharding_tpu_torch.parallel import put, run_on_mesh, shard_shapes, visualize
from learning_jax_sharding_tpu_torch.parallel.logical import (
    BATCH,
    EMBED,
    KV,
    SEQ,
    constrain,
    logical_sharding,
)
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import (
    make_train_step,
    sharded_train_state,
)

B, S, M = 8, 256, 640
INNER = 8 * 64  # heads × head_dim, the reference's Wq output width


class QProjection(nn.Module):
    """The reference's minimal attention: just the Q projection."""

    def __init__(self):
        super().__init__()
        self.query = make_linear(M, INNER, bias=False, dtype=torch.float32, device="cpu",
                                 generator=torch.Generator().manual_seed(0))

    @staticmethod
    def logical_axes(name):
        # The JAX kernel's (EMBED, KV), transposed for the (out, in) weight.
        return {"query.weight": (KV, EMBED)}[name]

    def forward(self, x):
        x = constrain(x, BATCH, SEQ, EMBED)
        return constrain(self.query(x), BATCH, SEQ, None)


def run(mesh, rules, label):
    x = put(np.random.default_rng(0).standard_normal((B, S, M)).astype(np.float32),
            logical_sharding(mesh, rules, BATCH, SEQ, EMBED))
    state = sharded_train_state(QProjection(), adamw(1e-3), mesh=mesh, rules=rules)
    wq = state.model.query.weight
    say(f"[{label}] rules={rules}")
    say(f"  Wq {tuple(wq.shape)} -> shard {shard_shapes(wq)[0]}")
    visualize(wq)
    step = make_train_step(mesh=mesh, rules=rules)
    state, loss = step(state, x)
    say(f"  one train step OK, loss={float(loss):.3f}")
    return shard_shapes(wq)[0]


def body(mesh):
    # Reference configuration: 'kv' not mapped, so Wq splits on its embed
    # rows only (the port's weight is (out, in): the embed dim is dim 1).
    shard_a = run(mesh, ((BATCH, "data"), (EMBED, "model")), "kv unmapped (reference)")
    assert shard_a == (INNER, M // 2)
    # With the kv rule the same kernel splits its columns instead.
    shard_b = run(mesh, ((BATCH, "data"), (EMBED, None), (KV, "model")), "kv -> model")
    assert shard_b == (INNER // 2, M)
    say("PASS: logical rules control kernel placement without touching the model")
    return shard_a, shard_b


def main():
    return run_on_mesh(body, (2, 2), ("data", "model"))


if __name__ == "__main__":
    main()
