"""Case 7: the composed transformer train step (the north star).

Port of ``cases/case7_transformer.py``: ``CONFIG_TINY`` trained for ten
steps as one SPMD program per rank on a (2, 4) ``data`` × ``model`` mesh of
8 CPU ranks under ``RULES_DP_TP_SP``: data, tensor and sequence parallelism
all active; the step's collectives counted.

    python -m learning_jax_sharding_tpu_torch.cases.case7_transformer
"""

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.parallel import collective_counts, run_on_mesh, shard_shapes
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_TP_SP
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import (
    make_train_step,
    sharded_train_state,
)


def body(mesh):
    cfg = CONFIG_TINY
    rng = np.random.default_rng(0)
    b, s = 8, 32
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int64))
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}

    state = sharded_train_state(Transformer(cfg, device="cpu", seed=0), adamw(3e-4),
                                mesh=mesh, rules=RULES_DP_TP_SP)
    up = state.model.blocks[0].ff.up.weight
    say(f"FF up-kernel {tuple(up.shape)} shard: {shard_shapes(up)[0]} (hidden over model)")
    emb = state.model.tok_embed.weight
    say(f"embedding {tuple(emb.shape)} shard: {shard_shapes(emb)[0]} (vocab over model)")

    step = make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=RULES_DP_TP_SP)
    losses = []
    for _ in range(10):
        state, loss = step(state, batch)
        losses.append(float(loss))
    say("losses:", " ".join(f"{loss:.3f}" for loss in losses))
    assert losses[-1] < losses[0], "training must descend"

    counts = collective_counts(step, state, batch)
    say(f"collectives inside one train step: {counts}")
    assert counts["all-reduce"] >= 1
    say("PASS: composed transformer trains as one SPMD program (dp+tp+sp)")
    return losses


def main():
    return run_on_mesh(body, (2, 4), ("data", "model"))


if __name__ == "__main__":
    main()
