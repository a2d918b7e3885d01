"""Case 9: train, then KV-cached generation, on a sharded mesh.

Port of ``cases/case9_generate.py``: ``CONFIG_TINY`` is trained by
``training.loop.fit`` on a fully predictable token stream (token i+1 =
token i + 1 mod V) over a (2, 2) ``data`` × ``model`` mesh under
``RULES_DP_TP``, every rank a thread of this process
(``parallel.run_on_threads``), then continues the cycle through the
tensor-parallel ``make_generate_fn`` on the same mesh (the caches and the
per-step collectives follow the training layout). The four ranks share
the card unless the caller asks for the CPU (``main(device_type="cpu")``,
``--cpu``); the card reads the cache through the dense path (its decode
attention kernel does not take CONFIG_TINY's head_dim of 16):

    python -m learning_jax_sharding_tpu_torch.cases.case9_generate [--cpu]
"""

import dataclasses
import sys

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.data import CyclicLMDataset
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY, Transformer
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_TP
from learning_jax_sharding_tpu_torch.training.loop import TrainLoopConfig, fit

STEPS = 40


def body(mesh, steps, device_type):
    cfg = CONFIG_TINY
    say(f"training {steps} steps on the cyclic stream ...")
    state, history = fit(
        Transformer(cfg, device=device_type, seed=0),
        CyclicLMDataset(cfg.vocab_size, 32, seed=13), mesh,
        RULES_DP_TP,
        TrainLoopConfig(steps=steps, global_batch_size=16, learning_rate=3e-3,
                        log_every=10, prefetch=0),
    )
    say(f"loss: {history[0]['loss']:.3f} → {history[-1]['loss']:.3f}")

    # The card's decode attention kernel takes head_dim 64 or 128 and
    # CONFIG_TINY's is 16, so there the cache is read by the dense path.
    decode = "blocked" if device_type == "cpu" else "dense"
    gen = make_generate_fn(dataclasses.replace(cfg, decode_attention=decode), mesh,
                           RULES_DP_TP, max_new_tokens=8, device=device_type)
    prompt = torch.from_numpy(np.stack([np.arange(10, 16), np.arange(100, 106)]).astype(np.int32))
    prompt = prompt.to(device_type)
    out = gen(state.model.state_dict(), prompt).cpu().numpy()
    say("prompt → continuation:")
    for row in out:
        say("  ", row[:6], "→", row[6:])
    want = (out[:, 5:-1] + 1) % cfg.vocab_size
    correct = float((out[:, 6:] == want).mean())
    say(f"next-token accuracy on continuation: {correct:.0%}")
    assert correct > 0.7, "trained model should continue the cycle"
    say("PASS: KV-cached generation continues the learned sequence")
    return dict(losses=[h["loss"] for h in history], tokens=out, accuracy=correct)


def main(steps: int = STEPS, device_type: str = "cuda"):
    """Run the case on a (2, 2) mesh of thread ranks on ``device_type``."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    return run_on_threads(body, (2, 2), ("data", "model"), device_type=device_type,
                          args=(steps, device_type))


if __name__ == "__main__":
    main(device_type="cpu" if "--cpu" in sys.argv[1:] else "cuda")
