"""Case 10: long context: flash attention, attention remat, ring attention,
the sliding window.

Port of ``cases/case10_long_context.py``. Four long-context mechanisms on
one model, each proven numerically:

1. flash attention (``ops/flash_attention.py``): the blockwise kernels,
   O(S·H) memory instead of O(S²);
2. ring attention (``ops/ring_attention.py``): the sequence split over the
   ``model`` axis of a (2, 4) mesh under ``RULES_DP_SP``, k/v blocks
   rotating rank to rank under an online softmax;
3. the sliding window (``flash_attention(window=w)``) against the dense
   band mask;
4. attention remat (``remat_attention``) in a sharded train step at
   S = 1024, where no ``(B, N, S, S)`` score tensor is kept for the
   backward.

The mesh's ranks are threads of this process (``parallel.run_on_threads``).
It runs on the card unless the caller asks for the CPU (``--cpu``,
``main(device_type="cpu")``); the card's flash kernels take head_dim 64 or
128, so there the attention checks run at head_dim 64 (the tiny config's
16 on the CPU, as the JAX case) and say so:

    python -m learning_jax_sharding_tpu_torch.cases.case10_long_context [--cpu]
"""

import dataclasses
import sys

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops.attention import (
    causal_mask,
    dot_product_attention,
    sliding_window_mask,
)
from learning_jax_sharding_tpu_torch.ops.flash_attention import flash_attention
from learning_jax_sharding_tpu_torch.ops.ring_attention import make_ring_attn_fn
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_SP, RULES_DP_TP
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import make_train_step, sharded_train_state

B, S, N = 2, 1024, 4
WINDOW = 96
ATOL = 2e-5


def head_dim(device_type: str) -> int:
    """The attention checks' head_dim: 64 on the card (its flash kernels
    take 64 or 128), the tiny config's 16 on the CPU."""
    return 16 if device_type == "cpu" else 64


def qkv(seed: int, h: int, device_type: str):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, N, h)).astype(np.float32)).to(device_type)
            for _ in range(3)]


def close(got, want, what):
    err = float((got - want).abs().max())
    assert err <= ATOL, f"{what}: max abs err {err:.3g} > {ATOL}"
    return err


def single_device(device_type: str):
    """Dense == flash (causal), and the sliding window == the band mask."""
    h = head_dim(device_type)
    q, k, v = qkv(0, h, device_type)
    dense = dot_product_attention(q, k, v, mask=causal_mask(S, device=q.device))
    err = close(flash_attention(q, k, v, causal=True), dense, "flash")
    say(f"PASS: dense == flash at S={S}, head_dim {h} on {device_type} (max abs err {err:.2e})")
    q, k, v = qkv(1, h, device_type)
    banded = dot_product_attention(q, k, v, mask=sliding_window_mask(S, WINDOW, device=q.device))
    err = close(flash_attention(q, k, v, causal=True, window=WINDOW, block_q=128, block_k=128),
                banded, "window")
    say(f"PASS: sliding-window flash (w={WINDOW}, head_dim {h}) matches the dense band mask "
        f"(max abs err {err:.2e})")
    return dense


def body(mesh, dense, device_type):
    """Ring attention == dense, then the remat train step, on the mesh."""
    h = head_dim(device_type)
    q, k, v = qkv(0, h, device_type)
    ring = make_ring_attn_fn(mesh, RULES_DP_SP)
    err = close(ring(q, k, v, causal=True).full_tensor(), dense.to(q.device), "ring")
    say(f"PASS: dense == ring at S={S} (causal; the sequence over the 4 'model' ranks, "
        f"head_dim {h}; max abs err {err:.2e})")

    cfg = dataclasses.replace(CONFIG_TINY, max_seq_len=S, remat_attention=True, rope=True)
    model = Transformer(cfg, device=device_type, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, S + 1)).astype(np.int64)).to(device_type)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    state = sharded_train_state(model, adamw(1e-3), mesh=mesh, rules=RULES_DP_TP)
    step = make_train_step(loss_fn=next_token_loss, mesh=mesh, rules=RULES_DP_TP)
    _, loss = step(state, batch)
    loss = float(loss)
    layout = dict(zip(mesh.mesh_dim_names, mesh.shape))
    say(f"train step at S={S}, remat_attention + rope over {layout}: loss={loss:.3f}")
    assert np.isfinite(loss)
    return loss


def main(device_type: str = "cuda"):
    """Run the case on ``device_type``; the mesh is (2, 4) thread ranks."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    dense = single_device(device_type)
    loss = run_on_threads(body, (2, 4), ("data", "model"), device_type=device_type,
                          args=(dense, device_type))
    say("PASS: long-context mechanisms (flash / window / remat / ring) all serve the same "
        "model")
    return loss


if __name__ == "__main__":
    main(device_type="cpu" if "--cpu" in sys.argv[1:] else "cuda")
