"""Case 9 of the port (``learning_jax_sharding_tpu_torch/cases/
case9_generate.py``) run whole through its ``main()``: ``CONFIG_TINY``
trained by ``fit`` for the case's 40 steps on the cyclic stream over a
(2, 2) mesh of thread ranks, then the tensor-parallel greedy generate on
that mesh continues the cycle (the case's own assert: accuracy above 0.7,
as the JAX case's)."""

import numpy as np

from learning_jax_sharding_tpu_torch.cases import case9_generate


def test_case9_trains_then_continues_the_cycle():
    out = case9_generate.main(device_type="cpu")
    assert len(out["losses"]) == case9_generate.STEPS // 10   # log_every=10
    assert out["losses"][-1] < out["losses"][0]
    assert out["accuracy"] > 0.7
    want = (out["tokens"][:, 5:-1] + 1) % 256
    assert np.mean(out["tokens"][:, 6:] == want) == out["accuracy"]
