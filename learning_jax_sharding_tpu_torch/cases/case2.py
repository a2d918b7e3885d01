"""Case 2: A fully 2-D sharded, B's rows over x → C row-sharded over x.

Port of ``cases/case2.py`` on a (2, 4) ``x`` × ``y`` mesh of 8 CPU ranks.

    python -m learning_jax_sharding_tpu_torch.cases.case2
"""

import numpy as np

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.parallel import (
    assert_shard_shape,
    mesh_sharding,
    put,
    run_on_mesh,
    shard_dims,
    unique_shard_count,
    visualize,
)


def body(mesh):
    rng = np.random.default_rng(0)
    a_host = rng.standard_normal((4, 16)).astype(np.float32)
    b_host = rng.standard_normal((16, 4)).astype(np.float32)

    a = put(a_host, shard_dims(mesh, 2, x=0, y=1))   # fully 2D-sharded
    say("A(4,16) — fully sharded over (x,y):")
    visualize(a)
    assert_shard_shape(a, (2, 4))

    b = put(b_host, shard_dims(mesh, 2, x=0))   # rows over X
    say("B(16,4) — rows split over X:")
    visualize(b)
    assert_shard_shape(b, (8, 4))

    # C laid out as GSPMD lays it: rows over x, replicated over y.
    c = (a @ b).redistribute(mesh, mesh_sharding(mesh, "x", None).placements)
    say("C = A·B:")
    visualize(c)
    np.testing.assert_allclose(c.full_tensor().numpy(), a_host @ b_host, rtol=1e-5)
    assert_shard_shape(c, (2, 4))
    # Two distinct row blocks (one per x row), each replicated over y.
    assert unique_shard_count(c) == 2
    say("PASS: outer-axis sharding → C row-sharded over X, no reduction needed")
    return unique_shard_count(c)


def main():
    return run_on_mesh(body, (2, 4), ("x", "y"))


if __name__ == "__main__":
    main()
