"""Case 3: both operands fully sharded → C fully sharded, zero redundancy.

Port of ``cases/case3_fully_sharded.py`` on a (2, 4) ``x`` × ``y`` mesh of 8
CPU ranks.

    python -m learning_jax_sharding_tpu_torch.cases.case3_fully_sharded
"""

import numpy as np

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.parallel import (
    assert_shard_shape,
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

    a = put(a_host, shard_dims(mesh, 2, x=0, y=1))
    say("A(4,16) — fully sharded:")
    visualize(a)
    assert_shard_shape(a, (2, 4))

    b = put(b_host, shard_dims(mesh, 2, x=0, y=1))
    say("B(16,4) — fully sharded:")
    visualize(b)
    assert_shard_shape(b, (8, 1))

    c = (a @ b).redistribute(mesh, shard_dims(mesh, 2, x=0, y=1).placements)
    say("C = A·B:")
    visualize(c)
    np.testing.assert_allclose(c.full_tensor().numpy(), a_host @ b_host, rtol=1e-5)
    assert_shard_shape(c, (2, 1))
    assert unique_shard_count(c) == 8, "every device must hold a distinct tile"
    say("PASS: fully-sharded operands → fully-sharded C, zero redundancy")
    return unique_shard_count(c)


def main():
    return run_on_mesh(body, (2, 4), ("x", "y"))


if __name__ == "__main__":
    main()
