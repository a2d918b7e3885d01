"""Case 1b: mismatched contraction shardings → all-gather → replicated C.

Port of ``cases/case1b.py`` on a (2, 4) ``x`` × ``y`` mesh of 8 CPU ranks.
GSPMD gathers both operands whole; DTensor gathers B's x-split contraction
rows to match A's y split, multiplies the partial products and all-reduces
them over y: a gather either way.

    python -m learning_jax_sharding_tpu_torch.cases.case1b
"""

import numpy as np

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.parallel import (
    assert_collectives,
    assert_replicated,
    assert_shard_shape,
    put,
    replicated,
    run_on_mesh,
    shard_arrays,
    shard_dims,
    visualize,
)


def body(mesh):
    rng = np.random.default_rng(0)
    a_host = rng.standard_normal((4, 16)).astype(np.float32)
    b_host = rng.standard_normal((16, 4)).astype(np.float32)

    a = put(a_host, shard_dims(mesh, 2, y=1))   # contraction dim over Y
    say("A(4,16) — inner dim split over Y:")
    visualize(a)
    assert_shard_shape(a, (4, 4))

    b = put(b_host, shard_dims(mesh, 2, x=0))   # contraction dim over X (mismatch!)
    say("B(16,4) — contraction dim split over X:")
    visualize(b)
    assert_shard_shape(b, (8, 4))

    def matmul(a, b):
        return (a @ b).redistribute(mesh, replicated(mesh).placements)

    c = matmul(a, b)
    say("C = A·B:")
    visualize(c)
    assert_replicated(c)
    np.testing.assert_allclose(shard_arrays(c)[0], a_host @ b_host, rtol=1e-5)
    counts = assert_collectives(matmul, a, b, require=("all-gather",))
    say(f"collectives: {counts}")
    say("PASS: mismatched contraction shardings → AllGather → replicated C")
    return counts


def main():
    return run_on_mesh(body, (2, 4), ("x", "y"))


if __name__ == "__main__":
    main()
