"""Case 1a: a contraction-sharded matmul → all-reduce → replicated C.

Port of ``cases/case1a.py`` on a (2, 4) ``x`` × ``y`` mesh of 8 CPU ranks.

    python -m learning_jax_sharding_tpu_torch.cases.case1a
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
    shard_dims,
    visualize,
)


def body(mesh):
    rng = np.random.default_rng(0)
    a_host = rng.standard_normal((4, 16)).astype(np.float32)
    b_host = rng.standard_normal((16, 4)).astype(np.float32)

    # A: the contraction dim split 4-way over y, replicated over x.
    a = put(a_host, shard_dims(mesh, 2, y=1))
    say("A(4,16) — inner dim split over Y:")
    visualize(a)
    assert_shard_shape(a, (4, 4))

    # B: its contraction dim split the same way.
    b = put(b_host, shard_dims(mesh, 2, y=0))
    say("B(16,4) — contraction dim split over Y:")
    visualize(b)
    assert_shard_shape(b, (4, 4))

    def matmul(a, b):
        return (a @ b).redistribute(mesh, replicated(mesh).placements)

    c = matmul(a, b)
    say("C = A·B:")
    visualize(c)
    # Every rank computed a partial (4,4) product; the all-reduce summed
    # them, so C is replicated and exact.
    assert_replicated(c, a_host @ b_host)
    counts = assert_collectives(matmul, a, b, require=("all-reduce",), forbid=("all-gather",))
    say(f"collectives: {counts}")
    say("PASS: contraction-sharded matmul → AllReduce → replicated C")
    return counts


def main():
    return run_on_mesh(body, (2, 4), ("x", "y"))


if __name__ == "__main__":
    main()
