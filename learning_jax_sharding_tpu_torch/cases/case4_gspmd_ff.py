"""Case 4: data-parallel rows × tensor-parallel columns → C born 2-D sharded.

Port of ``cases/case4_gspmd_ff.py`` on a (2, 4) ``x`` × ``y`` mesh of 8 CPU
ranks: the batched einsum, then the DP × MP projection, implicit (DTensor
places it; no collective) and explicit (``parallel.collectives.dp_tp_matmul``).

    python -m learning_jax_sharding_tpu_torch.cases.case4_gspmd_ff
"""

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.parallel import (
    assert_collectives,
    assert_shard_shape,
    col_sharded,
    put,
    row_sharded,
    run_on_mesh,
    visualize,
)
from learning_jax_sharding_tpu_torch.parallel.collectives import dp_tp_matmul


def body(mesh):
    rng = np.random.default_rng(0)

    # Part 1: the batched einsum.
    arr_a = torch.from_numpy(rng.standard_normal((8, 4, 16)).astype(np.float32))
    arr_b = torch.from_numpy(rng.standard_normal((8, 16, 4)).astype(np.float32))
    c = torch.einsum("ABC,ACD->ABD", arr_a, arr_b)
    assert c.shape == (8, 4, 4)
    say(f"batched einsum ABC,ACD->ABD: {tuple(arr_a.shape)} x {tuple(arr_b.shape)} -> "
        f"{tuple(c.shape)}")

    # Part 2: the DP×MP feed-forward projection.
    a_host = rng.standard_normal((4, 16)).astype(np.float32)
    b_host = rng.standard_normal((16, 4)).astype(np.float32)
    a = put(a_host, row_sharded(mesh, "x"))   # activations: batch rows over X
    b = put(b_host, col_sharded(mesh, "y"))   # weights: output cols over Y
    say("A(4,16) — rows (batch) over X:")
    visualize(a)
    assert_shard_shape(a, (2, 16))
    say("B(16,4) — columns (features) over Y:")
    visualize(b)
    assert_shard_shape(b, (16, 1))

    c = a @ b
    say("C = A·B (born 2D-sharded, GSPMD Fig. 3):")
    visualize(c)
    np.testing.assert_allclose(c.full_tensor().numpy(), a_host @ b_host, rtol=1e-5)
    assert_shard_shape(c, (2, 1))
    counts = assert_collectives(lambda: a @ b,
                                forbid=("all-reduce", "all-gather", "reduce-scatter"))
    say(f"collectives: {counts} (none needed)")

    # The same schedule written out on the local shards.
    c2 = dp_tp_matmul(a_host, b_host, mesh=mesh, dp_axis="x", tp_axis="y")
    np.testing.assert_allclose(c2.full_tensor().numpy(), a_host @ b_host, rtol=1e-5)
    say("PASS: DP×MP product born fully sharded, implicit == explicit")
    return counts


def main():
    return run_on_mesh(body, (2, 4), ("x", "y"))


if __name__ == "__main__":
    main()
