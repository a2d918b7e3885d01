"""Parallelism layers over ``torch.distributed``: mesh (``DeviceMesh``),
sharding placement (DTensor), logical axes, explicit collectives and the
collective counts, the resharding planner (``resharding``) and each
process's batch rows (``multihost``). Port of
``learning_jax_sharding_tpu/parallel``; the multi-host bootstrap and the
pipeline schedule come with slice D, the HLO analysis with slice G."""

from learning_jax_sharding_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    DEFAULT_AXIS_NAMES,
    MODEL_AXIS,
    MeshSpec,
    build_hybrid_mesh,
    build_mesh,
    run_on_mesh,
    run_on_threads,
    single_device_mesh,
)
from learning_jax_sharding_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    P,
    PartitionSpec,
    assert_replicated,
    assert_shard_shape,
    col_sharded,
    is_fully_replicated,
    mesh_sharding,
    put,
    replicated,
    row_sharded,
    shard_arrays,
    shard_dims,
    shard_shapes,
    unique_shard_count,
    visualize,
)
from learning_jax_sharding_tpu_torch.parallel.hlo import (  # noqa: F401
    assert_collectives,
    collective_counts,
    compiled_hlo,
)
