"""Fleet serving: the streamed KV handoff's transfer plan
(:mod:`.kv_transfer`). Port of ``learning_jax_sharding_tpu/fleet``; the
router, replicas, KV economy, load generator and autoscaler come with slice
F."""

from learning_jax_sharding_tpu_torch.fleet.kv_transfer import (  # noqa: F401
    DEFAULT_PAGE_TOKENS,
    Segment,
    TransferPlan,
    execute_transfer,
    plan_transfer,
    transfer_tree,
)
