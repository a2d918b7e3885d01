"""Tenancy: weight swaps while serving (:mod:`.hot_swap`). Port of
``learning_jax_sharding_tpu/tenancy``; the multi-LoRA adapter pool comes with
item 15."""

from learning_jax_sharding_tpu_torch.tenancy.hot_swap import (  # noqa: F401
    serving_shardings,
    stage_params,
    write_swap_timeline,
)
