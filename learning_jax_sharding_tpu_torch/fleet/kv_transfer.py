"""Streamed KV handoff between engines: an explicit resharding transfer plan.

Port of ``learning_jax_sharding_tpu/fleet/kv_transfer.py``. A disaggregated
deployment moves a finished prefill's KV cache row (``ContinuousEngine.
export_kv``) from a prefill engine's devices to a decode engine's
(``ingest_kv``); the move is an array redistribution, whose decomposition
lives in :mod:`learning_jax_sharding_tpu_torch.parallel.resharding`. This
module re-exports it under its fleet-facing names:

* :func:`plan_transfer` / :class:`TransferPlan` / :class:`Segment`: the
  page-granular block-copy decomposition;
* :func:`execute_transfer`: one plan run, with ``stop`` clipping so bytes the
  causal-at-index masks never read do not move;
* :func:`transfer_tree`: the whole exported cache-row tree, with the summed
  bytes and segment counts.

The router and the rest of the fleet come with slice F.
"""

from __future__ import annotations

from learning_jax_sharding_tpu_torch.parallel.resharding import (
    DEFAULT_PAGE_TOKENS,
    Box,
    Segment,
    TransferPlan,
    execute_transfer,
    plan_transfer,
    transfer_tree,
)

__all__ = [
    "DEFAULT_PAGE_TOKENS",
    "Box",
    "Segment",
    "TransferPlan",
    "execute_transfer",
    "plan_transfer",
    "transfer_tree",
]
