"""Weight-swap staging helpers: the operator-facing layer over
:mod:`parallel.resharding` and the engine's swap.

Port of ``learning_jax_sharding_tpu/tenancy/hot_swap.py``. The swap itself is
:meth:`ContinuousEngine.swap_weights` (staging, drain, atomic commit, version
attribution). Here: laying a trained or restored tree out in the serving
layout before handing it to the engine, and writing the swap timeline a
serving loop assembles.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from torch.utils import _pytree as pytree

from learning_jax_sharding_tpu_torch.parallel.resharding import reshard_tree, sharding_of


def serving_shardings(tree: Any) -> Any:
    """The layout tree of live serving weights (each DTensor's mesh and spec,
    each plain tensor's device): the destination :func:`stage_params`
    reshards a trained or restored tree into."""
    return pytree.tree_map(sharding_of, tree)


def stage_params(
    params: Any,
    dst_shardings: Any,
    *,
    plan_cache: dict | None = None,
    jit_cache: dict | None = None,
    mode: str = "auto",
) -> tuple[Any, dict]:
    """Reshard ``params`` into the serving layout off the dispatch path →
    ``(staged tree, stats)`` with the moved bytes and segments. A loop that
    swaps every N steps passes the same caches each time, so each plan is
    made once (``jit_cache``, JAX's cache of its compiled mover, is accepted
    and ignored). ``engine.swap_weights`` runs the same resharding itself
    when handed an unstaged tree."""
    return reshard_tree(params, dst_shardings, plan_cache=plan_cache, jit_cache=jit_cache,
                        mode=mode)


def write_swap_timeline(path: str | Path, timeline: list[dict]) -> Path:
    """Write a swap timeline (a list of JSON-able event dicts) as the
    artifact dashboards replay."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(timeline, indent=2, sort_keys=True) + "\n")
    return p
