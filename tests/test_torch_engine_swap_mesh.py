"""The port engine's weight swaps over a (2, 2) mesh against the JAX engine's.

``tests/test_torch_engine_swap.py``'s scenarios (``TestHotSwap`` ported: the
saturated drain-mode swap stepped with stale params, the preempt-mode swap,
one staged swap at a time, the chaos abort at ``engine.swap_stage``) over a
(2, 2) ``data`` × ``model`` mesh under ``RULES_DP_TP``: the JAX engine on
``mesh22``, the port's on four thread ranks of ``parallel.run_on_threads``
(each rank stages its own shards of the new weights; every rank commits in
the same step). Every outcome (tokens, versions, counts) equals JAX's on
``mesh22``, and every rank's equals the port's one-device engine's.
Tolerances: none; everything is compared for equality.
"""

import pytest
import torch

from learning_jax_sharding_tpu_torch import robustness as port_robustness
from learning_jax_sharding_tpu_torch.models import serving as port_serving
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from tests.test_torch_engine_swap import (
    CASES,
    PORT_CFG,
    _port_trees,
    jax_swap_cases,
    port_one_device_cases,
    swap_cases,
)
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)


def _mesh_body(mesh, trees):
    import torch.distributed as dist

    from learning_jax_sharding_tpu_torch.parallel import logical

    got = swap_cases(lambda **kw: port_serving.ContinuousEngine(
        PORT_CFG, mesh, logical.RULES_DP_TP, **kw), trees, port_robustness)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, got)
    return ranks


@pytest.fixture(scope="module")
def jax_mesh22(mesh22):
    return jax_swap_cases(mesh22)


@pytest.fixture(scope="module")
def mesh_ranks():
    return run_on_threads(_mesh_body, (2, 2), ("data", "model"), args=(_port_trees(),))


@pytest.fixture(scope="module")
def one_device():
    return port_one_device_cases()


@pytest.mark.parametrize("case", CASES)
def test_mesh_swap_equals_jax_on_mesh22(case, mesh_ranks, jax_mesh22):
    assert mesh_ranks[0][case] == jax_mesh22[case]


@pytest.mark.parametrize("case", CASES)
def test_mesh_swap_equals_one_device_on_every_rank(case, mesh_ranks, one_device):
    assert len(mesh_ranks) == 4
    for rank in mesh_ranks:
        assert rank[case] == one_device[case]
