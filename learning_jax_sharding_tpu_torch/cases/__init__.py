"""The sharding lessons as runnable drivers over ``torch.distributed``: the
port's counterparts of the JAX package's ``cases/case1a.py`` …
``case7_transformer.py``. Each spawns its mesh of CPU ranks over ``gloo``
(``parallel.run_on_mesh``: 8 ranks for 1a–4 and 7, 4 for 5 and 6), prints
its layouts and asserts as the JAX case does, and ends with ``PASS``:

    python -m learning_jax_sharding_tpu_torch.cases.case1a
"""

import torch.distributed as dist


def say(*args) -> None:
    """Print on rank 0 only (every rank runs the case)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args, flush=True)
