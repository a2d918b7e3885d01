"""The flash ceiling's second study: the windowed composed step at S=8192
and the block ablation.

Port of ``scripts/perf_flash_ceiling2.py``, which ran
``perf_flash_ceiling.py``'s parts 2 (window rows only) and 3; here by
calling that module's functions.

    python -m learning_jax_sharding_tpu_torch.scripts.perf_flash_ceiling2
"""

from __future__ import annotations

import functools

import torch

from learning_jax_sharding_tpu_torch.scripts.perf_flash_ceiling import ablation, composed_8k


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("perf_flash_ceiling2 measures the card: no CUDA device")
    log = functools.partial(print, flush=True)
    log(f"[flash] {torch.cuda.get_device_name(0)}")
    composed_8k(log=log, windowed_only=True)
    ablation(log=log)


if __name__ == "__main__":
    main()
