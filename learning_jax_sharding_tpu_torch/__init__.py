"""PyTorch + CUDA port of ``learning_jax_sharding_tpu`` for NVIDIA Hopper.

The JAX package stays the reference: every module here keeps the module path
and public names of its JAX counterpart, and the tests hold the two against
each other on the same inputs. This package imports ``torch`` (and numpy),
never JAX, Flax, optax, or anything of the JAX package.

Covered so far: KV-cached generation (greedy and sampled) of the
``TransformerConfig`` models in bf16 on one GPU, with decode attention in a
hand-written CUDA kernel (``csrc/decode_attention.cu``).
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the GPU unless the caller asks for
    another device. ``None`` means ``cuda``, and raises when no GPU is
    present: nothing falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
