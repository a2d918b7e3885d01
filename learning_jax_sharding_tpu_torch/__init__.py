"""PyTorch + CUDA port of ``learning_jax_sharding_tpu`` for NVIDIA Hopper.

The JAX package stays the reference: every module here keeps the module path
and public names of its JAX counterpart, and the tests hold the two against
each other on the same inputs. This package imports ``torch`` (and numpy),
never JAX, Flax, optax, or anything of the JAX package.

Covered so far, on one GPU, each TPU kernel of the path as a hand-written
CUDA kernel under ``csrc/``:

* KV-cached generation (greedy and sampled) of the ``TransformerConfig``
  models in bf16, with decode attention (``csrc/decode_attention.cu``);
* the train step (``training/pipeline.py``: flash attention forward, dK/dV
  and dQ in ``csrc/flash_attention.cu``, the fused chunked loss, AdamW);
* int4 quantized serving (``make_generate_fn(dequantize="fused" |
  "fused_w4a8")`` over ``models/quantize.py::quantize_tree(bits=4)``): the
  dequant-matmul, q/k/v triple and w4a8 kernels (``csrc/int4_matmul.cu``)
  and the whole-FF kernel (``csrc/int4_ff.cu``); and the int8/int4
  dequantize-per-call mode (``dequantize=True``);
* the fused residual+norm (``TransformerConfig(fused_norm=True)``, in the
  train step and generation): forward and backward in
  ``csrc/fused_norm.cu`` (``ops/fused_norm.py``);
* int8 KV caches (``TransformerConfig(kv_cache_dtype=torch.int8)``): decode
  attention's int8 mode, with per-(token, head) scales.

Not ported yet: the paged KV cache (with the continuous engine), meshes,
MoE, ``scan_layers`` and ``remat``.
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
