"""Carry a JAX ``Transformer`` parameter tree into the port.

The JAX package's tree (``model.init(...)["params"]``, unboxed, leaves as
numpy arrays) maps onto the state dict of the port's
:class:`~learning_jax_sharding_tpu_torch.models.transformer.Transformer`, so
both packages compute the same function and the tests can compare them.

Flax ``Dense`` kernels are ``(in, out)`` and ``nn.Linear`` weights
``(out, in)``: kernels are transposed. Norm ``scale`` becomes ``weight``.
A quantized kernel (``{"q4", "scale"}`` int4 or ``{"q", "scale"}`` int8
under ``<site>/kernel``, from ``quantize_tree`` or the fused-qkv layout) is
carried across verbatim, with no transpose: the port's quantized state dict
keeps the JAX layout (``models/quantize.py``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _dense(prefix: str, node: Mapping) -> dict:
    kernel = node["kernel"]
    if isinstance(kernel, Mapping):
        out = {f"{prefix}.{key}": _tensor(value) for key, value in kernel.items()}
    else:
        out = {f"{prefix}.weight": _tensor(np.asarray(kernel).T)}
    if "bias" in node:
        out[f"{prefix}.bias"] = _tensor(node["bias"])
    return out


def _norm(prefix: str, node: Mapping) -> dict:
    out = {f"{prefix}.weight": _tensor(node["scale"])}
    if "bias" in node:
        out[f"{prefix}.bias"] = _tensor(node["bias"])
    return out


def from_flax_params(params: Mapping, cfg) -> dict[str, torch.Tensor]:
    """JAX ``Transformer`` params → the port's state dict (CPU tensors in the
    tree's dtypes). ``cfg`` is the port's ``TransformerConfig`` of the same
    model."""
    if "blocks" in params:
        raise NotImplementedError(
            "scan_layers (stacked 'blocks') trees: ported with slice D (training breadth)"
        )
    sd = {"tok_embed.weight": _tensor(params["tok_embed"]["embedding"])}
    if not cfg.rope:
        sd["pos_embed"] = _tensor(params["pos_embed"])
    for i in range(cfg.num_layers):
        blk = params[f"block_{i}"]
        p = f"blocks.{i}"
        sd.update(_norm(f"{p}.ln_attn", blk["ln_attn"]))
        for name in ("query", "key", "value", "out"):
            sd.update(_dense(f"{p}.attn.{name}", blk["attn"][name]))
        sd.update(_norm(f"{p}.ln_ff", blk["ln_ff"]))
        for name in ("up", "down"):
            sd.update(_dense(f"{p}.ff.{name}", blk["ff"][name]))
    sd.update(_norm("ln_out", params["ln_out"]))
    sd.update(_dense("lm_head", params["lm_head"]))
    return sd
