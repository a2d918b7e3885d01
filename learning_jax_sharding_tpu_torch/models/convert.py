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

from learning_jax_sharding_tpu_torch.parallel.logical import (
    EMBED,
    HEADS,
    MLP,
    SEQ,
    VOCAB,
    logical_placements,
)
from learning_jax_sharding_tpu_torch.parallel.sharding import put


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


#: Each projection site's logical kernel axes ``(in, out)``, as the JAX
#: model declares them (``models/attention.py`` ``_dense``,
#: ``models/transformer.py`` ``FeedForward`` and ``lm_head``).
KERNEL_AXES = {
    "query": (EMBED, HEADS),
    "key": (EMBED, HEADS),
    "value": (EMBED, HEADS),
    "out": (HEADS, EMBED),
    "up": (EMBED, MLP),
    "down": (MLP, EMBED),
    "lm_head": (EMBED, VOCAB),
}


def param_logical_axes(name: str) -> tuple:
    """The logical axes of the port's parameter or buffer ``name``, in the
    port's layout: the JAX model's ``nn.with_logical_partitioning`` axes,
    reversed for an ``(out, in)`` weight. An int4 node's ``q4`` and
    ``scale`` (``(K/2, N)`` and ``(K/g, N)``, the JAX layout) shard their
    columns only: split-half packing never splits the contraction."""
    parts = name.split(".")
    if name == "tok_embed.weight":
        return (VOCAB, EMBED)
    if name == "pos_embed":
        return (SEQ, EMBED)
    site, leaf = parts[-2], parts[-1]
    if site in ("ln_attn", "ln_ff", "ln_out"):
        return (EMBED,)
    if site not in KERNEL_AXES:
        raise KeyError(f"no logical axes for parameter {name!r}")
    k_in, k_out = KERNEL_AXES[site]
    if leaf == "weight":
        return (k_out, k_in)
    if leaf == "bias":
        return (k_out,)
    if leaf in ("q4", "scale"):
        return (None, k_out)
    raise KeyError(f"no logical axes for parameter {name!r}")


def layout_tensors(model: torch.nn.Module) -> list[tuple[str, torch.Tensor, bool]]:
    """The tensors a model's layout places, ``[(name, tensor, is_param)]``:
    every parameter and every int4 ``q4``/``scale`` buffer."""
    named = [(n, t, True) for n, t in model.named_parameters()]
    return named + [(n, t, False) for n, t in model.named_buffers()
                    if n.rsplit(".", 1)[-1] in ("q4", "scale")]


def install_tensor(model: torch.nn.Module, name: str, tensor: torch.Tensor) -> None:
    """Make ``tensor`` the parameter or buffer ``name`` of ``model`` in place
    of the one there (nothing copied; a parameter keeps its
    ``requires_grad``)."""
    owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
    leaf = name.rsplit(".", 1)[-1]
    if leaf in owner._parameters:
        grad = owner._parameters[leaf].requires_grad
        owner._parameters[leaf] = torch.nn.Parameter(tensor, requires_grad=grad)
    else:
        owner._buffers[leaf] = tensor


def shard_params(model: torch.nn.Module, mesh, rules, state: Mapping | None = None) -> None:
    """Lay every parameter (and int4 ``q4``/``scale`` buffer) of ``model``
    out over ``mesh`` IN PLACE, as a DTensor placed by its logical axes
    under ``rules``: the port's counterpart of a Flax state born sharded.
    The model's own ``logical_axes(name)`` method gives them where it has
    one, else :func:`param_logical_axes` (the transformer's table).
    The values are the module's own full tensors, or ``state[name]`` (a full
    state dict, cast to each tensor's dtype); each rank keeps its slice,
    nothing is sent."""
    axes = getattr(model, "logical_axes", param_logical_axes)
    for name, old, _ in layout_tensors(model):
        value = old.detach() if state is None else torch.as_tensor(state[name])
        if hasattr(value, "full_tensor"):
            value = value.full_tensor()
        value = value.to(device=old.device, dtype=old.dtype)
        placements = logical_placements(mesh, rules, axes(name))
        install_tensor(model, name, put(value, placements, mesh))
