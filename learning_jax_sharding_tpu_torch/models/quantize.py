"""Weight-only int8 / int4 quantization for serving.

Port of ``learning_jax_sharding_tpu/models/quantize.py`` over the port's
state dict. Every matmul kernel is stored quantized, symmetric and
zero-point-free:

* **int8** (default): ``{prefix}.q`` int8 ``(in, out)`` with a per-output-
  channel fp32 ``{prefix}.scale`` ``(out,)``;
* **int4** (``bits=4``): ``{prefix}.q4`` uint8 ``(in/2, out)``, two weights
  per byte in split-half order (low nibble row r, high nibble row r + in/2,
  offset-binary +8), with group-wise fp32 ``{prefix}.scale`` ``(in/g, out)``.

The packed arrays keep the JAX layout (``(in, out)``, as a Flax kernel): an
``nn.Linear`` weight ``(out, in)`` is transposed back before packing, so the
bytes equal the JAX package's, and a converted JAX tree
(``models/convert.py``) is a plain copy. Embeddings, norms and biases stay in
full precision.

:class:`Int4Linear` runs an int4 projection through the fused kernels
(``ops/int4_matmul.py``); :func:`projection_dense` is the one dispatch every
projection site builds through. MoE expert stacks (3-D) come with the MoE
slice.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import nn

from learning_jax_sharding_tpu_torch.ops.int4_matmul import int4_matmul


def default_match(name: str, value: torch.Tensor) -> bool:
    """Quantize every 2-D projection weight (attention q/k/v/out, FF
    up/down, ``lm_head``) and the 3-D MoE expert stacks; not the embedding
    tables, the norms, the biases, or an MoE router (routing stays fp32)."""
    parts = name.split(".")
    if "router" in parts or name.startswith("tok_embed."):
        return False
    if parts[-1] == "weight" and value.ndim == 2:
        return True
    return parts[-1] in ("up", "down") and value.ndim == 3


def _quantized_prefixes(params: Mapping[str, torch.Tensor]) -> set[str]:
    """Prefixes ``p`` with ``p.scale`` beside ``p.q`` or ``p.q4``."""
    return {
        name.rsplit(".", 1)[0]
        for name in params
        if name.endswith((".q", ".q4")) and f"{name.rsplit('.', 1)[0]}.scale" in params
    }


def _node_of(name: str, prefixes: set[str]) -> str | None:
    """The quantized node ``name`` belongs to (its ``q``/``q4``/``scale``),
    or None (a bias beside the node is not part of it)."""
    prefix, _, leaf = name.rpartition(".")
    return prefix if prefix in prefixes and leaf in ("q", "q4", "scale") else None


def quantize_leaf(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """``(..., in, out)`` kernel → ``{"q": int8 same shape, "scale": fp32
    (..., out)}``: scale = max|W|/127 over the contraction dim (1 for an
    all-zero channel)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_leaf(node: Mapping[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    return (node["q"].float() * node["scale"][..., None, :]).to(dtype)


def quantize_leaf_int4(w: torch.Tensor, group_size: int = 128) -> dict[str, torch.Tensor]:
    """``(..., in, out)`` kernel → ``{"q4": uint8 (..., in/2, out), "scale":
    fp32 (..., in/g, out)}``: per-channel absmax over groups of
    ``group_size`` contraction rows, values in [-7, 7], split-half packed."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    rows = w.shape[-2]
    g = min(group_size, rows)
    if rows % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {rows}")
    if rows % g:
        raise ValueError(f"contraction dim {rows} not divisible by group_size {g}")
    wf = w.float()
    grouped = wf.reshape(*w.shape[:-2], rows // g, g, w.shape[-1])
    absmax = grouped.abs().amax(dim=-2)                     # (..., in/g, out)
    scale = torch.where(absmax > 0, absmax / 7.0, 1.0)
    q = torch.clamp(torch.round(grouped / scale[..., :, None, :]), -7, 7)
    q = q.reshape(*w.shape[:-2], rows, w.shape[-1]).to(torch.int32)
    low = q[..., : rows // 2, :] + 8                         # [1, 15]
    high = q[..., rows // 2 :, :] + 8
    return {"q4": (low | (high << 4)).to(torch.uint8), "scale": scale}


def dequantize_leaf_int4(node: Mapping[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack the nibbles, rebuild the row order of split-half packing with
    one concatenate, apply the group scales → ``(..., in, out)``."""
    p, scale = node["q4"], node["scale"]
    low = (p & 0xF).to(torch.int8) - 8
    high = (p >> 4).to(torch.int8) - 8
    rows = p.shape[-2] * 2
    q = torch.cat([low, high], dim=-2)                       # (..., in, out)
    groups = scale.shape[-2]
    qg = q.reshape(*p.shape[:-2], groups, rows // groups, p.shape[-1])
    w = qg.float() * scale[..., :, None, :]
    return w.reshape(*p.shape[:-2], rows, p.shape[-1]).to(dtype)


def quantize_tree(
    params: Mapping[str, torch.Tensor],
    *,
    match: Callable[[str, torch.Tensor], bool] = default_match,
    bits: int = 8,
    group_size: int = 128,
) -> dict[str, torch.Tensor]:
    """Replace each matched ``{prefix}.weight`` (``nn.Linear``, ``(out,
    in)``) with ``{prefix}.q``/``{prefix}.scale`` (int8) or
    ``{prefix}.q4``/``{prefix}.scale`` (int4, ``bits=4``) in the JAX
    ``(in, out)`` layout; everything else is carried over as it is.
    ``group_size`` applies to int4 only."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out = {}
    for name, value in params.items():
        if not match(name, value):
            out[name] = value
            continue
        if value.ndim != 2:
            raise NotImplementedError(
                f"{name}: 3-D MoE expert stacks are quantized with the MoE slice"
            )
        prefix = name.rsplit(".", 1)[0]
        kernel = value.detach().T                            # (in, out), as Flax
        node = quantize_leaf(kernel) if bits == 8 else quantize_leaf_int4(kernel, group_size)
        for key, tensor in node.items():
            out[f"{prefix}.{key}"] = tensor.contiguous()
    return out


def dequantize_tree(params: Mapping[str, torch.Tensor], dtype=torch.bfloat16) -> dict:
    """Inverse of :func:`quantize_tree`: each quantized node becomes
    ``{prefix}.weight`` ``(out, in)`` in ``dtype``; the rest is unchanged."""
    prefixes = _quantized_prefixes(params)
    out = {}
    for name, value in params.items():
        prefix = _node_of(name, prefixes)
        if prefix is None:
            out[name] = value
        elif name.endswith(".scale"):
            node = {"scale": value}
            if f"{prefix}.q4" in params:
                node["q4"] = params[f"{prefix}.q4"]
                kernel = dequantize_leaf_int4(node, dtype)
            else:
                node["q"] = params[f"{prefix}.q"]
                kernel = dequantize_leaf(node, dtype)
            out[f"{prefix}.weight"] = kernel.T
    return out


def map_unquantized(
    fn: Callable[[torch.Tensor], torch.Tensor], params: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map ``fn`` over every tensor that is not part of a quantized node;
    ``q``/``q4``/``scale`` of a quantized node pass through untouched."""
    prefixes = _quantized_prefixes(params)
    return {
        name: value if _node_of(name, prefixes) else fn(value)
        for name, value in params.items()
    }


def quantized_bytes(params: Mapping[str, torch.Tensor]) -> int:
    """Total serving bytes of a (possibly partially) quantized state dict."""
    return sum(t.numel() * t.element_size() for t in params.values())


class Int4Linear(nn.Module):
    """Drop-in for a projection over an int4-quantized kernel, computed by
    the fused dequant-matmul kernels (``ops/int4_matmul.py``): the packed
    nibbles stream into the product, no dequantized weight in device memory.

    Buffers match :func:`quantize_tree` ``bits=4`` exactly: ``q4`` (uint8,
    ``(K/2, N)``, split-half packed) and ``scale`` (fp32 whatever
    ``param_dtype`` is, ``(K/group, N)``), so a quantized state dict loads
    as it is. They start as zeros and ones; real weights come from
    :func:`quantize_tree`.

    A layout the kernel cannot tile (an odd group count: split-half packing
    needs ``group | K/2``) takes ``dequantize_leaf_int4`` and a plain
    product, as the JAX module routes it; w4a8 (``activation_bits=8``)
    raises there instead of changing the numerics the caller chose.
    """

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = False,
                 dtype=torch.bfloat16, param_dtype=torch.float32, group_size: int = 128,
                 activation_bits: int = 16, kernel_axes: tuple = (None, None),
                 matmul_fn=None, device=None):
        super().__init__()
        # Over a mesh ``matmul_fn`` (``ops.int4_matmul.make_int4_matmul_fn``)
        # runs the kernel on each shard, laid out by the logical kernel axes.
        self.kernel_axes, self.matmul_fn = tuple(kernel_axes), matmul_fn
        if in_features % 2:
            raise ValueError(f"int4 packing needs an even contraction dim, got {in_features}")
        self.in_features, self.out_features = in_features, out_features
        self.dtype, self.group = dtype, min(group_size, in_features)
        self.activation_bits = activation_bits
        self.register_buffer(
            "q4", torch.zeros(in_features // 2, out_features, dtype=torch.uint8, device=device)
        )
        self.register_buffer(
            "scale", torch.ones(in_features // self.group, out_features, dtype=torch.float32,
                                device=device)
        )
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, g = self.in_features, self.group
        x = x.to(self.dtype)
        w4a8 = self.activation_bits == 8
        if self.scale.shape[0] == 1 or (k // 2) % g == 0:
            if self.matmul_fn is not None:
                y = self.matmul_fn(x, self.q4, self.scale, group=g,
                                   kernel_axes=self.kernel_axes)
            else:
                y = int4_matmul(x, self.q4, self.scale, group=g, w4a8=w4a8)
        else:
            if w4a8:
                raise ValueError(
                    f"w4a8 requested but the kernel cannot tile this layout "
                    f"(scale rows {self.scale.shape[0]}, group {g} over K={k}); "
                    f"re-quantize with a group dividing K/2"
                )
            w = dequantize_leaf_int4({"q4": self.q4, "scale": self.scale}, self.dtype)
            y = x @ w
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def projection_dense(
    *,
    quantization: str | None,
    in_features: int,
    features: int,
    use_bias: bool,
    dtype,
    param_dtype,
    group_size: int = 128,
    kernel_init: Callable | None = None,
    kernel_axes: tuple = (None, None),
    matmul_fn=None,
    device=None,
    generator: torch.Generator | None = None,
) -> nn.Module:
    """The dense / :class:`Int4Linear` dispatch: every projection site
    (attention q/k/v/out, FF up/down, ``lm_head``) builds through here, so
    the quantized serving path cannot drift between modules.
    ``kernel_init(weight, generator)`` initializes a dense weight (default
    lecun-normal, Flax Dense's)."""
    if quantization in ("int4", "int4_w4a8"):
        return Int4Linear(
            in_features, features, use_bias=use_bias, dtype=dtype,
            param_dtype=param_dtype, group_size=group_size,
            activation_bits=8 if quantization == "int4_w4a8" else 16,
            kernel_axes=kernel_axes, matmul_fn=matmul_fn, device=device,
        )
    if quantization is not None:
        raise ValueError(
            f"unknown quantization {quantization!r}: expected None, 'int4', "
            f"or 'int4_w4a8'"
        )
    from learning_jax_sharding_tpu_torch.models.attention import lecun_normal_, make_linear

    return make_linear(in_features, features, bias=use_bias, dtype=param_dtype,
                       device=device, generator=generator, init=kernel_init or lecun_normal_)
