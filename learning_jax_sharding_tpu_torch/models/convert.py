"""Carry a JAX ``Transformer`` parameter tree, or a HuggingFace GPT-2, into
the port, and back.

The JAX package's tree (``model.init(...)["params"]``, unboxed, leaves as
numpy arrays) maps onto the state dict of the port's
:class:`~learning_jax_sharding_tpu_torch.models.transformer.Transformer`, so
both packages compute the same function and the tests can compare them.

Flax ``Dense`` kernels are ``(in, out)`` and ``nn.Linear`` weights
``(out, in)``: kernels are transposed. Norm ``scale`` becomes ``weight``.
A quantized kernel (``{"q4", "scale"}`` int4 or ``{"q", "scale"}`` int8
under ``<site>/kernel``, from ``quantize_tree`` or the fused-qkv layout) is
carried across verbatim, with no transpose: the port's quantized state dict
keeps the JAX layout (``models/quantize.py``). A ``scan_layers`` tree (one
``blocks`` subtree, leaves led by the layer dim) maps onto a
``scan_layers`` model's stacked names (``blocks.attn.query.weight``);
:func:`stack_scan_params` and :func:`unstack_scan_params` move a port state
dict between the two layouts.

HF GPT-2 (:func:`config_from_hf_gpt2`, :func:`params_from_hf_gpt2`,
:func:`state_dict_from_params`): GPT-2 is this pre-LN transformer with
learned positions, biased projections and tanh GELU (``use_bias=True``,
``norm_eps`` from the config). HF ``Conv1D`` weights are ``(in, out)`` and
transposed into ``nn.Linear``'s ``(out, in)``; ``c_attn`` packs q/k/v as one
``(E, 3E)`` weight, split in three; the head is read from ``lm_head.weight``,
which a tied checkpoint aliases to ``wte``. Nothing here imports
``transformers``: the functions read a state dict and config attributes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.parallel.logical import (
    EMBED,
    EXPERT,
    HEADS,
    LAYERS,
    MLP,
    SEQ,
    VOCAB,
    logical_placements,
)
from learning_jax_sharding_tpu_torch.parallel.sharding import put


def _tensor(x: Any) -> torch.Tensor:
    x = np.array(x)
    if x.dtype.name == "bfloat16":          # ml_dtypes' bf16: its bits, reinterpreted
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _dense(prefix: str, node: Mapping) -> dict:
    kernel = node["kernel"]
    if isinstance(kernel, Mapping):
        out = {f"{prefix}.{key}": _tensor(value) for key, value in kernel.items()}
    else:
        # (in, out) → (out, in); a stacked kernel keeps its leading layer dim.
        out = {f"{prefix}.weight": _tensor(np.swapaxes(np.asarray(kernel), -1, -2))}
    if "bias" in node:
        out[f"{prefix}.bias"] = _tensor(node["bias"])
    return out


def _norm(prefix: str, node: Mapping) -> dict:
    out = {f"{prefix}.weight": _tensor(node["scale"])}
    if "bias" in node:
        out[f"{prefix}.bias"] = _tensor(node["bias"])
    return out


def _block(prefix: str, blk: Mapping) -> dict:
    out = _norm(f"{prefix}.ln_attn", blk["ln_attn"])
    for name in ("query", "key", "value", "out"):
        out.update(_dense(f"{prefix}.attn.{name}", blk["attn"][name]))
    out.update(_norm(f"{prefix}.ln_ff", blk["ln_ff"]))
    if "moe" in blk:
        # The expert stacks keep the JAX layout; the router is a Dense.
        moe = blk["moe"]
        out.update(_dense(f"{prefix}.moe.router", moe["router"]))
        out.update({f"{prefix}.moe.{name}": _tensor(moe[name]) for name in ("up", "down")})
        return out
    for name in ("up", "down"):
        out.update(_dense(f"{prefix}.ff.{name}", blk["ff"][name]))
    return out


def from_flax_params(params: Mapping, cfg) -> dict[str, torch.Tensor]:
    """JAX ``Transformer`` params → the port's state dict (CPU tensors in the
    tree's dtypes). ``cfg`` is the port's ``TransformerConfig`` of the same
    model. A ``scan_layers`` tree (its ``blocks`` subtree stacked) gives the
    stacked names of a ``scan_layers`` model."""
    sd = {"tok_embed.weight": _tensor(params["tok_embed"]["embedding"])}
    if not cfg.rope:
        sd["pos_embed"] = _tensor(params["pos_embed"])
    if "blocks" in params:
        sd.update(_block("blocks", params["blocks"]))
    else:
        for i in range(cfg.num_layers):
            sd.update(_block(f"blocks.{i}", params[f"block_{i}"]))
    sd.update(_norm("ln_out", params["ln_out"]))
    sd.update(_dense("lm_head", params["lm_head"]))
    return sd


def to_flax_params(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`from_flax_params`: the port's state dict (an
    unrolled one: ``blocks.<i>.…``) → the JAX ``Transformer`` param tree
    with numpy leaves (``(out, in)`` weights transposed back into ``(in,
    out)`` kernels, norm ``weight`` back to ``scale``; the MoE expert stacks
    and quantized nodes as they are)."""
    tree: dict = {}
    for name, value in sd.items():
        value = torch.as_tensor(value).detach().cpu()
        # bf16 leaves go out as fp32 (exact); numpy has no bf16 of its own.
        arr = (value.float() if value.dtype == torch.bfloat16 else value).numpy()
        parts = name.split(".")
        if parts[0] == "blocks":
            parts = [f"block_{parts[1]}", *parts[2:]]
        leaf = parts[-1]
        if name == "tok_embed.weight":
            path = ["tok_embed", "embedding"]
        elif len(parts) == 1:
            path = parts                                # pos_embed
        elif parts[-2] in ("ln_attn", "ln_ff", "ln_out"):
            path = parts[:-1] + ["scale" if leaf == "weight" else leaf]
        elif leaf == "weight":
            path, arr = parts[:-1] + ["kernel"], arr.swapaxes(-1, -2)
        elif leaf in ("q", "q4", "scale") and parts[-3:-2] != ["moe"]:
            path = parts[:-1] + ["kernel", leaf]      # a quantized projection
        else:
            path = parts                                # biases, the expert stacks
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def _is_stacked(name: str) -> bool:
    """A ``scan_layers`` model's block tensor: ``blocks.<site>...`` with no
    layer index (the unrolled name is ``blocks.<i>.<site>...``)."""
    parts = name.split(".")
    return parts[0] == "blocks" and len(parts) > 2 and not parts[1].isdigit()


def unstack_scan_params(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A ``scan_layers`` state dict (``blocks.<site>``, led by the layer
    dim) → the unrolled layout (``blocks.<i>.<site>``), so the same trained
    weights serve and export. The inverse of :func:`stack_scan_params`; a
    state dict already unrolled passes through as it is."""
    if not any(_is_stacked(name) for name in sd):
        return dict(sd)
    if any(name.split(".")[0] in ("embed", "head") for name in sd):
        # A pipelined model's stage-stacked tree also keeps "blocks", but
        # led by (stages, ...): splitting that as layers would give
        # wrong-rank tensors.
        raise ValueError(
            "params look like a PipelinedTransformer stage-stacked tree "
            "(embed/blocks/head); unstack_scan_params handles only "
            "Transformer scan_layers trees"
        )
    out = {}
    for name, value in sd.items():
        if not _is_stacked(name):
            out[name] = value
            continue
        site = name.split(".", 1)[1]
        for i, layer in enumerate(value.unbind(0)):
            out[f"blocks.{i}.{site}"] = layer
    return out


def stack_scan_params(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """An unrolled state dict (``blocks.<i>.<site>``) → the ``scan_layers``
    layout (``blocks.<site>``, each tensor gaining a leading layer dim). The
    inverse of :func:`unstack_scan_params`; a state dict already stacked
    passes through as it is."""
    layers: dict[str, dict[int, torch.Tensor]] = {}
    out = {}
    for name, value in sd.items():
        parts = name.split(".", 2)
        if parts[0] == "blocks" and len(parts) == 3 and parts[1].isdigit():
            layers.setdefault(parts[2], {})[int(parts[1])] = value
        else:
            out[name] = value
    for site, by_layer in layers.items():
        out[f"blocks.{site}"] = torch.stack([by_layer[i] for i in range(len(by_layer))])
    return out


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
    "router": (EMBED, EXPERT),
}


#: The MoE FF's tensors in the port's layout: the expert stacks as JAX
#: declares them, the router's ``(EMBED, EXPERT)`` kernel as an ``(out, in)``
#: weight (``models/moe.py``).
MOE_AXES = {
    "up": (EXPERT, EMBED, MLP),
    "down": (EXPERT, MLP, EMBED),
}


def param_logical_axes(name: str) -> tuple:
    """The logical axes of the port's parameter or buffer ``name``, in the
    port's layout: the JAX model's ``nn.with_logical_partitioning`` axes,
    reversed for an ``(out, in)`` weight; a ``scan_layers`` stack's tensors
    lead with ``LAYERS``, which no rule set maps, so they shard as their
    unrolled counterparts with the layer dim whole. An int4 node's ``q4`` and
    ``scale`` (``(K/2, N)`` and ``(K/g, N)``, the JAX layout) shard their
    columns only: split-half packing never splits the contraction."""
    if _is_stacked(name):
        # The scan_layers stack: its layer's axes behind an unmapped LAYERS.
        return (LAYERS, *param_logical_axes("blocks.0." + name.split(".", 1)[1]))
    parts = name.split(".")
    if name == "tok_embed.weight":
        return (VOCAB, EMBED)
    if name == "pos_embed":
        return (SEQ, EMBED)
    site, leaf = parts[-2], parts[-1]
    if site in ("ln_attn", "ln_ff", "ln_out"):
        return (EMBED,)
    if site == "moe" and leaf in MOE_AXES:
        return MOE_AXES[leaf]
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


def is_kernel_weight(name: str) -> bool:
    """Whether the port's tensor ``name`` is a projection's ``(out, in)``
    weight (a JAX ``(in, out)`` kernel, transposed; a ``scan_layers`` stack
    led by its layer dim)."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in KERNEL_AXES


def jax_dim_order(name: str, ndim: int) -> tuple[int, ...]:
    """The dims of the port's tensor ``name`` in the order of the JAX
    leaf's: a kernel weight's last two swapped, every other tensor's as
    they are. A rule that walks a leaf's dims (ZeRO-1's first divisible dim)
    walks them in this order to place the port's tensor as JAX places its
    leaf."""
    if is_kernel_weight(name) and ndim >= 2:
        return (*range(ndim - 2), ndim - 1, ndim - 2)
    return tuple(range(ndim))


def _jax_path(name: str) -> tuple[str, ...]:
    """The JAX tree path of the port's kernel weight ``name``
    (``blocks.0.attn.query.weight`` → ``block_0/attn/query/kernel``)."""
    parts = name.split(".")[:-1]
    if parts[0] == "blocks" and len(parts) > 1 and parts[1].isdigit():
        parts = [f"block_{parts[1]}", *parts[2:]]
    return (*parts, "kernel")


def _at(tree: Mapping, path: tuple[str, ...]):
    for key in path:
        if not isinstance(tree, Mapping) or key not in tree:
            return None
        tree = tree[key]
    return tree


def adapters_from_flax(adapters: Mapping, cfg) -> dict[str, dict[str, torch.Tensor]]:
    """A JAX LoRA adapter tree (``training.lora.init_lora``, leaves as
    numpy) → the port's adapters, ``{weight name: {"lora_a", "lora_b"}}``:
    A ``(in, r)`` and B ``(r, out)`` keep JAX's orientation, so nothing is
    transposed."""
    out = {}
    for name in _kernel_names(cfg):
        node = _at(adapters, _jax_path(name))
        if node is not None:
            out[name] = {k: _tensor(node[k]) for k in ("lora_a", "lora_b")}
    return out


def _kernel_names(cfg) -> list[str]:
    names = [f"blocks.{i}.{site}.weight" for i in range(cfg.num_layers)
             for site in ("attn.query", "attn.key", "attn.value", "attn.out", "ff.up", "ff.down")]
    return names + ["lm_head.weight"]


def load_optimizer_slot_(optimizer, model: torch.nn.Module, slot: str,
                         values: Mapping[str, torch.Tensor]) -> None:
    """Write ``values`` (by parameter name, the port's layout: a JAX
    ``MasterWeightsState``'s ``master`` or ``EmaState``'s ``ema`` through
    :func:`from_flax_params`) into the slot ``slot`` (``"master"``,
    ``"ema"``) that a wrapped optimizer (``training.precision``,
    ``training.ema``, under ZeRO-1 or not) keeps for each parameter, IN
    PLACE: JAX's masters or EMA carried across. Each slot keeps its own
    placement (a slice of the whole value under ZeRO-1)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in values:
                dst = optimizer.slot_tensor(p, slot)
                src = torch.as_tensor(values[name]).to(device=dst.device, dtype=dst.dtype)
                if isinstance(dst, DTensor):
                    src = distribute_tensor(src, dst.device_mesh, dst.placements)
                dst.copy_(src)


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


def config_from_hf_gpt2(hf_config: Any, **overrides):
    """The port's ``TransformerConfig`` of a ``transformers.GPT2Config`` (or
    any object with its fields). ``overrides`` pass to the dataclass (e.g.
    ``dtype=torch.bfloat16`` to serve a converted checkpoint in bf16).
    Raises on the GPT-2 variants this model does not compute, which would
    give silently wrong logits."""
    from learning_jax_sharding_tpu_torch.models.transformer import TransformerConfig

    if hf_config.activation_function not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported activation {hf_config.activation_function!r}: the "
            "FeedForward uses tanh GELU (gelu_new)"
        )
    for flag in ("scale_attn_by_inverse_layer_idx", "reorder_and_upcast_attn"):
        if getattr(hf_config, flag, False):
            raise ValueError(f"unsupported GPT-2 attention variant: {flag}=True")
    if not getattr(hf_config, "scale_attn_weights", True):
        # The attention always scales scores by head_dim**-0.5.
        raise ValueError("unsupported GPT-2 attention variant: scale_attn_weights=False")
    if hf_config.n_embd % hf_config.n_head:
        raise ValueError(
            f"n_embd {hf_config.n_embd} not divisible by n_head "
            f"{hf_config.n_head}: head_dim would be fractional"
        )
    fields = dict(
        vocab_size=hf_config.vocab_size,
        num_layers=hf_config.n_layer,
        features=hf_config.n_embd,
        num_heads=hf_config.n_head,
        head_dim=hf_config.n_embd // hf_config.n_head,
        # n_inner=None is GPT-2's 4 * n_embd.
        hidden=getattr(hf_config, "n_inner", None) or 4 * hf_config.n_embd,
        max_seq_len=hf_config.n_positions,
        use_bias=True,
        norm_eps=hf_config.layer_norm_epsilon,
        norm="layernorm",
        rope=False,
        causal=True,
        dtype=torch.float32,
        param_dtype=torch.float32,
    )
    fields.update(overrides)
    return TransformerConfig(**fields)


def params_from_hf_gpt2(hf_model: Any) -> dict[str, torch.Tensor]:
    """A ``transformers.GPT2LMHeadModel`` (its ``.state_dict()`` and
    ``.config``) → the port's state dict, fp32 CPU tensors of their own."""
    hf = hf_model.state_dict()
    e = hf_model.config.n_embd

    def t(name):
        return hf[f"transformer.{name}"].detach().to("cpu", torch.float32)

    def conv1d(prefix, conv, cols=slice(None)):
        # Conv1D is (in, out); nn.Linear wants (out, in).
        return {f"{prefix}.weight": t(f"{conv}.weight")[:, cols].T.contiguous(),
                f"{prefix}.bias": t(f"{conv}.bias")[cols].clone()}

    # "lm_head.weight" is right for tied and untied checkpoints alike (a
    # tied state dict aliases it to wte).
    head = hf.get("lm_head.weight", hf["transformer.wte.weight"])
    sd = {
        "tok_embed.weight": t("wte.weight").clone(),
        "pos_embed": t("wpe.weight").clone(),
    }
    for i in range(hf_model.config.n_layer):
        h, p = f"h.{i}", f"blocks.{i}"
        sd[f"{p}.ln_attn.weight"] = t(f"{h}.ln_1.weight").clone()
        sd[f"{p}.ln_attn.bias"] = t(f"{h}.ln_1.bias").clone()
        for j, name in enumerate(("query", "key", "value")):
            sd.update(conv1d(f"{p}.attn.{name}", f"{h}.attn.c_attn", slice(j * e, (j + 1) * e)))
        sd.update(conv1d(f"{p}.attn.out", f"{h}.attn.c_proj"))
        sd[f"{p}.ln_ff.weight"] = t(f"{h}.ln_2.weight").clone()
        sd[f"{p}.ln_ff.bias"] = t(f"{h}.ln_2.bias").clone()
        sd.update(conv1d(f"{p}.ff.up", f"{h}.mlp.c_fc"))
        sd.update(conv1d(f"{p}.ff.down", f"{h}.mlp.c_proj"))
    sd["ln_out.weight"] = t("ln_f.weight").clone()
    sd["ln_out.bias"] = t("ln_f.bias").clone()
    sd["lm_head.weight"] = head.detach().to("cpu", torch.float32).clone()
    return sd


def state_dict_from_params(sd: Mapping[str, torch.Tensor], *,
                           tie_head: bool = True) -> dict[str, torch.Tensor]:
    """The inverse of :func:`params_from_hf_gpt2`: the port's state dict (a
    ``scan_layers`` one is unstacked first) → a ``transformers`` GPT-2 state
    dict of fp32 CPU tensors. ``tie_head`` leaves out ``lm_head.weight`` for
    HF to tie to ``wte`` and refuses a head that differs from the embedding
    (exporting it as tied would drop trained weights); ``tie_head=False``
    keeps it. Load with ``load_state_dict(sd, strict=False)``: HF models
    carry buffers this does not emit."""
    sd = {name: torch.as_tensor(v).detach().to("cpu", torch.float32)
          for name, v in unstack_scan_params(sd).items()}
    out = {
        "transformer.wte.weight": sd["tok_embed.weight"],
        "transformer.wpe.weight": sd["pos_embed"],
        "transformer.ln_f.weight": sd["ln_out.weight"],
        "transformer.ln_f.bias": sd["ln_out.bias"],
    }
    head = sd["lm_head.weight"]
    if tie_head:
        if not torch.allclose(head, sd["tok_embed.weight"], atol=1e-6, rtol=0):
            raise ValueError(
                "lm_head is not tied to tok_embed (they differ); export with "
                "tie_head=False to keep the trained head"
            )
    else:
        out["lm_head.weight"] = head
    n_layer = len({name.split(".")[1] for name in sd if name.startswith("blocks.")})
    if n_layer == 0:
        raise ValueError("no blocks.<i> tensors found — not a Transformer state dict")

    def conv1d(prefix):            # nn.Linear (out, in) → Conv1D (in, out)
        return sd[f"{prefix}.weight"].T.contiguous()

    for i in range(n_layer):
        p, h = f"blocks.{i}", f"transformer.h.{i}"
        qkv = [f"{p}.attn.{name}" for name in ("query", "key", "value")]
        out.update({
            f"{h}.ln_1.weight": sd[f"{p}.ln_attn.weight"],
            f"{h}.ln_1.bias": sd[f"{p}.ln_attn.bias"],
            f"{h}.attn.c_attn.weight": torch.cat([conv1d(q) for q in qkv], dim=1),
            f"{h}.attn.c_attn.bias": torch.cat([sd[f"{q}.bias"] for q in qkv]),
            f"{h}.attn.c_proj.weight": conv1d(f"{p}.attn.out"),
            f"{h}.attn.c_proj.bias": sd[f"{p}.attn.out.bias"],
            f"{h}.ln_2.weight": sd[f"{p}.ln_ff.weight"],
            f"{h}.ln_2.bias": sd[f"{p}.ln_ff.bias"],
            f"{h}.mlp.c_fc.weight": conv1d(f"{p}.ff.up"),
            f"{h}.mlp.c_fc.bias": sd[f"{p}.ff.up.bias"],
            f"{h}.mlp.c_proj.weight": conv1d(f"{p}.ff.down"),
            f"{h}.mlp.c_proj.bias": sd[f"{p}.ff.down.bias"],
        })
    return out
