"""Decoder-only transformer: embed → N pre-LN blocks → final norm → logits.

Port of ``learning_jax_sharding_tpu/models/transformer.py``. Field names and
defaults of :class:`TransformerConfig` follow the JAX config; dtypes are
torch dtypes. The parameter init mirrors Flax's (normal(0.02) embeddings and
``lm_head``, lecun-normal projections, unit norms), drawn from a seeded
``torch.Generator``; ``models/convert.py`` carries a JAX parameter tree
across instead. The training path: ``Transformer.forward(...,
return_hidden=True)`` with :func:`fused_next_token_loss` (the chunked logits
head), or logits with :func:`next_token_loss` /
:func:`make_next_token_loss`; custom ``attn_fn`` backends (the flash
kernels) in the config.

Quantized serving: ``quantization="int4"`` / ``"int4_w4a8"`` builds every
projection (attention, FF, ``lm_head``) as an int4 ``Int4Linear`` that
consumes ``models/quantize.py::quantize_tree(bits=4)`` state dicts as they
are; an eligible int4 feed-forward runs whole through ``ops/int4_ff.py``.

``fused_norm=True`` runs every block boundary and the final norm through
the fused residual+norm kernels (``ops/fused_norm.py``) in
:class:`FusedNorm`, whose parameters are those of :class:`Norm`, so a state
dict loads across the flag. ``kv_cache_dtype=torch.int8`` passes to the
blocks' caches (``models/attention.py``).

``decode_paged=True`` (with ``decode_page_count`` pages of ``decode_block_k``
tokens, the blocked backend and ``decode_ragged``) keeps every layer's K/V in
page pools behind one ``(B, max_seq_len // page)`` block table, which the
continuous engine (``models/serving.py``) owns.

Over a mesh (``parallel.logical.activate(mesh, rules)`` active), the
parameters are DTensors placed by their logical axes
(``models/convert.py::param_logical_axes``), the activations are constrained
at the JAX model's points (``parallel.logical.constrain``, the identity with
no active mesh), and every custom kernel runs on local shards: the flash
and decode-attention wrappers, the int4 wrapper
(``quantized_matmul_fn``), and here the fused norm and the losses.

``remat=True`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``, non-reentrant) under the named
``remat_policy`` (:func:`resolve_remat_policy`); ``remat_attention=True``
recomputes only the dense attention core. ``scan_layers=True`` keeps the
blocks as one :class:`ScannedBlocks` whose parameters carry a leading
``(num_layers,)`` dim (``blocks.attn.query.weight``, no layer index in the
name; ``models/convert.py::stack_scan_params`` / ``unstack_scan_params``
carry a state dict across), training and evaluation only.

Not ported yet: MoE feed-forwards (``num_experts``), which raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from learning_jax_sharding_tpu_torch import resolve_device
from learning_jax_sharding_tpu_torch.models.attention import (
    KVCache,
    MultiHeadAttention,
    linear,
)
from learning_jax_sharding_tpu_torch.models.convert import KERNEL_AXES, install_tensor
from learning_jax_sharding_tpu_torch.models.quantize import projection_dense
from learning_jax_sharding_tpu_torch.ops.fused_norm import fused_residual_norm
from learning_jax_sharding_tpu_torch.ops.int4_ff import int4_ff, int4_ff_eligible
from learning_jax_sharding_tpu_torch.parallel.logical import (
    BATCH,
    EMBED,
    HIDDEN,
    SEQ,
    VOCAB,
    active_mesh,
    constrain,
    local_call,
    on_whole_shards,
    reduce_partial_grad,
    vocab_parallel_xent,
    whole_call,
)


#: The matmul ops each saving policy keeps. JAX's ``checkpoint_dots`` saves
#: every ``dot_general``; ``checkpoint_dots_with_no_batch_dims`` saves those
#: without batch dimensions in the ``dot_general`` sense, which is every
#: ``Dense`` projection (q, k, v, out, up, down: ``aten.mm``/``aten.addmm``
#: here) but not the attention's ``b,n``-batched score and value einsums
#: (``aten.bmm``). ``jax.ad_checkpoint.print_saved_residuals`` on the JAX
#: model shows exactly that: 6 Dense outputs a block under
#: ``"dots_no_batch"``, those and the two einsums under ``"dots"``.
_SAVED_DOTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
}


def _save_ops_policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: str | None):
    """A named block-rematerialization policy → the ``context_fn`` of
    ``torch.utils.checkpoint.checkpoint``, or None for plain checkpointing.

    ``None``/``"nothing"``: save nothing, recompute the whole block (the
    ``jax.checkpoint`` default). ``"dots"``: selective checkpointing that
    saves every matmul output (``aten.mm``, ``aten.addmm``, ``aten.bmm``)
    and recomputes the rest. ``"dots_no_batch"``: saves only the products
    without a batch dimension, the projections (``aten.mm``/``aten.addmm``),
    and recomputes the attention's batched einsums (``aten.bmm``): what
    JAX's ``checkpoint_dots_with_no_batch_dims`` saves (``_SAVED_DOTS``).
    A custom kernel's ``autograd.Function`` (the flash and fused-norm
    kernels) is no matmul, as a ``pallas_call`` is no ``dot_general``: it is
    recomputed under every policy."""
    if name is None or name == "nothing":
        return None
    if name not in _SAVED_DOTS:
        raise ValueError(
            f"unknown remat_policy {name!r}: expected None, 'nothing', "
            f"'dots', or 'dots_no_batch'"
        )
    policy = functools.partial(_save_ops_policy, _SAVED_DOTS[name])
    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_call(fn, x: torch.Tensor, *, generator: torch.Generator | None = None,
               context_fn=None) -> torch.Tensor:
    """``fn(x)`` under non-reentrant ``torch.utils.checkpoint``: its
    activations are recomputed in the backward (``context_fn``: a policy
    from :func:`resolve_remat_policy`).

    ``generator``: the explicit generator ``fn`` draws dropout from.
    Checkpointing restores only the default CPU and CUDA generators, so the
    recompute would draw other masks and the gradients would be silently
    wrong: the recompute replays ``generator`` from the state it had before
    the forward, then puts back the state it has now."""
    kwargs = dict(use_reentrant=False)
    if context_fn is not None:
        kwargs["context_fn"] = context_fn
    if generator is None:
        return checkpoint(fn, x, **kwargs)
    start, forward_done = generator.get_state(), []

    def replayed(h):
        if not forward_done:
            forward_done.append(True)
            return fn(h)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(h)
        finally:
            generator.set_state(after)

    return checkpoint(replayed, x, **kwargs)


def layer_runner(remat: bool, generator: torch.Generator | None = None, context_fn=None):
    """``run(fn, x)`` for one layer of a stack: ``fn(x)``, or under
    ``remat`` :func:`remat_call` with ``generator`` and ``context_fn``."""
    if not remat:
        return lambda fn, x: fn(x)
    return lambda fn, x: remat_call(fn, x, generator=generator, context_fn=context_fn)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Model hyperparameters (the JAX config's fields this slice uses)."""

    vocab_size: int = 50304
    num_layers: int = 12
    features: int = 768
    num_heads: int = 12
    head_dim: int = 64
    num_kv_heads: int | None = None
    rope: bool = False
    rope_theta: float = 10_000.0
    window: int | None = None
    hidden: int = 3072
    max_seq_len: int = 1024
    dropout_rate: float = 0.0
    causal: bool = True
    use_bias: bool = False
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False                 # recompute each block's activations
    remat_policy: str | None = None     # what remat saves (resolve_remat_policy)
    remat_attention: bool = False       # recompute only the dense attention core
    scan_layers: bool = False           # one stacked block (ScannedBlocks)
    attn_fn: object = None
    num_experts: int = 0
    norm: str = "layernorm"
    fused_norm: bool = False
    decode: bool = False
    kv_cache_dtype: torch.dtype | None = None
    decode_attention: str = "auto"
    decode_block_k: int | None = None
    decode_ragged: bool = False
    decode_paged: bool = False
    decode_page_count: int = 0          # paged: pages in each layer's pools
    quantization: str | None = None     # "int4" / "int4_w4a8": int4 state dicts
    quantization_group: int = 128       # must match quantize_tree's group_size
    quantized_matmul_fn: object = None  # per-shard int4 matmul (a mesh)

    def __post_init__(self):
        # 'nothing' is the default policy, so only one that changes what is
        # saved demands remat=True; a typo fails here.
        if resolve_remat_policy(self.remat_policy) is not None and not self.remat:
            raise ValueError(
                "remat_policy is set but remat=False — the policy would "
                "be silently ignored; set remat=True (or drop the policy)"
            )
        if self.num_experts > 0:
            raise NotImplementedError("num_experts: ported with the MoE slice")

    def train_step_flops(self, batch: int, seq: int) -> float:
        """Analytic model FLOPs of one train step (fwd + bwd ≈ 3× fwd), the
        JAX config's count: ``6 × matmul_params`` per token plus the
        attention einsums, causal attention at half the S² (what a
        tile-skipping kernel computes)."""
        matmul_params = (
            self.num_layers * (self._attn_proj_params + 2 * self.features * self.hidden)
            + self.features * self.vocab_size        # lm_head
        )
        attn_per_token = (
            4 * seq * self.num_heads * self.head_dim * self.num_layers
        ) * (0.5 if self.causal else 1.0)
        per_token = 6 * matmul_params + 3 * attn_per_token
        return float(per_token) * batch * seq

    @property
    def _attn_proj_params(self) -> int:
        """q + k + v + out projection params (k/v shrink under GQA)."""
        kv_heads = self.num_kv_heads if self.num_kv_heads is not None else self.num_heads
        return (
            2 * self.features * self.num_heads * self.head_dim   # q + out
            + 2 * self.features * kv_heads * self.head_dim       # k + v
        )

    @property
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head), the JAX
        config's count."""
        per_block = (
            self._attn_proj_params
            + 2 * self.features * self.hidden                    # ff up + down
            + 4 * self.features                                  # 2 LN scale+bias
        )
        pos = 0 if self.rope else self.max_seq_len * self.features
        embed = self.vocab_size * self.features + pos
        head = self.features * self.vocab_size
        return embed + self.num_layers * per_block + 2 * self.features + head


#: The 125M flagship: 12 × 768, 12 heads × 64, GPT-2-small shape.
CONFIG_125M = TransformerConfig()

#: Small config for tests.
CONFIG_TINY = TransformerConfig(
    vocab_size=256,
    num_layers=2,
    features=64,
    num_heads=4,
    head_dim=16,
    hidden=128,
    max_seq_len=64,
    dtype=torch.float32,
)


class Norm(nn.Module):
    """Flax ``LayerNorm`` / ``RMSNorm``: statistics in fp32 (LayerNorm with
    the fast variance E[x²] − E[x]², clipped at 0), scale and bias applied
    in fp32, the result cast to the compute dtype."""

    def __init__(self, kind: str, features: int, *, eps: float, dtype, param_dtype, device):
        super().__init__()
        if kind not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {kind!r}: expected 'layernorm' or 'rmsnorm'")
        self.kind, self.eps, self.dtype = kind, eps, dtype
        self.weight = nn.Parameter(torch.ones(features, dtype=param_dtype, device=device))
        self.bias = None
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            mean = xf.mean(-1, keepdim=True)
            var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
            y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
            y = y + self.bias.float()
        else:
            var = (xf * xf).mean(-1, keepdim=True)
            y = xf * (torch.rsqrt(var + self.eps) * self.weight.float())
        return y.to(self.dtype)


class FusedNorm(Norm):
    """:class:`Norm`'s parameters (``weight``, ``bias``: a state dict loads
    across the ``fused_norm`` flag) through the fused residual+norm kernels.
    Called as ``module(x, resid)`` → ``(normed, x + resid)``, the whole
    block boundary in one pass; ``module(x)`` → ``(normed, x)``. Unlike
    :class:`Norm` it takes LayerNorm's centred variance, and it normalises
    the unrounded fp32 sum, so the two agree to rounding only."""

    def forward(self, x: torch.Tensor, resid: torch.Tensor | None = None):
        x = x.to(self.dtype)
        if resid is not None:
            resid = resid.to(self.dtype)
        if active_mesh()[0] is not None:
            return self._sharded(x, resid)
        return fused_residual_norm(x, resid, self.weight, self.bias, eps=self.eps, kind=self.kind)

    def _sharded(self, x, resid):
        """The kernel on each shard's rows: features whole (a rule that
        splits EMBED gathers them, and the norm's parameters, first)."""
        rows = (BATCH, SEQ, None)
        args = [x, resid, self.weight, self.bias]
        specs = [rows, rows if resid is not None else None, (None,),
                 (None,) if self.bias is not None else None]

        def body(x_l, r_l, w_l, b_l):
            return fused_residual_norm(x_l, r_l, w_l, b_l, eps=self.eps, kind=self.kind)

        # gamma/beta: each shard's gradient sums its own rows only.
        return local_call(body, args, specs, (rows, rows), partial_grads=(2, 3))


def make_norm(kind: str, features: int, dtype, param_dtype, eps: float = 1e-6, *, device=None,
              fused: bool = False) -> Norm:
    """``"layernorm"`` (scale + bias) or ``"rmsnorm"`` (scale only); with
    ``fused`` the :class:`FusedNorm` of the same parameters."""
    cls = FusedNorm if fused else Norm
    return cls(kind, features, eps=eps, dtype=dtype, param_dtype=param_dtype, device=device)


class FeedForward(nn.Module):
    """Position-wise FF: up-project → tanh GELU (Flax ``nn.gelu``) → down.
    Under int4 quantization an eligible block runs whole through the fused
    ``int4_ff`` kernel (:meth:`_use_fused_ff`, the JAX module's rule)."""

    def __init__(self, features: int, hidden: int, *, use_bias=False, dtype=torch.float32,
                 param_dtype=torch.float32, quantization=None, quantization_group=128,
                 quantized_matmul_fn=None, device=None, generator=None):
        super().__init__()
        self.features, self.hidden, self.use_bias = features, hidden, use_bias
        self.dtype = dtype
        self.quantization, self.quantization_group = quantization, quantization_group
        self.quantized_matmul_fn = quantized_matmul_fn
        kw = dict(quantization=quantization, use_bias=use_bias, dtype=dtype,
                  param_dtype=param_dtype, group_size=quantization_group, device=device,
                  generator=generator, matmul_fn=quantized_matmul_fn)
        self.up = projection_dense(in_features=features, features=hidden,
                                   kernel_axes=KERNEL_AXES["up"], **kw)
        self.down = projection_dense(in_features=hidden, features=features,
                                     kernel_axes=KERNEL_AXES["down"], **kw)

    def _use_fused_ff(self, k: int) -> bool:
        """The JAX rule: int4 serving, not split over a mesh (one whose
        axes are all of size 1 keeps the whole-FF kernel: its shards are the
        whole)."""
        return (
            self.quantization == "int4"
            and on_whole_shards()
            and not self.use_bias
            and self.features == k
            and int4_ff_eligible(k, self.hidden, self.quantization_group)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = constrain(x, BATCH, SEQ, EMBED)
        if self._use_fused_ff(x.shape[-1]):
            # Up, GELU and down in one kernel: the hidden activation never
            # reaches device memory.
            args = (x.to(self.dtype), self.up.q4, self.up.scale, self.down.q4, self.down.scale)
            return whole_call(lambda *a: int4_ff(*a, group=self.quantization_group), args,
                              (BATCH, SEQ, EMBED))
        h = constrain(linear(self.up, x, self.dtype), BATCH, SEQ, HIDDEN)
        h = nn.functional.gelu(h, approximate="tanh")
        return constrain(linear(self.down, h, self.dtype), BATCH, SEQ, EMBED)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + Attn(LN(x)); x + FF(LN(x)). Under ``fused_norm``
    the boundary between the two (the attention residual add and ``ln_ff``)
    is one fused call; the FF residual stays a plain add."""

    def __init__(self, cfg: TransformerConfig, *, device=None, generator=None):
        super().__init__()
        self.fused_norm = cfg.fused_norm
        norm = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device,
                    fused=cfg.fused_norm)
        self.ln_attn = make_norm(cfg.norm, cfg.features, eps=cfg.norm_eps, **norm)
        self.attn = MultiHeadAttention(
            cfg.features, cfg.num_heads, cfg.head_dim,
            num_kv_heads=cfg.num_kv_heads, rope=cfg.rope, rope_theta=cfg.rope_theta,
            window=cfg.window, dropout_rate=cfg.dropout_rate, causal=cfg.causal,
            use_bias=cfg.use_bias, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
            attn_fn=cfg.attn_fn, decode=cfg.decode,
            quantized_matmul_fn=cfg.quantized_matmul_fn,
            max_decode_len=cfg.max_seq_len if cfg.decode else 0,
            kv_cache_dtype=cfg.kv_cache_dtype, decode_attention=cfg.decode_attention,
            decode_block_k=cfg.decode_block_k, decode_ragged=cfg.decode_ragged,
            decode_paged=cfg.decode_paged, decode_page_count=cfg.decode_page_count,
            quantization=cfg.quantization, remat_attention=cfg.remat_attention,
            quantization_group=cfg.quantization_group, device=device, generator=generator,
        )
        self.ln_ff = make_norm(cfg.norm, cfg.features, eps=cfg.norm_eps, **norm)
        self.ff = FeedForward(
            cfg.features, cfg.hidden, use_bias=cfg.use_bias, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, quantization=cfg.quantization,
            quantization_group=cfg.quantization_group,
            quantized_matmul_fn=cfg.quantized_matmul_fn, device=device, generator=generator,
        )

    def forward(self, x, *, deterministic: bool = True, generator=None,
                cache: KVCache | None = None, chunk_lengths=None):
        attend = dict(deterministic=deterministic, generator=generator, cache=cache,
                      chunk_lengths=chunk_lengths)
        x = constrain(x, BATCH, SEQ, EMBED)
        if self.fused_norm:
            h, _ = self.ln_attn(x)
            h, x = self.ln_ff(self.attn(h, **attend), x)
        else:
            x = x + self.attn(self.ln_attn(x), **attend)
            h = self.ln_ff(x)
        return constrain(x + self.ff(h), BATCH, SEQ, EMBED)


class ScannedBlocks(TransformerBlock):
    """The ``scan_layers`` stack: the structure of one
    :class:`TransformerBlock` whose every parameter carries a leading
    ``(num_layers,)`` dim, so the names have no layer index
    (``attn.query.weight`` of shape ``(L, out, in)``; logical axes led by
    ``LAYERS``, ``models/convert.py::param_logical_axes``).

    Each layer's weights are drawn as an unrolled stack draws them, one
    block after another from the model's generator (distinct layers, as
    JAX's ``split_rngs``; the same seed gives the unrolled model's weights,
    stacked). A forward unbinds every stacked tensor once and runs the
    layers in order through a weightless template block
    (``torch.func.functional_call``): one ``(L, …)`` gradient a tensor,
    where indexing each layer would write a whole ``(L, …)`` zero gradient
    for every layer. Under ``remat`` each layer is checkpointed on its own.
    Training and evaluation only (no decode caches)."""

    def __init__(self, cfg: TransformerConfig, *, device=None, generator=None):
        super().__init__(cfg, device=device, generator=generator)
        self.num_layers = cfg.num_layers
        rest = [dict(TransformerBlock(cfg, device=device, generator=generator).named_parameters())
                for _ in range(1, cfg.num_layers)]
        for name, first in list(self.named_parameters()):
            install_tensor(self, name, torch.stack([first.detach()]
                                                   + [r[name].detach() for r in rest]))
        # Outside the module tree: it holds no weights of its own.
        self.__dict__["_layer"] = TransformerBlock(cfg, device="meta")

    def forward(self, x, *, deterministic: bool = True, generator=None, run=None):
        """``run``: how each layer is called (:func:`layer_runner`)."""
        run = run or layer_runner(False)
        slices = {name: p.unbind(0) for name, p in self.named_parameters()}
        kwargs = dict(deterministic=deterministic, generator=generator)
        for i in range(self.num_layers):
            weights = {name: parts[i] for name, parts in slices.items()}
            x = run(functools.partial(self._run_layer, weights, kwargs), x)
        return x

    def _run_layer(self, weights, kwargs, x):
        return torch.func.functional_call(self._layer, weights, (x,), kwargs, strict=True)


@dataclasses.dataclass
class DecodeCache:
    """The model's decode state: one :class:`KVCache` per block plus the
    position counter of the learned position table (a scalar, or ``(B,)``
    when ragged). Updated IN PLACE by every decode forward.

    Paged: ``block_table`` is the ONE ``(B, max_seq_len // page)`` int32
    table that every layer's cache reads (each ``KVCache.block_table`` is
    this same tensor; the JAX model keeps one leaf per layer, all equal).
    The forward never writes it; its owner updates it in place."""

    layers: list[KVCache]
    position: torch.Tensor
    block_table: torch.Tensor | None = None


class Transformer(nn.Module):
    """Decoder-only LM. Runs on ``cuda`` unless ``device`` says otherwise
    (``device="cpu"`` for the plain path); raises when no GPU is present and
    none was asked for. ``seed`` drives the Flax-mirroring init."""

    def __init__(self, config: TransformerConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        gen = torch.Generator(device=device).manual_seed(seed)
        self.tok_embed = nn.Embedding(
            cfg.vocab_size, cfg.features, dtype=cfg.param_dtype, device=device
        )
        self.pos_embed = None
        if not cfg.rope:
            self.pos_embed = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.features, dtype=cfg.param_dtype, device=device)
            )
        if cfg.scan_layers:
            if cfg.decode:
                raise ValueError(
                    "scan_layers does not support decode mode yet: use the "
                    "unrolled stack for KV-cached generation"
                )
            self.blocks = ScannedBlocks(cfg, device=device, generator=gen)
        else:
            self.blocks = nn.ModuleList(
                TransformerBlock(cfg, device=device, generator=gen)
                for _ in range(cfg.num_layers)
            )
        self._remat_context = resolve_remat_policy(cfg.remat_policy)
        self.ln_out = make_norm(
            cfg.norm, cfg.features, cfg.dtype, cfg.param_dtype, cfg.norm_eps, device=device,
            fused=cfg.fused_norm,
        )
        with torch.no_grad():
            nn.init.normal_(self.tok_embed.weight, 0.0, 0.02, generator=gen)
            if self.pos_embed is not None:
                nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=gen)
        self.lm_head = projection_dense(
            quantization=cfg.quantization, in_features=cfg.features, features=cfg.vocab_size,
            use_bias=False, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
            group_size=cfg.quantization_group,
            kernel_init=lambda w, g: nn.init.normal_(w, 0.0, 0.02, generator=g),
            kernel_axes=KERNEL_AXES["lm_head"], matmul_fn=cfg.quantized_matmul_fn,
            device=device, generator=gen,
        )

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device

    def init_cache(self, batch: int, block_table: torch.Tensor | None = None) -> DecodeCache:
        """Zeroed decode caches for ``batch`` rows (decode configs only).
        Paged: every layer reads one block table, ``block_table`` when given
        (a draft model's cache pages through its target's table)."""
        cfg = self.config
        if not cfg.decode:
            raise ValueError("init_cache requires a decode config (decode=True)")
        layers: list[KVCache] = []
        for blk in self.blocks:
            table = layers[0].block_table if layers else block_table
            layers.append(blk.attn.init_cache(batch, self.device, block_table=table))
        return DecodeCache(
            layers=layers,
            position=torch.zeros(
                (batch,) if cfg.decode_ragged else (), dtype=torch.int32, device=self.device
            ),
            block_table=layers[0].block_table if layers else None,
        )

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
        return_hidden: bool = False,
        cache: DecodeCache | None = None,
        chunk_lengths: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``(B, S)`` token ids → ``(B, S, V)`` logits in the compute dtype,
        or with ``return_hidden`` the ``(B, S, M)`` final-norm output (for
        :func:`fused_next_token_loss`, which applies the head chunk by
        chunk). ``deterministic=False`` applies dropout drawn from
        ``generator``; the default, like the JAX ``apply``, applies none.
        Decode configs take a ``cache`` (updated in place); ``chunk_lengths``
        is ragged decode only: per-row valid tokens of this chunk."""
        cfg = self.config
        b, s = tokens.shape
        if s > cfg.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}")
        if chunk_lengths is not None and not (cfg.decode and cfg.decode_ragged):
            raise ValueError("chunk_lengths requires decode=True and decode_ragged=True")
        if cfg.decode != (cache is not None):
            raise ValueError("a decode config takes a DecodeCache, and only a decode config does")
        tokens = constrain(tokens, BATCH, SEQ).long()
        # Over a mesh a vocabulary-split table's rows come back as masked
        # partial sums: each lookup is reduced on its own (the two masks
        # cannot meet in one add), and so is its gradient on the way back
        # (a partial sum there, from the first block's split projections,
        # cannot become the masked partial).
        x = reduce_partial_grad(
            constrain(self.tok_embed(tokens).to(cfg.dtype), BATCH, SEQ, EMBED))
        if self.pos_embed is not None:
            steps = torch.arange(s, device=self.device)
            if cache is None:
                positions = steps
            elif cfg.decode_ragged:
                positions = cache.position[:, None] + steps                  # (B, S)
            else:
                positions = cache.position + steps
            # A row gather of the (SEQ, EMBED) table (over a mesh, DTensor's
            # embedding rule serves any placement of it).
            pos = nn.functional.embedding(positions.long(), self.pos_embed)
            pos = constrain(pos, *((BATCH, SEQ, EMBED) if pos.ndim == 3 else (SEQ, EMBED)))
            x = x + pos.to(cfg.dtype)
            if cache is not None:
                cache.position += s if chunk_lengths is None else chunk_lengths.to(torch.int32)
        x = constrain(x, BATCH, SEQ, EMBED)
        # Remat wraps the training call only: never the decode path, nor a
        # forward that records no graph.
        run = layer_runner(cfg.remat and not cfg.decode and torch.is_grad_enabled(),
                           None if deterministic else generator, self._remat_context)
        if cfg.scan_layers:
            x = self.blocks(x, deterministic=deterministic, generator=generator, run=run)
        else:
            for i, block in enumerate(self.blocks):
                x = run(functools.partial(
                    block, deterministic=deterministic, generator=generator,
                    cache=None if cache is None else cache.layers[i],
                    chunk_lengths=chunk_lengths,
                ), x)
        x = self.ln_out(x)[0] if cfg.fused_norm else self.ln_out(x)
        if return_hidden:
            return x
        return constrain(linear(self.lm_head, x, cfg.dtype), BATCH, SEQ, VOCAB)


def _chunk_total(hidden: torch.Tensor, targets: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Summed fp32 cross-entropy of one chunk's logits (compute-dtype head
    product)."""
    logits = nn.functional.linear(hidden, head)
    return nn.functional.cross_entropy(
        logits.float().flatten(0, 1), targets.flatten().long(), reduction="sum"
    )


def fused_next_token_loss(
    hidden: torch.Tensor, batch: dict, model: Transformer, *, chunk_size: int = 128
) -> torch.Tensor:
    """Causal-LM loss with a chunked logits head: O(B·chunk·V) logits.

    ``hidden`` is the final-norm output (``model(tokens,
    return_hidden=True)``), ``batch["targets"]`` the inputs shifted left by
    one. Per sequence chunk: the head product in the compute dtype (the
    ``(V, M)`` ``model.lm_head.weight``, cast once), then fp32
    cross-entropy, summed; the total is divided by ``B·S``. Each chunk runs
    under ``torch.utils.checkpoint``, so forward and backward hold the
    logits of one chunk only, as ``jax.checkpoint`` does in the JAX loss.
    """
    b, s, _ = hidden.shape
    if s % chunk_size:
        raise ValueError(f"seq len {s} not divisible by chunk_size {chunk_size}")
    head = model.lm_head.weight.to(hidden.dtype)
    targets = batch["targets"]
    if active_mesh()[0] is not None:
        return _sharded_fused_loss(hidden, targets, head, chunk_size)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, chunk_size):
        end = start + chunk_size
        total = total + checkpoint(
            _chunk_total, hidden[:, start:end], targets[:, start:end], head,
            use_reentrant=False,
        )
    return total / (b * s)


def _sharded_chunk_total(hidden, targets, head):
    """One chunk's summed cross-entropy over a mesh: the head product as
    DTensor places it, the logits constrained as the JAX loss constrains
    them, then :func:`vocab_parallel_xent` on each shard."""
    logits = constrain(nn.functional.linear(hidden, head), BATCH, SEQ, VOCAB)
    return vocab_parallel_xent(logits, targets)


def _sharded_fused_loss(hidden, targets, head, chunk_size):
    b, s, _ = hidden.shape
    # The chunk loop slices the sequence: gather it first where a rule
    # splits it (sequence parallelism), as the JAX loss reshapes it whole.
    hidden = constrain(hidden, BATCH, None, None)
    targets = constrain(targets, BATCH, None)
    total = None
    for start in range(0, s, chunk_size):
        end = start + chunk_size
        part = checkpoint(_sharded_chunk_total, hidden[:, start:end], targets[:, start:end],
                          head, use_reentrant=False)
        total = part if total is None else total + part
    return constrain(total / (b * s))


def next_token_loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """Causal-LM loss: mean fp32 cross-entropy over all positions.
    ``batch["targets"]`` must already be the inputs shifted left by one."""
    if active_mesh()[0] is not None:
        # Over a mesh: each shard's rows against its vocabulary slice.
        logits = constrain(logits, BATCH, SEQ, VOCAB)
        return constrain(vocab_parallel_xent(logits, batch["targets"]) / batch["targets"].numel())
    return nn.functional.cross_entropy(
        logits.float().flatten(0, -2), batch["targets"].flatten().long()
    )


def make_next_token_loss(*, label_smoothing: float = 0.0, z_loss: float = 0.0):
    """Causal-LM loss with label smoothing ε (``(1-ε)·nll + ε·(logsumexp −
    mean logits)``, no one-hot) and/or a z-loss ``z_loss·logsumexp²``. The
    defaults reproduce :func:`next_token_loss`."""

    def loss_fn(logits: torch.Tensor, batch: dict) -> torch.Tensor:
        logits = logits.float()
        targets = batch["targets"].long()
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - logits.gather(-1, targets[..., None])[..., 0]
        loss = nll
        if label_smoothing:
            uniform_nll = lse - logits.mean(dim=-1)
            loss = (1.0 - label_smoothing) * nll + label_smoothing * uniform_nll
        if z_loss:
            loss = loss + z_loss * lse.square()
        return loss.mean()

    return loss_fn
