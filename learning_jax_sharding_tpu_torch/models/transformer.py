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

Not ported yet: MoE feed-forwards, ``scan_layers``, ``remat`` and the paged
cache; each raises ``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from learning_jax_sharding_tpu_torch import resolve_device
from learning_jax_sharding_tpu_torch.models.attention import (
    KVCache,
    MultiHeadAttention,
    linear,
)
from learning_jax_sharding_tpu_torch.models.quantize import projection_dense
from learning_jax_sharding_tpu_torch.ops.fused_norm import fused_residual_norm
from learning_jax_sharding_tpu_torch.ops.int4_ff import int4_ff, int4_ff_eligible


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
    remat: bool = False
    scan_layers: bool = False
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
    quantization: str | None = None     # "int4" / "int4_w4a8": int4 state dicts
    quantization_group: int = 128       # must match quantize_tree's group_size

    def __post_init__(self):
        later = {
            "num_experts": (self.num_experts > 0, "the MoE slice"),
            "scan_layers": (self.scan_layers, "slice D (training breadth)"),
            "remat": (self.remat, "slice D (training breadth)"),
            "decode_paged": (self.decode_paged, "the continuous-engine slice"),
        }
        for name, (used, where) in later.items():
            if used:
                raise NotImplementedError(f"{name}: ported with {where}")

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
        return fused_residual_norm(x, resid, self.weight, self.bias, eps=self.eps, kind=self.kind)


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
                 device=None, generator=None):
        super().__init__()
        self.features, self.hidden, self.use_bias = features, hidden, use_bias
        self.dtype = dtype
        self.quantization, self.quantization_group = quantization, quantization_group
        kw = dict(quantization=quantization, use_bias=use_bias, dtype=dtype,
                  param_dtype=param_dtype, group_size=quantization_group, device=device,
                  generator=generator)
        self.up = projection_dense(in_features=features, features=hidden, **kw)
        self.down = projection_dense(in_features=hidden, features=features, **kw)

    def _use_fused_ff(self, k: int) -> bool:
        return (
            self.quantization == "int4"
            and not self.use_bias
            and self.features == k
            and int4_ff_eligible(k, self.hidden, self.quantization_group)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._use_fused_ff(x.shape[-1]):
            # Up, GELU and down in one kernel: the hidden activation never
            # reaches device memory.
            return int4_ff(x.to(self.dtype), self.up.q4, self.up.scale, self.down.q4,
                           self.down.scale, group=self.quantization_group)
        h = nn.functional.gelu(linear(self.up, x, self.dtype), approximate="tanh")
        return linear(self.down, h, self.dtype)


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
            max_decode_len=cfg.max_seq_len if cfg.decode else 0,
            kv_cache_dtype=cfg.kv_cache_dtype, decode_attention=cfg.decode_attention,
            decode_block_k=cfg.decode_block_k, decode_ragged=cfg.decode_ragged,
            decode_paged=cfg.decode_paged, quantization=cfg.quantization,
            quantization_group=cfg.quantization_group, device=device, generator=generator,
        )
        self.ln_ff = make_norm(cfg.norm, cfg.features, eps=cfg.norm_eps, **norm)
        self.ff = FeedForward(
            cfg.features, cfg.hidden, use_bias=cfg.use_bias, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, quantization=cfg.quantization,
            quantization_group=cfg.quantization_group, device=device, generator=generator,
        )

    def forward(self, x, *, deterministic: bool = True, generator=None,
                cache: KVCache | None = None, chunk_lengths=None):
        attend = dict(deterministic=deterministic, generator=generator, cache=cache,
                      chunk_lengths=chunk_lengths)
        if self.fused_norm:
            h, _ = self.ln_attn(x)
            h, x = self.ln_ff(self.attn(h, **attend), x)
        else:
            x = x + self.attn(self.ln_attn(x), **attend)
            h = self.ln_ff(x)
        return x + self.ff(h)


@dataclasses.dataclass
class DecodeCache:
    """The model's decode state: one :class:`KVCache` per block plus the
    position counter of the learned position table (a scalar, or ``(B,)``
    when ragged). Updated IN PLACE by every decode forward."""

    layers: list[KVCache]
    position: torch.Tensor


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
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, device=device, generator=gen)
            for _ in range(cfg.num_layers)
        )
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
            device=device, generator=gen,
        )

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device

    def init_cache(self, batch: int) -> DecodeCache:
        """Zeroed decode caches for ``batch`` rows (decode configs only)."""
        cfg = self.config
        if not cfg.decode:
            raise ValueError("init_cache requires a decode config (decode=True)")
        return DecodeCache(
            layers=[blk.attn.init_cache(batch, self.device) for blk in self.blocks],
            position=torch.zeros(
                (batch,) if cfg.decode_ragged else (), dtype=torch.int32, device=self.device
            ),
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
        tokens = tokens.long()
        x = self.tok_embed(tokens).to(cfg.dtype)
        if self.pos_embed is not None:
            steps = torch.arange(s, device=tokens.device)
            if cache is None:
                positions = steps
            elif cfg.decode_ragged:
                positions = cache.position[:, None] + steps                  # (B, S)
            else:
                positions = cache.position + steps
            x = x + self.pos_embed[positions.long()].to(cfg.dtype)
            if cache is not None:
                cache.position += s if chunk_lengths is None else chunk_lengths.to(torch.int32)
        for i, block in enumerate(self.blocks):
            x = block(
                x, deterministic=deterministic, generator=generator,
                cache=None if cache is None else cache.layers[i],
                chunk_lengths=chunk_lengths,
            )
        x = self.ln_out(x)[0] if cfg.fused_norm else self.ln_out(x)
        if return_hidden:
            return x
        return linear(self.lm_head, x, cfg.dtype)


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
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, chunk_size):
        end = start + chunk_size
        total = total + checkpoint(
            _chunk_total, hidden[:, start:end], targets[:, start:end], head,
            use_reentrant=False,
        )
    return total / (b * s)


def next_token_loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """Causal-LM loss: mean fp32 cross-entropy over all positions.
    ``batch["targets"]`` must already be the inputs shifted left by one."""
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
