"""Autoregressive generation with a KV cache.

Port of ``learning_jax_sharding_tpu/models/generate.py``: one prefill call
fills every block's cache, then a Python loop feeds one token per step (the
JAX package's ``lax.scan`` / ``while_loop``). Greedy, temperature, top-k,
top-p, min-p and vocab-limited sampling and a CTRL-style repetition penalty;
filters compose vocab-limit → temperature → top-k → top-p → min-p.

The decode loop never waits for the device, except with ``eos_id``: that
loop reads one boolean per step ("has every row finished?") to exit early.
Each step is a chain of eager launches; capturing it in a CUDA graph is
later work.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import torch
from torch.distributed.tensor import DTensor

from learning_jax_sharding_tpu_torch import resolve_device
from learning_jax_sharding_tpu_torch.models.decoding import (
    apply_dequantize_policy,
    batch_ranks,
    check_sequence_budget,
    derive_decode_config,
    make_cached_apply,
    make_param_caster,
    pad_rows,
    whole_logits,
)
from learning_jax_sharding_tpu_torch.models.convert import shard_params
from learning_jax_sharding_tpu_torch.models.quantize import dequantize_tree
from learning_jax_sharding_tpu_torch.models.transformer import Transformer, TransformerConfig
from learning_jax_sharding_tpu_torch.parallel.logical import activate


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k largest logits per row to -inf (ties with the
    k-th value survive)."""
    if k <= 0:
        raise ValueError(f"top_k must be positive, got {k}")
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest set of tokens with cumulative
    probability ≥ p (always at least one), mask the rest to -inf."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {p}")
    probs = torch.softmax(logits, dim=-1)
    # Descending as the JAX filter orders it: a stable ascending sort reversed.
    order = torch.argsort(probs, dim=-1, stable=True).flip(-1)
    sorted_probs = probs.gather(-1, order)
    cumulative = sorted_probs.cumsum(-1)
    keep_sorted = cumulative - sorted_probs < p
    keep = keep_sorted.gather(-1, torch.argsort(order, dim=-1))
    return logits.masked_fill(~keep, float("-inf"))


def min_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep tokens whose probability is at least ``p`` times the top one's:
    ``logit >= max_logit + log(p)``."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"min_p must be in (0, 1], got {p}")
    cutoff = logits.amax(dim=-1, keepdim=True) + torch.log(
        torch.tensor(p, dtype=logits.dtype, device=logits.device)
    )
    return logits.masked_fill(logits < cutoff, float("-inf"))


def repetition_penalty_filter(
    logits: torch.Tensor, seen: torch.Tensor, penalty: float
) -> torch.Tensor:
    """For tokens in ``seen`` ((B, V) bool): positive logits are divided by
    ``penalty`` and negative ones multiplied."""
    if penalty <= 0:
        raise ValueError(f"repetition_penalty must be positive, got {penalty}")
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def vocab_limit_filter(logits: torch.Tensor, limit: int) -> torch.Tensor:
    """Mask logits at ids ≥ ``limit`` (the padded tail of the vocab) to -inf."""
    if limit < 1:
        raise ValueError(f"vocab_limit must be >= 1, got {limit}")
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(ids >= limit, float("-inf"))


def filtered_logits(
    logits: torch.Tensor,
    temperature: float,
    top_k: int | None = None,
    top_p: float | None = None,
    min_p: float | None = None,
    vocab_limit: int | None = None,
) -> torch.Tensor:
    """The sampling distribution in logit space, fp32: vocab-limit →
    temperature → top-k → top-p → min-p. Requires ``temperature > 0``."""
    logits = logits.float() / temperature
    if vocab_limit is not None:
        logits = vocab_limit_filter(logits, vocab_limit)
    if top_k is not None:
        logits = top_k_filter(logits, top_k)
    if top_p is not None:
        logits = top_p_filter(logits, top_p)
    if min_p is not None:
        logits = min_p_filter(logits, min_p)
    return logits


def _sample(
    logits: torch.Tensor,
    temperature: float,
    generator: torch.Generator | None,
    top_k: int | None = None,
    top_p: float | None = None,
    min_p: float | None = None,
    vocab_limit: int | None = None,
) -> torch.Tensor:
    """(B, V) logits → (B,) int32 ids: argmax at temperature 0, else a
    Gumbel-max draw from ``generator`` (categorical sampling, as
    ``jax.random.categorical``; the random bits differ)."""
    if temperature == 0.0:
        if vocab_limit is not None:
            logits = vocab_limit_filter(logits, vocab_limit)
        return logits.argmax(dim=-1).to(torch.int32)
    logits = filtered_logits(logits, temperature, top_k, top_p, min_p, vocab_limit)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return (logits + gumbel).argmax(dim=-1).to(torch.int32)


def make_generate_fn(
    config: TransformerConfig,
    mesh=None,
    rules=None,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    min_p: float | None = None,
    vocab_limit: int | None = None,
    repetition_penalty: float | None = None,
    eos_id: int | None = None,
    prefill_chunk_size: int | None = None,
    inference_dtype: torch.dtype | None = None,
    dequantize: bool | str = False,
    ragged: bool = False,
    device=None,
):
    """Build ``generate(params, prompt, generator=None, lengths=None) ->
    (B, prompt + new)`` int32 tokens on the device.

    ``params`` is a state dict of :class:`Transformer` (e.g. from
    ``models.convert.from_flax_params``); it is cast to ``inference_dtype``
    once per call and loaded into the decode model. ``config`` is the
    training config; its decode variant is derived here. Runs on ``cuda``
    unless ``device`` says otherwise.

    ``ragged``: the prompt arrives right-padded and ``lengths`` ((B,)) gives
    each row's length; row ``b`` of the result is ``[prompt_b, generated,
    fill]`` with the generated span at ``lengths[b]``; every other cell is
    the fill (``eos_id``, or 0). Not combinable with ``prefill_chunk_size``.

    ``eos_id``: rows that emit it are frozen (EOS from there on; ragged rows
    also stop advancing their caches) and the loop exits once every row
    has finished.

    ``prefill_chunk_size``: feed the prompt through the cache in chunks of
    this size instead of one call.

    ``generator``: drives sampling when ``temperature > 0`` (a fresh one
    seeded 0 when ``None``). ``vocab_limit`` masks ids ≥ it, for greedy too.
    ``repetition_penalty`` down-weights every token already in the row,
    prompt included.

    ``dequantize``: ``"fused"``: ``params`` is an int4 state dict
    (``models.quantize.quantize_tree(bits=4)``) and every projection streams
    the packed nibbles into its product through the fused CUDA kernels
    (``ops/int4_matmul.py``, ``ops/int4_ff.py``): no dequantized weight in
    device memory. ``"fused_w4a8"``: the same state dict, with activations
    quantized per row to int8 and int8 × int4 products summed in int32.
    ``True``: an int8 (or int4) state dict that stays quantized and is
    dequantized to the compute dtype inside every model call. Quantized
    nodes are never cast; embeddings and norms cast to ``inference_dtype``.

    ``mesh``/``rules``: tensor-parallel generate (the JAX package's
    ``make_generate_fn(config, mesh, rules)``). Every rank calls
    ``generate`` with the same arguments; the weights are laid out over the
    mesh by their logical axes on each call, the KV caches are born split
    over batch and heads (each rank holds its shard), every kernel runs on
    its shard (decode attention on the cache's shards, the int4 matmuls
    through their per-shard wrapper), and each step's last-position logits
    are gathered whole, so every rank picks the same tokens and returns the
    whole result. The mesh's device is the default ``device``. Over a mesh ``dequantize=True``
    dequantizes the state dict once a call (the same weights a model call
    would see). Ragged over a mesh keeps the per-row lengths and cache
    counters whole on every rank; each rank's attention takes its rows.
    A batch the mesh's batch split does not divide is padded with copies
    of its first row (``models.decoding.pad_rows``), which are dropped from
    the result.
    """
    if ragged and prefill_chunk_size is not None:
        raise ValueError(
            "ragged and prefill_chunk_size cannot combine (chunked ragged "
            "prefill would need per-chunk logit gathers; prefill whole)"
        )
    if prefill_chunk_size is not None and prefill_chunk_size < 1:
        raise ValueError(f"prefill_chunk_size must be >= 1, got {prefill_chunk_size}")
    if mesh is not None:
        if rules is None:
            raise ValueError("rules are required when a mesh is given")
        device = mesh.device_type if device is None else device
    device = resolve_device(device)
    cfg = derive_decode_config(config, inference_dtype)
    if ragged:
        cfg = dataclasses.replace(cfg, decode_ragged=True)
    cfg, fused = apply_dequantize_policy(cfg, dequantize, mesh, rules)
    model = Transformer(cfg, device=device).eval()
    maybe_cast = make_param_caster(inference_dtype, device, dequantize=bool(dequantize))
    in_apply = bool(dequantize) and not fused and mesh is None
    cached_apply = make_cached_apply(model, dequantize=in_apply, dequant_dtype=cfg.param_dtype)
    scope = (lambda: activate(mesh, rules)) if mesh is not None else contextlib.nullcontext
    split = batch_ranks(mesh, rules)

    @torch.no_grad()
    def generate(
        params: Mapping[str, torch.Tensor],
        prompt,
        generator: torch.Generator | None = None,
        lengths=None,
    ) -> torch.Tensor:
        if ragged and lengths is None:
            raise ValueError(
                "ragged=True: pass lengths (B,) — each row's true prompt "
                "length in the right-padded prompt batch"
            )
        if not ragged and lengths is not None:
            raise ValueError("lengths requires make_generate_fn(ragged=True)")
        prompt = torch.as_tensor(prompt, device=device).to(torch.int32)
        real = prompt.shape[0]
        prompt = pad_rows(prompt, split)
        if ragged:
            lengths = pad_rows(torch.as_tensor(lengths, device=device).to(torch.int32), split)
        b, prompt_len = prompt.shape
        check_sequence_budget(
            prompt_len + max_new_tokens, cfg.max_seq_len,
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens})",
        )
        if generator is None and temperature > 0:
            generator = torch.Generator(device=device).manual_seed(0)
        # The model serves its loaded weights, or (``dequantize=True``) each
        # call dequantizes the quantized state dict it is given.
        weights = maybe_cast(params)
        if mesh is not None:
            if dequantize and not fused:
                weights = dequantize_tree(weights, cfg.param_dtype)
            shard_params(model, mesh, rules, weights)
            weights = None
        elif not in_apply:
            model.load_state_dict(weights)
            weights = None

        def apply(cache, tokens, chunk_lengths=None):
            with scope():
                return cached_apply(cache, tokens, chunk_lengths, params=weights)

        def step_apply(cache, tokens, chunk_lengths=None):
            logits, cache = apply(cache, tokens, chunk_lengths)
            logits = logits[:, -1]
            # Over a mesh the last logits are gathered whole: every rank picks.
            return (logits.full_tensor() if isinstance(logits, DTensor) else logits), cache

        rows = torch.arange(b, device=device)

        if ragged:
            # Each row's pad tail writes garbage K/V past its length, masked
            # now and overwritten as the row generates; the first logits come
            # from each row's own last valid position.
            logits_all, cache = apply(None, prompt, lengths)
            logits = whole_logits(logits_all, lengths - 1)
        else:
            chunk = prefill_chunk_size or prompt_len
            cache = None
            for start in range(0, prompt_len, chunk):
                logits, cache = step_apply(cache, prompt[:, start : start + chunk])

        seen = None
        if repetition_penalty is not None:
            if ragged:
                # Only valid prompt positions count: a short row's pad tail
                # must not penalize the pad id.
                valid = torch.arange(prompt_len, device=device)[None, :] < lengths[:, None]
            else:
                valid = torch.ones_like(prompt, dtype=torch.bool)
            counts = torch.zeros(b, logits.shape[-1], dtype=torch.int32, device=device)
            counts.scatter_add_(1, prompt.long(), valid.to(torch.int32))
            seen = counts > 0

        def pick(logits, seen):
            if repetition_penalty is not None:
                logits = repetition_penalty_filter(logits, seen, repetition_penalty)
            tok = _sample(logits, temperature, generator, top_k, top_p, min_p, vocab_limit)
            if repetition_penalty is not None:
                seen = seen.clone()
                seen[rows, tok.long()] = True
            return tok, seen

        def advance(tok, cache, seen, active=None):
            logits, cache = step_apply(cache, tok[:, None], active)
            nxt, seen = pick(logits, seen)
            return nxt, cache, seen

        def assemble(new_tokens):
            if not ragged:
                return torch.cat([prompt, new_tokens], dim=1)
            fill = 0 if eos_id is None else eos_id
            total = prompt_len + max_new_tokens
            col = torch.arange(total, device=device)[None, :]
            padded = torch.nn.functional.pad(prompt, (0, max_new_tokens))
            out = torch.where(col < lengths[:, None], padded, fill).to(torch.int32)
            cols = lengths.long()[:, None] + torch.arange(max_new_tokens, device=device)
            return out.scatter_(1, cols, new_tokens)

        tok, seen = pick(logits, seen)
        buffer = torch.empty(b, max_new_tokens, dtype=torch.int32, device=device)
        buffer[:, 0] = tok
        if eos_id is None:
            for i in range(1, max_new_tokens):
                tok, cache, seen = advance(tok, cache, seen)
                buffer[:, i] = tok
            return assemble(buffer)[:real]

        # EOS early exit: finished rows are frozen to EOS (their model step
        # still runs in the batch, its output overwritten). One host read of
        # "all finished" per step.
        buffer[:, 1:] = eos_id
        finished = tok == eos_id
        i = 1
        while i < max_new_tokens and not bool(finished[:real].all()):
            active = (~finished).to(torch.int32) if ragged else None
            nxt, cache, seen = advance(tok, cache, seen, active)
            tok = torch.where(finished, eos_id, nxt).to(torch.int32)
            buffer[:, i] = tok
            finished = finished | (tok == eos_id)
            i += 1
        return assemble(buffer)[:real]

    return generate
