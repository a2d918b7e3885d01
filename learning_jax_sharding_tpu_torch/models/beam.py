"""Beam search over the KV-cached stack.

Port of ``learning_jax_sharding_tpu/models/beam.py``. Sampling
(``models/generate.py``) follows one path; beam search keeps the
``beam_size`` best prefixes at every step and returns the best complete
sequence.

* Beams fold into the batch: the prompt is prefilled once at ``B`` rows, the
  caches are then tiled to ``B·K`` rows (a row's beams adjacent), and each
  step is one cached model call at ``B·K`` rows (on the card through the
  decode attention kernel).
* Every step expands ``2K`` candidates per row from the flattened ``K·V``
  continuation scores, so ``K`` live beams survive even when ``K`` of them
  end in EOS.
* With ``eos_id`` a candidate that emits EOS leaves the live set for a
  ``K``-slot finished pool, its score normalised by ``length **
  length_penalty`` when it finishes; the best of the pool and the live beams
  wins at the end.
* The top-k is JAX's: ``lax.top_k`` puts the lower index first among equal
  values, which a stable descending sort gives (``torch.topk`` promises no
  order), so the pools hold the same hypotheses as JAX's, ``-1e9`` ties
  included.
* The beam reorder gathers every per-row tensor of the cache (k, v, the
  int8 scales, a ragged per-row index and position) with one
  ``index_select`` into a second set of buffers, then swaps the two: no
  cache is allocated per step. Over a mesh a row's beams stay in the rank
  that holds the row (``B`` a multiple of the data size), so each rank
  gathers its own rows with local indices; the logits are gathered whole
  before the pick, so every rank picks the same beams.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import torch
from torch.distributed.tensor import DTensor

from learning_jax_sharding_tpu_torch import resolve_device
from learning_jax_sharding_tpu_torch.models.attention import _local
from learning_jax_sharding_tpu_torch.models.convert import shard_params
from learning_jax_sharding_tpu_torch.models.decoding import (
    check_sequence_budget,
    derive_decode_config,
    make_cached_apply,
    make_param_caster,
    whole_logits,
)
from learning_jax_sharding_tpu_torch.models.generate import vocab_limit_filter
from learning_jax_sharding_tpu_torch.models.quantize import dequantize_tree
from learning_jax_sharding_tpu_torch.models.transformer import (
    DecodeCache,
    Transformer,
    TransformerConfig,
)
from learning_jax_sharding_tpu_torch.parallel.logical import BATCH, activate, logical_placements
from learning_jax_sharding_tpu_torch.parallel.sharding import local_rows

NEG_INF = -1e9
_CACHE_FIELDS = ("key", "value", "key_scale", "value_scale")


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the ``k`` largest values in
    descending order and their indices, the lower index first among equal
    values."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def gather_rows(src: DecodeCache, dst: DecodeCache, rows: torch.Tensor) -> None:
    """Fill ``dst``'s per-row tensors with ``src``'s rows ``rows`` (global
    row ids into ``src``, one a row of ``dst``), IN PLACE. A sharded
    buffer gathers on each rank: ``dst``'s local rows take their ids'
    local rows of ``src`` (a row of ``dst`` lies in the rank that holds its
    row of ``src``); whole per-row counters gather whole."""
    local_ids = {}                     # by (dst, src) placements: every layer's alike
    for s_layer, d_layer in zip(src.layers, dst.layers):
        for field in _CACHE_FIELDS:
            s, d = getattr(s_layer, field), getattr(d_layer, field)
            if s is None:
                continue
            ids = rows
            if isinstance(d, DTensor):
                key = (d.placements, s.placements)
                if key not in local_ids:
                    first = local_rows(torch.arange(s.shape[0], device=rows.device),
                                       s.device_mesh, s.placements)[:1]
                    local_ids[key] = local_rows(rows, d.device_mesh, d.placements) - first
                ids = local_ids[key]
            torch.index_select(_local(s), 0, ids, out=_local(d))
        if s_layer.index.ndim:
            torch.index_select(s_layer.index, 0, rows, out=d_layer.index)
        else:
            d_layer.index.copy_(s_layer.index)
    if src.position.ndim:
        torch.index_select(src.position, 0, rows, out=dst.position)
    else:
        dst.position.copy_(src.position)


def swap_caches(a: DecodeCache, b: DecodeCache) -> None:
    """Exchange the buffers of two caches of one shape, IN PLACE: ``a``
    takes ``b``'s and ``b`` takes ``a``'s (nothing copied)."""
    for la, lb in zip(a.layers, b.layers):
        for field in (*_CACHE_FIELDS, "index"):
            va, vb = getattr(la, field), getattr(lb, field)
            setattr(la, field, vb)
            setattr(lb, field, va)
    a.position, b.position = b.position, a.position


def make_beam_search_fn(
    config: TransformerConfig,
    mesh=None,
    rules=None,
    *,
    beam_size: int,
    max_new_tokens: int,
    eos_id: int | None = None,
    vocab_limit: int | None = None,
    length_penalty: float = 1.0,
    inference_dtype: torch.dtype | None = None,
    dequantize: bool = False,
    ragged: bool = False,
    device=None,
):
    """Build ``search(params, prompt, lengths=None) -> (tokens, scores)``.

    ``tokens``: the best hypothesis of each row, ``(B, prompt +
    max_new_tokens)`` int32, everything after an EOS filled with EOS;
    ``scores``: its length-normalised sequence log-probability, ``(B,)``
    fp32. ``params`` is a state dict of :class:`Transformer`, cast to
    ``inference_dtype`` once a call; ``config`` is the training config, its
    decode variant derived here. Runs on ``cuda`` unless ``device`` says
    otherwise.

    ``dequantize``: ``params`` is an int8 (or int4) state dict
    (``models.quantize.quantize_tree``) that stays quantized and is
    dequantized inside every model call; there is no fused int4 mode.

    ``ragged``: a right-padded prompt with per-row ``lengths``; each row's
    beams expand from its own last valid position, and row ``b`` of the
    output is ``[prompt_b, best hypothesis, fill]`` with the hypothesis at
    ``lengths[b]`` (fill: ``eos_id``, or 0), as ``make_generate_fn``'s
    ragged output.

    ``mesh``/``rules``: every rank calls ``search`` with the same arguments;
    the weights are laid out over the mesh on each call, the caches are
    born split, each step's logits are gathered whole before the pick, and
    the beam reorder stays inside each rank's rows: ``B`` must be a multiple
    of the ranks the batch splits over (``ValueError`` otherwise). Over a
    mesh ``dequantize`` dequantizes once a call.
    """
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    if config.vocab_size < 2 * beam_size:
        raise ValueError(
            f"vocab_size ({config.vocab_size}) must be >= 2*beam_size "
            f"({2 * beam_size}) for the 2K candidate expansion"
        )
    if config.decode_paged:
        raise ValueError(
            "beam search over a paged cache is not supported: beams tile "
            "the batch, which would need per-beam block tables (use the "
            "continuous engine for paged serving)"
        )
    data_size = 1          # the ranks a batch dim splits over (rows of one rank hold their beams)
    if mesh is not None:
        if rules is None:
            raise ValueError("rules are required when a mesh is given")
        device = mesh.device_type if device is None else device
        for dim, placement in enumerate(logical_placements(mesh, rules, (BATCH,))):
            data_size *= mesh.size(dim) if placement.is_shard() else 1
    device = resolve_device(device)
    cfg = derive_decode_config(config, inference_dtype)
    if ragged:
        cfg = dataclasses.replace(cfg, decode_ragged=True)
    model = Transformer(cfg, device=device).eval()
    maybe_cast = make_param_caster(inference_dtype, device, dequantize=dequantize)
    in_apply = dequantize and mesh is None
    cached_apply = make_cached_apply(model, dequantize=in_apply, dequant_dtype=cfg.param_dtype)
    scope = (lambda: activate(mesh, rules)) if mesh is not None else contextlib.nullcontext
    k = beam_size

    def limit(logits):
        return logits if vocab_limit is None else vocab_limit_filter(logits, vocab_limit)

    def norm(length: int) -> float:
        return float(length) ** length_penalty

    def expand(scores_2k, tokens_2k, cand_buf, pos, fin_scores, fin_buf):
        """Split the 2K candidates: those ending in EOS merge into the
        K-slot finished pool (normalised at their length ``pos + 1``, the
        suffix filled with EOS), the rest give the K live beams by raw
        score. → the pool and the live pick."""
        if eos_id is None:
            live_scores, live_idx = top_k(scores_2k, k)
            return fin_scores, fin_buf, live_scores, live_idx
        is_eos = tokens_2k == eos_id
        cols = torch.arange(cand_buf.shape[-1], device=cand_buf.device)
        padded = torch.where(cols > pos, eos_id, cand_buf)
        cand_fin = torch.where(is_eos, scores_2k / norm(pos + 1), NEG_INF)
        fin_scores, fin_idx = top_k(torch.cat([fin_scores, cand_fin], dim=1), k)
        all_buf = torch.cat([fin_buf, padded], dim=1)
        fin_buf = all_buf.gather(1, fin_idx[:, :, None].expand(-1, -1, all_buf.shape[-1]))
        live_scores, live_idx = top_k(torch.where(is_eos, NEG_INF, scores_2k), k)
        return fin_scores, fin_buf, live_scores, live_idx

    @torch.no_grad()
    def search(params: Mapping[str, torch.Tensor], prompt, lengths=None):
        if ragged and lengths is None:
            raise ValueError(
                "ragged=True: pass lengths (B,) — each row's true prompt "
                "length in the right-padded prompt batch"
            )
        if not ragged and lengths is not None:
            raise ValueError("lengths requires make_beam_search_fn(ragged=True)")
        prompt = torch.as_tensor(prompt, device=device).to(torch.int32)
        b, prompt_len = prompt.shape
        if b % data_size:
            raise ValueError(
                f"over a mesh the batch B={b} must be a multiple of the ranks "
                f"its rows split over ({data_size}): a row's beams stay in its rank"
            )
        check_sequence_budget(
            prompt_len + max_new_tokens, cfg.max_seq_len,
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens})",
        )
        weights = maybe_cast(params)
        if mesh is not None:
            if dequantize:
                weights = dequantize_tree(weights, cfg.param_dtype)
            shard_params(model, mesh, rules, weights)
            weights = None
        elif not in_apply:
            model.load_state_dict(weights)
            weights = None

        def apply(cache, tokens, chunk_lengths=None):
            with scope():
                return cached_apply(cache, tokens, chunk_lengths, params=weights)

        # Prefill once at B rows; the first logits from each row's last
        # valid position.
        if ragged:
            lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
            logits, prefilled = apply(None, prompt, lengths)
            last = whole_logits(logits, lengths - 1)
        else:
            logits, prefilled = apply(None, prompt)
            last = whole_logits(logits, torch.full((b,), prompt_len - 1, device=device))
        # The caches at B·K rows (row-major: a row's beams adjacent), and a
        # second set the beam reorder gathers into.
        with scope():
            cache, spare = model.init_cache(b * k), model.init_cache(b * k)
        row_of = torch.arange(b, device=device)
        gather_rows(prefilled, cache, row_of.repeat_interleave(k))
        del prefilled
        logp0 = torch.log_softmax(limit(last.float()), dim=-1)          # (B, V)
        vocab = logp0.shape[-1]

        fin_scores = torch.full((b, k), NEG_INF, device=device)
        fin_buf = torch.zeros((b, k, max_new_tokens), dtype=torch.int32, device=device)
        # The first expansion: a row's K beams are equal here, so the top 2K
        # tokens of its one prefill row seed it.
        scores_2k, tok_2k = top_k(logp0, 2 * k)
        cand_buf = torch.zeros((b, 2 * k, max_new_tokens), dtype=torch.int32, device=device)
        cand_buf[:, :, 0] = tok_2k
        fin_scores, fin_buf, scores, live_idx = expand(
            scores_2k, tok_2k, cand_buf, 0, fin_scores, fin_buf)
        tokens_buf = cand_buf.gather(1, live_idx[:, :, None].expand(-1, -1, max_new_tokens))

        for i in range(1, max_new_tokens):
            logits, cache = apply(cache, tokens_buf[:, :, i - 1].reshape(b * k, 1))
            step = whole_logits(logits, torch.zeros(b * k, dtype=torch.int32, device=device))
            logp = torch.log_softmax(limit(step.float()), dim=-1).reshape(b, k, vocab)
            total = scores[:, :, None] + logp                            # (B, K, V)
            scores_2k, flat_idx = top_k(total.reshape(b, k * vocab), 2 * k)
            parent_2k = flat_idx // vocab                                # (B, 2K)
            tok_2k = (flat_idx % vocab).to(torch.int32)
            cand_buf = tokens_buf.gather(1, parent_2k[:, :, None].expand(-1, -1, max_new_tokens))
            cand_buf[:, :, i] = tok_2k
            fin_scores, fin_buf, scores, live_idx = expand(
                scores_2k, tok_2k, cand_buf, i, fin_scores, fin_buf)
            tokens_buf = cand_buf.gather(1, live_idx[:, :, None].expand(-1, -1, max_new_tokens))
            parent = parent_2k.gather(1, live_idx)                       # (B, K)
            gather_rows(cache, spare, (row_of[:, None] * k + parent).reshape(-1))
            swap_caches(cache, spare)

        # The live beams (all at full length) join the finished pool on
        # normalised scores; with no EOS the pool is all NEG_INF.
        all_scores = torch.cat([fin_scores, scores / norm(max_new_tokens)], dim=1)
        all_buf = torch.cat([fin_buf, tokens_buf], dim=1)
        best = all_scores.argmax(dim=1)                                  # (B,)
        best_tokens = all_buf[row_of, best]
        best_score = all_scores[row_of, best]
        if not ragged:
            return torch.cat([prompt, best_tokens], dim=1), best_score
        # Row b's hypothesis starts at its length; every other cell past the
        # prompt, the caller's padding included, is the fill.
        fill = 0 if eos_id is None else eos_id
        col = torch.arange(prompt_len + max_new_tokens, device=device)[None, :]
        padded = torch.nn.functional.pad(prompt, (0, max_new_tokens))
        out = torch.where(col < lengths[:, None], padded, fill).to(torch.int32)
        cols = lengths.long()[:, None] + torch.arange(max_new_tokens, device=device)
        return out.scatter_(1, cols, best_tokens), best_score

    return search
