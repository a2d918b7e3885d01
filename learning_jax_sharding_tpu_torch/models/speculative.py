"""Speculative decoding: a small draft model proposes, the target verifies.

Port of ``learning_jax_sharding_tpu/models/speculative.py`` on one device.
A draft model proposes ``num_draft`` tokens one at a time, the target scores
the whole proposal in ONE chunked forward (decode attention over the cache
at its index, the path prefill takes), the longest prefix of proposals that
matches the target's own picks is accepted, plus one bonus token from the
target's logits. Each round costs one target call and yields 1 to
``num_draft + 1`` tokens, and greedy output is exactly the target's plain
greedy decode.

* Rollback rewinds each layer's cache ``index`` and the cache ``position``
  in place (:func:`_rollback`): stale K/V past the index are masked by the
  causal-at-index attention and overwritten by the next chunk.
* The rectangular path takes the MINIMUM acceptance over the batch each
  round (one scalar index); the ragged path (``ragged=True``) accepts and
  rewinds per row, and frozen rows ride with chunk length 0.
* ``temperature > 0``: Leviathan rejection sampling (accept ``x`` when
  ``u·q(x) < p(x)``, correct a rejection from ``norm(max(p − q, 0))``).
  Every draw is keyed by absolute generated position and a stream tag
  (:func:`_pos_key`), and ragged rows by their row index too, through the
  port's threefry (``utils/prng.py``): the same key draws JAX's tokens.

The JAX loops are ``lax.while_loop``/``scan`` on the device; here they are
Python loops of eager calls that read the round's acceptance on the host
(one sync a round).

Over a mesh (``mesh``/``rules``) the target and the draft are laid out on
the same mesh under the same rules, every model call runs on each rank's
shards, and each call's logits come back whole on every rank
(``models/decoding.py::whole_logits``): acceptance, rollback and every draw
run on whole tensors, alike on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from learning_jax_sharding_tpu_torch import resolve_device
from learning_jax_sharding_tpu_torch.models.attention import row_update_masked
from learning_jax_sharding_tpu_torch.models.decoding import (
    check_sequence_budget,
    derive_decode_config,
    make_cached_apply,
    make_param_caster,
    whole_logits,
)
from learning_jax_sharding_tpu_torch.models.convert import shard_params
from learning_jax_sharding_tpu_torch.models.generate import filtered_logits, vocab_limit_filter
from learning_jax_sharding_tpu_torch.models.transformer import (
    DecodeCache,
    Transformer,
    TransformerConfig,
)
from learning_jax_sharding_tpu_torch.parallel.logical import activate
from learning_jax_sharding_tpu_torch.utils import prng


def _rollback(cache: DecodeCache, index) -> DecodeCache:
    """Rewind the decode counters (every layer's ``index`` and the
    ``position``) to ``index``, IN PLACE: a scalar, or a ``(B,)`` tensor on
    a ragged cache."""
    for counter in [layer.index for layer in cache.layers] + [cache.position]:
        counter.copy_(torch.as_tensor(index, device=counter.device).to(counter.dtype)
                      .expand(counter.shape))
    return cache


def emit_vector(drafts: torch.Tensor, m: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
    """``(B, num_draft + 1)`` emission rows: row b's accepted drafts below
    slot ``m_b``, its ``final`` token from slot ``m_b`` on (repeated past it:
    junk the caller masks or overwrites)."""
    padded = torch.nn.functional.pad(drafts, (0, 1))
    idx = torch.arange(drafts.shape[1] + 1, device=drafts.device)
    return torch.where(idx[None, :] < m[:, None], padded, final[:, None])


def greedy_accept_emit(drafts: torch.Tensor, choices: torch.Tensor):
    """Per-row greedy acceptance over a verified chunk, shared by the ragged
    generator and the engine's speculative rounds. ``drafts`` ``(B,
    num_draft)``, ``choices`` ``(B, num_draft + 1)`` target picks →
    ``(m, emitted, bonus)``: the accepted prefix length per row, the emission
    rows, and ``bonus[b] = choices[b, m_b]``."""
    eq = (drafts == choices[:, :-1]).to(torch.int32)
    m = torch.cumprod(eq, dim=1).sum(dim=1)
    bonus = choices.gather(1, m[:, None].long())[:, 0]
    return m.to(torch.int32), emit_vector(drafts, m, bonus), bonus


def rejection(drafts: torch.Tensor, q_all: torch.Tensor, p_all: torch.Tensor,
              u: torch.Tensor):
    """Per-row Leviathan acceptance over a verified chunk, shared by the
    generator and the engine's sampled rounds. Proposal ``x_j`` is accepted
    when ``u_j · q(x_j) < p(x_j)`` (strict: ``p == q`` always accepts, ``p
    == 0`` never does). ``drafts`` ``(B, num_draft)``, ``q_all`` the draft's
    ``(B, num_draft, V)`` distributions, ``p_all`` the target's ``(B,
    num_draft + 1, V)``, ``u`` ``(B, num_draft)`` → ``(m, residual)``: the
    accepted prefix length per row and, at every slot, the distribution a
    rejection there resamples from, ``norm(max(p − q, 0))`` (``p`` where it
    has no mass; past the proposals, with q taken as 0, the bonus ``p``)."""
    nd = drafts.shape[1]
    idx = drafts.long()[..., None]
    p_at = p_all[:, :nd].gather(-1, idx)[..., 0]
    q_at = q_all.gather(-1, idx)[..., 0]
    accept = (u * q_at < p_at).to(torch.int32)
    m = torch.cumprod(accept, dim=1).sum(dim=1)
    q_pad = torch.cat([q_all, torch.zeros_like(q_all[:, :1])], dim=1)
    residual = torch.clamp(p_all - q_pad, min=0.0)
    mass = residual.sum(dim=-1, keepdim=True)
    return m, torch.where(mass > 0, residual / mass, p_all)


def _greedy(logits: torch.Tensor, vocab_limit: int | None = None) -> torch.Tensor:
    """Argmax over the last axis in fp32 (ids ≥ ``vocab_limit`` masked) →
    int32."""
    logits = logits.float()
    if vocab_limit is not None:
        logits = vocab_limit_filter(logits, vocab_limit)
    return logits.argmax(dim=-1).to(torch.int32)


def _pos_key(rng: torch.Tensor, pos, tag: int) -> torch.Tensor:
    """Randomness keyed by ABSOLUTE generated position and a role tag (0 =
    draft proposal, 1 = acceptance uniform, 2 = residual/bonus sample): a
    rolled-back position re-derives the same draws."""
    return prng.fold_in(prng.fold_in(rng, pos), tag)


def make_speculative_generate_fn(
    target_config: TransformerConfig,
    draft_config: TransformerConfig,
    mesh=None,
    rules=None,
    *,
    max_new_tokens: int,
    num_draft: int = 4,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    min_p: float | None = None,
    vocab_limit: int | None = None,
    inference_dtype: torch.dtype | None = None,
    ragged: bool = False,
    device=None,
):
    """Build ``run(target_params, draft_params, prompt, rng=None,
    lengths=None, return_stats=False) -> tokens``.

    ``target_config``/``draft_config`` are training configs sharing a vocab;
    the decode variants are derived here. ``temperature == 0``: greedy
    verification, output equal to the target's greedy decode whatever the
    draft. ``temperature > 0``: speculative sampling, keyed by ``rng`` (an
    int seed or two-word key data; ``jax.random.key(0)``'s when None).
    ``top_k``/``top_p``/``min_p``/``vocab_limit`` shape the target's and the
    draft's distributions alike.

    ``ragged``: the prompt arrives right-padded with ``lengths`` ``(B,)``;
    every row keeps its own acceptance and rewind, rows sample from keys of
    (row, position, tag), and row b of the result is ``[prompt_b,
    generated..., 0-fill]`` with the generated span at ``lengths[b]``.
    ``return_stats`` (ragged only) also returns ``{"accepted", "rounds",
    "emitted"}``. Runs on ``cuda`` unless ``device`` says otherwise.

    ``mesh``/``rules``: the target and the draft run over the mesh, as
    ``make_generate_fn``'s mesh path runs one model; every rank calls
    ``run`` with the same arguments and returns the whole result."""
    if target_config.vocab_size != draft_config.vocab_size:
        raise ValueError(
            f"target vocab {target_config.vocab_size} != draft vocab "
            f"{draft_config.vocab_size}"
        )
    if num_draft < 1:
        raise ValueError(f"num_draft must be >= 1, got {num_draft}")
    if mesh is not None:
        if rules is None:
            raise ValueError("rules are required when a mesh is given")
        device = mesh.device_type if device is None else device
    device = resolve_device(device)
    t_cfg = derive_decode_config(target_config, inference_dtype)
    d_cfg = derive_decode_config(draft_config, inference_dtype)
    if ragged:
        t_cfg = dataclasses.replace(t_cfg, decode_ragged=True)
        d_cfg = dataclasses.replace(d_cfg, decode_ragged=True)
    target = Transformer(t_cfg, device=device).eval()
    draft = Transformer(d_cfg, device=device).eval()
    scope = (lambda: activate(mesh, rules)) if mesh is not None else contextlib.nullcontext

    def whole_apply(model):
        # One model call (under the mesh) → its logits whole, or at each
        # row's ``pick`` position; a draft prefill's, never read, stays put.
        apply = make_cached_apply(model)

        def call(cache, tokens, lengths=None, *, pick=None, read=True):
            with scope():
                logits, cache = apply(cache, tokens, lengths)
            return (whole_logits(logits, pick) if read else None), cache

        return call

    t_apply, d_apply = whole_apply(target), whole_apply(draft)
    maybe_cast = make_param_caster(inference_dtype, device)
    width = num_draft + 1
    buf_len = max_new_tokens + width

    def check_budget(prompt_len: int):
        # Verification writes up to num_draft + 1 positions past the
        # accepted prefix before rolling back: leave that headroom.
        need = prompt_len + max_new_tokens + width
        for name, cfg in (("target", t_cfg), ("draft", d_cfg)):
            check_sequence_budget(need, cfg.max_seq_len, f"prompt+new+draft for {name}")

    def to_flogits(logits):
        return filtered_logits(logits, temperature, top_k, top_p, min_p, vocab_limit)

    def to_probs(logits):
        return torch.softmax(to_flogits(logits), dim=-1)

    def propose(d_cache, prev, lengths, keys):
        """``num_draft`` draft proposals from ``prev``, then one more feed
        that puts the last one's K/V in the draft cache (so a full
        acceptance leaves it complete). ``keys(j)``: proposal j's keys when
        sampling. → ``(drafts (B, num_draft), q_all (B, num_draft, V) or
        None)``; ``lengths`` None or per-row (frozen rows keep ``prev``)."""
        drafts, q_all = [], []
        for j in range(num_draft):
            logits, d_cache = d_apply(d_cache, prev[:, None], lengths)
            if keys is None:
                nxt = _greedy(logits[:, -1], vocab_limit)
            else:
                fl = to_flogits(logits[:, -1])
                nxt = prng.categorical(keys(j), fl).to(torch.int32)
                q_all.append(torch.softmax(fl, dim=-1))
            prev = nxt if lengths is None else torch.where(lengths > 0, nxt, prev)
            drafts.append(prev)
        d_apply(d_cache, prev[:, None], lengths, read=False)
        return torch.stack(drafts, dim=1), (torch.stack(q_all, dim=1) if q_all else None)

    def generate(prompt, rng):
        """The rectangular loop: batch-min acceptance keeps one scalar cache
        index; rows that matched further re-derive the same tokens later
        (greedy choices, or position-keyed draws)."""
        sampled = temperature != 0.0
        b, prompt_len = prompt.shape
        last = torch.full((b,), prompt_len - 1, device=device)
        t_last, t_cache = t_apply(None, prompt, pick=last)
        _, d_cache = d_apply(None, prompt, read=False)
        if sampled:
            # Generated position 0 from the target's prefill distribution.
            t_cur = prng.categorical(_pos_key(rng, 0, 2), to_flogits(t_last))
        else:
            t_cur = _greedy(t_last, vocab_limit)
        t_cur = t_cur.to(torch.int32)
        buffer = torch.zeros((b, buf_len), dtype=torch.int32, device=device)
        buffer[:, 0] = t_cur
        rows = torch.arange(b, device=device)
        n = 1
        while n < max_new_tokens:
            # Both caches hold the prompt and the n - 1 accepted tokens
            # before t_cur, which this round feeds.
            base = prompt_len + n - 1
            keys = (lambda j: _pos_key(rng, n + j, 0)) if sampled else None
            drafts, q_all = propose(d_cache, t_cur, None, keys)
            chunk = torch.cat([t_cur[:, None], drafts], dim=1)
            t_logits, t_cache = t_apply(t_cache, chunk)
            if sampled:
                pos = n + torch.arange(num_draft, device=device)
                u = prng.uniform(_pos_key(rng, pos, 1), (b,)).T      # (B, num_draft)
                a_row, final = rejection(drafts, q_all, to_probs(t_logits), u)
                m = int(a_row.min())                                  # batch-min
                final = prng.categorical(_pos_key(rng, n + m, 2), torch.log(final[rows, m]))
            else:
                choices = _greedy(t_logits, vocab_limit)
                eq = (drafts == choices[:, :-1]).to(torch.int32)
                a_row = torch.cumprod(eq, dim=1).sum(dim=1)
                m = int(a_row.min())                                  # batch-min
                final = choices[:, m]
            # Rows that accepted past m emit their draft at slot m (greedy:
            # equal to the target's choice there).
            drafts_pad = torch.nn.functional.pad(drafts, (0, 1))
            token_m = torch.where(a_row > m, drafts_pad[:, m], final.to(torch.int32))
            buffer[:, n:n + width] = torch.cat(
                [drafts[:, :m], token_m[:, None].expand(b, width - m)], dim=1)
            _rollback(t_cache, base + 1 + m)
            _rollback(d_cache, base + 1 + m)
            n, t_cur = n + 1 + m, token_m
        return torch.cat([prompt, buffer[:, :max_new_tokens]], dim=1)

    def assemble_ragged(prompt, lengths, buffer):
        # Row b's generated span starts at its length; everything past it,
        # the caller's padding included, becomes 0-fill.
        b, prompt_len = prompt.shape
        total = prompt_len + max_new_tokens
        col = torch.arange(total, device=device)[None, :]
        padded = torch.nn.functional.pad(prompt, (0, max_new_tokens))
        out = torch.where(col < lengths[:, None], padded, 0).to(torch.int32)
        cols = lengths.long()[:, None] + torch.arange(max_new_tokens, device=device)
        return out.scatter_(1, cols, buffer[:, :max_new_tokens].contiguous())

    def row_keys(rng, pos, tag: int):
        """Keys of (row index, absolute position, tag): a row's stream is
        independent of the other rows, and a rewind re-derives its draws.
        ``pos`` is ``(B,)`` or ``(B, J)``."""
        rows = torch.arange(pos.shape[0], device=device).reshape(
            (-1,) + (1,) * (pos.ndim - 1))
        return _pos_key(prng.fold_in(rng, rows), pos, tag)

    def generate_ragged(prompt, lengths, rng):
        """Per-row speculative decode. Before a round each row's caches hold
        its prompt and ``n_b - 1`` accepted tokens; after accepting ``m_b``
        the rewind target is ``lengths_b + n_new_b - 1``, which for a
        frozen row is its current index, so one rollback serves all rows."""
        sampled = temperature != 0.0
        b, _ = prompt.shape
        first, t_cache = t_apply(None, prompt, lengths, pick=lengths - 1)
        _, d_cache = d_apply(None, prompt, lengths, read=False)
        rows = torch.arange(b, device=device)
        if sampled:
            zeros = torch.zeros((b,), dtype=torch.int64, device=device)
            t_cur = prng.categorical(row_keys(rng, zeros, 2), to_flogits(first))
        else:
            t_cur = _greedy(first, vocab_limit)
        t_cur = t_cur.to(torch.int32)
        buffer = torch.zeros((b, buf_len), dtype=torch.int32, device=device)
        buffer[:, 0] = t_cur
        n = torch.ones((b,), dtype=torch.int32, device=device)
        acc = torch.zeros((b,), dtype=torch.int32, device=device)
        rounds = 0
        while bool((n < max_new_tokens).any()):
            live = n < max_new_tokens
            live32 = live.to(torch.int32)
            keys = (lambda j: row_keys(rng, n + j, 0)) if sampled else None
            drafts, q_all = propose(d_cache, t_cur, live32, keys)
            chunk = torch.cat([t_cur[:, None], drafts], dim=1)
            t_logits, t_cache = t_apply(t_cache, chunk, live32 * width)
            if sampled:
                pos = n[:, None] + torch.arange(num_draft, device=device)
                u = prng.uniform(row_keys(rng, pos, 1))               # (B, num_draft)
                m, residual = rejection(drafts, q_all, to_probs(t_logits), u)
                m = m.to(torch.int32)
                final = prng.categorical(row_keys(rng, n + m, 2),
                                         torch.log(residual[rows, m.long()])).to(torch.int32)
                emitted = emit_vector(drafts, m, final)
            else:
                m, emitted, final = greedy_accept_emit(drafts, _greedy(t_logits, vocab_limit))
            row_update_masked(buffer, emitted, n, live32 * width, seq_dim=1)
            n = n + live32 * (1 + m)
            roll = lengths + n - 1
            _rollback(t_cache, roll)
            _rollback(d_cache, roll)
            t_cur = torch.where(live, final, t_cur)
            acc = acc + live32 * m
            rounds += 1
        stats = {"accepted": acc, "rounds": torch.tensor(rounds, dtype=torch.int32),
                 "emitted": n}
        return assemble_ragged(prompt, lengths, buffer), stats

    @torch.no_grad()
    def run(t_params: Any, d_params: Any, prompt, rng=None, lengths=None,
            return_stats: bool = False):
        if ragged and lengths is None:
            raise ValueError(
                "ragged=True: pass lengths (B,) — each row's true prompt "
                "length in the right-padded prompt batch"
            )
        if not ragged and lengths is not None:
            raise ValueError("lengths requires make_speculative_generate_fn(ragged=True)")
        if return_stats and not ragged:
            raise ValueError("return_stats requires ragged=True")
        prompt = torch.as_tensor(prompt, device=device).to(torch.int32)
        check_budget(prompt.shape[1])
        for model, params in ((target, t_params), (draft, d_params)):
            if mesh is not None:
                shard_params(model, mesh, rules, maybe_cast(params))
            else:
                model.load_state_dict(maybe_cast(params))
        key = prng.as_key(0 if rng is None else rng, device)
        if ragged:
            lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
            out, stats = generate_ragged(prompt, lengths, key)
            return (out, stats) if return_stats else out
        return generate(prompt, key)

    return run
