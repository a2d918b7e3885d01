"""The port's speculative generator (``models/speculative.py``) against the
JAX package's, and against plain greedy decoding.

Same weights (``CONFIG_TINY`` in fp32 as the target, a 1-layer draft of its
own init, both JAX inits carried across by ``from_flax_params``), same
prompts. Greedy output must EQUAL the JAX generator's and the port's plain
greedy ``make_generate_fn``'s, for any draft and ``num_draft`` 1 to 4,
rectangular and ragged, dense and blocked, with the int8 cache; the ragged
per-row stats must equal JAX's. Sampled output at the same key must equal
JAX's (the near-tie rule of ``test_torch_prng``: a draw may differ only
where two Gumbel-perturbed scores lie within about 1e-5, which these draws
never meet), and its two-token joint must match the target's exact
filtered joint in total variation, as the JAX tests hold theirs. The JAX
generator runs on a one-device mesh.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import speculative as jax_spec
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn, top_k_filter
from learning_jax_sharding_tpu_torch.models.speculative import make_speculative_generate_fn
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY, Transformer
from tests._torch_jax import quick_jax_compiles  # noqa: F401

torch.set_num_threads(1)

JAX_F32 = dataclasses.replace(JAX_TINY, dtype=jnp.float32)
JAX_DRAFT = dataclasses.replace(JAX_F32, num_layers=1, hidden=64)
DRAFT = dataclasses.replace(CONFIG_TINY, num_layers=1, hidden=64)
LENGTHS = np.array([8, 5, 3, 7], np.int32)


@functools.cache
def _setup():
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, CONFIG_TINY.vocab_size, size=(6, 8)).astype(np.int32)

    def init(cfg, seed):
        p = JaxTransformer(cfg).init(jax.random.key(seed), jnp.asarray(prompt[:2]))["params"]
        return jax.tree.map(np.asarray, nn.meta.unbox(p))

    return prompt, init(JAX_F32, 0), init(JAX_DRAFT, 7)


def _ragged_prompt():
    prompt = _setup()[0][:4].copy()
    for b, n in enumerate(LENGTHS):
        prompt[b, n:] = 0
    return prompt


def _mods(backend, kv_int8, jax_side):
    mods = dict(decode_attention=backend, decode_block_k=16)
    if kv_int8:
        mods["kv_cache_dtype"] = jnp.int8 if jax_side else torch.int8
    return mods


def _port(draft="weak", backend="dense", kv_int8=False, **kw):
    """The port's generator and its (target, draft) state dicts."""
    _, tp, dp = _setup()
    mods = _mods(backend, kv_int8, False)
    cfg = dataclasses.replace(CONFIG_TINY, **mods)
    dcfg = dataclasses.replace(CONFIG_TINY if draft == "self" else DRAFT, **mods)
    gen = make_speculative_generate_fn(cfg, dcfg, device="cpu", **kw)
    t = from_flax_params(tp, CONFIG_TINY)
    d = t if draft == "self" else from_flax_params(dp, DRAFT)
    return gen, t, d


@functools.cache
def _jax_out(prompt_name, draft="weak", backend="dense", kv_int8=False, rng=None, **kw):
    """The JAX generator's tokens (and ragged stats) on one of the test prompts."""
    _, tp, dp = _setup()
    mods = _mods(backend, kv_int8, True)
    cfg = dataclasses.replace(JAX_F32, **mods)
    dcfg = dataclasses.replace(JAX_F32 if draft == "self" else JAX_DRAFT, **mods)
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    gen = jax_spec.make_speculative_generate_fn(cfg, dcfg, mesh, RULES_DP_TP, **kw)
    prompt = _ragged_prompt() if prompt_name == "ragged" else _setup()[0][:4]
    key = None if rng is None else jax.random.key(rng)
    if kw.get("ragged"):
        out, stats = gen(tp, tp if draft == "self" else dp, jnp.asarray(prompt), key,
                         lengths=LENGTHS, return_stats=True)
        return np.asarray(out), {k: np.asarray(v) for k, v in stats.items()}
    return np.asarray(gen(tp, tp if draft == "self" else dp, jnp.asarray(prompt), key)), None


def _plain(backend="dense", kv_int8=False, ragged=False, new=10):
    """The port's plain greedy decode of the target on the same prompt."""
    cfg = dataclasses.replace(CONFIG_TINY, **_mods(backend, kv_int8, False))
    gen = make_generate_fn(cfg, max_new_tokens=new, device="cpu", ragged=ragged)
    t = from_flax_params(_setup()[1], CONFIG_TINY)
    if ragged:
        return gen(t, _ragged_prompt(), lengths=LENGTHS).numpy()
    return gen(t, _setup()[0][:4]).numpy()


@pytest.mark.parametrize("num_draft", [1, 2, 3, 4])
def test_greedy_matches_jax_and_plain(num_draft):
    kw = dict(max_new_tokens=10, num_draft=num_draft)
    gen, t, d = _port(**kw)
    got = gen(t, d, _setup()[0][:4]).numpy()
    np.testing.assert_array_equal(got, _jax_out("rect", **kw)[0])
    np.testing.assert_array_equal(got, _plain())


def test_self_draft_full_acceptance():
    gen, t, d = _port(draft="self", max_new_tokens=10, num_draft=4)
    np.testing.assert_array_equal(gen(t, d, _setup()[0][:4]).numpy(), _plain())


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf_cache", "int8_cache"])
def test_blocked_backend(kv_int8):
    """Rollback over the blocked ``(B, N_kv, L, H)`` cache, int8 scales
    rewound with the values: JAX's tokens and plain greedy on the same
    backend."""
    kw = dict(max_new_tokens=10, num_draft=2, backend="blocked", kv_int8=kv_int8)
    gen, t, d = _port(**kw)
    got = gen(t, d, _setup()[0][:4]).numpy()
    np.testing.assert_array_equal(got, _jax_out("rect", **kw)[0])
    np.testing.assert_array_equal(got, _plain("blocked", kv_int8))


def test_batch_rows_decode_independently():
    gen, t, d = _port(max_new_tokens=10, num_draft=3)
    full = gen(t, d, _setup()[0][:4]).numpy()
    halves = [gen(t, d, _setup()[0][i:i + 2]).numpy() for i in (0, 2)]
    np.testing.assert_array_equal(full, np.concatenate(halves))


@pytest.mark.parametrize("num_draft,backend", [(1, "dense"), (2, "blocked"), (3, "dense"),
                                               (4, "dense")])
def test_ragged_matches_jax_and_plain(num_draft, backend):
    """Per-row acceptance and rewind: tokens and per-row stats equal JAX's,
    tokens equal plain ragged greedy."""
    kw = dict(max_new_tokens=10, num_draft=num_draft, ragged=True, backend=backend)
    gen, t, d = _port(**kw)
    got, stats = gen(t, d, _ragged_prompt(), lengths=LENGTHS, return_stats=True)
    want, want_stats = _jax_out("ragged", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert {k: v.numpy().tolist() for k, v in stats.items()} == {
        k: v.tolist() for k, v in want_stats.items()}
    np.testing.assert_array_equal(got.numpy(), _plain(backend, ragged=True))


def test_ragged_self_draft_stats():
    """Draft == target: every row accepts every proposal, so rounds =
    ceil((new - 1) / (num_draft + 1)), accepted = rounds · num_draft and
    emitted = 1 + rounds · (num_draft + 1), per row."""
    new, nd = 12, 3
    gen, t, d = _port(draft="self", max_new_tokens=new, num_draft=nd, ragged=True)
    _, stats = gen(t, d, _ragged_prompt(), lengths=LENGTHS, return_stats=True)
    rounds = -(-(new - 1) // (nd + 1))
    assert stats["accepted"].tolist() == [rounds * nd] * 4
    assert int(stats["rounds"]) == rounds
    assert stats["emitted"].tolist() == [1 + rounds * (nd + 1)] * 4


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "sampled"])
def test_ragged_rows_independent(temperature):
    """A row's output does not depend on the other rows' prompts, greedy
    or sampled ((row, position)-keyed draws)."""
    gen, t, d = _port(max_new_tokens=10, num_draft=3, ragged=True, temperature=temperature,
                      top_k=16 if temperature else None)
    prompt = _ragged_prompt()
    other = prompt.copy()
    other[0] = _setup()[0][5]
    a = gen(t, d, prompt, rng=11, lengths=LENGTHS).numpy()
    b = gen(t, d, other, rng=11, lengths=LENGTHS).numpy()
    np.testing.assert_array_equal(a[1:], b[1:])


@pytest.mark.parametrize("ragged", [False, True], ids=["rect", "ragged"])
def test_sampled_matches_jax(ragged):
    """Leviathan rejection at equal keys: JAX's tokens (and ragged stats);
    the same key again reproduces them, another key does not."""
    kw = dict(max_new_tokens=10, num_draft=3, temperature=1.0, top_k=16, ragged=ragged)
    gen, t, d = _port(**kw)
    prompt, args = (_ragged_prompt(), dict(lengths=LENGTHS)) if ragged else (_setup()[0][:4], {})
    want, want_stats = _jax_out("ragged" if ragged else "rect", rng=11, **kw)
    got = gen(t, d, prompt, rng=11, return_stats=ragged, **args)
    if ragged:
        got, stats = got
        assert {k: v.numpy().tolist() for k, v in stats.items()} == {
            k: v.tolist() for k, v in want_stats.items()}
    np.testing.assert_array_equal(got.numpy(), want)
    again = gen(t, d, prompt, rng=[0, 11], **args)
    np.testing.assert_array_equal(again.numpy(), want)
    assert (gen(t, d, prompt, rng=12, **args).numpy() != want).any()


@pytest.mark.parametrize("ragged", [False, True], ids=["rect", "ragged"])
def test_sampled_joint_matches_target_distribution(ragged):
    """4096 identical rows are 4096 two-token samples; their empirical joint
    must match the target's exact top-4 joint (from full forwards) in total
    variation below 0.1, the JAX tests' bound. The 1-layer draft keeps
    acceptance partial, so the accept, residual and bonus paths all
    contribute."""
    b = 4096
    gen, t, d = _port(max_new_tokens=2, num_draft=2, temperature=1.0, top_k=4, ragged=ragged)
    row = _setup()[0][:1]
    args = dict(lengths=np.full((b,), 8, np.int32)) if ragged else {}
    out = gen(t, d, np.repeat(row, b, axis=0), rng=17, **args).numpy()
    pairs = out[:, 8:10]

    model = Transformer(CONFIG_TINY, device="cpu").eval()
    model.load_state_dict(t)

    def probs(tokens):
        with torch.no_grad():
            logits = model(torch.as_tensor(tokens))[:, -1].float()
        return torch.softmax(top_k_filter(logits, 4), dim=-1).numpy().astype(np.float64)

    v = CONFIG_TINY.vocab_size
    p0 = probs(row)[0]
    exact = np.zeros((v, v))
    for t0 in np.nonzero(p0)[0]:
        exact[t0] = p0[t0] * probs(np.concatenate([row, [[t0]]], axis=1))[0]
    emp = np.zeros((v, v))
    np.add.at(emp, (pairs[:, 0], pairs[:, 1]), 1.0 / b)
    assert (emp[exact == 0] == 0).all()
    tv = 0.5 * np.abs(emp - exact).sum()
    assert tv < 0.1, f"total variation {tv:.3f}"


def test_validation():
    """JAX's checks, with its words."""
    with pytest.raises(ValueError, match="vocab"):
        make_speculative_generate_fn(CONFIG_TINY, dataclasses.replace(DRAFT, vocab_size=128),
                                     max_new_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="num_draft"):
        make_speculative_generate_fn(CONFIG_TINY, DRAFT, max_new_tokens=4, num_draft=0,
                                     device="cpu")
    with pytest.raises(ValueError, match="rules are required when a mesh is given"):
        make_speculative_generate_fn(CONFIG_TINY, DRAFT, object(), None, max_new_tokens=4,
                                     device="cpu")
    gen, t, d = _port(max_new_tokens=CONFIG_TINY.max_seq_len, num_draft=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        gen(t, d, _setup()[0][:2])
    ragged, t, d = _port(max_new_tokens=4, ragged=True)
    with pytest.raises(ValueError, match="lengths"):
        ragged(t, d, _setup()[0][:4])
    rect, t, d = _port(max_new_tokens=4)
    with pytest.raises(ValueError, match="lengths"):
        rect(t, d, _setup()[0][:4], lengths=np.full((4,), 8))
    with pytest.raises(ValueError, match="return_stats"):
        rect(t, d, _setup()[0][:4], return_stats=True)
