"""The port's threefry draws (``utils/prng.py``) against ``jax.random``.

Keys, ``fold_in`` chains, ``bits`` and ``uniform`` must be BIT-EQUAL to JAX
0.9.0's (threefry2x32, partitionable) over many seeds and shapes, batched
keys included. ``gumbel`` takes two logarithms, which torch and XLA may
round apart: it must lie within 4e-6 of JAX's. ``categorical`` must give
JAX's token, except where the top two of JAX's own Gumbel-perturbed scores
lie within 1e-5 of each other (the near-tie rule); the tests count such
cases and require every differing draw to be one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu_torch.utils import prng

SEEDS = [0, 1, 5, 42, 1234, 2**31 - 1, 2**32 - 1, -1, -7, 2**33 + 5]
SHAPES = [(), (1,), (3,), (2, 5), (4, 257), (3, 2, 7)]
NEAR_TIE = 1e-5
TINY = float(jnp.finfo(jnp.float32).tiny)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data(seed):
    """``jax.random.key(seed)`` with JAX's default 32-bit integers."""
    np.testing.assert_array_equal(prng.key(seed).numpy(), _data(jax.random.key(seed)))
    np.testing.assert_array_equal(prng.as_key(_data(jax.random.key(seed))).numpy(),
                                  _data(jax.random.key(seed)))


@pytest.mark.parametrize("seed", range(8))
def test_fold_in_chains(seed):
    """Chains of up to six folds of random 32-bit words, ints and tensors."""
    rng = np.random.default_rng(seed)
    jk, tk = jax.random.key(seed), prng.key(seed)
    for depth in range(6):
        word = int(rng.integers(0, 2**32))
        jk = jax.random.fold_in(jk, word)
        tk = prng.fold_in(tk, word if depth % 2 else torch.tensor(word))
        np.testing.assert_array_equal(tk.numpy(), _data(jk), err_msg=f"depth {depth}")


def test_vmapped_fold_in():
    """A batch of keys from per-row words, as the engine folds request ids
    and positions (``jax.vmap`` over both), and a (B, J) grid of positions."""
    rid, pos = np.arange(6), np.array([0, 3, 9, 2, 41, 7])
    jk = jax.vmap(lambda r, p: jax.random.fold_in(jax.random.fold_in(jax.random.key(3), r), p))(
        rid, pos)
    tk = prng.fold_in(prng.fold_in(prng.key(3), torch.as_tensor(rid)), torch.as_tensor(pos))
    np.testing.assert_array_equal(tk.numpy(), _data(jk))
    grid = pos[:, None] + np.arange(4)
    jg = jax.vmap(jax.vmap(lambda r, p: jax.random.fold_in(
        jax.random.fold_in(jax.random.key(3), r), p), in_axes=(None, 0)))(rid, grid)
    tg = prng.fold_in(prng.fold_in(prng.key(3), torch.as_tensor(rid)[:, None]),
                      torch.as_tensor(grid))
    np.testing.assert_array_equal(tg.numpy(), _data(jg))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_equal(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(prng.bits(tk, shape).numpy(),
                                      np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
        for lo in (0.0, TINY):
            want = np.asarray(jax.random.uniform(jk, shape, minval=lo))
            got = prng.uniform(tk, shape, lo, 1.0).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_batched_keys_bits_and_uniform():
    """``jax.vmap(uniform)`` over a batch of keys, scalar and shaped draws."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(11), i))(jnp.arange(5))
    tk = prng.fold_in(prng.key(11), torch.arange(5))
    for shape in ((), (3,), (2, 9)):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
        np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(), want)
        want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(keys))
        np.testing.assert_array_equal(prng.bits(tk, shape).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_gumbel_within_tolerance(seed):
    shape = (4, 1000)
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), shape))
    got = prng.gumbel(prng.key(seed), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def _check_categorical(jkeys, tkeys, logits, vmapped):
    """Tokens of both sides → (draws, near-tie draws); every differing draw
    must be a near tie of JAX's perturbed scores."""
    lj = jnp.asarray(logits)
    if vmapped:
        want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, lj))
        noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, logits.shape[-1:]))(jkeys))
    else:
        want = np.asarray(jax.random.categorical(jkeys, lj))
        noise = np.asarray(jax.random.gumbel(jkeys, logits.shape))
    got = prng.categorical(tkeys, torch.from_numpy(logits)).numpy()
    scores = np.sort(noise + logits, axis=-1)
    near = (scores[..., -1] - scores[..., -2]) <= NEAR_TIE
    assert np.all((got == want) | near), "a differing draw that is no near tie"
    return got.size, int(near.sum())


@pytest.mark.parametrize("vocab", [16, 256, 50257])
def test_categorical_matches(vocab):
    """One key over a batch of rows, and one key a row (the engine's
    ``jax.vmap(categorical)``), over logits with ``-inf`` filtered entries."""
    rng = np.random.default_rng(vocab)
    draws = ties = 0
    for seed in range(6):
        logits = (rng.standard_normal((8, vocab)) * 3).astype(np.float32)
        logits[:, rng.integers(0, vocab, size=vocab // 4)] = -np.inf
        n, t = _check_categorical(jax.random.key(seed), prng.key(seed), logits, False)
        draws, ties = draws + n, ties + t
        rows = np.arange(8)
        jk = jax.vmap(lambda r: jax.random.fold_in(jax.random.key(seed), r))(rows)
        tk = prng.fold_in(prng.key(seed), torch.as_tensor(rows))
        n, t = _check_categorical(jk, tk, logits, True)
        draws, ties = draws + n, ties + t
    assert draws == 96 and ties <= 1
