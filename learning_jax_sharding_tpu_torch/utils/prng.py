"""The ``jax.random`` draws the serving engine makes, over threefry2x32.

A key is two 32-bit words, the key data of ``jax.random.key(seed)``
(``jax.random.key_data``), held as an int64 tensor of shape ``(..., 2)``:
leading dimensions are a batch of keys, as ``jax.vmap`` over keys gives.
The functions compute what JAX 0.9.0 computes with its defaults
(``jax_default_prng_impl="threefry2x32"``, ``jax_threefry_partitionable=
True``), so equal keys give equal bits: :func:`bits` and :func:`uniform`
are bit-equal to ``jax.random.bits`` / ``uniform``; :func:`gumbel` and
:func:`categorical` take a logarithm, which torch and XLA may round apart
by an ulp, so a categorical draw can differ only where two Gumbel-perturbed
scores tie to within that.

Everything is plain integer tensor work on the key's device, with no host
round trip. Torch's ``uint32`` has no add or shift on the CPU, so the words
ride in int64 masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data with JAX's default 32-bit
    integers: the seed is taken as an int32, so the words are ``(0, seed mod
    2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def as_key(rng, device=None) -> torch.Tensor:
    """An int seed, or key data (two words: a list, numpy array or tensor),
    as a key on ``device``."""
    if isinstance(rng, int):
        return key(rng, device)
    k = torch.as_tensor(rng, device=device)
    if k.shape[-1:] != (2,) or k.is_floating_point():
        raise ValueError(f"a key is an int seed or two uint32 words, got {tuple(k.shape)}")
    return k.to(torch.int64) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the word pairs ``(x1, x2)``
    under the key ``(k1, k2)``; every argument broadcasts."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x1 + ks[0]) & MASK
    y = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & MASK
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        y = (y + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, y


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``k`` and a 32-bit word, an
    int or an integer tensor whose shape broadcasts against ``k``'s batch
    dimensions (``jax.vmap(fold_in)``)."""
    if isinstance(data, int):
        # A host word stays a Python scalar: no copy to the device.
        d = data & MASK
        y1, y2 = threefry2x32(k[..., 0], k[..., 1], 0, d)
    else:
        d = data.to(torch.int64) & MASK
        y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32 values in int64): the hash of
    each element's row-major index under the key. A batch of keys ``(...,
    2)`` gives ``k.shape[:-1] + shape``, as ``jax.vmap`` does."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 2**32:
        raise NotImplementedError("more than 2**32 draws from one key")
    counts = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    lead = k.shape[:-1] + (1,) * len(shape)
    k1, k2 = k[..., 0].reshape(lead), k[..., 1].reshape(lead)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return y1 ^ y2


def uniform(k: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0, minus 1, scaled into ``[minval, maxval)``."""
    mant = (bits(k, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    # The bounds as float32 values, kept on the host (a float32 tensor's
    # arithmetic with a Python scalar rounds the scalar to float32).
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` (its default ``mode="low"``), float32."""
    return -torch.log(-torch.log(uniform(k, shape, _TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the argmax of the
    logits plus Gumbel noise → int64 ids of shape ``logits.shape[:-1]``. One
    key draws noise of the logits' whole shape; a batch of keys matching
    ``logits.shape[:-1]`` draws each row's own (``jax.vmap(categorical)``)."""
    if k.ndim == 1:
        noise = gumbel(k, logits.shape)
    else:
        if k.shape[:-1] != logits.shape[:-1]:
            raise ValueError(f"keys {tuple(k.shape)} do not match logits {tuple(logits.shape)}")
        noise = gumbel(k, logits.shape[-1:])
    return (noise + logits.float()).argmax(dim=-1)
