"""Token datasets for LM training.

Port of ``learning_jax_sharding_tpu/data/datasets.py`` (numpy only; the port
keeps its own copy so that it imports nothing of the JAX package). Batch
``i`` is a pure function of ``(seed, i)`` through
``np.random.default_rng((seed, index))``, so the port and the JAX package
see the same tokens.

* :class:`SyntheticLMDataset`: deterministic random tokens, for tests and
  benchmarks; every process can slice the same virtual stream.
* :class:`MemmapTokenDataset`: a flat binary file of token ids,
  memory-mapped, so a process touches only the pages behind its batch rows
  (the packed "one long uint16/32 array" format; :func:`write_token_file`
  writes it).
* :class:`CyclicLMDataset`: a fully learnable stream (token i+1 = token
  i + 1 mod V) from seeded starts, for checking that training learns.

All yield ``{"inputs": (B, S), "targets": (B, S)}`` int32 numpy batches,
the targets the inputs shifted one position left: what
``models.transformer.next_token_loss`` expects.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    """Deterministic synthetic token stream: batch ``i`` is a pure function
    of ``(seed, i)``, so processes can load disjoint rows of one global
    batch without coordination."""

    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, index: int, rows: slice | None = None, batch_size: int = 8) -> dict:
        """Global batch ``index``; ``rows`` selects a process's row range."""
        rng = np.random.default_rng((self.seed, index))
        tokens = rng.integers(
            0, self.vocab_size, size=(batch_size, self.seq_len + 1), dtype=np.int64
        ).astype(np.int32)
        if rows is not None:
            tokens = tokens[rows]
        return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


@dataclasses.dataclass(frozen=True)
class CyclicLMDataset:
    """A fully learnable stream: row ``r`` of batch ``i`` counts up (mod
    ``vocab_size``) from a start drawn from ``(seed, i)``, so token i+1
    always follows token i and batch ``i`` is a pure function of its
    index. Two seeds give disjoint batches of the same rule (a held-out
    stream)."""

    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, index: int, rows: slice | None = None, batch_size: int = 8) -> dict:
        """Global batch ``index``; ``rows`` selects a process's row range."""
        rng = np.random.default_rng((self.seed, index))
        starts = rng.integers(0, self.vocab_size, size=batch_size)
        if rows is not None:
            starts = starts[rows]
        toks = (starts[:, None] + np.arange(self.seq_len + 1)[None]) % self.vocab_size
        toks = toks.astype(np.int32)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def write_token_file(path: str | Path, tokens: np.ndarray, dtype=np.uint16) -> Path:
    """Write a packed-token binary file (a flat array of ids)."""
    path = Path(path)
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be flat, got shape {tokens.shape}")
    if tokens.max(initial=0) >= np.iinfo(dtype).max:
        raise ValueError(f"token ids exceed {dtype} range")
    tokens.astype(dtype).tofile(path)
    return path


@dataclasses.dataclass
class MemmapTokenDataset:
    """Memory-mapped packed-token file: random-access (B, S+1) windows.

    Sample ``j`` of batch ``i`` reads the ``seq_len + 1`` tokens at a
    position drawn from ``(seed, i)``; only the touched pages are read."""

    path: str | Path
    seq_len: int
    dtype: type = np.uint16
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        if len(self._data) < self.seq_len + 1:
            raise ValueError(
                f"token file has {len(self._data)} tokens, need at least "
                f"seq_len + 1 = {self.seq_len + 1}"
            )

    def __len__(self) -> int:
        return len(self._data)

    def batch(self, index: int, rows: slice | None = None, batch_size: int = 8) -> dict:
        rng = np.random.default_rng((self.seed, index))
        starts = rng.integers(0, len(self._data) - self.seq_len, size=batch_size)
        if rows is not None:
            starts = starts[rows]
        windows = np.stack(
            [np.asarray(self._data[s : s + self.seq_len + 1]) for s in starts]
        ).astype(np.int32)
        return {"inputs": windows[:, :-1], "targets": windows[:, 1:]}
