"""Deterministic, shardable token pipeline, in numpy.

Each host process draws only its slice of the global batch, derived from
``(step, host_index)``: restart-safe (the stream is a pure function of
the step, so checkpoint/restart never replays or skips data) and
elastic-safe (re-slicing by the new host count is a pure re-index).
Batches are int32 numpy arrays, the JAX package's bit for bit; the
training driver moves each one to its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticCorpus", "TokenStream"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticCorpus:
    """Zipf-distributed synthetic tokens (stable across restarts)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._cdf = np.cumsum(probs / probs.sum())

    def batch(self, step: int, host_index: int = 0, n_hosts: int = 1):
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{n_hosts} hosts")
        per_host = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_index])
        )
        u = rng.random((per_host, cfg.seq_len))
        tokens = np.searchsorted(self._cdf, u).astype(np.int32)
        return {"tokens": np.clip(tokens, 0, cfg.vocab_size - 1)}


class TokenStream:
    """Chunk a fixed token array into training batches (KB corpus path)."""

    def __init__(self, tokens: np.ndarray, cfg: DataConfig):
        self.tokens = np.asarray(tokens, dtype=np.int32)
        self.cfg = cfg
        n = cfg.seq_len * cfg.global_batch
        if self.tokens.shape[0] < n:
            reps = -(-n // self.tokens.shape[0])
            self.tokens = np.tile(self.tokens, reps)
        self.n_batches = self.tokens.shape[0] // n

    def batch(self, step: int, host_index: int = 0, n_hosts: int = 1):
        cfg = self.cfg
        per_host = cfg.global_batch // n_hosts
        n = cfg.seq_len * cfg.global_batch
        base = (step % max(self.n_batches, 1)) * n
        start = base + host_index * per_host * cfg.seq_len
        chunk = self.tokens[start : start + per_host * cfg.seq_len]
        return {"tokens": chunk.reshape(per_host, cfg.seq_len)}
