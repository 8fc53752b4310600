"""Deterministic, shardable token pipeline: the port's own copy of the
reference's ``repro/data/pipeline.py`` (plain numpy, so both packages give
the same tokens bit for bit).

Two sources:
  * ``SyntheticLM`` -- a seeded Markov-ish token stream (structure so the
    loss can actually drop: next token depends on the current token), used
    by the training loop, its tests and the card's training phase;
  * ``MemmapDataset`` -- flat binary token files (np.memmap), the
    production path.

Determinism + elasticity contract: batch ``i`` of a run is a pure function
of (seed, i, shard), so a restarted job resumes mid-stream by step counter
alone (the checkpoint stores only ``step``).  Each host slices the same
global batch by its shard index: ``rows`` gives a data shard its rows of
the global batch (the model ranks of one data shard take the same rows),
so a sharded run trains on the batch a one-device run takes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.9      # prob of following the Markov chain

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # a fixed random permutation chain: next = chain[cur] with prob p
        self.chain = rng.permutation(self.vocab)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> np.ndarray:
        """Tokens [global_batch/n_shards, seq_len+1] for (step, shard)."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        per = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        toks = np.empty((per, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, per)
        follow = rng.random((per, self.seq_len)) < self.structure
        noise = rng.integers(0, self.vocab, (per, self.seq_len))
        for t in range(self.seq_len):
            nxt = self.chain[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, noise[:, t])
        return toks.astype(np.int32)

    def rows(self, step: int, shard: int = 0, n_shards: int = 1
             ) -> np.ndarray:
        """Data shard ``shard``'s rows of the global batch ``step``:
        ``batch(step)[shard * per:(shard + 1) * per]``."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        per = self.global_batch // n_shards
        return self.batch(step)[shard * per:(shard + 1) * per]


@dataclasses.dataclass
class MemmapDataset:
    """Flat int32 token file; batches are deterministic strided windows."""
    path: str
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        self.tokens = np.memmap(self.path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.tokens) - 1) // self.seq_len

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> np.ndarray:
        per = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        idx = rng.integers(0, self.n_windows, per)
        out = np.empty((per, self.seq_len + 1), np.int32)
        for i, w in enumerate(idx):
            a = w * self.seq_len
            out[i] = self.tokens[a:a + self.seq_len + 1]
        return out


def write_token_file(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)
