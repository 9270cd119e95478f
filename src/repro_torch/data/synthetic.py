"""Deterministic synthetic LM data pipeline (a numpy copy of the
reference's ``data.synthetic``: the same batches, bit for bit).

Requirements at scale:
* exactly reproducible across restarts (the iterator state is a single int
  checkpointed with the model);
* host-shardable: every process can compute ITS slice of the global batch
  without coordination (pure function of (step, shard));
* structured enough for a loss to be learnable (the quickstart trains on it):
  a Markov stream parameterized by a fixed hash — not uniform noise.

Tokens: t_{i+1} = (a * t_i + h(block)) mod V with per-block drift — gives
learnable bigram structure with long-range block statistics.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataState:
    step: int = 0


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        """(tokens, labels) for this host's slice of global batch at step."""
        assert self.global_batch % num_shards == 0
        local = self.global_batch // num_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        a = 6364136223846793005 % self.vocab_size
        starts = rng.integers(0, self.vocab_size, size=(local, 1))
        drift = rng.integers(1, 97, size=(local, 1))
        idx = np.arange(self.seq_len + 1)
        toks = (starts + drift * idx + (a * idx * idx) // 7) % self.vocab_size
        toks = toks.astype(np.int32)
        return toks[:, :-1], toks[:, 1:]


def make_batch_iterator(ds: SyntheticLM, state: DataState,
                        shard: int = 0, num_shards: int = 1):
    """Stateful iterator resuming from ``state.step`` (checkpoint-friendly)."""
    while True:
        tokens, labels = ds.batch_at(state.step, shard, num_shards)
        state.step += 1
        yield {"tokens": tokens, "labels": labels}
