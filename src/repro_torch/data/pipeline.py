"""Sharded data pipeline (a numpy-only copy of the JAX package's
``data/pipeline.py``: the same seed gives the same batches there and here).

Two sources behind one interface:

* ``SyntheticBigramSource`` — tokens drawn from a fixed random bigram
  chain.  The distribution has ~``entropy_bits`` of conditional entropy,
  so a trained LM's loss has a KNOWN floor: examples/tests can assert
  convergence toward it (cross-entropy -> H(next|prev)) rather than just
  "loss went down".
* ``FileTokenSource`` — memory-mapped flat token file (uint16/uint32),
  the production path.

Sharding: each data-parallel rank reads its own disjoint slice — the
pipeline takes (shard_id, num_shards) exactly like a tf.data shard, and
batches are emitted host-side as numpy; the trainer moves them to its
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticBigramSource:
    """next ~ Cat(T[prev]) with a sparse random transition table."""

    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 4):
        self.vocab_size = vocab_size
        self.branching = branching
        rng = np.random.default_rng(seed)
        # each token can be followed by `branching` successors, skewed probs
        self.succ = rng.integers(0, vocab_size, (vocab_size, branching))
        raw = rng.exponential(1.0, (vocab_size, branching))
        self.probs = raw / raw.sum(-1, keepdims=True)

    @property
    def entropy_bits(self) -> float:
        p = self.probs
        return float(-(p * np.log2(p)).sum(-1).mean())

    @property
    def entropy_nats(self) -> float:
        p = self.probs
        return float(-(p * np.log(p)).sum(-1).mean())

    def sample(self, rng: np.random.Generator, batch: int,
               seq: int) -> np.ndarray:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, batch)
        for t in range(seq):
            prev = toks[:, t]
            choice = np.array(
                [rng.choice(self.branching, p=self.probs[p]) for p in prev]
            ) if batch <= 64 else self._vectorized_choice(rng, prev)
            toks[:, t + 1] = self.succ[prev, choice]
        return toks

    def _vectorized_choice(self, rng, prev):
        u = rng.random(prev.shape[0])
        cdf = np.cumsum(self.probs[prev], -1)
        return (u[:, None] < cdf).argmax(-1)


class FileTokenSource:
    """Flat binary token file; slices are drawn at random offsets."""

    def __init__(self, path: str, vocab_size: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size

    def sample(self, rng: np.random.Generator, batch: int,
               seq: int) -> np.ndarray:
        hi = len(self.tokens) - seq - 1
        starts = rng.integers(0, hi, batch)
        return np.stack([self.tokens[s:s + seq + 1] for s in starts]
                        ).astype(np.int32)


@dataclasses.dataclass
class DataPipeline:
    source: object
    batch: int          # per-shard batch
    seq: int
    shard_id: int = 0
    num_shards: int = 1
    seed: int = 0

    def __post_init__(self):
        # disjoint per-shard streams: distinct substream per shard
        self.rng = np.random.default_rng(
            np.random.SeedSequence(self.seed).spawn(self.num_shards)
            [self.shard_id])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            toks = self.source.sample(self.rng, self.batch, self.seq)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, n: int):
        it = iter(self)
        for _ in range(n):
            yield next(it)


def make_pipeline(vocab_size: int, batch: int, seq: int, *,
                  path: Optional[str] = None, shard_id: int = 0,
                  num_shards: int = 1, seed: int = 0) -> DataPipeline:
    src = (FileTokenSource(path, vocab_size) if path
           else SyntheticBigramSource(vocab_size, seed))
    return DataPipeline(src, batch, seq, shard_id, num_shards, seed)
