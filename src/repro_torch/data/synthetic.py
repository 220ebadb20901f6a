"""Synthetic data pipeline.

A copy of ``repro.data.synthetic`` (numpy only): the port imports
nothing of the reference package.

The paper evaluates on Enwik8 / CCnews / Wmt19 / Lambada, none of which are
available offline. We substitute a deterministic Zipf-distributed token
stream with local n-gram correlations: token frequencies follow a Zipf law
(like natural text, which is what makes expert popularity skewed in the
first place), and a first-order Markov blend makes neighbouring tokens
correlated (so attention IDs carry signal, as in real text). EXPERIMENTS.md
documents this substitution.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def zipf_token_stream(vocab_size: int, length: int, *, alpha: float = 1.1,
                      seed: int = 0, markov_blend: float = 0.35) -> np.ndarray:
    """Deterministic Zipfian token stream with Markov locality."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=length, p=probs)
    # Markov blend: with prob markov_blend, repeat a recent token (locality)
    out = base.copy()
    reuse = rng.random(length) < markov_blend
    lag = rng.integers(1, 8, size=length)
    for i in range(1, length):
        if reuse[i]:
            out[i] = out[max(0, i - lag[i])]
    return out.astype(np.int32)


@dataclass
class SyntheticCorpus:
    """Sharded batch iterator over a synthetic stream (the data pipeline)."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    alpha: float = 1.1

    def batches(self, num_batches: int, *,
                start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        need = (start + num_batches) * self.batch_size * (self.seq_len + 1)
        stream = zipf_token_stream(self.vocab_size, need, alpha=self.alpha,
                                   seed=self.seed)
        per = self.batch_size * (self.seq_len + 1)
        for b in range(start, start + num_batches):
            chunk = stream[b * per:(b + 1) * per].reshape(
                self.batch_size, self.seq_len + 1)
            yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


def make_batch(vocab_size: int, batch: int, seq: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    it = SyntheticCorpus(vocab_size, seq, batch, seed=seed).batches(1)
    return next(it)
