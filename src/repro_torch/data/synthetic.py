"""``MarkovLM`` synthetic corpus and calibration batches.

The token streams come from the same ``np.random.RandomState`` draws as
the JAX package's ``repro.data.synthetic``, so both packages see identical
calibration data for a seed; batches are returned as torch tensors.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class MarkovLM:
    """A fixed random first-order Markov chain over the vocabulary."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 branching: int = 4, temperature: float = 1.0):
        self.vocab = vocab_size
        self.seed = seed
        self.step = 0
        rng = np.random.RandomState(seed)
        succ = rng.randint(0, vocab_size, size=(vocab_size, branching))
        logits = rng.randn(vocab_size, branching) / temperature
        probs = np.exp(logits)
        probs /= probs.sum(1, keepdims=True)
        self._succ = succ
        self._probs = probs

    def batch(self, batch_size: int, seq_len: int) -> Dict[str, torch.Tensor]:
        rng = np.random.RandomState((self.seed * 1_000_003 + self.step)
                                    % (2 ** 31))
        self.step += 1
        toks = np.empty((batch_size, seq_len), np.int32)
        cur = rng.randint(0, self.vocab, size=batch_size)
        toks[:, 0] = cur
        for t in range(1, seq_len):
            u = rng.rand(batch_size, 1)
            cdf = np.cumsum(self._probs[cur], axis=1)
            choice = (u > cdf).sum(1)
            cur = self._succ[cur, np.minimum(choice,
                                             self._succ.shape[1] - 1)]
            toks[:, t] = cur
        return {"tokens": torch.from_numpy(toks.astype(np.int64))}


def calibration_batches(source, n_batches: int, batch_size: int,
                        seq_len: int) -> List[Dict[str, torch.Tensor]]:
    """Materialize a fixed calibration set (host tensors)."""
    return [source.batch(batch_size, seq_len) for _ in range(n_batches)]
