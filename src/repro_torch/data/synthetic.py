"""Synthetic, checkpointable data: the ``MarkovLM`` corpus, the
``SentimentTask`` proxy and calibration batches.

The token streams come from the same ``np.random.RandomState`` draws as
the JAX package's ``repro.data.synthetic``, so both packages see identical
batches for a seed; batches are returned as CPU torch tensors. A batch is
a pure function of (seed, step): ``state()`` / ``restore()`` carry the step
counter (a :class:`DataState`), which a trainer checkpoint stores so that
a restart resumes the stream where it stopped.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class DataState:
    seed: int
    step: int


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

    def state(self) -> DataState:
        return DataState(self.seed, self.step)

    def restore(self, st: DataState) -> None:
        if st.seed != self.seed:
            raise ValueError(f"data seed mismatch on restore: {st.seed} != "
                             f"{self.seed}")
        self.step = st.step


class SentimentTask:
    """The paper's downstream proxy: a 3-class marker-counting task. Each
    sequence carries markers of one class among noise tokens; the last two
    positions are the query token and the class's answer token, and the
    loss mask selects the answer slot alone."""

    def __init__(self, vocab_size: int, seed: int = 0):
        if vocab_size < 16:
            raise ValueError(f"vocab_size {vocab_size} < 16")
        self.vocab = vocab_size
        self.seed = seed
        self.step = 0
        self.markers = (1, 2, 3)
        self.answers = (4, 5, 6)
        self.query = 7

    def batch(self, batch_size: int, seq_len: int
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        rng = np.random.RandomState((self.seed * 9_999_991 + self.step)
                                    % (2 ** 31))
        self.step += 1
        toks = rng.randint(8, self.vocab, size=(batch_size, seq_len))
        labels = rng.randint(0, 3, size=batch_size)
        n_marks = max(2, seq_len // 6)
        for i in range(batch_size):
            pos = rng.choice(seq_len - 2, size=n_marks, replace=False)
            toks[i, pos] = self.markers[labels[i]]
            toks[i, -2] = self.query
            toks[i, -1] = self.answers[labels[i]]
        mask = np.zeros((batch_size, seq_len), np.float32)
        mask[:, -1] = 1.0
        return ({"tokens": torch.from_numpy(toks.astype(np.int64)),
                 "loss_mask": torch.from_numpy(mask)},
                torch.from_numpy(labels.astype(np.int64)))

    def accuracy(self, logits_last: torch.Tensor,
                 labels: torch.Tensor) -> float:
        """The share of rows whose largest logit among the three answer
        tokens (at the answer-predicting position) is the label's."""
        sub = logits_last[:, list(self.answers)]
        pred = sub.argmax(dim=-1).to(labels.device)
        return float((pred == labels).float().mean())

    def state(self) -> DataState:
        return DataState(self.seed, self.step)

    def restore(self, st: DataState) -> None:
        if st.seed != self.seed:
            raise ValueError(f"data seed mismatch on restore: {st.seed} != "
                             f"{self.seed}")
        self.step = st.step


def calibration_batches(source, n_batches: int, batch_size: int,
                        seq_len: int) -> List[Dict[str, torch.Tensor]]:
    """Materialize a fixed calibration set (host tensors)."""
    return [source.batch(batch_size, seq_len) for _ in range(n_batches)]
