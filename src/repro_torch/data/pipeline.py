"""Batching pipelines: image batches for the FL study, token batches for
the transformer substrate (a synthetic LM task with learnable structure).

The port's own copy of `repro.data.pipeline`, numpy only: the same
`np.random.default_rng` draws in the same order, so one seed gives the
reference's batches bit for bit. Tokens and labels are int32 numpy
arrays, as there; `launch.train.train_loop` moves them to the device as
int64.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def image_batches(x: np.ndarray, y: np.ndarray, batch_size: int, *,
                  seed=0, epochs=1, drop_remainder=True
                  ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = len(x)
    for _ in range(epochs):
        order = rng.permutation(n)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, stop, batch_size):
            sel = order[i:i + batch_size]
            yield {"image": x[sel], "label": y[sel]}


class MarkovLM:
    """Synthetic language-model task: an order-1 Markov chain over the
    vocabulary with a sparse, sharply peaked transition matrix. A model
    that learns the transitions reaches a loss well below uniform, so
    training curves mean something."""

    def __init__(self, vocab_size: int, branching=4, seed=0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.next_tokens = rng.integers(
            0, vocab_size, size=(vocab_size, branching))
        self.probs = rng.dirichlet([2.0] * branching, size=vocab_size)

    def sample(self, rng, batch, seq_len):
        toks = np.empty((batch, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(1, seq_len):
            prev = toks[:, t - 1]
            toks[:, t] = np.array(
                [rng.choice(self.next_tokens[p], p=self.probs[p])
                 for p in prev])
        return toks

    def batches(self, batch, seq_len, steps, seed=0):
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            toks = self.sample(rng, batch, seq_len)
            labels = np.concatenate(
                [toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
            yield {"tokens": toks, "labels": labels}
