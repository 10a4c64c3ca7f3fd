"""Deterministic token source for the LM examples (port of
``repro.data.pipeline.TokenPipeline``, numpy only).

A reproducible synthetic corpus: a Markov chain over ``order_states``
hidden states, each emitting from its own permutation of a Zipfian
distribution over the vocabulary. The same seed gives the reference's
tokens. ``lm_batches`` comes with the training slice.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    """Zipfian Markov-chain corpus."""

    def __init__(self, vocab_size: int, seed: int = 0, order_states: int = 64):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self.n_states = order_states
        # each state emits from its own permutation of one Zipf law
        ranks = np.arange(1, vocab_size + 1)
        base = 1.0 / ranks ** 1.1
        self.emit = np.empty((order_states, vocab_size))
        for s in range(order_states):
            perm = rng.permutation(vocab_size)
            self.emit[s] = base[perm]
            self.emit[s] /= self.emit[s].sum()
        self.trans = rng.dirichlet(np.full(order_states, 0.3),
                                   size=order_states)
        self._rng = np.random.default_rng(seed + 1)
        self._state = 0

    def sample(self, n_tokens: int) -> np.ndarray:
        out = np.empty(n_tokens, np.int32)
        s = self._state
        for i in range(n_tokens):
            out[i] = self._rng.choice(self.vocab, p=self.emit[s])
            s = self._rng.choice(self.n_states, p=self.trans[s])
        self._state = s
        return out
