"""Synthetic LM token pipeline for the assigned architectures.

Generates Zipf-distributed token streams with a latent "topic" per sequence
(so sequence-level affinity graphs — the SSL integration of DESIGN.md §3 —
carry signal: sequences of the same topic are k-NN neighbours in
bag-of-tokens space), plus next-token training batches.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_token_corpus", "lm_batches", "sequence_features"]


def make_token_corpus(n_seqs: int, seq_len: int, vocab: int, *,
                      n_topics: int = 8, seed: int = 0):
    """Returns (tokens (n, T) int32, topic (n,) int)."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab + 1) ** 1.1          # Zipf backbone
    topics = rng.integers(0, n_topics, n_seqs)
    # Each topic boosts a random subset of the vocab.
    boost = np.ones((n_topics, vocab))
    for t in range(n_topics):
        idx = rng.choice(vocab, size=max(vocab // 20, 1), replace=False)
        boost[t, idx] *= 40.0
    toks = np.empty((n_seqs, seq_len), np.int32)
    for i in range(n_seqs):
        p = base * boost[topics[i]]
        p /= p.sum()
        toks[i] = rng.choice(vocab, size=seq_len, p=p)
    return toks, topics


def sequence_features(tokens: np.ndarray, vocab: int, *,
                      dim: int = 64, seed: int = 0) -> np.ndarray:
    """Bag-of-tokens features projected to ``dim`` — affinity-graph inputs."""
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(vocab, dim)) / np.sqrt(dim)
    n, T = tokens.shape
    feats = np.zeros((n, dim))
    for i in range(n):
        counts = np.bincount(tokens[i], minlength=vocab)
        feats[i] = counts @ proj / T
    return feats.astype(np.float32)


def lm_batches(tokens: np.ndarray, batch_size: int, *, seed: int = 0):
    """Yield (inputs, targets) next-token batches forever."""
    rng = np.random.default_rng(seed)
    n = tokens.shape[0]
    while True:
        order = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            b = tokens[order[s : s + batch_size]]
            yield b[:, :-1], b[:, 1:]
