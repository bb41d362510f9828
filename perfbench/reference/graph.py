"""Plain reference of the LM example's sequence graph, in float64 NumPy.

Bag-of-tokens features (each sequence's mean of a fixed Gaussian
projection of its tokens, the projection drawn from NumPy's generator
seeded 0 with std dim^-1/2), exact k-nearest neighbours by Euclidean
distance, the paper's weights w = exp(−‖xi − xj‖ / 2σ²) with σ the mean
distance to the k-th neighbour, symmetrised by the larger weight, zero
diagonal.
"""
from __future__ import annotations

import numpy as np


def features(tokens: np.ndarray, vocab: int, dim: int) -> np.ndarray:
    proj = np.random.default_rng(0).normal(size=(vocab, dim)) / np.sqrt(dim)
    return np.stack([proj[row].mean(axis=0) for row in tokens])


def affinity(tokens: np.ndarray, vocab: int, *, dim: int,
             k: int) -> np.ndarray:
    """Dense (n, n) affinity matrix of the sequences ``tokens`` (n, T)."""
    X = features(tokens, vocab, dim)
    n = len(X)
    d = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, axis=1, kind="stable")[:, :k]
    rows = np.repeat(np.arange(n), k)
    dist = d[rows, nn.ravel()]
    sigma = dist.reshape(n, k)[:, -1].mean() or 1.0
    W = np.zeros((n, n))
    W[rows, nn.ravel()] = np.exp(-dist / (2.0 * sigma * sigma))
    W = np.maximum(W, W.T)
    np.fill_diagonal(W, 0.0)
    return W
