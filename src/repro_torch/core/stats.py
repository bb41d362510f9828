"""Batch-quality statistics from the paper (Eq. 5, Figs. 1c/2a/2b).

Within-batch connectivity  c_j = Σ_i |C_i| / Σ_i |N_i|  over members i of
batch j (Eq. 5), and the label-entropy of a batch — the two opposing
qualities (connectivity vs. diversity) the meta-batch heuristic trades off.
Host-side numpy; consumed by the benchmarks that reproduce the figures.
"""
from __future__ import annotations

import numpy as np

from .affinity import AffinityGraph

__all__ = [
    "within_batch_connectivity",
    "batch_label_entropy",
    "connectivity_distribution",
    "entropy_distribution",
    "random_batches",
]


def within_batch_connectivity(graph: AffinityGraph, batch: np.ndarray) -> float:
    """Eq. 5: fraction of members' neighbours that fall inside the batch."""
    in_batch = np.zeros(graph.n_nodes, dtype=bool)
    in_batch[batch] = True
    indptr, indices = graph.W.indptr, graph.W.indices
    n_total = 0
    n_inside = 0
    for u in batch:
        s, e = indptr[u], indptr[u + 1]
        nbrs = indices[s:e]
        n_total += len(nbrs)
        n_inside += int(in_batch[nbrs].sum())
    return n_inside / max(n_total, 1)


def batch_label_entropy(labels: np.ndarray, batch: np.ndarray,
                        n_classes: int) -> float:
    """Shannon entropy (nats) of the label distribution within a batch."""
    counts = np.bincount(labels[batch], minlength=n_classes).astype(np.float64)
    p = counts / counts.sum()
    nz = p[p > 0]
    return float(-(nz * np.log(nz)).sum())


def connectivity_distribution(graph: AffinityGraph,
                              batches: list[np.ndarray]) -> np.ndarray:
    return np.array([within_batch_connectivity(graph, b) for b in batches])


def entropy_distribution(labels: np.ndarray, batches: list[np.ndarray],
                         n_classes: int) -> np.ndarray:
    return np.array([batch_label_entropy(labels, b, n_classes) for b in batches])


def random_batches(n: int, batch_size: int, *,
                   rng: np.random.Generator) -> list[np.ndarray]:
    """Randomly shuffled mini-batches (the paper's baseline batching)."""
    perm = rng.permutation(n)
    return [perm[s : s + batch_size] for s in range(0, n, batch_size)]
