"""Synthetic TIMIT-like corpus (DESIGN.md §1.6).

TIMIT itself is license-gated, so we generate a corpus with the same
statistical skeleton the paper's method relies on: 351-d frame vectors
(cepstral-coefficient stand-ins) lying near a low-dimensional manifold where
class identity is locally smooth — exactly the manifold assumption that makes
graph-based SSL work.  Frames are drawn from per-class Gaussian mixtures in a
``manifold_dim``-dimensional latent space, embedded into 351-d by a random
linear map plus noise; 39 phone classes by default.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticCorpus", "make_corpus", "drop_labels"]


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    X: np.ndarray            # (n, input_dim) float32
    y: np.ndarray            # (n,) int labels (ground truth, all points)
    label_mask: np.ndarray   # (n,) bool — True where the label is visible
    n_classes: int

    @property
    def n(self) -> int:
        return self.X.shape[0]

    def label_ratio(self) -> float:
        return float(self.label_mask.mean())


def make_corpus(
    n: int = 20_000,
    *,
    n_classes: int = 39,
    input_dim: int = 351,
    manifold_dim: int = 12,
    structure: str = "filaments",   # "filaments" | "blobs"
    modes_per_class: int = 3,
    class_sep: float = 2.0,
    noise: float = 0.25,
    ambient_noise: float = 0.35,
    seed: int = 0,
) -> SyntheticCorpus:
    """``filaments``: each class is a smooth random 1-D curve in the latent
    space (random Fourier series).  This is the regime where graph-based SSL
    matters: a classifier trained on a handful of labels sees only a short
    arc of each filament, while the k-NN graph connects the whole curve —
    label propagation along the graph beats local generalization.  ``blobs``
    (per-class Gaussian mixtures) is kept as an easy control where plain
    supervised training already generalizes.
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    if structure == "filaments":
        K = 4  # Fourier components per class curve
        coef = rng.normal(size=(n_classes, K, manifold_dim)) * 2.0
        phase = rng.uniform(0, 2 * np.pi, size=(n_classes, K))
        freq = rng.uniform(0.5, 2.0, size=(n_classes, K))
        offset = rng.normal(size=(n_classes, manifold_dim)) * class_sep
        t = rng.uniform(0, 2 * np.pi, n)
        z = offset[y] + np.einsum(
            "nk,nkd->nd", np.sin(freq[y] * t[:, None] + phase[y]), coef[y])
        z += rng.normal(size=z.shape) * noise
    elif structure == "blobs":
        centers = rng.normal(size=(n_classes, modes_per_class, manifold_dim))
        centers *= class_sep * 2.0
        mode = rng.integers(0, modes_per_class, size=n)
        z = centers[y, mode] + rng.normal(size=(n, manifold_dim)) * noise
    else:
        raise ValueError(structure)
    # Embed into the ambient (cepstral) space with observation noise.
    A = rng.normal(size=(manifold_dim, input_dim)) / np.sqrt(manifold_dim)
    X = z @ A + rng.normal(size=(n, input_dim)) * ambient_noise
    X = (X - X.mean(0)) / (X.std(0) + 1e-8)
    return SyntheticCorpus(
        X=X.astype(np.float32), y=y.astype(np.int64),
        label_mask=np.ones(n, bool), n_classes=n_classes)


def drop_labels(corpus: SyntheticCorpus, ratio: float, *,
                seed: int = 0) -> SyntheticCorpus:
    """Keep a ``ratio`` fraction of labels (paper §3: 2%..100%), at least one
    per class so the supervised term never starves a class entirely."""
    rng = np.random.default_rng(seed)
    n = corpus.n
    mask = rng.random(n) < ratio
    for c in range(corpus.n_classes):
        cls = np.where(corpus.y == c)[0]
        if len(cls) and not mask[cls].any():
            mask[rng.choice(cls)] = True
    return dataclasses.replace(corpus, label_mask=mask)
