"""Embedding-space affinity refresh: the graph half of online refresh.

Bai et al. (1511.06104) build the k-NN graph *online* from the evolving
network's embeddings.  This module holds the part of that loop that builds
and compares graphs: :func:`embedding_knn_graph` re-runs the streaming
top-k over an embedding matrix (host numpy, or the kernel K8 on a device —
never a dense N×N) and rebuilds the RBF weights with a self-tuning
bandwidth (global sigma, or Zelnik-Manor per-node scaling — the
learned-bandwidth option of Sharma & Jones 2306.07098);
:func:`edge_churn` measures how far the topology moved.  The manager that
captures embeddings during training and swaps the graph into the stream
is not part of the port yet (``Experiment`` refuses ``online.active``).

Determinism: a graph is a pure function of (embeddings, config): the
top-k, the bandwidth heuristic and the CSR assembly derive from those
alone, and K8 uses no atomics.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from repro_torch.core.affinity import AffinityGraph, knn_edges

__all__ = [
    "embedding_topk_device",
    "embedding_knn_graph",
    "edge_set",
    "edge_churn",
]


def embedding_topk_device(E, k: int):
    """Streaming top-k of the embedding tensor ``E`` (N, D) against itself
    through K8 (its plain version for a CPU tensor): ``(d2, idx)``, (N, k),
    self excluded — the running top-k lives in shared memory, no dense
    (N, N) intermediate exists."""
    from repro_torch.kernels.pairwise import knn_topk
    return knn_topk(E, E, k, exclude_self=True)


def embedding_knn_graph(
    E: np.ndarray,
    *,
    k: int = 10,
    backend: str = "host",
    bandwidth: str = "global",
    block: int = 2048,
    col_block: int = 4096,
    device="cuda",
) -> AffinityGraph:
    """Symmetrized RBF k-NN graph over an embedding matrix.

    Same streaming construction as :func:`repro_torch.core.affinity.
    build_affinity_graph` (f32 distances, never a dense N×N; ``device`` is
    read by ``backend="device"`` only), with the bandwidth selectable:

    * ``"global"``   — one self-tuning sigma (mean k-th-neighbour
      distance), the paper's kernel;
    * ``"per_node"`` — Zelnik-Manor local scaling
      ``w_ij = exp(-d_ij / (2 σ_i σ_j))`` with ``σ_i`` = node i's k-th-NN
      distance: each node's bandwidth adapts to its local embedding
      density (the learned-bandwidth option, Sharma & Jones 2306.07098).
      The recorded ``graph.sigma`` is still the global mean, so inserts
      against a per-node graph stay well-defined.
    """
    if bandwidth not in ("global", "per_node"):
        raise ValueError(
            f"bandwidth must be 'global' or 'per_node', got {bandwidth!r}")
    E = np.asarray(E, dtype=np.float32)
    n = E.shape[0]
    src, dst, d2 = knn_edges(E, k, block=block, col_block=col_block,
                             backend=backend, device=device)
    dist = np.sqrt(d2)
    kth = dist.reshape(n, -1)[:, -1]
    sigma = float(np.mean(kth)) or 1.0
    if bandwidth == "global":
        w = np.exp(-dist / (2.0 * sigma * sigma))
    else:
        sig = np.maximum(kth, 1e-12)
        w = np.exp(-dist / (2.0 * sig[src] * sig[dst]))
    W = sp.csr_matrix((w, (src, dst)), shape=(n, n))
    W = W.maximum(W.T).tocsr()
    W.setdiag(0.0)
    W.eliminate_zeros()
    W.sort_indices()
    return AffinityGraph(W=W, k=min(k, n - 1), sigma=sigma)


def edge_set(graph: AffinityGraph) -> set[tuple[int, int]]:
    """The undirected edge set {(i, j) : i < j, w_ij > 0}."""
    coo = sp.triu(graph.W, k=1).tocoo()
    return set(zip(coo.row.tolist(), coo.col.tolist()))


def edge_churn(old: AffinityGraph, new: AffinityGraph) -> float:
    """Topology churn: |symmetric difference| / |union| of the undirected
    edge sets (0 = identical topology, 1 = disjoint).  Weight changes on a
    surviving edge do not count — the partition only sees weights through
    refinement, which the delta path re-runs anyway."""
    a, b = edge_set(old), edge_set(new)
    union = len(a | b)
    return 0.0 if union == 0 else len(a ^ b) / union
