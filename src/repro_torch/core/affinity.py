"""k-NN affinity-graph construction (paper §3).

The paper builds a sparse k-NN graph (k=10) over ~1M speech frames with a
ball-tree search, symmetrizes it, and applies an RBF kernel
``w_ij = exp(-||x_i - x_j|| / (2 sigma^2))`` to get edge weights.

Search is exact blocked brute force, *streaming over candidate columns*: for
each row block only one (row_block × col_block) distance tile is live at a
time and a running per-row top-k is merged tile by tile — the N×N (or even
row_block × N) distance matrix is never materialized, which is what keeps
construction feasible on the ROADMAP's path to corpus-scale graphs (graph
construction, not training, is the scale bottleneck — Bai et al. 1511.06104).

Two backends share the same semantics and are validated against each other:

  * ``"host"``   — numpy, column-streamed (this module; the default);
  * ``"device"`` — a streaming top-k kernel on the GPU.  Its Hopper kernel
    is not ported yet, so this backend raises ``NotImplementedError``.

Both backends compute distances in float32: the self-tuning ``sigma``
heuristic (and hence every edge weight) is a function of the returned
distances, so the search dtype is pinned rather than inherited from the
input — host-f64 vs device-f32 used to make the *same corpus* produce
different graphs depending on backend.

Dynamic corpora: :func:`insert_nodes` / :func:`evict_nodes` (also exposed as
``AffinityGraph.insert`` / ``.evict``) patch the symmetric CSR incrementally —
a streaming top-k of the new rows against the corpus plus symmetric row
patching — so new users join the live graph without an O(N²) rebuild
(online graph refresh drives these under traffic).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

__all__ = [
    "AffinityGraph",
    "pairwise_sq_dists",
    "knn_edges",
    "build_affinity_graph",
    "insert_nodes",
    "evict_nodes",
]


@dataclasses.dataclass(frozen=True)
class AffinityGraph:
    """Symmetric weighted k-NN affinity graph G = (V, E, W) in CSR form."""

    W: sp.csr_matrix          # symmetric affinity weights, zero diagonal
    k: int                    # neighbours requested per node
    sigma: float              # RBF bandwidth actually used

    @property
    def n_nodes(self) -> int:
        return self.W.shape[0]

    @property
    def n_edges(self) -> int:
        return self.W.nnz // 2

    def degrees(self) -> np.ndarray:
        """Weighted degree ``d_i = sum_j w_ij`` (the Eq. 3 coefficient)."""
        return np.asarray(self.W.sum(axis=1)).ravel()

    def neighbor_counts(self) -> np.ndarray:
        """|N_i| — structural neighbour counts (used by Eq. 5 stats)."""
        return np.diff(self.W.indptr)

    def permuted(self, perm: np.ndarray) -> "AffinityGraph":
        """Re-permute the affinity matrix (paper Fig. 1b) by ``perm``.

        ``perm[new_index] = old_index``; rows/cols are reordered so that a
        graph partitioning yields a dense block-diagonal structure.
        """
        P = sp.csr_matrix(
            (np.ones(len(perm)), (np.arange(len(perm)), perm)),
            shape=self.W.shape,
        )
        Wp = (P @ self.W @ P.T).tocsr()
        Wp.sort_indices()
        return AffinityGraph(W=Wp, k=self.k, sigma=self.sigma)

    def dense_block(self, idx: np.ndarray) -> np.ndarray:
        """Dense ``|idx| x |idx|`` affinity sub-block for a (meta-)batch."""
        sub = self.W[idx][:, idx]
        return np.asarray(sub.todense(), dtype=np.float32)

    def insert(self, X: np.ndarray, X_new: np.ndarray,
               **kw) -> "AffinityGraph":
        """See :func:`insert_nodes`."""
        return insert_nodes(self, X, X_new, **kw)

    def evict(self, idx: np.ndarray) -> "AffinityGraph":
        """See :func:`evict_nodes`."""
        return evict_nodes(self, idx)


def pairwise_sq_dists(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Squared euclidean distances, the classic ||x||^2 - 2xy + ||y||^2 form."""
    xx = np.einsum("id,id->i", X, X)[:, None]
    yy = np.einsum("jd,jd->j", Y, Y)[None, :]
    d2 = xx - 2.0 * (X @ Y.T) + yy
    np.maximum(d2, 0.0, out=d2)
    return d2


def _streaming_topk_host(X: np.ndarray, k: int, block: int,
                         col_block: int) -> tuple[np.ndarray, np.ndarray]:
    """Column-streamed exact top-k: running (rows, k) state merged one
    (block × col_block) distance tile at a time; peak memory is one tile
    plus the running state — independent of n along the candidate axis.

    Distances are float32 regardless of the input dtype, matching the
    device backend so the sigma heuristic downstream agrees across the two.
    """
    X = np.ascontiguousarray(X, dtype=np.float32)
    n = X.shape[0]
    offs = np.arange(n)
    return _streaming_topk_rows(X, X, k, block, col_block, self_of_row=offs)


def _streaming_topk_rows(
    Q: np.ndarray, Y: np.ndarray, k: int, block: int, col_block: int,
    *, self_of_row: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k of query rows ``Q`` against candidate rows ``Y``, streamed
    in (block × col_block) f32 tiles.  ``self_of_row[i]`` (optional) names a
    candidate column excluded for query row i — the self index when Q is a
    row slice of Y, as in the online insert path."""
    Q = np.ascontiguousarray(Q, dtype=np.float32)
    Y = np.ascontiguousarray(Y, dtype=np.float32)
    m, n = Q.shape[0], Y.shape[0]
    qn = np.einsum("id,id->i", Q, Q)
    yn = np.einsum("id,id->i", Y, Y)
    cols = np.empty((m, k), dtype=np.int64)
    dsts = np.empty((m, k), dtype=np.float32)
    for s in range(0, m, block):
        e = min(s + block, m)
        run_d = np.full((e - s, k), np.inf, dtype=np.float32)
        run_i = np.full((e - s, k), -1, dtype=np.int64)
        for cs in range(0, n, col_block):
            ce = min(cs + col_block, n)
            d2 = qn[s:e, None] - 2.0 * (Q[s:e] @ Y[cs:ce].T) + yn[None, cs:ce]
            np.maximum(d2, 0.0, out=d2)
            if self_of_row is not None:
                sc = self_of_row[s:e]
                hit = (sc >= cs) & (sc < ce)
                if hit.any():
                    d2[np.flatnonzero(hit), sc[hit] - cs] = np.inf
            cand_d = np.concatenate([run_d, d2], axis=1)
            cand_i = np.concatenate(
                [run_i, np.broadcast_to(np.arange(cs, ce), d2.shape)], axis=1)
            sel = np.argpartition(cand_d, k - 1, axis=1)[:, :k]
            run_d = np.take_along_axis(cand_d, sel, axis=1)
            run_i = np.take_along_axis(cand_i, sel, axis=1)
        order = np.argsort(run_d, axis=1, kind="stable")
        cols[s:e] = np.take_along_axis(run_i, order, axis=1)
        dsts[s:e] = np.take_along_axis(run_d, order, axis=1)
    return cols, dsts


def _streaming_topk_device(X: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The device streaming top-k search.

    Its Hopper kernel (the port of the reference's streaming top-k kernel)
    belongs to a later slice of the port; until then this backend raises
    rather than falling back to the host search or a dense N×N product.
    """
    raise NotImplementedError(
        "construction='device' needs the streaming top-k GPU kernel, which "
        "is not ported yet (device graph-construction slice); use "
        "construction='host'")


def knn_edges(
    X: np.ndarray,
    k: int,
    *,
    block: int = 2048,
    col_block: int = 4096,
    backend: str = "host",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact k-NN by blocked brute force, streaming over candidate columns.

    The paper uses an approximate ball-tree (sklearn); for our corpus sizes
    exact blocked search is both simpler and exactly reproducible.  The
    candidate axis is consumed in ``col_block``-wide chunks against a
    running per-row top-k, so no row ever sees more than one distance tile
    at a time.  ``backend="device"`` routes the search through the GPU
    streaming top-k kernel instead (same semantics, f32 distances).
    Returns (rows, cols, sq_dists) for the directed k-NN edge set (self
    excluded), neighbours sorted nearest-first.
    """
    n = X.shape[0]
    k = min(k, n - 1)
    if backend not in ("host", "device"):
        raise ValueError(
            f"backend must be 'host' or 'device', got {backend!r}")
    if backend == "device":
        cols, dsts = _streaming_topk_device(X, k)
    else:
        cols, dsts = _streaming_topk_host(X, k, block, col_block)
    src = np.repeat(np.arange(n), k)
    return src, cols.ravel(), dsts.ravel()


def build_affinity_graph(
    X: np.ndarray,
    *,
    k: int = 10,
    sigma: float | None = None,
    block: int = 2048,
    col_block: int = 4096,
    backend: str = "host",
) -> AffinityGraph:
    """Build the symmetrized RBF-weighted k-NN graph of the paper.

    ``sigma=None`` uses the self-tuning heuristic: sigma = mean distance to
    the k-th neighbour (the paper does not report its sigma; this is the
    standard choice and is recorded on the returned graph).  The heuristic
    is evaluated on float32 distances on *both* backends, so host and
    device builds agree to f32 round-off.  ``backend`` selects the
    streaming top-k search: ``"host"`` (numpy) or ``"device"`` (GPU
    kernel) — see :func:`knn_edges`.
    """
    n = X.shape[0]
    src, dst, d2 = knn_edges(X, k, block=block, col_block=col_block,
                             backend=backend)
    dist = np.sqrt(d2)
    if sigma is None:
        kth = dist.reshape(n, -1)[:, -1]
        sigma = float(np.mean(kth)) or 1.0
    w = np.exp(-dist / (2.0 * sigma * sigma))  # paper's kernel: exp(-||.||/2s^2)
    W = sp.csr_matrix((w, (src, dst)), shape=(n, n))
    # Symmetrize: w_ij = max(w_ij, w_ji) keeps weights in the RBF range.
    W = W.maximum(W.T).tocsr()
    W.setdiag(0.0)
    W.eliminate_zeros()
    W.sort_indices()
    return AffinityGraph(W=W, k=k, sigma=sigma)


def insert_nodes(
    graph: AffinityGraph,
    X: np.ndarray,
    X_new: np.ndarray,
    *,
    block: int = 2048,
    col_block: int = 4096,
) -> AffinityGraph:
    """Append ``X_new`` rows to the graph without an O(N²) rebuild.

    Streaming top-k of the new rows against the combined corpus
    ``[X; X_new]`` (self excluded, new rows see each other), weighted with
    the graph's *recorded* sigma, then symmetric row patching via
    ``max(W, Wᵀ)``.  Existing rows keep their edge sets untouched — their
    k-NN lists are not re-run, they only *gain* reverse edges from new
    nodes — so :func:`evict_nodes` of the same rows restores the original
    graph bit-for-bit (the online insert/evict round-trip invariant).

    ``X`` must be the feature (or embedding) matrix the graph was built
    from, one row per existing node.
    """
    n = graph.n_nodes
    if X.shape[0] != n:
        raise ValueError(
            f"X has {X.shape[0]} rows but the graph has {n} nodes")
    X_new = np.atleast_2d(X_new)
    m = X_new.shape[0]
    if m == 0:
        return graph
    Y = np.concatenate(
        [np.asarray(X, np.float32), np.asarray(X_new, np.float32)])
    k = min(graph.k, n + m - 1)
    cols, d2 = _streaming_topk_rows(
        X_new, Y, k, block, col_block, self_of_row=np.arange(n, n + m))
    w = np.exp(-np.sqrt(d2) / (2.0 * graph.sigma * graph.sigma))
    rows = np.repeat(np.arange(m), k)
    new_rows = sp.csr_matrix((w.ravel(), (rows, cols.ravel())),
                             shape=(m, n + m))
    top = sp.hstack([graph.W, sp.csr_matrix((n, m))], format="csr")
    Wd = sp.vstack([top, new_rows], format="csr")
    W2 = Wd.maximum(Wd.T).tocsr()
    W2.setdiag(0.0)
    W2.eliminate_zeros()
    W2.sort_indices()
    return AffinityGraph(W=W2, k=graph.k, sigma=graph.sigma)


def evict_nodes(graph: AffinityGraph, idx: np.ndarray) -> AffinityGraph:
    """Drop nodes ``idx``: symmetric row/col deletion + compact reindexing.

    Surviving node j gets new index ``j - |{i in idx : i < j}|``.  Because
    insertion never rewrites existing rows, evicting exactly the rows a
    prior :func:`insert_nodes` appended returns the original graph.
    """
    idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
    n = graph.n_nodes
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"evict indices out of range for {n} nodes")
    keep = np.ones(n, dtype=bool)
    keep[idx] = False
    W = graph.W[keep][:, keep].tocsr()
    W.sort_indices()
    return AffinityGraph(W=W, k=graph.k, sigma=graph.sigma)
