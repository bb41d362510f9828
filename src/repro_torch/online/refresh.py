"""Embedding-space affinity refresh + dynamic corpus ingestion.

The paper's production framing (§4) assumes the regularizer tracks the
model's similarity structure as training progresses; Bai et al. (1511.06104)
build the k-NN graph *online* from the evolving network's embeddings.  This
module is the reference's loop (``repro.online.refresh``) on the port:

  capture  — the engine's ``capture_fn``/``on_epoch_end`` hook hands this
             module the hidden activations of every step of a refresh
             epoch (stacked on the host after the epoch);
  refresh  — :func:`embedding_knn_graph` re-runs the streaming top-k over
             those activations (host numpy, or the kernel K8 on the
             experiment's device — never a dense N×N) and rebuilds the RBF
             weights with a self-tuning bandwidth (global sigma, or
             Zelnik-Manor per-node scaling — the learned-bandwidth option
             of Sharma & Jones 2306.07098);
  swap     — the new graph + plan are lock-published to the
             :class:`~repro_torch.data.pipeline.MetaBatchStream` through
             ``swap_graph``, with the partition delta-repaired around the
             changed edges when churn is low and re-synthesized from
             scratch when the topology really moved;
  ingest   — :meth:`OnlineManager.insert` / ``.evict`` patch new/departed
             nodes through ``AffinityGraph.insert``/``.evict`` plus the
             partitioner's "perturbed chunk" repair
             (:func:`~repro_torch.core.partition.extend_partition`).

Determinism: a refresh at epoch ``e`` is a pure function of
``(params, corpus, config, seed)``; K8 uses no atomics, so identical runs
produce bit-identical graphs.

Threading: every :class:`OnlineManager` method runs on the training thread
(the engine fires ``on_epoch_end`` between epochs); all cross-thread
publication goes through the stream's lock (``snapshot`` in,
``swap_graph`` out).  The manager itself holds no lock.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from repro_torch.core.affinity import AffinityGraph, knn_edges
from repro_torch.core.metabatch import (epoch_plan_seed, plan_from_labels,
                                        plan_meta_batches)
from repro_torch.core.partition import (HierarchyCache, extend_partition,
                                        repair_partition)

__all__ = [
    "embedding_topk_device",
    "embedding_knn_graph",
    "edge_set",
    "edge_churn",
    "scatter_epoch_embeddings",
    "OnlineManager",
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


def _changed_endpoints(Wa: sp.csr_matrix, Wb: sp.csr_matrix) -> np.ndarray:
    """Nodes incident to any edge present in exactly one of Wa, Wb."""
    Pa = (Wa != 0).astype(np.int8)
    Pb = (Wb != 0).astype(np.int8)
    D = (Pa - Pb).tocoo()
    return np.unique(np.concatenate([D.row, D.col]))


def scatter_epoch_embeddings(
    captures: np.ndarray,
    indices: list[list[np.ndarray]],
    n: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-node embedding matrix from the engine's stacked epoch captures.

    ``captures`` is the ``on_epoch_end`` payload, ``(steps, k, P, H)``;
    ``indices`` is the stream's ``last_epoch_indices`` — per step, per
    worker, the *unpadded* concatenated node indices that batch row held.
    Later steps overwrite earlier ones (a node sampled twice — Eq.-6
    neighbour draws, the wrap-padded tail group — keeps its freshest
    activation); padding rows beyond ``len(idx)`` are dropped.  Returns
    ``(E, seen)`` with ``seen`` marking nodes that appeared at least once
    (callers embed the gaps directly with a clean forward).
    """
    if len(indices) != captures.shape[0]:
        raise ValueError(
            f"{captures.shape[0]} captured steps but {len(indices)} index "
            "groups — was the stream built with record_indices=True?")
    width = captures.shape[-1]
    E = np.zeros((n, width), dtype=np.float32)
    seen = np.zeros(n, dtype=bool)
    for s, group in enumerate(indices):
        for w, idx in enumerate(group):
            E[idx] = np.asarray(captures[s, w][: len(idx)], dtype=np.float32)
            seen[idx] = True
    return E, seen


class OnlineManager:
    """Drives refresh + ingestion against a live :class:`MetaBatchStream`.

    Wire it into the engine via ``capture_epoch`` (as ``capture_epochs=``)
    and ``on_epoch_end``; call :meth:`insert` / :meth:`evict` from the
    serving/ingestion side between epochs.  ``embed_fn(params, X) ->
    (n, H)`` computes embeddings directly (a clean ``dnn_hidden`` forward)
    for nodes the capture missed and for newly inserted rows after the
    graph has moved to embedding space.

    ``stats`` counts refreshes / delta_refines / full_rebuilds / inserts /
    evictions / rejected swaps — the insert acceptance gate asserts
    ``full_rebuilds`` stays 0 and the swapped-in hierarchy cache records 0
    builds.  ``device`` is where ``OnlineConfig.backend="device"`` runs the
    refresh's top-k (K8 on a GPU, its plain version on the CPU).
    """

    def __init__(self, stream, corpus, graph: AffinityGraph, cfg, *,
                 batch_size: int, n_classes: int, tol: float = 0.15,
                 coarsen_to: int = 60, shuffle_blocks: bool = True,
                 partitioner=None, embed_fn=None, seed: int = 0,
                 device="cuda"):
        self.stream = stream
        self.corpus = corpus
        self.graph = graph
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.n_classes = int(n_classes)
        self.tol = tol
        self.coarsen_to = coarsen_to
        self.shuffle_blocks = shuffle_blocks
        self.partitioner = partitioner
        self.embed_fn = embed_fn
        self.seed = int(seed)
        self.device = device
        self.params = None           # freshest params seen by on_epoch_end
        # Rows the *current* graph was built from: input features until the
        # first refresh, then the captured embedding matrix.
        self.features = np.asarray(corpus.X)
        self.embedding_space = False
        self.last_churn: float | None = None
        self._ops = 0                # insert/evict counter -> plan seeds
        self.stats = {"refreshes": 0, "delta_refines": 0, "full_rebuilds": 0,
                      "inserts": 0, "evictions": 0, "rejected": 0}

    # ------------------------------------------------------------- engine
    def capture_epoch(self, epoch: int) -> bool:
        """Predicate handed to ``Engine.run(capture_epochs=...)``: capture
        during every ``refresh_every``-th epoch (whose end refreshes)."""
        r = int(getattr(self.cfg, "refresh_every", 0) or 0)
        return r > 0 and (epoch + 1) % r == 0

    def on_epoch_end(self, epoch: int, params, captures) -> None:
        """Engine epoch-end hook: assemble the per-node embedding matrix
        from the epoch's captures and refresh the graph from it."""
        self.params = params
        if captures is None or not self.capture_epoch(epoch):
            return
        indices = self.stream.snapshot()[4]
        if indices is None:
            raise RuntimeError(
                "online refresh needs the stream built with "
                "record_indices=True (the Experiment layer does this when "
                "OnlineConfig is active)")
        E, seen = scatter_epoch_embeddings(captures, indices, self.corpus.n)
        if not seen.all():
            missing = np.flatnonzero(~seen)
            if self.embed_fn is None:
                raise RuntimeError(
                    f"{missing.size} nodes were never captured this epoch "
                    "and no embed_fn was provided to fill the gaps")
            E[missing] = self.embed_fn(params, self.corpus.X[missing])
        self.refresh(epoch, E)

    # ------------------------------------------------------------ refresh
    def _fresh_hierarchy(self, graph: AffinityGraph):
        """A lazily-built cache for the new graph — iff the stream was
        using hierarchy reuse (the old cache describes dead topology)."""
        if self.stream.snapshot()[3] is None:
            return None
        return HierarchyCache(
            graph.W, tol=self.tol, coarsen_to=self.coarsen_to,
            seed=self.seed)

    def refresh(self, epoch: int, embeddings: np.ndarray) -> bool:
        """Rebuild the affinity graph from ``embeddings`` and lock-publish
        it (with a matching plan) to the stream.

        Low edge churn (``<= cfg.churn_threshold``) keeps the previous
        mini-block labels and repairs them around the changed-edge
        endpoints (delta path — the partition work tracks the topology
        delta); high churn re-synthesizes the plan from scratch on the new
        graph.  Returns False when the stream rejected the swap (pad/tile
        budget), in which case the old graph stays live.
        """
        cfg = self.cfg
        k = int(getattr(cfg, "k", None) or self.graph.k)
        new_graph = embedding_knn_graph(
            embeddings, k=k,
            backend=getattr(cfg, "backend", "host"),
            bandwidth=getattr(cfg, "bandwidth", "global"),
            device=self.device)
        churn = edge_churn(self.graph, new_graph)
        seed = epoch_plan_seed(self.seed + 3, epoch)
        prev_plan = self.stream.snapshot()[0]
        labels = prev_plan.mini_block_labels
        delta = churn <= float(getattr(cfg, "churn_threshold", 0.25))
        if delta:
            res = repair_partition(
                new_graph.W, labels, int(labels.max()) + 1, tol=self.tol,
                touched=_changed_endpoints(self.graph.W, new_graph.W))
            plan = plan_from_labels(
                new_graph, res.labels, self.batch_size, self.n_classes,
                seed=seed, shuffle_blocks=self.shuffle_blocks)
        else:
            plan = plan_meta_batches(
                new_graph, self.batch_size, self.n_classes, seed=seed,
                tol=self.tol, shuffle_blocks=self.shuffle_blocks,
                partitioner=self.partitioner, coarsen_to=self.coarsen_to)
        if not self.stream.swap_graph(new_graph, plan,
                                      hierarchy=self._fresh_hierarchy(
                                          new_graph)):
            self.stats["rejected"] += 1
            return False
        self.graph = new_graph
        self.features = np.asarray(embeddings, dtype=np.float32)
        self.embedding_space = True
        self.last_churn = churn
        self.stats["refreshes"] += 1
        self.stats["delta_refines" if delta else "full_rebuilds"] += 1
        return True

    # ------------------------------------------------------------- ingest
    def _embed_new(self, X_new: np.ndarray) -> np.ndarray:
        """Rows for new nodes in the current graph's space: raw features
        before the first refresh, model embeddings (current params) after."""
        if not self.embedding_space:
            return np.asarray(X_new, dtype=np.float32)
        if self.embed_fn is None or self.params is None:
            raise RuntimeError(
                "insert after an embedding-space refresh needs embed_fn "
                "and at least one trained epoch (params)")
        return np.asarray(self.embed_fn(self.params, X_new), np.float32)

    def insert(self, X_new: np.ndarray, y_new=None,
               labeled=None) -> np.ndarray | None:
        """Add new corpus rows to the live graph/plan/stream.

        The PR-5 "perturbed chunk" path end to end: streaming top-k of the
        new rows against the corpus (``AffinityGraph.insert`` — existing
        rows untouched), heaviest-neighbour label seeding + delta-seeded
        refinement (:func:`extend_partition` — never ``partition_graph``),
        plan re-grouped from the repaired labels, and the whole
        (graph, plan, corpus) lock-published at once.  New rows default to
        unlabeled (``label_mask`` False) — the arriving-traffic case.
        Returns the new nodes' indices, or None when the stream rejected
        the swap (plan outgrew the pinned pad — raise pad_headroom).
        """
        import dataclasses
        X_new = np.atleast_2d(np.asarray(X_new))
        m = X_new.shape[0]
        if m == 0:
            return np.empty((0,), dtype=np.int64)
        n_old = self.corpus.n
        new_graph = self.graph.insert(self.features, self._embed_new(X_new))
        prev_plan = self.stream.snapshot()[0]
        labels = prev_plan.mini_block_labels
        res = extend_partition(new_graph.W, labels,
                               int(labels.max()) + 1, tol=self.tol)
        self._ops += 1
        plan = plan_from_labels(
            new_graph, res.labels, self.batch_size, self.n_classes,
            seed=epoch_plan_seed(self.seed + 7919, self._ops),
            shuffle_blocks=self.shuffle_blocks)
        y_new = (np.zeros(m, dtype=self.corpus.y.dtype) if y_new is None
                 else np.asarray(y_new, dtype=self.corpus.y.dtype))
        labeled = (np.zeros(m, dtype=bool) if labeled is None
                   else np.asarray(labeled, dtype=bool))
        corpus = dataclasses.replace(
            self.corpus,
            X=np.concatenate([self.corpus.X,
                              np.asarray(X_new, self.corpus.X.dtype)]),
            y=np.concatenate([self.corpus.y, y_new]),
            label_mask=np.concatenate([self.corpus.label_mask, labeled]))
        if not self.stream.swap_graph(
                new_graph, plan, corpus=corpus,
                hierarchy=self._fresh_hierarchy(new_graph)):
            self.stats["rejected"] += 1
            return None
        self.features = np.concatenate(
            [self.features, self._embed_new(X_new)])
        self.graph = new_graph
        self.corpus = corpus
        self.stats["inserts"] += 1
        return np.arange(n_old, n_old + m)

    def evict(self, idx: np.ndarray) -> bool:
        """Remove nodes from the live graph/plan/corpus (departed users).

        Symmetric row/col deletion, then the same local repair as insert,
        seeded with the evicted nodes' surviving neighbours.  Returns False
        if the stream rejected the swap.
        """
        import dataclasses
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
        if idx.size == 0:
            return True
        n = self.corpus.n
        keep = np.ones(n, dtype=bool)
        keep[idx] = False
        new_index = np.cumsum(keep) - 1
        nbrs = np.unique(self.graph.W[idx].indices)
        touched = new_index[nbrs[keep[nbrs]]]
        new_graph = self.graph.evict(idx)
        prev_plan = self.stream.snapshot()[0]
        labels = prev_plan.mini_block_labels[keep]
        res = repair_partition(new_graph.W, labels,
                               int(prev_plan.mini_block_labels.max()) + 1,
                               tol=self.tol, touched=touched)
        self._ops += 1
        plan = plan_from_labels(
            new_graph, res.labels, self.batch_size, self.n_classes,
            seed=epoch_plan_seed(self.seed + 7919, self._ops),
            shuffle_blocks=self.shuffle_blocks)
        corpus = dataclasses.replace(
            self.corpus, X=self.corpus.X[keep], y=self.corpus.y[keep],
            label_mask=self.corpus.label_mask[keep])
        if not self.stream.swap_graph(
                new_graph, plan, corpus=corpus,
                hierarchy=self._fresh_hierarchy(new_graph)):
            self.stats["rejected"] += 1
            return False
        self.features = self.features[keep]
        self.graph = new_graph
        self.corpus = corpus
        self.stats["evictions"] += 1
        return True
