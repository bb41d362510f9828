"""Meta-batch synthesis and stochastic neighbour regularization (paper §2).

Implements the heuristic of §2.1 verbatim:

  1. Given N points, batch size B (memory constraint) and M classes,
     partition the affinity graph into ``N*M/B`` mini-blocks of ~``B/M``
     nodes each (balanced min edge-cut).
  2. Each meta-batch = M mini-blocks drawn at random (without replacement
     within an epoch) → size ~B, entropy ≈ global label entropy, and
     ``E[C_meta] >= E[C_mini]`` with ``Var[C_meta] = Var[C_mini]/K``.

and §2.2: the induced meta-batch graph ``G_M`` with edge weight
``|C_ij|`` (# affinity edges between members of meta-batches i and j), from
which a neighbour meta-batch is drawn with probability
``p_ij = |C_ij| / sum_j |C_ij|`` (Eq. 6) each step; the loss is computed on
the concatenated batch ``[M_r, M_s]`` (§2.3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from repro_torch.introspect import accepts_kwarg

from .affinity import AffinityGraph
from .partition import PartitionResult, edge_cut, partition_graph

__all__ = ["MetaBatchPlan", "build_mini_blocks", "synthesize_meta_batches",
           "batch_graph", "NeighborSampler", "concat_batch_indices",
           "plan_meta_batches", "plan_from_labels", "epoch_plan_seed",
           "resynthesize_plan", "BlockLayout", "tile_occupancy",
           "layout_from_occupancy", "block_layout", "plan_layout_budget"]


@dataclasses.dataclass(frozen=True)
class MetaBatchPlan:
    """Static preprocessing output consumed by the training loop."""

    mini_block_labels: np.ndarray          # mini-block id per node
    meta_batches: list[np.ndarray]         # node indices per meta-batch
    meta_of_block: np.ndarray              # meta-batch id per mini-block
    batch_edges: sp.csr_matrix             # |C_ij| weights of G_M (Eq. 6)
    batch_size: int
    n_classes: int

    @property
    def n_meta(self) -> int:
        return len(self.meta_batches)


def build_mini_blocks(
    graph: AffinityGraph,
    batch_size: int,
    n_classes: int,
    *,
    tol: float = 0.15,
    seed: int = 0,
    partitioner=None,
    coarsen_to: int = 60,
    reuse=None,
) -> PartitionResult:
    """Step 1: partition into N*M/B balanced mini-blocks of ~B/M nodes.

    ``partitioner`` is any ``(W, n_parts, *, tol, coarsen_to, seed) ->
    PartitionResult`` callable (PARTITIONER registry entries qualify);
    default is the built-in multilevel scheme.  ``reuse`` (a
    ``PartitionHierarchy`` or ``HierarchyCache``) is forwarded to
    partitioners that accept it — the incremental-replan fast path.
    """
    if batch_size < n_classes:
        # n_blocks would exceed n and the clamp below would silently hand
        # back single-node "blocks": no graph structure inside any block,
        # meta-batches degenerate to random batches.
        raise ValueError(
            f"batch_size={batch_size} < n_classes={n_classes}: each "
            f"meta-batch draws M=n_classes mini-blocks of ~B/M nodes, so "
            f"B/M < 1 produces degenerate single-node mini-blocks. "
            f"Increase batch_size to at least n_classes (ideally many "
            f"times it) or reduce n_classes.")
    n = graph.n_nodes
    n_blocks = max(1, int(round(n * n_classes / batch_size)))
    n_blocks = min(n_blocks, n)  # can't have more blocks than nodes
    part = partitioner or partition_graph
    kw = {}
    if reuse is not None:
        if not accepts_kwarg(part, "reuse"):
            raise ValueError(
                f"hierarchy reuse requested but partitioner "
                f"{getattr(part, '__name__', part)!r} does not accept a "
                f"reuse= argument; use the vectorized 'multilevel' "
                f"partitioner or disable reuse_hierarchy")
        kw["reuse"] = reuse
    return part(graph.W, n_blocks, tol=tol, coarsen_to=coarsen_to, seed=seed,
                **kw)


def synthesize_meta_batches(
    mini_blocks: PartitionResult,
    n_classes: int,
    *,
    rng: np.random.Generator,
    shuffle_blocks: bool = True,
) -> tuple[list[np.ndarray], np.ndarray]:
    """Step 2: group M randomly-drawn mini-blocks into each meta-batch.

    Mini-blocks are drawn *without replacement* so every node appears in
    exactly one meta-batch per synthesis (an epoch covers the data once).
    ``shuffle_blocks=False`` groups CONSECUTIVE mini-blocks instead — that
    is the paper's 'pure graph-partitioned batch' baseline (§2: homogeneous,
    low-entropy, biased gradients), kept for the ablation benchmark.
    Returns (meta_batches, meta_of_block).
    """
    k = mini_blocks.n_parts
    order = rng.permutation(k) if shuffle_blocks else np.arange(k)
    groups = [order[s : s + n_classes] for s in range(0, k, n_classes)]
    # Fold a trailing undersized group into the previous one (keeps ~B size).
    if len(groups) > 1 and len(groups[-1]) < max(2, n_classes // 2):
        groups[-2] = np.concatenate([groups[-2], groups[-1]])
        groups.pop()
    # One stable argsort groups every block's (ascending) members at once —
    # the k-times-np.where scan this replaces was a visible slice of the
    # per-epoch replan cost in the many-small-blocks regime.
    by_block = np.argsort(mini_blocks.labels, kind="stable")
    counts = np.bincount(mini_blocks.labels, minlength=k)
    starts = np.concatenate(([0], np.cumsum(counts)))
    members_of_block = [by_block[starts[b] : starts[b + 1]] for b in range(k)]
    meta_batches = [
        np.concatenate([members_of_block[b] for b in g]) for g in groups
    ]
    meta_of_block = np.empty(k, dtype=np.int64)
    for mi, g in enumerate(groups):
        meta_of_block[g] = mi
    return meta_batches, meta_of_block


def batch_graph(
    graph: AffinityGraph, meta_of_node: np.ndarray, n_meta: int
) -> sp.csr_matrix:
    """Induced meta-batch graph G_M with integer edge weights |C_ij| (§2.2)."""
    coo = graph.W.tocoo()
    r = meta_of_node[coo.row]
    c = meta_of_node[coo.col]
    keep = r != c
    if n_meta <= 2048:
        # |C_ij| is a *count* of crossing affinity edges: one bincount over
        # the flattened (i, j) key replaces the duplicate-summing CSR
        # assembly (a visible slice of the per-epoch replan cost).
        key = r[keep].astype(np.int64) * n_meta + c[keep]
        counts = np.bincount(key, minlength=n_meta * n_meta)
        # Each unique node pair was counted twice (W symmetric) -> halve.
        E = sp.csr_matrix((counts / 2.0).reshape(n_meta, n_meta))
        E.eliminate_zeros()
        return E.tocsr()
    ones = np.ones(keep.sum())
    E = sp.csr_matrix((ones, (r[keep], c[keep])), shape=(n_meta, n_meta))
    E.sum_duplicates()
    E.data = E.data / 2.0
    return E.tocsr()


def plan_meta_batches(
    graph: AffinityGraph,
    batch_size: int,
    n_classes: int,
    *,
    seed: int = 0,
    tol: float = 0.15,
    shuffle_blocks: bool = True,
    partitioner=None,
    coarsen_to: int = 60,
    reuse=None,
) -> MetaBatchPlan:
    """One-shot preprocessing: mini-blocks -> meta-batches -> batch graph."""
    rng = np.random.default_rng(seed)
    mini = build_mini_blocks(graph, batch_size, n_classes, tol=tol, seed=seed,
                             partitioner=partitioner, coarsen_to=coarsen_to,
                             reuse=reuse)
    metas, meta_of_block = synthesize_meta_batches(
        mini, n_classes, rng=rng, shuffle_blocks=shuffle_blocks)
    meta_of_node = meta_of_block[mini.labels]
    E = batch_graph(graph, meta_of_node, len(metas))
    return MetaBatchPlan(
        mini_block_labels=mini.labels,
        meta_batches=metas,
        meta_of_block=meta_of_block,
        batch_edges=E,
        batch_size=batch_size,
        n_classes=n_classes,
    )


def plan_from_labels(
    graph: AffinityGraph,
    labels: np.ndarray,
    batch_size: int,
    n_classes: int,
    *,
    seed: int = 0,
    shuffle_blocks: bool = True,
) -> MetaBatchPlan:
    """Re-group an *existing* mini-block labeling into a fresh plan.

    The online insert/evict and low-churn refresh paths already hold
    delta-repaired labels (``repair_partition`` / ``extend_partition``) —
    this skips the partitioner entirely and runs only the §2.2 grouping:
    shuffled mini-block → meta-batch assignment plus the induced batch
    graph, deterministic per ``(labels, seed)``.
    """
    labels = np.asarray(labels, dtype=np.int64)
    if labels.shape[0] != graph.n_nodes:
        raise ValueError(
            f"labels cover {labels.shape[0]} nodes, graph has "
            f"{graph.n_nodes}")
    n_parts = int(labels.max()) + 1 if labels.size else 0
    mini = PartitionResult(
        labels=labels, n_parts=n_parts,
        cut=edge_cut(graph.W, labels),
        sizes=np.bincount(labels, minlength=n_parts))
    rng = np.random.default_rng(seed)
    metas, meta_of_block = synthesize_meta_batches(
        mini, n_classes, rng=rng, shuffle_blocks=shuffle_blocks)
    meta_of_node = meta_of_block[labels]
    E = batch_graph(graph, meta_of_node, len(metas))
    return MetaBatchPlan(
        mini_block_labels=labels,
        meta_batches=metas,
        meta_of_block=meta_of_block,
        batch_edges=E,
        batch_size=batch_size,
        n_classes=n_classes,
    )


def epoch_plan_seed(base_seed: int, epoch: int) -> int:
    """Deterministic per-epoch seed stream for stochastic re-partitioning.

    Derived through ``np.random.SeedSequence([base_seed, epoch])`` so the
    epoch seeds are decorrelated (not just ``base_seed + epoch``) while
    identical ``(base_seed, epoch)`` pairs stay bit-reproducible across
    processes and platforms.
    """
    ss = np.random.SeedSequence([int(base_seed), int(epoch)])
    return int(ss.generate_state(1, dtype=np.uint32)[0])


def resynthesize_plan(
    graph: AffinityGraph,
    batch_size: int,
    n_classes: int,
    *,
    epoch: int,
    base_seed: int = 0,
    temperature: float = 0.0,
    tol: float = 0.15,
    shuffle_blocks: bool = True,
    partitioner=None,
    coarsen_to: int = 60,
    reuse=None,
) -> MetaBatchPlan:
    """Plan for one epoch of the stochastic re-partitioning stream (§2).

    A pure function of ``(graph, config, base_seed, epoch)``: identical
    inputs yield bit-identical plans (safe to compute on a background
    thread), while different epochs draw a fresh partition from the
    ``temperature``-perturbed matching distribution — batch composition
    stays stochastic across epochs, as the abstract's "enough
    stochasticity for SGD" requires.

    ``temperature`` is forwarded to the partitioner only when its signature
    accepts it (the built-in vectorized partitioner does); requesting
    ``temperature > 0`` from a partitioner that cannot honor it raises.

    ``reuse`` hands the partitioner a cached coarsening hierarchy (a
    ``PartitionHierarchy`` or ``HierarchyCache``): the replan skips the
    frozen fine-level coarsening and re-draws only the top of the chain
    plus the initial partition and refinement.  The hierarchy is itself a
    pure function of ``(graph, k, config, seed)`` — never of the epoch —
    so reuse keeps the bit-reproducibility contract: identical
    ``(base_seed, epoch)`` pairs yield identical plans no matter when (or
    whether) the hierarchy was built.
    """
    part = partitioner or partition_graph
    if temperature != 0.0:
        if not accepts_kwarg(part, "temperature"):
            raise ValueError(
                f"matching_temperature={temperature} but partitioner "
                f"{getattr(part, '__name__', part)!r} does not accept a "
                f"temperature= argument; use the vectorized 'multilevel' "
                f"partitioner or set matching_temperature=0")
        import functools
        part = functools.partial(part, temperature=temperature)
    return plan_meta_batches(
        graph, batch_size=batch_size, n_classes=n_classes,
        seed=epoch_plan_seed(base_seed, epoch), tol=tol,
        shuffle_blocks=shuffle_blocks, partitioner=part,
        coarsen_to=coarsen_to, reuse=reuse)


class NeighborSampler:
    """Samples a neighbour meta-batch with p_ij = |C_ij| / sum_j |C_ij| (Eq. 6)."""

    def __init__(self, batch_edges: sp.csr_matrix, *, seed: int = 0):
        self.E = batch_edges.tocsr()
        self.rng = np.random.default_rng(seed)

    def probs(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Neighbour ids and their selection probabilities for meta-batch i."""
        s, e = self.E.indptr[i], self.E.indptr[i + 1]
        nbrs = self.E.indices[s:e]
        w = self.E.data[s:e]
        tot = w.sum()
        if tot <= 0 or len(nbrs) == 0:
            return np.array([], dtype=np.int64), np.array([])
        return nbrs, w / tot

    def sample(self, i: int) -> int | None:
        nbrs, p = self.probs(i)
        if len(nbrs) == 0:
            return None
        return int(self.rng.choice(nbrs, p=p))


def concat_batch_indices(
    plan: MetaBatchPlan, i: int, j: int | None
) -> np.ndarray:
    """Node indices of the concatenated batch M_c = [M_r, M_s] (§2.3)."""
    if j is None:
        return plan.meta_batches[i]
    return np.concatenate([plan.meta_batches[i], plan.meta_batches[j]])


# --------------------------------------------------------------------------
# Block-sparse tile layout (consumed by kernels/graph_reg blocksparse path)
#
# After §2 partitioning the concatenated-batch affinity block W is
# block-structured: most bt×bt tiles off the mini-block diagonal are exact
# structural zeros.  A ``BlockLayout`` records which tiles are occupied as
#   * a dense (nt, nt) int32 occupancy mask, and
#   * two padded active-tile index lists — row-major (CSR-style, drives the
#     forward / dL/dlogp kernels) and column-major (CSC-style, drives the
#     Wᵀ·P pass of the VJP) — each entry an (row, col, valid) triple.
# Both lists share one static length so jitted kernel shapes never change
# across batches; the padding convention is part of the kernel contract:
#   * every EMPTY tile row (resp. column) still gets one sentinel entry
#     (row, 0, valid=0) so the row's output block is visited and written
#     (Pallas only flushes an output block when the grid visits it), and
#   * length padding repeats the LAST entry with valid=0 — same (row, col)
#     as the real tail, so no new accumulation strip starts and the
#     strip-finalize predicate fires exactly once, at the final pad tile.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Static tile-occupancy layout of one padded batch affinity block."""

    bt: int                    # square tile edge (rows == cols per tile)
    nt: int                    # number of tiles per side (padded B / bt)
    n_active: int              # occupied tiles (<= nt*nt)
    rows: np.ndarray           # (T,) int32 — row-major list: tile row ids
    cols: np.ndarray           # (T,) int32 — row-major list: tile col ids
    valid: np.ndarray          # (T,) int32 — 1 = real tile, 0 = sentinel/pad
    crows: np.ndarray          # (T,) int32 — col-major list: tile row ids
    ccols: np.ndarray          # (T,) int32 — col-major list: tile col ids
    cvalid: np.ndarray         # (T,) int32
    occ: np.ndarray            # (nt, nt) int32 occupancy mask

    @property
    def list_len(self) -> int:
        return int(self.rows.shape[0])

    @property
    def density(self) -> float:
        """Fraction of tiles occupied — the FLOP ratio vs the dense sweep."""
        return self.n_active / float(self.nt * self.nt)

    def arrays(self) -> tuple[np.ndarray, ...]:
        """The 7-tuple the kernels consume (order is the ops contract)."""
        return (self.rows, self.cols, self.valid,
                self.crows, self.ccols, self.cvalid, self.occ)


def tile_occupancy(W: np.ndarray, bt: int) -> np.ndarray:
    """(nt, nt) bool mask: tile (i, j) is True iff any W entry in it is != 0.

    Exact occupancy — the block-sparse regularizer over this mask equals
    the dense regularizer bit-for-bit semantics-wise (a skipped tile is an
    all-zero tile, contributing nothing to any Eq.-3/4 term).
    """
    if W.ndim != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f"W must be square, got shape {W.shape}")
    B = W.shape[0]
    nt = -(-B // bt)
    P = nt * bt
    if P != B:
        Wp = np.zeros((P, P), dtype=W.dtype)
        Wp[:B, :B] = W
    else:
        Wp = W
    return Wp.reshape(nt, bt, nt, bt).any(axis=(1, 3))


def _tile_list(occ: np.ndarray, *, by_col: bool) -> tuple[np.ndarray, ...]:
    """Active-tile (rows, cols, valid) in row-major or col-major order,
    with one (major, 0, valid=0) sentinel per empty major line."""
    nt = occ.shape[0]
    if by_col:
        c, r = np.nonzero(occ.T)        # sorted by col, then row
        major = c
    else:
        r, c = np.nonzero(occ)          # sorted by row, then col
        major = r
    present = np.zeros(nt, dtype=bool)
    present[major] = True
    missing = np.flatnonzero(~present)
    zeros = np.zeros(len(missing), dtype=np.int64)
    if by_col:
        rows = np.concatenate([r, zeros])
        cols = np.concatenate([c, missing])
        order = np.argsort(cols, kind="stable")
    else:
        rows = np.concatenate([r, missing])
        cols = np.concatenate([c, zeros])
        order = np.argsort(rows, kind="stable")
    valid = np.concatenate([np.ones(len(r), dtype=np.int32),
                            np.zeros(len(missing), dtype=np.int32)])
    return (rows[order].astype(np.int32), cols[order].astype(np.int32),
            valid[order])


def _pad_tile_list(rows, cols, valid, n: int):
    """Pad to length n by repeating the last entry with valid=0."""
    cur = len(rows)
    if cur > n:
        raise ValueError(
            f"tile list length {cur} exceeds the pinned layout budget {n}; "
            f"raise the budget (plan_layout_budget headroom) or the tile "
            f"size")
    if cur == n:
        return rows, cols, valid
    pad = n - cur
    rows = np.concatenate([rows, np.full(pad, rows[-1], dtype=np.int32)])
    cols = np.concatenate([cols, np.full(pad, cols[-1], dtype=np.int32)])
    valid = np.concatenate([valid, np.zeros(pad, dtype=np.int32)])
    return rows, cols, valid


def layout_from_occupancy(
    occ: np.ndarray, bt: int, *, list_len: int | None = None
) -> BlockLayout:
    """Build the padded index lists from a boolean (nt, nt) occupancy mask."""
    occ = np.asarray(occ, dtype=bool)
    if occ.ndim != 2 or occ.shape[0] != occ.shape[1]:
        raise ValueError(f"occ must be square, got shape {occ.shape}")
    nt = occ.shape[0]
    rows, cols, valid = _tile_list(occ, by_col=False)
    crows, ccols, cvalid = _tile_list(occ, by_col=True)
    n = max(len(rows), len(crows)) if list_len is None else int(list_len)
    rows, cols, valid = _pad_tile_list(rows, cols, valid, n)
    crows, ccols, cvalid = _pad_tile_list(crows, ccols, cvalid, n)
    return BlockLayout(
        bt=int(bt), nt=nt, n_active=int(occ.sum()),
        rows=rows, cols=cols, valid=valid,
        crows=crows, ccols=ccols, cvalid=cvalid,
        occ=occ.astype(np.int32))


def block_layout(
    W: np.ndarray, bt: int, *, list_len: int | None = None
) -> BlockLayout:
    """BlockLayout of a (padded) dense batch affinity block W."""
    return layout_from_occupancy(tile_occupancy(W, bt), bt,
                                 list_len=list_len)


def plan_layout_budget(
    plan: MetaBatchPlan,
    graph: AffinityGraph,
    bt: int,
    pad: int,
    *,
    with_neighbor: bool = True,
    headroom: float = 1.25,
) -> int:
    """Static tile-list length covering every batch this plan can emit.

    Walks every Eq.-6 support pair (r, s) with |C_rs| > 0 (plus the
    neighbourless singletons) and computes the exact padded-tile list
    length of the assembled [M_r, M_s] batch — active tiles plus one
    sentinel per empty tile row/column.  The max over pairs, scaled by
    ``headroom`` (slack for re-partitioned plans) and rounded up to a
    multiple of 8, is the shared static list length the jitted kernels
    are shaped with.  Pure host-side preprocessing — nothing here runs
    per training step.
    """
    nt = -(-pad // bt)
    W = graph.W.tocsr()
    pairs: list[tuple[int, int | None]] = [(i, None)
                                           for i in range(plan.n_meta)]
    if with_neighbor:
        coo = plan.batch_edges.tocoo()
        pairs += [(int(i), int(j)) for i, j in zip(coo.row, coo.col)]
    need = nt  # floor: an all-empty mask still carries nt sentinels
    for i, j in pairs:
        idx = concat_batch_indices(plan, i, j)
        sub = W[idx][:, idx].tocoo()
        if sub.nnz == 0:
            continue
        tr = sub.row // bt
        tc = sub.col // bt
        n_active = len(np.unique(tr.astype(np.int64) * nt + tc))
        n_csr = n_active + (nt - len(np.unique(tr)))
        n_csc = n_active + (nt - len(np.unique(tc)))
        need = max(need, n_csr, n_csc)
    return int(np.ceil(need * headroom / 8.0) * 8)
