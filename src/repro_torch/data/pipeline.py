"""Training-batch pipeline: meta-batches -> device-ready arrays.

Each step yields the concatenated batch ``M_c = [M_r, M_s]`` of §2.3:
features, labels, label mask, and the dense affinity sub-block ``W`` for the
concatenated index set.  For ``k``-worker data parallelism, each step packs
``k`` independent concatenated batches along a leading axis — the launcher
shards that axis over the mesh's data dimension, which *is* the paper's
Eq.-7 parallel decomposition.

Batches are padded to a fixed size (2B) so shapes are static under jit;
padding rows carry zero affinity and zero label mask.

Two meta-batch pipelines share the assembly code:

  * :class:`MetaBatchPipeline` — the static plan, fixed for the whole run;
  * :class:`MetaBatchStream`  — the streaming stage ("metabatch_stream" in
    the PIPELINE registry): between epochs a background thread re-runs the
    §2 synthesis (partition → mini-blocks → meta-batches → batch graph)
    with a fresh epoch seed and Gumbel-perturbed matching, and the new plan
    is swapped in at the epoch boundary — host-side only, no device sync —
    so batch composition stays stochastic across epochs as the paper's
    SGD argument requires.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Iterator

import numpy as np

from repro_torch.core.affinity import AffinityGraph
from repro_torch.core.metabatch import (MetaBatchPlan, NeighborSampler,
                                  block_layout, epoch_plan_seed,
                                  plan_layout_budget, resynthesize_plan)
from repro_torch.core.partition import HierarchyCache
from repro_torch.core.partition import partition_graph as partition_graph_default
from repro_torch.data.synthetic_timit import SyntheticCorpus
from repro_torch.introspect import accepts_kwarg

__all__ = ["SSLBatch", "MetaBatchPipeline", "MetaBatchStream",
           "random_batch_pipeline", "make_meta_batch_pipeline",
           "make_graph_batch_pipeline", "make_random_batch_pipeline",
           "make_metabatch_stream_pipeline"]


@dataclasses.dataclass(frozen=True)
class SSLBatch:
    x: np.ndarray            # (k, P, d)    P = padded concat-batch size
    y: np.ndarray            # (k, P)
    label_mask: np.ndarray   # (k, P) float {0,1}
    W: np.ndarray            # (k, P, P) dense affinity block
    valid: np.ndarray        # (k, P) bool (padding indicator)
    # Optional block-sparse layout of W (``BlockLayout.arrays()`` per
    # worker, stacked along k) — present only when the pipeline was built
    # with ``layout_bt``; ``None`` fields are dropped before the batch
    # reaches a device (``engine._as_host_dict``).
    tile_rows: np.ndarray | None = None    # (k, T) int32, row-major list
    tile_cols: np.ndarray | None = None    # (k, T) int32
    tile_valid: np.ndarray | None = None   # (k, T) int32 {0,1}
    tile_crows: np.ndarray | None = None   # (k, T) int32, col-major list
    tile_ccols: np.ndarray | None = None   # (k, T) int32
    tile_cvalid: np.ndarray | None = None  # (k, T) int32 {0,1}
    tile_occ: np.ndarray | None = None     # (k, nt, nt) int32 occupancy


def _pad_to(a: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    pad = size - a.shape[axis]
    if pad <= 0:
        return a[(slice(None),) * axis + (slice(0, size),)]
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


def _assemble(corpus: SyntheticCorpus, graph: AffinityGraph,
              idx: np.ndarray, P: int, *, layout_bt: int | None = None,
              layout_len: int | None = None):
    """Padded (x, y, label_mask, W, valid) arrays for one concat batch.

    With ``layout_bt`` the tuple is extended by the 7 ``BlockLayout``
    arrays of the padded W (``layout_len`` pins the static tile-list
    length so every batch of the run shares one jitted shape).  This runs
    on the pipeline/prefetch producer thread — zero per-step layout work
    on the training path.
    """
    W = _pad_to(_pad_to(graph.dense_block(idx), P, 0), P, 1)
    base = (_pad_to(corpus.X[idx], P),
            _pad_to(corpus.y[idx], P),
            _pad_to(corpus.label_mask[idx].astype(np.float32), P),
            W,
            _pad_to(np.ones(len(idx), bool), P))
    if layout_bt is None:
        return base
    return base + block_layout(W, layout_bt, list_len=layout_len).arrays()


def _stack_group(parts) -> SSLBatch:
    cols = [np.stack(c) for c in zip(*parts)]
    return SSLBatch(*cols)   # 5 base columns, +7 tile columns with a layout


def _epoch_groups(order: np.ndarray, k: int) -> Iterator[np.ndarray]:
    """Consecutive groups of ``k`` meta-batch ids covering *all* of ``order``.

    A tail of ``len(order) % k`` ids is padded by wrap-around from the head
    of the permutation (those head ids train twice that epoch) — never
    silently dropped: the order is permuted per epoch, so dropping the tail
    would starve a random node subset of gradient every epoch.  With fewer
    than ``k`` ids no group is yielded (wrap-around there would duplicate a
    meta-batch *within* one group; the engine already warns on an empty
    epoch).
    """
    n = len(order)
    for s in range(0, n - k + 1, k):
        yield order[s : s + k]
    tail = n % k
    if tail and n >= k:
        yield np.concatenate([order[n - tail:], order[: k - tail]])


class MetaBatchPipeline:
    """Iterates (meta-batch, sampled-neighbour) pairs for k workers."""

    def __init__(self, corpus: SyntheticCorpus, graph: AffinityGraph,
                 plan: MetaBatchPlan, *, n_workers: int = 1,
                 pad_factor: float = 2.4, with_neighbor: bool = True,
                 seed: int = 0, layout_bt: int | None = None):
        self.corpus = corpus
        self.graph = graph
        self.plan = plan
        self.k = n_workers
        self.with_neighbor = with_neighbor
        self.sampler = NeighborSampler(plan.batch_edges, seed=seed)
        self.rng = np.random.default_rng(seed + 1)
        # Static padded size: max meta-batch + max neighbour, rounded up.
        mmax = max(len(m) for m in plan.meta_batches)
        self.pad = int(np.ceil(
            (2 * mmax if with_neighbor else mmax) / 64) * 64)
        # Static plan => the exact tile-list budget is known up front (no
        # headroom needed: the plan never changes).
        self.layout_bt = layout_bt
        self.layout_len = (None if layout_bt is None else plan_layout_budget(
            plan, graph, layout_bt, self.pad, with_neighbor=with_neighbor,
            headroom=1.0))

    def _one(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        j = self.sampler.sample(i) if self.with_neighbor else None
        main = self.plan.meta_batches[i]
        idx = (main if j is None
               else np.concatenate([main, self.plan.meta_batches[j]]))
        return idx, main

    def epoch(self) -> Iterator[SSLBatch]:
        """One pass over all meta-batches, k at a time (tail wrap-padded)."""
        order = self.rng.permutation(self.plan.n_meta)
        for group in _epoch_groups(order, self.k):
            parts = []
            for i in group:
                idx, _ = self._one(int(i))
                parts.append(_assemble(self.corpus, self.graph, idx,
                                       self.pad, layout_bt=self.layout_bt,
                                       layout_len=self.layout_len))
            yield _stack_group(parts)


class MetaBatchStream:
    """First-class streaming meta-batch stage with stochastic
    re-partitioning (PIPELINE registry name ``"metabatch_stream"``).

    Per epoch it yields the same Eq.-6/§2.3 (meta-batch, sampled-neighbour)
    concat batches as :class:`MetaBatchPipeline`, k workers wide (the Eq.-7
    decomposition lives on the leading axis).  With an active
    ``repartition`` config, while epoch ``e`` trains, a background thread
    re-synthesizes the plan for the next re-partition epoch — vectorized
    partition with ``matching_temperature``-perturbed coarsening, fresh
    mini-block grouping, fresh batch graph — and the swap happens at the
    epoch boundary on the host: the engine's prefetch iterator simply reads
    the new plan, no device sync, no shape change (the pad is pinned with
    ``pad_headroom`` so jitted shapes survive every swap; a plan that would
    not fit is rejected with a warning and the previous plan is kept).
    With ``repartition.reuse_hierarchy`` (the default) the partitioner's
    coarsening hierarchy is cached across epochs (``HierarchyCache``) and
    each replan runs incrementally — top-level Gumbel redraw + perturbed
    cached labels + delta-seeded refinement — instead of from scratch.
    A replan that raises warns with the exception type and text and keeps
    the previous plan; a later successful swap re-arms the retry for
    previously failed targets.  With a ``supervisor`` each synthesis gets
    bounded retries with backoff first, and ``max_replan_failures``
    consecutive failed targets disable background replans for the rest of
    the run (one final warning, plan static) instead of spinning a thread
    and repeating the same warning every retry window.

    Determinism: the plan for epoch ``e`` is a pure function of
    ``(graph, config, repartition.seed, e)`` and the per-epoch batch order
    and neighbour draws derive from ``(seed, e)``, so identical seeds are
    bit-reproducible — run to run, with or without the background thread.

    Thread-safety: each epoch's generator body runs on whatever thread
    consumes it (under the engine that is the *prefetch producer* thread,
    a different one every epoch), while the replan builder runs on its own
    thread.  All mutable stream state — ``plan``, ``graph``, ``corpus``,
    ``_hierarchy``, ``_pending``, ``_plan_epoch``, ``swaps``, ``_failed``,
    ``_epoch_counter``, ``last_epoch_indices`` — is therefore published
    under ``_lock``; the builder thread snapshots the swappable
    graph/hierarchy under the lock at synthesis start (batch size and class
    count are construction-time immutables).

    Online refresh / dynamic corpora: :meth:`swap_graph` lock-publishes a
    whole new ``(graph, plan[, corpus][, hierarchy])`` tuple through the
    same path replans use — the epoch that starts next reads the new graph
    and plan together (``repro_torch.online`` drives this from the engine's
    epoch-end hook).
    """

    def __init__(self, corpus: SyntheticCorpus, graph: AffinityGraph,
                 plan: MetaBatchPlan, *, n_workers: int = 1,
                 with_neighbor: bool = True, seed: int = 0,
                 repartition=None, partitioner=None, tol: float = 0.15,
                 coarsen_to: int = 60, shuffle_blocks: bool = True,
                 pad_headroom: float = 1.25, record_indices: bool = False,
                 hierarchy_cache: HierarchyCache | None = None,
                 supervisor=None, fault_injector=None,
                 max_replan_failures: int = 3,
                 layout_bt: int | None = None):
        self.corpus = corpus
        self.graph = graph
        self.plan = plan
        self.k = n_workers
        self.with_neighbor = with_neighbor
        self.seed = seed
        self.repartition = repartition
        self.partitioner = partitioner
        # Resilience collaborators (construction-time immutables): the
        # supervisor retries/backs off each synthesis attempt, the fault
        # injector arms deterministic replan failures for chaos tests, and
        # ``max_replan_failures`` consecutive failed *targets* disable
        # background re-partitioning entirely (one final warning) so a
        # persistently broken partitioner stops spinning a thread — and
        # emitting an identical warning — every retry window.
        self.supervisor = supervisor
        self.fault_injector = fault_injector
        self.max_replan_failures = int(max_replan_failures)
        self.tol = tol
        self.coarsen_to = coarsen_to
        self.shuffle_blocks = shuffle_blocks
        self.record_indices = record_indices
        self.last_epoch_indices: list[list[np.ndarray]] | None = None
        self.swaps = 0                     # plans swapped in so far
        every = getattr(repartition, "every_n_epochs", 0) if repartition \
            else 0
        self.every = int(every)
        self._hierarchy: HierarchyCache | None = None
        if self.every > 0:
            # Fail at construction, not as a once-per-epoch warning from
            # the background thread: an incapable partitioner would leave
            # the plan silently static forever.
            temp = getattr(repartition, "matching_temperature", 0.0)
            if temp != 0.0 and not accepts_kwarg(
                    partitioner or partition_graph_default, "temperature"):
                raise ValueError(
                    f"repartition.matching_temperature={temp} but the "
                    f"configured partitioner does not accept temperature=; "
                    f"use the vectorized 'multilevel' partitioner or set "
                    f"matching_temperature=0")
            if getattr(repartition, "reuse_hierarchy", True):
                # Hierarchy-cached incremental replans (the default).  The
                # cache is a pure function of (graph, partition config,
                # repartition seed) — never of the epoch — so plans stay
                # bit-reproducible per (seed, epoch) regardless of when it
                # is first (lazily) built.  A partitioner without reuse=
                # support degrades to from-scratch replans with a warning,
                # not an error: reuse is an optimization, not semantics.
                if accepts_kwarg(partitioner or partition_graph_default,
                                 "reuse"):
                    self._hierarchy = hierarchy_cache or HierarchyCache(
                        graph.W, tol=tol, coarsen_to=coarsen_to,
                        seed=int(getattr(repartition, "seed", 0)))
                else:
                    warnings.warn(
                        "repartition.reuse_hierarchy=True but the "
                        "configured partitioner does not accept reuse=; "
                        "replans will run from scratch", stacklevel=2)
        mmax = max(len(m) for m in plan.meta_batches)
        base = 2 * mmax if with_neighbor else mmax
        headroom = pad_headroom if self.every > 0 else 1.0
        self.pad = int(np.ceil(base * headroom / 64) * 64)
        # Tile-list budget pinned like the pad: with re-partitioning on,
        # ``pad_headroom`` also buys slack for denser re-planned layouts;
        # ``_fits`` rejects a plan that would overflow either pin.
        self.layout_bt = layout_bt
        self.layout_len = (None if layout_bt is None else plan_layout_budget(
            plan, graph, layout_bt, self.pad, with_neighbor=with_neighbor,
            headroom=headroom))
        # Snapshots for the builder thread: replans preserve batch size and
        # class count, so the thread never reads the swappable ``plan``.
        self._batch_size = plan.batch_size
        self._n_classes = plan.n_classes
        self._lock = threading.Lock()
        self._epoch_counter = 0
        self._plan_epoch = 0               # epoch the current plan targets
        self._failed: set[int] = set()     # targets that failed to swap
        self._pending: tuple[int, threading.Thread, dict] | None = None
        self._consec_failures = 0          # distinct targets failed in a row
        self._replan_disabled = False      # tripped at max_replan_failures

    # ------------------------------------------------------------ internals
    def _fits(self, plan: MetaBatchPlan, graph: AffinityGraph) -> bool:
        mmax = max(len(m) for m in plan.meta_batches)
        if (2 * mmax if self.with_neighbor else mmax) > self.pad:
            return False
        if self.layout_bt is not None:
            need = plan_layout_budget(
                plan, graph, self.layout_bt, self.pad,
                with_neighbor=self.with_neighbor, headroom=1.0)
            if need > self.layout_len:
                return False
        return True

    def _synthesize(self, epoch: int) -> MetaBatchPlan:
        # Runs on the builder thread: snapshots the swappable
        # graph/hierarchy under the lock, then synthesizes lock-free (it
        # never reads the swappable ``plan`` — batch size and class count
        # are construction-time immutables).
        if self.fault_injector is not None:
            self.fault_injector.maybe_fail("replan", epoch=epoch)
        with self._lock:
            graph, hierarchy = self.graph, self._hierarchy
        rep = self.repartition
        return resynthesize_plan(
            graph, self._batch_size, self._n_classes,
            epoch=epoch, base_seed=getattr(rep, "seed", 0),
            temperature=getattr(rep, "matching_temperature", 0.0),
            tol=self.tol, shuffle_blocks=self.shuffle_blocks,
            partitioner=self.partitioner, coarsen_to=self.coarsen_to,
            reuse=hierarchy)

    def _call_synthesize(self, epoch: int) -> MetaBatchPlan:
        """One supervised synthesis: with a supervisor, transient failures
        are retried with backoff before the degrade path ever fires."""
        if self.supervisor is not None:
            return self.supervisor.call(self._synthesize, epoch,
                                        key=f"replan@{epoch}")
        return self._synthesize(epoch)

    def _note_failure(self, target: int, err: BaseException, *,
                      stacklevel: int) -> None:
        """Degrade: keep the previous plan, count the failure, and trip the
        disable switch after ``max_replan_failures`` consecutive ones."""
        with self._lock:
            self._failed.add(target)
            self._consec_failures += 1
            n = self._consec_failures
            tripped = (self.max_replan_failures > 0
                       and n >= self.max_replan_failures
                       and not self._replan_disabled)
            if tripped:
                self._replan_disabled = True
        warnings.warn(
            f"re-partitioning for epoch {target} failed with "
            f"{type(err).__name__}: {err}; keeping the previous plan "
            f"(consecutive failure {n})", stacklevel=stacklevel + 1)
        if tripped:
            warnings.warn(
                f"{n} consecutive re-partitioning failures: disabling "
                "background replans for the rest of the run (the current "
                "plan stays static); fix the partitioner and restart to "
                "re-enable", stacklevel=stacklevel + 1)

    def _launch(self, target_epoch: int) -> None:
        box: dict = {}

        def work():
            try:
                box["plan"] = self._call_synthesize(target_epoch)
            except BaseException as e:  # noqa: BLE001 — surfaced at swap
                box["error"] = e

        t = threading.Thread(target=work, daemon=True,
                             name="metabatch-repartition")
        t.start()
        # Lock-publish the handoff: the epoch that collects this pending
        # tuple runs on a *different* prefetch-producer thread, so the
        # write must be visible there (the join in ``_collect`` then
        # orders the builder's box contents).
        with self._lock:
            self._pending = (target_epoch, t, box)

    def _next_target(self, epoch: int) -> int:
        """First re-partition epoch strictly after ``epoch``."""
        return (epoch // self.every + 1) * self.every

    def _swap_in(self, plan: MetaBatchPlan, target: int) -> bool:
        with self._lock:
            graph = self.graph
        if not self._fits(plan, graph):
            warnings.warn(
                f"re-partitioned plan for epoch {target} exceeds the "
                f"pinned pad {self.pad} or tile-list budget "
                f"{self.layout_len} (raise pad_headroom — "
                f"BatchConfig.pad_headroom in the config API); keeping the "
                "previous plan", stacklevel=4)
            return False
        with self._lock:
            self.plan = plan
            self._plan_epoch = target
            self.swaps += 1
            # A successful swap re-arms the retry for previously-failed
            # targets: a transient failure (OOM on the background thread, a
            # flaky data mount) must not pin those epochs to the stale plan
            # forever once the stream has proven healthy again.  It also
            # resets the consecutive-failure count feeding the disable
            # threshold — only an *unbroken* run of failures disables.
            self._failed.clear()
            self._consec_failures = 0
        return True

    def _collect(self, epoch: int) -> None:
        """Swap in the background plan scheduled for ``epoch``, if any."""
        with self._lock:
            pending = self._pending
            if pending is None or pending[0] != epoch:
                return
            self._pending = None
        _, t, box = pending
        t.join()   # happens-before: orders the builder's writes to box
        if "error" in box:
            self._note_failure(epoch, box["error"], stacklevel=3)
            return
        if not self._swap_in(box["plan"], epoch):
            with self._lock:
                self._failed.add(epoch)

    # ------------------------------------------------------------- online
    def snapshot(self) -> tuple:
        """One-lock read of the swappable state the online manager needs:
        ``(plan, graph, corpus, hierarchy, last_epoch_indices)``."""
        with self._lock:
            return (self.plan, self.graph, self.corpus, self._hierarchy,
                    self.last_epoch_indices)

    def swap_graph(self, graph: AffinityGraph, plan: MetaBatchPlan, *,
                   corpus: SyntheticCorpus | None = None,
                   hierarchy: HierarchyCache | None = None) -> bool:
        """Lock-publish a new affinity graph (and plan built against it).

        The online-refresh / insert / evict handoff, sharing the replan
        swap discipline: the epoch that starts next reads the new
        ``(graph, plan, corpus)`` together, mid-epoch generators keep their
        snapshots, and a plan that would overflow the pinned pad/tile-list
        budget is rejected with a warning (``False``; the stream keeps the
        old graph).  ``corpus`` rides along for dynamic ingestion (insert/
        evict change the node set).  ``hierarchy`` replaces the replan
        cache — pass a fresh (lazily built) :class:`HierarchyCache` for the
        new graph, or ``None`` to drop caching until the next refresh; the
        old cache's levels describe the old topology and must not survive.
        Any in-flight background replan is discarded: it was synthesized
        against the graph this call replaces.
        """
        if not self._fits(plan, graph):
            warnings.warn(
                f"online graph swap rejected: plan exceeds the pinned pad "
                f"{self.pad} or tile-list budget {self.layout_len} (raise "
                f"pad_headroom); keeping the previous graph", stacklevel=2)
            return False
        with self._lock:
            self.graph = graph
            self.plan = plan
            if corpus is not None:
                self.corpus = corpus
            self._hierarchy = hierarchy
            self._pending = None
            self.swaps += 1
            self._failed.clear()
            self._consec_failures = 0
        return True

    # ----------------------------------------------------------------- epoch
    def epoch(self, epoch: int | None = None,
              n_epochs: int | None = None) -> Iterator[SSLBatch]:
        """One pass over the *current* plan's meta-batches, k at a time.

        Epoch-pure: ``epoch`` pins the epoch index (the engine passes it)
        and any epoch's batches are reproducible from that index alone —
        jumping straight to epoch ``e`` (checkpoint resume) synthesizes the
        plan the uninterrupted run would have been using.  When omitted, an
        internal counter advances by one per call.  ``n_epochs`` bounds the
        run so no background plan is computed past the final epoch.
        """
        with self._lock:
            e = self._epoch_counter if epoch is None else int(epoch)
            self._epoch_counter = e + 1
        if self.every > 0:
            self._collect(e)
            target = (e // self.every) * self.every
            with self._lock:
                need_sync = (target > 0 and self._plan_epoch != target
                             and target not in self._failed
                             and not self._replan_disabled)
                if need_sync:
                    self._pending = None
            if need_sync:
                # Jumped over the swap epoch (resume, or out-of-order
                # call): synthesize the plan epoch ``e`` should be using,
                # synchronously.
                try:
                    plan = self._call_synthesize(target)
                except Exception as err:  # noqa: BLE001 — degrade like bg
                    self._note_failure(target, err, stacklevel=2)
                else:
                    if not self._swap_in(plan, target):
                        with self._lock:
                            self._failed.add(target)
            nxt = self._next_target(e)
            with self._lock:
                may_launch = (self._pending is None
                              and not self._replan_disabled
                              and (n_epochs is None or nxt < n_epochs))
            # Epochs are consumed one at a time, so only this generator
            # launches — the lock above is for visibility, not exclusion.
            if may_launch:
                self._launch(nxt)
        with self._lock:
            # One snapshot for the whole epoch: plan, graph and corpus swap
            # together (replans and online refreshes), never mid-epoch.
            plan, graph, corpus = self.plan, self.graph, self.corpus
        sampler = NeighborSampler(
            plan.batch_edges, seed=epoch_plan_seed(self.seed + 1, e))
        order_rng = np.random.default_rng([self.seed, 2, e])
        order = order_rng.permutation(plan.n_meta)
        recorded: list[list[np.ndarray]] = []
        for group in _epoch_groups(order, self.k):
            parts, idxs = [], []
            for i in group:
                j = sampler.sample(int(i)) if self.with_neighbor else None
                main = plan.meta_batches[int(i)]
                idx = (main if j is None else np.concatenate(
                    [main, plan.meta_batches[j]]))
                idxs.append(idx)
                parts.append(_assemble(corpus, graph, idx,
                                       self.pad, layout_bt=self.layout_bt,
                                       layout_len=self.layout_len))
            if self.record_indices:
                recorded.append(idxs)
            yield _stack_group(parts)
        if self.record_indices:
            with self._lock:
                self.last_epoch_indices = recorded


# ---------------------------------------------------------------------------
# PIPELINE-registry factories.  Uniform signature
#   (corpus, graph, plan, *, batch_size, n_workers, seed, ...) -> epoch_fn
# so the experiment layer can swap batching strategies by config name.
# ---------------------------------------------------------------------------
def make_meta_batch_pipeline(corpus, graph, plan, *, n_workers: int = 1,
                             seed: int = 0, with_neighbor: bool = True,
                             pad_factor: float = 2.4,
                             layout_bt: int | None = None, **_):
    """The paper's method (§2): meta-batches + Eq.-6 sampled neighbours."""
    return MetaBatchPipeline(corpus, graph, plan, n_workers=n_workers,
                             pad_factor=pad_factor,
                             with_neighbor=with_neighbor, seed=seed,
                             layout_bt=layout_bt).epoch


def make_graph_batch_pipeline(corpus, graph, plan, *, n_workers: int = 1,
                              seed: int = 0, pad_factor: float = 2.4,
                              layout_bt: int | None = None, **_):
    """Pure graph-partitioned batches — the §2 low-entropy baseline.

    Pair with a plan built with ``shuffle_blocks=False`` so each batch is a
    run of consecutive (homogeneous) mini-blocks.
    """
    return MetaBatchPipeline(corpus, graph, plan, n_workers=n_workers,
                             pad_factor=pad_factor, with_neighbor=False,
                             seed=seed, layout_bt=layout_bt).epoch


def make_metabatch_stream_pipeline(corpus, graph, plan, *,
                                   n_workers: int = 1, seed: int = 0,
                                   with_neighbor: bool = True,
                                   repartition=None, partitioner=None,
                                   tol: float = 0.15, coarsen_to: int = 60,
                                   shuffle_blocks: bool = True,
                                   pad_headroom: float = 1.25,
                                   record_indices: bool = False,
                                   hierarchy_cache=None, supervisor=None,
                                   fault_injector=None,
                                   max_replan_failures: int = 3,
                                   layout_bt: int | None = None, **_):
    """The §2 stream as a first-class pipeline: NeighborSampler + meta-batch
    assembly feeding the engine directly, with optional between-epoch
    stochastic re-partitioning (``repartition`` = a ``RepartitionConfig``-
    shaped object: every_n_epochs / matching_temperature / seed).

    The returned epoch factory accepts optional ``epoch=`` / ``n_epochs=``
    keywords — the engine passes the true epoch index (so re-partition
    scheduling stays exact across checkpoint resume, with no replay drain)
    and the horizon (so no plan is pre-computed past the final epoch) —
    and exposes the underlying :class:`MetaBatchStream` as ``.stream``
    (tests, introspection).
    """
    stream = MetaBatchStream(
        corpus, graph, plan, n_workers=n_workers, seed=seed,
        with_neighbor=with_neighbor, repartition=repartition,
        partitioner=partitioner, tol=tol, coarsen_to=coarsen_to,
        shuffle_blocks=shuffle_blocks, pad_headroom=pad_headroom,
        record_indices=record_indices, hierarchy_cache=hierarchy_cache,
        supervisor=supervisor, fault_injector=fault_injector,
        max_replan_failures=max_replan_failures, layout_bt=layout_bt)

    def epoch_fn(epoch: int | None = None, n_epochs: int | None = None):
        return stream.epoch(epoch=epoch, n_epochs=n_epochs)

    epoch_fn.stream = stream
    return epoch_fn


def make_random_batch_pipeline(corpus, graph, plan=None, *,
                               batch_size: int | None = None,
                               n_workers: int = 1, seed: int = 0,
                               steps_per_epoch: int | None = None, **_):
    """Randomly shuffled batches (Fig. 1a regime) as an epoch factory.

    ``plan`` is optional (no partitioning needed); when present it pins the
    batch size and epoch length to the meta-batch pipeline's for apples-to-
    apples ablations.
    """
    bs = batch_size or (plan.batch_size if plan is not None else 512)
    if corpus.n < bs * n_workers:
        raise ValueError(
            f"random_batch pipeline needs n >= batch_size * n_workers "
            f"({corpus.n} < {bs} * {n_workers}); shrink the batch or the "
            "worker count")
    if steps_per_epoch is None:
        steps_per_epoch = (plan.n_meta // n_workers if plan is not None
                           else max(1, corpus.n // (bs * n_workers)))
    it = random_batch_pipeline(corpus, graph, bs, n_workers=n_workers,
                               seed=seed)

    def epoch():
        return (next(it) for _ in range(steps_per_epoch))

    return epoch


def random_batch_pipeline(corpus: SyntheticCorpus, graph: AffinityGraph,
                          batch_size: int, *, n_workers: int = 1,
                          seed: int = 0) -> Iterator[SSLBatch]:
    """Baseline: randomly shuffled batches (paper's Fig. 1a regime) — the
    affinity block is still looked up, but is near-empty by construction."""
    rng = np.random.default_rng(seed)
    n = corpus.n
    if n < batch_size * n_workers:
        # The per-epoch loop below would never yield — fail loudly instead
        # of spinning through permutations forever.
        raise ValueError(
            f"corpus too small for the requested batches: "
            f"n={n} < batch_size*n_workers={batch_size * n_workers}")
    P = int(np.ceil(batch_size / 64) * 64)
    while True:
        perm = rng.permutation(n)
        for s in range(0, n - batch_size * n_workers + 1,
                       batch_size * n_workers):
            xs, ys, ms, Ws, vs = [], [], [], [], []
            for w in range(n_workers):
                idx = perm[s + w * batch_size : s + (w + 1) * batch_size]
                xs.append(_pad_to(corpus.X[idx], P))
                ys.append(_pad_to(corpus.y[idx], P))
                ms.append(_pad_to(corpus.label_mask[idx].astype(np.float32), P))
                Ws.append(_pad_to(_pad_to(graph.dense_block(idx), P, 0), P, 1))
                vs.append(_pad_to(np.ones(len(idx), bool), P))
            yield SSLBatch(x=np.stack(xs), y=np.stack(ys),
                           label_mask=np.stack(ms), W=np.stack(Ws),
                           valid=np.stack(vs))
