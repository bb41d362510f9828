"""The port's ``Experiment`` runner — one entry point for every paper scenario.

``Experiment(config, device="cuda").run()`` drives the whole pipeline from
an ``ExperimentConfig``: corpus → affinity graph → balanced partition →
meta-batch synthesis → Eq.-3 objective → sequential, k-worker synchronous
(``sync_mesh``) or stale-gradient (``async_ps``) SGD on the GPU, every
stage resolved by name through :mod:`repro_torch.api.registry`.  The host
half (``build``) is the reference's logic on the port's copies of the
numpy/scipy modules; ``run`` trains with :func:`train_dnn_ssl`.

Pre-built artifacts (corpus, graph, plan) can be injected through the
constructor so sweeps don't re-run graph construction per point, and a
fault injector (``repro_torch.resilience.FaultInjector``) for chaos runs.
With ``OnlineConfig.refresh_every > 0`` the experiment holds an
:class:`~repro_torch.online.OnlineManager` (``self.online``) that rebuilds
the graph from the model's hidden activations between epochs.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.registry import (AFFINITY, OPTIMIZER, PAIRWISE,
                                      PARTITIONER, PIPELINE, resolve_pairwise)
from repro_torch.device import resolve_device

__all__ = ["Experiment", "ExperimentResult"]


@dataclasses.dataclass
class ExperimentResult:
    """Structured output of one :meth:`Experiment.run`."""

    config: ExperimentConfig
    history: list[dict]       # per-epoch metric rows from the trainer
    final: dict               # last epoch's row ({} if no epoch produced one)
    seconds: float            # wall-clock for the training loop
    params: Any = None        # trained model parameters (nest of tensors)

    def best(self, key: str = "eval/acc") -> float:
        """Best value of ``key`` across epochs (e.g. peak test accuracy)."""
        vals = [h[key] for h in self.history if key in h]
        if not vals:
            raise KeyError(f"metric {key!r} not present in history")
        return max(vals)


def _accepts(fn: Callable, name: str) -> bool:
    """True when ``fn`` takes a keyword ``name`` (or ``**kwargs``)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):   # non-introspectable callable
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class Experiment:
    """Config-driven experiment: ``build()`` assembles, ``run()`` trains.

    ``device`` defaults to ``"cuda"`` and raises at construction when no
    GPU is usable; ``device="cpu"`` runs the plain PyTorch path.
    """

    def __init__(self, config: ExperimentConfig, *, corpus=None,
                 eval_data: tuple[np.ndarray, np.ndarray] | None = None,
                 graph=None, plan=None, hierarchy_cache=None,
                 injector=None, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.corpus = corpus          # SyntheticCorpus (labels already dropped)
        self.eval_data = eval_data    # (X_test, y_test) or None
        self.graph = graph            # AffinityGraph
        self.plan = plan              # MetaBatchPlan
        self.hierarchy_cache = hierarchy_cache
        self.injector = injector      # repro_torch.resilience.FaultInjector
        self.pipeline: Callable | None = None   # epoch-factory callable
        self.online = None            # repro_torch.online.OnlineManager
        self._built = False

    # ------------------------------------------------------------------ build
    def build(self) -> "Experiment":
        """Assemble corpus, graph, plan and batch pipeline (idempotent)."""
        if self._built:
            return self
        cfg = self.config
        if self.corpus is None:
            self.corpus, self.eval_data = self._make_data()
        if self.graph is None:
            builder = AFFINITY.get(cfg.graph.builder)
            kw = {}
            if _accepts(builder, "backend"):
                kw["backend"] = cfg.graph.construction
            elif cfg.graph.construction != "host":
                raise ValueError(
                    f"graph.construction={cfg.graph.construction!r} but "
                    f"AFFINITY builder {cfg.graph.builder!r} does not "
                    f"accept a backend= argument")
            if _accepts(builder, "device"):
                kw["device"] = self.device
            self.graph = builder(self.corpus.X, k=cfg.graph.k,
                                 sigma=cfg.graph.sigma, **kw)
        if self.plan is None and cfg.batch.pipeline != "random_batch":
            from repro_torch.core.metabatch import plan_meta_batches
            self.plan = plan_meta_batches(
                self.graph, batch_size=cfg.batch.batch_size,
                n_classes=self.corpus.n_classes, seed=cfg.data.seed,
                tol=cfg.partition.tol,
                shuffle_blocks=cfg.batch.shuffle_blocks,
                partitioner=PARTITIONER.get(cfg.partition.method),
                coarsen_to=cfg.partition.coarsen_to)
        factory = PIPELINE.get(cfg.batch.pipeline)
        # The async parameter server consumes 1-worker batches round-robin
        # (k lives in the engine strategy, not the pipeline).
        pipeline_workers = (1 if self._strategy() == "async_ps"
                            else cfg.train.n_workers)
        # Extra keys are swallowed by factories that don't need them: the
        # stream pipeline retries a failed replan under the replan
        # supervisor, fires the injector's replan site and records each
        # batch's node indices for the online refresh.
        self.pipeline = factory(
            self.corpus, self.graph, self.plan,
            batch_size=cfg.batch.batch_size,
            n_workers=pipeline_workers,
            with_neighbor=cfg.batch.with_neighbor,
            pad_factor=cfg.batch.pad_factor,
            pad_headroom=cfg.batch.pad_headroom,
            seed=cfg.data.seed,
            repartition=cfg.repartition,
            partitioner=PARTITIONER.get(cfg.partition.method),
            tol=cfg.partition.tol,
            coarsen_to=cfg.partition.coarsen_to,
            shuffle_blocks=cfg.batch.shuffle_blocks,
            hierarchy_cache=self._hierarchy_cache(),
            supervisor=self._replan_supervisor(),
            fault_injector=self.injector,
            record_indices=cfg.online.active,
            layout_bt=cfg.batch.layout_bt)
        if cfg.online.active:
            self.online = self._make_online_manager()
        self._built = True
        return self

    def _make_online_manager(self):
        """The :class:`~repro_torch.online.OnlineManager` bound to this
        experiment's stream: refreshes the affinity graph from captured
        embeddings every ``online.refresh_every`` epochs (its top-k on
        this experiment's device with ``online.backend="device"``) and
        serves ``insert``/``evict`` for dynamic corpora."""
        from repro_torch.online import OnlineManager
        cfg = self.config
        return OnlineManager(
            self.pipeline.stream, self.corpus, self.graph, cfg.online,
            batch_size=cfg.batch.batch_size,
            n_classes=self.corpus.n_classes,
            tol=cfg.partition.tol, coarsen_to=cfg.partition.coarsen_to,
            shuffle_blocks=cfg.batch.shuffle_blocks,
            partitioner=PARTITIONER.get(cfg.partition.method),
            embed_fn=self._embed_fn(), seed=cfg.data.seed,
            device=self.device)

    def _embed_fn(self):
        """Chunked clean forward to the tapped hidden layer, on the params'
        device — fills capture gaps and embeds freshly inserted rows."""
        from repro_torch.models.dnn import dnn_hidden
        tap = self.config.online.tap

        @torch.no_grad()
        def embed(params, X, batch: int = 4096):
            device = params["layers"][0]["w"].device
            outs = [dnn_hidden(params, torch.from_numpy(np.ascontiguousarray(
                        X[s: s + batch], np.float32)).to(device),
                        layer=tap).cpu().numpy()
                    for s in range(0, len(X), batch)]
            return np.concatenate(outs) if outs else np.empty((0, 0))
        return embed

    def _replan_supervisor(self):
        """The reference's supervisor for the stream's replan builder:
        ``None`` when retries are configured off (the stream then degrades
        on the first failure), else retries with backoff and the
        ``replan_hang_timeout`` watchdog."""
        r = self.config.resilience
        if r.max_retries <= 0:
            return None
        from repro_torch.resilience.supervisor import RetryPolicy, Supervisor
        return Supervisor(RetryPolicy(
            max_retries=r.max_retries, backoff_base=r.backoff_base,
            backoff_max=r.backoff_max, hang_timeout=r.replan_hang_timeout,
            seed=r.seed), name="replan")

    def _hierarchy_cache(self):
        """The reference's ``HierarchyCache`` choice for hierarchy-reuse
        replans (None when re-partitioning or reuse is off)."""
        cfg = self.config
        if not (cfg.repartition.active and cfg.repartition.reuse_hierarchy):
            return None
        from repro_torch.introspect import accepts_kwarg
        if not accepts_kwarg(PARTITIONER.get(cfg.partition.method), "reuse"):
            return None
        if self.hierarchy_cache is not None:
            return self.hierarchy_cache
        from repro_torch.core.partition import HierarchyCache
        return HierarchyCache(
            self.graph.W, tol=cfg.partition.tol,
            coarsen_to=cfg.partition.coarsen_to,
            seed=cfg.repartition.seed)

    def tiles(self):
        """The tiles the pairwise entry runs with: the config's pinned ones.
        A pipeline-built block layout fixes the block-sparse kernels' tile
        edge, so ``bi`` is pinned to ``layout_bt`` as in the reference
        (config validation rejects a conflicting ``tile_bi``), but only for
        layout-aware entries: the dense Hopper kernels refuse any pinned
        size, and they never see the layout."""
        cfg = self.config
        tiles = cfg.objective.tiles()
        takes_layout = getattr(PAIRWISE.get(cfg.objective.pairwise),
                               "accepts_layout", False)
        if cfg.batch.layout_bt is None or not takes_layout:
            return tiles
        from repro_torch.kernels.tuning import TileSpec
        tiles = tiles or TileSpec()
        if tiles.bi is None:
            tiles = dataclasses.replace(tiles, bi=cfg.batch.layout_bt)
        return tiles

    def _strategy(self) -> str:
        strategy = self.config.execution.strategy
        if strategy is None:
            strategy = ("sync_mesh"
                        if self.config.train.execution == "parallel"
                        else "sequential")
        return strategy

    def _make_data(self):
        """Synthesize the train corpus + held-out test split from the config."""
        from repro_torch.data import drop_labels, make_corpus

        d = self.config.data
        n_total = d.n + int(round(d.n * d.test_fraction))
        full = make_corpus(n_total, n_classes=d.n_classes,
                           input_dim=d.input_dim,
                           manifold_dim=d.manifold_dim,
                           structure=d.structure, seed=d.seed)
        train = dataclasses.replace(
            full, X=full.X[: d.n], y=full.y[: d.n],
            label_mask=full.label_mask[: d.n])
        eval_data = ((full.X[d.n:], full.y[d.n:])
                     if n_total > d.n else None)
        if d.label_ratio < 1.0:
            train = drop_labels(train, d.label_ratio, seed=d.seed + 1)
        return train, eval_data

    # -------------------------------------------------------------------- run
    def run(self) -> ExperimentResult:
        """Train end to end and return the structured result."""
        self.build()
        from repro_torch.models.dnn import DNNConfig
        from repro_torch.train.trainer import train_dnn_ssl

        cfg = self.config
        t = cfg.train
        ex = cfg.execution
        model_cfg = DNNConfig(
            input_dim=self.corpus.X.shape[1], hidden_dim=t.hidden_dim,
            n_hidden=t.n_hidden, n_classes=self.corpus.n_classes,
            dropout=t.dropout)
        pairwise = resolve_pairwise(cfg.objective.pairwise,
                                    tiles=self.tiles())
        capture_fn = capture_epochs = on_epoch_end = None
        if self.online is not None:
            from repro_torch.models.dnn import dnn_hidden
            tap = cfg.online.tap

            def capture_fn(params, batch):
                # batch["x"] is (k_workers, P, d): the tapped layer per
                # worker row, stacked by the engine into (steps, k, P, H).
                return dnn_hidden(params, batch["x"], layer=tap)

            capture_epochs = self.online.capture_epoch
            on_epoch_end = self.online.on_epoch_end
        t0 = time.time()
        res = train_dnn_ssl(
            self.pipeline,
            cfg=model_cfg,
            hyper=cfg.objective.hyper(),
            n_epochs=t.n_epochs,
            n_workers=t.n_workers,
            base_lr=t.base_lr,
            lr_reset_epochs=t.lr_reset_epochs,
            dropout=t.dropout,
            eval_data=self.eval_data,
            seed=t.seed,
            opt=OPTIMIZER.get(t.optimizer)(),
            pairwise=pairwise,
            device=self.device,
            strategy=self._strategy(),
            scan_chunk=ex.scan_chunk,
            prefetch=ex.prefetch,
            max_staleness=ex.max_staleness,
            checkpoint_every=ex.checkpoint_every,
            checkpoint_dir=ex.checkpoint_dir,
            resume=ex.resume,
            resilience=cfg.resilience,
            injector=self.injector,
            capture_fn=capture_fn,
            capture_epochs=capture_epochs,
            on_epoch_end=on_epoch_end)
        seconds = time.time() - t0
        final = res.history[-1] if res.history else {}
        return ExperimentResult(config=cfg, history=res.history,
                                final=final, seconds=seconds,
                                params=res.params)
