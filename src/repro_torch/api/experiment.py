"""The port's ``Experiment`` runner — one entry point for every paper scenario.

``Experiment(config, device="cuda").run()`` drives the whole pipeline from
an ``ExperimentConfig``: corpus → affinity graph → balanced partition →
meta-batch synthesis → Eq.-3 objective → sequential SGD on the GPU, every
stage resolved by name through :mod:`repro_torch.api.registry`.  The host
half (``build``) is the reference's logic on the port's copies of the
numpy/scipy modules; ``run`` trains with :func:`train_dnn_ssl`.

Pre-built artifacts (corpus, graph, plan) can be injected through the
constructor so sweeps don't re-run graph construction per point.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.registry import (AFFINITY, OPTIMIZER, PARTITIONER,
                                      PIPELINE, resolve_pairwise)
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


class Experiment:
    """Config-driven experiment: ``build()`` assembles, ``run()`` trains.

    ``device`` defaults to ``"cuda"`` and raises at construction when no
    GPU is usable; ``device="cpu"`` runs the plain PyTorch path.
    """

    def __init__(self, config: ExperimentConfig, *, corpus=None,
                 eval_data: tuple[np.ndarray, np.ndarray] | None = None,
                 graph=None, plan=None, hierarchy_cache=None,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.corpus = corpus          # SyntheticCorpus (labels already dropped)
        self.eval_data = eval_data    # (X_test, y_test) or None
        self.graph = graph            # AffinityGraph
        self.plan = plan              # MetaBatchPlan
        self.hierarchy_cache = hierarchy_cache
        self.pipeline: Callable | None = None   # epoch-factory callable
        self._built = False

    # ------------------------------------------------------------------ build
    def build(self) -> "Experiment":
        """Assemble corpus, graph, plan and batch pipeline (idempotent)."""
        if self._built:
            return self
        cfg = self.config
        if cfg.online.active:
            raise NotImplementedError(
                "online graph refresh (OnlineConfig.refresh_every > 0) is not "
                "ported to repro_torch yet (engine extras slice)")
        if cfg.batch.layout_bt is not None:
            raise NotImplementedError(
                "BatchConfig.layout_bt needs the block-sparse GPU kernels "
                "(K4-K7), which are not ported yet (block-sparse batches "
                "slice)")
        if self.corpus is None:
            self.corpus, self.eval_data = self._make_data()
        if self.graph is None:
            builder = AFFINITY.get(cfg.graph.builder)
            try:
                params = inspect.signature(builder).parameters
                takes_backend = ("backend" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values()))
            except (TypeError, ValueError):   # non-introspectable callable
                takes_backend = False
            if takes_backend:
                kw = {"backend": cfg.graph.construction}
            elif cfg.graph.construction != "host":
                raise ValueError(
                    f"graph.construction={cfg.graph.construction!r} but "
                    f"AFFINITY builder {cfg.graph.builder!r} does not "
                    f"accept a backend= argument")
            else:
                kw = {}
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
        # The static meta-batch pipeline never replans, so no replan
        # supervisor is needed (supervisor=None); the stream pipeline then
        # degrades to a kept plan on its first failed replan.
        self.pipeline = factory(
            self.corpus, self.graph, self.plan,
            batch_size=cfg.batch.batch_size,
            n_workers=cfg.train.n_workers,
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
            supervisor=None,
            fault_injector=None,
            record_indices=False,
            layout_bt=None)
        self._built = True
        return self

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
                                    tiles=cfg.objective.tiles())
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
            resilience=cfg.resilience)
        seconds = time.time() - t0
        final = res.history[-1] if res.history else {}
        return ExperimentResult(config=cfg, history=res.history,
                                final=final, seconds=seconds,
                                params=res.params)
