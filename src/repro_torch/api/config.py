"""Frozen, validated, serializable experiment configs.

The same dataclasses, fields and validation as the reference package's
``repro.api.config``, so one config document drives either package; here
``ObjectiveConfig.hyper()`` and ``.tiles()`` build this package's objects.
The ``sync_mesh`` and ``async_ps`` strategies belong to a later slice of
the port: their settings are kept for the round trip, and the port's entry
points refuse them.

One ``ExperimentConfig`` captures everything the paper's pipeline needs —
corpus synthesis, affinity graph, balanced partition, meta-batch synthesis,
the Eq.-3 objective, and the training loop — as plain data.  Components are
referenced *by name* and resolved through ``repro_torch.api.registry``, so a config
is a complete, hashable, JSON-round-trippable description of an experiment:

    cfg = ExperimentConfig(objective=ObjectiveConfig(gamma=1.0))
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg

Every sub-config validates its fields in ``__post_init__`` (fail at
construction, not three layers deep in the trainer).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "DataConfig",
    "GraphConfig",
    "PartitionConfig",
    "BatchConfig",
    "RepartitionConfig",
    "ObjectiveConfig",
    "TrainConfig",
    "ExecutionConfig",
    "ResilienceConfig",
    "OnlineConfig",
    "ExperimentConfig",
]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _from_dict(cls, d: dict[str, Any]):
    """Reconstruct a (flat) dataclass from a dict, rejecting unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    _require(not unknown,
             f"{cls.__name__}: unknown keys {sorted(unknown)}; "
             f"expected a subset of {sorted(names)}")
    return cls(**d)


@dataclass(frozen=True)
class DataConfig:
    """Synthetic TIMIT-like corpus (``repro_torch.data.make_corpus``) + label drop.

    ``n`` training points plus ``round(n * test_fraction)`` held-out test
    points are drawn from one generative manifold (the paper's §3 protocol);
    ``label_ratio`` of the training labels stay visible (§3: 2%–100%).
    """

    n: int = 4000
    n_classes: int = 16
    input_dim: int = 128
    manifold_dim: int = 10
    structure: str = "filaments"
    label_ratio: float = 0.02
    test_fraction: float = 0.25
    seed: int = 0

    def __post_init__(self):
        _require(self.n > 0, f"n must be positive, got {self.n}")
        _require(self.n_classes > 1, "need at least 2 classes")
        _require(self.input_dim > 0 and self.manifold_dim > 0,
                 "dims must be positive")
        _require(self.structure in ("filaments", "blobs"),
                 f"unknown structure {self.structure!r}")
        _require(0.0 < self.label_ratio <= 1.0,
                 f"label_ratio must be in (0, 1], got {self.label_ratio}")
        _require(0.0 <= self.test_fraction < 1.0,
                 f"test_fraction must be in [0, 1), got {self.test_fraction}")


@dataclass(frozen=True)
class GraphConfig:
    """k-NN affinity graph (paper §3): ``builder`` names an AFFINITY entry.

    ``construction`` picks the streaming top-k search backend: ``"host"``
    (numpy, column-streamed) or ``"device"`` (the streaming top-k kernel
    K8 on the experiment's device; its plain version on the CPU) — both
    exact, neither materializes the N×N distance matrix.
    """

    builder: str = "knn_rbf"
    k: int = 10
    sigma: float | None = None    # None = self-tuning bandwidth
    construction: str = "host"

    def __post_init__(self):
        _require(self.k > 0, f"k must be positive, got {self.k}")
        _require(self.sigma is None or self.sigma > 0,
                 f"sigma must be positive or None, got {self.sigma}")
        _require(self.construction in ("host", "device"),
                 f"construction must be 'host' or 'device', "
                 f"got {self.construction!r}")


@dataclass(frozen=True)
class PartitionConfig:
    """Balanced min-edge-cut partition (paper §1.1, Fig. 1b)."""

    method: str = "multilevel"    # PARTITIONER registry entry
    tol: float = 0.15             # balance tolerance
    coarsen_to: int = 60          # nodes-per-part target to stop coarsening

    def __post_init__(self):
        _require(self.tol >= 0, f"tol must be >= 0, got {self.tol}")
        _require(self.coarsen_to > 0,
                 f"coarsen_to must be positive, got {self.coarsen_to}")


@dataclass(frozen=True)
class BatchConfig:
    """Meta-batch synthesis (paper §2) and the training-batch pipeline.

    ``pipeline`` names a PIPELINE registry entry: ``"meta_batch"`` (the
    paper's method, static plan), ``"metabatch_stream"`` (the same §2
    stream as a first-class stage, required for ``RepartitionConfig``),
    ``"graph_batch"`` (pure partitioned batches — the §2 low-entropy
    baseline; pair with ``shuffle_blocks=False``), or ``"random_batch"``
    (the Fig.-1a regime).
    """

    pipeline: str = "meta_batch"
    batch_size: int = 512
    with_neighbor: bool = True    # concatenate the Eq.-6 sampled neighbour
    shuffle_blocks: bool = True   # random mini-block grouping (§2.1 step 2)
    pad_factor: float = 2.4
    pad_headroom: float = 1.25    # metabatch_stream: pinned-pad slack so
                                  # re-partitioned plans fit jitted shapes
    layout_bt: int | None = None  # tile edge of the per-batch BlockLayout
                                  # (block-sparse regularizer); None = no
                                  # layout attached, dense kernels only

    def __post_init__(self):
        _require(self.batch_size > 0,
                 f"batch_size must be positive, got {self.batch_size}")
        _require(self.pad_factor >= 1.0,
                 f"pad_factor must be >= 1, got {self.pad_factor}")
        _require(self.pad_headroom >= 1.0,
                 f"pad_headroom must be >= 1, got {self.pad_headroom}")
        _require(self.layout_bt is None
                 or (isinstance(self.layout_bt, int) and self.layout_bt > 0),
                 f"layout_bt must be a positive int or None, "
                 f"got {self.layout_bt!r}")
        _require(not (self.pipeline == "graph_batch" and self.shuffle_blocks),
                 "pipeline='graph_batch' is the consecutive-mini-block "
                 "baseline; set shuffle_blocks=False (shuffled blocks would "
                 "silently turn it into neighbour-less meta-batches)")


@dataclass(frozen=True)
class RepartitionConfig:
    """Stochastic re-partitioning of the §2 meta-batch plan between epochs.

    Requires ``BatchConfig.pipeline="metabatch_stream"``.  Every
    ``every_n_epochs`` epochs a background thread re-synthesizes the whole
    plan — balanced partition with ``matching_temperature``-perturbed
    (Gumbel) coarsening, fresh mini-block grouping, fresh Eq.-6 batch graph
    — under a deterministic per-epoch seed stream derived from ``seed``, and
    the engine's next epoch consumes it without a device sync.
    ``every_n_epochs=0`` (default) keeps the plan static.

    ``reuse_hierarchy`` (default True) caches the partitioner's coarsening
    hierarchy across epochs: each replan re-draws only the chain's top
    levels plus a temperature-scaled perturbation and re-runs refinement
    around the delta, instead of rebuilding the whole multilevel chain
    from scratch.  Plans stay bit-reproducible per ``(seed, epoch)`` —
    the hierarchy is a pure function of the graph and this config, never
    of the epoch.  Set False to force from-scratch replans (also the
    automatic fallback when the configured partitioner does not accept
    ``reuse=``).
    """

    every_n_epochs: int = 0
    matching_temperature: float = 0.5
    seed: int = 0
    reuse_hierarchy: bool = True

    def __post_init__(self):
        _require(self.every_n_epochs >= 0,
                 f"every_n_epochs must be >= 0, got {self.every_n_epochs}")
        _require(self.matching_temperature >= 0,
                 f"matching_temperature must be >= 0, "
                 f"got {self.matching_temperature}")
        _require(isinstance(self.reuse_hierarchy, bool),
                 f"reuse_hierarchy must be a bool, "
                 f"got {self.reuse_hierarchy!r}")

    @property
    def active(self) -> bool:
        return self.every_n_epochs > 0


@dataclass(frozen=True)
class ObjectiveConfig:
    """Eq.-2/3 hyper-parameters plus the pairwise-kernel selection.

    ``pairwise`` names a PAIRWISE registry entry — ``"ref"`` (plain
    version), ``"pallas"`` (cross-term kernel; the name is the
    reference's), ``"fused"`` (fused regularizer kernel, fwd + analytic
    VJP), ``"blocksparse"`` (the tile-skipping kernels K4–K7; needs
    ``BatchConfig.layout_bt``) or ``"auto"`` (the GPU kernels for CUDA
    tensors, the plain version on the CPU; block-sparse with a layout).
    ``gamma=kappa=0`` recovers the fully-supervised baseline.

    ``tile_bi``/``tile_bj``/``tile_bc`` pin kernel block sizes (rows ×
    affinity-columns × class-chunk); ``None`` auto-selects.  The Hopper
    kernels have fixed block shapes and refuse a pinned size, except the
    block-sparse kernels' ``bi``, which is the layout's tile edge.
    """

    gamma: float = 1.0            # graph-regularizer weight γ
    kappa: float = 1e-4           # entropy-regularizer weight κ
    weight_decay: float = 1e-5    # ℓ2 weight λ
    pairwise: str = "auto"
    tile_bi: int | None = None
    tile_bj: int | None = None
    tile_bc: int | None = None

    def __post_init__(self):
        _require(self.gamma >= 0 and self.kappa >= 0
                 and self.weight_decay >= 0,
                 "gamma, kappa and weight_decay must all be >= 0, got "
                 f"({self.gamma}, {self.kappa}, {self.weight_decay})")
        for name in ("tile_bi", "tile_bj", "tile_bc"):
            v = getattr(self, name)
            _require(v is None or (isinstance(v, int) and v > 0),
                     f"{name} must be a positive int or None, got {v!r}")

    def hyper(self):
        """The ``repro_torch.core.ssl_loss.SSLHyper`` this config describes."""
        from repro_torch.core.ssl_loss import SSLHyper
        return SSLHyper(gamma=self.gamma, kappa=self.kappa,
                        weight_decay=self.weight_decay)

    def tiles(self):
        """The pinned-tile ``TileSpec`` (or None when fully auto)."""
        if self.tile_bi is None and self.tile_bj is None \
                and self.tile_bc is None:
            return None
        from repro_torch.kernels.tuning import TileSpec
        return TileSpec(bi=self.tile_bi, bj=self.tile_bj, bc=self.tile_bc)


@dataclass(frozen=True)
class TrainConfig:
    """Model size, optimizer and loop settings (paper §3 protocol).

    ``execution="sequential"`` runs the vmapped k-worker step on the default
    device; ``"parallel"`` additionally shards the leading worker axis over a
    ``("data",)`` mesh of the available devices — the launcher's pjit
    pattern, which *is* the paper's synchronous k-worker SGD.  (Back-compat
    shorthand: ``"parallel"`` selects the engine's ``"sync_mesh"`` strategy
    unless ``ExecutionConfig.strategy`` overrides it.)
    """

    n_epochs: int = 10
    n_workers: int = 1
    execution: str = "sequential"
    base_lr: float = 1e-3
    lr_reset_epochs: int = 10     # paper: lr = base·k for 10 epochs, then base
    dropout: float = 0.2
    optimizer: str = "adagrad"    # OPTIMIZER registry entry
    hidden_dim: int = 512
    n_hidden: int = 3
    seed: int = 0

    def __post_init__(self):
        _require(self.n_epochs >= 0,
                 f"n_epochs must be >= 0, got {self.n_epochs}")
        _require(self.n_workers >= 1,
                 f"n_workers must be >= 1, got {self.n_workers}")
        _require(self.execution in ("sequential", "parallel"),
                 f"execution must be 'sequential' or 'parallel', "
                 f"got {self.execution!r}")
        _require(self.base_lr > 0, f"base_lr must be > 0, got {self.base_lr}")
        _require(self.lr_reset_epochs >= 1, "lr_reset_epochs must be >= 1")
        _require(0.0 <= self.dropout < 1.0,
                 f"dropout must be in [0, 1), got {self.dropout}")
        _require(self.hidden_dim > 0 and self.n_hidden >= 1,
                 "model dims must be positive")


@dataclass(frozen=True)
class ExecutionConfig:
    """How the unified engine executes the loop (see ``repro_torch.train.engine``).

    ``strategy`` names a STRATEGY registry entry (``"sequential"``,
    ``"sync_mesh"``, ``"async_ps"``); ``None`` (the default) infers it from
    the legacy ``TrainConfig.execution`` shorthand — an *explicit* name
    always wins.  ``scan_chunk`` steps make one chunk (0 = the whole
    epoch), the unit in which the fault sites and the guard windows count,
    as in the reference, which compiles each chunk into one ``lax.scan``;
    the eager engine only groups them.  ``prefetch`` batches are staged
    host→device ahead of compute (0 turns prefetching off).  ``checkpoint_every > 0`` saves the full engine
    carry every N epochs into ``checkpoint_dir``; ``resume=True`` restores
    the newest checkpoint exactly (rng and step included).
    ``max_staleness`` is the ``async_ps`` worker lag in server steps.
    """

    strategy: str | None = None
    scan_chunk: int = 16
    prefetch: int = 2
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None
    resume: bool = False
    max_staleness: int = 2

    def __post_init__(self):
        _require(self.strategy is None
                 or (isinstance(self.strategy, str) and self.strategy != ""),
                 f"strategy must be a non-empty name or None (= infer from "
                 f"TrainConfig.execution), got {self.strategy!r}")
        _require(self.scan_chunk >= 0,
                 f"scan_chunk must be >= 0, got {self.scan_chunk}")
        _require(self.prefetch >= 0,
                 f"prefetch must be >= 0, got {self.prefetch}")
        _require(self.checkpoint_every >= 0,
                 f"checkpoint_every must be >= 0, got {self.checkpoint_every}")
        _require(self.checkpoint_every == 0 or self.checkpoint_dir,
                 "checkpoint_every > 0 requires checkpoint_dir")
        _require(self.max_staleness >= 1,
                 f"max_staleness must be >= 1, got {self.max_staleness}")


@dataclass(frozen=True)
class ResilienceConfig:
    """Failure semantics for the engine/stream/checkpoint layers
    (see the reference's ``repro.resilience`` and README "Failure semantics").

    ``nonfinite_guard`` arms a two-speed non-finite guard: the hot scan
    body is unchanged, each chunk ends with one finiteness reduction, and
    the engine resolves windows of ``guard_window`` chunks with a single
    guard-scalar fetch.  A window that saw NaN/inf is replayed from its
    start with a strict body that skips exactly the poisoned updates
    (params/opt_state/rng/step untouched, as if the batch had never been
    drawn), counting into ``guard/skipped_total`` in the history; with
    ``halt_after_consecutive=K > 0`` a ``NonFiniteHaltError`` is raised
    on host once K steps in a row were skipped (checked at window edges).
    Larger ``guard_window`` amortizes the fetch further but retains that
    many chunks of batches (the port keeps their pinned host copies and
    copies them to the device again) for a possible replay.

    ``checkpoint_checksums`` writes/verifies a ``.sha256`` sidecar per
    checkpoint; a corrupt LATEST target then falls back to the newest
    valid checkpoint on resume.  ``keep_last=N > 0`` prunes all but the
    newest N checkpoints after each save.

    ``max_retries``/``backoff_base``/``backoff_max`` parameterize the
    thread supervisor for the prefetch producer and the replan builder
    (deterministic jitter derives from ``seed``).  ``hang_timeout`` is the
    per-attempt watchdog for the prefetch producer's device-put (a fast
    operation — a fraction of a second is generous); the replan builder
    gets its own ``replan_hang_timeout`` budget, since a legitimate
    re-synthesis takes orders of magnitude longer than a device-put.
    ``max_replan_failures`` consecutive failed replan targets disable
    background re-partitioning (plan stays static) instead of spinning a
    warning+thread per epoch.

    ``drop_overstale`` makes ``async_ps`` drop gradients from workers
    whose snapshot age exceeds ``max_staleness`` (dead/straggler) and
    renormalize the survivors' contribution.
    """

    nonfinite_guard: bool = False
    guard_window: int = 4
    halt_after_consecutive: int = 0
    checkpoint_checksums: bool = True
    keep_last: int = 0
    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    hang_timeout: float | None = None
    replan_hang_timeout: float | None = None
    drop_overstale: bool = False
    max_replan_failures: int = 3
    seed: int = 0

    def __post_init__(self):
        _require(self.guard_window >= 1,
                 f"guard_window must be >= 1, got {self.guard_window}")
        _require(self.halt_after_consecutive >= 0,
                 f"halt_after_consecutive must be >= 0, "
                 f"got {self.halt_after_consecutive}")
        _require(self.halt_after_consecutive == 0 or self.nonfinite_guard,
                 "halt_after_consecutive > 0 requires nonfinite_guard=True "
                 "(the halt policy counts guard-skipped steps)")
        _require(self.keep_last >= 0,
                 f"keep_last must be >= 0, got {self.keep_last}")
        _require(self.max_retries >= 0,
                 f"max_retries must be >= 0, got {self.max_retries}")
        _require(0 <= self.backoff_base <= self.backoff_max,
                 f"need 0 <= backoff_base <= backoff_max, got "
                 f"({self.backoff_base}, {self.backoff_max})")
        _require(self.hang_timeout is None or self.hang_timeout > 0,
                 f"hang_timeout must be positive or None, "
                 f"got {self.hang_timeout}")
        _require(self.replan_hang_timeout is None
                 or self.replan_hang_timeout > 0,
                 f"replan_hang_timeout must be positive or None, "
                 f"got {self.replan_hang_timeout}")
        _require(self.max_replan_failures >= 0,
                 f"max_replan_failures must be >= 0, "
                 f"got {self.max_replan_failures}")


@dataclass(frozen=True)
class OnlineConfig:
    """Embedding-space graph refresh + dynamic corpus (the reference's ``repro.online``).

    ``refresh_every=N > 0`` turns the loop on: during every N-th epoch the
    engine captures the model's hidden activations (``tap`` selects the
    hidden layer, negative = from the top) and at the epoch boundary the
    affinity graph is rebuilt over those embeddings and lock-published to
    the streaming pipeline — the graph tracks the *model's* similarity
    rather than the frozen input features (Bai et al. 1511.06104).  When
    edge churn is at most ``churn_threshold`` the existing partition is
    delta-repaired around the changed edges; above it the plan is
    re-synthesized from scratch.

    ``bandwidth="per_node"`` swaps the global self-tuning sigma for
    Zelnik-Manor local scaling (per-node k-th-NN bandwidth — the learned-
    bandwidth option of Sharma & Jones 2306.07098); ``k=None`` inherits
    ``GraphConfig.k``.  ``insert_batch`` is the default chunk size for
    ``OnlineManager.insert`` callers.  Requires
    ``BatchConfig.pipeline="metabatch_stream"`` — only the streaming
    pipeline can swap graphs between epochs.
    """

    refresh_every: int = 0
    tap: int = -1                 # hidden layer to capture (negative = top)
    insert_batch: int = 32
    churn_threshold: float = 0.25
    bandwidth: str = "global"
    k: int | None = None          # None = inherit GraphConfig.k
    backend: str = "host"         # top-k search backend for the refresh

    def __post_init__(self):
        _require(self.refresh_every >= 0,
                 f"refresh_every must be >= 0, got {self.refresh_every}")
        _require(self.insert_batch > 0,
                 f"insert_batch must be positive, got {self.insert_batch}")
        _require(0.0 <= self.churn_threshold <= 1.0,
                 f"churn_threshold must be in [0, 1], "
                 f"got {self.churn_threshold}")
        _require(self.bandwidth in ("global", "per_node"),
                 f"bandwidth must be 'global' or 'per_node', "
                 f"got {self.bandwidth!r}")
        _require(self.k is None or (isinstance(self.k, int) and self.k > 0),
                 f"k must be a positive int or None, got {self.k!r}")
        _require(self.backend in ("host", "device"),
                 f"backend must be 'host' or 'device', got {self.backend!r}")

    @property
    def active(self) -> bool:
        return self.refresh_every > 0


@dataclass(frozen=True)
class ExperimentConfig:
    """The single config object an ``Experiment`` runs from."""

    name: str = "ssl"
    data: DataConfig = field(default_factory=DataConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    partition: PartitionConfig = field(default_factory=PartitionConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    repartition: RepartitionConfig = field(
        default_factory=RepartitionConfig)
    objective: ObjectiveConfig = field(default_factory=ObjectiveConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    execution: ExecutionConfig = field(default_factory=ExecutionConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    online: OnlineConfig = field(default_factory=OnlineConfig)

    def __post_init__(self):
        _require(not (self.online.active
                      and self.batch.pipeline != "metabatch_stream"),
                 f"online.refresh_every={self.online.refresh_every} requires "
                 f"batch.pipeline='metabatch_stream' (got "
                 f"{self.batch.pipeline!r}); only the streaming pipeline "
                 "can swap graphs between epochs")
        _require(not (self.online.active
                      and not -self.train.n_hidden
                      <= self.online.tap < self.train.n_hidden),
                 f"online.tap={self.online.tap} out of range for "
                 f"n_hidden={self.train.n_hidden} hidden layers")
        _require(not (self.repartition.active
                      and self.batch.pipeline != "metabatch_stream"),
                 f"repartition.every_n_epochs="
                 f"{self.repartition.every_n_epochs} requires "
                 f"batch.pipeline='metabatch_stream' (got "
                 f"{self.batch.pipeline!r}); only the streaming pipeline "
                 "can swap plans between epochs")
        _require(self.batch.layout_bt is None
                 or self.objective.tile_bi is None
                 or self.batch.layout_bt == self.objective.tile_bi,
                 f"batch.layout_bt={self.batch.layout_bt} and "
                 f"objective.tile_bi={self.objective.tile_bi} disagree; the "
                 "block-sparse kernel's tile edge must match the layout the "
                 "pipeline builds (leave tile_bi unset to inherit layout_bt)")
        _require(not (self.objective.pairwise == "blocksparse"
                      and self.batch.layout_bt is None),
                 "objective.pairwise='blocksparse' without batch.layout_bt "
                 "would silently run the dense fused path every step; set "
                 "layout_bt (or use pairwise='auto')")

    @classmethod
    def _sections(cls) -> dict[str, type]:
        """Section name → sub-config class, derived from the field list
        (every section field is declared with ``default_factory=<class>``)."""
        return {f.name: f.default_factory for f in dataclasses.fields(cls)
                if f.default_factory is not dataclasses.MISSING}

    def to_dict(self) -> dict[str, Any]:
        """Plain nested-dict form (JSON/YAML-safe)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        """Inverse of :meth:`to_dict`; missing sections take defaults,
        unknown sections or keys raise ``ValueError``."""
        sections = cls._sections()
        unknown = set(d) - set(sections) - {"name"}
        _require(not unknown,
                 f"ExperimentConfig: unknown sections {sorted(unknown)}")
        kw: dict[str, Any] = {}
        if "name" in d:
            kw["name"] = d["name"]
        for sec, sec_cls in sections.items():
            if sec in d:
                val = d[sec]
                kw[sec] = (val if isinstance(val, sec_cls)
                           else _from_dict(sec_cls, dict(val)))
        return cls(**kw)
