"""String-keyed component registries of the port.

The port keeps its own tables (it never writes into the reference's): a
config names a component, the registry maps the name to a callable.  Default
entries are lazy ``"module:attr"`` specs, resolved and cached on first
:meth:`Registry.get`, which keeps this module import-light.  The names are
the reference's, so a config carries over unchanged.
"""
from __future__ import annotations

import functools
import importlib
from typing import Any, Callable, Iterable

__all__ = ["Registry", "AFFINITY", "PARTITIONER", "PIPELINE", "PAIRWISE",
           "OPTIMIZER", "resolve_pairwise"]


class Registry:
    """A named string→component table with lazy ``"module:attr"`` entries."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Any] = {}

    def register(self, name: str, component: Any = None):
        """Register ``component`` under ``name`` (directly, as a lazy
        ``"pkg.mod:attr"`` spec, or as a decorator); re-registering
        overwrites."""
        if component is None:
            def deco(fn):
                self._entries[name] = fn
                return fn
            return deco
        self._entries[name] = component
        return component

    def get(self, name: str) -> Any:
        """Resolve ``name``; raises ``KeyError`` listing known names."""
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} component {name!r}; "
                f"registered: {self.names()}")
        entry = self._entries[name]
        if isinstance(entry, str):
            mod_name, _, attr = entry.partition(":")
            entry = getattr(importlib.import_module(mod_name), attr)
            self._entries[name] = entry
        return entry

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterable[str]:
        return iter(self.names())

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, names={self.names()})"


#: ``(X, *, k, sigma, ...) -> AffinityGraph``
AFFINITY = Registry("affinity")
AFFINITY.register("knn_rbf", "repro_torch.core.affinity:build_affinity_graph")

#: ``(W, n_parts, *, tol, coarsen_to, seed) -> PartitionResult``
PARTITIONER = Registry("partitioner")
PARTITIONER.register("multilevel", "repro_torch.core.partition:partition_graph")
PARTITIONER.register("multilevel_loop",
                     "repro_torch.core.partition:partition_graph_loop")

#: ``(corpus, graph, plan, *, n_workers, seed, ...) -> epoch_fn`` yielding
#: host ``SSLBatch``es for one epoch.
PIPELINE = Registry("pipeline")
PIPELINE.register("meta_batch",
                  "repro_torch.data.pipeline:make_meta_batch_pipeline")
PIPELINE.register("graph_batch",
                  "repro_torch.data.pipeline:make_graph_batch_pipeline")
PIPELINE.register("random_batch",
                  "repro_torch.data.pipeline:make_random_batch_pipeline")
PIPELINE.register("metabatch_stream",
                  "repro_torch.data.pipeline:make_metabatch_stream_pipeline")

#: ``(logp, W) -> Σ_ij W_ij·Hc(p_i, p_j)``, or for entries with the
#: ``full_regularizer`` marker ``(logp, W, γ, κ) -> `` the whole Eq.-3/4
#: regularizer:
#:   * ``"ref"``    — the plain cross term (autograd through torch ops);
#:   * ``"pallas"`` — the cross term through the K1 kernel and its K2/K3
#:     VJP (the reference's name for its Pallas cross-term entry);
#:   * ``"fused"``  — the fused regularizer kernel K1 with its VJP;
#:   * ``"blocksparse"`` — the tile-skipping kernels with a ``layout=``
#:     (a later slice; raises), the dense fused path without one;
#:   * ``"auto"``   — the Hopper kernels for CUDA tensors, the plain
#:     version for CPU tensors.
PAIRWISE = Registry("pairwise")
PAIRWISE.register("ref", "repro_torch.kernels.ref:graph_reg_pairwise_ref")
PAIRWISE.register("pallas", "repro_torch.kernels.ops:graph_reg_cross_vjp")
PAIRWISE.register("fused", "repro_torch.kernels.ops:graph_regularizer_fused")
PAIRWISE.register("blocksparse",
                  "repro_torch.kernels.ops:graph_regularizer_blocksparse")
PAIRWISE.register("auto", "repro_torch.kernels.ops:graph_regularizer_auto")

#: ``(**hyper) -> repro_torch.optim.Optimizer``
OPTIMIZER = Registry("optimizer")
OPTIMIZER.register("adagrad", "repro_torch.optim:adagrad")
OPTIMIZER.register("adam", "repro_torch.optim:adam")
OPTIMIZER.register("sgd", "repro_torch.optim:sgd")


def resolve_pairwise(pairwise: str | Callable | None, *,
                     tiles=None) -> Callable | None:
    """Resolve a pairwise-kernel *name* to its implementation.

    ``None`` and already-resolved callables pass through.  ``tiles`` (a
    :class:`repro_torch.kernels.tuning.TileSpec`) rides along on every call
    of entries that advertise ``accepts_tiles``.
    """
    if pairwise is None or callable(pairwise):
        return pairwise
    impl = PAIRWISE.get(pairwise)
    if tiles is not None and getattr(impl, "accepts_tiles", False):
        @functools.wraps(impl)   # copies full_regularizer/accepts_tiles too
        def tiled(*args, _impl=impl, _tiles=tiles, **kw):
            kw.setdefault("tiles", _tiles)
            return _impl(*args, **kw)
        return tiled
    return impl
