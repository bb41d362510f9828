"""Sharding strategies: how params, batches and caches map onto the mesh.

Port of ``repro/sharding/specs.py``.  Three selectable strategies:

  dp       — the PAPER-FAITHFUL baseline.  §2.3's k-worker synchronous SGD:
             parameters replicated on every chip, the batch axis sharded over
             ("pod","data"); the gradient all-reduce plays the parameter
             server.  The 'model' axis is idle — exactly as the paper's
             scheme would run on this mesh.
  fsdp     — beyond-paper: ZeRO-style parameter/optimizer sharding over the
             data axes (largest divisible dim of each param).
  fsdp_tp  — beyond-paper: fsdp + tensor/expert parallelism over the 'model'
             axis (heads / d_ff / vocab / experts), name-driven rules.

A spec is a :class:`PartitionSpec`: one entry per tensor dim, ``None``, a
mesh axis name, or a tuple of names.  The rules read only ``mesh.shape``
(a mapping from axis name to size) and ``mesh.axis_names``, so they take
an :class:`~repro_torch.launch.mesh.AbstractMesh` (``AbstractMesh.of``
gives one for a ``DeviceMesh``) or any object with those two
attributes.  :func:`to_placements` turns a
spec into DTensor placements, one per mesh dim, and :func:`local_shape`
gives the shard a chip holds.

The tree walkers name a node by its dict key, its list index or its
dataclass field, bare: a cache leaf is ``layers/0/k``, and the cache rules
fire on it as their docstring says.  (The reference's walker renders a
registered dataclass field as ``.k``, so on its real cache trees the leaf
rules never fire; see ``ROADMAP.md``, properties.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["STRATEGIES", "PartitionSpec", "batch_axes", "fsdp_axes",
           "spec_for_param", "spec_for_cache", "param_shardings",
           "cache_shardings", "train_batch_shardings", "tree_paths",
           "to_placements", "local_shape"]

STRATEGIES = ("dp", "fsdp", "fsdp_tp")


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of axis names (sharded over their product, in order)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fsdp_axes(mesh) -> tuple[str, ...]:
    return batch_axes(mesh)


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    return int(math.prod(mesh.shape[a] for a in axes))


# --------------------------------------------------------------- params
# Name-driven tensor-parallel dim preferences: leaf name -> candidate dims
# (index into the *unstacked* shape; stacked params shift by +1).
_TP_DIM_RULES: dict[str, tuple[int, ...]] = {
    "table": (0,),          # vocab
    "lm_head": (1,),        # vocab
    "modality_proj": (1,),
    "wq": (1,), "wk": (1,), "wv": (1,),   # head dim
    "wo": (0,),                            # head dim
    "wg": (1, 2), "wu": (1, 2), "wd": (0, 1),   # mlp (d,f)/(f,d); moe (E,d,f)
    "router": (1,),
    "in_proj": (1,), "out_proj": (0,), "x_proj": (0,),
    "conv_w": (1,), "conv_b": (0,), "dt_proj_w": (1,), "dt_proj_b": (0,),
    "A_log": (0,), "D": (0,),
    "up": (1,), "down": (0,), "up_g": (1,), "up_u": (1,),
    "wi": (0,), "wf": (0,),
}
_MOE_LEAVES = {"wg", "wu", "wd"}  # under a "moe" parent: prefer expert dim 0


def _one(axes: tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def spec_for_param(path: str, shape: tuple[int, ...], mesh,
                   strategy: str) -> PartitionSpec:
    if strategy == "dp" or len(shape) == 0:
        return P()
    leaf = path.rsplit("/", 1)[-1]
    stacked = "superblocks" in path
    off = 1 if stacked else 0
    spec: list[Any] = [None] * len(shape)
    model_n = mesh.shape.get("model", 1)
    fa = fsdp_axes(mesh)
    fsdp_n = _axes_size(mesh, fa)

    # -- tensor parallel dim (fsdp_tp only) --
    if strategy == "fsdp_tp":
        cands = list(_TP_DIM_RULES.get(leaf, ()))
        if "/moe/" in path + "/" and leaf in _MOE_LEAVES:
            # Expert-parallel first; else Megatron column-parallel: shard the
            # d_ff dim of up/gate (dim 2 of (E,d,f)) so only the down-proj
            # (row-parallel, f contracting) all-reduces the small (·,d)
            # output — never the (·,f) intermediate.
            cands = [0, 2] if leaf in ("wu", "wg") else [0, 1]
        for c in cands:
            d = c + off
            if d < len(shape) and shape[d] % model_n == 0 and shape[d] >= model_n:
                spec[d] = "model"
                break

    # -- fsdp dim: largest remaining divisible dim (skip scan dim) --
    order = sorted(range(off, len(shape)), key=lambda d: -shape[d])
    for d in order:
        if spec[d] is None and shape[d] % fsdp_n == 0 and shape[d] >= fsdp_n:
            spec[d] = _one(fa)
            break
    return P(*spec)


# ---------------------------------------------------------------- caches
def spec_for_cache(path: str, shape: tuple[int, ...], mesh,
                   batch_size: int, strategy: str) -> PartitionSpec:
    """Decode-cache sharding.

    Batch dim over data axes when divisible; for global_batch=1
    (long_500k) the KV sequence dim is sharded over data instead
    (sequence-parallel decode — softmax reductions become collectives).
    KV-head dims go on 'model' when divisible under fsdp_tp.
    """
    leaf = path.rsplit("/", 1)[-1]
    stacked = "first" not in path.split("/")
    off = 1 if stacked else 0        # leading L dim from stacking
    ba = batch_axes(mesh)
    bn = _axes_size(mesh, ba)
    model_n = mesh.shape.get("model", 1) if strategy == "fsdp_tp" else 1
    spec: list[Any] = [None] * len(shape)
    b_dim = off                       # batch dim position
    batch_ok = (b_dim < len(shape) and shape[b_dim] % bn == 0
                and shape[b_dim] >= bn)
    if batch_ok:
        spec[b_dim] = _one(ba)
    if leaf in ("k", "v", "positions", "valid"):
        s_dim = off + 1
        if not batch_ok and s_dim < len(shape) and shape[s_dim] % bn == 0:
            spec[s_dim] = _one(ba)
        if leaf in ("k", "v") and model_n > 1:
            kv_dim = off + 2
            if shape[kv_dim] % model_n == 0 and shape[kv_dim] >= model_n:
                spec[kv_dim] = "model"
    elif leaf in ("conv", "ssm") and model_n > 1:
        di_dim = off + 2 if leaf == "conv" else off + 1
        if di_dim < len(shape) and shape[di_dim] % model_n == 0:
            spec[di_dim] = "model"
    return P(*spec)


# ----------------------------------------------------------- tree walkers
def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nest of dicts, lists, tuples and
    dataclasses, in order: dict keys, list indices and dataclass fields
    joined by ``/``, each bare (``layers/0/k``).  Non-tensor leaves
    (numbers, generators) are skipped."""
    def join(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return [pair for k, v in tree.items()
                for pair in tree_paths(v, join(k))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in tree_paths(v, join(i))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for f in dataclasses.fields(tree)
                for pair in tree_paths(getattr(tree, f.name), join(f.name))]
    return [(prefix, tree)] if isinstance(tree, torch.Tensor) else []


def param_shardings(params, mesh, strategy: str) -> dict[str, PartitionSpec]:
    """``{path: spec}`` of every tensor leaf of a param nest (or of an
    optimizer state that mirrors it)."""
    return {path: spec_for_param(path, tuple(t.shape), mesh, strategy)
            for path, t in tree_paths(params)}


def train_batch_shardings(batch, mesh) -> dict[str, PartitionSpec]:
    """Shard the leading (batch/group) axis of every train input over the
    data axes; everything else replicated."""
    ba = batch_axes(mesh)
    bn = _axes_size(mesh, ba)
    out = {}
    for path, t in tree_paths(batch):
        ok = t.dim() and t.shape[0] % bn == 0 and t.shape[0] >= bn
        out[path] = P(_one(ba)) if ok else P()
    return out


def cache_shardings(cache, mesh, batch_size: int,
                    strategy: str) -> dict[str, PartitionSpec]:
    return {path: spec_for_cache(path, tuple(t.shape), mesh, batch_size,
                                 strategy)
            for path, t in tree_paths(cache)}


# ------------------------------------------------------------ placements
def _dim_axes(spec: PartitionSpec) -> dict[str, int]:
    """Mesh axis name -> the tensor dim it shards."""
    out = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            out[name] = d
    return out


def to_placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec``, one per mesh dim in
    ``mesh.axis_names`` order: ``Shard(d)`` where that axis shards tensor
    dim d, ``Replicate()`` elsewhere.  A dim sharded over ``("pod",
    "data")`` gives ``Shard(d)`` on both mesh dims, split in that order."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = _dim_axes(spec)
    return [Shard(by_axis[a]) if a in by_axis else Replicate()
            for a in mesh.axis_names]


def local_shape(shape: tuple[int, ...], spec: PartitionSpec,
                mesh) -> tuple[int, ...]:
    """The shard of a ``shape`` tensor that mesh coordinate 0 holds: each
    sharded dim split over its axes in mesh order, rounded up (as DTensor
    splits an uneven dim; the rules above shard only dims that divide)."""
    out = list(shape)
    by_axis = _dim_axes(spec)
    for a in mesh.axis_names:
        if a in by_axis:
            d = by_axis[a]
            out[d] = -(-out[d] // mesh.shape[a])
    return tuple(out)
