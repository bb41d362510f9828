"""Carry parameters, optimizer state and decode caches between the two
packages.

``to_torch(tree, device)`` turns the reference's params, AdaGrad state or
decode cache (numpy leaves) into the port's; ``to_numpy`` turns them back.

The reference keeps its pytrees as nests of dicts and lists with array
leaves — DNN params ``{"layers": [{"w": (in, out), "b": (out,)}]}``, LM
params ``{"embed", "final_norm", "superblocks": [<layer dict with a
leading n_superblocks axis>]}``, AdaGrad state ``{"accum": <params
nest>}`` — and the port keeps the same nests with tensor leaves, so a
conversion is a leaf-by-leaf copy and both packages can start a step from
the same state.  A dataclass node
is carried field by field; the reference's decode states become the
port's classes of the same name (``KVCache``, ``MambaState``,
``SLSTMState``, ``MLSTMState``), and ``to_numpy`` keeps the port's class
with numpy fields, which the caller rebuilds as the reference's class of
that name (this module cannot name the reference's classes).
``leaf_paths`` flattens either package's trees alike, so two trees
compare leaf by leaf.  bfloat16 arrays
(``ml_dtypes.bfloat16``, what numpy holds for a JAX bf16 array) become
``torch.bfloat16`` tensors bit for bit, through a 16-bit integer view, and
back.  Give the reference side as numpy arrays (``jax.device_get`` of its
pytree); this module never imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["to_torch", "to_numpy", "leaf_paths"]


def _fields(tree, convert) -> dict:
    return {f.name: convert(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _is_dataclass_node(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def _state_classes() -> dict[str, type]:
    """The port's decode-state dataclasses by name."""
    from .models.layers.attention import KVCache
    from .models.layers.mamba import MambaState
    from .models.layers.xlstm import MLSTMState, SLSTMState
    return {c.__name__: c
            for c in (KVCache, MambaState, SLSTMState, MLSTMState)}


def to_torch(tree, device: str | torch.device = "cpu"):
    """Nest of numpy arrays (or tensors) -> same nest of dtype-preserving
    tensors on ``device``; always copies, so the result owns its storage."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if _is_dataclass_node(tree):
        cls = _state_classes().get(type(tree).__name__, type(tree))
        return cls(**_fields(tree, lambda v: to_torch(v, device)))
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, (int, float)):
        return tree
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def to_numpy(tree):
    """Nest of tensors -> same nest of numpy arrays (on the host) that own
    their storage; bfloat16 tensors become ``ml_dtypes.bfloat16`` arrays,
    and a dataclass node keeps its class."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if _is_dataclass_node(tree):
        return type(tree)(**_fields(tree, to_numpy))
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(tree)


def leaf_paths(tree, path: str = "") -> list[tuple[str, object]]:
    """(path, leaf) of every leaf of a nest of dicts (keys sorted), lists,
    tuples and dataclass nodes (fields in order, each named with its
    class: ``/layers/0/KVCache.k``), ``None`` skipped.  The walk reads
    neither package's types, so the reference's tree and the port's give
    equal paths where their structures and class names agree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaf_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaf_paths(v, f"{path}/{i}")]
    if _is_dataclass_node(tree):
        name = type(tree).__name__
        return [x for f in dataclasses.fields(tree)
                for x in leaf_paths(getattr(tree, f.name),
                                    f"{path}/{name}.{f.name}")]
    return [] if tree is None else [(path, tree)]
