"""Carry parameters and optimizer state between the two packages.

``to_torch(params_np, device)`` turns the reference's params or AdaGrad
state (numpy leaves) into the port's; ``to_numpy`` turns them back.

The reference keeps its pytrees as nests of dicts and lists with array
leaves — params ``{"layers": [{"w": (in, out), "b": (out,)}]}``, AdaGrad
state ``{"accum": <params nest>}`` — and the port keeps the same nests with
tensor leaves, so a conversion is a leaf-by-leaf copy.  Give the reference
side as numpy arrays (``jax.device_get`` of its pytree); this module never
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_torch", "to_numpy"]


def to_torch(tree, device: str | torch.device = "cpu"):
    """Nest of numpy arrays (or tensors) -> same nest of float32-preserving
    tensors on ``device``; always copies, so the result owns its storage."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, (int, float)):
        return tree
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    """Nest of tensors -> same nest of numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
