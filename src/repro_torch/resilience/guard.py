"""Non-finite guard primitives (the reference's ``repro.resilience.guard``).

The engine runs the reference's two-speed guard on an eager loop.  The hot
path runs the plain step; once per window of ``guard_window`` chunks of
``scan_chunk`` steps one :func:`all_finite` reduction over the window's
per-step metrics and the state at its end folds into a ``tainted`` flag,
and one host fetch reads it.  Only a tainted window is replayed from the
backup of the strategy's carry taken at its start (params, optimizer
state, generator state and step; ``async_ps``'s snapshots, ages and t),
one step at a time: a poisoned step keeps the carry it started from, as
if the batch had never been drawn, and is counted.  The guard state the engine keeps is::

    (skipped_total, consecutive, worst_consecutive, tainted)

three int32 scalars and a bool on the device.  ``skipped_total`` lands in
the epoch history; ``worst_consecutive`` is a running maximum the engine
checks at window edges to realize the halt-after-K-consecutive policy
(:class:`NonFiniteHaltError`) without a per-step device sync.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ssl_loss import tree_leaves

__all__ = ["NonFiniteHaltError", "all_finite", "guard_init"]


class NonFiniteHaltError(RuntimeError):
    """Raised by the engine when ``halt_after_consecutive`` or more steps
    in a row produced a non-finite update (the data or the optimization is
    broken, not one unlucky batch)."""


def guard_init(device: str | torch.device = "cpu"):
    """Fresh ``(skipped_total, consecutive, worst_consecutive, tainted)``
    state on ``device``: four distinct 0-d tensors."""
    return (torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every floating leaf of ``tree`` (a nest of dicts,
    lists and tuples of tensors, arrays or numbers) is finite.

    Integer and bool leaves (step counters, generator states, tile lists)
    are skipped: they cannot hold NaN or inf.  The result lives on the
    first floating tensor leaf's device, and no value leaves the device.
    """
    checks = []
    for leaf in tree_leaves(tree):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        if t.is_floating_point() or t.is_complex():
            checks.append(torch.isfinite(t).all())
    if not checks:
        return torch.tensor(True)
    if len(checks) == 1:
        return checks[0]
    return torch.stack([c.to(checks[0].device) for c in checks]).all()
