"""Memory-bounded sequential scan with chunked rematerialisation.

Port of ``repro/models/layers/scan_utils.py``.  The reference nests two
``lax.scan``s and checkpoints the inner one, so a backward pass keeps the
carry at chunk boundaries only, O(T/C·state), and recomputes each chunk's
steps.  Here the scan is a Python loop over T; under autograd each chunk
of ``chunk`` steps runs as one non-reentrant ``torch.utils.checkpoint``.
The reference's rule for the chunk is kept: C = min(chunk, T), and a T
that C does not divide runs the plain loop.

:func:`loop_through` swaps the loop for another with the same signature
inside its scope: the dry run's analysis traces two steps of each scan
that way and weights the second by T − 1.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint


def _scan(step, carry, xs, lo: int, hi: int):
    """Steps lo..hi-1 of ``step`` over the leading axis of ``xs`` ->
    (carry, ys stacked on a new leading axis)."""
    ys = []
    for t in range(lo, hi):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def _loop(step, init, xs, chunk: int, remat: bool):
    """All T steps: chunks of ``chunk`` steps, each checkpointed, when
    ``remat``; else one plain loop."""
    T = xs[0].shape[0]
    if not remat:
        return _scan(step, init, xs, 0, T)
    carry, ys = init, []
    for lo in range(0, T, chunk):
        carry, y = checkpoint(_scan, step, carry, xs, lo, lo + chunk,
                              use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


_loops = [_loop]


@contextlib.contextmanager
def loop_through(loop):
    """Run :func:`chunked_scan`'s loops through ``loop(step, init, xs,
    chunk, remat) -> (carry, ys)`` inside this scope."""
    _loops.append(loop)
    try:
        yield
    finally:
        _loops.pop()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in _tensors(v)]


def chunked_scan(step, init, xs: tuple, *, chunk: int = 128):
    """``lax.scan(step, init, xs)`` with chunked rematerialisation.

    ``step(carry, x_t) -> (carry, y_t)``; ``carry`` is a tensor or a tuple
    of tensors, ``xs`` a tuple of tensors with leading axis T, and ``x_t``
    the tuple of their slices at t.  Returns (final carry, ys (T, ...))."""
    T = xs[0].shape[0]
    c = min(chunk, T)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(init) + _tensors(xs))
    return _loops[-1](step, init, xs, c, grad and T % c == 0)
