"""Kernel boundaries: where a kernel wrapper's work begins and ends.

A dispatch trace (:mod:`repro_torch.analysis.graph_audit`) sees every
PyTorch op but not a ctypes launch, so each wrapper of :mod:`.graph_reg`,
:mod:`.graph_reg_bsp`, :mod:`.pairwise` and :mod:`.flash_attention` runs
inside :func:`boundary` — its CUDA branch and its plain branch alike.  An
op recorded while a boundary is open ran inside that kernel: on the CPU
the plain version's (B, B) products count as the kernel's own, as the
reference's interpret-mode Pallas kernels do, and on the card the boundary
holds the launch.  :mod:`repro_torch.kernels.ref` called directly (the
``graph_reg_ref`` canary entry) stays outside.

The state is per thread: the ops a wrapper runs run on the thread that
entered it.  It is :mod:`repro_torch.spans`'s per-thread state, whose
stack of open spans sits beside this stack of boundaries: while the
thread records spans, :func:`bounded` also opens a ``kernel.<name>``
span with a device interval.
"""
from __future__ import annotations

import contextlib
import functools

from .. import spans

__all__ = ["boundary", "bounded", "current"]

_STATE = spans._STATE


def current() -> str | None:
    """The innermost open kernel boundary on this thread, else None."""
    stack = _STATE.stack
    return stack[-1] if stack else None


@contextlib.contextmanager
def boundary(name: str):
    """Mark the ops run inside as kernel ``name``'s."""
    stack = _STATE.stack
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def bounded(name: str):
    """Decorator: run the wrapper inside kernel ``name``'s boundary (a
    push and a pop of this thread's list, no context manager: the
    wrappers run it on every call), and inside a ``kernel.<name>`` span
    while the thread records."""
    label = "kernel." + name

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            st = _STATE
            st.stack.append(name)
            try:
                if st.on:
                    with spans.span(label, device=True):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                st.stack.pop()
        return wrapper
    return deco
