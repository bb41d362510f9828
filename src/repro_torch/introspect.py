"""Tiny signature-introspection helpers shared across layers."""
from __future__ import annotations

import inspect
from typing import Callable

__all__ = ["accepts_kwarg"]


def accepts_kwarg(fn: Callable, name: str, *, explicit: bool = False) -> bool:
    """True when ``fn(...)`` can be called with keyword argument ``name``.

    ``explicit=False`` counts a ``**kwargs`` catch-all as acceptance (the
    right question for "is it safe to forward this kwarg").
    ``explicit=True`` requires a named parameter — use it when accepting
    the kwarg signals a *semantic contract* (e.g. the engine's epoch-pure
    pipeline protocol), which a permissive catch-all must not opt into
    silently.  Returns False for non-introspectable callables.
    """
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    p = params.get(name)
    if p is not None and p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                    inspect.Parameter.KEYWORD_ONLY):
        return True
    if explicit:
        return False
    return any(q.kind is inspect.Parameter.VAR_KEYWORD
               for q in params.values())
