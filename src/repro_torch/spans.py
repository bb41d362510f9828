"""Program spans: where a request's time goes, as the program marks it.

A span is one named interval of the program's work: its name, its
request, its parent, its start and end on the host clock
(``time.time_ns``, the realtime clock on which ``torch.profiler`` gives
the device's kernel timestamps), optional attributes (a layer's index
``i``) and, for a span asked to have one, a device interval: two timing
CUDA events on the request's stream around the work the span enqueued.

    with spans.request("prefill", device=tokens.device, batch=B):
        with spans.span("layer", i=0):
            with spans.span("attn.rope", device=True):
                ...
    with spans.request("sample", new=False):     # the same request
        ...

:func:`request` opens a request's top span and a fresh request id, which
every span under it carries; ``new=False`` opens a top span that carries
the last request's id instead.  Recording is on while a ``torch.profiler``
window is open on the thread (tested once, at each top span) or inside
:func:`recording`.  Off, :func:`span` returns one shared no-op context
(one test of a module flag, no allocation, no clock read; its enter and
exit are C functions, so it runs no Python frame).  Kernel wrappers
(:func:`repro_torch.kernels.boundary.bounded`) open a ``kernel.<name>``
span with a device interval; the kernel boundaries' stack and the open
spans' stack are one per-thread state.

The device's clock.  A request's top span on a CUDA device records an
anchor event first and polls it until it has fired (in a closed loop the
device is idle there, so the wait is the launch's latency).  It fired
after the start of the last poll that saw it pending (or the record, if
none did) and before the host saw it done: the anchor's host time is the
middle of the two, and half their distance bounds its error
(``anchor_err`` on the top span).  Every other event of the request is
the anchor's time plus their ``elapsed_time``.

Spans stay in memory, the last :data:`MAX_SPANS`, until :func:`clear`;
:func:`records` and :func:`requests` read them, resolving device
intervals (which waits for their events).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

__all__ = ["span", "request", "recording", "records", "requests", "clear",
           "MAX_SPANS"]

#: Spans kept in memory; older ones are dropped.
MAX_SPANS = 1 << 17


class _Thread(threading.local):
    """One thread's state: its open kernel boundaries
    (:mod:`repro_torch.kernels.boundary`), its open spans, whether it
    records, and the top span of its last request."""

    def __init__(self):
        self.stack: list = []
        self.open: list = []
        self.on = False
        self.top = None


_STATE = _Thread()
_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count()
#: The threads recording now: while none does, :func:`span` reads no
#: per-thread state.
_RECORDING: set = set()


def _set_on(on: bool) -> None:
    _STATE.on = on
    if on:
        _RECORDING.add(threading.get_ident())
    else:
        _RECORDING.discard(threading.get_ident())


class _Off:
    """The no-op span that every call returns while recording is off.
    Its enter and exit are C functions, so that ``with`` runs no Python
    frame: ``__exit__`` ignores its three arguments and returns "", which
    is false, so an exception passes through."""
    __slots__ = ()
    __enter__ = object.__sizeof__
    __exit__ = "".format


_OFF = _Off()


def _event(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "id", "req", "parent", "t0", "t1", "attrs",
                 "device", "top", "ev", "dev")

    def __init__(self, name: str, device: bool, attrs: dict | None):
        self.name, self.device, self.attrs = name, device, attrs
        self.id = next(_IDS)
        self.ev = self.dev = None

    def _open(self, top) -> None:
        st = _STATE
        self.top = top
        self.req = top.id if top is not None else None
        self.parent = st.open[-1].id if st.open else None
        st.open.append(self)

    def __enter__(self):
        self._open(_STATE.top)
        self.t0 = time.time_ns()
        top = self.top
        if self.device and top is not None and top.anchor is not None:
            self.ev = [_event(top.stream), None]
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.ev is not None:
            self.ev[1] = _event(self.top.stream)
        self.t1 = time.time_ns()
        _STATE.open.pop()
        _SPANS.append(self)
        return None


class _Top(_Span):
    """A request's top span: it turns recording on for its duration when
    a profiler window asked for it (``own``), and with ``new`` opens a
    request, anchored on the device when the request runs on one
    (``where``)."""
    __slots__ = ("new", "own", "where", "stream", "anchor")

    def __init__(self, name: str, new: bool, own: bool, where,
                 attrs: dict | None):
        super().__init__(name, False, attrs)
        self.new, self.own, self.where = new, own, where
        self.stream = self.anchor = None

    def __enter__(self):
        if not self.new:
            super().__enter__()
        else:
            _STATE.top = self
            if self.where is not None and \
                    torch.device(self.where).type == "cuda":
                self._anchor()
            self._open(self)
            self.t0 = time.time_ns()
        if self.own:
            _set_on(True)
        return self

    def _anchor(self) -> None:
        self.stream = torch.cuda.current_stream(self.where)
        t_pending = time.time_ns()
        ev = _event(self.stream)
        while True:
            t_poll = time.time_ns()
            if ev.query():
                break
            t_pending = t_poll
        t_done = time.time_ns()
        self.anchor = (ev, (t_pending + t_done) // 2,
                       (t_done - t_pending + 1) // 2)
        self.ev = [ev, None]

    def __exit__(self, exc_type, exc, tb):
        try:
            return super().__exit__(exc_type, exc, tb)
        finally:
            if self.own:
                _set_on(False)


def span(name: str, device: bool = False, i: int | None = None):
    """A span ``name`` under the thread's open span; ``device`` also
    records its device interval, ``i`` an index (a layer's)."""
    if not _RECORDING or not _STATE.on:
        return _OFF
    return _Span(name, device, None if i is None else {"i": i})


def request(name: str, *, new: bool = True, device=None, **attrs):
    """A request's top span: with ``new`` a fresh request (its id is this
    span's), with a device interval anchored as the module says when
    ``device`` is a CUDA device; else a top span of the last request."""
    if _RECORDING and _STATE.on:
        own = False
    elif torch.autograd._profiler_enabled():
        own = True
    else:
        return _OFF
    return _Top(name, new, own, device if new else None, attrs or None)


@contextlib.contextmanager
def recording():
    """Record the spans of the work inside, with no profiler open."""
    if _STATE.on:
        yield
        return
    _set_on(True)
    try:
        yield
    finally:
        _set_on(False)


def clear() -> None:
    """Drop every recorded span."""
    _SPANS.clear()


def _resolve(s: _Span) -> None:
    """Map a finished span's device events onto the host clock."""
    if s.ev is None:
        return
    anchor, t_anchor, _ = s.top.anchor
    s.ev[1].synchronize()
    s.dev = tuple(t_anchor + 1e6 * anchor.elapsed_time(e) if e is not anchor
                  else float(t_anchor) for e in s.ev)
    s.ev = None


def _as_dict(s: _Span) -> dict:
    out = {"name": s.name, "id": s.id, "req": s.req, "parent": s.parent,
           "start": s.t0 * 1e-9, "end": s.t1 * 1e-9, "attrs": s.attrs,
           "dev": None if s.dev is None else [t * 1e-9 for t in s.dev]}
    if isinstance(s, _Top) and s.anchor is not None:
        out["anchor_err"] = s.anchor[2] * 1e-9
    return out


def records(lo: float | None = None, hi: float | None = None) -> list[dict]:
    """The recorded spans that lie inside [lo, hi] (host seconds), in the
    order they closed, as dicts: name, id, req, parent, start, end (host
    seconds), attrs, dev ([start, end] on the host clock, or None) and, on
    an anchored top span, anchor_err (seconds)."""
    out = []
    for s in list(_SPANS):
        if (lo is not None and s.t0 * 1e-9 < lo) or \
                (hi is not None and s.t1 * 1e-9 > hi):
            continue
        _resolve(s)
        out.append(_as_dict(s))
    return out


def requests(lo: float | None = None,
             hi: float | None = None) -> dict[int, list[dict]]:
    """request id -> its spans inside [lo, hi], for every request whose
    top span lies there (a top span's ``req`` is its own ``id``)."""
    recs = records(lo, hi)
    out: dict[int, list[dict]] = {r["id"]: [] for r in recs
                                  if r["req"] == r["id"]}
    for r in recs:
        if r["req"] in out:
            out[r["req"]].append(r)
    return out
