"""Device idle a request that the program's own dispatch leaves: the
gaps in the device's busy union (every kernel of the traced window), each
put down to the innermost program span (``repro_torch.spans``) open at
the gap's middle, summed over the gaps whose middle falls inside the
request's ``prefill`` or ``sample`` span; the median over the traced
requests.  What the harness's loop leaves (the token's wait, the time
between requests) is not counted.  The spans' host times are carried onto
the trace's clock by their request's line (``device_ms.rope.prefill``'s
``clocks``, which says where it holds); None where it holds for none, the
trace holds no kernel or the program records no spans."""
import bisect
import importlib.util
import statistics
from pathlib import Path

from perfbench.harness.trace import _innermost

_spec = importlib.util.spec_from_file_location(
    "perfbench_metric_device_ms_rope_prefill",
    Path(__file__).with_name("device_ms.rope.prefill.py"))
_rope = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_rope)

#: The program's top spans of a request: the gaps under them are its own.
TOPS = ("prefill", "sample")


def split(ctx):
    """request id -> {innermost span name: idle seconds} inside its top
    spans, or None."""
    reqs = _rope.requests(ctx)
    tr = ctx["trace"] if reqs else None
    if reqs is None or not tr.kernels:
        return None
    fits = _rope.clocks(reqs, tr.in_window())
    if fits is None:
        return None
    lo, hi = tr.window
    edges = [lo] + [x for iv in tr.busy_intervals() for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    mids = [0.5 * (s + e) for s, e in gaps]
    out = {}
    for req, line in fits.items():
        rs = [(r["name"], _rope.at(line, r["start"]),
               _rope.at(line, r["end"])) for r in reqs[req]]
        mine = sorted({g for name, s, e in rs if name in TOPS
                       for g in range(bisect.bisect_left(mids, s),
                                      bisect.bisect_right(mids, e))})
        labels = _innermost(rs, [mids[g] for g in mine])
        idle: dict = {}
        for g, name in zip(mine, labels):
            idle[name] = idle.get(name, 0.0) + gaps[g][1] - gaps[g][0]
        out[req] = idle
    return out


def read(ctx):
    per = split(ctx)
    if not per:
        return None
    return 1e3 * statistics.median(sum(v.values()) for v in per.values())
