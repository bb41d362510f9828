"""Device time of RoPE a request: the device's busy time (the union of
the profiler's kernel intervals) inside the program's ``attn.rope``
device intervals (``repro_torch.spans``), summed over the layers; the
median over the traced requests, so that the request that holds the
profiler's start cannot set it.

The trace's clock is not quite the host's: the profiler gives its kernels
on ``time.time_ns``'s scale but drifting from it (up to ~0.6 ms a
second), and ``repro_torch.spans`` maps a request's CUDA events onto the
host clock within its anchor error (~1 ms on the first traced request,
whose first calls the profiler slows).  So each request's device
intervals are carried onto the trace's clock by a line
(:func:`clocks`) fitted on its K11 spans: the end of each
``kernel.flash_attention`` interval against the end of its K11 kernel
(``flash_fwd*``), the two paired in order across the window.  A request
is read where the line holds: every fitted end within FIT_S of its
kernel's, every fitted start no later than its kernel's start (within
FIT_S), so that each interval holds exactly its one K11 kernel.  None
where the window's K11 intervals and kernels are not as many, where
fewer than half the requests hold, where the program records no spans
(the module is missing, or nothing was recorded) or where no request lies
in the window.  This file holds what the readers of the program's spans
share (the others load it)."""
import statistics

#: Largest misfit of the line at a K11 interval's end (and allowed
#: lateness of its start): the events' resolution is about half a
#: microsecond, and the misfits of 104 requests of the three prefill
#: cells on an H100 read at most 4.3 us.
FIT_S = 1e-5


def requests(ctx):
    """request id -> its program spans inside the traced window, or None."""
    if ctx.get("kind") != "prefill":
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    lo, hi = ctx["trace"].window
    return spans.requests(lo, hi) or None


def union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def overlap_s(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _line(xs: list, ys: list) -> tuple:
    """The least-squares line through (xs, ys) as (x0, y0, slope): y =
    y0 + slope (x - x0), x0 the mean of xs (seconds since the epoch keep
    their rounding small only as differences)."""
    x0 = xs[0] + sum(x - xs[0] for x in xs) / len(xs)
    y0 = ys[0] + sum(y - ys[0] for y in ys) / len(ys)
    sxx = sum((x - x0) ** 2 for x in xs)
    slope = (sum((x - x0) * (y - y0) for x, y in zip(xs, ys)) / sxx
             if sxx > 0 else 1.0)
    return x0, y0, slope


def at(line: tuple, t: float) -> float:
    """Host-clock time ``t`` on the trace's clock, by a request's line."""
    x0, y0, slope = line
    return y0 + slope * (t - x0)


def clocks(reqs: dict, kernels: list):
    """request id -> its line onto the trace's clock (:func:`at`), for
    each request where it holds; None as the module says."""
    k11 = sorted((s, e) for n, s, e in kernels if "flash_fwd" in n)
    ivs = {req: sorted(r["dev"] for r in spans
                       if r["name"] == "kernel.flash_attention" and r["dev"])
           for req, spans in reqs.items()}
    if not k11 or sum(map(len, ivs.values())) != len(k11):
        return None
    out, i = {}, 0
    for req in sorted(ivs):
        pairs = list(zip(ivs[req], k11[i:i + len(ivs[req])]))
        i += len(pairs)
        if len(pairs) < 2:
            continue
        line = _line([b for (_, b), _ in pairs], [e for _, (_, e) in pairs])
        if all(abs(at(line, b) - e) <= FIT_S and at(line, a) <= s + FIT_S
               for (a, b), (s, e) in pairs):
            out[req] = line
    return out if out and 2 * len(out) >= len(reqs) else None


def device_ms(ctx, names, keep=None):
    """Median over the window's requests of the busy time of the kernels
    that ``keep`` takes (all without it) inside the device intervals of
    the spans named ``names``, in ms; None as the module says."""
    reqs = requests(ctx)
    if reqs is None:
        return None
    kernels = ctx["trace"].in_window()
    fits = clocks(reqs, kernels)
    if fits is None:
        return None
    busy = union((s, e) for n, s, e in kernels if keep is None or keep(n))
    per = [overlap_s(busy, union((at(line, r["dev"][0]),
                                  at(line, r["dev"][1]))
                                 for r in reqs[req]
                                 if r["name"] in names and r["dev"]))
           for req, line in fits.items()]
    return 1e3 * statistics.median(per)


def read(ctx):
    return device_ms(ctx, ("attn.rope",))
