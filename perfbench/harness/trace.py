"""The traced window: ``torch.profiler`` over it, read in memory.

The profiler records the device alone (CUDA activity: every kernel, copy
and set's interval); recording host operations too doubled the host's
time a prefill in development runs, and the host sets a prefill's pace.
The harness keeps its own host spans (``span``) on the same clock as the
profiler's device timestamps (``time.time_ns``, the realtime clock), so
an idle gap on the device can be named by what the harness was doing.
Nothing is written to disk: the profiler's raw events are read in memory.

``Trace`` holds what the metric readers read: kernels (name, start, end)
in seconds, the window's interval and the harness's spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time

#: Kernel-name groups, as ``repro_torch.bench._group`` files them: the
#: port's own kernels by their entry names, then cuBLAS/CUTLASS products.
PORT_KERNELS = {
    "graph_reg": ("pad_classes", "reg_fwd_partials", "reg_fwd_tree_sum",
                  "reg_fwd_class_partials", "reg_fwd_class_sum",
                  "reg_bwd_dlogp", "reg_bwd_dw", "bsp_fwd_partials",
                  "bsp_bwd_bterm", "bsp_bwd_dlogp", "bsp_bwd_dw"),
    "flash_attention": ("flash_fwd",),
}
MATMUL_KEYS = ("gemm", "cutlass", "matmul", "xmma", "nvjet")


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments' tail."""
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width - 3] + "..."


def group(name: str) -> str:
    for g, keys in PORT_KERNELS.items():
        if any(k in name for k in keys):
            return g
    low = name.lower()
    if any(k in low for k in MATMUL_KEYS):
        return "matmul"
    return "other"


@dataclasses.dataclass
class Trace:
    kernels: list            # (name, start_s, end_s), device
    window: tuple            # (start_s, end_s)
    spans: list              # (label, start_s, end_s), the harness's

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self) -> list:
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.kernels
                if e > lo and s < hi]

    def busy_intervals(self) -> list:
        """The union of the kernels' intervals inside the window."""
        merged: list = []
        for _, s, e in sorted(self.in_window(), key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def group_s(self) -> dict:
        out: dict = {}
        for n, s, e in self.in_window():
            out[group(n)] = out.get(group(n), 0.0) + (e - s)
        return out

    def kernel_s(self, key: str) -> float:
        return sum(e - s for n, s, e in self.in_window() if key in n)

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, s, e in self.in_window():
            tot[short(name)] = tot.get(short(name), 0.0) + (e - s)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time inside the window, summed by the harness span that
        was open at the middle of each gap (the innermost; "none" between
        spans)."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        labels = _innermost(self.spans, [0.5 * (s + e) for s, e in gaps])
        tot: dict = {}
        for (s, e), label in zip(gaps, labels):
            tot[label] = tot.get(label, 0.0) + (e - s)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


def _innermost(intervals: list, times: list) -> list:
    """For each of the ascending ``times``, the name of the latest-started
    interval still open then (the innermost where intervals nest), or
    "none"."""
    order = sorted(intervals, key=lambda iv: iv[1])
    heap: list = []
    out, i = [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            name, s, e = order[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "none")
    return out


class Tracer:
    """``with tracer.window(): ...`` profiles the window's device work;
    ``with tracer.span(label): ...`` records a harness span inside it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.spans: list = []
        self.bounds = None

    @contextlib.contextmanager
    def span(self, label: str):
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((label, t0 * 1e-9, time.time_ns() * 1e-9))

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.time_ns()
            yield
            if cuda:
                torch.cuda.synchronize()
            self.bounds = (t0 * 1e-9, time.time_ns() * 1e-9)
        self.prof = prof

    def read(self) -> Trace:
        """The window's device intervals and the harness's spans."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        kernels = [(k.name(), k.start_ns() * 1e-9, k.end_ns() * 1e-9)
                   for k in self.prof.profiler.kineto_results.events()
                   if k.device_type() == cuda]
        return Trace(kernels=kernels, window=self.bounds,
                     spans=list(self.spans))
