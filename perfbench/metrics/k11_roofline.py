"""K11's share of its roofline: the least time its launches of a request
could take (``count.flops.k11_bound_s``, one launch a layer) over their
device time in the profiler's trace (kernels named ``flash_fwd*``)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "perfbench_count_flops", Path(__file__).resolve().parents[1] / "count"
    / "flops.py")
flops = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(flops)


def read(ctx):
    peak = ctx.get("peaks")
    if ctx.get("kind") != "prefill" or peak is None:
        return None
    spent = ctx["trace"].kernel_s("flash_fwd")
    if spent <= 0:
        return None
    bound = ctx["k11_launches"] * flops.k11_bound_s(
        ctx["config"], ctx["batch"], ctx["prompt_len"], peak)
    return 100.0 * bound * ctx["units"] / spent
