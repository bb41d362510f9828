"""K12's and K13's share of their roofline: the least time their launches
of a request could take (``count.moe_flops.permute_bound_s``, one of each
a MoE layer, bound by bytes) over their device time in the profiler's
trace (kernels named ``moe_dispatch*`` and ``moe_combine*``); None where
the trace holds neither."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "perfbench_count_moe_flops",
    Path(__file__).resolve().parents[1] / "count" / "moe_flops.py")
moe_flops = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(moe_flops)

KERNELS = ("moe_dispatch", "moe_combine")


def read(ctx):
    peak = ctx.get("peaks")
    if ctx.get("kind") != "prefill" or peak is None:
        return None
    spent = sum(ctx["trace"].kernel_s(k) for k in KERNELS)
    if spent <= 0:
        return None
    c = ctx["config"]
    bound = c["n_layers"] * moe_flops.permute_bound_s(
        c, ctx["batch"] * ctx["prompt_len"], peak)
    return 100.0 * bound * ctx["units"] / spent
