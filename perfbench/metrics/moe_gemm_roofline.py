"""The expert products' share of their roofline: the least time a
request's grouped GEMMs could take (``count.moe_flops.experts_bound_s``,
one layer's three products a MoE layer) over the busy time of the matmul
kernels inside the device intervals of the program's ``ffn.mlp`` spans
that an ``ffn.moe`` span holds (the dropless layer's expert products; a
dense layer's ``ffn.mlp`` lies outside), read as
``device_ms.rope.prefill`` reads RoPE's, the median request; None
without such spans (a dense model or a program without the dropless
layer)."""
import importlib.util
import statistics
from pathlib import Path

from perfbench.harness.trace import group


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_here = Path(__file__).resolve()
_rope = _load("perfbench_metric_device_ms_rope_prefill",
              _here.with_name("device_ms.rope.prefill.py"))
moe_flops = _load("perfbench_count_moe_flops",
                  _here.parents[1] / "count" / "moe_flops.py")


def _experts(spans) -> list:
    """The ``ffn.mlp`` spans of a request that an ``ffn.moe`` span holds."""
    moe = {r["id"] for r in spans if r["name"] == "ffn.moe"}
    return [r for r in spans
            if r["name"] == "ffn.mlp" and r["parent"] in moe and r["dev"]]


def matmul_ms(ctx):
    """Median over the window's requests of the matmul kernels' busy time
    inside the expert products' device intervals, in ms; None as
    ``device_ms.rope.prefill`` says, or where no request has them."""
    reqs = _rope.requests(ctx)
    if reqs is None or not any(map(_experts, reqs.values())):
        return None
    kernels = ctx["trace"].in_window()
    fits = _rope.clocks(reqs, kernels)
    if fits is None:
        return None
    busy = _rope.union((s, e) for n, s, e in kernels
                       if group(n) == "matmul")
    per = [_rope.overlap_s(busy, _rope.union(
        (_rope.at(line, r["dev"][0]), _rope.at(line, r["dev"][1]))
        for r in _experts(reqs[req]))) for req, line in fits.items()]
    return 1e3 * statistics.median(per)


def read(ctx):
    peak = ctx.get("peaks")
    if peak is None:
        return None
    spent = matmul_ms(ctx)
    if not spent:
        return None
    c = ctx["config"]
    bound = c["n_layers"] * moe_flops.experts_bound_s(
        c, ctx["batch"] * ctx["prompt_len"], peak)
    return 100.0 * 1e3 * bound / spent
