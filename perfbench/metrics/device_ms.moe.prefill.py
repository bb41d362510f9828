"""Device time of the MoE FFN a request: the device's busy time inside the
program's ``ffn.moe`` device intervals (router, K12, the expert products,
K13), summed over the layers, read as ``device_ms.rope.prefill`` reads
RoPE's; None where no request records an ``ffn.moe`` span (a dense
model)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "perfbench_metric_device_ms_rope_prefill",
    Path(__file__).with_name("device_ms.rope.prefill.py"))
_rope = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_rope)

NAMES = ("ffn.moe",)


def has_spans(ctx, names) -> bool:
    """Whether any request of the window records a span of ``names``."""
    reqs = _rope.requests(ctx)
    return bool(reqs) and any(r["name"] in names for spans in reqs.values()
                              for r in spans)


def read(ctx):
    if not has_spans(ctx, NAMES):
        return None
    return _rope.device_ms(ctx, NAMES)
