"""Device time of the MLP's activation a request: the busy time of the
non-matmul kernels (``harness.trace.group`` "other": SiLU, the product,
casts) inside the program's ``ffn.mlp`` device intervals, read as
``device_ms.rope.prefill`` reads RoPE's."""
import importlib.util
from pathlib import Path

from perfbench.harness.trace import group

_spec = importlib.util.spec_from_file_location(
    "perfbench_metric_device_ms_rope_prefill",
    Path(__file__).with_name("device_ms.rope.prefill.py"))
_rope = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_rope)


def _not_matmul(name: str) -> bool:
    return group(name) == "other"


def read(ctx):
    return _rope.device_ms(ctx, ("ffn.mlp",), keep=_not_matmul)
