"""Device time of RMSNorm a request: the device's busy time inside the
program's ``attn.norm``, ``ffn.norm`` and ``head.norm`` device intervals
(norm1 and norm2 of every layer, and the final norm), read as
``device_ms.rope.prefill`` reads RoPE's."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "perfbench_metric_device_ms_rope_prefill",
    Path(__file__).with_name("device_ms.rope.prefill.py"))
_rope = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_rope)

NAMES = ("attn.norm", "ffn.norm", "head.norm")


def read(ctx):
    return _rope.device_ms(ctx, NAMES)
