"""The profiled step's kernel groups (``repro_torch.bench``) against the
kernel sources.

``python -m repro_torch.bench`` reports the device time of a training step
by group; the regularizer's share is the time of every kernel that
``_group`` files as ``graph_reg_kernels``.  A kernel of the regularizer's
sources that the grouping does not know lands in ``other`` and drops out of
that share, so each one found in the sources must be filed there.
"""
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch import bench  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
_KERNEL = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(")


def _kernels(*names: str) -> list[str]:
    found = []
    for name in names:
        found += _KERNEL.findall((CSRC / name).read_text())
    return sorted(set(found))


REG = _kernels("graph_reg.cu", "graph_reg_bsp.cu", "graph_reg_tiles.cuh")
ATTN = _kernels("flash_attention.cu", "flash_attention_wgmma.cuh")


def test_the_sources_hold_the_regularizer_kernels():
    assert {"pad_classes", "reg_fwd_partials", "reg_fwd_tree_sum",
            "reg_bwd_dlogp", "reg_bwd_dw", "bsp_bwd_bterm"} <= set(REG)


@pytest.mark.parametrize("kernel", REG)
def test_regularizer_kernel_is_in_the_regularizer_group(kernel):
    # as the profiler names a kernel of an anonymous namespace
    assert bench._group(f"void (anonymous namespace)::{kernel}<true>("
                        f"float const*, int, float*)") == "graph_reg_kernels"


@pytest.mark.parametrize("kernel", ATTN)
def test_attention_kernel_is_in_the_attention_group(kernel):
    assert bench._group(f"(anonymous namespace)::{kernel}(float const*)") \
        == "flash_attention"
