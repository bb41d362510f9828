"""Checks of the port's inputs that the kernels rely on."""
from repro_torch.analysis.race_audit import (Finding, check_layout,
                                             check_tile_list)

__all__ = ["Finding", "check_tile_list", "check_layout"]
