"""Tile specifications carried by the kernel configs.

``TileSpec`` is kept field for field as the reference package defines it,
so an ``ObjectiveConfig`` with pinned ``tile_bi``/``tile_bj``/``tile_bc``
round-trips between the two packages.  The Hopper kernels of this package
have fixed block shapes (see ``csrc/graph_reg.cu``): a spec that pins any
dimension is refused when it reaches a CUDA kernel, rather than ignored.
The plain versions on the CPU have no tiles at all and accept any spec.
"""
from __future__ import annotations

import dataclasses

__all__ = ["TileSpec", "refuse_pinned"]

_DIMS = ("bi", "bj", "bc", "bd")


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Block sizes for one kernel launch; ``None`` means "auto-select"."""

    bi: int | None = None
    bj: int | None = None
    bc: int | None = None
    bd: int | None = None

    def __post_init__(self):
        for name in _DIMS:
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v <= 0):
                raise ValueError(
                    f"TileSpec.{name} must be a positive int or None, "
                    f"got {v!r}")

    def astuple(self) -> tuple[int | None, ...]:
        return (self.bi, self.bj, self.bc, self.bd)


def refuse_pinned(tiles: TileSpec | None, kernel: str) -> None:
    """Raise if ``tiles`` pins a block size the CUDA ``kernel`` cannot take."""
    if tiles is not None and any(v is not None for v in tiles.astuple()):
        raise ValueError(
            f"{kernel}: the Hopper kernel has fixed block shapes and does not "
            f"take a pinned {tiles}; leave ObjectiveConfig.tile_* unset")
