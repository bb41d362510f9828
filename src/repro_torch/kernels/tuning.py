"""Tile specifications carried by the kernel configs.

``TileSpec`` is kept field for field as the reference package defines it,
so an ``ObjectiveConfig`` with pinned ``tile_bi``/``tile_bj``/``tile_bc``
round-trips between the two packages.  The Hopper kernels of this package
have fixed block shapes (see ``csrc/graph_reg.cu``): a spec that pins any
dimension is refused when it reaches a CUDA kernel, rather than ignored;
the block-sparse kernels take a pinned ``bi`` equal to their layout's tile
edge and nothing else.  The plain versions on the CPU have no tiles at all
and accept any spec.
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


def refuse_pinned(tiles: TileSpec | None, kernel: str, *,
                  bi: int | None = None) -> None:
    """Raise if ``tiles`` pins a block size the CUDA ``kernel`` cannot take.

    ``bi`` is the one row tile the kernel does take: the block-sparse
    kernels run at their layout's tile edge, which the reference pins as
    ``tiles.bi`` (``Experiment`` does so from ``BatchConfig.layout_bt``).
    """
    if tiles is None:
        return
    pinned = {name: v for name, v in zip(_DIMS, tiles.astuple())
              if v is not None and not (name == "bi" and v == bi)}
    if pinned:
        takes = f" (only bi={bi}, the layout's tile edge)" if bi else ""
        raise ValueError(
            f"{kernel}: the Hopper kernel has fixed block shapes{takes} and "
            f"does not take a pinned {tiles}; leave ObjectiveConfig.tile_* "
            f"unset")
