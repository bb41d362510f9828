"""Production mesh definitions and the card's roofline constants.

Port of ``repro/launch/mesh.py``.  The meshes keep the reference's shapes
and axis names, so a spec of :mod:`repro_torch.sharding.specs` is the
reference's on the same mesh:

  single:  (16, 16)      axes ("data", "model")     256 chips
  multi:   (2, 16, 16)   axes ("pod", "data", "model")   512 chips

The dry run places nothing: it takes an :class:`AbstractMesh` (axis names
and sizes, no devices, no process group).  :func:`make_device_mesh` builds
a ``DeviceMesh`` for a run whose process group already holds that many
ranks; it never starts one itself.

Roofline constants are an NVIDIA H100 SXM's (NVIDIA H100 Tensor Core GPU
data sheet, SXM column): 989 TFLOP/s dense bf16 on the tensor cores, 3.35
TB/s of HBM3, and NVLink 4 at 900 GB/s a GPU in both directions, so 450
GB/s each way.  NVLink joins at most 8 GPUs of one HGX board; a 16-wide
``model`` axis crosses that domain (over InfiniBand or an NVLink switch
system), so the collective term, which assumes NVLink's rate for every
byte, is a lower bound there.
"""
from __future__ import annotations

import dataclasses
import math

SINGLE_POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)
SINGLE_AXES = ("data", "model")
MULTI_AXES = ("pod", "data", "model")

# H100 SXM hardware constants used by the roofline analysis.
PEAK_FLOPS_BF16 = 989e12        # per chip, dense
HBM_BW = 3.35e12                # bytes/s per chip
LINK_BW = 450e9                 # bytes/s per chip and direction (NVLink 4)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh without devices: ``shape`` maps each axis name to its size,
    ``axis_names`` gives their order (the mesh dims' order)."""

    shape: dict
    axis_names: tuple

    @classmethod
    def of(cls, device_mesh) -> "AbstractMesh":
        """The abstract view of a ``DeviceMesh`` with named dims."""
        names = tuple(device_mesh.mesh_dim_names)
        return cls(dict(zip(names, device_mesh.mesh.shape)), names)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape, axes = ((MULTI_POD_SHAPE, MULTI_AXES) if multi_pod
                   else (SINGLE_POD_SHAPE, SINGLE_AXES))
    return AbstractMesh(dict(zip(axes, shape)), axes)


def debug_mesh(*, multi_pod: bool = False, data: int = 2,
               model: int = 2) -> AbstractMesh:
    """Tiny mesh with the same axis names (the CPU tests' dry runs)."""
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": data, "model": model},
                            MULTI_AXES)
    return AbstractMesh({"data": data, "model": model}, SINGLE_AXES)


def make_device_mesh(shape: tuple[int, ...], names: tuple[str, ...],
                     device_type: str = "cuda"):
    """``init_device_mesh(device_type, shape, mesh_dim_names=names)`` over
    the default process group, which must already hold ``prod(shape)``
    ranks (``torchrun``, or ``init_process_group`` by the caller)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group; it does not start one")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))
