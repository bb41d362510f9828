"""Hopper kernels K8 (streaming k-NN top-k) and K9 (RBF affinity block).

Both work on squared distances ``d2_ij = max(‖x_i‖² − 2·x_i·y_j + ‖y_j‖², 0)``
in float32.  The wrappers compute the row norms with one PyTorch reduction,
as the reference computes them outside its kernels, launch one kernel of
``csrc/pairwise.cu`` for CUDA tensors, run the plain version from
:mod:`repro_torch.kernels.ref` for CPU tensors, and raise for mixed
devices.  A CUDA tensor never reaches a plain version.

Source notes (bounds on an H100 SXM, 3.35 TB/s and 67 TFLOP/s f32 without
tensor cores):

* ``knn_topk`` — K8, replaces ``repro/kernels/pairwise.py:_knn_topk`` /
  ``_topk_kernel``.  Per query row the k smallest d2 and their candidate
  indices, sorted by (d2, index): ties go to the lowest index, as the
  reference's lowest-position rule gives.  2·N·M·D flops, 4.19 ms at the
  paper's corpus (N = M = 20,000, D = 351); the bytes (x and y once, 28 MB)
  take 8 µs: bound by operations.  The Pallas kernel keeps the running
  top-k in VMEM scratch across an ordered grid; here one block owns 32
  query rows and loops over every column chunk itself, each warp merging
  its rows' distances from registers into a list in shared memory.  No
  N×M buffer exists, on the card or on the CPU path, which streams column
  chunks against a running (N, k) state (``knn_topk_stream_ref``).
  On the card the lists live in shared memory for k ≤ :data:`K_MAX`
  and, past it, in the rows of the outputs themselves (:func:`route`);
  the card and the CPU take every k the reference takes.
* ``rbf_affinity`` — K9, replaces ``rbf_affinity_pallas`` /
  ``_pairwise_kernel``.  ``exp(−sqrt(d2)/(2σ²))`` over the dense (N, M)
  block; 2·N·M·D flops: bound by operations at a meta-batch's shape.
  Output-tiled, edges masked.

Both are plain FMA loops in f32 (no TF32): agreement with the reference
comes first, speed is later work.  Each wrapper counts its kernel launches
in ``<wrapper>.launches``; :func:`repro_torch.kernels.graph_reg.
launch_counts` reports them with the other kernels'.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .graph_reg import _checked, _on_cpu, _raise_on, _stream
from .tuning import TileSpec, refuse_pinned

__all__ = ["knn_topk", "rbf_affinity", "K_MAX", "route", "WRAPPERS",
           "SOURCE"]

SOURCE = "src/repro_torch/csrc/pairwise.cu"

#: Largest k of the streaming top-k kernel's shared-memory route (``kKMax``
#: in ``csrc/pairwise.cu``): a block's 32 running lists of k (d2, index)
#: pairs live in shared memory, 64 KB at k = 256.  Past it the lists live
#: in the outputs (the global route).
K_MAX = 256


def route(k: int) -> str:
    """Where K8 keeps its running lists for this k: ``"shared"`` (shared
    memory, k ≤ :data:`K_MAX`) or ``"global"`` (the rows of the (N, k)
    outputs).  Chosen by k alone; both give the same lists."""
    return "shared" if k <= K_MAX else "global"


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "knn_topk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "rbf_affinity": (_P, _P, _P, _P, _I, _I, _I, _F, _P, _P),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("pairwise")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def _operands(x: torch.Tensor, y: torch.Tensor):
    """x (N, D) and y (M, D) as contiguous float32, and their squared row
    norms (the same tensor twice when x is y)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x and y must be (N, D) and (M, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    same = y is x
    x = x.to(torch.float32).contiguous()
    y = x if same else y.to(torch.float32).contiguous()
    nx = torch.sum(x * x, dim=1)
    ny = nx if same else torch.sum(y * y, dim=1)
    return x, y, nx, ny


def knn_topk(x: torch.Tensor, y: torch.Tensor, k: int, *,
             exclude_self: bool = False,
             tiles: TileSpec | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: per-row k smallest squared distances and their indices.

    x (N, D) queries, y (M, D) candidates → ``(d2, idx)``, (N, k) float32
    and int32, sorted ascending by (d2, index).  ``exclude_self`` skips the
    pair (i, i) for every row i < min(N, M) (x is y).
    """
    M = y.shape[0]
    limit = M - 1 if exclude_self else M
    if not 0 < k <= limit:
        raise ValueError(f"k must be in [1, {limit}] for M={M} candidates "
                         f"(exclude_self={exclude_self}), got {k}")
    if _on_cpu(x, y):
        return ref.knn_topk_stream_ref(x, y, k, exclude_self=exclude_self)
    refuse_pinned(tiles, "knn_topk")
    x, y, nx, ny = _operands(x, y)
    N, D = x.shape
    d2 = torch.empty(N, k, dtype=torch.float32, device=x.device)
    idx = torch.empty(N, k, dtype=torch.int32, device=x.device)
    if N == 0:
        return d2, idx
    rc = _lib().knn_topk(x.data_ptr(), y.data_ptr(),
                         _checked(nx, "nx", (N,)), _checked(ny, "ny", (M,)),
                         N, M, D, k, int(exclude_self), d2.data_ptr(),
                         idx.data_ptr(), _stream(x))
    _raise_on(rc, "knn_topk")
    knn_topk.launches += 1
    return d2, idx


def rbf_affinity(x: torch.Tensor, y: torch.Tensor, sigma: float, *,
                 tiles: TileSpec | None = None) -> torch.Tensor:
    """K9: the dense RBF affinity block exp(−‖x_i − y_j‖/(2σ²)), (N, M)
    float32.  ``sigma`` is a Python float."""
    if _on_cpu(x, y):
        return ref.rbf_affinity_ref(x, y, sigma)
    refuse_pinned(tiles, "rbf_affinity")
    x, y, nx, ny = _operands(x, y)
    N, D = x.shape
    M = y.shape[0]
    out = torch.empty(N, M, dtype=torch.float32, device=x.device)
    if N == 0 or M == 0:
        return out
    rc = _lib().rbf_affinity(x.data_ptr(), y.data_ptr(),
                             _checked(nx, "nx", (N,)),
                             _checked(ny, "ny", (M,)), N, M, D, float(sigma),
                             out.data_ptr(), _stream(x))
    _raise_on(rc, "rbf_affinity")
    rbf_affinity.launches += 1
    return out


WRAPPERS = {"knn_topk": knn_topk, "rbf_affinity": rbf_affinity}
for _fn in WRAPPERS.values():
    _fn.launches = 0
