"""Hopper kernels K8 (streaming k-NN top-k) and K9 (RBF affinity block).

Both work on squared distances ``d2_ij = max(‖x_i‖² − 2·x_i·y_j + ‖y_j‖², 0)``
in float32.  The wrappers compute the row norms with one PyTorch reduction,
as the reference computes them outside its kernels, launch the entry point
of ``csrc/pairwise.cu`` for CUDA tensors, run the plain version from
:mod:`repro_torch.kernels.ref` for CPU tensors, and raise for mixed
devices.  A CUDA tensor never reaches a plain version.

Source notes (bounds on an H100 SXM, 3.35 TB/s and 67 TFLOP/s f32 without
tensor cores):

* Both kernels run on one distance engine (``csrc/d2_tile.cuh``):
  128-column output tiles of 128 (or 64) rows, 8 × 8 (4 × 8) values a
  thread read as ``float4`` from 32-feature, feature-major slabs in shared
  memory, two in flight, loaded by 16-byte ``cp.async`` copies.  Each
  entry point first writes feature-major copies of x and y, zero-padded
  to whole slabs and tiles, into a workspace whose size the library gives
  (:func:`launch_plan`; :func:`knn_plan` and :func:`rbf_plan` are its
  mirrors), so rows of any length and alignment load as 16-byte copies.
  Every product is one fmaf chain in increasing feature order from +0,
  the order of the tile the kernels had before their redesign: the
  outputs keep those bits.
* ``knn_topk`` — K8, replaces ``repro/kernels/pairwise.py:_knn_topk`` /
  ``_topk_kernel``.  Per query row the k smallest d2 and their candidate
  indices, sorted by (d2, index): ties go to the lowest index, as the
  reference's lowest-position rule gives.  2·N·M·D flops, 4.19 ms at the
  paper's corpus (N = M = 20,000, D = 351); the bytes (x and y once, 28 MB)
  take 8 µs: bound by operations.  The Pallas kernel keeps the running
  top-k in VMEM scratch across an ordered grid; here a block owns 128
  query rows and one segment of the column tiles (segments fill the card),
  walks it in increasing j, buffers each tile's distances below a row's
  k-th through shared-memory slot counters and merges them into the
  row's list by rank; a second pass merges each row's segment lists by
  rank.  The k smallest under (d2, index) are a unique set, so no merge
  order matters (:func:`repro_torch.kernels.ref.knn_topk_segments_ref`
  is the rule).  No N×M buffer exists, on the card or on the CPU path,
  which streams column chunks against a running (N, k) state
  (``knn_topk_stream_ref``).  On the card the lists live in shared memory
  for k ≤ :data:`K_MAX` and, past it, in global memory (:func:`route`);
  the card and the CPU take every k the reference takes.
* ``rbf_affinity`` — K9, replaces ``rbf_affinity_pallas`` /
  ``_pairwise_kernel``.  ``exp(−sqrt(d2)/(2σ²))`` over the dense (N, M)
  block; 2·N·M·D flops: bound by operations at a meta-batch's shape.
  Output-tiled (rows per tile from :func:`rbf_plan`), 16-byte stores
  along j, edges masked.

Each wrapper counts its launches in ``<wrapper>.launches`` (one per call,
the packing and K8's merge pass included);
:func:`repro_torch.kernels.graph_reg.launch_counts` reports them with the
other kernels'.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .boundary import bounded
from .graph_reg import _checked, _on_cpu, _raise_on, _stream
from .tuning import TileSpec, refuse_pinned

__all__ = ["knn_topk", "rbf_affinity", "K_MAX", "route", "knn_plan",
           "rbf_plan", "launch_plan", "WRAPPERS", "OCCUPANCY_KERNELS",
           "occupancy", "SOURCE"]

SOURCE = "src/repro_torch/csrc/pairwise.cu"

#: Largest k of the streaming top-k kernel's shared-memory route (``kKMax``
#: in ``csrc/pairwise.cu``): a block's 128 running lists of k (d2, index)
#: pairs live in shared memory, 120 KB at k = 120, beside the operand ring
#: and the candidate buffers.  Past it the lists live in global memory
#: (the global route).
K_MAX = 120

# The launch plans' constants (``csrc/d2_tile.cuh``, ``csrc/pairwise.cu``).
D2_ROWS, D2_COLS, D2_K, D2_STAGES, D2_THREADS = 128, 128, 32, 2, 256
LIST_ENTRY_BYTES = 8          # a (float d2, int index) pair
CAND_CAP = 32                 # candidates a row buffers per merge round
MAX_SEGMENTS = 16
MIN_SEGMENT_TILES = 4
SEGMENT_BYTES_CAP = 256 << 20


def route(k: int) -> str:
    """Where K8 keeps its running lists for this k: ``"shared"`` (shared
    memory, k ≤ :data:`K_MAX`) or ``"global"`` (the rows of the outputs or
    of the segments' partial lists).  Chosen by k alone; both give the same
    lists."""
    return "shared" if k <= K_MAX else "global"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _features(D: int) -> int:
    """Padded feature count of the packed copies: whole slabs, at least one."""
    return _cdiv(max(D, 1), D2_K) * D2_K


def knn_plan(N: int, M: int, D: int, k: int, *, same: bool,
             n_sm: int) -> dict:
    """K8's launch plan on a card of ``n_sm`` SMs, as ``knn_plan`` in the
    source computes it: column segments (the fewest S that minimise
    ceil(strips·S / n_sm)·ceil(tiles / S), the tiles one SM walks with one
    block at a time; at most ``MAX_SEGMENTS``, each at least
    ``MIN_SEGMENT_TILES`` tiles, their partial lists within
    ``SEGMENT_BYTES_CAP``), tiles a segment, dynamic shared memory and
    workspace bytes (the packed copies, then the partial lists when there
    is more than one segment).  ``same``: x and y are the same rows."""
    n_strips, n_tiles = _cdiv(N, D2_ROWS), _cdiv(M, D2_COLS)
    s_max = min(MAX_SEGMENTS, n_tiles // MIN_SEGMENT_TILES,
                SEGMENT_BYTES_CAP // (N * k * LIST_ENTRY_BYTES))
    s = min(range(1, max(s_max, 1) + 1),
            key=lambda t: (_cdiv(n_strips * t, n_sm) * _cdiv(n_tiles, t), t))
    seg_tiles = _cdiv(n_tiles, s)
    segments = _cdiv(n_tiles, seg_tiles)
    smem = (4 * D2_STAGES * D2_K * (D2_ROWS + D2_COLS)
            + D2_ROWS * CAND_CAP * LIST_ENTRY_BYTES
            + D2_THREADS * LIST_ENTRY_BYTES + D2_ROWS * 12
            + (D2_ROWS * k * LIST_ENTRY_BYTES if k <= K_MAX else 0))
    packed = _features(D) * (n_strips * D2_ROWS
                             + (0 if same else n_tiles * D2_COLS))
    lists = segments * N * k * LIST_ENTRY_BYTES if segments > 1 else 0
    return {"segments": segments, "seg_tiles": seg_tiles,
            "dynamic_smem_bytes": smem, "workspace_bytes": 4 * packed + lists}


def rbf_plan(N: int, M: int, D: int, *, same: bool, n_sm: int) -> dict:
    """K9's launch plan on a card of ``n_sm`` SMs, as the source's
    ``rbf_affinity_plan``: 128-row tiles, or 64 where that leaves each SM
    fewer rows of tiles to run; workspace bytes (the packed copies)."""
    ct = _cdiv(M, D2_COLS)
    at = {rows: _cdiv(_cdiv(N, rows) * ct, n_sm) * rows for rows in (128, 64)}
    packed = _features(D) * (_cdiv(N, D2_ROWS) * D2_ROWS
                             + (0 if same else ct * D2_COLS))
    return {"rows_per_block": 64 if at[64] < at[128] else 128,
            "workspace_bytes": 4 * packed}


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "knn_topk_plan": (_I, _I, _I, _I, _I, _P, _P, _P),
    "knn_topk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "rbf_affinity_plan": (_I, _I, _I, _I, _P, _P),
    "rbf_affinity": (_P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
    "pairwise_occupancy": (_I, _I, _I, _P, _P, _P),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("pairwise")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


#: The kernels ``pairwise_occupancy`` answers for, by index: each one's
#: mangled name from its length on, as the compiler's report names it, in
#: the order of the source's ``kOccupancy`` table.
OCCUPANCY_KERNELS = ("15knn_topk_kernelILb0ELb1E",
                     "15knn_topk_kernelILb0ELb0E",
                     "15knn_topk_kernelILb1ELb0E",
                     "18knn_merge_segmentsE",
                     "6pack_tE",
                     "19rbf_affinity_kernelILi64E",
                     "19rbf_affinity_kernelILi128E")


def occupancy(symbol: str, threads: int, dynamic_smem: int) -> dict:
    """Resident blocks an SM, registers and static shared memory of kernel
    ``symbol`` (:data:`OCCUPANCY_KERNELS`) on the current card, as the
    runtime reads them (builds the library)."""
    return build.occupancy(_lib(), "pairwise", OCCUPANCY_KERNELS, symbol,
                           threads, dynamic_smem)


def _operands(x: torch.Tensor, y: torch.Tensor):
    """x (N, D) and y (M, D) as contiguous float32, their squared row norms
    (the same tensor twice when x is y), and whether they are the same rows
    (the entry points then pack one copy)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x and y must be (N, D) and (M, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    same = y is x
    x = x.to(torch.float32).contiguous()
    y = x if same else y.to(torch.float32).contiguous()
    nx = torch.sum(x * x, dim=1)
    ny = nx if same else torch.sum(y * y, dim=1)
    # The source's same_rows: one pointer and one row count.
    same = x.data_ptr() == y.data_ptr() and x.shape[0] == y.shape[0]
    return x, y, nx, ny, same


def launch_plan(name: str, N: int, M: int, D: int, k: int | None = None, *,
                same: bool) -> dict:
    """The launch plan of one K8 (``"knn_topk"``, with ``k``) or K9
    (``"rbf_affinity"``) call on the current card, as the library computes
    it (keys as :func:`knn_plan` / :func:`rbf_plan`, without
    ``seg_tiles``)."""
    a, b = ctypes.c_int(), ctypes.c_int()
    ws = ctypes.c_int64()
    if name == "knn_topk":
        rc = _lib().knn_topk_plan(N, M, D, k, int(same), ctypes.byref(a),
                                  ctypes.byref(b), ctypes.byref(ws))
        _raise_on(rc, "knn_topk_plan")
        return {"segments": a.value, "dynamic_smem_bytes": b.value,
                "workspace_bytes": ws.value}
    rc = _lib().rbf_affinity_plan(N, M, D, int(same), ctypes.byref(a),
                                  ctypes.byref(ws))
    _raise_on(rc, "rbf_affinity_plan")
    return {"rows_per_block": a.value, "workspace_bytes": ws.value}


def _workspace(plan: dict, device: torch.device) -> torch.Tensor:
    """A workspace of the plan's bytes (16-byte aligned, as every PyTorch
    allocation on the card)."""
    return torch.empty(plan["workspace_bytes"], dtype=torch.uint8,
                       device=device)


@bounded("knn_topk")
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
    x, y, nx, ny, same = _operands(x, y)
    N, D = x.shape
    d2 = torch.empty(N, k, dtype=torch.float32, device=x.device)
    idx = torch.empty(N, k, dtype=torch.int32, device=x.device)
    if N == 0:
        return d2, idx
    work = _workspace(launch_plan("knn_topk", N, M, D, k, same=same),
                      x.device)
    rc = _lib().knn_topk(x.data_ptr(), y.data_ptr(),
                         _checked(nx, "nx", (N,)), _checked(ny, "ny", (M,)),
                         N, M, D, k, int(exclude_self), work.data_ptr(),
                         d2.data_ptr(), idx.data_ptr(), _stream(x))
    _raise_on(rc, "knn_topk")
    knn_topk.launches += 1
    return d2, idx


@bounded("rbf_affinity")
def rbf_affinity(x: torch.Tensor, y: torch.Tensor, sigma: float, *,
                 tiles: TileSpec | None = None) -> torch.Tensor:
    """K9: the dense RBF affinity block exp(−‖x_i − y_j‖/(2σ²)), (N, M)
    float32.  ``sigma`` is a Python float."""
    if _on_cpu(x, y):
        return ref.rbf_affinity_ref(x, y, sigma)
    refuse_pinned(tiles, "rbf_affinity")
    x, y, nx, ny, same = _operands(x, y)
    N, D = x.shape
    M = y.shape[0]
    out = torch.empty(N, M, dtype=torch.float32, device=x.device)
    if N == 0 or M == 0:
        return out
    work = _workspace(launch_plan("rbf_affinity", N, M, D, same=same),
                      x.device)
    rc = _lib().rbf_affinity(x.data_ptr(), y.data_ptr(),
                             _checked(nx, "nx", (N,)),
                             _checked(ny, "ny", (M,)), N, M, D, float(sigma),
                             work.data_ptr(), out.data_ptr(), _stream(x))
    _raise_on(rc, "rbf_affinity")
    rbf_affinity.launches += 1
    return out


WRAPPERS = {"knn_topk": knn_topk, "rbf_affinity": rbf_affinity}
for _fn in WRAPPERS.values():
    _fn.launches = 0
