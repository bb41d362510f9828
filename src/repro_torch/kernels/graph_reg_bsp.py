"""Hopper kernels K4–K7 of the block-sparse Eq.-3/4 graph regularizer.

The block-sparse regularizer is the fused one (:mod:`.graph_reg`) over the
bt×bt tiles of W that a ``BlockLayout`` lists as occupied
(:mod:`repro_torch.core.metabatch`): the pipeline builds one per batch when
``BatchConfig.layout_bt`` is set, and the ``tile_*`` fields of the batch
carry its row-major list (``rows``, ``cols``, ``valid``), its column-major
list (``crows``, ``ccols``, ``cvalid``) and its occupancy mask ``occ``.
Each wrapper below launches one kernel of ``csrc/graph_reg_bsp.cu`` for
CUDA tensors, runs its plain version from :mod:`repro_torch.kernels.ref`
for CPU tensors, and raises for anything else.

Source notes (paper's path: P = 2176, C = 39, bt = 128, nt = 17, about 60
of the 289 tiles occupied; bounds for one worker on an H100 SXM, 3.35 TB/s
and 67 TFLOP/s f32 without tensor cores):

* ``bsp_forward`` — K4, replaces ``repro/kernels/graph_reg.py:
  _bsp_forward`` / ``_bsp_fwd_kernel``.  Reads the occupied tiles of W
  and logp (4.3 MB, 1.3 µs) and does 2·C flops per occupied entry
  (77 MFLOP, 1.1 µs): bound by bytes.  The Pallas kernel walks the list as
  one ordered grid and adds every step into one (1,1) output.  Here K1's
  pipeline (``csrc/graph_reg_tiles.cuh``) runs over the listed tiles:
  blocks of warps of one tile row (:func:`fwd_plan`) find their row's
  entries, compact its valid tiles into shared memory and stream their
  64-column pieces of W and of a class-padded logP through a ``cp.async``
  ring, with K1's chains and K1's second pass over the partials.
* ``bsp_bwd_bterm`` — K5, replaces ``_bsp_bwd`` pass 1 /
  ``_bsp_bterm_kernel``.  bterm = Wᵀ·P per output column strip over the
  column-major list, j increasing as in K2's Wᵀ·P.  Same bytes and flops
  as K4; bound in practice by the latency of each strip's serial sums.
  Redesigned for Hopper: blocks of 8 output rows (272 at the path's
  shape), the strip's list range found and compacted into shared memory
  by one warp, its 32-row pieces of W and P streamed through an 8-stage
  ``cp.async`` ring, the class chunk sized to C.
* ``bsp_bwd_dlogp`` — K6, replaces ``_bsp_bwd`` pass 2 /
  ``_bsp_dlogp_kernel``.  W·logP and the degrees over the row-major list,
  folding in K5's bterm (a (k, B, C) buffer; the two launches are ordered
  on one stream).  Redesigned for Hopper as the A half of K2's pipeline
  without its cluster: blocks of rows of one tile row (:func:`dlogp_plan`),
  2 rows × 4 classes a thread, the listed tiles' 32-j pieces of W and of a
  class-padded logP streamed through a ``cp.async`` ring.
* ``bsp_bwd_dw`` — K7, replaces ``_bsp_bwd`` pass 3 / ``_bsp_dw_kernel``.
  Writes the dense P×P dW (18.9 MB, 5.7 µs): bound by bytes.
  Redesigned for Hopper on K3's tile (``dw_tile`` in
  ``csrc/graph_reg_tiles.cuh``): 64×128 pieces, swizzled ``cp.async``
  staging, H from the staged rows and 16-byte streaming stores; a piece
  that touches no occupied tile stores its zeros and nothing else, a live
  one zeroes what lies off the occupied tiles.  Its values equal K3's bit
  for bit on a full mask.  Training never asks for it.

The kernels take any tile edge bt that is a positive multiple of 32 (a
block's rows lie in one tile row, in whole 32-row strips for K4's
chains); :func:`check_tile_edge`
raises for any other, naming the rule.  The plain versions take any bt.
On a full occupancy mask with bt a multiple of 64 the kernels repeat the
dense kernels' sums in the same order, so K4 equals K1 (one copy of the
pipeline, ``csrc/graph_reg_tiles.cuh``), K5∘K6 equals K2 and K7 equals
K3, bit for bit.  K4 and K6 write the class-padded logP into a workspace
the wrapper allocates, of the size the library gives (the plans'
``workspace_floats``).  Each wrapper counts its launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .boundary import bounded
from .graph_reg import (_checked, _dims, _on_cpu, _plan, _raise_on,
                        _stream, _workspace)

__all__ = ["bsp_forward", "bsp_bwd_bterm", "bsp_bwd_dlogp", "bsp_bwd_dw",
           "bterm_smem_bytes", "check_tile_edge", "fwd_plan", "dlogp_plan",
           "launch_plan", "WRAPPERS", "OCCUPANCY_KERNELS", "occupancy",
           "SOURCE"]

SOURCE = "src/repro_torch/csrc/graph_reg_bsp.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "graph_reg_bsp_fwd_workspace": (_I, _I, _I),
    "graph_reg_bsp_fwd_plan": (_I, _I, _I, _I, _I, _P, _P),
    "graph_reg_bsp_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _F, _F, _F, _P, _P, _P),
    "graph_reg_bsp_bterm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "graph_reg_bsp_bterm_smem": (_I, _I, _I, _I),
    "graph_reg_bsp_dlogp_workspace": (_I, _I, _I),
    "graph_reg_bsp_dlogp_plan": (_I, _I, _I, _I, _I, _P, _P),
    "graph_reg_bsp_dlogp": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _F, _F, _F, _P, _P, _P),
    "graph_reg_bsp_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P),
    "graph_reg_bsp_occupancy": (_I, _I, _I, _P, _P, _P),
}

# The launch plans' constants (``csrc/graph_reg_tiles.cuh`` and
# ``csrc/graph_reg_bsp.cu``): K4 runs K1's pipeline, K6 the A half of K2's.
FWD_SPAN, FWD_CHUNK, FWD_STAGES, FWD_MAX_PAIRS = 128, 64, 3, 8
SUM_THREADS = 256              # partials a 32-row strip (kThreads)
DL_PIECE, DL_MAX_ROWS, DL_MAX_QUADS, DL_MAX_THREADS = 32, 64, 32, 512
DLOGP_STAGES = 2               # K6's ring (kBsDlStages)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("graph_reg_bsp")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


#: The kernels ``graph_reg_bsp_occupancy`` answers for, by index: each one's
#: mangled name from its length on, as the compiler's report names it, in
#: the order of the source's ``kOccupancy`` table.
OCCUPANCY_KERNELS = ("16bsp_fwd_partialsE",
                     "13bsp_bwd_btermE",
                     "13bsp_bwd_dlogpE",
                     "10bsp_bwd_dwE")


def occupancy(symbol: str, threads: int, dynamic_smem: int) -> dict:
    """Resident blocks an SM, registers and static shared memory of kernel
    ``symbol`` (:data:`OCCUPANCY_KERNELS`) on the current card, as the
    runtime reads them (builds the library)."""
    return build.occupancy(_lib(), "graph_reg_bsp", OCCUPANCY_KERNELS, symbol,
                           threads, dynamic_smem)


def check_tile_edge(bt: int) -> None:
    """Raise unless the CUDA kernels can take tile edge ``bt``."""
    if not (isinstance(bt, int) and bt > 0 and bt % 32 == 0):
        raise ValueError(
            f"block-sparse kernels: tile edge bt={bt!r} is not a positive "
            f"multiple of 32 (a block owns 32 rows of one tile strip); "
            f"build the layout with such a BatchConfig.layout_bt")


def bterm_smem_bytes(B: int, C: int, T: int, bt: int) -> int:
    """Dynamic shared memory of one K5 launch at (B, C), list length T and
    tile edge bt, as the launch computes it (builds the library)."""
    return _lib().graph_reg_bsp_bterm_smem(B, C, T, bt)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad4(C: int) -> int:
    return _cdiv(C, 4) * 4


def fwd_plan(k: int, B: int, C: int, T: int, bt: int, *, n_sm: int) -> dict:
    """K4's launch plan on a card of ``n_sm`` SMs, as the source's
    ``graph_reg_bsp_fwd_plan`` computes it: blocks of a power of two of
    warps (4 rows each, at most ``FWD_MAX_PAIRS``) inside one tile row, the
    most that still fill every SM once; dynamic shared memory (K1's ring
    and P rows, then the compacted tile list) and workspace floats (K1's
    partials, then the class-padded logP)."""
    check_tile_edge(bt)
    lines = k * _cdiv(B, bt)
    pairs = FWD_MAX_PAIRS
    while pairs > 1 and lines * (bt // 4 // pairs) < n_sm:
        pairs //= 2
    rows = 4 * pairs
    width = min(_pad4(C), FWD_CHUNK)
    stride = 4 * ((width // 4) | 1)
    one_chunk = C <= width
    stage = FWD_SPAN * stride + rows * FWD_SPAN + (0 if one_chunk
                                                   else rows * stride)
    smem_floats = FWD_STAGES * stage + (rows * stride if one_chunk else 0)
    return {"rows_per_block": rows, "groups_per_tile_row": bt // rows,
            "dynamic_smem_bytes": 4 * smem_floats + 4 * min(T, _cdiv(B, bt)),
            "workspace_floats": k * _cdiv(B, 32) * SUM_THREADS
            + k * B * _pad4(C)}


def dlogp_plan(k: int, B: int, C: int, T: int, bt: int, *,
               n_sm: int) -> dict:
    """K6's launch plan on a card of ``n_sm`` SMs, as the source's
    ``graph_reg_bsp_dlogp_plan``: the most rows a block (a multiple of 4,
    at most ``DL_MAX_ROWS``, bt and what ``DL_MAX_THREADS`` threads of 2
    rows × 4 classes hold) that still fill every SM once; dynamic shared
    memory (the ring, then the compacted tile list) and workspace floats
    (the class-padded logP)."""
    check_tile_edge(bt)
    quads = min(_cdiv(C, 4), DL_MAX_QUADS)
    lines = k * _cdiv(C, 4 * DL_MAX_QUADS) * _cdiv(B, bt)
    rows = min(2 * (DL_MAX_THREADS // quads), DL_MAX_ROWS, bt) & ~3
    while rows > 4 and lines * _cdiv(bt, rows) < n_sm:
        rows -= 4
    return {"rows_per_block": rows, "groups_per_tile_row": _cdiv(bt, rows),
            "dynamic_smem_bytes": 4 * DLOGP_STAGES * DL_PIECE
            * (rows + 4 * quads) + 4 * min(T, _cdiv(B, bt)),
            "workspace_floats": k * B * _pad4(C)}


def launch_plan(name: str, k: int, B: int, C: int, T: int, bt: int) -> dict:
    """Rows per block and dynamic shared memory (bytes) of one K4
    (``"graph_reg_bsp_fwd"``) or K6 (``"graph_reg_bsp_dlogp"``) launch on
    the current card, as the library computes them."""
    return _plan(_lib(), name, k, B, C, T, bt)


def _lists(k: int, **lists: torch.Tensor) -> list[int]:
    """Pointers of one layout's three (k, T) int32 tile lists."""
    T = next(iter(lists.values())).shape[-1]
    return [_checked(t, name, (k, T), torch.int32)
            for name, t in lists.items()]


@bounded("graph_reg_bsp_fwd")
def bsp_forward(logp: torch.Tensor, W: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, valid: torch.Tensor, bt: int, gc: float,
                kappa: float, ge: float, *,
                p: torch.Tensor | None = None) -> torch.Tensor:
    """K4: the block-sparse fused regularizer per worker.  logp (k, B, C),
    W (k, B, B), the row-major list (k, T) int32 -> (k,)."""
    if _on_cpu(logp, W, rows, cols, valid):
        return ref.bsp_forward_ref(logp, W, rows, cols, valid, bt, gc, kappa,
                                   ge)
    k, B, C = _dims(logp)
    check_tile_edge(bt)
    p = torch.exp(logp) if p is None else p
    work = _workspace(_lib(), "graph_reg_bsp_fwd", k, B, C, logp.device)
    out = torch.empty(k, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_bsp_fwd(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(W, "W", (k, B, B)),
        *_lists(k, rows=rows, cols=cols, valid=valid), k, B, C,
        rows.shape[-1], bt, gc, kappa, ge, work.data_ptr(),
        out.data_ptr(), _stream(logp))
    _raise_on(rc, "graph_reg_bsp_fwd")
    bsp_forward.launches += 1
    return out


@bounded("graph_reg_bsp_bterm")
def bsp_bwd_bterm(logp: torch.Tensor, W: torch.Tensor, crows: torch.Tensor,
                  ccols: torch.Tensor, cvalid: torch.Tensor, bt: int, *,
                  p: torch.Tensor | None = None) -> torch.Tensor:
    """K5: bterm = Wᵀ·P over the column-major list, (k, B, C)."""
    if _on_cpu(logp, W, crows, ccols, cvalid):
        return ref.bsp_bwd_bterm_ref(logp, W, crows, ccols, cvalid, bt)
    k, B, C = _dims(logp)
    check_tile_edge(bt)
    p = torch.exp(logp) if p is None else p
    out = torch.empty(k, B, C, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_bsp_bterm(
        _checked(p, "p", (k, B, C)), _checked(W, "W", (k, B, B)),
        *_lists(k, crows=crows, ccols=ccols, cvalid=cvalid), k, B, C,
        crows.shape[-1], bt, out.data_ptr(), _stream(logp))
    _raise_on(rc, "graph_reg_bsp_bterm")
    bsp_bwd_bterm.launches += 1
    return out


@bounded("graph_reg_bsp_dlogp")
def bsp_bwd_dlogp(logp: torch.Tensor, W: torch.Tensor, bterm: torch.Tensor,
                  rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
                  g: torch.Tensor, bt: int, gc: float, kappa: float,
                  ge: float, *, p: torch.Tensor | None = None) -> torch.Tensor:
    """K6: dL/dlogp, (k, B, C), from K5's ``bterm`` and the row-major list,
    for the cotangent ``g`` of shape (k,), read by pointer."""
    if _on_cpu(logp, W, bterm, rows, cols, valid, g):
        return ref.bsp_bwd_dlogp_ref(logp, W, bterm, rows, cols, valid, g,
                                     bt, gc, kappa, ge)
    k, B, C = _dims(logp)
    check_tile_edge(bt)
    p = torch.exp(logp) if p is None else p
    work = _workspace(_lib(), "graph_reg_bsp_dlogp", k, B, C, logp.device)
    out = torch.empty(k, B, C, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_bsp_dlogp(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(W, "W", (k, B, B)), _checked(bterm, "bterm", (k, B, C)),
        _checked(g, "g", (k,)),
        *_lists(k, rows=rows, cols=cols, valid=valid), k, B, C,
        rows.shape[-1], bt, gc, kappa, ge, work.data_ptr(), out.data_ptr(),
        _stream(logp))
    _raise_on(rc, "graph_reg_bsp_dlogp")
    bsp_bwd_dlogp.launches += 1
    return out


@bounded("graph_reg_bsp_dw")
def bsp_bwd_dw(logp: torch.Tensor, occ: torch.Tensor, g: torch.Tensor,
               bt: int, gc: float, ge: float, *,
               p: torch.Tensor | None = None) -> torch.Tensor:
    """K7: dL/dW, (k, B, B), on the tiles ``occ`` (k, nt, nt) marks
    occupied and exact zeros elsewhere."""
    if _on_cpu(logp, occ, g):
        return ref.bsp_bwd_dw_ref(logp, occ, g, bt, gc, ge)
    k, B, C = _dims(logp)
    check_tile_edge(bt)
    nt = -(-B // bt)
    p = torch.exp(logp) if p is None else p
    out = torch.empty(k, B, B, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_bsp_dw(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(occ, "occ", (k, nt, nt), torch.int32),
        _checked(g, "g", (k,)), k, B, C, bt, gc, ge, out.data_ptr(),
        _stream(logp))
    _raise_on(rc, "graph_reg_bsp_dw")
    bsp_bwd_dw.launches += 1
    return out


WRAPPERS = {"graph_reg_bsp_fwd": bsp_forward,
            "graph_reg_bsp_bterm": bsp_bwd_bterm,
            "graph_reg_bsp_dlogp": bsp_bwd_dlogp,
            "graph_reg_bsp_dw": bsp_bwd_dw}
for _fn in WRAPPERS.values():
    _fn.launches = 0
