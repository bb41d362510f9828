"""Hopper kernels K1–K3 and K10 of the Eq.-3/4 graph regularizer, and their
wrappers.

The regularizer over one dense (meta-)batch affinity block is

    L(logp, W) = gc·Σ_ij W_ij·Hc(p_i, p_j) − Σ_i (κ + ge·Σ_j W_ij)·H(p_i)

with Hc(p_i, p_j) = −Σ_c p_ic log p_jc and H(p_i) = −Σ_c p_ic log p_ic; the
scalar triple (gc, κ, ge) is (γ, κ, γ) for the full regularizer and (1, 0, 0)
for the bare cross term.  Each wrapper below launches one kernel of
``csrc/graph_reg.cu`` for CUDA tensors, runs its plain version from
:mod:`repro_torch.kernels.ref` for CPU tensors, and raises for anything
else.  A CUDA tensor never reaches the plain version.

Source notes (P = padded meta-batch, 2176 on the paper's path; C = 39
classes; bounds for one worker on an H100 SXM, 3.35 TB/s and 67 TFLOP/s
f32 without tensor cores):

* ``reg_forward`` — K1, replaces ``repro/kernels/graph_reg.py:
  _fused_reg_forward`` / ``_fused_reg_kernel``.  Reads W once (P²·4 B =
  18.9 MB, 5.7 µs) and does 2·P²·C flops for P·logPᵀ (5.5 µs): bound by
  bytes, barely.  The Pallas kernel added every grid step into one (1,1)
  output, which needs the TPU's ordered grid.  Here the sum is split into
  256 fixed-order chains per 32-row strip, one per thread of the strip
  kernel it replaces; a chain touches four rows, so each is one warp's,
  and blocks of 4-row warps are sized to fill every SM once.  Each block
  streams logP, P and W tiles through a cp.async ring and computes its S
  tiles with 16-byte shared-memory reads.  Pass 1 writes every chain's
  value; pass 2 adds each strip's 256 by the old block tree and the
  strips in order.  No atomics, and the bits are those of the strip
  kernel.  At narrow B and wide C (the LM heads, e.g. (1, 16, 151936)),
  where that plan is at its least (4 rows a block) and C spans more than
  4 of its class chunks, K1 takes the class-split plan instead
  (:func:`fwd_plan`): blocks own a class chunk of a 64 × 64 tile of
  P·logPᵀ and write its partial; a second pass adds the chunks in order
  and forms L.  Bound there by reading P and logP once (5.8 µs at
  (1, 16, 151936)); its sums have their own fixed order.
* ``reg_bwd_dlogp`` — K2, replaces ``_reg_bwd_dlogp`` /
  ``_reg_bwd_dlogp_kernel``.  Two products with W (W·logP and Wᵀ·P),
  4·P²·C flops (11 µs): bound by operations.  Every output is one fmaf
  chain over all j, so blocks own rows and all classes (C rounded up to
  4): a cluster of two blocks per rows, sized to fill every SM once, one
  summing W·logP and the degrees from 32-j pieces of W's rows and of
  logP, the other Wᵀ·P from W's columns and P, both through cp.async
  rings, 2 rows × 4 classes a thread; the second hands its tile to the
  first through distributed shared memory.  The Pallas wrapper's square
  re-padding of W becomes edge masks.  That is the row route.  At narrow
  B and wide C (B ≤ ``DC_MAX_ROWS``, C past one 128-class chunk: every LM
  head, never the paper's B = 2176, C = 39) K2 takes its class route
  (:func:`dlogp_plan`): one kernel, no cluster, no class padding and no
  workspace; a block owns a span of classes, all B rows and a worker,
  stages W, Wᵀ and the degrees in shared memory once and streams its
  span's logP and P through a cp.async ring, 4 classes × 4 rows a
  thread.  Bound there by bytes (P and logP read once, dlogp written
  once: 8.7 µs at (1, 16, 151936)).  Its chains are the row route's, so
  the two routes give the same bits.
* ``reg_bwd_dw`` — K3, replaces ``_reg_bwd_dw`` / ``_reg_bwd_dw_kernel``.
  Writes the P×P dW once (18.9 MB, 5.7 µs) and does 2·P²·C flops (5.5
  µs): bound by bytes, barely.  Output-tiled, redesigned for Hopper: each
  block computes a 64×128 tile of P·logPᵀ from P and logP rows staged
  once, class-major, in shared memory (4×8 values a thread), adds ge·H_i
  (one entropy per row per block) and writes the tile with 16-byte
  streaming stores.  Its body (``dw_tile``) is K7's, so the two agree bit
  for bit on a full mask.  Training never asks for it (W carries no
  gradient).

* ``reg_pairwise`` — K10, replaces ``graph_reg_pairwise_pallas`` /
  ``_graph_reg_kernel``: the bare cross term −Σ W⊙(P·logPᵀ) of one
  (B, C) block, no worker axis.  K1's strip kernel compiled without the
  degree and entropy terms, with K1's ordered second pass, so it equals
  K1 at (1, 0, 0); same bytes and bound as K1.

All four are FMA loops in f32 (no TF32, no tensor cores, whose sums would
run in another order).

On ``meta`` tensors (the dry run, :mod:`repro_torch.launch`) K1 and K2
take their shape rules: one custom op each, ``repro_torch::graph_reg_fwd``
and ``repro_torch::graph_reg_bwd_dlogp``, whose only implementation makes
empty ``meta`` outputs of the kernel's shape and dtype, and whose FLOP
formula (:func:`reg_forward_flops`, :func:`reg_bwd_dlogp_flops`) is the
one ``chip_smoke.py`` bounds the kernel by.  Neither the kernel nor the
plain version runs, and nothing is launched or counted.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``; :func:`launch_counts`
reports them together with those of the block-sparse kernels K4–K7
(:mod:`.graph_reg_bsp`), the graph-construction kernels K8–K9
(:mod:`.pairwise`) and the attention kernel K11 (:mod:`.flash_attention`).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, ref
from .boundary import bounded

__all__ = ["reg_forward", "reg_bwd_dlogp", "reg_bwd_dw", "reg_pairwise",
           "fwd_plan", "class_split", "dlogp_route", "dlogp_plan",
           "launch_plan", "launch_counts", "reset_launch_counts",
           "OCCUPANCY_KERNELS", "occupancy", "SOURCE"]

SOURCE = "src/repro_torch/csrc/graph_reg.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "graph_reg_fwd_workspace": (_I, _I, _I),
    "graph_reg_bwd_dlogp_workspace": (_I, _I, _I),
    "graph_reg_fwd_plan": (_I, _I, _I, _P, _P, _P, _P),
    "graph_reg_bwd_dlogp_plan": (_I, _I, _I, _P, _P, _P, _P, _P),
    "graph_reg_fwd": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P),
    "graph_reg_pairwise": (_P, _P, _P, _I, _I, _P, _P, _P),
    "graph_reg_bwd_dlogp": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P,
                            _P),
    "graph_reg_bwd_dw": (_P, _P, _P, _I, _I, _I, _F, _F, _P, _P),
    "graph_reg_occupancy": (_I, _I, _I, _P, _P, _P),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("graph_reg")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


#: The kernels ``graph_reg_occupancy`` answers for, by index: each one's
#: mangled name from its length on, as the compiler's report names it, in
#: the order of the source's ``kOccupancy`` table.
OCCUPANCY_KERNELS = ("16reg_fwd_partialsILb1E",
                     "16reg_fwd_partialsILb0E",
                     "13reg_bwd_dlogpE",
                     "10reg_bwd_dwE",
                     "11pad_classesE",
                     "16reg_fwd_tree_sumE",
                     "22reg_fwd_class_partialsE",
                     "17reg_fwd_class_sumE",
                     "21reg_bwd_dlogp_classesE")


def occupancy(symbol: str, threads: int, dynamic_smem: int) -> dict:
    """Resident blocks an SM, registers and static shared memory of kernel
    ``symbol`` (:data:`OCCUPANCY_KERNELS`) on the current card, as the
    runtime reads them (builds the library)."""
    return build.occupancy(_lib(), "graph_reg", OCCUPANCY_KERNELS, symbol,
                           threads, dynamic_smem)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for all-CPU inputs, False for all-CUDA ones; raise otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"the kernels take CPU or CUDA tensors, all on one "
                     f"device; got {sorted(kinds)}")


def _on_meta(*tensors: torch.Tensor) -> bool:
    """True for all-``meta`` inputs, which take a kernel's shape rule."""
    return all(t.device.type == "meta" for t in tensors)


def reg_forward_flops(k: int, B: int, C: int) -> float:
    """K1's operations: P·logPᵀ (2·B²·C a worker), its sum against W and
    the degrees (2·B²), the entropies (4·B·C)."""
    return k * (2.0 * B * B * C + 2.0 * B * B + 4.0 * B * C)


def reg_bwd_dlogp_flops(k: int, B: int, C: int) -> float:
    """K2's operations: W·logP and Wᵀ·P (4·B²·C a worker), the degrees
    (B²) and the elementwise terms (8·B·C)."""
    return k * (4.0 * B * B * C + B * B + 8.0 * B * C)


@torch.library.custom_op("repro_torch::graph_reg_fwd", mutates_args=())
def _reg_forward_rule(logp: torch.Tensor, W: torch.Tensor,
                      p: torch.Tensor) -> torch.Tensor:
    raise RuntimeError("graph_reg_fwd's shape rule runs on meta tensors only")


@_reg_forward_rule.register_fake
def _(logp, W, p):
    return logp.new_empty(logp.shape[0])


@register_flop_formula(torch.ops.repro_torch.graph_reg_fwd)
def _(logp_shape, W_shape, p_shape, **_):
    return reg_forward_flops(*logp_shape)


@torch.library.custom_op("repro_torch::graph_reg_bwd_dlogp", mutates_args=())
def _reg_bwd_dlogp_rule(logp: torch.Tensor, W: torch.Tensor, g: torch.Tensor,
                        p: torch.Tensor) -> torch.Tensor:
    raise RuntimeError("graph_reg_bwd_dlogp's shape rule runs on meta "
                       "tensors only")


@_reg_bwd_dlogp_rule.register_fake
def _(logp, W, g, p):
    return torch.empty_like(logp, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.graph_reg_bwd_dlogp)
def _(logp_shape, W_shape, g_shape, p_shape, **_):
    return reg_bwd_dlogp_flops(*logp_shape)


def _checked(t: torch.Tensor, name: str, shape: tuple,
             dtype: torch.dtype = torch.float32) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def _dims(logp: torch.Tensor) -> tuple[int, int, int]:
    if logp.dim() != 3:
        raise ValueError(f"the CUDA kernels take a worker axis: logp must be "
                         f"(k, B, C), got {tuple(logp.shape)}")
    return tuple(logp.shape)


def _workspace(lib: ctypes.CDLL, name: str, k: int, B: int, C: int,
               device: torch.device) -> torch.Tensor:
    """The workspace of one launch of ``lib``'s entry point ``name`` (K1 /
    K10 ``"graph_reg_fwd"``, K2 ``"graph_reg_bwd_dlogp"``, K4
    ``"graph_reg_bsp_fwd"``, K6 ``"graph_reg_bsp_dlogp"``), of the size
    the library gives."""
    n = getattr(lib, f"{name}_workspace")(k, B, C)
    if n < 0:
        raise RuntimeError(f"{name}_workspace({k}, {B}, {C}) could not ask "
                           f"the device for its SM count")
    return torch.empty(n, dtype=torch.float32, device=device)


def _plan(lib: ctypes.CDLL, name: str, *dims: int,
          extra: tuple[str, ...] = ()) -> dict:
    """Rows per block and dynamic shared memory (bytes) of one launch of
    ``lib``'s entry point ``name`` at ``dims``, from its ``_plan``, and the
    further outputs named in ``extra`` that this ``_plan`` writes."""
    outs = [ctypes.c_int() for _ in range(2 + len(extra))]
    _raise_on(getattr(lib, f"{name}_plan")(
        *dims, *map(ctypes.byref, outs)), f"{name}_plan")
    return dict(zip(("rows_per_block", "dynamic_smem_bytes", *extra),
                    (o.value for o in outs)))


# The launch plans' constants (``csrc/graph_reg_tiles.cuh``): K1's
# pipeline and K2's ring; K1's class-split plan (``csrc/graph_reg.cu``).
FWD_SPAN, FWD_CHUNK, FWD_STAGES, FWD_MAX_PAIRS = 128, 64, 3, 8
SUM_THREADS = 256              # partials a 32-row strip (kThreads)
CS_SLAB, CS_TILE, CS_STAGES, CS_MAX_GROUPS = 128, 64, 3, 32
CS_STRIDE = CS_SLAB + 4        # floats a staged row (kCsStride)
CS_SUM_THREADS = 256           # pass 2's block (kCsSumThreads)
DL_PIECE, DL_MAX_ROWS, DL_MAX_QUADS, DL_MAX_THREADS = 32, 64, 32, 512
DL_STAGES = 2                  # K2's ring (kDlStages)
# K2's class route (``csrc/graph_reg.cu``): the widest B it takes, rows
# of a row group (a thread's register tile), warps a block shares among
# its groups, ring depth, the least span and the blocks an SM its spans
# fill it with; its launch bounds give each group of the widest B a warp.
DC_MAX_ROWS, DC_ROWS, DC_WARPS, DC_STAGES = 64, 4, 8, 3
DC_MIN_SPAN, DC_SM_BLOCKS = 128, 2
DC_MAX_THREADS = 32 * (DC_MAX_ROWS // DC_ROWS)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rows_to_fill(rows_total: int, n_sm: int, step: int,
                  max_rows: int) -> int:
    """``rows_to_fill`` of the source: as few rows a block (units of
    ``step``, at most ``max_rows``) as fill each SM once."""
    rows = _cdiv(_cdiv(rows_total, n_sm), step) * step
    return step if rows < step else min(rows, max_rows)


def fwd_smem_floats(rows: int, C: int) -> int:
    """``fwd_smem_floats`` of the source: K1's ring and P rows."""
    width = min(_cdiv(C, 4) * 4, FWD_CHUNK)
    stride = 4 * ((width // 4) | 1)
    stage = FWD_SPAN * stride + rows * FWD_SPAN + (rows * stride
                                                   if C > width else 0)
    return FWD_STAGES * stage + (0 if C > width else rows * stride)


def class_split(k: int, B: int, C: int, *, n_sm: int) -> bool:
    """``cs_takes`` of the source: K1 and K10 take the class-split plan
    where the row plan is at its least (4 rows a block: k·32·⌈B/32⌉ rows
    fill no SM past 4) and C spans more than 4 of its class chunks
    (C > 4·``FWD_CHUNK`` = 256).  The paper's shapes (B = 2176, C 39)
    never do; every LM head does."""
    return (_rows_to_fill(k * 32 * _cdiv(B, 32), n_sm, 4,
                          4 * FWD_MAX_PAIRS) == 4
            and C > 4 * FWD_CHUNK)


def _class_groups(B: int) -> int:
    """``cs_groups`` of the source: class groups of a pass-1 block, the
    most (a power of two, at most ``CS_MAX_GROUPS``) whose ⌈min(B, 64)/4⌉²
    threads each fit 256."""
    q = _cdiv(min(B, CS_TILE), 4) ** 2
    g = 1
    while 2 * g <= CS_MAX_GROUPS and 2 * g * q <= SUM_THREADS:
        g *= 2
    return g


def fwd_plan(k: int, B: int, C: int, *, n_sm: int) -> dict:
    """K1's (and K10's) launch plan on a card of ``n_sm`` SMs, as the
    source's ``graph_reg_fwd_plan``.

    ``route`` ``"rows"``: the fewest rows a block (4 a warp, at most
    ``FWD_MAX_PAIRS`` warps) that fill each SM once; the workspace holds
    the partials, then the class-padded logP; ``class_chunk`` 0.

    ``route`` ``"classes"`` (:func:`class_split`): pass-1 blocks of 256
    threads own a ``class_chunk`` of C (whole 128-class slabs, as many as
    still give every SM a block) of a min(B, 64)-square tile of P·logPᵀ
    (``rows_per_block``) and worker; the workspace holds one (B, B)
    partial a chunk and worker.  ``blocks`` counts pass 1's blocks."""
    if class_split(k, B, C, n_sm=n_sm):
        slabs, nt = _cdiv(C, CS_SLAB), _cdiv(B, CS_TILE)
        per = min(max(slabs * nt * nt * k // n_sm, 1), slabs)
        chunk = CS_SLAB * per
        n_chunks = _cdiv(C, chunk)
        quads, groups = _cdiv(min(B, CS_TILE), 4), _class_groups(B)
        ring = CS_STAGES * 2 * 4 * quads * CS_STRIDE
        return {"route": "classes", "rows_per_block": min(B, CS_TILE),
                "class_chunk": chunk, "class_chunks": n_chunks,
                "class_groups": groups, "blocks": n_chunks * nt * nt * k,
                "dynamic_smem_bytes": 4 * max(ring,
                                              groups * quads * quads * 16),
                "workspace_floats": k * n_chunks * B * B}
    rows = _rows_to_fill(k * 32 * _cdiv(B, 32), n_sm, 4, 4 * FWD_MAX_PAIRS)
    return {"route": "rows", "rows_per_block": rows, "class_chunk": 0,
            "blocks": k * _cdiv(8 * _cdiv(B, 32), rows // 4),
            "dynamic_smem_bytes": 4 * fwd_smem_floats(rows, C),
            "workspace_floats": k * _cdiv(B, 32) * SUM_THREADS
            + k * B * _cdiv(C, 4) * 4}


def class_split_chain(B: int, plan: dict) -> int:
    """The longest float32 chain a term of K1's L runs through on the
    class-split ``plan`` (:func:`fwd_plan`): class_chunk/class_groups
    classes a class group, the groups, the chunks, then pass 2's
    ⌈B²/``CS_SUM_THREADS``⌉ entries a thread, its 5 warp-butterfly steps
    and its ``CS_SUM_THREADS``/32 warps.  Round-off grows with it, not
    with C."""
    return (plan["class_chunk"] // plan["class_groups"]
            + plan["class_groups"] + plan["class_chunks"]
            + _cdiv(B * B, CS_SUM_THREADS) + 5 + CS_SUM_THREADS // 32)


def dlogp_route(B: int, C: int) -> str:
    """``dc_takes`` of the source: K2's class route where B ≤
    ``DC_MAX_ROWS`` and C spans more than one of the row route's 128-class
    chunks (every LM head), its row route elsewhere (the paper's
    shapes)."""
    return ("classes" if B <= DC_MAX_ROWS and C > 4 * DL_MAX_QUADS
            else "rows")


def dlogp_plan(k: int, B: int, C: int, *, n_sm: int) -> dict:
    """K2's launch plan on a card of ``n_sm`` SMs, as the source's
    ``graph_reg_bwd_dlogp_plan``.

    ``route`` ``"rows"``: rows a block (a multiple of 4, at most
    ``DL_MAX_ROWS`` and what ``DL_MAX_THREADS`` threads of 2 rows × 4
    classes hold) that fill the card's n_sm/2 cluster slots once; dynamic
    shared memory (the ring) and workspace floats (class-padded P and
    logP); ``class_span`` 0.

    ``route`` ``"classes"`` (:func:`dlogp_route`): a block owns a
    ``class_span`` of C (a multiple of 4, at least ``DC_MIN_SPAN``, sized
    so that the blocks of all k workers fill each SM with
    ``DC_SM_BLOCKS``) and all B rows (``rows_per_block``); its threads
    are ⌈B/``DC_ROWS``⌉ row groups of whole warps (``DC_WARPS`` shared
    among them, one each at least), 4 classes a thread, and it streams
    the span in tiles of ``tile_classes``; its dynamic shared memory
    holds the ring of ``DC_STAGES`` tiles of logP and P rows, W and Wᵀ (B
    rows of the groups' rows each) and the degrees; no workspace.
    ``blocks`` and ``threads`` are the launch's."""
    if dlogp_route(B, C) == "classes":
        span = max(4 * _cdiv(_cdiv(C, 4), _cdiv(DC_SM_BLOCKS * n_sm, k)),
                   DC_MIN_SPAN)
        groups = _cdiv(B, DC_ROWS)
        tile = min(128 * max(DC_WARPS // groups, 1), span)
        return {"route": "classes", "rows_per_block": B,
                "class_span": span, "tile_classes": tile,
                "blocks": k * _cdiv(C, span),
                "threads": groups * 32 * _cdiv(tile, 128),
                "dynamic_smem_bytes": 4 * (DC_STAGES * 2 * B * tile
                                           + (2 * B + 1) * DC_ROWS * groups),
                "workspace_floats": 0}
    quads = min(_cdiv(C, 4), DL_MAX_QUADS)
    n_chunks = _cdiv(C, 4 * DL_MAX_QUADS)
    max_rows = min(2 * (DL_MAX_THREADS // quads), DL_MAX_ROWS) & ~3
    rows = _rows_to_fill(k * n_chunks * B, n_sm // 2 if n_sm > 1 else 1, 4,
                         max_rows)
    return {"route": "rows", "rows_per_block": rows, "class_span": 0,
            "blocks": 2 * _cdiv(B, rows) * n_chunks * k,
            "threads": rows // 2 * quads,
            "dynamic_smem_bytes": 4 * DL_STAGES * DL_PIECE
            * (rows + 4 * quads),
            "workspace_floats": 2 * k * B * _cdiv(C, 4) * 4}


def launch_plan(name: str, k: int, B: int, C: int) -> dict:
    """Rows per block and dynamic shared memory (bytes) of one K1 / K10
    (``"graph_reg_fwd"``, also its ``class_chunk``, 0 on the row plan, and
    pass 1's ``blocks``) or K2 (``"graph_reg_bwd_dlogp"``, also its
    ``class_span``, 0 on the row route, ``blocks`` and ``threads``) launch
    on the current card, as the library computes them."""
    return _plan(_lib(), name, k, B, C,
                 extra=(("class_chunk", "blocks") if name == "graph_reg_fwd"
                        else ("class_span", "blocks", "threads")))


@bounded("graph_reg_fwd")
def reg_forward(logp: torch.Tensor, W: torch.Tensor, gc: float, kappa: float,
                ge: float, *, p: torch.Tensor | None = None) -> torch.Tensor:
    """K1: the fused regularizer per worker.  logp (k, B, C), W (k, B, B)
    -> (k,).  ``p`` is ``exp(logp)`` when the caller already has it."""
    if _on_meta(logp, W):
        _dims(logp)
        return _reg_forward_rule(logp, W,
                                 torch.exp(logp) if p is None else p)
    if _on_cpu(logp, W):
        return ref.reg_forward_ref(logp, W, gc, kappa, ge)
    k, B, C = _dims(logp)
    p = torch.exp(logp) if p is None else p
    work = _workspace(_lib(), "graph_reg_fwd", k, B, C, logp.device)
    out = torch.empty(k, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_fwd(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(W, "W", (k, B, B)), k, B, C, gc, kappa, ge,
        work.data_ptr(), out.data_ptr(), _stream(logp))
    _raise_on(rc, "graph_reg_fwd")
    reg_forward.launches += 1
    return out


@bounded("graph_reg_pairwise")
def reg_pairwise(logp: torch.Tensor, W: torch.Tensor, *,
                 p: torch.Tensor | None = None) -> torch.Tensor:
    """K10: the bare cross term Σ_ij W_ij·Hc(p_i, p_j) of one block.
    logp (B, C), W (B, B) -> scalar."""
    if _on_cpu(logp, W):
        return ref.graph_reg_pairwise_ref(logp, W)
    if logp.dim() != 2:
        raise ValueError(f"K10 takes no worker axis: logp must be (B, C), "
                         f"got {tuple(logp.shape)}")
    B, C = logp.shape
    p = torch.exp(logp) if p is None else p
    work = _workspace(_lib(), "graph_reg_fwd", 1, B, C, logp.device)
    out = torch.empty((), dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_pairwise(
        _checked(p, "p", (B, C)), _checked(logp, "logp", (B, C)),
        _checked(W, "W", (B, B)), B, C, work.data_ptr(), out.data_ptr(),
        _stream(logp))
    _raise_on(rc, "graph_reg_pairwise")
    reg_pairwise.launches += 1
    return out


@bounded("graph_reg_bwd_dlogp")
def reg_bwd_dlogp(logp: torch.Tensor, W: torch.Tensor, g: torch.Tensor,
                  gc: float, kappa: float, ge: float, *,
                  p: torch.Tensor | None = None) -> torch.Tensor:
    """K2: dL/dlogp, (k, B, C), for the cotangent ``g`` of shape (k,).
    ``g`` stays on the device and the kernel reads it by pointer.  The
    library picks the route (:func:`dlogp_plan`) and sizes the workspace
    for it (none on the class route)."""
    if _on_meta(logp, W, g):
        _dims(logp)
        return _reg_bwd_dlogp_rule(logp, W, g,
                                   torch.exp(logp) if p is None else p)
    if _on_cpu(logp, W, g):
        return ref.reg_bwd_dlogp_ref(logp, W, g, gc, kappa, ge)
    k, B, C = _dims(logp)
    p = torch.exp(logp) if p is None else p
    work = _workspace(_lib(), "graph_reg_bwd_dlogp", k, B, C, logp.device)
    out = torch.empty(k, B, C, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_bwd_dlogp(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(W, "W", (k, B, B)), _checked(g, "g", (k,)), k, B, C, gc,
        kappa, ge, work.data_ptr(), out.data_ptr(), _stream(logp))
    _raise_on(rc, "graph_reg_bwd_dlogp")
    reg_bwd_dlogp.launches += 1
    return out


@bounded("graph_reg_bwd_dw")
def reg_bwd_dw(logp: torch.Tensor, g: torch.Tensor, gc: float, ge: float, *,
               p: torch.Tensor | None = None) -> torch.Tensor:
    """K3: dL/dW, (k, B, B), for the cotangent ``g`` of shape (k,)."""
    if _on_cpu(logp, g):
        return ref.reg_bwd_dw_ref(logp, g, gc, ge)
    k, B, C = _dims(logp)
    p = torch.exp(logp) if p is None else p
    out = torch.empty(k, B, B, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_bwd_dw(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(g, "g", (k,)), k, B, C, gc, ge, out.data_ptr(),
        _stream(logp))
    _raise_on(rc, "graph_reg_bwd_dw")
    reg_bwd_dw.launches += 1
    return out


WRAPPERS = {"graph_reg_fwd": reg_forward, "graph_reg_bwd_dlogp": reg_bwd_dlogp,
            "graph_reg_bwd_dw": reg_bwd_dw, "graph_reg_pairwise": reg_pairwise}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def _all_wrappers() -> dict:
    # they reuse this module's helpers
    from . import flash_attention, graph_reg_bsp, pairwise
    return {**WRAPPERS, **graph_reg_bsp.WRAPPERS, **pairwise.WRAPPERS,
            **flash_attention.WRAPPERS}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset, K1-K11."""
    return {name: fn.launches for name, fn in _all_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _all_wrappers().values():
        fn.launches = 0
