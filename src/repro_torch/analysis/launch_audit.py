"""Launch models of the port's CUDA kernels, and their checks (V-pass).

The counterpart of the reference's ``vmem_audit.py``.  Each of the 21
``__global__`` functions of ``src/repro_torch/csrc`` is mirrored here by a
static *launch model* — the grid, threads, cluster, dynamic and static
shared memory and ``__launch_bounds__`` its entry point uses, and for each
output the range every block writes — computed from a problem shape and
the card's SM count without touching a device.  The Python plan mirrors
that exist are reused (``pairwise.knn_plan`` / ``rbf_plan``,
``graph_reg_bsp.fwd_plan`` / ``dlogp_plan``, ``graph_reg.fwd_plan`` /
``dlogp_plan``).  From a model the checker proves:

  * ``V001`` — a block's dynamic + static shared memory fits the 227 KB
    (232,448 B) a block may opt into, and the blocks an SM that the
    ``__launch_bounds__`` minimum promises fit 228 KB (1 KB reserved a
    block) and 2,048 threads; on the card, the runtime's occupancy of the
    launch (:func:`occupancy`) holds at least that minimum;
  * ``V002`` — every 16-byte vector or ``cp.async`` access reads rows of a
    multiple of 16 bytes, and every TMA box's inner extent is 16-byte
    aligned and cut evenly by the 128-byte swizzle;
  * ``V003`` — the blocks of a launch cover each output exactly, write
    nothing past it, and divide into the launch's clusters;
  * ``V004`` — not applicable: the port has no first-match tuning table
    (``kernels/tuning.py`` refuses pinned tiles; the library computes its
    plans), so the id is never emitted;
  * ``V005`` — every ``__global__`` function of ``csrc/`` has a model whose
    ``__launch_bounds__`` are the source's, and (on the card,
    :func:`check_against_library`) every model's plan is the library's.

:mod:`.race_audit` proves ``W001`` from the same models.  The models are
evaluated at the shapes the port's paths run (:data:`DEFAULT_SHAPES`).
:func:`ptxas_entries` reads the compiler's report (``-Xptxas -v``,
:data:`repro_torch.kernels.build.REPORTS`) and :func:`occupancy` the
runtime's (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, through each
library's ``<name>_occupancy``).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import re
from pathlib import Path
from typing import Callable

import numpy as np

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import graph_reg, graph_reg_bsp, norm, pairwise

__all__ = [
    "Output",
    "Vector",
    "Launch",
    "DEFAULT_SHAPES",
    "N_SM",
    "SMEM_BLOCK_BYTES",
    "call_launches",
    "kernel_launches",
    "check_launch",
    "coverage",
    "source_kernels",
    "validate_launches",
    "check_against_library",
    "ptxas_entries",
    "occupancy",
    "REDESIGNED",
]

#: SMs of an H100 SXM (the card's own count is used on the card).
N_SM = 132
#: Shared memory a block may opt into, an SM's, and what a block reserves.
SMEM_BLOCK_BYTES = 232_448
SMEM_SM_BYTES = 228 * 1024
SMEM_RESERVED_BYTES = 1024
THREADS_SM = 2048
SWIZZLE_BYTES = 128

CSRC = Path(__file__).resolve().parents[1] / "csrc"


@dataclasses.dataclass(frozen=True)
class Output:
    """One output a launch writes: its shape and, for block (x, y, z), the
    boxes (a (lo, hi) pair a dimension) it writes, after the kernel's
    masks."""

    name: str
    shape: tuple[int, ...]
    writes: Callable[[int, int, int], list]
    #: grid axes (0 = x, 1 = y, 2 = z) along which blocks revisit the same
    #: elements and accumulate in a declared order (none in the port).
    accum_axes: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class Vector:
    """A 16-byte vector, ``cp.async`` or TMA access over rows of
    ``row_bytes``; ``box_inner_bytes`` is a TMA box's inner extent."""

    name: str
    row_bytes: int
    base_align: int = 16
    box_inner_bytes: int | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class Launch:
    """Static mirror of one kernel launch.  ``static_smem`` is the static
    shared memory the compiler gives the kernel (``-Xptxas -v`` for
    ``sm_90a``): K4's, K5's and K6's few ``__shared__`` ints take 16 bytes,
    and K1 drops K4's list counters; the card holds each model to the
    report."""

    kernel: str                        # the __global__ function
    variant: str                       # instantiation and shape
    source: str                        # csrc file holding the kernel
    symbol: str                        # its mangled name, from the length on
    grid: tuple[int, int, int]
    threads: int
    dynamic_smem: int
    static_smem: int
    launch_bounds: tuple[int, int]     # (max threads, min blocks an SM)
    cluster: tuple[int, int, int] = (1, 1, 1)
    outputs: tuple[Output, ...] = ()
    vectors: tuple[Vector, ...] = ()
    #: (library function, args, kwargs, expected plan items) for the card
    library: tuple | None = None

    @property
    def smem(self) -> int:
        return self.dynamic_smem + self.static_smem

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _sym(name: str, targs: str = "") -> str:
    return f"{len(name)}{name}" + (f"I{targs}" if targs else "E")


# ------------------------------------------------------------ the models
def _pad_classes(rows: int, C: int, two: bool) -> Launch:
    """``pad_classes`` (``csrc/graph_reg_tiles.cuh``): a grid-stride copy of
    rows of C floats into rows of C rounded up to 4, as float4s."""
    q4 = _cdiv(C, 4)
    n = rows * q4
    blocks = min(_cdiv(n, 256), 512)

    def out(y: int):
        def writes(x, yy, z):
            if yy != y:
                return []
            return [((e, min(e + 256, n)),)
                    for e in range(x * 256, n, blocks * 256)]
        return Output("outX" if y == 0 else "outY", (n,), writes)

    return Launch("pad_classes", f"rows={rows} C={C}",
                  "graph_reg_tiles.cuh", _sym("pad_classes"),
                  (blocks, 2 if two else 1, 1), 256, 0, 0, (256, 0),
                  outputs=tuple(out(y) for y in range(2 if two else 1)),
                  vectors=(Vector("padded rows", 16 * q4),))


def _tree_sum(k: int, n_strips: int) -> Launch:
    return Launch("reg_fwd_tree_sum", f"k={k} strips={n_strips}",
                  "graph_reg_tiles.cuh", _sym("reg_fwd_tree_sum"),
                  (k, 1, 1), 1024, 0, 4 * 1024, (1024, 0),
                  outputs=(Output("out", (k,),
                                  lambda x, y, z: [((x, x + 1),)]),))


def _w_rows(B: int) -> tuple[Vector, ...]:
    """16-byte copies of W's rows, which the entry points take only when
    B is a multiple of 4 (``vec_w``)."""
    return (Vector("W rows", 4 * B),) if B % 4 == 0 else ()


def _partials(k: int, B: int, pairs_of) -> Output:
    n_pairs = 8 * _cdiv(B, 32)

    def writes(x, y, z):
        lo, hi = pairs_of(x)
        lo, hi = max(lo, 0), min(hi, n_pairs)
        return [((z, z + 1), (lo, hi), (0, 32))] if lo < hi else []
    return Output("partials", (k, n_pairs, 32), writes)


def _fwd_classes(k: int, B: int, C: int, plan: dict) -> list:
    """K1 / K10 on the class-split plan: pass 1 writes one (B, B) partial
    a class chunk and worker, a min(B, 64)-square tile a block; pass 2 one
    value a worker (S_ii handed over in B floats of shared memory)."""
    chunk, n_chunks = plan["class_chunk"], plan["class_chunks"]
    nt, tile = _cdiv(B, graph_reg.CS_TILE), graph_reg.CS_TILE

    def writes(x, y, z):
        i0, j0 = (y // nt) * tile, (y % nt) * tile
        return [((z, z + 1), (x, x + 1), (i0, min(i0 + tile, B)),
                 (j0, min(j0 + tile, B)))]
    part = Launch(
        "reg_fwd_class_partials", f"k={k} B={B} C={C}", "graph_reg.cu",
        _sym("reg_fwd_class_partials"), (n_chunks, nt * nt, k), 256,
        plan["dynamic_smem_bytes"], 0, (256, 0),
        outputs=(Output("partials", (k, n_chunks, B, B), writes),),
        vectors=(Vector("P/logP rows", 4 * C),) if C % 4 == 0 else (),
        library=("graph_reg.launch_plan", ("graph_reg_fwd", k, B, C), {},
                 (("rows_per_block", plan["rows_per_block"]),
                  ("dynamic_smem_bytes", plan["dynamic_smem_bytes"]),
                  ("class_chunk", chunk), ("blocks", plan["blocks"]))))
    total = Launch("reg_fwd_class_sum", f"k={k} B={B} chunks={n_chunks}",
                   "graph_reg.cu", _sym("reg_fwd_class_sum"), (k, 1, 1),
                   256, 4 * B, 4 * 8, (256, 1),
                   outputs=(Output("out", (k,),
                                   lambda x, y, z: [((x, x + 1),)]),))
    return [part, total]


def _fwd(k: int, B: int, C: int, n_sm: int, full: bool = True) -> list:
    """K1 (``full``) or K10: ``graph_reg_fwd`` / ``graph_reg_pairwise``,
    on the row plan (class padding, the pipeline, the tree sum) or the
    class-split plan."""
    plan = graph_reg.fwd_plan(k, B, C, n_sm=n_sm)
    if plan["route"] == "classes":
        return _fwd_classes(k, B, C, plan)
    pairs = plan["rows_per_block"] // 4
    n_strips = _cdiv(B, 32)
    tag = "1" if full else "0"
    part = Launch(
        "reg_fwd_partials", f"kFull={tag} k={k} B={B} C={C}", "graph_reg.cu",
        _sym("reg_fwd_partials", f"Lb{tag}E"),
        (_cdiv(8 * n_strips, pairs), 1, k), 32 * pairs,
        plan["dynamic_smem_bytes"], 0, (256, 1),
        outputs=(_partials(k, B, lambda x: (x * pairs, (x + 1) * pairs)),),
        vectors=(Vector("padded logP rows", 16 * _cdiv(C, 4)),) + _w_rows(B),
        library=("graph_reg.launch_plan", ("graph_reg_fwd", k, B, C), {},
                 (("rows_per_block", plan["rows_per_block"]),
                  ("dynamic_smem_bytes", plan["dynamic_smem_bytes"]),
                  ("class_chunk", 0), ("blocks", plan["blocks"]))))
    return [_pad_classes(k * B, C, False), part, _tree_sum(k, n_strips)]


def _class_box(y: int, C: int, quads: int) -> tuple[int, int]:
    return (y * 128, min(y * 128 + 4 * quads, C))


def _dlogp_classes(k: int, B: int, C: int, plan: dict) -> list:
    """K2 on the class route: one launch, a block per class span and
    worker, all B rows; no class padding, no cluster."""
    span = plan["class_span"]

    def writes(x, y, z):
        return [((z, z + 1), (0, B), (x * span, min(x * span + span, C)))]

    return [Launch(
        "reg_bwd_dlogp_classes", f"k={k} B={B} C={C}", "graph_reg.cu",
        _sym("reg_bwd_dlogp_classes"), (plan["blocks"] // k, 1, k),
        plan["threads"], plan["dynamic_smem_bytes"], 0,
        (graph_reg.DC_MAX_THREADS, 1),
        outputs=(Output("dlogp", (k, B, C), writes),),
        vectors=(Vector("P/logP/dlogp rows", 4 * C),) if C % 4 == 0 else (),
        library=("graph_reg.launch_plan", ("graph_reg_bwd_dlogp", k, B, C),
                 {}, tuple((key, plan[key]) for key in (
                     "rows_per_block", "dynamic_smem_bytes", "class_span",
                     "blocks", "threads"))))]


def _dlogp(k: int, B: int, C: int, n_sm: int) -> list:
    """K2: ``graph_reg_bwd_dlogp``, on the row route two-block clusters
    (block 1 of each hands its Wᵀ·P tile to block 0, which writes the
    rows) after the class padding, or on the class route one kernel."""
    plan = graph_reg.dlogp_plan(k, B, C, n_sm=n_sm)
    if plan["route"] == "classes":
        return _dlogp_classes(k, B, C, plan)
    rows = plan["rows_per_block"]
    quads = min(_cdiv(C, 4), 32)

    def writes(x, y, z):
        if x % 2:
            return []
        i0 = (x // 2) * rows
        return [((z, z + 1), (i0, min(i0 + rows, B)),
                 _class_box(y, C, quads))]

    kern = Launch(
        "reg_bwd_dlogp", f"k={k} B={B} C={C}", "graph_reg.cu",
        _sym("reg_bwd_dlogp"), (2 * _cdiv(B, rows), _cdiv(C, 128), k),
        rows // 2 * quads, plan["dynamic_smem_bytes"], 0, (512, 0),
        cluster=(2, 1, 1), outputs=(Output("dlogp", (k, B, C), writes),),
        vectors=(Vector("padded P/logP rows", 16 * _cdiv(C, 4)),)
        + _w_rows(B),
        library=("graph_reg.launch_plan", ("graph_reg_bwd_dlogp", k, B, C),
                 {}, tuple((key, plan[key]) for key in (
                     "rows_per_block", "dynamic_smem_bytes", "class_span",
                     "blocks", "threads"))))
    return [_pad_classes(k * B, C, True), kern]


def _dw(name: str, k: int, B: int, C: int, tag: str) -> Launch:
    """K3 / K7: ``dw_tile`` over 64 × 128 pieces of the (B, B) output."""
    def writes(x, y, z):
        return [((z, z + 1), (y * 64, min(y * 64 + 64, B)),
                 (x * 128, min(x * 128 + 128, B)))]
    # dw_tile's staging: P, logP rows and logP columns for 40 classes, H.
    static = 4 * (40 * 64 + 40 * 64 + 40 * 128 + 64)
    return Launch(name, f"{tag}k={k} B={B} C={C}",
                  "graph_reg.cu" if name == "reg_bwd_dw"
                  else "graph_reg_bsp.cu", _sym(name),
                  (_cdiv(B, 128), _cdiv(B, 64), k), 256, 0, static, (256, 3),
                  outputs=(Output("dW", (k, B, B), writes),),
                  vectors=(Vector("dW rows", 4 * B),) if B % 4 == 0 else ())


def _bsp_fwd(k: int, B: int, C: int, T: int, bt: int, n_sm: int) -> list:
    """K4: ``graph_reg_bsp_fwd``, K1's pipeline over a tile row's list."""
    plan = graph_reg_bsp.fwd_plan(k, B, C, T, bt, n_sm=n_sm)
    pairs = plan["rows_per_block"] // 4
    nt, groups = _cdiv(B, bt), bt // 4 // pairs

    def pairs_of(x):
        line = x // groups
        first = line * (bt // 4) + (x - line * groups) * pairs
        return first, first + pairs

    part = Launch(
        "bsp_fwd_partials", f"k={k} B={B} C={C} bt={bt}",
        "graph_reg_bsp.cu", _sym("bsp_fwd_partials"),
        (nt * groups, 1, k), 32 * pairs, plan["dynamic_smem_bytes"], 16,
        (256, 1), outputs=(_partials(k, B, pairs_of),),
        vectors=(Vector("padded logP rows", 16 * _cdiv(C, 4)),) + _w_rows(B),
        library=("graph_reg_bsp.launch_plan",
                 ("graph_reg_bsp_fwd", k, B, C, T, bt), {},
                 (("rows_per_block", plan["rows_per_block"]),
                  ("dynamic_smem_bytes", plan["dynamic_smem_bytes"]))))
    return [_pad_classes(k * B, C, False), part,
            _tree_sum(k, _cdiv(B, 32))]


def _bsp_bterm(k: int, B: int, C: int, T: int, bt: int) -> list:
    """K5: ``graph_reg_bsp_bterm``, 8 output rows a block."""
    quads = min(_cdiv(C, 4), 32)
    nt = _cdiv(B, bt)
    smem = 4 * 8 * 32 * (8 + 4 * quads) + 4 * min(T, nt)

    def writes(x, y, z):
        return [((z, z + 1), (x * 8, min(x * 8 + 8, B)),
                 _class_box(y, C, quads))]
    vec = _w_rows(B) + ((Vector("P rows", 4 * C),) if C % 4 == 0 else ())
    return [Launch("bsp_bwd_bterm", f"k={k} B={B} C={C} bt={bt}",
                   "graph_reg_bsp.cu", _sym("bsp_bwd_bterm"),
                   (_cdiv(B, 8), _cdiv(C, 128), k), 8 * quads, smem, 16,
                   (256, 0), outputs=(Output("bterm", (k, B, C), writes),),
                   vectors=vec,
                   library=("graph_reg_bsp.bterm_smem_bytes", (B, C, T, bt),
                            {}, (("", smem),)))]


def _bsp_dlogp(k: int, B: int, C: int, T: int, bt: int, n_sm: int) -> list:
    """K6: ``graph_reg_bsp_dlogp``, the A half of K2's pipeline by tile
    row."""
    plan = graph_reg_bsp.dlogp_plan(k, B, C, T, bt, n_sm=n_sm)
    rows = plan["rows_per_block"]
    quads = min(_cdiv(C, 4), 32)
    nt, groups = _cdiv(B, bt), _cdiv(bt, rows)

    def writes(x, y, z):
        line = x // groups
        i0 = line * bt + (x - line * groups) * rows
        end = min(line * bt + bt, B)
        if i0 >= end:
            return []
        return [((z, z + 1), (i0, min(i0 + rows, end)),
                 _class_box(y, C, quads))]

    kern = Launch(
        "bsp_bwd_dlogp", f"k={k} B={B} C={C} bt={bt}", "graph_reg_bsp.cu",
        _sym("bsp_bwd_dlogp"), (nt * groups, _cdiv(C, 128), k),
        rows // 2 * quads, plan["dynamic_smem_bytes"], 16, (512, 0),
        outputs=(Output("dlogp", (k, B, C), writes),),
        vectors=(Vector("padded logP rows", 16 * _cdiv(C, 4)),) + _w_rows(B),
        library=("graph_reg_bsp.launch_plan",
                 ("graph_reg_bsp_dlogp", k, B, C, T, bt), {},
                 (("rows_per_block", rows),
                  ("dynamic_smem_bytes", plan["dynamic_smem_bytes"]))))
    return [_pad_classes(k * B, C, False), kern]


def _pack(rows: int, D: int, rows_pad: int) -> Launch:
    """``pack_t`` (``csrc/d2_tile.cuh``): a feature-major, zero-padded copy
    (Dp, rows_pad) through 32 × 32 shared-memory tiles."""
    Dp = _cdiv(max(D, 1), 32) * 32

    def writes(x, y, z):
        return [((y * 32, min(y * 32 + 32, Dp)), (x * 32, x * 32 + 32))]
    return Launch("pack_t", f"rows={rows} D={D}", "d2_tile.cuh",
                  _sym("pack_t"), (rows_pad // 32, _cdiv(Dp, 32), 1), 256, 0,
                  4 * 32 * 33, (256, 0),
                  outputs=(Output("XT", (Dp, rows_pad), writes),))


def _knn(N: int, M: int, D: int, k: int, same: bool, n_sm: int) -> list:
    """K8: ``knn_topk`` — the packing, the streaming top-k over column
    segments and, with more than one segment, the merge by rank."""
    plan = pairwise.knn_plan(N, M, D, k, same=same, n_sm=n_sm)
    S, strips = plan["segments"], _cdiv(N, 128)
    glob, small = k > pairwise.K_MAX, k <= 32
    targs = f"Lb{int(glob)}ELb{int(small)}E"

    def writes(x, y, z):
        strip, seg = divmod(x, S)
        rows = (strip * 128, min(strip * 128 + 128, N))
        return ([((seg, seg + 1), rows, (0, k))] if S > 1
                else [(rows, (0, k))])
    shape = (S, N, k) if S > 1 else (N, k)
    out = [_pack(N, D, strips * 128)]
    if not same:
        out.append(_pack(M, D, _cdiv(M, 128) * 128))
    out.append(Launch(
        "knn_topk_kernel", f"N={N} M={M} D={D} k={k}", "pairwise.cu",
        _sym("knn_topk_kernel", targs), (strips * S, 1, 1), 256,
        plan["dynamic_smem_bytes"], 0, (256, 1),
        outputs=(Output("lists", shape, writes),),
        vectors=(Vector("packed rows", 4 * strips * 128),),
        library=("pairwise.launch_plan", ("knn_topk", N, M, D, k),
                 {"same": same},
                 (("segments", S),
                  ("dynamic_smem_bytes", plan["dynamic_smem_bytes"]),
                  ("workspace_bytes", plan["workspace_bytes"])))))
    if S > 1:
        out.append(Launch(
            "knn_merge_segments", f"N={N} k={k} S={S}", "pairwise.cu",
            _sym("knn_merge_segments"), (_cdiv(N, 8), 1, 1), 256, 0, 0,
            (256, 0), outputs=(Output("out", (N, k), lambda x, y, z: [
                ((8 * x, min(8 * x + 8, N)), (0, k))]),)))
    return out


def _rbf(N: int, M: int, D: int, same: bool, n_sm: int,
         rows: int | None = None) -> list:
    """K9: ``rbf_affinity`` — the packing and the RBF tiles of ``rows``
    rows (the plan's when None)."""
    plan = pairwise.rbf_plan(N, M, D, same=same, n_sm=n_sm)
    bm = rows or plan["rows_per_block"]

    def writes(x, y, z):
        return [((y * bm, min(y * bm + bm, N)),
                 (x * 128, min(x * 128 + 128, M)))]
    out = [_pack(N, D, _cdiv(N, 128) * 128)]
    if not same:
        out.append(_pack(M, D, _cdiv(M, 128) * 128))
    lib = (("pairwise.launch_plan", ("rbf_affinity", N, M, D),
            {"same": same}, (("rows_per_block", bm),
                             ("workspace_bytes", plan["workspace_bytes"])))
           if rows is None else None)
    out.append(Launch(
        "rbf_affinity_kernel", f"rows={bm} N={N} M={M} D={D}", "pairwise.cu",
        _sym("rbf_affinity_kernel", f"Li{bm}E"),
        (_cdiv(M, 128), _cdiv(N, bm), 1), 256, 4 * 2 * 32 * (bm + 128), 0,
        (256, 2), outputs=(Output("out", (N, M), writes),),
        vectors=((Vector("out rows", 4 * M),) if M % 4 == 0 else ())
        + (Vector("packed rows", 4 * _cdiv(N, 128) * 128),),
        library=lib))
    return out


def _flash(B: int, Tq: int, Tk: int, H: int, KV: int, hd: int,
           dtype: str) -> list:
    """K11: the FMA kernel (64-row query blocks) or, for bf16 at hd 64,
    112 and 128, the tensor-core kernel (128-row query blocks fed by TMA,
    tiles of hd rounded up to whole 64-column boxes)."""
    wgmma = dtype == "bfloat16" and hd in (64, 112, 128)
    bq = 128 if wgmma else 64
    nq = _cdiv(Tq, bq)

    def writes(x, y, z):
        if wgmma:
            (b, h), qb = divmod(x, H), y
        else:
            (b, h), qb = divmod(y, H), x
        q0 = (nq - 1 - qb) * bq
        return [((b, b + 1), (q0, min(q0 + bq, Tq)), (h, h + 1), (0, hd))]
    out = Output("o", (B, Tq, H, hd), writes)
    tag = f"{dtype} hd={hd} B={B} T={Tq} H={H} KV={KV}"
    if wgmma:
        smem = 5 * _cdiv(hd, 64) * 128 * 128 + 64 + 1024
        return [Launch(
            "flash_fwd_wgmma_kernel", tag, "flash_attention_wgmma.cuh",
            _sym("flash_fwd_wgmma_kernel", f"Li{hd}E"), (B * H, nq, 1), 256,
            smem, 0, (256, 1), outputs=(out,),
            vectors=(Vector("q/k/v rows (TMA)", 2 * hd,
                            box_inner_bytes=2 * 64),),
            library=("flash_attention.launch_smem", (dtype, hd), {},
                     (("", smem),)))]
    es = 4 if dtype == "float32" else 2
    smem = (64 + 2 * 64) * (hd + 4 // es) * es + 64 * 65 * 4
    t = "f" if dtype == "float32" else "13__nv_bfloat16"
    return [Launch(
        "flash_fwd_kernel", tag, "flash_attention.cu",
        _sym("flash_fwd_kernel", f"{t}Li{hd}E"), (nq, B * H, 1), 256, smem,
        0, (256, 0), outputs=(out,),
        library=("flash_attention.launch_smem", (dtype, hd), {},
                 (("", smem),)))]


def _moe_dispatch(N: int, d: int, E: int, k: int, dtype: str) -> list:
    """K12: 128 assignments a block, each block writing its assignments'
    rows of ``pos`` and block 0 the counts and ends.  Each gathered row
    of ``xs`` goes to the row the counting sort gives its assignment, a
    permutation of the rows that no box per block describes: it is not
    modelled as an output."""
    A = N * k

    def own(x, y, z):
        return [((x * 128, min(x * 128 + 128, A)),)]

    def first(x, y, z):
        return [((0, E),)] if x == 0 else []
    es = 4 if dtype == "float32" else 2
    return [Launch(
        "moe_dispatch_kernel", f"{dtype} N={N} d={d} E={E} k={k}", "moe.cu",
        _sym("moe_dispatch_kernel"), (_cdiv(A, 128), 1, 1), 256, 3 * E * 4,
        2 * 128 * 4, (256, 0),
        outputs=(Output("pos", (A,), own), Output("counts", (E,), first),
                 Output("ends", (E,), first)),
        vectors=(Vector("x and xs rows", es * d),))]


def _moe_combine(N: int, d: int, k: int, dtype: str) -> list:
    """K13: one warp a token, 8 tokens a block."""
    def writes(x, y, z):
        return [((x * 8, min(x * 8 + 8, N)), (0, d))]
    es = 4 if dtype == "float32" else 2
    t = "f" if dtype == "float32" else "13__nv_bfloat16"
    return [Launch(
        "moe_combine_kernel", f"{dtype} N={N} d={d} k={k}", "moe.cu",
        _sym("moe_combine_kernel", t), (_cdiv(N, 8), 1, 1), 256, 0, 0,
        (256, 0), outputs=(Output("y", (N, d), writes),),
        vectors=(Vector("out and y rows", es * d),))]


def _rms_norm(rows: int, d: int, dtype: str) -> list:
    """K14: ``warps`` warps a row and 8 / warps rows a block
    (``norm.plan``), each block writing its rows whole; the warps of a row
    meet in 4 bytes of static shared memory a warp where they are more
    than one."""
    p = norm.plan(rows, d, dtype)
    per = p["rows_per_block"]

    def writes(x, y, z):
        return [((x * per, min(x * per + per, rows)), (0, d))]
    es = 4 if dtype == "float32" else 2
    t = "f" if dtype == "float32" else "13__nv_bfloat16"
    return [Launch(
        "rms_norm_kernel", f"{dtype} rows={rows} d={d}", "norm.cu",
        _sym("rms_norm_kernel", f"{t}Li{p['warps']}E"), (p["blocks"], 1, 1),
        p["threads"], 0, 0 if p["warps"] == 1 else 4 * 8, (256, 0),
        outputs=(Output("y", (rows, d), writes),),
        vectors=(Vector("x and y rows", es * d),),
        library=("norm.launch_plan", (rows, d, dtype), {},
                 (("warps", p["warps"]), ("blocks", p["blocks"]))))]


#: Wrapper calls -> their launch models.
_CALLS = {
    "graph_reg_fwd": lambda k, B, C, n_sm: _fwd(k, B, C, n_sm),
    "graph_reg_pairwise": lambda B, C, n_sm: _fwd(1, B, C, n_sm, full=False),
    "graph_reg_bwd_dlogp": _dlogp,
    "graph_reg_bwd_dw": lambda k, B, C, n_sm: [_dw("reg_bwd_dw", k, B, C,
                                                   "")],
    "graph_reg_bsp_fwd": _bsp_fwd,
    "graph_reg_bsp_bterm": lambda k, B, C, T, bt, n_sm: _bsp_bterm(
        k, B, C, T, bt),
    "graph_reg_bsp_dlogp": _bsp_dlogp,
    "graph_reg_bsp_dw": lambda k, B, C, T, bt, n_sm: [_dw(
        "bsp_bwd_dw", k, B, C, f"bt={bt} ")],
    "knn_topk": _knn,
    "rbf_affinity": _rbf,
    "flash_attention": lambda B, Tq, Tk, H, KV, hd, dtype, n_sm: _flash(
        B, Tq, Tk, H, KV, hd, dtype),
    "moe_dispatch": lambda N, d, E, k, dtype, n_sm: _moe_dispatch(
        N, d, E, k, dtype),
    "moe_combine": lambda N, d, k, dtype, n_sm: _moe_combine(N, d, k, dtype),
    "rms_norm": lambda rows, d, dtype, n_sm: _rms_norm(rows, d, dtype),
}

_P, _C, _BT = 2176, 39, 128
_T = _cdiv(_P, _BT) ** 2
#: The shapes the port's paths run: (wrapper, arguments).  The paper's DNN
#: at k ∈ {1, 4} workers, P 2176, C 39, layout_bt 128; the LM SSL heads
#: (k, B, V); K8 on the corpus (N 20,000, D 351) at k 10 / 40 / 300 /
#: 1,000 and on the online refresh's embeddings (D 2000); K9 at P × P, at
#: both tile heights; K11 in bf16 at the serve paths' head layouts and in
#: float32 at the small head dims; K12 and K13 at the mixtral prefill's
#: 8,192 tokens of 4,096 (8 experts, top 2) and a decode step's 4, and in
#: float32 at the reduced configs' width; K14 at the four prefill cells'
#: rows (qwen2 2k and 32k, phi4 2k, mixtral 2k, bf16), and at every
#: config's width in both dtypes on 7 rows (a block's rows cut short) and
#: the reduced configs' 128 in float32.
DEFAULT_SHAPES: tuple = (
    *((name, dict(k=k, B=_P, C=_C)) for k in (1, 4) for name in (
        "graph_reg_fwd", "graph_reg_bwd_dlogp", "graph_reg_bwd_dw")),
    ("graph_reg_pairwise", dict(B=_P, C=_C)),
    *((name, dict(k=k, B=_P, C=_C, T=_T, bt=_BT)) for k in (1, 4)
      for name in ("graph_reg_bsp_fwd", "graph_reg_bsp_bterm",
                   "graph_reg_bsp_dlogp", "graph_reg_bsp_dw")),
    *((name, dict(k=k, B=B, C=C))
      for k, B, C in ((1, 16, 151936), (1, 16, 32000), (1, 16, 50304),
                      (1, 4, 512))
      for name in ("graph_reg_fwd", "graph_reg_bwd_dlogp")),
    *(("knn_topk", dict(N=20000, M=20000, D=351, k=k, same=True))
      for k in (10, 40, 300, 1000)),
    ("knn_topk", dict(N=20000, M=20000, D=2000, k=10, same=True)),
    ("rbf_affinity", dict(N=_P, M=_P, D=351, same=True)),
    ("rbf_affinity", dict(N=_P, M=_P, D=351, same=True, rows=128)),
    ("rbf_affinity", dict(N=_P, M=_P, D=351, same=True, rows=64)),
    *(("flash_attention", dict(B=4, Tq=2048, Tk=2048, H=H, KV=KV, hd=hd,
                               dtype=dt))
      for dt, hd, H, KV in (("bfloat16", 64, 16, 16),
                            ("bfloat16", 112, 64, 8),
                            ("bfloat16", 128, 12, 2),
                            ("float32", 16, 4, 2),
                            ("float32", 32, 4, 2))),
    *(("moe_dispatch", dict(N=N, d=d, E=8, k=2, dtype=dt))
      for N, d, dt in ((8192, 4096, "bfloat16"), (4, 4096, "bfloat16"),
                       (64, 128, "float32"))),
    *(("moe_combine", dict(N=N, d=d, k=2, dtype=dt))
      for N, d, dt in ((8192, 4096, "bfloat16"), (4, 4096, "bfloat16"),
                       (64, 128, "float32"))),
    *(("rms_norm", dict(rows=rows, d=d, dtype="bfloat16"))
      for rows, d in ((8192, 1536), (8192, 3072), (32768, 1536),
                      (8192, 4096))),
    *(("rms_norm", dict(rows=7, d=d, dtype=dt))
      for d in (768, 1024, 1536, 2048, 3072, 4096, 7168, 8192)
      for dt in ("bfloat16", "float32")),
    ("rms_norm", dict(rows=64, d=128, dtype="float32")),
)


def call_launches(name: str, *, n_sm: int = N_SM, **shape) -> list[Launch]:
    """The launch models of one wrapper call at ``shape``."""
    if name not in _CALLS:
        raise KeyError(f"no launch model for {name!r}; known: "
                       f"{sorted(_CALLS)}")
    return _CALLS[name](**shape, n_sm=n_sm)


@functools.cache
def kernel_launches(n_sm: int = N_SM) -> tuple[tuple[str, Launch], ...]:
    """``(where, launch)`` for every model at :data:`DEFAULT_SHAPES`, with
    the same launch (e.g. one ``pad_classes``) kept once."""
    out: dict = {}
    for name, shape in DEFAULT_SHAPES:
        for ln in call_launches(name, n_sm=n_sm, **shape):
            key = (ln.kernel, ln.variant)
            if key not in out:
                out[key] = (f"{ln.kernel}/{ln.variant}", ln)
    return tuple(out.values())


# ---------------------------------------------------------- the checks
_COVERAGE: dict = {}


def coverage(launch: Launch) -> dict:
    """Per output: ``{"past": [...], "overlap": str | None, "uncovered":
    n}`` from one walk of the launch's blocks (cached per launch)."""
    key = id(launch)
    if key in _COVERAGE and _COVERAGE[key][0] is launch:
        return _COVERAGE[key][1]
    res = {}
    gx, gy, gz = launch.grid
    for out in launch.outputs:
        owner = np.full(out.shape, -1, np.int32) if out.accum_axes \
            else np.zeros(out.shape, np.uint8)
        past, overlap = [], None
        for z in range(gz):
            for y in range(gy):
                for x in range(gx):
                    coord = (x, y, z)
                    if any(coord[a] for a in out.accum_axes):
                        continue     # revisits its projection's boxes
                    proj = x + gx * (y + gy * z)
                    for box in out.writes(x, y, z):
                        if any(lo < 0 or hi > d for (lo, hi), d in
                               zip(box, out.shape)) and len(past) < 3:
                            past.append((coord, box))
                        sl = tuple(slice(max(lo, 0), min(hi, d))
                                   for (lo, hi), d in zip(box, out.shape))
                        region = owner[sl]
                        if out.accum_axes:
                            clash = ((region != -1) & (region != proj)).any()
                            region[...] = proj
                        else:
                            clash = region.any()
                            region[...] = 1
                        if clash and overlap is None:
                            overlap = f"block {coord} box {box}"
        uncovered = int(owner.size - np.count_nonzero(
            owner != -1 if out.accum_axes else owner))
        res[out.name] = {"past": past, "overlap": overlap,
                         "uncovered": uncovered}
    _COVERAGE[key] = (launch, res)
    return res


def check_launch(launch: Launch, *, where: str,
                 resident: int | None = None,
                 static_smem: int | None = None) -> list[Finding]:
    """V001 + V002 + V003 for one launch.  ``resident`` (the runtime's
    blocks an SM) and ``static_smem`` (the compiler's) are read on the
    card; without them the model's static shared memory is used and the
    launch bounds' minimum is held to shared memory and threads alone."""
    findings = []
    smem = launch.dynamic_smem + (launch.static_smem if static_smem is None
                                  else static_smem)
    max_threads, min_blocks = launch.launch_bounds
    name = f"{launch.kernel}/{launch.variant}"
    if smem > SMEM_BLOCK_BYTES:
        findings.append(Finding(
            "vmem", "V001", where,
            f"{name}: {smem} bytes of shared memory a block exceed the "
            f"{SMEM_BLOCK_BYTES} a block may have", detail="smem"))
    if launch.threads > max_threads:
        findings.append(Finding(
            "vmem", "V001", where,
            f"{name}: {launch.threads} threads exceed __launch_bounds__"
            f"({max_threads})", detail="threads"))
    if min_blocks:
        if min_blocks * (smem + SMEM_RESERVED_BYTES) > SMEM_SM_BYTES \
                or min_blocks * launch.threads > THREADS_SM:
            findings.append(Finding(
                "vmem", "V001", where,
                f"{name}: the {min_blocks} blocks an SM that "
                f"__launch_bounds__ promises do not fit ({smem} bytes of "
                f"shared memory, {launch.threads} threads a block)",
                detail="min_blocks"))
        elif resident is not None and resident < min_blocks:
            findings.append(Finding(
                "vmem", "V001", where,
                f"{name}: the runtime fits {resident} blocks an SM, fewer "
                f"than the {min_blocks} __launch_bounds__ promises",
                detail="resident"))
    for v in launch.vectors:
        if v.row_bytes % 16 or v.base_align % 16:
            findings.append(Finding(
                "vmem", "V002", where,
                f"{name}: 16-byte accesses of {v.name} on rows of "
                f"{v.row_bytes} bytes (base aligned to {v.base_align})",
                detail=v.name))
        if v.box_inner_bytes is not None and (
                v.box_inner_bytes % 16 or v.box_inner_bytes > SWIZZLE_BYTES
                or SWIZZLE_BYTES % v.box_inner_bytes):
            findings.append(Finding(
                "vmem", "V002", where,
                f"{name}: a TMA box of {v.box_inner_bytes} inner bytes is "
                f"not cut evenly by the {SWIZZLE_BYTES}-byte swizzle",
                detail=f"{v.name}:box"))
    if any(g % c for g, c in zip(launch.grid, launch.cluster)):
        findings.append(Finding(
            "vmem", "V003", where,
            f"{name}: grid {launch.grid} does not divide into clusters "
            f"{launch.cluster}", detail="cluster"))
    for oname, cov in coverage(launch).items():
        if cov["past"]:
            findings.append(Finding(
                "vmem", "V003", where,
                f"{name}: blocks address past output {oname!r} "
                f"{launch.outputs[0].shape}: {cov['past'][0]}",
                detail=f"{oname}:past"))
        if cov["uncovered"]:
            findings.append(Finding(
                "vmem", "V003", where,
                f"{name}: {cov['uncovered']} elements of output {oname!r} "
                "are written by no block", detail=f"{oname}:uncovered"))
    return findings


# ------------------------------------------------------- the source scan
_GLOBAL = re.compile(
    r"__global__\s+void\s+((?:__\w+__\s*\([^()]*\)\s*)*)(\w+)\s*\(")
_CONST = re.compile(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);")


def _constants(path: Path, seen=None) -> dict:
    """``constexpr int`` values of a source and the headers it includes
    (its own taking precedence)."""
    seen = set() if seen is None else seen
    if path in seen or not path.exists():
        return {}
    seen.add(path)
    text = path.read_text()
    consts: dict = {}
    for inc in re.findall(r'#include\s+"([\w.]+)"', text):
        consts.update(_constants(path.parent / inc, seen))
    for name, expr in _CONST.findall(text):
        try:
            consts[name] = int(eval(expr.replace("ll", ""),
                                    {"__builtins__": {}}, consts))
        except Exception:  # noqa: BLE001 — not an integer expression
            continue
    return consts


def source_kernels(csrc: Path = CSRC) -> dict[str, tuple]:
    """``name -> (file, (max threads, min blocks))`` of every ``__global__``
    function of ``csrc``, the launch bounds evaluated from the source."""
    out = {}
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        consts = _constants(path)
        for attrs, name in _GLOBAL.findall(text):
            lb = re.search(r"__launch_bounds__\s*\(([^(),]+)(?:,([^()]+))?\)",
                           attrs)
            bounds = (0, 0)
            if lb:
                ev = [int(eval(e, {"__builtins__": {}}, consts))
                      for e in lb.groups() if e]
                bounds = (ev[0], ev[1] if len(ev) > 1 else 0)
            out[name] = (path.name, bounds)
    return out


def validate_launches(launches=None, *, csrc: Path = CSRC
                      ) -> tuple[list[Finding], dict]:
    """The V-pass entry point: every model in budget, aligned and covering
    its outputs, and every ``__global__`` function of ``csrc`` modelled
    with its source's launch bounds."""
    launches = kernel_launches() if launches is None else launches
    findings: list[Finding] = []
    worst: dict[str, int] = {}
    for where, ln in launches:
        findings += check_launch(ln, where=where)
        worst[ln.kernel] = max(worst.get(ln.kernel, 0), ln.smem)
    kernels = source_kernels(csrc)
    modelled = {ln.kernel: ln for _, ln in launches}
    for name, (path, bounds) in sorted(kernels.items()):
        ln = modelled.get(name)
        if ln is None:
            findings.append(Finding(
                "vmem", "V005", f"{path}:{name}",
                f"__global__ {name} ({path}) has no launch model — add one "
                "to repro_torch.analysis.launch_audit", detail=name))
        elif ln.launch_bounds != bounds:
            findings.append(Finding(
                "vmem", "V005", f"{path}:{name}",
                f"{name}: the model's __launch_bounds__{ln.launch_bounds} "
                f"are not the source's {bounds}", detail=f"{name}:bounds"))
    metrics = {
        "launches_checked": len(launches),
        "kernels_in_source": len(kernels),
        "kernels_modelled": len(set(modelled) & set(kernels)),
        "budget_bytes": SMEM_BLOCK_BYTES,
        "worst_smem_bytes": worst,
    }
    return findings, metrics


# ------------------------------------------------------------- the card
def ptxas_entries(name: str) -> list[tuple[str, dict]]:
    """(mangled kernel name, registers / spill bytes / static shared
    memory) of every entry function in ``csrc/<name>.cu``'s compiler report
    (``-Xptxas -v``, from a verbose :func:`repro_torch.kernels.build.build`).
    """
    from repro_torch.kernels import build
    out = []
    for entry in re.split(r"ptxas info\s+: Compiling entry function ",
                          build.REPORTS[name])[1:]:
        kernel = entry.split("'")[1]
        spill = re.search(rf"Function properties for {re.escape(kernel)}\s+"
                          r"\d+ bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        if spill is None or regs is None:
            raise RuntimeError(f"no register or spill report for {kernel}: "
                               f"{entry[:400]}")
        out.append((kernel, {"registers": int(regs.group(1)),
                             "spill_bytes": int(spill.group(1))
                             + int(spill.group(2)),
                             "static_smem_bytes": int(smem.group(1))
                             if smem else 0}))
    return out


#: The redesigned kernels (K3 and K5; K1, K2 and K10, which shares K1's
#: template; K4 on K1's pipeline, K6 on K2's and K7 on K3's tile): wrapper
#: name -> (source, the kernel's name in its mangled symbol, up to the
#: character after it).
REDESIGNED = {"graph_reg_bwd_dw": ("graph_reg", "reg_bwd_dwE"),
              "graph_reg_bsp_bterm": ("graph_reg_bsp", "bsp_bwd_btermE"),
              "graph_reg_fwd": ("graph_reg", "reg_fwd_partialsILb1E"),
              "graph_reg_bwd_dlogp": ("graph_reg", "reg_bwd_dlogpE"),
              "graph_reg_pairwise": ("graph_reg", "reg_fwd_partialsILb0E"),
              "graph_reg_bsp_fwd": ("graph_reg_bsp", "bsp_fwd_partialsE"),
              "graph_reg_bsp_dlogp": ("graph_reg_bsp", "bsp_bwd_dlogpE"),
              "graph_reg_bsp_dw": ("graph_reg_bsp", "bsp_bwd_dwE")}


#: The library that answers for the kernels of each source file.
_LIBRARY = {"graph_reg.cu": "graph_reg", "graph_reg_tiles.cuh": "graph_reg",
            "graph_reg_bsp.cu": "graph_reg_bsp", "pairwise.cu": "pairwise",
            "d2_tile.cuh": "pairwise", "flash_attention.cu": "flash_attention",
            "flash_attention_wgmma.cuh": "flash_attention", "moe.cu": "moe",
            "norm.cu": "norm"}


def occupancy(launch: Launch) -> dict:
    """The runtime's reading of ``launch`` on the current card: resident
    blocks an SM at its threads and dynamic shared memory, and the
    kernel's registers and static shared memory (builds the library)."""
    module = importlib.import_module(
        f"repro_torch.kernels.{_LIBRARY[launch.source]}")
    return module.occupancy(launch.symbol, launch.threads,
                            launch.dynamic_smem)


def library_dynamic_smem(launch: Launch) -> int | None:
    """The launch's dynamic shared memory as the library's plan query
    reports it, or None where the library has no such query."""
    if launch.library is None:
        return None
    got = _library_value(launch.library)
    if isinstance(got, dict):
        return got.get("dynamic_smem_bytes")
    return got


def _library_value(spec: tuple):
    import importlib
    fn_path, args, kwargs, _ = spec
    mod, fn = fn_path.rsplit(".", 1)
    module = importlib.import_module(f"repro_torch.kernels.{mod}")
    if fn == "launch_smem":
        import torch
        args = (getattr(torch, args[0]),) + tuple(args[1:])
    return getattr(module, fn)(*args, **kwargs)


def check_against_library(launches=None, *, reports: dict | None = None
                          ) -> tuple[list[Finding], dict]:
    """The card's half of the V-pass: every model's plan against the
    library's (V005), every ``__global__`` function with a compiler report
    and no spill, the runtime's registers and static shared memory equal
    to the report's (V005: the occupancy table names the right kernel),
    and V001 with the compiler's static shared memory and the runtime's
    resident blocks.  ``reports``: source name -> :func:`ptxas_entries`."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    launches = kernel_launches(n_sm) if launches is None else launches
    if reports is None:
        reports = {name: ptxas_entries(name) for name in
                   ("graph_reg", "graph_reg_bsp", "pairwise",
                    "flash_attention", "moe", "norm")}
    entries = [(mangled, r) for rs in reports.values() for mangled, r in rs]
    findings: list[Finding] = []
    plans = static_diff = 0
    resident: dict[str, int] = {}
    for where, ln in launches:
        if ln.library is not None:
            got = _library_value(ln.library)
            plans += 1
            for key, want in ln.library[3]:
                have = got if key == "" else got[key]
                if have != want:
                    findings.append(Finding(
                        "vmem", "V005", where,
                        f"the model's {key or 'value'} {want} is not the "
                        f"library's {have} ({ln.library[0]})",
                        detail=f"plan:{key or 'value'}"))
        # The symbol from its length on: an anonymous namespace's hash
        # before it may end in digits.
        hits = [r for mangled, r in entries if ln.symbol in mangled]
        if not hits:
            findings.append(Finding(
                "vmem", "V005", where, f"no compiler report for {ln.symbol}",
                detail=f"report:{ln.kernel}"))
            continue
        r = hits[0]
        if r["static_smem_bytes"] != ln.static_smem:
            static_diff += 1
            findings.append(Finding(
                "vmem", "V005", where,
                f"the model's {ln.static_smem} bytes of static shared "
                f"memory are not the compiler's {r['static_smem_bytes']}",
                detail="static_smem"))
        occ = occupancy(ln)
        if (occ["registers"], occ["static_smem_bytes"]) != (
                r["registers"], r["static_smem_bytes"]):
            findings.append(Finding(
                "vmem", "V005", where,
                f"the runtime reads {occ['registers']} registers and "
                f"{occ['static_smem_bytes']} bytes of static shared memory "
                f"for {ln.symbol}, the compiler's report {r['registers']} "
                f"and {r['static_smem_bytes']}", detail="occupancy"))
        findings += check_launch(ln, where=where,
                                 resident=occ["resident_blocks"],
                                 static_smem=r["static_smem_bytes"])
        resident[where] = occ["resident_blocks"]
    for name, (path, _) in sorted(source_kernels().items()):
        if not any(re.search(rf"{len(name)}{name}[IE]", mangled)
                   for mangled, _ in entries):
            findings.append(Finding(
                "vmem", "V005", f"{path}:{name}",
                f"__global__ {name} has no compiler report",
                detail=f"report:{name}"))
    for mangled, r in entries:
        if r["spill_bytes"]:
            findings.append(Finding(
                "vmem", "V001", mangled,
                f"{mangled} spills {r['spill_bytes']} bytes",
                detail="spill"))
    return findings, {"plans_compared": plans, "n_sm": n_sm,
                      "static_smem_differs": static_diff,
                      "resident_blocks": resident,
                      "reports": len(entries)}
