"""Registry entries of the graph regularizer, with its analytic VJP.

The reference wraps its Pallas kernels in one ``jax.custom_vjp``; here that
is one ``torch.autograd.Function`` (:class:`GraphReg`): the forward runs K1,
the backward runs K2 for ``dlogp`` and K3 for ``dW`` only when ``W`` needs a
gradient.  In training ``W`` is batch data, so no P×P result is written that
nothing would read.  The scalar triple (gc, κ, ge) selects the bare cross
term (1, 0, 0) or the full regularizer (γ, κ, γ); all three are Python
floats, while the backward's cotangent stays a device tensor that the
kernels read by pointer (no host sync on the step path).

Two calling conventions, as in the reference:

  * cross term only: ``fn(logp, W)`` returns ``Σ_ij W_ij·Hc(p_i, p_j)``;
  * full regularizer (``fn.full_regularizer`` is set): ``fn(logp, W, γ, κ)``
    returns ``γ·Σ W_ij Hc(p_i,p_j) − Σ_i (κ + γ·Σ_j W_ij)·H(p_i)``.

``logp`` may be (B, C) or carry a leading worker axis (k, B, C), with ``W``
(B, B) or (k, B, B); the result is then a scalar or (k,).  The worker axis
is the kernels' grid z dimension.

With a ``BlockLayout`` (``layout=``), :class:`GraphRegBlockSparse` runs
the same regularizer over the occupied tiles only: K4 forward, K5 → K6
backward for ``dlogp``, and K7 only when ``W`` needs a gradient.

The graph-construction entries :func:`knn_topk` (K8) and
:func:`rbf_affinity` (K9), and :func:`graph_reg_pairwise` (K10 forward,
K2/K3 backward, the bare cross term through its own kernel), are the twins
of the reference's ``ops`` entries of those names; they take no
``use_pallas``: the tensors' device picks the kernel or the plain version.
The ``"pallas"`` registry entry keeps routing the cross term through K1
with (1, 0, 0), as the reference's does.

:func:`flash_attention_gqa` is the attention forward (K11) of the serve
path's prefill.  It is forward only and raises on inputs that require a
gradient: training attention runs ``chunked_attention``, which has a
backward.

``"auto"`` is the fused entry (the block-sparse one when a layout is
given) on every device: each wrapper in :mod:`.graph_reg` and
:mod:`.graph_reg_bsp` launches its Hopper kernel for CUDA tensors and runs
its plain version for CPU tensors, so the CPU and the GPU go through the
same Function and the same backward.
"""
from __future__ import annotations

import numpy as np
import torch

from . import flash_attention, graph_reg, graph_reg_bsp
from .pairwise import knn_topk, rbf_affinity
from .tuning import TileSpec, refuse_pinned

__all__ = ["GraphReg", "GraphRegBlockSparse", "GraphRegPairwise",
           "graph_reg_cross_vjp", "graph_reg_pairwise",
           "graph_regularizer_fused", "graph_regularizer_blocksparse",
           "graph_regularizer_auto", "knn_topk", "rbf_affinity",
           "flash_attention_gqa", "DEFAULT_BT"]

#: Tile edge of a layout given as bare arrays with no pinned ``tiles.bi``
#: (the reference's table default).
DEFAULT_BT = 128


class GraphReg(torch.autograd.Function):
    """K1 forward; K2 (and K3 when W needs a gradient) backward."""

    @staticmethod
    def forward(ctx, logp, W, gc: float, kappa: float, ge: float):
        p = torch.exp(logp)
        ctx.save_for_backward(logp, W, p)
        ctx.scalars = (gc, kappa, ge)
        return graph_reg.reg_forward(logp, W, gc, kappa, ge, p=p)

    @staticmethod
    def backward(ctx, g):
        logp, W, p = ctx.saved_tensors
        gc, kappa, ge = ctx.scalars
        g = g.contiguous()
        dlogp = dW = None
        if ctx.needs_input_grad[0]:
            dlogp = graph_reg.reg_bwd_dlogp(logp, W, g, gc, kappa, ge, p=p)
        if ctx.needs_input_grad[1]:
            dW = graph_reg.reg_bwd_dw(logp, g, gc, ge, p=p)
        return dlogp, dW, None, None, None


class GraphRegPairwise(torch.autograd.Function):
    """K10 forward; K2 (and K3 when W needs a gradient) backward, at
    (gc, κ, ge) = (1, 0, 0).  logp (B, C), W (B, B) -> scalar."""

    @staticmethod
    def forward(ctx, logp, W):
        p = torch.exp(logp)
        ctx.save_for_backward(logp, W, p)
        return graph_reg.reg_pairwise(logp, W, p=p)

    @staticmethod
    def backward(ctx, g):
        logp, W, p = (t[None] for t in ctx.saved_tensors)
        g = g.reshape(1).contiguous()
        dlogp = dW = None
        if ctx.needs_input_grad[0]:
            dlogp = graph_reg.reg_bwd_dlogp(logp, W, g, 1.0, 0.0, 0.0, p=p)[0]
        if ctx.needs_input_grad[1]:
            dW = graph_reg.reg_bwd_dw(logp, g, 1.0, 0.0, p=p)[0]
        return dlogp, dW


def graph_reg_pairwise(logp: torch.Tensor, W: torch.Tensor, *,
                       tiles: TileSpec | None = None) -> torch.Tensor:
    """Σ_ij W_ij·Hc(p_i,p_j) of one block, logp (B, C), W (B, B), through
    K10 and its analytic VJP."""
    if logp.device.type == "cuda":
        refuse_pinned(tiles, "graph_reg_pairwise")
    return GraphRegPairwise.apply(logp.contiguous(), W.contiguous())


graph_reg_pairwise.accepts_tiles = True


def _reg(logp, W, gc: float, kappa: float, ge: float,
         tiles: TileSpec | None) -> torch.Tensor:
    if logp.device.type == "cuda":
        refuse_pinned(tiles, "graph_regularizer")
    single = logp.dim() == 2
    if single:
        logp, W = logp[None], W[None]
    out = GraphReg.apply(logp.contiguous(), W.contiguous(), gc, kappa, ge)
    return out[0] if single else out


def graph_reg_cross_vjp(logp: torch.Tensor, W: torch.Tensor, *,
                        tiles: TileSpec | None = None) -> torch.Tensor:
    """Σ_ij W_ij·Hc(p_i,p_j) through K1 with (gc, κ, ge) = (1, 0, 0) and its
    analytic VJP — the PAIRWISE registry's ``"pallas"`` entry (the name is
    kept so configs carry over)."""
    return _reg(logp, W, 1.0, 0.0, 0.0, tiles)


graph_reg_cross_vjp.accepts_tiles = True


def graph_regularizer_fused(
        logp: torch.Tensor, W: torch.Tensor,
        gamma: float | None = None, kappa: float | None = None, *,
        tiles: TileSpec | None = None) -> torch.Tensor:
    """The fused regularizer — the registry's ``"fused"`` entry.  With
    (logp, W, γ, κ) it returns the whole Eq.-3/4 penalty from K1; with just
    (logp, W) the bare cross term.  γ and κ must be Python floats."""
    if gamma is None:
        return _reg(logp, W, 1.0, 0.0, 0.0, tiles)
    gamma, kappa = float(gamma), float(kappa or 0.0)
    return _reg(logp, W, gamma, kappa, gamma, tiles)


graph_regularizer_fused.full_regularizer = True
graph_regularizer_fused.accepts_tiles = True


class GraphRegBlockSparse(torch.autograd.Function):
    """K4 forward; K5 → K6 (and K7 when W needs a gradient) backward.

    Inputs: logp (k, B, C), W (k, B, B), the layout's seven int32 arrays
    with the worker axis leading, then (bt, gc, κ, ge) as Python numbers.
    """

    @staticmethod
    def forward(ctx, logp, W, rows, cols, valid, crows, ccols, cvalid, occ,
                bt: int, gc: float, kappa: float, ge: float):
        p = torch.exp(logp)
        ctx.save_for_backward(logp, W, p, rows, cols, valid, crows, ccols,
                              cvalid, occ)
        ctx.scalars = (bt, gc, kappa, ge)
        return graph_reg_bsp.bsp_forward(logp, W, rows, cols, valid, bt, gc,
                                         kappa, ge, p=p)

    @staticmethod
    def backward(ctx, g):
        (logp, W, p, rows, cols, valid, crows, ccols, cvalid,
         occ) = ctx.saved_tensors
        bt, gc, kappa, ge = ctx.scalars
        g = g.contiguous()
        dlogp = dW = None
        if ctx.needs_input_grad[0]:
            bterm = graph_reg_bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid,
                                                bt, p=p)
            dlogp = graph_reg_bsp.bsp_bwd_dlogp(logp, W, bterm, rows, cols,
                                                valid, g, bt, gc, kappa, ge,
                                                p=p)
        if ctx.needs_input_grad[1]:
            dW = graph_reg_bsp.bsp_bwd_dw(logp, occ, g, bt, gc, ge, p=p)
        return (dlogp, dW) + (None,) * 11


def _validate_layout(layout) -> None:
    """Check a layout's tile lists against the contract the kernels rely
    on (:mod:`repro_torch.analysis.race_audit`); raise on any violation.
    Both lists are checked (K5 walks the column-major one), per worker."""
    from repro_torch.analysis.race_audit import check_layout, check_tile_list

    where = "blocksparse.layout"
    if hasattr(layout, "arrays"):
        findings = check_layout(layout, where=where)
    else:
        arrays = [a.cpu().numpy() if isinstance(a, torch.Tensor)
                  else np.asarray(a) for a in layout]
        if arrays[0].ndim == 1:
            arrays = [a[None] for a in arrays]
        findings = []
        for z, (rows, cols, valid, crows, ccols, cvalid, occ) in enumerate(
                zip(*arrays)):
            for major, lists in (("row", (rows, cols, valid)),
                                 ("col", (crows, ccols, cvalid))):
                findings += check_tile_list(
                    *lists, occ.shape[0], major=major, occ=occ, where=where,
                    name=f"worker{z}.{major}_list")
    if findings:
        lines = "; ".join(f"[{f.rule}] {f.message}" for f in findings)
        raise ValueError(f"blocksparse layout failed W-pass audit: {lines}")


def _layout_tensors(layout, logp: torch.Tensor) -> list[torch.Tensor]:
    """The layout's seven arrays as int32 tensors on ``logp``'s device with
    the worker axis of ``logp`` (k, B, C) leading; an unstacked layout is
    shared by every worker."""
    arrays = layout.arrays() if hasattr(layout, "arrays") else tuple(layout)
    if len(arrays) != 7:
        raise ValueError(f"a block layout has 7 arrays (rows, cols, valid, "
                         f"crows, ccols, cvalid, occ), got {len(arrays)}")
    k = logp.shape[0]
    out = []
    for i, a in enumerate(arrays):
        t = torch.as_tensor(a, dtype=torch.int32, device=logp.device)
        if t.dim() == (2 if i == 6 else 1):
            t = t.expand((k,) + tuple(t.shape))
        out.append(t.contiguous())
    return out


def graph_regularizer_blocksparse(
        logp: torch.Tensor, W: torch.Tensor,
        gamma: float | None = None, kappa: float | None = None, *,
        layout=None, tiles: TileSpec | None = None,
        validate: bool = False) -> torch.Tensor:
    """The ``"blocksparse"`` entry: the fused regularizer over the tiles a
    ``BlockLayout`` lists (K4–K7).

    ``layout`` is a ``BlockLayout`` or its seven arrays ``(rows, cols,
    valid, crows, ccols, cvalid, occ)`` (``BlockLayout.arrays()``), numpy
    or tensors, with or without a leading worker axis.  Its tile edge is
    ``layout.bt``, else ``tiles.bi``, else :data:`DEFAULT_BT`; the grid it
    was built on must be ceil(B/bt) tiles a side.  Without a layout, and on
    a 1×1 tile grid (nothing to skip), the call is the dense fused path, as
    in the reference.  ``validate=True`` checks the tile lists first and
    raises on any violation (a duplicate tile would be added twice, an
    out-of-order list breaks the kernels' strip search).  On the card a
    pinned ``tiles`` is refused unless it pins only ``bi`` = the tile edge.
    """
    if layout is None:
        return graph_regularizer_fused(logp, W, gamma, kappa, tiles=tiles)
    if validate:
        _validate_layout(layout)
    bt = getattr(layout, "bt", None) or (
        tiles.bi if tiles is not None and tiles.bi else DEFAULT_BT)
    if logp.device.type == "cuda":
        refuse_pinned(tiles, "graph_regularizer_blocksparse", bi=bt)
    single = logp.dim() == 2
    if single:
        logp, W = logp[None], W[None]
    arrays = _layout_tensors(layout, logp)
    B, nt = logp.shape[-2], arrays[6].shape[-1]
    if -(-B // bt) != nt:
        raise ValueError(
            f"BlockLayout tile grid ({nt}×{nt}) does not match ceil(B/bt) = "
            f"ceil({B}/{bt}) = {-(-B // bt)}; the layout must be built with "
            f"the tile size the kernel runs with (pin tiles.bi to it)")
    if nt == 1:
        # A 1×1 tile grid has no tile to skip: the dense fused kernels do
        # the same work.  The pinned bt served the layout only.
        out = graph_regularizer_fused(logp, W, gamma, kappa)
    else:
        if gamma is None:
            gc, kap, ge = 1.0, 0.0, 0.0
        else:
            gc, kap = float(gamma), float(kappa or 0.0)
            ge = gc
        out = GraphRegBlockSparse.apply(logp.contiguous(), W.contiguous(),
                                        *arrays, bt, gc, kap, ge)
    return out[0] if single else out


graph_regularizer_blocksparse.full_regularizer = True
graph_regularizer_blocksparse.accepts_tiles = True
graph_regularizer_blocksparse.accepts_layout = True


def graph_regularizer_auto(
        logp: torch.Tensor, W: torch.Tensor,
        gamma: float | None = None, kappa: float | None = None, *,
        tiles: TileSpec | None = None, layout=None) -> torch.Tensor:
    """The ``"auto"`` entry: the block-sparse entry when a layout is given,
    else the fused one; the kernel wrappers pick the Hopper kernel or the
    plain version by the tensors' device.  Same dual signature as
    ``graph_regularizer_fused``."""
    if layout is not None:
        return graph_regularizer_blocksparse(logp, W, gamma, kappa,
                                             layout=layout, tiles=tiles)
    return graph_regularizer_fused(logp, W, gamma, kappa, tiles=tiles)


graph_regularizer_auto.full_regularizer = True
graph_regularizer_auto.accepts_tiles = True
graph_regularizer_auto.accepts_layout = True


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Attention forward through K11: q (B, Tq, H, hd), k, v (B, Tk, KV,
    hd) -> (B, Tq, H, hd), query row t at position Tk − Tq + t.  Forward
    only: it raises if any input requires a gradient."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention_gqa (K11) is forward only, as the reference's "
            "Pallas kernel is; attention that needs a gradient runs "
            "repro_torch.models.layers.attention.chunked_attention")
    return flash_attention.flash_attention_gqa(q, k, v, causal=causal)
