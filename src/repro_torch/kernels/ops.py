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

``"auto"`` is the fused entry (the block-sparse one when a layout is
given) on every device: each wrapper in :mod:`.graph_reg` launches its
Hopper kernel for CUDA tensors and runs its plain version for CPU tensors,
so the CPU and the GPU go through the same Function and the same backward.
"""
from __future__ import annotations

import torch

from . import graph_reg
from .tuning import TileSpec, refuse_pinned

__all__ = ["GraphReg", "graph_reg_cross_vjp", "graph_regularizer_fused",
           "graph_regularizer_blocksparse", "graph_regularizer_auto"]


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


def graph_regularizer_blocksparse(
        logp: torch.Tensor, W: torch.Tensor,
        gamma: float | None = None, kappa: float | None = None, *,
        layout=None, tiles: TileSpec | None = None,
        validate: bool = False) -> torch.Tensor:
    """The ``"blocksparse"`` entry.  Without a layout it is the dense fused
    path, as in the reference; the tile-skipping kernels that a layout
    drives (K4–K7) belong to a later slice of the port."""
    if layout is not None:
        raise NotImplementedError(
            "pairwise='blocksparse' with a BlockLayout needs the block-sparse "
            "GPU kernels (K4-K7), which are not ported yet (block-sparse "
            "batches slice)")
    return graph_regularizer_fused(logp, W, gamma, kappa, tiles=tiles)


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
