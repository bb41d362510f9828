"""Plain PyTorch versions of the graph-regularizer kernels.

Each function is the semantic ground truth of its Hopper kernel in
:mod:`repro_torch.kernels.graph_reg`: the CPU path runs them, and
``chip_smoke.py`` holds each kernel against them on the card.  All take an
optional leading worker axis: ``logp`` (..., B, C), ``W`` (..., B, B).

The forward pair mirrors the reference oracles; the two backward closed
forms are the analytic VJP the reference's backward kernels tile:

    dlogp = g·[−gc·(P⊙(W·logP) + Wᵀ·P) + (κ + ge·deg)⊙P⊙(logP + 1)]
    dW    = −g·(gc·P·logPᵀ + ge·H(p)·1ᵀ)
"""
from __future__ import annotations

import torch

__all__ = ["graph_reg_pairwise_ref", "graph_regularizer_ref",
           "reg_forward_ref", "reg_bwd_dlogp_ref", "reg_bwd_dw_ref"]


def graph_reg_pairwise_ref(logp: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Σ_ij W_ij Hc(p_i, p_j) = −Σ W ⊙ (P·logPᵀ);  logp: (B, C), W: (B, B)."""
    p = torch.exp(logp)
    return -torch.sum(W * (p @ logp.mT), dim=(-2, -1))


def graph_regularizer_ref(logp: torch.Tensor, W: torch.Tensor,
                          gamma: float, kappa: float) -> torch.Tensor:
    """Full Eq.-3/4 regularizer:  γ Σ_ij W_ij Hc(p_i,p_j) − Σ_i (κ + γ Σ_j W_ij) H(p_i)."""
    return reg_forward_ref(logp, W, gamma, kappa, gamma)


def reg_forward_ref(logp: torch.Tensor, W: torch.Tensor, gc: float,
                    kappa: float, ge: float) -> torch.Tensor:
    """The fused forward with the kernel's scalar triple (gc, κ, ge)."""
    p = torch.exp(logp)
    cross = -torch.sum(W * (p @ logp.mT), dim=(-2, -1))
    deg = torch.sum(W, dim=-1)
    h = -torch.sum(p * logp, dim=-1)
    return gc * cross - torch.sum((kappa + ge * deg) * h, dim=-1)


def _g(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Cotangent broadcast over the trailing (rows, cols) axes."""
    return torch.as_tensor(g, dtype=like.dtype, device=like.device)[..., None, None]


def reg_bwd_dlogp_ref(logp: torch.Tensor, W: torch.Tensor, g, gc: float,
                      kappa: float, ge: float) -> torch.Tensor:
    """dL/dlogp of the fused forward, closed form."""
    p = torch.exp(logp)
    deg = torch.sum(W, dim=-1, keepdim=True)
    cross = p * (W @ logp) + W.mT @ p
    return _g(g, logp) * (-gc * cross + (kappa + ge * deg) * p * (logp + 1.0))


def reg_bwd_dw_ref(logp: torch.Tensor, g, gc: float, ge: float) -> torch.Tensor:
    """dL/dW of the fused forward, closed form (W itself is not read)."""
    p = torch.exp(logp)
    h = -torch.sum(p * logp, dim=-1, keepdim=True)
    return -_g(g, logp) * (gc * (p @ logp.mT) + ge * h)
