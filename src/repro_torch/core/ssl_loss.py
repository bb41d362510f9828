"""Graph-regularized semi-supervised objective (paper Eq. 2 / Eq. 3), in PyTorch.

Eq. 2 (full KL form):

    J(θ) = Σ_{i∈labeled} D(t_i ‖ p_i)
         + γ Σ_{i,j} ω_ij D(p_i ‖ p_j)
         + κ Σ_i D(p_i ‖ u)
         + λ ‖θ‖²

Eq. 3 (entropy/cross-entropy decomposition, constants w.r.t. θ dropped):

    J_i = Hc(t_i, p_i) + γ Σ_j ω_ij Hc(p_i, p_j)
        − (κ + γ Σ_j ω_ij) H(p_i) + λ‖θ‖²

All functions take *logits* and work in log-space.  Every batch argument may
carry leading worker axes — ``logits`` (..., B, C), ``labels`` and
``label_mask`` (..., B), ``W`` (..., B, B) — and the results then carry the
same leading axes; that is how the k workers of one step go through the
kernels in one launch.  The pairwise contraction is selected by name
through :data:`repro_torch.api.registry.PAIRWISE` (``"ref"``, ``"pallas"``,
``"fused"``, ``"blocksparse"``, ``"auto"``); ``pairwise=None`` keeps the
inline plain version, and an already-resolved callable passes through.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = [
    "SSLHyper",
    "entropy",
    "pairwise_cross_entropy_term",
    "graph_regularizer",
    "ssl_objective",
    "ssl_objective_kl_form",
    "l2_penalty",
    "tree_leaves",
]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SSLHyper:
    """Hyper-parameters of Eq. 2 (γ graph, κ entropy, λ ℓ2); all >= 0."""

    gamma: float = 1e-3
    kappa: float = 1e-4
    weight_decay: float = 1e-5

    def __post_init__(self):
        for name in ("gamma", "kappa", "weight_decay"):
            v = getattr(self, name)
            if not v >= 0:
                raise ValueError(
                    f"SSLHyper.{name} must be >= 0, got {v!r}")


def _resolve_pairwise(pairwise: str | Callable | None) -> Callable | None:
    if pairwise is None or callable(pairwise):
        return pairwise
    from repro_torch.api.registry import resolve_pairwise  # lazy: avoids cycle
    return resolve_pairwise(pairwise)


def tree_leaves(tree) -> list[Tensor]:
    """Leaves of a nest of dicts/lists/tuples, dict keys in sorted order —
    the order ``jax.tree_util.tree_leaves`` gives the same nest."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def entropy(logp: Tensor) -> Tensor:
    """Shannon entropy H(p_i) per row from log-probabilities."""
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def pairwise_cross_entropy_term(logp: Tensor, W: Tensor) -> Tensor:
    """Σ_ij W_ij · Hc(p_i, p_j) = −Σ W ⊙ (P · logPᵀ), the plain version."""
    S = torch.exp(logp) @ logp.mT
    return -torch.sum(W * S, dim=(-2, -1))


def graph_regularizer(logp: Tensor, W: Tensor, gamma: float, kappa: float, *,
                      pairwise: str | Callable | None = None,
                      layout=None) -> Tensor:
    """γ Σ_ij W_ij Hc(p_i,p_j) − Σ_i (κ + γ Σ_j W_ij) H(p_i)   (Eq. 4 + entropy).

    Implementations carrying the ``full_regularizer`` marker compute the
    whole penalty in one call; ``layout`` goes only to those advertising
    ``accepts_layout``.  Returns the summed penalty per leading index.
    """
    impl = _resolve_pairwise(pairwise)
    if impl is not None and getattr(impl, "full_regularizer", False):
        if layout is not None and getattr(impl, "accepts_layout", False):
            return impl(logp, W, gamma, kappa, layout=layout)
        return impl(logp, W, gamma, kappa)
    impl = impl or pairwise_cross_entropy_term
    cross = impl(logp, W)
    deg = torch.sum(W, dim=-1)
    h = entropy(logp)
    return gamma * cross - torch.sum((kappa + gamma * deg) * h, dim=-1)


def l2_penalty(params) -> Tensor:
    """Σ of every squared leaf, biases included, in the reference's leaf order."""
    leaves = tree_leaves(params)
    if not leaves:
        return torch.zeros(())
    return sum(torch.sum(torch.square(x)) for x in leaves)


def ssl_objective(logits: Tensor, labels: Tensor, label_mask: Tensor,
                  W: Tensor, hyper: SSLHyper, *, params=None,
                  pairwise: str | Callable | None = None, layout=None,
                  reduction: str = "mean") -> tuple[Tensor, dict]:
    """Decomposed Eq.-3 objective over one (concatenated meta-)batch.

    ``reduction='sum'`` is the paper's Eq. 2; ``'mean'`` divides the
    supervised term by the number of labeled points and the graph term by
    the (padded) batch size ``B`` — the trainer's scale-stable form.
    Returns (loss, metrics), both per leading index.
    """
    pairwise = _resolve_pairwise(pairwise)
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    sup = -torch.sum(picked * label_mask, dim=-1)
    n_labeled = torch.clamp(torch.sum(label_mask, dim=-1), min=1.0)
    greg = graph_regularizer(logp, W, hyper.gamma, hyper.kappa,
                             pairwise=pairwise, layout=layout)
    l2 = (hyper.weight_decay * l2_penalty(params) if params is not None
          else torch.zeros((), device=logits.device))
    if reduction == "mean":
        loss = sup / n_labeled + greg / logits.shape[-2] + l2
    elif reduction == "sum":
        loss = sup + greg + l2
    else:
        raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")
    hit = (torch.argmax(logits, dim=-1) == labels).to(label_mask.dtype)
    metrics = {
        "loss/supervised": sup / n_labeled,
        "loss/graph": greg,
        "loss/l2": l2,
        "acc/labeled": torch.sum(hit * label_mask, dim=-1) / n_labeled,
    }
    return loss, metrics


def ssl_objective_kl_form(logits: Tensor, labels: Tensor, label_mask: Tensor,
                          W: Tensor, hyper: SSLHyper, *,
                          params=None) -> Tensor:
    """Literal Eq.-2 KL form (sum reduction), for testing Eq. 3 against it."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    c = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long(), c).to(logp.dtype)
    sup = -torch.sum(torch.sum(onehot * logp, dim=-1) * label_mask, dim=-1)
    kl_ij = torch.sum(p * logp, dim=-1)[..., :, None] - p @ logp.mT
    graph = torch.sum(W * kl_ij, dim=(-2, -1))
    log_c = torch.log(torch.tensor(float(c), dtype=logp.dtype))
    ent = torch.sum(log_c - entropy(logp), dim=-1)
    l2 = (l2_penalty(params) if params is not None
          else torch.zeros((), device=logits.device))
    return (sup + hyper.gamma * graph + hyper.kappa * ent
            + hyper.weight_decay * l2)
