"""Optimizers. AdaGrad is the paper's choice (§3, [Duchi et al. 2011]).

Same functional surface as the reference: ``opt.init(params) -> state`` and
``opt.update(grads, state, params, lr) -> (new_params, new_state)``, with
states that mirror the params' nest in float32.  Unlike the reference, the
update runs **in place**: it overwrites the tensors of ``params`` and
``state`` and returns those same objects, so a step allocates no second
copy of the model.  Updates run under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.ssl_loss import tree_leaves


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (new_params, new_state)


def _zeros_like(params):
    if isinstance(params, dict):
        return {k: _zeros_like(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_zeros_like(v) for v in params)
    return torch.zeros_like(params, dtype=torch.float32)


def adagrad(eps: float = 1e-8) -> Optimizer:
    """AdaGrad: G += g²; p -= lr·g/(√G+eps)."""

    def init(params):
        return {"accum": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        for p, g, a in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["accum"])):
            g = g.float()
            a.add_(g * g)
            p.sub_(lr * g / (torch.sqrt(a) + eps))
        return params, state

    return Optimizer("adagrad", init, update)


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        return {} if momentum == 0.0 else {"mu": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        if momentum == 0.0:
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.sub_(lr * g.float())
            return params, state
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["mu"])):
            m.mul_(momentum).add_(g.float())
            p.sub_(lr * m)
        return params, state

    return Optimizer("sgd", init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params), "t": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        t = state["t"] + 1
        mh = 1.0 - b1 ** t
        vh = 1.0 - b2 ** t
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lr * (m / mh) / (torch.sqrt(v / vh) + eps))
        state["t"] = t
        return params, state

    return Optimizer("adam", init, update)
