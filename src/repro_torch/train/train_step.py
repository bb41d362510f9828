"""The paper's SSL DNN train step (Eq. 3 over the k stacked meta-batches).

The reference ``vmap``s one worker's loss over the leading axis of the
(k, P, ·) batch.  Here that axis is written out: the DNN runs on all k
concatenated batches at once (batched matmuls), and the objective and the
graph-regularizer kernels take the worker axis as a leading dimension (the
kernels' grid z).  The loss is the mean over workers, and so is each metric.
"""
from __future__ import annotations

import torch

from repro_torch.core.ssl_loss import SSLHyper, ssl_objective, tree_leaves
from repro_torch.models.dnn import DNNConfig, dnn_forward
from repro_torch.optim import Optimizer

#: SSLBatch block-layout fields, in ``BlockLayout.arrays()`` order — the
#: tuple the layout-aware pairwise kernels consume (present when the
#: pipeline was built with ``BatchConfig.layout_bt``).
_TILE_KEYS = ("tile_rows", "tile_cols", "tile_valid",
              "tile_crows", "tile_ccols", "tile_cvalid", "tile_occ")


def _unflatten(tree, leaves: list):
    """Rebuild ``tree``'s nest with ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    return rebuild(tree)


def dnn_ssl_loss(params, batch: dict, cfg: DNNConfig, hyper: SSLHyper, *,
                 generator: torch.Generator | None = None,
                 dropout: float = 0.0, pairwise=None,
                 workers: tuple[int, int] | None = None):
    """Mean Eq.-3 loss over the k stacked concatenated batches.

    Padding rows get zero label mask and zero affinity (``W`` masked by the
    outer product of ``valid``); the ``mean`` reduction still divides the
    graph term by the padded size P, as the reference does.  ``workers``
    (see :func:`~repro_torch.models.dnn.dnn_forward`) places the batch's
    workers in a larger batch for the dropout draw.  When the
    pipeline attached a block layout (all ``tile_*`` keys, worker axis
    leading) it goes to layout-aware pairwise entries, which skip W's
    unoccupied tiles.
    """
    layout = (tuple(batch[k] for k in _TILE_KEYS)
              if all(batch.get(k) is not None for k in _TILE_KEYS) else None)
    logits = dnn_forward(params, batch["x"], generator=generator,
                         dropout=dropout, workers=workers)
    valid = batch["valid"].to(torch.float32)
    mask = batch["label_mask"] * valid
    Wm = batch["W"] * valid[..., :, None] * valid[..., None, :]
    losses, metrics = ssl_objective(
        logits, batch["y"], mask, Wm, hyper, params=params,
        pairwise=pairwise, layout=layout, reduction="mean")
    return losses.mean(), {k: v.mean() for k, v in metrics.items()}


def dnn_ssl_grads(params, batch: dict, *, cfg: DNNConfig, hyper: SSLHyper,
                  generator: torch.Generator | None = None,
                  dropout: float = 0.0, pairwise=None,
                  workers: tuple[int, int] | None = None):
    """``(grads, metrics)`` of the Eq.-3 loss at ``params``; ``grads``
    mirrors the params' nest.  The metrics are 0-d device tensors."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = dnn_ssl_loss(
            _unflatten(params, leaves), batch, cfg, hyper,
            generator=generator, dropout=dropout, pairwise=pairwise,
            workers=workers)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss/total"] = loss.detach()
    return _unflatten(params, list(grads)), metrics


def dnn_ssl_step(params, opt_state, batch: dict, *, cfg: DNNConfig,
                 hyper: SSLHyper, opt: Optimizer, lr: float,
                 generator: torch.Generator | None = None,
                 dropout: float = 0.0, pairwise=None):
    """One synchronous step: grads, then the optimizer update (in place —
    the returned params and state are the objects passed in)."""
    grads, metrics = dnn_ssl_grads(params, batch, cfg=cfg, hyper=hyper,
                                   generator=generator, dropout=dropout,
                                   pairwise=pairwise)
    new_params, new_state = opt.update(grads, opt_state, params, lr)
    return new_params, new_state, metrics
