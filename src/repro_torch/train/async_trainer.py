"""Asynchronous SGD (the paper's §4 future work), the reference's entry point.

``k`` workers each hold a possibly stale copy of the parameters (up to
``max_staleness`` server steps old) and push gradients of their own
meta-batch; the server applies each pushed gradient at once.  The schedule
is a deterministic round robin, so the update sequence is testable.

:func:`train_dnn_ssl_async` is a thin wrapper: the regime is the
``"async_ps"`` STRATEGY entry of the engine (:mod:`repro_torch.train.engine`).
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from repro_torch.core.ssl_loss import SSLHyper
from repro_torch.device import resolve_device
from repro_torch.models.dnn import DNNConfig, init_dnn
from repro_torch.optim import Optimizer, constant_lr
from repro_torch.train.trainer import train_dnn_ssl

__all__ = ["train_dnn_ssl_async"]


def train_dnn_ssl_async(
    pipeline_epoch: Callable[[], Iterable],
    *,
    cfg: DNNConfig,
    hyper: SSLHyper,
    n_epochs: int = 10,
    n_workers: int = 4,
    max_staleness: int = 2,
    base_lr: float = 1e-3,
    seed: int = 0,
    opt: Optimizer | None = None,
    eval_fn: Callable | None = None,
    pairwise: str | Callable | None = None,
    scan_chunk: int = 16,
    device: str | torch.device = "cuda",
):
    """Async SSL training. ``pipeline_epoch`` must yield (1, P, ·) batches
    (``n_workers=1`` pipelines); workers consume them round-robin.

    Returns ``(params, history)``, the reference's contract: a constant lr,
    no dropout, params initialized from ``seed``.  ``eval_fn(params) ->
    float`` fills each row's ``eval/acc``.  ``device`` defaults to
    ``"cuda"``; ``device="cpu"`` runs the plain PyTorch path."""
    device = resolve_device(device)
    res = train_dnn_ssl(
        pipeline_epoch,
        cfg=cfg,
        hyper=hyper,
        n_epochs=n_epochs,
        n_workers=n_workers,
        base_lr=base_lr,
        dropout=0.0,
        seed=seed,
        opt=opt,
        pairwise=pairwise,
        device=device,
        strategy="async_ps",
        max_staleness=max_staleness,
        scan_chunk=scan_chunk,
        lr_schedule=constant_lr(base_lr),
        params=init_dnn(cfg, seed, device=device),
        eval_fn=(None if eval_fn is None
                 else (lambda p: {"eval/acc": float(eval_fn(p))})),
    )
    return res.params, res.history
