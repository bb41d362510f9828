"""Train steps: the paper's SSL DNN step and the LM steps.

``dnn_ssl_step``   — the paper's objective (Eq. 3) on the 4×2000 DNN, over
                     a (k, P, ·) stack of concatenated meta-batches.  The
                     reference ``vmap``s one worker's loss over the leading
                     axis; here that axis is written out: the DNN runs on
                     all k concatenated batches at once (batched matmuls),
                     and the objective and the graph-regularizer kernels
                     take the worker axis as a leading dimension (the
                     kernels' grid z).  The loss is the mean over workers,
                     and so is each metric.
``lm_train_step``  — next-token loss of a decoder LM, with the paper's graph
                     regularizer attached at the sequence level: the pooled
                     output distributions of G concatenated meta-batches of
                     sequences and their dense affinity blocks W, the G axis
                     again the kernels' worker axis (K1 forward, K2
                     backward under ``pairwise="auto"``).
``lm_supervised_step`` — the same without the SSL terms.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.ssl_loss import SSLHyper, ssl_objective, tree_leaves
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
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


# ------------------------------------------------------------------- LM
def _chunk_nll(xc, head, tc, mc):
    """(Σ −log p(target)·mask, Σ mask) of one chunk, logits in float32."""
    logp = torch.log_softmax((xc @ head).float(), dim=-1)
    picked = torch.gather(logp, -1, tc.long()[..., None])[..., 0]
    return -torch.sum(picked * mc), torch.sum(mc)


def chunked_ce(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor, *, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over (B, T) without a live (B, T, V) logits tensor.

    T is cut into chunks of ``chunk`` positions; each chunk runs under
    non-reentrant ``torch.utils.checkpoint``, so its logits are rebuilt in
    the backward pass and peak memory is O(B·chunk·V), as the reference's
    ``jax.checkpoint`` inside ``lax.scan`` keeps it."""
    T = x.shape[1]
    c = min(chunk, T)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, T, c):
        nll, n = checkpoint(_chunk_nll, x[:, s:s + c], head,
                            targets[:, s:s + c], mask[:, s:s + c],
                            use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg: ModelConfig, batch: dict, hyper: SSLHyper | None,
            *, pairwise=None):
    """Next-token CE (+ the sequence-level SSL graph regularizer when
    ``hyper`` is given and the batch holds ``W``) -> (loss, metrics).

    The batch: ``tokens`` and ``targets`` (B, T), optional ``loss_mask``
    and ``modality_embeds`` (B, M, modality_dim, for XATTN layers);
    for the SSL term ``W`` (G, b, b) with B = G·b, ``seq_labels`` and
    ``seq_label_mask`` (G, b).  The G groups' pooled logits go, in float32
    as (G, b, V), through one ``ssl_objective`` call with G on the
    kernels' worker axis; the loss adds their mean, as the reference's
    ``vmap`` over groups does."""
    out = tf.forward(params, cfg, batch["tokens"],
                     modality_embeds=batch.get("modality_embeds"),
                     with_logits=False)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                          device=batch["targets"].device)
    ce = chunked_ce(out["hidden"], tf.output_head(params, cfg),
                    batch["targets"], mask)
    loss = ce + 0.01 * out["moe_aux"]
    metrics = {"loss/ce": ce, "loss/moe_aux": out["moe_aux"]}
    if hyper is not None and "W" in batch:
        G, b, _ = batch["W"].shape
        pooled = out["pooled_logits"].float().reshape(G, b, -1)
        ssl_losses, ssl_metrics = ssl_objective(
            pooled, batch["seq_labels"], batch["seq_label_mask"], batch["W"],
            hyper, params=None, pairwise=pairwise, reduction="mean")
        loss = loss + ssl_losses.mean()
        metrics.update({f"ssl/{k.split('/')[-1]}": v.mean()
                        for k, v in ssl_metrics.items()})
    metrics["loss/total"] = loss
    return loss, metrics


def lm_grads(params, batch: dict, *, cfg: ModelConfig,
             hyper: SSLHyper | None, pairwise=None):
    """``(grads, metrics)`` of :func:`lm_loss` at ``params``; ``grads``
    mirrors the params' nest, the metrics are 0-d device tensors."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = lm_loss(_unflatten(params, leaves), cfg, batch,
                                hyper, pairwise=pairwise)
        grads = torch.autograd.grad(loss, leaves)
    return (_unflatten(params, list(grads)),
            {k: v.detach() for k, v in metrics.items()})


def lm_train_step(params, opt_state, batch: dict, *, cfg: ModelConfig,
                  hyper: SSLHyper | None, opt: Optimizer, lr: float,
                  pairwise=None):
    """One step: grads of :func:`lm_loss`, then the optimizer update (in
    place — the returned params and state are the objects passed in)."""
    grads, metrics = lm_grads(params, batch, cfg=cfg, hyper=hyper,
                              pairwise=pairwise)
    new_params, new_state = opt.update(grads, opt_state, params, lr)
    return new_params, new_state, metrics


def lm_supervised_step(params, opt_state, batch: dict, *, cfg: ModelConfig,
                       opt: Optimizer, lr: float):
    """:func:`lm_train_step` without the SSL terms."""
    return lm_train_step(params, opt_state, batch, cfg=cfg, hyper=None,
                         opt=opt, lr=lr)
