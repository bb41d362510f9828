"""Sequential SSL training for the paper's experiments (PyTorch port).

Reproduces the paper's §3 protocol: AdaGrad, base lr 1e-3, effective lr
``1e-3·k`` reset after 10 epochs, dropout 0.2.  :func:`train_dnn_ssl` keeps
the reference's signature; it builds the :class:`TrainState` and the Eq.-3
step and hands the loop to :class:`repro_torch.train.engine.Engine`.

Features that later slices of the port bring raise ``NotImplementedError``
naming the slice instead of being ignored: the ``sync_mesh`` and
``async_ps`` strategies, checkpointing and resume, the non-finite guard and
fault injection, and the capture hooks of the online graph refresh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.convert import to_torch
from repro_torch.core.ssl_loss import SSLHyper
from repro_torch.device import resolve_device
from repro_torch.models.dnn import DNNConfig, dnn_forward, init_dnn
from repro_torch.optim import Optimizer, adagrad, parallel_lr_schedule
from repro_torch.train.engine import Engine, TrainState
from repro_torch.train.train_step import dnn_ssl_step

__all__ = ["TrainResult", "train_dnn_ssl", "evaluate_dnn"]


@dataclasses.dataclass
class TrainResult:
    params: dict
    history: list[dict]          # per-epoch metrics
    state: Any = None            # final TrainState


@torch.no_grad()
def evaluate_dnn(params, X: np.ndarray, y: np.ndarray,
                 batch: int = 4096) -> float:
    """Accuracy of ``params`` on (X, y), in chunks of ``batch`` rows, on the
    device the params live on; one host fetch at the end."""
    device = params["layers"][0]["w"].device
    correct = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(0, len(X), batch):
        xb = torch.from_numpy(np.ascontiguousarray(X[s:s + batch])).to(device)
        yb = torch.from_numpy(np.ascontiguousarray(y[s:s + batch])).to(device)
        pred = torch.argmax(dnn_forward(params, xb), dim=-1)
        correct += (pred == yb).sum()
    return int(correct.item()) / len(X)


def _later_slice(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet ({slice_name} slice)")


def train_dnn_ssl(
    pipeline_epoch: Callable[[], Iterable],
    *,
    cfg: DNNConfig,
    hyper: SSLHyper,
    n_epochs: int = 10,
    n_workers: int = 1,
    base_lr: float = 1e-3,
    lr_reset_epochs: int = 10,
    dropout: float = 0.2,
    eval_data: tuple[np.ndarray, np.ndarray] | None = None,
    eval_fn: Callable[[Any], dict] | None = None,
    seed: int = 0,
    opt: Optimizer | None = None,
    pairwise: str | Callable | None = "auto",
    device: str | torch.device = "cuda",
    mesh=None,
    strategy: str | None = None,
    scan_chunk: int = 16,
    prefetch: int = 2,
    max_staleness: int = 2,
    checkpoint_every: int = 0,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    lr_schedule: Callable[[int], float] | None = None,
    params: dict | None = None,
    resilience=None,
    injector=None,
    capture_fn: Callable | None = None,
    capture_epochs=None,
    on_epoch_end: Callable[[int, Any, Any], None] | None = None,
) -> TrainResult:
    """Run the paper's training loop over ``pipeline_epoch`` batches.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` for the plain PyTorch path.  ``pairwise`` names a
    PAIRWISE entry — the default ``"auto"`` runs the Hopper kernels on the
    GPU and the plain version on the CPU — or is a resolved callable.
    ``params`` (tensors or numpy arrays in the reference layout, e.g. the
    reference's init) replaces the seeded init; it is copied, never updated
    in place.  ``scan_chunk`` and ``max_staleness`` are accepted so configs
    carry over: there is no scan to chunk in eager PyTorch, and the
    staleness bound belongs to ``async_ps``.  ``prefetch > 0`` stages each
    batch that many steps ahead.  Dropout draws from a ``torch.Generator``
    seeded from ``seed``; its stream cannot match the reference's threefry
    keys.
    """
    device = resolve_device(device)
    strategy = strategy or ("sync_mesh" if mesh is not None else "sequential")
    if strategy in ("sync_mesh", "async_ps"):
        raise _later_slice(f"strategy {strategy!r}", "execution strategies")
    if strategy != "sequential":
        raise KeyError(f"unknown strategy {strategy!r}; the port has "
                       "'sequential' (later slices: 'sync_mesh', 'async_ps')")
    if checkpoint_every > 0 or resume:
        raise _later_slice("checkpointing and resume", "engine extras")
    if injector is not None or (resilience is not None and (
            resilience.nonfinite_guard or resilience.drop_overstale)):
        raise _later_slice("the non-finite guard and fault injection",
                           "engine extras")
    if capture_fn is not None or capture_epochs is not None:
        raise _later_slice("capture hooks (online graph refresh)",
                           "engine extras")

    opt = opt or adagrad()
    if params is None:
        params = init_dnn(cfg, seed, device=device)
    else:
        params = to_torch(params, device)
    generator = torch.Generator(device).manual_seed(seed + 1)
    state = TrainState(params=params, opt_state=opt.init(params),
                       generator=generator)

    # Resolve the pairwise kernel once; everything below passes the callable.
    from repro_torch.api.registry import resolve_pairwise
    pairwise = resolve_pairwise(pairwise)

    def step_fn(s: TrainState, batch: dict, lr: float) -> dict:
        s.params, s.opt_state, metrics = dnn_ssl_step(
            s.params, s.opt_state, batch, cfg=cfg, hyper=hyper, opt=opt,
            lr=lr, generator=s.generator, dropout=dropout, pairwise=pairwise)
        s.step += 1
        return metrics

    engine = Engine(step_fn, device=device, prefetch=prefetch)
    schedule = lr_schedule or parallel_lr_schedule(base_lr, n_workers,
                                                   lr_reset_epochs)
    if eval_fn is None and eval_data is not None:
        def eval_fn(p):
            return {"eval/acc": evaluate_dnn(p, *eval_data)}
    res = engine.run(pipeline_epoch, state=state, n_epochs=n_epochs,
                     lr_schedule=schedule, eval_fn=eval_fn,
                     on_epoch_end=on_epoch_end)
    return TrainResult(params=res.state.params, history=res.history,
                       state=res.state)

