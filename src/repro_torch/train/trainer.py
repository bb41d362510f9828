"""Sequential, data-parallel and asynchronous SSL training for the paper's
experiments (PyTorch port).

Reproduces the paper's §3 protocol: AdaGrad, base lr 1e-3, effective lr
``1e-3·k`` reset after 10 epochs, dropout 0.2.  :func:`train_dnn_ssl` keeps
the reference's signature; it builds the :class:`TrainState`, the Eq.-3
step and gradient functions, picks an execution strategy (``sequential``,
``sync_mesh`` or ``async_ps``, STRATEGY registry names) and hands the loop
to :class:`repro_torch.train.engine.Engine`.

Checkpointing and resume, the non-finite guard, fault injection and the
capture hooks of the online graph refresh run under every strategy, as in
the reference (see :mod:`repro_torch.train.engine`).
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
from repro_torch.optim import (Optimizer, adagrad, constant_lr,
                               parallel_lr_schedule)
from repro_torch.train.engine import Engine, TrainState, data_group
from repro_torch.train.train_step import dnn_ssl_grads, dnn_ssl_step

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
    in place.

    ``strategy`` names a STRATEGY registry entry; when omitted it is
    ``"sync_mesh"`` if ``mesh`` (a ``torch.distributed`` process group) is
    given, else ``"sequential"``.  ``"sync_mesh"`` without ``mesh`` reduces
    over :func:`~repro_torch.train.engine.data_group`: the default process
    group (``torchrun``) or a world-size-1 group of this process.  The
    synchronous strategies keep the lr·k rule (``parallel_lr_schedule``);
    ``"async_ps"`` runs the §4 stale-gradient regime (``max_staleness``
    server steps of lag) at the constant base lr and refuses dropout.
    ``scan_chunk`` groups steps into the chunks the fault sites and the
    guard windows count (there is no scan in eager PyTorch).  ``prefetch >
    0`` stages each batch that many steps ahead.  Dropout draws from a
    ``torch.Generator`` seeded from ``seed``; its stream cannot match the
    reference's threefry keys.  A checkpoint holds the generator's state,
    so ``resume=True`` draws the dropout masks an uninterrupted run would.

    ``resilience`` (a ``ResilienceConfig``) turns on the engine's failure
    defenses — the non-finite guard, checkpoint integrity and retention,
    the staging supervisor; ``injector`` (a
    :class:`~repro_torch.resilience.faults.FaultInjector`) arms fault
    injection.  ``capture_fn(params, batch)`` taps per-step embeddings on
    the epochs ``capture_epochs`` selects, and ``on_epoch_end(epoch,
    params, captures)`` receives them stacked on the host: the online
    graph refresh's hook (:mod:`repro_torch.online`).
    """
    device = resolve_device(device)
    strategy = strategy or ("sync_mesh" if mesh is not None else "sequential")
    if strategy == "sync_mesh" and mesh is None:
        mesh = data_group(n_workers, device)
    if strategy == "async_ps" and dropout > 0.0:
        # The async server pushes no dropout stream to its workers: refuse
        # rather than train another model than the caller configured.
        raise ValueError(
            "strategy 'async_ps' does not support dropout (the stale-"
            f"gradient workers draw no masks); got dropout={dropout}. "
            "Set dropout=0.0 explicitly.")

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

    def grad_fn(p: dict, batch: dict, generator=None, workers=None):
        # sync_mesh: its workers' share with the dropout stream; async_ps:
        # at a stale snapshot, without generator, so without dropout.
        return dnn_ssl_grads(p, batch, cfg=cfg, hyper=hyper,
                             generator=generator,
                             dropout=dropout if generator is not None
                             else 0.0,
                             pairwise=pairwise, workers=workers)

    engine = Engine(step_fn, device=device, grad_fn=grad_fn, opt=opt,
                    strategy=strategy, mesh=mesh, n_workers=n_workers,
                    max_staleness=max_staleness, scan_chunk=scan_chunk,
                    prefetch=prefetch, checkpoint_every=checkpoint_every,
                    checkpoint_dir=checkpoint_dir, resilience=resilience,
                    injector=injector, capture_fn=capture_fn)
    # The lr·k rule makes up for averaging k gradients; the async server
    # applies each pushed gradient alone, so it keeps the base lr.
    schedule = lr_schedule or (
        constant_lr(base_lr) if strategy == "async_ps"
        else parallel_lr_schedule(base_lr, n_workers, lr_reset_epochs))
    if eval_fn is None and eval_data is not None:
        def eval_fn(p):
            return {"eval/acc": evaluate_dnn(p, *eval_data)}
    res = engine.run(pipeline_epoch, state=state, n_epochs=n_epochs,
                     lr_schedule=schedule, eval_fn=eval_fn, resume=resume,
                     capture_epochs=capture_epochs,
                     on_epoch_end=on_epoch_end)
    return TrainResult(params=res.state.params, history=res.history,
                       state=res.state)

