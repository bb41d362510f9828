"""Eager training engine: the reference engine's sequential strategy.

The reference compiles each epoch into donated ``lax.scan`` chunks.  PyTorch
runs eagerly, so here an epoch is a Python loop over steps.  What the
reference gets from its prefetch thread and its once-per-epoch metric fetch
is kept:

* host batches are staged ``prefetch`` steps ahead: copied into pinned
  memory and sent to the GPU with ``non_blocking=True`` on a side stream.
  An event recorded after each batch's copies is what the compute stream
  waits on before the step that reads that batch, so a step never waits
  for the copies of the batches staged after it;
* per-step metrics stay on the device and are fetched once per epoch.

History rows have the reference's keys: the epoch means of the step
metrics, ``epoch``, ``lr``, ``seconds`` (epoch wall time, ending with the
metric fetch) and whatever ``eval_fn`` returns (``eval/acc``).

Other strategies (``sync_mesh``, ``async_ps``), checkpointing, the
non-finite guard, fault injection and capture hooks belong to later slices
of the port; :func:`repro_torch.train.trainer.train_dnn_ssl` refuses them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.introspect import accepts_kwarg

__all__ = ["TrainState", "EngineResult", "Engine", "stage_batch"]


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: Any
    generator: torch.Generator | None = None   # dropout stream
    step: int = 0


@dataclasses.dataclass
class EngineResult:
    state: TrainState
    history: list[dict]      # per-epoch metric rows

    @property
    def params(self):
        return self.state.params


def _as_host_dict(batch) -> dict:
    d = (dataclasses.asdict(batch)
         if dataclasses.is_dataclass(batch) and not isinstance(batch, dict)
         else dict(batch))
    return {k: v for k, v in d.items() if v is not None}


def stage_batch(batch, device: torch.device,
                stream: torch.cuda.Stream | None = None) -> dict:
    """Host batch (``SSLBatch`` or dict of arrays) -> dict of tensors on
    ``device``.  For a GPU the arrays go through pinned memory and a
    non-blocking copy, issued on ``stream`` when one is given."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _as_host_dict(batch).items()}
    if device.type != "cuda":
        return host
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        return {k: t.pin_memory().to(device, non_blocking=True)
                for k, t in host.items()}


class Engine:
    """Runs ``step_fn(state, batch, lr) -> metrics`` over epochs of batches.

    ``step_fn`` updates ``state`` in place (params, optimizer state, step
    counter) and returns a dict of 0-d device tensors.  ``prefetch = d > 0``
    keeps the next ``d`` batches staged while the current one trains; 0
    stages each batch right before its step.
    """

    def __init__(self, step_fn: Callable, *, device: torch.device,
                 prefetch: int = 1):
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.step_fn = step_fn
        self.device = device
        self.prefetch = prefetch
        self._copy_stream = (torch.cuda.Stream(device)
                             if device.type == "cuda" and prefetch else None)

    def _stage(self, batch) -> tuple[dict, torch.cuda.Event | None]:
        """Stage ``batch``; on the side stream, also return the event that
        marks the end of its copies."""
        staged = stage_batch(batch, self.device, self._copy_stream)
        if self._copy_stream is None:
            return staged, None
        done = torch.cuda.Event()
        done.record(self._copy_stream)
        return staged, done

    def _staged(self, batches: Iterable) -> Iterator[dict]:
        """Device batches, each staged ``prefetch`` steps ahead of its use
        and ordered on the compute stream after its own copies only."""
        queue: collections.deque = collections.deque()
        for b in batches:
            queue.append(self._stage(b))
            if len(queue) > self.prefetch:
                yield self._ready(*queue.popleft())
        while queue:
            yield self._ready(*queue.popleft())

    def _ready(self, batch: dict, done: torch.cuda.Event | None) -> dict:
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in batch.values():
                t.record_stream(cur)
        return batch

    def run(self, pipeline_epoch: Callable[..., Iterable], *,
            state: TrainState, n_epochs: int,
            lr_schedule: Callable[[int], float],
            eval_fn: Callable[[dict], dict] | None = None,
            on_epoch_end: Callable[[int, Any, Any], None] | None = None,
            ) -> EngineResult:
        """Train for ``n_epochs`` passes of ``pipeline_epoch()``.  A pipeline
        that accepts an explicit ``epoch=`` keyword gets the epoch index
        (and ``n_epochs=`` when it takes that too), as in the reference."""
        takes_epoch = accepts_kwarg(pipeline_epoch, "epoch", explicit=True)
        extra = ({"n_epochs": n_epochs}
                 if takes_epoch and accepts_kwarg(pipeline_epoch, "n_epochs",
                                                  explicit=True) else {})
        history: list[dict] = []
        for epoch in range(n_epochs):
            lr = float(np.float32(lr_schedule(epoch)))
            t0 = time.time()
            batches = (pipeline_epoch(epoch=epoch, **extra) if takes_epoch
                       else pipeline_epoch())
            step_metrics = []
            for batch in self._staged(batches):
                step_metrics.append(self.step_fn(state, batch, lr))
            if not step_metrics:
                warnings.warn(
                    f"epoch {epoch}: pipeline yielded no batches "
                    "(n_meta < n_workers?); skipping epoch row", stacklevel=2)
                continue
            keys = list(step_metrics[0])
            # One device->host fetch per epoch: (n_keys, steps) float32.
            table = torch.stack([torch.stack([m[k] for m in step_metrics])
                                 for k in keys]).cpu().numpy()
            row = {k: float(np.mean(table[i])) for i, k in enumerate(keys)}
            row.update(epoch=epoch, lr=lr, seconds=time.time() - t0)
            if eval_fn is not None:
                row.update(eval_fn(state.params))
            history.append(row)
            if on_epoch_end is not None:
                on_epoch_end(epoch, state.params, None)
        return EngineResult(state=state, history=history)
