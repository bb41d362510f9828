"""Eager training engine: the reference engine's sequential strategy.

The reference compiles each epoch into donated ``lax.scan`` chunks.  PyTorch
runs eagerly, so here an epoch is a Python loop over steps.  What the
reference gets from its prefetch thread and its once-per-epoch metric fetch
is kept:

* host batches are staged ``prefetch`` steps ahead: copied into pinned
  memory and sent to the GPU with ``non_blocking=True`` on a side stream.
  An event recorded after each batch's copies is what the compute stream
  waits on before the step that reads that batch, so a step never waits
  for the copies of the batches staged after it.  With a supervisor (the
  reference builds one from ``resilience``), each batch's staging runs
  under it: retried with backoff when it raises, and, with a
  ``hang_timeout``, on a watchdog thread that abandons a hung attempt;
* per-step metrics stay on the device and are fetched once per epoch.

The reference's engine extras, on that loop:

* **checkpoint and resume** — every ``checkpoint_every`` epochs the state
  (params, optimizer state, the dropout generator's state, the step and
  the guard's counters) goes to ``checkpoint_dir/ckpt_<epoch>.npz`` with a
  meta sidecar holding the history, and LATEST points at it;
  ``run(..., resume=True)`` restores LATEST's target, or the newest valid
  checkpoint when that one is corrupt, and replays the skipped epochs of
  an epoch-blind pipeline on the host, so a resumed run equals an
  uninterrupted one bit for bit;
* **the two-speed non-finite guard** (``resilience.nonfinite_guard``) —
  the hot path runs the plain step; once per window of ``guard_window``
  steps (the port has no scan chunks: a window counts steps) one
  finiteness reduction over the window's metrics and the state at its end,
  and one host fetch.  A tainted window is replayed from the backup taken
  at its start (generator state included), skipping exactly the poisoned
  steps; ``halt_after_consecutive`` raises :class:`NonFiniteHaltError`;
* **fault injection** (``injector``) — the batch, prefetch and checkpoint
  sites fire at their planned coordinates (the prefetch site's chunk index
  is the step: a chunk here is one batch);
* **the capture hook** — on the epochs ``capture_epochs`` selects,
  ``capture_fn(params, batch)`` runs after each step at the post-step
  params and ``on_epoch_end`` receives the epoch's captures stacked
  ``(steps, ...)`` on the host (the online graph refresh's tap).

History rows have the reference's keys: the epoch means of the step
metrics, ``epoch``, ``lr``, ``seconds`` (epoch wall time, ending with the
metric fetch), ``guard/skipped_total`` with the guard, and whatever
``eval_fn`` returns (``eval/acc``).

Other strategies (``sync_mesh``, ``async_ps``) belong to a later slice of
the port; :func:`repro_torch.train.trainer.train_dnn_ssl` refuses them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import time
import warnings
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.introspect import accepts_kwarg
from repro_torch.resilience.guard import (NonFiniteHaltError, all_finite,
                                          guard_init)
from repro_torch.resilience.supervisor import Supervisor
from repro_torch.train.checkpoint import (atomic_write_text, load_checkpoint,
                                          save_checkpoint)

__all__ = ["TrainState", "EngineResult", "Engine", "stage_batch"]

_LATEST = "LATEST"


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


def _clone(tree):
    """A copy of a nest's tensor leaves (other leaves are shared)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _assign(dst, src):
    """Write ``src``'s leaves into ``dst``'s nest: tensors in place (they
    keep their identity, which the in-place optimizer relies on), numpy
    arrays and numbers as tensors or numbers of ``dst``'s kind.  Returns
    the nest with any non-tensor leaves replaced."""
    if isinstance(dst, dict):
        return {k: _assign(dst[k], src[k]) for k in dst}
    if isinstance(dst, (list, tuple)):
        return type(dst)(_assign(d, s) for d, s in zip(dst, src))
    if isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(torch.as_tensor(np.asarray(src)) if not isinstance(
                src, torch.Tensor) else src)
        return dst
    if dst is None:
        return None
    return type(dst)(np.asarray(src).item())


class _Snapshot:
    """The state a window (or a replayed step) may have to return to."""

    def __init__(self, state: TrainState):
        self.params = _clone(state.params)
        self.opt_state = _clone(state.opt_state)
        self.generator = (None if state.generator is None
                          else state.generator.get_state())
        self.step = state.step

    def restore(self, state: TrainState) -> None:
        state.params = _assign(state.params, self.params)
        state.opt_state = _assign(state.opt_state, self.opt_state)
        if state.generator is not None:
            state.generator.set_state(self.generator)
        state.step = self.step


class Engine:
    """Runs ``step_fn(state, batch, lr) -> metrics`` over epochs of batches.

    ``step_fn`` updates ``state`` in place (params, optimizer state, step
    counter) and returns a dict of 0-d device tensors.  ``prefetch = d > 0``
    keeps the next ``d`` batches staged while the current one trains; 0
    stages each batch right before its step.

    ``checkpoint_every``/``checkpoint_dir`` save the state every N epochs;
    ``resilience`` (a ``ResilienceConfig``-shaped object) turns on the
    non-finite guard (``nonfinite_guard``, ``guard_window``,
    ``halt_after_consecutive``), checkpoint integrity and retention
    (``checkpoint_checksums``, ``keep_last``) and the staging supervisor's
    retries and hang watchdog; ``injector`` (a
    :class:`~repro_torch.resilience.faults.FaultInjector`) arms fault
    injection; ``capture_fn(params, batch) -> tensor`` is the embedding
    tap of the epochs ``run(capture_epochs=...)`` selects.
    """

    #: Metrics key the capture tap rides under; popped out of the step
    #: metrics (and stacked for ``on_epoch_end``) before row averaging.
    _CAPTURE_KEY = "capture/emb"

    def __init__(self, step_fn: Callable, *, device: torch.device,
                 prefetch: int = 1, checkpoint_every: int = 0,
                 checkpoint_dir: str | None = None, resilience=None,
                 injector=None, capture_fn: Callable | None = None):
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        if checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {checkpoint_every}")
        if checkpoint_every > 0 and not checkpoint_dir:
            raise ValueError("checkpoint_every > 0 requires checkpoint_dir")
        self.step_fn = step_fn
        self.device = device
        self.prefetch = prefetch
        self.checkpoint_every = checkpoint_every
        self.checkpoint_dir = checkpoint_dir
        self.injector = injector
        self.capture_fn = capture_fn
        # Knobs are duck-typed off the config object, defaults as the
        # reference's.
        self._guard = bool(getattr(resilience, "nonfinite_guard", False))
        self._guard_window = max(
            1, int(getattr(resilience, "guard_window", 4) or 4))
        self._halt_after = int(
            getattr(resilience, "halt_after_consecutive", 0) or 0)
        self._checksums = bool(
            getattr(resilience, "checkpoint_checksums", True))
        self._keep_last = int(getattr(resilience, "keep_last", 0) or 0)
        self.supervisor = (None if resilience is None else
                           Supervisor.from_config(resilience,
                                                  name="prefetch"))
        self._copy_stream = (torch.cuda.Stream(device)
                             if device.type == "cuda" and prefetch else None)

    # ------------------------------------------------------------ staging
    def _stage(self, batch) -> tuple[dict, torch.cuda.Event | None]:
        """Stage ``batch``; on the side stream, also return the event that
        marks the end of its copies."""
        staged = stage_batch(batch, self.device, self._copy_stream)
        if self._copy_stream is None:
            return staged, None
        done = torch.cuda.Event()
        done.record(self._copy_stream)
        return staged, done

    def _host_batches(self, batches: Iterable, epoch: int) -> Iterator:
        """The epoch's host batches, a batch-site fault event poisoning its
        step's batch."""
        for step, b in enumerate(batches):
            yield (b if self.injector is None else self.injector.on_batch(
                _as_host_dict(b), epoch=epoch, step=step))

    def _staged(self, batches: Iterable, epoch: int = 0) -> Iterator[dict]:
        """Device batches, each staged ``prefetch`` steps ahead of its use
        and ordered on the compute stream after its own copies only."""
        put = self._stage
        if self.injector is not None:
            put = self.injector.wrap_put(put, epoch=epoch)
        if self.supervisor is not None:
            put = functools.partial(self.supervisor.call, put,
                                    key=f"prefetch@{epoch}")
        queue: collections.deque = collections.deque()
        for b in batches:
            queue.append(put(b))
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

    # --------------------------------------------------------------- steps
    def _step(self, state: TrainState, batch: dict, lr: float,
              capture: bool) -> dict:
        metrics = self.step_fn(state, batch, lr)
        if self._guard:
            metrics = dict(metrics)
            metrics["guard/skipped"] = torch.zeros(
                (), dtype=torch.float32, device=self.device)
        if capture:
            metrics = dict(metrics)
            with torch.no_grad():
                metrics[self._CAPTURE_KEY] = self.capture_fn(state.params,
                                                             batch)
        return metrics

    def _guarded_steps(self, state: TrainState, batches: Iterable,
                       lr: float, capture: bool, guard: tuple,
                       epoch: int) -> tuple[list[dict], tuple]:
        """The epoch's steps in windows of ``guard_window``: each window
        keeps the state it started from and its device batches, and is
        resolved by one fetch at its end."""
        out: list[dict] = []
        window: list[list] = []          # [batch, metrics] per step
        backup = None
        for batch in batches:
            if not window:
                backup = _Snapshot(state)
            window.append([batch, self._step(state, batch, lr, capture)])
            if len(window) == self._guard_window:
                guard = self._resolve(state, window, backup, lr, capture,
                                      guard, epoch)
                out.extend(m for _, m in window)
                window = []
        if window:
            guard = self._resolve(state, window, backup, lr, capture, guard,
                                  epoch)
            out.extend(m for _, m in window)
        return out, guard

    def _resolve(self, state: TrainState, window: list, backup: _Snapshot,
                 lr: float, capture: bool, guard: tuple, epoch: int) -> tuple:
        """One finiteness reduction over the window's metrics and the state
        at its end, one fetch; a tainted window is replayed step by step
        from ``backup``, a non-finite step keeping the state it started
        from (its metrics zeroed, ``guard/skipped`` 1)."""
        skipped, consec_in, worst, tainted = guard
        ok = all_finite(([m for _, m in window], state.params,
                         state.opt_state))
        consec = torch.where(ok, torch.zeros_like(consec_in), consec_in)
        tainted = tainted | ~ok
        n_skipped, n_worst, is_tainted, n_consec = torch.stack(
            [skipped, worst, tainted.to(torch.int32), consec_in]).tolist()
        if is_tainted:
            backup.restore(state)
            for item in window:
                before = _Snapshot(state)
                metrics = self._step(state, item[0], lr, capture)
                if all_finite((metrics, state.params,
                               state.opt_state)).item():
                    n_consec = 0
                else:
                    before.restore(state)
                    metrics = {k: torch.zeros_like(v)
                               for k, v in metrics.items()}
                    metrics["guard/skipped"] = torch.ones_like(
                        metrics["guard/skipped"])
                    n_skipped += 1
                    n_consec += 1
                    n_worst = max(n_worst, n_consec)
                item[1] = metrics
            dev = skipped.device
            skipped, consec, worst = (
                torch.tensor(v, dtype=torch.int32, device=dev)
                for v in (n_skipped, n_consec, n_worst))
            tainted = torch.zeros((), dtype=torch.bool, device=dev)
        if self._halt_after and n_worst >= self._halt_after:
            raise NonFiniteHaltError(
                f"{n_worst} consecutive non-finite steps "
                f"(halt_after_consecutive={self._halt_after}) at epoch "
                f"{epoch}")
        return skipped, consec, worst, tainted

    # ---------------------------------------------------------- checkpoints
    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.checkpoint_dir, f"ckpt_{epoch:05d}")

    @staticmethod
    def _carry(state: TrainState, guard) -> dict:
        """What a checkpoint holds."""
        return {"params": state.params, "opt_state": state.opt_state,
                "generator": (None if state.generator is None
                              else state.generator.get_state()),
                "step": state.step, "guard": guard}

    def _save(self, state: TrainState, guard, epoch: int,
              history: list[dict]) -> None:
        path = self._ckpt_path(epoch)
        save_checkpoint(path, self._carry(state, guard),
                        checksum=self._checksums)
        atomic_write_text(path + ".meta.json",
                          json.dumps({"epoch": epoch, "history": history}))
        atomic_write_text(os.path.join(self.checkpoint_dir, _LATEST),
                          os.path.basename(path))
        if self.injector is not None:
            # Simulated bit rot / torn write of the file LATEST points at —
            # after the pointer update, so recovery must fall back.
            self.injector.after_checkpoint(path + ".npz", epoch=epoch)
        if self._keep_last:
            self._prune(keep=os.path.basename(path))

    def _prune(self, keep: str) -> None:
        """Drop all but the newest ``keep_last`` checkpoints (never the one
        just written).  Epoch numbers order lexically at fixed width."""
        names = sorted(
            (f[:-len(".npz")] for f in os.listdir(self.checkpoint_dir)
             if f.startswith("ckpt_") and f.endswith(".npz")), reverse=True)
        for base in names[self._keep_last:]:
            if base == keep:
                continue
            stem = os.path.join(self.checkpoint_dir, base)
            for suffix in (".npz", ".npz.sha256", ".meta.json"):
                if os.path.exists(stem + suffix):
                    os.remove(stem + suffix)

    def _load_latest(self, template: dict):
        """(carry, completed_epochs, history) from the newest *valid*
        checkpoint, or None when the directory holds none.

        The LATEST pointer's target is tried first; if it is corrupt
        (checksum mismatch, torn archive, unreadable meta) the remaining
        ``ckpt_*`` files are tried newest-first, each failure downgraded
        to a warning — a crash or bit flip costs at most the epochs since
        the last good save, never the run.
        """
        if not self.checkpoint_dir or not os.path.isdir(self.checkpoint_dir):
            return None
        pointer = os.path.join(self.checkpoint_dir, _LATEST)
        candidates: list[str] = []
        if os.path.exists(pointer):
            with open(pointer) as f:
                candidates.append(f.read().strip())
        candidates += sorted(
            (f[:-len(".npz")] for f in os.listdir(self.checkpoint_dir)
             if f.startswith("ckpt_") and f.endswith(".npz")), reverse=True)
        seen: set[str] = set()
        for base in candidates:
            if not base or base in seen:
                continue
            seen.add(base)
            path = os.path.join(self.checkpoint_dir, base)
            try:
                carry = load_checkpoint(path, template,
                                        verify=self._checksums)
                with open(path + ".meta.json") as f:
                    meta = json.load(f)
                epoch, hist = int(meta["epoch"]), list(meta["history"])
            except Exception as e:  # noqa: BLE001 — degrade to older ckpt
                warnings.warn(
                    f"checkpoint {base} is unusable "
                    f"({type(e).__name__}: {e}); falling back to the next "
                    "newest", stacklevel=2)
                continue
            return carry, epoch, hist
        return None

    # ----------------------------------------------------------------- run
    def run(self, pipeline_epoch: Callable[..., Iterable], *,
            state: TrainState, n_epochs: int,
            lr_schedule: Callable[[int], float],
            eval_fn: Callable[[dict], dict] | None = None,
            resume: bool = False,
            capture_epochs: Callable[[int], bool] | Any = None,
            on_epoch_end: Callable[[int, Any, Any], None] | None = None,
            ) -> EngineResult:
        """Train for ``n_epochs`` passes of ``pipeline_epoch()``.  A pipeline
        that accepts an explicit ``epoch=`` keyword gets the epoch index
        (and ``n_epochs=`` when it takes that too), as in the reference; such
        an epoch-pure pipeline needs no host replay on resume, an
        epoch-blind one has the skipped epochs' batches drawn and dropped.

        ``resume=True`` restores the newest valid checkpoint of
        ``checkpoint_dir`` (if any) into ``state`` in place.
        ``capture_epochs`` (a predicate or a container of epoch indices)
        selects the epochs whose steps run ``capture_fn``;
        ``on_epoch_end(epoch, params, captures)`` fires after every epoch
        row with those captures stacked on the host (``None`` on other
        epochs).  On a guard-replayed window, skipped steps' captures are
        zeroed like their metrics."""
        takes_epoch = accepts_kwarg(pipeline_epoch, "epoch", explicit=True)
        extra = ({"n_epochs": n_epochs}
                 if takes_epoch and accepts_kwarg(pipeline_epoch, "n_epochs",
                                                  explicit=True) else {})

        def epoch_batches(e: int):
            return (pipeline_epoch(epoch=e, **extra) if takes_epoch
                    else pipeline_epoch())

        def capture_on(e: int) -> bool:
            if self.capture_fn is None or capture_epochs is None:
                return False
            if callable(capture_epochs):
                return bool(capture_epochs(e))
            return e in capture_epochs

        guard = guard_init(self.device) if self._guard else None
        start, history = 0, []
        if resume:
            loaded = self._load_latest(self._carry(state, guard))
            if loaded is not None:
                carry, start, history = loaded
                state.params = _assign(state.params, carry["params"])
                state.opt_state = _assign(state.opt_state,
                                          carry["opt_state"])
                if state.generator is not None:
                    state.generator.set_state(
                        torch.from_numpy(carry["generator"]))
                state.step = int(carry["step"])
                if guard is not None:
                    guard = tuple(torch.as_tensor(v, device=self.device)
                                  for v in carry["guard"])
        if start < n_epochs and not takes_epoch:
            # Epoch-blind pipelines advance host RNG per call: replay the
            # skipped epochs (data pass only, no compute).
            for past in range(start):
                for _ in epoch_batches(past):
                    pass

        for epoch in range(start, n_epochs):
            lr = float(np.float32(lr_schedule(epoch)))
            cap = capture_on(epoch)
            t0 = time.time()
            batches = self._staged(
                self._host_batches(epoch_batches(epoch), epoch), epoch)
            if guard is None:
                step_metrics = [self._step(state, b, lr, cap)
                                for b in batches]
            else:
                step_metrics, guard = self._guarded_steps(
                    state, batches, lr, cap, guard, epoch)
            if not step_metrics:
                warnings.warn(
                    f"epoch {epoch}: pipeline yielded no batches "
                    "(n_meta < n_workers?); skipping epoch row", stacklevel=2)
                continue
            captures = None
            if cap:
                # The tap must not enter the row means: stack it (steps,
                # ...) on the host.
                captures = torch.stack(
                    [m.pop(self._CAPTURE_KEY) for m in step_metrics]
                ).cpu().numpy()
            keys = list(step_metrics[0])
            # One device->host fetch per epoch: (n_keys, steps) float32.
            table = torch.stack([torch.stack([m[k] for m in step_metrics])
                                 for k in keys]).cpu().numpy()
            row = {k: float(np.mean(table[i])) for i, k in enumerate(keys)}
            row.update(epoch=epoch, lr=lr, seconds=time.time() - t0)
            if guard is not None:
                row["guard/skipped_total"] = int(guard[0])
            if eval_fn is not None:
                row.update(eval_fn(state.params))
            history.append(row)
            if on_epoch_end is not None:
                on_epoch_end(epoch, state.params, captures)
            if self.checkpoint_every and \
                    (epoch + 1) % self.checkpoint_every == 0:
                self._save(state, guard, epoch + 1, history)
        return EngineResult(state=state, history=history)
