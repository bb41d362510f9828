"""Eager training engine: the reference engine's three strategies.

The reference compiles each epoch into donated ``lax.scan`` chunks of
``scan_chunk`` steps.  PyTorch runs eagerly, so here an epoch is a Python
loop over steps, and ``scan_chunk`` only groups them: chunk c is steps
``[c·S, (c+1)·S)`` for S = ``scan_chunk``, and with ``scan_chunk=0`` the
whole epoch is one chunk.  The chunk is the unit of the reference's
coordinates (fault sites, guard windows), so a plan made for the reference
fires at the same steps here.  What the reference gets from its prefetch
thread and its once-per-epoch metric fetch is kept:

* host batches are staged ``prefetch`` steps ahead, one batch at a time:
  copied into pinned memory and sent to the GPU with ``non_blocking=True``
  on a side stream.  An event recorded after each batch's copies is what
  the compute stream waits on before the step that reads that batch, so a
  step never waits for the copies of the batches staged after it.  With a
  supervisor (the reference builds one from ``resilience``), each batch's
  staging runs under it: retried with backoff when it raises, and, with a
  ``hang_timeout``, on a watchdog thread that abandons a hung attempt;
* per-step metrics stay on the device and are fetched once per epoch.

How a step maps onto devices is an *execution strategy*, looked up by name
in :data:`repro_torch.api.registry.STRATEGY` (or passed as an instance):

* ``"sequential"`` — the k-worker step (``step_fn``) on one device;
* ``"sync_mesh"``  — the paper's k-worker synchronous SGD over a
  ``torch.distributed`` group (:func:`data_group`): each of R ranks stages
  and differentiates its k/R workers, and one ``all_gather`` of the
  gradients and metrics, summed in rank order on every rank, stands for the
  parameter server's reduction (no float atomics, identical params on
  every rank; at R = 1 the sequential step bit for bit);
* ``"async_ps"``   — the §4 stale-gradient parameter-server simulation: k
  per-worker parameter snapshots, round-robin pushes applied at once,
  snapshots refreshed every ``max_staleness`` pushes.

A strategy's *carry* is what a step reads and writes: the
:class:`TrainState` for the synchronous strategies, the state with the
snapshots, ages and the epoch-local step for ``async_ps``.

The reference's engine extras, on that loop, each on the whole carry:

* **checkpoint and resume** — every ``checkpoint_every`` epochs the carry
  (params, optimizer state, the dropout generator's state, the step, the
  guard's counters, and for ``async_ps`` the snapshots, ages and t) goes to
  ``checkpoint_dir/ckpt_<epoch>.npz`` with a meta sidecar holding the
  history, and LATEST points at it; ``run(..., resume=True)`` restores
  LATEST's target, or the newest valid checkpoint when that one is
  corrupt, and replays the skipped epochs of an epoch-blind pipeline on
  the host, so a resumed run equals an uninterrupted one bit for bit;
* **the two-speed non-finite guard** (``resilience.nonfinite_guard``) —
  the hot path runs the plain step; once per window of ``guard_window``
  chunks one finiteness reduction over the window's metrics and the state
  at its end, and one host fetch.  A tainted window is replayed from the
  backup of the carry taken at its start (generator state included) and
  its batches' pinned host copies, skipping exactly the poisoned steps;
  ``halt_after_consecutive`` raises :class:`NonFiniteHaltError`;
* **fault injection** (``injector``) — the batch site fires at its step,
  the prefetch site on the put of its chunk's first batch (a supervised
  retry re-stages that put), the worker site before its chunk's first step
  (through :meth:`FaultInjector.before_chunk`, re-applied when a guard
  replay runs that step again), the checkpoint site after its save;
* **the capture hook** — on the epochs ``capture_epochs`` selects,
  ``capture_fn(params, batch)`` runs after each step at the post-step
  params and ``on_epoch_end`` receives the epoch's captures stacked
  ``(steps, ...)`` on the host (the online graph refresh's tap).

History rows have the reference's keys: the epoch means of the step
metrics, ``epoch``, ``lr``, ``seconds`` (epoch wall time, ending with the
metric fetch), ``guard/skipped_total`` with the guard, and whatever
``eval_fn`` returns (``eval/acc``).
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import functools
import json
import os
import tempfile
import time
import warnings
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.ssl_loss import tree_leaves
from repro_torch.introspect import accepts_kwarg
from repro_torch.resilience.guard import (NonFiniteHaltError, all_finite,
                                          guard_init)
from repro_torch.resilience.supervisor import Supervisor
from repro_torch.train.checkpoint import (atomic_write_text, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.train_step import _unflatten

__all__ = ["TrainState", "EngineResult", "Engine", "lift_step",
           "stage_batch", "data_group", "SequentialStrategy",
           "SyncMeshStrategy", "AsyncPSStrategy", "AsyncCarry"]

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


def lift_step(update_fn: Callable) -> Callable:
    """Adapt a raw ``(params, opt_state, batch, lr) -> (params, opt_state,
    metrics)`` update into the engine's ``step_fn(state, batch, lr) ->
    metrics``: the state takes the returned params and optimizer state
    (the port's optimizers return the objects they updated in place) and
    its step counter advances; its generator is left alone (for steps that
    draw nothing, like the LM path)."""

    def step_fn(state: TrainState, batch, lr):
        state.params, state.opt_state, metrics = update_fn(
            state.params, state.opt_state, batch, lr)
        state.step += 1
        return metrics

    return step_fn


def _as_host_dict(batch) -> dict:
    """The batch's arrays by field name, without copies (``asdict`` would
    deep-copy every array of every batch), ``None`` fields dropped."""
    d = ({f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
         if dataclasses.is_dataclass(batch) and not isinstance(batch, dict)
         else dict(batch))
    return {k: v for k, v in d.items() if v is not None}


def _host_tensors(batch, device: torch.device) -> dict:
    """The batch's arrays as tensors: pinned copies for a GPU (what a
    non-blocking copy reads), views of the arrays for the CPU."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _as_host_dict(batch).items()}
    if device.type == "cuda":
        host = {k: t.pin_memory() for k, t in host.items()}
    return host


def _to_device(host: dict, device: torch.device,
               stream: torch.cuda.Stream | None = None) -> dict:
    """Host tensors -> ``device``; for a GPU a non-blocking copy, issued on
    ``stream`` when one is given."""
    if device.type != "cuda":
        return host
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        return {k: t.to(device, non_blocking=True) for k, t in host.items()}


def stage_batch(batch, device: torch.device,
                stream: torch.cuda.Stream | None = None) -> dict:
    """Host batch (``SSLBatch`` or dict of arrays) -> dict of tensors on
    ``device``.  For a GPU the arrays go through pinned memory and a
    non-blocking copy, issued on ``stream`` when one is given."""
    return _to_device(_host_tensors(batch, device), device, stream)


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


def _state_tree(state: TrainState) -> dict:
    """The state's part of a carry tree (what a checkpoint holds)."""
    return {"params": state.params, "opt_state": state.opt_state,
            "generator": (None if state.generator is None
                          else state.generator.get_state()),
            "step": state.step}


def _place_state_tree(state: TrainState, tree: dict) -> None:
    state.params = _assign(state.params, tree["params"])
    state.opt_state = _assign(state.opt_state, tree["opt_state"])
    if state.generator is not None:
        state.generator.set_state(
            torch.as_tensor(np.asarray(tree["generator"])))
    state.step = int(tree["step"])


class _Snapshot:
    """The carry a window (or a replayed step) may have to return to."""

    def __init__(self, strategy, carry):
        self.strategy = strategy
        self.tree = _clone(strategy.carry_tree(carry))

    def restore(self, carry) -> None:
        self.strategy.place_carry(carry, self.tree)


# ------------------------------------------------------------------ groups
_LOCAL_GROUPS: dict[str, Any] = {}


def _shutdown_local_groups() -> None:
    for group in _LOCAL_GROUPS.values():
        group.shutdown()
    _LOCAL_GROUPS.clear()


def data_group(n_workers: int, device: str | torch.device = "cuda"):
    """The ``torch.distributed`` group ``sync_mesh`` reduces over.

    The default process group when one is initialised (``torchrun``, or
    ``init_process_group`` by the caller), whose world size R must divide
    ``n_workers``; otherwise a world-size-1 group of this process on a
    ``FileStore`` in a temporary directory (NCCL for ``cuda``, gloo for
    ``cpu``), made once per backend, reused, and shut down at exit."""
    import torch.distributed as dist
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        R = dist.get_world_size()
        if n_workers % R:
            raise ValueError(
                f"sync_mesh: the process group's world size {R} does not "
                f"divide n_workers={n_workers}")
        return dist.group.WORLD
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in _LOCAL_GROUPS:
        if not _LOCAL_GROUPS:
            atexit.register(_shutdown_local_groups)
        store = dist.FileStore(os.path.join(
            tempfile.mkdtemp(prefix="repro_torch_group-"), "store"), 1)
        cls = (dist.ProcessGroupNCCL if backend == "nccl"
               else dist.ProcessGroupGloo)
        _LOCAL_GROUPS[backend] = cls(store, 0, 1)
    return _LOCAL_GROUPS[backend]


# -------------------------------------------------------------- strategies
class SequentialStrategy:
    """One device: the step is ``step_fn`` itself, the carry the state."""

    #: Whether this process writes the checkpoints.
    writes_checkpoints = True

    def __init__(self, engine: "Engine"):
        self.engine = engine
        if engine.step_fn is None:
            raise ValueError(f"strategy {type(self).__name__} needs step_fn=")

    # Placement ----------------------------------------------------------
    def place_state(self, state: TrainState) -> TrainState:
        return state

    def place_batch(self, batch, stream=None) -> tuple[dict, dict]:
        """``(host tensors, device tensors)`` of ``batch``: the host side
        (pinned on a GPU) is what a guard replay copies again."""
        host = _host_tensors(batch, self.engine.device)
        return host, _to_device(host, self.engine.device, stream)

    def carry_tree(self, carry) -> dict:
        """The carry as a nest of tensors and numbers (checkpoint, guard
        backup)."""
        return _state_tree(self.state_of(carry))

    def place_carry(self, carry, tree: dict):
        """Write a carry tree (a backup, or a checkpoint's numpy leaves)
        into ``carry`` in place."""
        _place_state_tree(self.state_of(carry), tree)
        return carry

    # Carry lifecycle ----------------------------------------------------
    def init_carry(self, state: TrainState):
        return state

    def begin_epoch(self, carry):
        return carry

    def state_of(self, carry) -> TrainState:
        return carry

    # Step ---------------------------------------------------------------
    def body(self, carry, batch: dict, lr: float) -> dict:
        return self.engine.step_fn(carry, batch, lr)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """A per-worker tensor of this process's batch over all workers."""
        return t

    def barrier(self) -> None:
        pass


class SyncMeshStrategy(SequentialStrategy):
    """The paper's k-worker synchronous SGD on a ``torch.distributed``
    group of R ranks (``engine.mesh``, see :func:`data_group`).

    Rank r stages workers ``[r·k/R, (r+1)·k/R)`` of each batch (every rank
    runs the same seeded host pipeline) and takes ``grad_fn`` of their
    mean loss, its dropout masks drawn for the whole ``(k, P, H)``
    activation from the shared generator and sliced.  One flat buffer of
    the gradients and the step's metrics goes through one ``all_gather``;
    every rank sums the R buffers in rank order and divides by R, then
    applies ``opt``.  The reduction order is fixed, so every rank keeps the
    same params bit for bit; at R = 1 the step is the sequential one bit
    for bit.  Rank 0 writes the checkpoints."""

    def __init__(self, engine: "Engine"):
        self.engine = engine
        if engine.grad_fn is None or engine.opt is None:
            raise ValueError("strategy 'sync_mesh' needs grad_fn= and opt=")
        if engine.mesh is None:
            raise ValueError("strategy 'sync_mesh' needs mesh= (a process "
                             "group); use repro_torch.train.engine.data_group")
        self.group = engine.mesh
        self.rank, self.size = self.group.rank(), self.group.size()
        self.k = engine.n_workers
        if self.k % self.size:
            raise ValueError(f"sync_mesh: {self.size} ranks do not divide "
                             f"n_workers={self.k}")
        share = self.k // self.size
        self.lo, self.hi = self.rank * share, (self.rank + 1) * share
        self.writes_checkpoints = self.rank == 0
        self._buffers: dict[tuple, tuple[torch.Tensor, list]] = {}

    def place_batch(self, batch, stream=None) -> tuple[dict, dict]:
        mine = {k: v[self.lo:self.hi] for k, v in _as_host_dict(batch).items()}
        return super().place_batch(mine, stream)

    def _all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """The R ranks' ``t``, in rank order, in this strategy's own
        buffers: valid until the next call with the same shape and dtype.

        Every call of one shape and dtype sends and receives through the
        same tensors, which the strategy keeps.  A collective's work can
        outlive its ``wait()`` on a gloo worker thread; were the work's
        tensors its last references, that thread would need the
        interpreter lock to free them, and a thread that asks for it while
        the interpreter exits ends the process with SIGABRT ("terminate
        called without an active exception")."""
        key = (tuple(t.shape), t.dtype, t.device)
        if key not in self._buffers:
            self._buffers[key] = (torch.empty_like(t), [
                torch.empty_like(t) for _ in range(self.size)])
        send, out = self._buffers[key]
        send.copy_(t)
        self.group.allgather([out], [send]).wait()
        return out

    def body(self, carry: TrainState, batch: dict, lr: float) -> dict:
        grads, metrics = self.engine.grad_fn(
            carry.params, batch, generator=carry.generator,
            workers=(self.lo, self.k))
        leaves = tree_leaves(grads)
        keys = sorted(metrics)
        flat = torch.cat([g.reshape(-1) for g in leaves]
                         + [metrics[k].reshape(1).to(leaves[0].dtype)
                            for k in keys])
        parts = self._all_gather(flat)
        total = parts[0]
        for part in parts[1:]:       # rank order: the same sum on each rank
            total = total + part
        total = total / self.size
        views, at = [], 0
        for g in leaves:
            views.append(total[at: at + g.numel()].view_as(g))
            at += g.numel()
        self.engine.opt.update(_unflatten(grads, views), carry.opt_state,
                               carry.params, lr)
        carry.step += 1
        return {k: total[at + i].to(metrics[k].dtype)
                for i, k in enumerate(keys)}

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._all_gather(t.contiguous()))

    def barrier(self) -> None:
        self._all_gather(torch.zeros(1, device=self.engine.device))


@dataclasses.dataclass
class AsyncCarry:
    """``async_ps``'s carry: the live state, one parameter snapshot per
    worker (each owning its storage), each worker's age in pushes since
    its last pull, and the epoch-local step ``t``."""

    state: TrainState
    snapshots: list
    ages: list
    t: int = 0


class AsyncPSStrategy(SequentialStrategy):
    """The stale-gradient parameter server of the reference.

    Worker ``w = t % k`` takes ``grad_fn`` at its snapshot; the server
    applies it to the live params at once (``opt``, in place); ``ages[w]``
    grows by one, and once it reaches ``max_staleness`` the worker pulls:
    its snapshot is refreshed from the live params with ``copy_`` (a
    snapshot never aliases the live tensors, which the optimizer updates
    in place).  ``t`` restarts each epoch.  With
    ``resilience.drop_overstale`` a worker older than ``max_staleness`` has
    its gradient scaled by 0 and each live one by ``k / n_live``
    (float32); the zero update is still applied and ``async/dropped`` set.
    """

    def __init__(self, engine: "Engine"):
        self.engine = engine
        if engine.grad_fn is None or engine.opt is None:
            raise ValueError("strategy 'async_ps' needs grad_fn= and opt=")
        self.k = engine.n_workers
        self.max_staleness = engine.max_staleness
        self.drop_overstale = bool(
            getattr(engine.resilience, "drop_overstale", False))

    def carry_tree(self, carry: AsyncCarry) -> dict:
        return {**_state_tree(carry.state), "snapshots": carry.snapshots,
                "ages": np.asarray(carry.ages, np.int32), "t": carry.t}

    def place_carry(self, carry: AsyncCarry, tree: dict):
        _place_state_tree(carry.state, tree)
        carry.snapshots = _assign(carry.snapshots, tree["snapshots"])
        carry.ages = [int(a) for a in np.asarray(tree["ages"]).reshape(-1)]
        carry.t = int(tree["t"])
        return carry

    def init_carry(self, state: TrainState) -> AsyncCarry:
        return AsyncCarry(state=state,
                          snapshots=[_clone(state.params)
                                     for _ in range(self.k)],
                          ages=[0] * self.k, t=0)

    def begin_epoch(self, carry: AsyncCarry) -> AsyncCarry:
        carry.t = 0
        return carry

    def state_of(self, carry: AsyncCarry) -> TrainState:
        return carry.state

    def bump_age(self, carry: AsyncCarry, worker: int, amount: float):
        """Fault hook: age worker ``worker % k`` by ``amount`` pushes
        (0: past ``max_staleness``, a dead worker)."""
        carry.ages[int(worker) % self.k] += (int(amount)
                                             or self.max_staleness + 1)
        return carry

    def body(self, carry: AsyncCarry, batch: dict, lr: float) -> dict:
        state, w = carry.state, carry.t % self.k
        grads, metrics = self.engine.grad_fn(carry.snapshots[w], batch)
        if self.drop_overstale:
            live = [a <= self.max_staleness for a in carry.ages]
            scale = (np.float32(self.k) / np.float32(max(sum(live), 1))
                     if live[w] else np.float32(0.0))
            grads = [g * float(scale) for g in tree_leaves(grads)]
            metrics = dict(metrics)
            metrics["async/dropped"] = torch.full(
                (), 0.0 if live[w] else 1.0, dtype=torch.float32,
                device=self.engine.device)
        self.engine.opt.update(grads, state.opt_state, state.params, lr)
        carry.ages[w] += 1
        if carry.ages[w] >= self.max_staleness:
            with torch.no_grad():
                for s, p in zip(tree_leaves(carry.snapshots[w]),
                                tree_leaves(state.params)):
                    s.copy_(p)
            carry.ages[w] = 0
        state.step += 1
        carry.t += 1
        return metrics


class _BumpRecorder:
    """Stands in for a strategy with ``bump_age`` in
    :meth:`FaultInjector.before_chunk`, recording the bump so that a guard
    replay of the chunk's first step applies it again."""

    def __init__(self, strategy):
        self.strategy = strategy
        self.bump = None

    def bump_age(self, carry, worker, amount):
        self.bump = (worker, amount)
        return self.strategy.bump_age(carry, worker, amount)


# ------------------------------------------------------------------ engine
class Engine:
    """Runs a strategy's step over epochs of batches.

    ``step_fn(state, batch, lr) -> metrics`` updates ``state`` in place
    (params, optimizer state, step counter) and returns a dict of 0-d
    device tensors: the ``sequential`` step.  ``grad_fn(params, batch,
    generator=None, workers=None) -> (grads, metrics)`` and ``opt`` serve
    ``sync_mesh`` (with the generator and its workers' place) and
    ``async_ps`` (at a stale snapshot, without dropout).  ``strategy`` is a
    STRATEGY registry name or an instance; ``mesh`` is ``sync_mesh``'s
    process group (:func:`data_group`), ``n_workers`` its k and
    ``async_ps``'s, ``max_staleness`` ``async_ps``'s bound.

    ``scan_chunk`` S groups steps into chunks of S (0: one chunk an epoch),
    the unit of the fault sites' and the guard windows' coordinates.
    ``prefetch = d > 0`` keeps the next ``d`` batches staged while the
    current one trains; 0 stages each batch right before its step.

    ``checkpoint_every``/``checkpoint_dir`` save the carry every N epochs;
    ``resilience`` (a ``ResilienceConfig``-shaped object) turns on the
    non-finite guard (``nonfinite_guard``, ``guard_window`` chunks,
    ``halt_after_consecutive``), checkpoint integrity and retention
    (``checkpoint_checksums``, ``keep_last``), ``async_ps``'s
    ``drop_overstale`` and the staging supervisor's retries and hang
    watchdog; ``injector`` (a
    :class:`~repro_torch.resilience.faults.FaultInjector`) arms fault
    injection; ``capture_fn(params, batch) -> tensor`` is the embedding
    tap of the epochs ``run(capture_epochs=...)`` selects.

    ``step_scope(step)`` is a context manager entered around each step's
    worker event and body (not around a guard's replay of it); an audit
    sets it to mark the steps of a chunk.
    """

    #: Metrics key the capture tap rides under; popped out of the step
    #: metrics (and stacked for ``on_epoch_end``) before row averaging.
    _CAPTURE_KEY = "capture/emb"
    step_scope: Callable[[int], Any] = staticmethod(
        lambda step: contextlib.nullcontext())

    def __init__(self, step_fn: Callable | None = None, *,
                 device: torch.device, grad_fn: Callable | None = None,
                 opt=None, strategy: str | Any = "sequential", mesh=None,
                 n_workers: int = 1, max_staleness: int = 2,
                 scan_chunk: int = 0, prefetch: int = 1,
                 checkpoint_every: int = 0,
                 checkpoint_dir: str | None = None, resilience=None,
                 injector=None, capture_fn: Callable | None = None):
        if scan_chunk < 0:
            raise ValueError(f"scan_chunk must be >= 0, got {scan_chunk}")
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        if checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {checkpoint_every}")
        if checkpoint_every > 0 and not checkpoint_dir:
            raise ValueError("checkpoint_every > 0 requires checkpoint_dir")
        self.step_fn = step_fn
        self.grad_fn = grad_fn
        self.opt = opt
        self.device = device
        self.mesh = mesh
        self.n_workers = n_workers
        self.max_staleness = max_staleness
        self.scan_chunk = scan_chunk
        self.prefetch = prefetch
        self.checkpoint_every = checkpoint_every
        self.checkpoint_dir = checkpoint_dir
        self.resilience = resilience
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
        if isinstance(strategy, str):
            # Lazy: api.registry only names this module's classes.
            from repro_torch.api.registry import STRATEGY
            strategy = STRATEGY.get(strategy)(self)
        self.strategy = strategy

    def _chunk_at(self, step: int) -> int | None:
        """The chunk that starts at epoch-local ``step``, else None."""
        S = self.scan_chunk
        if S == 0:
            return 0 if step == 0 else None
        return step // S if step % S == 0 else None

    # ------------------------------------------------------------ staging
    def _stage(self, batch) -> tuple[dict, dict, torch.cuda.Event | None]:
        """Stage ``batch``: ``(host tensors, device tensors, event)``, the
        event marking the end of its copies on the side stream."""
        return self._copied(*self.strategy.place_batch(batch,
                                                       self._copy_stream))

    def _copied(self, host: dict, staged: dict) -> tuple:
        if self._copy_stream is None:
            return host, staged, None
        done = torch.cuda.Event()
        done.record(self._copy_stream)
        return host, staged, done

    def _host_batches(self, batches: Iterable, epoch: int) -> Iterator:
        """The epoch's host batches, a batch-site fault event poisoning its
        step's batch."""
        for step, b in enumerate(batches):
            yield (b if self.injector is None else self.injector.on_batch(
                _as_host_dict(b), epoch=epoch, step=step))

    def _staged(self, batches: Iterable, epoch: int = 0) -> Iterator[tuple]:
        """``(host tensors, device batch)`` pairs, each device batch staged
        ``prefetch`` steps ahead of its use and ordered on the compute
        stream after its own copies only.  The put of a chunk's first batch
        goes through the injector's prefetch site, whose counter so counts
        chunks."""
        put = first = self._stage
        if self.injector is not None:
            first = self.injector.wrap_put(put, epoch=epoch)
        if self.supervisor is not None:
            put, first = (functools.partial(self.supervisor.call, p,
                                            key=f"prefetch@{epoch}")
                          for p in (put, first))
        queue: collections.deque = collections.deque()
        for step, b in enumerate(batches):
            queue.append((put if self._chunk_at(step) is None
                          else first)(b))
            if len(queue) > self.prefetch:
                yield self._ready(*queue.popleft())
        while queue:
            yield self._ready(*queue.popleft())

    def _ready(self, host, batch: dict,
               done: torch.cuda.Event | None) -> tuple:
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in batch.values():
                t.record_stream(cur)
        return host, batch

    # --------------------------------------------------------------- steps
    def _worker_event(self, carry, epoch: int, step: int):
        """At a chunk's first step, the injector's worker event for that
        chunk (the strategy's ``bump_age``): ``(carry, bump)``, ``bump``
        what a replay of the step applies again (None: nothing fired)."""
        chunk = self._chunk_at(step)
        if self.injector is None or chunk is None:
            return carry, None
        rec = (_BumpRecorder(self.strategy)
               if hasattr(self.strategy, "bump_age") else self.strategy)
        carry = self.injector.before_chunk(rec, carry, epoch=epoch,
                                           chunk=chunk)
        return carry, getattr(rec, "bump", None)

    def _step(self, carry, batch: dict, lr: float, capture: bool) -> dict:
        metrics = self.strategy.body(carry, batch, lr)
        if self._guard:
            metrics = dict(metrics)
            metrics["guard/skipped"] = torch.zeros(
                (), dtype=torch.float32, device=self.device)
        if capture:
            metrics = dict(metrics)
            with torch.no_grad():
                metrics[self._CAPTURE_KEY] = self.strategy.gather(
                    self.capture_fn(self.strategy.state_of(carry).params,
                                    batch))
        return metrics

    def _guarded_steps(self, carry, batches: Iterable, lr: float,
                       capture: bool, guard: tuple,
                       epoch: int) -> tuple[list[dict], tuple]:
        """The epoch's steps in windows of ``guard_window`` chunks: each
        window keeps the carry it started from and its batches' host
        tensors (pinned on a GPU, so the caching host allocator reuses
        them; a replay copies them to the device again), and is resolved
        by one fetch at its end."""
        out: list[dict] = []
        window: list[list] = []          # [host tensors, metrics, bump]
        backup = None
        span = self._guard_window * self.scan_chunk   # 0: the whole epoch
        for step, (host, batch) in enumerate(batches):
            if not window:
                backup = _Snapshot(self.strategy, carry)
            with self.step_scope(step):
                carry, bump = self._worker_event(carry, epoch, step)
                window.append([host, self._step(carry, batch, lr, capture),
                               bump])
            if len(window) == span:
                guard = self._resolve(carry, window, backup, lr, capture,
                                      guard, epoch)
                out.extend(m for _, m, _ in window)
                window = []
        if window:
            guard = self._resolve(carry, window, backup, lr, capture, guard,
                                  epoch)
            out.extend(m for _, m, _ in window)
        return out, guard

    def _finite(self, carry, metrics) -> torch.Tensor:
        state = self.strategy.state_of(carry)
        return all_finite((metrics, state.params, state.opt_state))

    def _resolve(self, carry, window: list, backup: _Snapshot, lr: float,
                 capture: bool, guard: tuple, epoch: int) -> tuple:
        """One finiteness reduction over the window's metrics and the state
        at its end, one fetch; a tainted window is replayed step by step
        from ``backup`` (its worker bumps applied again), a non-finite step
        keeping the carry it started from (its metrics zeroed,
        ``guard/skipped`` 1)."""
        skipped, consec_in, worst, tainted = guard
        ok = self._finite(carry, [m for _, m, _ in window])
        consec = torch.where(ok, torch.zeros_like(consec_in), consec_in)
        tainted = tainted | ~ok
        n_skipped, n_worst, is_tainted, n_consec = torch.stack(
            [skipped, worst, tainted.to(torch.int32), consec_in]).tolist()
        if is_tainted:
            backup.restore(carry)
            for item in window:
                if item[2] is not None:
                    carry = self.strategy.bump_age(carry, *item[2])
                before = _Snapshot(self.strategy, carry)
                batch = self._ready(*self._copied(item[0], _to_device(
                    item[0], self.device, self._copy_stream)))[1]
                metrics = self._step(carry, batch, lr, capture)
                if self._finite(carry, metrics).item():
                    n_consec = 0
                else:
                    before.restore(carry)
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

    def _carry(self, carry, guard) -> dict:
        """What a checkpoint holds: the strategy's carry and the guard."""
        return {**self.strategy.carry_tree(carry), "guard": guard}

    def _save(self, carry, guard, epoch: int, history: list[dict]) -> None:
        if self.strategy.writes_checkpoints:
            path = self._ckpt_path(epoch)
            save_checkpoint(path, self._carry(carry, guard),
                            checksum=self._checksums)
            atomic_write_text(path + ".meta.json",
                              json.dumps({"epoch": epoch,
                                          "history": history}))
            atomic_write_text(os.path.join(self.checkpoint_dir, _LATEST),
                              os.path.basename(path))
            if self.injector is not None:
                # Simulated bit rot / torn write of the file LATEST points
                # at — after the pointer update, so recovery must fall back.
                self.injector.after_checkpoint(path + ".npz", epoch=epoch)
            if self._keep_last:
                self._prune(keep=os.path.basename(path))
        self.strategy.barrier()

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
        """(carry tree, completed_epochs, history) from the newest *valid*
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
        ``checkpoint_dir`` (if any) into the carry in place.
        ``capture_epochs`` (a predicate or a container of epoch indices)
        selects the epochs whose steps run ``capture_fn``;
        ``on_epoch_end(epoch, params, captures)`` fires after every epoch
        row with those captures stacked on the host (``None`` on other
        epochs).  On a guard-replayed window, skipped steps' captures are
        zeroed like their metrics."""
        strategy = self.strategy
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

        carry = strategy.init_carry(strategy.place_state(state))
        guard = guard_init(self.device) if self._guard else None
        start, history = 0, []
        if resume:
            loaded = self._load_latest(self._carry(carry, guard))
            if loaded is not None:
                tree, start, history = loaded
                carry = strategy.place_carry(carry, tree)
                if guard is not None:
                    guard = tuple(torch.as_tensor(v, device=self.device)
                                  for v in tree["guard"])
        if start < n_epochs and not takes_epoch:
            # Epoch-blind pipelines advance host RNG per call: replay the
            # skipped epochs (data pass only, no compute).
            for past in range(start):
                for _ in epoch_batches(past):
                    pass

        for epoch in range(start, n_epochs):
            carry = strategy.begin_epoch(carry)
            lr = float(np.float32(lr_schedule(epoch)))
            cap = capture_on(epoch)
            t0 = time.time()
            batches = self._staged(
                self._host_batches(epoch_batches(epoch), epoch), epoch)
            if guard is None:
                step_metrics = []
                for step, (_, b) in enumerate(batches):
                    with self.step_scope(step):
                        carry, _ = self._worker_event(carry, epoch, step)
                        step_metrics.append(self._step(carry, b, lr, cap))
            else:
                step_metrics, guard = self._guarded_steps(
                    carry, batches, lr, cap, guard, epoch)
            if not step_metrics:
                warnings.warn(
                    f"epoch {epoch}: pipeline yielded no batches "
                    "(n_meta < n_workers?); skipping epoch row", stacklevel=2)
                continue
            params = strategy.state_of(carry).params
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
                row.update(eval_fn(params))
            history.append(row)
            if on_epoch_end is not None:
                on_epoch_end(epoch, params, captures)
            if self.checkpoint_every and \
                    (epoch + 1) % self.checkpoint_every == 0:
                self._save(carry, guard, epoch + 1, history)
        return EngineResult(state=strategy.state_of(carry), history=history)
