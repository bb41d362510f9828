"""Seeded, deterministic fault injection for the training stack.

A :class:`FaultPlan` is a pure function of its seed: the same ``(seed,
n_epochs, steps_per_epoch)`` always yields the same schedule of
:class:`FaultEvent`\\ s, so a chaos run is exactly reproducible — including
across a checkpoint resume, where a *fresh* injector built from the same
plan re-arms every event and the replayed epochs re-fire identically.

Five injection sites, one per failure mode the resilience layer defends:

========== ==================== =========================================
site       event coordinates    what fires
========== ==================== =========================================
batch      (epoch, step)        batch tensor filled with NaN/inf → the
                                step's gradients go non-finite (exercises
                                the in-scan guard)
prefetch   (epoch, chunk)       the producer's device-put raises
                                ``InjectedFault`` (mode "crash") or stalls
                                ``arg`` seconds then raises (mode "hang",
                                for the supervisor's watchdog)
replan     (epoch,)             ``MetaBatchStream``'s partitioner raises
                                for that target epoch
checkpoint (epoch,)             the just-saved ``.npz`` is truncated to
                                half its bytes or gets a flipped byte
worker     (epoch, chunk)       an async_ps worker's snapshot age is
                                pushed past ``max_staleness`` (dead /
                                straggler worker)
========== ==================== =========================================

Events are *consumed on fire* under a lock (hooks are called from the
engine thread, the prefetch producer, and replan builders concurrently);
a supervisor retry of the same call therefore succeeds — exactly the
transient-fault shape the defenses target.  :meth:`FaultInjector.report`
returns the plan / fired / pending ledger for the chaos artifact.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np

__all__ = ["SITES", "FaultEvent", "FaultPlan", "FaultInjector",
           "InjectedFault"]

SITES = ("batch", "prefetch", "replan", "checkpoint", "worker")


class InjectedFault(RuntimeError):
    """The exception every injected crash raises — chaos tests assert on
    this type so a real bug can never masquerade as an injection."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``step`` is the epoch-local batch index for
    ``batch`` events, the epoch-local chunk index for ``prefetch`` /
    ``worker`` events, and 0 for per-epoch sites."""

    site: str
    epoch: int
    step: int = 0
    mode: str = ""
    arg: float = 0.0
    worker: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {SITES}")

    def key(self) -> tuple:
        return (self.site, self.epoch, self.step)


_DEFAULT_MODES = {
    "batch": ("nan", "inf"),
    "prefetch": ("crash",),
    "replan": ("fail",),
    "checkpoint": ("truncate", "bitflip"),
    "worker": ("dead",),
}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of events.  Build explicitly from events, or
    derive deterministically with :meth:`from_seed`."""

    events: tuple[FaultEvent, ...]

    @classmethod
    def from_seed(cls, seed: int, *, n_epochs: int, steps_per_epoch: int,
                  sites=SITES, per_site: int = 1) -> "FaultPlan":
        """``per_site`` events per site, coordinates drawn without
        replacement from the run's (epoch, step) grid — a pure function of
        ``seed`` and the shape arguments.

        ``checkpoint`` events use epochs 1..n_epochs (a checkpoint saved
        *after* epoch e is labelled e); everything else uses 0-based
        epochs.  ``batch``/``prefetch``/``worker`` steps are drawn from
        ``steps_per_epoch`` (callers pass the chunk count for the chunk-
        indexed sites).
        """
        if n_epochs < 1 or steps_per_epoch < 1:
            raise ValueError("need n_epochs >= 1 and steps_per_epoch >= 1")
        events: list[FaultEvent] = []
        for site in sites:
            rng = np.random.default_rng([int(seed), SITES.index(site)])
            modes = _DEFAULT_MODES[site]
            per_epoch = steps_per_epoch if site in ("batch", "prefetch",
                                                    "worker") else 1
            grid = n_epochs * per_epoch
            picks = rng.choice(grid, size=min(per_site, grid), replace=False)
            for i, flat in enumerate(sorted(int(p) for p in picks)):
                epoch, step = divmod(flat, per_epoch)
                if site == "checkpoint":
                    epoch += 1          # labelled by completed-epoch count
                events.append(FaultEvent(
                    site=site, epoch=epoch, step=step,
                    mode=modes[i % len(modes)],
                    arg=0.0, worker=int(rng.integers(0, 8))))
        return cls(events=tuple(events))

    def for_site(self, site: str) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.site == site)

    def to_json(self) -> list[dict]:
        return [dataclasses.asdict(e) for e in self.events]


class FaultInjector:
    """Arms a :class:`FaultPlan` and exposes one hook per site.

    Thread-safe: the armed table and the fired ledger are only touched
    under ``_lock`` (engine thread + prefetch producer + replan builder
    all call in)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._armed = {e.key(): e for e in plan.events}
        if len(self._armed) != len(plan.events):
            raise ValueError("fault plan has colliding (site, epoch, step) "
                             "coordinates; events must be unique")
        self._fired: list[dict] = []

    # -------------------------------------------------------------- ledger
    def _take(self, site: str, epoch: int, step: int = 0,
              **detail) -> FaultEvent | None:
        with self._lock:
            ev = self._armed.pop((site, int(epoch), int(step)), None)
            if ev is not None:
                self._fired.append(
                    {**dataclasses.asdict(ev), **detail})
        return ev

    def fired(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._fired]

    def pending(self) -> list[FaultEvent]:
        with self._lock:
            return sorted(self._armed.values(),
                          key=lambda e: (e.epoch, e.step, e.site))

    def report(self) -> dict:
        return {"plan": self.plan.to_json(), "fired": self.fired(),
                "pending": [dataclasses.asdict(e) for e in self.pending()]}

    # --------------------------------------------------------------- hooks
    def take(self, site: str, *, epoch: int, step: int = 0
             ) -> FaultEvent | None:
        """Consume and return the event armed at these coordinates
        (``None`` when nothing is armed) — for callers that need the
        event's payload to apply (and possibly re-apply, e.g. on a guarded
        chunk replay) its effect themselves."""
        return self._take(site, epoch, step)

    def on_batch(self, batch: dict, *, epoch: int, step: int) -> dict:
        """Engine hook: poison this step's batch if an event is armed."""
        ev = self._take("batch", epoch, step)
        if ev is None:
            return batch
        out = dict(batch)
        key = "x" if "x" in out else next(
            (k for k, v in out.items()
             if np.issubdtype(np.asarray(v).dtype, np.floating)), None)
        if key is None:     # nothing poisonable — record and pass through
            return out
        arr = np.array(out[key], copy=True)
        arr[...] = np.nan if ev.mode != "inf" else np.inf
        out[key] = arr
        return out

    def wrap_put(self, put, *, epoch: int):
        """Wrap the prefetch producer's device-put.  The chunk index only
        advances on a *successful* put, so a supervisor retry of a failed
        chunk re-runs at the same coordinate (where the event is already
        consumed) and later events keep their planned positions."""
        state = {"i": 0}

        def injected_put(chunk):
            with self._lock:
                i = state["i"]
            ev = self._take("prefetch", epoch, i)
            if ev is not None:
                if ev.mode == "hang":
                    time.sleep(ev.arg or 1.0)
                raise InjectedFault(
                    f"injected prefetch {ev.mode} (epoch {epoch}, "
                    f"chunk {i})")
            out = put(chunk)
            with self._lock:
                state["i"] = i + 1
            return out

        return injected_put

    def maybe_fail(self, site: str, *, epoch: int, step: int = 0) -> None:
        """Raise :class:`InjectedFault` if an event is armed here (the
        replan hook; usable for any raise-style site)."""
        ev = self._take(site, epoch, step)
        if ev is not None:
            raise InjectedFault(
                f"injected {site} failure (epoch {epoch}, step {step})")

    def after_checkpoint(self, path: str, *, epoch: int) -> None:
        """Corrupt the just-written checkpoint file in place (simulated
        torn write / bit rot).  The checksum sidecar keeps the *good*
        digest, so verification must catch this on load."""
        ev = self._take("checkpoint", epoch, 0, path=os.path.basename(path))
        if ev is None:
            return
        size = os.path.getsize(path)
        if ev.mode == "bitflip":
            with open(path, "r+b") as f:
                f.seek(size // 2)
                byte = f.read(1)
                f.seek(size // 2)
                f.write(bytes([byte[0] ^ 0xFF]))
        else:
            os.truncate(path, size // 2)

    def before_chunk(self, strategy, carry, *, epoch: int, chunk: int):
        """Engine hook, called with the *strategy* carry before each chunk:
        pushes an async_ps worker's age past ``max_staleness`` when a
        ``worker`` event is armed.  Strategies opt in by exposing
        ``bump_age(carry, worker, amount)``; others are left untouched
        (the event stays armed and shows up as pending in the report)."""
        if not hasattr(strategy, "bump_age"):
            return carry
        ev = self._take("worker", epoch, chunk)
        if ev is None:
            return carry
        return strategy.bump_age(carry, ev.worker, ev.arg)
