"""Thread supervision: bounded retries, deterministic backoff, hang timeouts.

The training stack runs three kinds of host-side background work — the
engine's prefetch producer, the ``MetaBatchStream`` replan builder, and
checkpoint I/O — and before this module a single exception or hang in any
of them either killed the run or stalled it forever.  :class:`Supervisor`
wraps such calls with a retry policy:

  * **bounded retries** — up to ``max_retries`` re-attempts of the failed
    call; the last exception is re-raised when they exhaust, so callers
    keep their existing degrade path (the stream keeps the old plan, the
    engine surfaces the prefetch error);
  * **exponential backoff with deterministic jitter** — the delay before
    attempt ``a`` is ``min(backoff_max, backoff_base·2^a)`` scaled by a
    jitter factor that is a pure function of ``(seed, key, a)``, so two
    runs with the same seed sleep the same schedule (bit-reproducible
    chaos tests included);
  * **hang timeout** — with ``hang_timeout`` set, each attempt runs on a
    disposable daemon worker thread and :class:`SupervisorTimeout` fires
    if it does not finish in time (the hung attempt is abandoned; the
    retry runs clean).

Every attempt outcome is recorded (under a lock — the supervisor is shared
across producer/builder threads) and exposed via :meth:`Supervisor.events`
for the chaos report.
"""
from __future__ import annotations

import queue
import threading
import time
import zlib
from dataclasses import dataclass

import numpy as np

__all__ = ["RetryPolicy", "Supervisor", "SupervisorTimeout"]


class SupervisorTimeout(RuntimeError):
    """An attempt exceeded the policy's ``hang_timeout`` and was abandoned."""


@dataclass(frozen=True)
class RetryPolicy:
    """How a supervised call is retried.  ``max_retries=0`` means one
    attempt, no retry; ``hang_timeout=None`` disables the watchdog (the
    call runs inline on the calling thread — the fast path)."""

    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    jitter: float = 0.5          # delay is scaled by 1 + jitter·u, u ∈ [0,1)
    hang_timeout: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base < 0 or self.backoff_max < self.backoff_base:
            raise ValueError(
                f"need 0 <= backoff_base <= backoff_max, got "
                f"({self.backoff_base}, {self.backoff_max})")
        if not 0 <= self.jitter:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")
        if self.hang_timeout is not None and self.hang_timeout <= 0:
            raise ValueError(
                f"hang_timeout must be positive or None, "
                f"got {self.hang_timeout}")

    def delay(self, key: str, attempt: int) -> float:
        """Backoff before re-attempt ``attempt`` (0-based) of call ``key``
        — a pure function of ``(seed, key, attempt)``."""
        base = min(self.backoff_max, self.backoff_base * (2.0 ** attempt))
        u = np.random.default_rng(
            [self.seed, zlib.crc32(key.encode()), attempt]).random()
        return float(base * (1.0 + self.jitter * u))


class Supervisor:
    """Applies a :class:`RetryPolicy` to host-side calls.

    One supervisor may be shared by several threads (the engine hands the
    same instance to every epoch's prefetch producer); the attempt log is
    lock-published.
    """

    def __init__(self, policy: RetryPolicy | None = None, *,
                 name: str = "supervisor", sleep=time.sleep):
        self.policy = policy or RetryPolicy()
        self.name = name
        self._sleep = sleep
        self._lock = threading.Lock()
        self._events: list[dict] = []

    @classmethod
    def from_config(cls, resilience, *, name: str = "supervisor",
                    sleep=time.sleep) -> "Supervisor":
        """Build from any object with ResilienceConfig-shaped attributes."""
        return cls(RetryPolicy(
            max_retries=int(getattr(resilience, "max_retries", 3)),
            backoff_base=float(getattr(resilience, "backoff_base", 0.05)),
            backoff_max=float(getattr(resilience, "backoff_max", 2.0)),
            hang_timeout=getattr(resilience, "hang_timeout", None),
            seed=int(getattr(resilience, "seed", 0))),
            name=name, sleep=sleep)

    # ------------------------------------------------------------- attempts
    def _attempt(self, fn, args, kwargs):
        timeout = self.policy.hang_timeout
        if timeout is None:
            return fn(*args, **kwargs)
        out: queue.Queue = queue.Queue(maxsize=1)

        def work():
            try:
                out.put(("ok", fn(*args, **kwargs)))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                out.put(("err", e))

        t = threading.Thread(target=work, daemon=True,
                             name=f"{self.name}-attempt")
        t.start()
        try:
            kind, value = out.get(timeout=timeout)
        except queue.Empty:
            raise SupervisorTimeout(
                f"{self.name}: call exceeded hang_timeout={timeout}s; "
                "abandoning the attempt") from None
        if kind == "err":
            raise value
        return value

    def _record(self, key: str, attempt: int, status: str,
                error: BaseException | None = None,
                delay: float | None = None) -> None:
        row = {"key": key, "attempt": attempt, "status": status}
        if error is not None:
            row["error"] = f"{type(error).__name__}: {error}"
        if delay is not None:
            row["delay"] = delay
        with self._lock:
            self._events.append(row)

    def events(self) -> list[dict]:
        """Snapshot of the attempt log (chaos report material)."""
        with self._lock:
            return [dict(e) for e in self._events]

    # ----------------------------------------------------------------- call
    def call(self, fn, *args, key: str = "", retryable=(Exception,), **kw):
        """Run ``fn(*args, **kw)`` under the policy.

        Exceptions matching ``retryable`` (and timeouts) trigger backoff +
        retry; when retries exhaust, the last exception is re-raised so the
        caller's own degrade path takes over.  Non-retryable exceptions
        (``KeyboardInterrupt`` et al.) propagate immediately.
        """
        key = key or getattr(fn, "__name__", "call")
        retryable = tuple(retryable) + (SupervisorTimeout,)
        last: BaseException | None = None
        for attempt in range(self.policy.max_retries + 1):
            try:
                result = self._attempt(fn, args, kw)
            except retryable as e:
                last = e
                if attempt == self.policy.max_retries:
                    self._record(key, attempt, "exhausted", error=e)
                    raise
                delay = self.policy.delay(key, attempt)
                self._record(key, attempt, "retrying", error=e, delay=delay)
                if delay > 0:
                    self._sleep(delay)
            else:
                if attempt or last is not None:
                    self._record(key, attempt, "recovered")
                return result
        raise AssertionError("unreachable")  # pragma: no cover
