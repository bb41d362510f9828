"""Fault injection and recovery for the port's training stack.

``faults``     — a copy of the reference's seeded, deterministic
                 :class:`FaultPlan`/:class:`FaultInjector` (poisoned batch,
                 prefetch crash/hang, replan failure, corrupt checkpoint,
                 over-stale async worker; the last acts only under
                 ``async_ps`` and stays pending under the other
                 strategies).
``guard``      — the non-finite guard primitives the engine uses to skip
                 poisoned updates (and halt after K consecutive skips).
``supervisor`` — a copy of the reference's bounded-retry/backoff/
                 hang-timeout wrapper for host-side background work
                 (batch staging, replan builder).

``chaos``      — the end-to-end chaos driver: one seeded ``async_ps`` run
                 with a fault at every site, in three phases
                 (``python -m repro_torch.resilience.chaos``).
"""
from repro_torch.resilience.faults import (FaultEvent, FaultInjector,
                                           FaultPlan, InjectedFault, SITES)
from repro_torch.resilience.guard import (NonFiniteHaltError, all_finite,
                                          guard_init)
from repro_torch.resilience.supervisor import (RetryPolicy, Supervisor,
                                               SupervisorTimeout)

__all__ = [
    "SITES",
    "FaultEvent",
    "FaultPlan",
    "FaultInjector",
    "InjectedFault",
    "NonFiniteHaltError",
    "all_finite",
    "guard_init",
    "RetryPolicy",
    "Supervisor",
    "SupervisorTimeout",
    "chaos_config",
    "chaos_plan",
    "run_chaos",
]


def __getattr__(name: str):
    # The chaos driver loads on first use, so ``python -m
    # repro_torch.resilience.chaos`` does not find it imported already.
    if name in ("chaos_config", "chaos_plan", "run_chaos"):
        from repro_torch.resilience import chaos
        return getattr(chaos, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
