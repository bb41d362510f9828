"""Fault injection and recovery for the port's training stack.

``faults``     — a copy of the reference's seeded, deterministic
                 :class:`FaultPlan`/:class:`FaultInjector` (poisoned batch,
                 prefetch crash/hang, replan failure, corrupt checkpoint,
                 over-stale async worker; the last stays pending under the
                 sequential strategy, the only one the port has).
``guard``      — the non-finite guard primitives the engine uses to skip
                 poisoned updates (and halt after K consecutive skips).
``supervisor`` — a copy of the reference's bounded-retry/backoff/
                 hang-timeout wrapper for host-side background work
                 (batch staging, replan builder).

The reference's chaos harness (``repro.resilience.chaos``) runs
``async_ps`` and belongs to the execution-strategies slice.
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
]
