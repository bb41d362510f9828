"""Thread supervision for host-side background work (the replan builder).

``supervisor`` is a copy of the reference's module (bounded retries,
deterministic backoff, hang timeouts).  The fault injector and the
non-finite guard belong to the engine-extras slice.
"""
from repro_torch.resilience.supervisor import (RetryPolicy, Supervisor,
                                               SupervisorTimeout)

__all__ = ["RetryPolicy", "Supervisor", "SupervisorTimeout"]
