"""repro_torch.runtime — fault tolerance: preemption, stragglers, restarts."""

from repro_torch.runtime.fault_tolerance import (
    PreemptionHandler,
    StragglerMonitor,
    run_with_restarts,
)

__all__ = ["PreemptionHandler", "StragglerMonitor", "run_with_restarts"]
