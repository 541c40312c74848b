"""Serving-runtime support: deterministic fault injection, retry and
restart schedules, straggler detection and rendezvous routing (the ported
part of ``repro.runtime``; its training supervisor and mesh helpers are
not ported)."""

from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    RestartPolicy,
    decorrelated_jitter,
)
from repro_torch.runtime.straggler import StragglerWatchdog  # noqa: F401
from repro_torch.runtime.elastic import route_key  # noqa: F401
from repro_torch.runtime.chaos import (  # noqa: F401
    ChaosConfig,
    ChaosError,
    ChaosFailure,
    ChaosMonkey,
)
