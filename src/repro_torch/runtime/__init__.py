"""Runtime support: deterministic fault injection, retry and restart
schedules, the training supervisor, straggler detection, rendezvous
routing and elastic meshes (the ported part of ``repro.runtime``;
``reshard_state`` waits with the sharded LM)."""

from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    Preempted,
    RestartPolicy,
    Supervisor,
    SupervisorConfig,
    decorrelated_jitter,
)
from repro_torch.runtime.straggler import StragglerWatchdog  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    best_grid,
    make_elastic_mesh,
    route_key,
)
from repro_torch.runtime.chaos import (  # noqa: F401
    ChaosConfig,
    ChaosError,
    ChaosFailure,
    ChaosMonkey,
)
