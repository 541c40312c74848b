"""The EEI SolverEngine of the port: plan -> backend registry -> engine.

    from repro_torch.engine import SolverEngine, plan_for

    plan = plan_for(stack.shape, k=8)               # or SolverPlan(...)
    engine = SolverEngine(plan)                     # device="cuda" by default
    lam, mags = engine.solve(stack)                 # (b, n), (b, n, n)
    top = engine.topk(stack, k=8)                   # (b, k), (b, k, n)
"""

from repro_torch.engine.plan import (  # noqa: F401
    BackendName,
    Method,
    SolverPlan,
    Spectrum,
    plan_for,
)
from repro_torch.engine.registry import (  # noqa: F401
    Composition,
    StageLibrary,
    StageSig,
    available_backends,
    available_compositions,
    composition_for,
    get_backend,
    register_backend,
    register_composition,
)
from repro_torch.engine.engine import (  # noqa: F401
    ProgramSpec,
    SolveResult,
    SolverEngine,
    TopkResult,
)
