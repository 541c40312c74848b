"""The EEI SolverEngine of the port: plan -> backend registry -> engine.

    from repro_torch.engine import SolverEngine, plan_for

    plan = plan_for(stack.shape, k=8)               # or SolverPlan(...)
    engine = SolverEngine(plan)                     # device="cuda" by default
    lam, mags = engine.solve(stack)                 # (b, n), (b, n, n)
    top = engine.topk(stack, k=8)                   # (b, k), (b, k, n)

    packed = packed_topk_program(packed_plan_for(512), k=8, largest=True,
                                 verify=True)
    res, flags = packed(rows, seg_off, seg_len)     # (b, S, k), (b, S)

    session = engine.open_session(a, k=8)           # one (n, n) matrix
    top = engine.update(session, Rank1Update(u, 1)) # A <- A + u u^T

    with EeiServer(max_batch=8) as server:          # serving: device="cuda"
        fut = server.submit(a, k=8)                 # one (n, n) request
    top = fut.result()                              # numpy (k,), (k, n)

    with EeiFleet(3) as fleet:                      # replicas of the server
        fut = fleet.submit(a, k=8)                  # routed, failed over

    mesh = make_local_mesh(2, 1)                    # two cards' data axis
    plan = plan_for(stack.shape, k=8, mesh=mesh)    # backend "sharded"
    EeiServer(mesh=mesh)                            # buckets round up to 2
"""

from repro_torch.engine.autotune import (  # noqa: F401
    CalibrationTable,
    calibrate,
    get_table,
    load_table,
    set_table,
)
from repro_torch.launch.mesh import Mesh, make_local_mesh  # noqa: F401
from repro_torch.engine.plan import (  # noqa: F401
    BackendName,
    Method,
    SolverPlan,
    Spectrum,
    fallback_chain,
    packed_plan_for,
    plan_for,
    resolved_crossovers,
    resolved_krylov_n_min,
    resolved_windowed_k_frac,
)
from repro_torch.engine.registry import (  # noqa: F401
    Composition,
    StageLibrary,
    StageSig,
    available_backends,
    available_compositions,
    composition_for,
    get_backend,
    get_composition,
    register_backend,
    register_composition,
)
from repro_torch.engine.engine import (  # noqa: F401
    PackedTopkResult,
    ProgramSpec,
    SolveResult,
    SolverEngine,
    TopkResult,
    packed_topk_program,
    topk_program,
    update_program,
)
from repro_torch.engine.session import (  # noqa: F401
    Rank1Update,
    SessionConfig,
    SessionVerifyError,
    SpectralSession,
)
from repro_torch.engine.verify import (  # noqa: F401
    VerifyFlags,
    verify_topk,
    verify_topk_host,
    verify_topk_packed,
)
from repro_torch.engine.server import (  # noqa: F401
    DegradedResult,
    DispatchRecord,
    EeiServer,
    ProgramCache,
    QueueFull,
    ServerClosed,
    ShapeBucket,
    VerifyFailed,
)
from repro_torch.engine.fleet import (  # noqa: F401
    EeiFleet,
    FleetClosed,
    InProcessReplica,
    ReplicaDied,
    SubprocessReplica,
)
