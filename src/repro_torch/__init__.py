"""PyTorch and CUDA port of the EEI system, for one NVIDIA H100.

The JAX package ``repro`` is the reference and stays beside it; this
package imports ``torch`` and numpy, never ``jax`` or ``repro``.  Its
layout mirrors ``repro``'s: ``linalg`` and ``core`` hold plain PyTorch,
``kernels`` the hand-written CUDA kernels beside their plain versions, and
``engine`` the ``SolverEngine``, its serving runtime and the ``sharded``
backend on a device mesh (``launch.mesh``, ``core.distributed``);
``models`` the language model, and ``optim``, ``train``, ``checkpoint`` and
``data`` its trainer, whose ``EigenPre`` runs the engine in the loop.
"""

from repro_torch.engine import (  # noqa: F401
    EeiServer,
    Mesh,
    PackedTopkResult,
    Rank1Update,
    SessionConfig,
    SessionVerifyError,
    SolveResult,
    SolverEngine,
    SolverPlan,
    SpectralSession,
    TopkResult,
    VerifyFlags,
    make_local_mesh,
    packed_plan_for,
    packed_topk_program,
    plan_for,
    verify_topk,
    verify_topk_host,
    verify_topk_packed,
)
