"""``solve``: the eigenvalues and every ``|v[i, j]|^2`` of each matrix.

The call is the public one, ``SolverEngine(plan).solve(stack)``; the
comparison covers the eigenvalues and the whole magnitude table.
"""

from bench import flops
from bench import reference as plain

CHECKS = ("eig_err", "mag_err")


def plan_k(traffic: dict):
    """The ``k`` the planner is asked about: none, the whole table."""
    return None


def program_spec(traffic: dict):
    from repro_torch.engine.engine import ProgramSpec

    return ProgramSpec("solve")


def call(engine, stack, traffic: dict):
    return engine.solve(stack)


def flops_per_matrix(config: dict, traffic: dict, levels: int) -> float:
    return flops.solve(int(config["n"]), levels)


def reference(stack, traffic: dict) -> dict:
    return plain.solve(stack)


def compare(result, ref: dict) -> dict:
    return {"eig_err": plain.eig_err(result.eigenvalues, ref),
            "mag_err": plain.mag_err(result.magnitudes, ref)}
