"""``topk``: the ``k`` extremal eigenpairs of each matrix, signed vectors.

The call is the public one, ``SolverEngine(plan).topk(stack, k)``; the
comparison covers the window's eigenvalues and its signed unit vectors.
"""

from bench import flops
from bench import reference as plain

CHECKS = ("eig_err", "vec_err")


def plan_k(traffic: dict):
    return int(traffic["k"])


def program_spec(traffic: dict):
    from repro_torch.engine.engine import ProgramSpec

    return ProgramSpec("topk", int(traffic["k"]), bool(traffic["largest"]))


def call(engine, stack, traffic: dict):
    return engine.topk(stack, int(traffic["k"]), bool(traffic["largest"]))


def flops_per_matrix(config: dict, traffic: dict, levels: int) -> float:
    return flops.topk(int(config["n"]), int(traffic["k"]), int(traffic["m"]),
                      levels)


def reference(stack, traffic: dict) -> dict:
    return plain.topk(stack, int(traffic["k"]), bool(traffic["largest"]))


def compare(result, ref: dict) -> dict:
    return {"eig_err": plain.eig_err(result.eigenvalues, ref),
            "vec_err": plain.vec_err(result.vectors, ref)}
