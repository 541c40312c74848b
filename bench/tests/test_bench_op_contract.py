"""The op contract of ``bench/run.py`` on the CPU: what an op written as a
new file under ``bench/ops/`` may bring (its plan, inputs drawn from the
seed beyond the pool, a reference for each call, its programs and stage
split), and that the ``solve`` and ``topk`` ops, which bring none of it,
keep the default path.

Each test op and cell is a new file in a copy of the small checkout."""

import json
import shutil

import pytest
import torch

from conftest import SMALL_TOPK_CONFIG

from bench import ensembles, run, trace
from repro_torch.engine.engine import SolveResult, TopkResult

#: A stream of rank-1 updates: each call adds the next seeded term
#: ``rho u u^T`` to its stack's running matrix and answers ``engine.topk``
#: of the sum.  With ``STALE`` it answers the previous call's result, the
#: fault that a reference keyed by pool stack alone would not see.
STREAM_OP = '''"""A stream of rank-1 updates (a test op)."""

import torch

from bench import reference as plain

CHECKS = ("eig_err", "vec_err")
STALE = {stale}


def plan_k(traffic):
    return int(traffic["k"])


def program_spec(traffic):
    from repro_torch.engine.engine import ProgramSpec

    return ProgramSpec("topk", int(traffic["k"]), bool(traffic["largest"]))


def flops_per_matrix(config, traffic, levels):
    return 1.0


def draw(config, traffic, gen, device):
    shape = (int(traffic["updates"]), int(traffic["b"]), int(config["n"]))
    u = torch.randn(shape, generator=gen, dtype=torch.float64, device=device)
    u /= torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    rho = torch.rand(shape[:2], generator=gen, dtype=torch.float64,
                     device=device) - 0.5
    return {{"u": u, "rho": rho, "running": {{}}, "last": {{}}}}


def _term(inputs, ordinal):
    i = ordinal % len(inputs["u"])
    u, rho = inputs["u"][i], inputs["rho"][i]
    return rho[:, None, None] * u[:, :, None] * u[:, None, :]


def _advance(stack, inputs):
    t, a = inputs["running"].get(id(stack), (0, stack))
    a = a + _term(inputs, t)
    inputs["running"][id(stack)] = (t + 1, a)
    return a


def _answer(stack, inputs, out):
    if STALE:
        out, inputs["last"][id(stack)] = (
            inputs["last"].get(id(stack), out), out)
    return out


def call(engine, stack, traffic, inputs):
    a = _advance(stack, inputs)
    return _answer(stack, inputs, engine.topk(a, int(traffic["k"]),
                                              bool(traffic["largest"])))


def split(engine, stack, inputs, traffic, walk):
    from repro_torch.engine.engine import program

    a = _advance(stack, inputs)
    out = walk(program(engine.plan, program_spec(traffic)), a)
    return _answer(stack, inputs, out)


def reference_key(idx, ordinal, inputs):
    return (idx, ordinal)


def reference_for(idx, ordinal, pool, inputs, traffic):
    a = pool[idx]
    for s in range(ordinal + 1):
        a = a + _term(inputs, s)
    return plain.topk(a, int(traffic["k"]), bool(traffic["largest"]))


def compare(result, ref):
    return {{"eig_err": plain.eig_err(result.eigenvalues, ref),
            "vec_err": plain.vec_err(result.vectors, ref)}}
'''

#: The ``topk`` op with a plan of its own: the dense ``eigh`` chain.
EIGH_PLAN = '''

def plan(shape, config, traffic):
    from repro_torch import SolverPlan

    return SolverPlan(method="eigh", precision=config["precision"])
'''

#: Two programs a call: the top-k window of the stack seeds the rank-1
#: ``update`` program (``initial_state(a_prev, basis, theta, u, rho)``),
#: whose updated matrix the top-k program solves again; on the ``eigh``
#: plan, which keeps the test short.
RESOLVE_OP = '''"""A rank-1 update and a re-solve a call (a test op)."""

import torch

from bench import reference as plain

CHECKS = ("eig_err", "vec_err")


def plan(shape, config, traffic):
    from repro_torch import SolverPlan

    return SolverPlan(method="eigh", precision=config["precision"])


def flops_per_matrix(config, traffic, levels):
    return 1.0


def draw(config, traffic, gen, device):
    b, n = int(traffic["b"]), int(config["n"])
    u = torch.randn((b, n), generator=gen, dtype=torch.float64,
                    device=device)
    u /= torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    rho = torch.rand(b, generator=gen, dtype=torch.float64,
                     device=device) + 0.5
    return {"u": u, "rho": rho}


def programs(engine, plan, traffic):
    from repro_torch.engine.engine import topk_program, update_program

    k, largest = int(traffic["k"]), bool(traffic["largest"])
    return [topk_program(plan, k, largest),
            update_program(plan, k, largest, k, int(traffic["ext"]))]


def _run(engine, stack, inputs, traffic, run):
    solve, update = programs(engine, engine.plan, traffic)
    window = run(solve, stack)
    _, _, a, _, _ = run(update, stack, window.vectors, window.eigenvalues,
                        inputs["u"], inputs["rho"])
    return run(solve, a)


def call(engine, stack, traffic, inputs):
    return _run(engine, stack, inputs, traffic, lambda prog, *a: prog(*a))


def split(engine, stack, inputs, traffic, walk):
    return _run(engine, stack, inputs, traffic, walk)


def reference_for(idx, ordinal, pool, inputs, traffic):
    u, rho = inputs["u"], inputs["rho"]
    a = pool[idx] + rho[:, None, None] * u[:, :, None] * u[:, None, :]
    return plain.topk(a, int(traffic["k"]), bool(traffic["largest"]))


def compare(result, ref):
    return {"eig_err": plain.eig_err(result.eigenvalues, ref),
            "vec_err": plain.vec_err(result.vectors, ref)}
'''

_TOPK = {"config": SMALL_TOPK_CONFIG["name"], "k": 4, "largest": True,
         "m": 128, "b": 2, "loop": "closed",
         "limits": {"eig_err": 1e-9, "vec_err": 1e-4}}
CELLS = {
    "stream4.small": dict(_TOPK, traffic="stream4.b2", op="stream",
                          pool=2, updates=3, trace_calls=1, split_calls=1),
    "stream4_stale.small": dict(_TOPK, traffic="stream4_stale.b2",
                                op="stream_stale", pool=2, updates=3,
                                trace_calls=1, split_calls=1),
    "topk4_eigh.small": dict(_TOPK, traffic="topk4_eigh.b2", op="topk_eigh",
                             pool=2, trace_calls=1, split_calls=1),
    "resolve4.small": dict(_TOPK, traffic="resolve4.b2", op="resolve",
                           pool=1, ext=4, trace_calls=1, split_calls=1),
}


@pytest.fixture(scope="module")
def contract_root(small_root, tmp_path_factory):
    """The small checkout with the test ops and their cells added as new
    files and entries."""
    root = tmp_path_factory.mktemp("contract")
    shutil.copytree(small_root / "bench", root / "bench")
    ops = root / "bench" / "ops"
    (ops / "stream.py").write_text(STREAM_OP.format(stale=False))
    (ops / "stream_stale.py").write_text(STREAM_OP.format(stale=True))
    (ops / "topk_eigh.py").write_text((ops / "topk.py").read_text()
                                      + EIGH_PLAN)
    (ops / "resolve.py").write_text(RESOLVE_OP)
    manifest = json.loads((small_root / "BENCHMARK.json").read_text())
    for name, traffic in CELLS.items():
        (root / "bench" / "workloads" / f"{name}.json").write_text(
            json.dumps(traffic))
        manifest["workloads"].append({
            "name": name, "config": traffic["config"],
            "traffic": traffic["traffic"], "chips": 1, "why": "small"})
        for metric in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in metric:
                metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def _run(root, name, trace_on, seed=2**31 + 7):
    return run.run_cell(run.load_cell(root, name), seed, 0.01, trace_on,
                        "cpu", 0.0)


@pytest.mark.parametrize("trace_on", [False, True])
def test_a_stream_op_reads_correct_against_a_reference_a_call(
        contract_root, trace_on):
    out = _run(contract_root, "stream4.small", trace_on)
    result = out["result"]
    assert result["correct"] is True and result["failed"] == 0
    assert out["info"]["calls"] >= (2 if trace_on else 1)
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(result, allow_nan=False)


def test_the_op_draws_after_the_pool_from_the_same_generator(contract_root):
    cell = run.load_cell(contract_root, "stream4.small")
    op = run.load_op(cell)
    seed = 2**33 + 5
    pool, inputs, drawn = run._draw(op, cell["config"], cell["traffic"],
                                    seed, "cpu")
    alone = ensembles.draw(cell["config"], cell["traffic"], seed, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(pool, alone))
    again = run._draw(op, cell["config"], cell["traffic"], seed, "cpu")[1]
    assert torch.equal(inputs["u"], again["u"])
    assert inputs["u"].shape == (3, 2, SMALL_TOPK_CONFIG["n"])
    # The reference's copy is equal and apart.
    assert torch.equal(drawn["u"], inputs["u"])
    assert drawn["u"].data_ptr() != inputs["u"].data_ptr()
    topk = run.load_op(run.load_cell(contract_root, "topk4.small"))
    assert run._draw(topk, cell["config"], cell["traffic"], seed,
                     "cpu")[1:] == (None, None)


def test_a_reference_cannot_see_what_the_calls_wrote(contract_root,
                                                     monkeypatch):
    """The stream keeps its running matrices and last answers in its
    inputs; the reference is handed the copy drawn before the first call,
    so state that the timed path wrote never reaches it."""
    seen = []
    load_op = run.load_op

    def load(cell):
        op = load_op(cell)
        call, reference_for = op.call, op.reference_for

        def spied_call(engine, stack, traffic, inputs):
            out = call(engine, stack, traffic, inputs)
            inputs["u"].add_(1.0)  # a call that spoils what it was handed
            return out

        def spied_reference_for(idx, ordinal, pool, inputs, traffic):
            seen.append((dict(inputs["running"]), dict(inputs["last"]),
                         float(inputs["u"].abs().amax())))
            return reference_for(idx, ordinal, pool, inputs, traffic)

        op.call, op.reference_for = spied_call, spied_reference_for
        return op

    monkeypatch.setattr(run, "load_op", load)
    result = _run(contract_root, "stream4.small", False)["result"]
    assert seen and all(running == {} and last == {} and top <= 1.0
                        for running, last, top in seen)
    # The calls advanced their own state, and spoiled their own u: judged
    # against references of the unspoiled terms, the answers read wrong.
    assert result["correct"] is False and result["failed"] > 0


def test_a_stale_answer_of_a_stream_reads_not_correct(contract_root):
    result = _run(contract_root, "stream4_stale.small", False)["result"]
    assert result["correct"] is False and result["failed"] > 0
    assert result["checks"]["eig_err"]["value"] > 1e-9


def test_an_op_brings_its_own_plan(contract_root):
    out = _run(contract_root, "topk4_eigh.small", False)
    assert out["info"]["plan"] == {"method": "eigh", "spectrum": "full",
                                   "backend": "cuda", "precision": "float64"}
    assert out["result"]["correct"] is True


def test_a_traced_op_with_two_programs_splits_both(contract_root,
                                                   monkeypatch):
    walked = []
    split = trace.split

    def spy(prog, args, device, stage_ms):
        walked.append((type(prog).__name__, len(args)))
        return split(prog, args, device, stage_ms)

    monkeypatch.setattr(trace, "split", spy)
    out = _run(contract_root, "resolve4.small", True)
    assert out["result"]["correct"] is True
    assert walked == [("Program", 1), ("UpdateProgram", 5), ("Program", 1)]
    keys = set(out["info"]["stage_ms"])
    assert {"spectrum/eigh", "recover/eigh_topk", "reduce/warm_project",
            "spectrum/tridiag_bracketed", "recover/update_select"} <= keys
    assert "recover_ms" in out["result"]["metrics"]


def test_a_call_left_out_of_the_comparison_is_not_judged():
    class Op:
        CHECKS = ("eig_err",)

        @staticmethod
        def reference_key(idx, ordinal, inputs):
            return None if ordinal in inputs else (idx, ordinal)

        @staticmethod
        def reference_for(idx, ordinal, pool, inputs, traffic):
            return {"ordinal": ordinal}

        @staticmethod
        def compare(result, ref):
            return {"eig_err": torch.tensor([abs(result - ref["ordinal"])],
                                            dtype=torch.float64)}

    traffic = {"limits": {"eig_err": 0.5}}
    pool = [None, None]
    # Ordinals 1, 1, 2, 2, 3 on stacks 0, 1, 0, 1, 0; the call of
    # ordinal 2 on stack 1 answers wrongly.  Left out of the comparison it
    # fails nothing; with every call left out nothing is compared.
    kept = [(0, 1), (1, 1), (0, 2), (1, 9), (0, 3)]
    checks, failed, compared = run._judge(Op, pool, kept, traffic, 1, "cpu",
                                          inputs={})
    assert (failed, compared) == (1, 5)
    assert checks["eig_err"]["value"] == 7
    assert run._judge(Op, pool, kept, traffic, 1, "cpu",
                      inputs={2}) == ({"eig_err": {"value": 0.0,
                                                   "limit": 0.5}}, 0, 3)
    assert run._judge(Op, pool, kept, traffic, 1, "cpu",
                      inputs={1, 2, 3})[2] == 0


def _counting(monkeypatch):
    """Count ``op.reference`` a pool stack, on the op each run loads."""
    counts = {}
    load_op = run.load_op

    def load(cell):
        op = load_op(cell)
        reference = op.reference

        def counted(stack, traffic):
            counts[id(stack)] = counts.get(id(stack), 0) + 1
            return reference(stack, traffic)

        op.reference = counted
        return op

    monkeypatch.setattr(run, "load_op", load)
    return counts


@pytest.mark.parametrize("name", ["solve.small", "topk4.small"])
def test_the_default_reference_is_made_once_a_pool_stack(
        small_root, monkeypatch, name):
    counts = _counting(monkeypatch)
    cell = run.load_cell(small_root, name)
    out = run.run_cell(cell, 2**31 + 99, 0.01, False, "cpu", 0.0)
    result = out["result"]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True
    assert set(counts.values()) == {1}
    assert len(counts) == min(out["info"]["calls"], cell["traffic"]["pool"])

    # Five kept calls over the two stacks of a pool: two references.
    counts.clear()
    op = run.load_op(cell)
    traffic = cell["traffic"]
    pool = ensembles.draw(cell["config"], traffic, 3, "cpu")
    refs = [op.reference(stack, traffic) for stack in pool]
    counts.clear()
    if name.startswith("solve"):
        outs = [SolveResult(r["lam"], r["mags"]) for r in refs]
    else:
        outs = [TopkResult(r["lam"], r["vecs"]) for r in refs]
    kept = [(i % 2, outs[i % 2]) for i in range(5)]
    checks, failed, compared = run._judge(op, pool, kept, traffic,
                                          int(traffic["b"]), "cpu")
    assert (failed, compared) == (0, 5)
    assert sorted(counts.values()) == [1, 1]
    assert all(c["value"] == 0.0 for c in checks.values())
