"""``update``: a streaming rank-1 session, one update a call.

Each pool matrix ``A_0`` (a stack of one) seeds a ``SpectralSession``
through the public path, ``SolverEngine(plan).open_session(A_0, k,
largest)`` under the session's documented defaults (``SessionConfig()``,
which the configuration's ``session`` states), and a call is one
``engine.update(session, Rank1Update(x, sign))`` of the next step of that
session's stream.  The pool's sessions are updated in turn.

The stream (``bench/stream.py``) slides a window of ``window`` samples
over a bank of ``bank`` samples a session (cycled), each ``x = A_0 g /
||A_0 g|| * sqrt(rho)`` with ``rho = rho_per_fro * ||A_0||_F``: the first
``window`` steps bring samples in, then the oldest leaves and the next
enters, in turn.

Set-up's warm call on a stack opens its session (a full solve, which builds
the re-solve's top-k program), makes its bank and applies step 0 (which
builds the update program).  ``draw`` draws the bank's ``g`` and the
compared calls: the first kept call on each session and one call at a
seeded place in each block of ``compare_one_in``.  A compared call returns
the refreshed window and the session's matrix; any other call returns None,
so the run holds no state of the calls it does not judge.

Called with no drawn inputs (``bench/readings.py`` draws none), a call is a
stream of one step: a session opened on the stack and updated once with a
sample made from ``A_0`` itself, which ``reference`` rebuilds.

The reference rebuilds the matrix at a compared call as ``A_0 + sum over
the window of x x^T`` in float64 and takes its top-k from float64 ``eigh``
(``bench/reference.py``): ``eig_err`` and ``vec_err`` judge the window,
``mat_err`` the session's matrix (``||A - A_ref||_F / ||A_ref||_F``).
"""

import dataclasses
import functools
import math

import torch

from bench import flops
from bench import reference as plain
from bench.stream import matrix_after, samples, step

CHECKS = ("eig_err", "vec_err", "mat_err")
#: Blocks of ``compare_one_in`` calls whose compared place ``draw`` draws,
#: cycled after (2**12 blocks of 32 is 131,072 calls a session).
COMPARE_BLOCKS = 2 ** 12


def _geometry(k: int) -> tuple:
    """``(m_keep, n_aug)`` of a session of window ``k`` under
    ``SessionConfig()``, at an ``n`` above ``m_keep + n_aug`` (``draw``
    holds a cell to that)."""
    from repro_torch import SessionConfig

    cfg = SessionConfig()
    return k + cfg.buffer, 1 + cfg.ext


def plan_k(traffic: dict) -> int:
    """The ``k`` the planner is asked about: the session's ``m_keep``, what
    its re-solve asks the engine for."""
    return _geometry(int(traffic["k"]))[0]


def programs(engine, plan, traffic: dict):
    """The update program and the re-solve's top-k program."""
    from repro_torch.engine.engine import topk_program, update_program

    k, largest = int(traffic["k"]), bool(traffic["largest"])
    m_keep, n_aug = _geometry(k)
    return [update_program(plan, k, largest, m_keep, n_aug),
            topk_program(plan, m_keep, largest)]


def flops_per_matrix(config: dict, traffic: dict, levels: int) -> float:
    """One update: the rank-1 add (2 n^2), the frame's Krylov matvecs
    (2 n^2 each, one a direction of ``n_aug``), ``S A'`` over the frame's
    ``m_keep + n_aug`` rows (2 n^2 a row) and ``S A' S^T``, the verify's
    ``A V`` (2 n^2 k) and the window's bisection on the frame's band; plus
    the share of a re-solve (``flops.topk`` at ``m_keep`` through the
    traffic's frozen ``m``) that the drift bound forces once every
    ``ceil(drift_bound / rho_per_fro)`` updates."""
    n, k = int(config["n"]), int(traffic["k"])
    m_keep, n_aug = _geometry(k)
    rows = m_keep + n_aug
    fast = (2 * n * n * (1 + n_aug + rows + k) + 2 * n * rows * rows
            + flops.sturm_ops(1, rows, m_keep, levels))
    every = math.ceil(float(config["session"]["drift_bound"])
                      / float(traffic["rho_per_fro"]))
    return fast + flops.topk(n, m_keep, int(traffic["m"]), levels) / every


def _compared(inputs: dict, slot: int, ordinal: int) -> bool:
    """Whether the call of this ordinal on session ``slot`` is judged: the
    first kept call, and the drawn place of each block."""
    offsets = inputs["offsets"][slot]
    block, place = divmod(ordinal, inputs["every"])
    return ordinal == 1 or place == offsets[block % len(offsets)]


def draw(config: dict, traffic: dict, gen, device) -> dict:
    """The bank's normal draws ``g (pool, bank, n)`` and each session's
    compared places; the calls keep their sessions under ``streams``."""
    from repro_torch import SessionConfig

    if config["session"] != dataclasses.asdict(SessionConfig()):
        raise ValueError(f"the configuration states the session "
                         f"{config['session']}, the port's defaults are "
                         f"{dataclasses.asdict(SessionConfig())}")
    pool, n = int(traffic["pool"]), int(config["n"])
    if int(traffic["b"]) != 1:
        raise ValueError("an update cell runs one session a pool matrix")
    if n < sum(_geometry(int(traffic["k"]))):
        raise ValueError(f"n = {n} leaves no room for the session's frame")
    g = torch.randn((pool, int(traffic["bank"]), n), generator=gen,
                    dtype=torch.float64, device=device)
    every = int(traffic["compare_one_in"])
    offsets = torch.randint(every, (pool, COMPARE_BLOCKS), generator=gen,
                            device=device)
    return {"g": g, "every": every, "offsets": offsets.tolist(),
            "streams": {}}


def _first_sample(a0: torch.Tensor, traffic: dict) -> torch.Tensor:
    """The one sample of a stream without drawn inputs: ``A_0 1``, scaled
    as a bank's samples are."""
    return samples(a0, torch.ones_like(a0[:1]),
                   float(traffic["rho_per_fro"]))[0]


def call(engine, stack, traffic: dict, inputs: dict = None):
    from repro_torch import Rank1Update

    k, largest = int(traffic["k"]), bool(traffic["largest"])
    if inputs is None:
        # A caller that draws no inputs (``bench/readings.py``): a stream of
        # one step, a session opened and updated with ``_first_sample``.
        session = engine.open_session(stack[0], k, largest)
        engine.update(session, Rank1Update(_first_sample(stack[0], traffic),
                                           1))
        return session.result(), session.a
    stream = inputs["streams"].get(id(stack))
    if stream is None:
        # Set-up's warm call on this stack: its pool index is the number
        # of sessions opened before it.
        slot = len(inputs["streams"])
        session = engine.open_session(stack[0], k, largest)
        stream = inputs["streams"][id(stack)] = {
            "session": session, "slot": slot, "step": 0,
            "bank": samples(stack[0], inputs["g"][slot],
                            float(traffic["rho_per_fro"]))}
    s = stream["step"]
    stream["step"] = s + 1
    sample, sign = step(s, int(traffic["window"]))
    bank = stream["bank"]
    out = engine.update(stream["session"],
                        Rank1Update(bank[sample % len(bank)], sign))
    if not _compared(inputs, stream["slot"], s):
        return None
    return out, stream["session"].a


def split(engine, stack, inputs: dict, traffic: dict, walk):
    """One call whose programs (the update program, and the re-solve's
    top-k program where the monitor asks for one) are each walked stage by
    stage: the engine builds them, for the call, as ``walk`` bound to the
    built program."""
    from repro_torch.engine import engine as engine_mod

    built = engine_mod.program
    engine_mod.program = lambda plan, spec: functools.partial(
        walk, built(plan, spec))
    try:
        return call(engine, stack, traffic, inputs)
    finally:
        engine_mod.program = built


def reference_key(idx: int, ordinal: int, inputs: dict):
    return (idx, ordinal) if _compared(inputs, idx, ordinal) else None


def reference_for(idx: int, ordinal: int, pool: list, inputs: dict,
                  traffic: dict) -> dict:
    """Float64 ``eigh`` of ``A_0 + sum over the window of x x^T`` after
    step ``ordinal`` of session ``idx``, and that matrix."""
    a0 = pool[idx][0]
    banks = inputs.setdefault("banks", {})
    if idx not in banks:
        banks[idx] = samples(a0, inputs["g"][idx],
                             float(traffic["rho_per_fro"]))
    a = matrix_after(a0, banks[idx], ordinal, int(traffic["window"]))
    ref = plain.topk(a[None], int(traffic["k"]), bool(traffic["largest"]))
    ref["a"] = a
    return ref


def reference(stack, traffic: dict) -> dict:
    """The reference of a call without drawn inputs: ``A_0 + x x^T`` with
    ``x = _first_sample(A_0)``."""
    a0 = stack[0].to(torch.float64)
    x = _first_sample(a0, traffic)
    a = a0 + x[:, None] * x[None, :]
    ref = plain.topk(a[None], int(traffic["k"]), bool(traffic["largest"]))
    ref["a"] = a
    return ref


def compare(result, ref: dict) -> dict:
    window, a = result
    a_ref = ref["a"]
    mat = (torch.linalg.matrix_norm(a.to(torch.float64) - a_ref)
           / torch.linalg.matrix_norm(a_ref))
    return {"eig_err": plain.eig_err(window.eigenvalues[None], ref),
            "vec_err": plain.vec_err(window.vectors[None], ref),
            "mat_err": mat[None]}
