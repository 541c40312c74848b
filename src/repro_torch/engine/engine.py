"""SolverEngine: plan-driven, batched execution of the EEI stage graph.

``SolverEngine(plan, device).solve(a)`` / ``.topk(a, k)`` /
``.eigenvalues(a)`` take one symmetric matrix ``(n, n)`` or a stack
``(b, n, n)`` and run the plan's composition on the plan's backend;
``packed_topk_program(plan, k, largest)`` runs stacks of segment-packed
block-diagonal rows, a window of ``k`` per segment;
``.open_session(a, k)`` / ``.update(session, u)`` maintain the top-k window
of one matrix under rank-1 updates (``engine.session``).  The twin of
``repro.engine.engine``: a program resolves ``plan -> composition -> stage
chain`` (``registry``), binds every stage to its builder (the
``_STAGE_BUILDERS`` table) and threads a state dict through the chain.
Built programs are cached per :class:`ProgramSpec`; PyTorch runs eagerly,
so there is nothing to compile.

The engine runs on the card unless the caller asks for another device: with
no ``device`` it takes ``cuda`` and raises where there is none.  Under a
``sharded`` plan it runs on the mesh's first device (the stages move each
shard to its own), and the stack is padded up to a multiple of the mesh's
batch axis and sliced back.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.engine import backends as _backends  # noqa: F401 (registers)
from repro_torch.engine import registry
from repro_torch.engine.plan import SolverPlan
from repro_torch.engine.verify import DEFAULT_TOL
from repro_torch.linalg import interlace
from repro_torch.tracing import span

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class SolveResult(NamedTuple):
    """``eigenvalues (..., n)`` ascending and the magnitude table
    ``magnitudes (..., n, n)`` (rows are eigenvectors, dense basis)."""

    eigenvalues: torch.Tensor
    magnitudes: torch.Tensor


class TopkResult(NamedTuple):
    """``eigenvalues (..., k)`` ascending and signed, unit-norm eigenvectors
    ``vectors (..., k, n)`` (rows are eigenvectors, dense basis)."""

    eigenvalues: torch.Tensor
    vectors: torch.Tensor

    # Class-level marker so callers can test `result.degraded` uniformly;
    # the server's ``DegradedResult`` subclass overrides it.
    degraded = False


class PackedTopkResult(NamedTuple):
    """Per-slot windows of a segment-packed stack: ``eigenvalues (b, S,
    k)`` ascending per slot and ``vectors (b, S, k, n)`` over the full row
    width (each segment's columns at its offset).  A slot with fewer than
    ``k`` eigenvalues carries finite filler lanes outside the slice a
    request of ``k' <= seg_len`` reads: at the front of a ``largest``
    window, at the back of a smallest one."""

    eigenvalues: torch.Tensor
    vectors: torch.Tensor


class ProgramSpec(NamedTuple):
    """Static description of one program: kind, window and verify.

    ``verify=True`` appends the backend's ``verify`` stage: a topk program
    then returns ``(TopkResult, VerifyFlags)``, a packed_topk program
    ``(PackedTopkResult, VerifyFlags)`` with per-slot flags.  ``update`` programs always
    verify, and carry the session's retained window ``m_keep`` and the
    number ``ext`` of augmentation directions (``u`` plus Lanczos
    extensions) of the warm-project reduce.
    """

    kind: str  # solve | topk | eigenvalues | packed_topk | update
    k: int = 0  # 0 -> no window (full spectrum)
    largest: bool = True
    verify: bool = False
    m_keep: int = 0
    ext: int = 0


def _renormalize(vecs: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
    return vecs / torch.clamp(nrm, min=1e-30)


def _back_transform(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rows ``w[.., i, :]`` of tridiagonal eigenvectors -> dense ``v = Q w``."""
    return w @ q.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Stage builders: (role, name) -> builder(lib, spec) -> fn(state) -> dict
# ---------------------------------------------------------------------------


def _b_householder(lib, spec):
    with_q = spec.kind != "eigenvalues"

    def fn(st):
        d, e, q = lib.tridiagonalize(st["a"], with_q)
        return {"d": d, "e": e, "q": q}

    return fn


def _b_eigh(lib, spec):
    def fn(st):
        lam, v = torch.linalg.eigh(st["a"])
        return {"lam": lam, "v": v}

    return fn


def _b_eigh_topk(lib, spec):
    def fn(st):
        idx = st["idx"]
        return {"lam_sel": st["lam"][..., idx],
                "vecs": st["v"][..., :, idx].transpose(-1, -2)}

    return fn


def _b_eigh_solve(lib, spec):
    return lambda st: {"mags": (st["v"] * st["v"]).transpose(-1, -2)}


def _b_dense_eigenvalues(lib, spec):
    return lambda st: {"lam": lib.dense_eigenvalues(st["a"])}


def _b_tridiag_full(lib, spec):
    return lambda st: {"lam": lib.tridiag_eigenvalues(st["d"], st["e"])}


def _b_tridiag_windowed(lib, spec):
    def fn(st):
        # k == 0 (a full-eigenvalues program) means the whole band.
        return {"lam_sel": lib.tridiag_eigenvalues_windowed(
            st["d"], st["e"], spec.k or st["d"].shape[-1], spec.largest)}

    return fn


def _b_krylov(lib, spec):
    def fn(st):
        d, e, q = lib.krylov_reduce(st["a"], spec.k or st["a"].shape[-1],
                                    spec.largest)
        return {"d": d, "e": e, "q": q}

    return fn


def _b_krylov_si(lib, spec):
    def fn(st):
        d, e, q, sigma = lib.krylov_shift_invert_reduce(
            st["a"], spec.k or st["a"].shape[-1], spec.largest)
        return {"d": d, "e": e, "q": q, "sigma": sigma}

    return fn


def _b_tridiag_windowed_si(lib, spec):
    # The band lives in theta = 1/(lambda - sigma) space, where the
    # requested extreme of lambda is the opposite extreme of theta (sigma
    # sits outside the spectrum on the requested side): hence `not largest`.
    def fn(st):
        return {"lam_sel": lib.tridiag_eigenvalues_windowed(
            st["d"], st["e"], spec.k or st["d"].shape[-1], not spec.largest)}

    return fn


def _b_shift_invert_map(lib, spec):
    def fn(st):
        # theta ascending maps to lambda descending (1/x decreases on a
        # sign-definite interval): flip to ascending.
        lam = st["sigma"].unsqueeze(-1) + 1.0 / st["lam_sel"]
        out = {"lam_sel": torch.flip(lam, dims=(-1,))}
        if "vecs" in st:
            out["vecs"] = torch.flip(st["vecs"], dims=(-2,))
        return out

    return fn


def _b_dense_minors(lib, spec):
    return lambda st: {"mu": lib.dense_minor_spectra(st["a"])}


def _b_tridiag_minors(lib, spec):
    return lambda st: {"mu": lib.tridiag_minor_spectra(st["d"], st["e"])}


def _b_eei_full(lib, spec):
    return lambda st: {"mags": lib.magnitudes(st["lam"], st["mu"])}


def _b_eei_select(lib, spec):
    def fn(st):
        mags = lib.magnitudes(st["lam"], st["mu"])
        idx = st["idx"]
        return {"lam_sel": st["lam"][..., idx], "mag_sel": mags[..., idx, :]}

    return fn


def _b_eei_windowed(lib, spec):
    def fn(st):
        idx = st["idx"]
        return {"lam_sel": st["lam"][..., idx],
                "mag_sel": lib.magnitudes_windowed(st["lam"], st["mu"], idx)}

    return fn


def _b_minor_det(lib, spec):
    return lambda st: {"mag_sel": lib.minor_det_components(
        st["d"], st["e"], st["lam_sel"])}


def _b_tridiag_signs(lib, spec):
    def fn(st):
        w = lib.tridiag_signs(st["d"], st["e"], st["lam_sel"], st["mag_sel"])
        return {"vecs": _renormalize(_back_transform(w, st["q"]))}

    return fn


def _b_tridiag_solve(lib, spec):
    def fn(st):
        # Sign and back-transform every row so the table is in the dense
        # basis like the other compositions'.
        w = lib.tridiag_signs(st["d"], st["e"], st["lam"], st["mags"])
        v = _back_transform(_renormalize(w), st["q"])
        mags = v * v
        return {"mags": mags / mags.sum(dim=-1, keepdim=True)}

    return fn


def _b_dense_signs(lib, spec):
    return lambda st: {"vecs": _renormalize(lib.dense_signs(
        st["a"], st["lam_sel"], st["mag_sel"]))}


def _b_verify_topk(lib, spec):
    return lambda st: {"flags": lib.verify_topk(
        st["a"], st["lam_sel"], st["vecs"])}


# -- streaming rank-1 update stages -------------------------------------------


def _append_ortho(s_rows: torch.Tensor, v: torch.Tensor,
                  seed: int) -> torch.Tensor:
    """One more orthonormal row onto ``s_rows (..., r, n)`` (classical
    Gram-Schmidt, twice); where ``v`` already lies in the span, a fixed
    direction ``cos(arange(n) * (seed + 2) + 0.1)`` takes its place."""
    n = s_rows.shape[-1]

    def proj_out(x):
        for _ in range(2):
            c = torch.einsum("...rn,...n->...r", s_rows, x)
            x = x - torch.einsum("...r,...rn->...n", c, s_rows)
        return x

    v = proj_out(v)
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fb = torch.cos(torch.arange(n, dtype=s_rows.dtype, device=s_rows.device)
                   * (seed + 2) + 0.1)
    fb = proj_out(fb.expand(v.shape))
    fb_nrm = torch.linalg.vector_norm(fb, dim=-1, keepdim=True)
    v = torch.where(nrm > 1e-6, v / torch.clamp(nrm, min=1e-30),
                    fb / torch.clamp(fb_nrm, min=1e-30))
    return torch.cat([s_rows, v.unsqueeze(-2)], dim=-2)


def _b_warm_project(lib, spec):
    """Augmented-subspace reduce of the ``update`` kind.

    Projects the updated stack onto ``S = [basis; u; A'-Krylov ext]``: the
    retained Ritz rows, the unit update direction and ``spec.ext - 1``
    Lanczos extensions.  The compression ``S A' S^T`` (``(b, m', m')``) goes
    through the backend's own Householder reduce, and ``q = S^T q_small``
    lifts band vectors straight to the dense basis.  O(m' n^2) instead of a
    from-scratch O(n^3).
    """
    n_aug = spec.ext

    def fn(st):
        a, basis, u = st["a"], st["basis"], st["u"]
        m = basis.shape[-2]
        # Re-orthonormalize the retained rows (orthogonal only to fp
        # accuracy); QR of a near-orthonormal frame is cheap.
        qb, _ = torch.linalg.qr(basis.transpose(-1, -2))
        s_rows = qb.transpose(-1, -2)  # (b, m, n)
        v = u
        for j in range(n_aug):
            s_rows = _append_ortho(s_rows, v, j)
            v = torch.einsum("...nm,...m->...n", a, s_rows[..., -1, :])
        t = torch.einsum("...rn,...nm->...rm", s_rows, a)
        band = torch.einsum("...rm,...sm->...rs", t, s_rows)
        band = 0.5 * (band + band.transpose(-1, -2))
        d, e, qs = lib.tridiagonalize(band, True)
        q_eff = torch.einsum("...rn,...rt->...nt", s_rows, qs)
        # Secular weights: the coefficients of u on the retained frame.
        z = torch.einsum("...rn,...n->...r", s_rows[..., :m, :], u)
        return {"d": d, "e": e, "q": q_eff, "z2": z * z}

    return fn


def _b_tridiag_bracketed(lib, spec):
    """Warm-bracket spectrum stage of the ``update`` kind.

    Lane brackets come from rank-1 interlacing + Weyl on the cached Ritz
    values, widened by a slack of what verify lets the cached spectrum
    drift, then tightened on one side by the secular refinement (a lower
    bound for a ``largest`` window, an upper one for ``smallest``).  The
    backend's bracketed bisection validates every lane and falls back to
    Gershgorin where a bracket cannot prove containment.
    """
    k_lanes, largest = spec.m_keep, spec.largest

    def fn(st):
        theta, rho, z2, a = st["theta"], st["rho"], st["z2"], st["a"]
        scale = torch.sqrt(torch.sum(a * a, dim=(-2, -1)))  # ||A'||_F
        slack = (8.0 * DEFAULT_TOL) * scale
        lo, hi = interlace.rank1_update_brackets(
            theta, rho, drift_bound=slack.unsqueeze(-1))
        slo, shi = interlace.secular_bracket_refine(theta, z2, rho, lo, hi)
        sec_pad = (1e-5 * scale).unsqueeze(-1)
        if largest:
            lo = torch.maximum(lo, slo - sec_pad)
        else:
            hi = torch.minimum(hi, shi + sec_pad)
        return {"lam_sel": lib.tridiag_eigenvalues_bracketed(
            st["d"], st["e"], lo, hi, k_lanes, largest)}

    return fn


def _b_update_select(lib, spec):
    """Split the caller's k-window out of the refreshed m_keep-window; the
    whole window becomes the session's next ``(basis, theta)``."""
    k, largest = spec.k, spec.largest

    def fn(st):
        lam, vecs = st["lam_sel"], st["vecs"]  # (b, m_keep[, n]) ascending
        if largest:
            lam_k, vecs_k = lam[..., -k:], vecs[..., -k:, :]
        else:
            lam_k, vecs_k = lam[..., :k], vecs[..., :k, :]
        return {"lam_sel": lam_k, "vecs": vecs_k,
                "basis": vecs, "theta": lam}

    return fn


# -- packed (segment-stacked) stages ------------------------------------------


def _in_segment(seg_off, seg_len, n):
    """``(b, S, n)``: column ``p`` lies in slot ``s`` of row ``b``."""
    col = torch.arange(n, dtype=torch.int32, device=seg_off.device)
    return ((seg_off.unsqueeze(-1) <= col)
            & (col < (seg_off + seg_len).unsqueeze(-1)))


def _b_packed_select(lib, spec):
    """Per-slot windows from the ``eigh`` of each packed row.

    A packed row is block-diagonal, so each eigenvector lies in one segment
    (or in guard columns): in-segment mass above 0.5 decides ownership.
    Guard pairs and near-degenerate pairs mixed across two segments fail
    the gate and leave finite filler lanes, which the per-slot verify flags.
    """
    k, largest = spec.k, spec.largest

    def fn(st):
        lam, v = st["lam"], st["v"]  # (b, N) ascending, columns = vectors
        b, n = lam.shape
        in_seg = _in_segment(st["seg_off"], st["seg_len"], n)
        mass = torch.einsum("bsp,bpj->bsj", in_seg.to(lam.dtype), v * v)
        owned = mass > 0.5
        big = torch.finfo(lam.dtype).max / 8
        fill = torch.full((), -big, dtype=lam.dtype, device=lam.device)
        if largest:
            vals = torch.where(owned, lam.unsqueeze(1), fill)
            top, idx = torch.topk(vals, k, dim=-1)  # descending, fillers last
            lam_seg, idx = top.flip(-1), idx.flip(-1)
        else:
            vals = torch.where(owned, -lam.unsqueeze(1), fill)
            top, idx = torch.topk(vals, k, dim=-1)
            lam_seg = -top  # ascending, fillers (+big) last
        vt = v.transpose(-1, -2)  # rows = vectors
        rows = torch.arange(b, device=lam.device)[:, None, None]
        return {"lam_seg": lam_seg, "vecs_seg": vt[rows, idx, :]}

    return fn


def _b_tridiag_segmented(lib, spec):
    """Per-segment k-windows of the packed band (the segmented Sturm
    kernel), flattened to ``lam_sel (b, S*k)`` so that the components and
    recover stages run on them unchanged."""
    k, largest = spec.k, spec.largest

    def fn(st):
        lam_seg = lib.tridiag_eigenvalues_segmented(
            st["d"], st["e"], st["seg_off"], st["seg_len"], k, largest)
        b, s, _ = lam_seg.shape
        return {"lam_sel": lam_seg.reshape(b, s * k)}

    return fn


def _b_packed_reshape(lib, spec):
    k = spec.k

    def fn(st):
        lam_sel, vecs = st["lam_sel"], st["vecs"]  # (b, S*k), (b, S*k, N)
        b, s = st["seg_off"].shape
        return {"lam_seg": lam_sel.reshape(b, s, k),
                "vecs_seg": vecs.reshape(b, s, k, vecs.shape[-1])}

    return fn


def _b_verify_topk_packed(lib, spec):
    return lambda st: {"flags": lib.verify_topk_packed(
        st["a"], st["seg_off"], st["seg_len"], st["lam_seg"],
        st["vecs_seg"], spec.largest)}


_STAGE_BUILDERS = {
    ("reduce", "householder"): _b_householder,
    ("reduce", "krylov"): _b_krylov,
    ("reduce", "krylov_shift_invert"): _b_krylov_si,
    ("spectrum", "eigh"): _b_eigh,
    ("spectrum", "dense_eigenvalues"): _b_dense_eigenvalues,
    ("spectrum", "tridiag_full"): _b_tridiag_full,
    ("spectrum", "tridiag_windowed"): _b_tridiag_windowed,
    ("spectrum", "tridiag_windowed_si"): _b_tridiag_windowed_si,
    ("minor_spectra", "dense_minors"): _b_dense_minors,
    ("minor_spectra", "tridiag_minors"): _b_tridiag_minors,
    ("components", "eei_full"): _b_eei_full,
    ("components", "eei_select"): _b_eei_select,
    ("components", "eei_windowed"): _b_eei_windowed,
    ("components", "minor_det"): _b_minor_det,
    ("recover", "eigh_topk"): _b_eigh_topk,
    ("recover", "eigh_solve"): _b_eigh_solve,
    ("recover", "tridiag_signs"): _b_tridiag_signs,
    ("recover", "tridiag_solve"): _b_tridiag_solve,
    ("recover", "dense_signs"): _b_dense_signs,
    ("recover", "shift_invert_map"): _b_shift_invert_map,
    ("reduce", "warm_project"): _b_warm_project,
    ("spectrum", "tridiag_bracketed"): _b_tridiag_bracketed,
    ("recover", "update_select"): _b_update_select,
    ("spectrum", "tridiag_segmented"): _b_tridiag_segmented,
    ("recover", "packed_select"): _b_packed_select,
    ("recover", "packed_reshape"): _b_packed_reshape,
    ("verify", "verify_topk"): _b_verify_topk,
    ("verify", "verify_topk_packed"): _b_verify_topk_packed,
}

#: The verify stage the engine appends to a chain (not part of any
#: composition, so every method and backend gets it).
_VERIFY_SIG = registry.StageSig(
    role="verify", name="verify_topk",
    requires=("a", "lam_sel", "vecs"), provides=("flags",))

#: Its packed twin: flags per slot ``(b, S)``, so one bad segment flags one
#: request, not its whole row.
_PACKED_VERIFY_SIG = registry.StageSig(
    role="verify", name="verify_topk_packed",
    requires=("a", "seg_off", "seg_len", "lam_seg", "vecs_seg"),
    provides=("flags",))


# ---------------------------------------------------------------------------
# Graph executor
# ---------------------------------------------------------------------------


def _resolve_chain(plan: SolverPlan, spec: ProgramSpec):
    """The composition and chain a program runs.

    ``topk`` takes the windowed composition when the plan asks for it;
    ``solve`` always the full one; ``eigenvalues`` with a window prefers the
    windowed chain (index-targeted bisection).  A composition without the
    kind's chain falls back to the method's full composition.
    """
    if spec.kind in ("topk", "packed_topk", "update"):
        windowed = plan.spectrum == "windowed"
    else:
        windowed = spec.kind == "eigenvalues" and spec.k > 0
    comp = registry.composition_for(plan.method, windowed)
    chain = comp.chain(spec.kind)
    if chain is None:
        comp = registry.composition_for(plan.method, False)
        chain = comp.chain(spec.kind)
    if chain is None:
        raise ValueError(
            f"composition {comp.name!r} declares no {spec.kind!r} chain")
    return comp, chain


def _window_idx(n: int, k: int, largest: bool, device) -> torch.Tensor:
    start = n - k if largest else 0
    return torch.arange(start, start + k, device=device)


class Program:
    """One built stage chain; ``stages`` lists ``(StageSig, fn)`` in order."""

    def __init__(self, plan: SolverPlan, spec: ProgramSpec):
        lib = registry.get_backend(plan)
        _, chain = _resolve_chain(plan, spec)
        if spec.verify:
            if spec.kind not in ("topk", "packed_topk", "update"):
                raise ValueError("verify is only supported for topk, "
                                 "packed_topk and update programs")
            chain = chain + (_PACKED_VERIFY_SIG if spec.kind == "packed_topk"
                             else _VERIFY_SIG,)
        self.spec = spec
        self.stages = tuple(
            (sig, _STAGE_BUILDERS[(sig.role, sig.name)](lib, spec))
            for sig in chain)

    def initial_state(self, a: torch.Tensor) -> dict:
        state = {"a": a}
        if self.spec.kind in ("topk", "eigenvalues"):
            n = a.shape[-1]
            state["idx"] = _window_idx(n, self.spec.k or n, self.spec.largest,
                                       a.device)
        return state

    def result(self, state: dict):
        if self.spec.kind == "topk":
            result = TopkResult(state["lam_sel"], state["vecs"])
            return (result, state["flags"]) if self.spec.verify else result
        if self.spec.kind == "solve":
            return SolveResult(state["lam"], state["mags"])
        if "lam_sel" in state:  # windowed eigenvalue chain
            return state["lam_sel"]
        # A windowed query on a full chain (eigh): slice the spectrum.
        return state["lam"][..., state["idx"]] if self.spec.k else state["lam"]

    def __call__(self, *args):
        state = self.initial_state(*args)
        for sig, fn in self.stages:
            with span(f"stage/{sig.role}/{sig.name}"):
                state.update(fn(state))
        return self.result(state)


class UpdateProgram(Program):
    """The streaming rank-1 ``update`` program.

    ``prog(a_prev, basis, theta, u, rho)`` applies ``a = a_prev + rho u
    u^T`` (``u (b, n)`` unit, ``rho (b,)`` signed), walks the method's
    ``update`` chain and the verify stage, and returns ``(TopkResult,
    VerifyFlags, a, basis', theta')``: the trailing state is what the
    session keeps for its next update.
    """

    def initial_state(self, a_prev, basis, theta, u, rho) -> dict:
        a = a_prev + rho[..., None, None] * u[..., :, None] * u[..., None, :]
        idx = _window_idx(a.shape[-1], self.spec.k, self.spec.largest,
                          a.device)
        return {"a": a, "basis": basis, "theta": theta, "u": u, "rho": rho,
                "idx": idx}

    def result(self, state: dict):
        return (TopkResult(state["lam_sel"], state["vecs"]), state["flags"],
                state["a"], state["basis"], state["theta"])


class PackedProgram(Program):
    """The ``packed_topk`` program: ``prog(a, seg_off, seg_len)`` takes a
    stack ``a (b, N, N)`` of block-diagonal rows and its segment layout
    ``(b, S)`` (start columns and lengths, 0 for an empty slot) and returns
    a :class:`PackedTopkResult`, with per-slot flags when it verifies."""

    def initial_state(self, a, seg_off, seg_len) -> dict:
        return {"a": a,
                "seg_off": torch.as_tensor(seg_off, dtype=torch.int32,
                                           device=a.device),
                "seg_len": torch.as_tensor(seg_len, dtype=torch.int32,
                                           device=a.device)}

    def result(self, state: dict):
        result = PackedTopkResult(state["lam_seg"], state["vecs_seg"])
        return (result, state["flags"]) if self.spec.verify else result


@functools.lru_cache(maxsize=None)
def program(plan: SolverPlan, spec: ProgramSpec) -> Program:
    """The built program for one ``(plan, spec)``, cached."""
    if spec.kind == "update":
        if not spec.verify:
            raise ValueError("update programs always verify")
        return UpdateProgram(plan, spec)
    if spec.kind == "packed_topk":
        return PackedProgram(plan, spec)
    return Program(plan, spec)


def topk_program(plan: SolverPlan, k: int, largest: bool,
                 verify: bool = False) -> Program:
    """The batched top-k program for one ``(plan, k, largest)``; with
    ``verify=True`` it returns ``(TopkResult, VerifyFlags)``, its
    ``TopkResult`` bitwise equal to the plain program's."""
    return program(plan, ProgramSpec("topk", int(k), bool(largest),
                                     bool(verify)))


def packed_topk_program(plan: SolverPlan, k: int, largest: bool,
                        verify: bool = False) -> PackedProgram:
    """The per-slot top-k program of segment-packed stacks for one ``(plan,
    k, largest)`` (:func:`~repro_torch.engine.plan.packed_plan_for` picks
    the plan from the row width).  ``k`` is the slot window: every packed
    request reads its own ``k' <= k`` lanes of it.  The program runs where
    its operands lie; with ``verify=True`` it returns
    ``(PackedTopkResult, flags (b, S))``."""
    return program(plan, ProgramSpec("packed_topk", int(k), bool(largest),
                                     bool(verify)))


def update_program(plan: SolverPlan, k: int, largest: bool, m_keep: int,
                   ext: int) -> UpdateProgram:
    """The rank-1 update program for one session geometry: window ``k``,
    retained window ``m_keep`` and ``ext`` augmentation directions."""
    return program(plan, ProgramSpec("update", int(k), bool(largest), True,
                                     int(m_keep), int(ext)))


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "SolverEngine runs on the card by default and found no CUDA "
                "device; pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def _same_device(x: torch.device, y: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` name one device."""
    if x.type != y.type:
        return False
    if x.type != "cuda" or (x.index is not None and y.index is not None):
        return x == y
    current = torch.cuda.current_device()
    return ((current if x.index is None else x.index)
            == (current if y.index is None else y.index))


def _map(fn, out):
    if isinstance(out, tuple):
        return type(out)(*(fn(x) for x in out))
    return fn(out)


def _concat(outs):
    if isinstance(outs[0], tuple):
        return type(outs[0])(*(torch.cat(xs, dim=0) for xs in zip(*outs)))
    return torch.cat(outs, dim=0)


@dataclasses.dataclass(frozen=True)
class SolverEngine:
    """Batched EEI solver executing one :class:`SolverPlan` on ``device``."""

    plan: SolverPlan = SolverPlan()
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.plan.backend == "sharded":
            first = self.plan.mesh.first_device
            if self.device is not None and not _same_device(
                    torch.device(self.device), first):
                raise ValueError(
                    f"a sharded plan runs on its mesh's first device "
                    f"{first}, not {self.device}")
            object.__setattr__(self, "device", first)
            return
        object.__setattr__(self, "device", _resolve_device(self.device))

    def solve(self, a) -> SolveResult:
        """Eigenvalues and the full ``|v[i, j]|^2`` table (dense basis).
        Always the method's full composition."""
        return self._run(program(self.plan, ProgramSpec("solve")), a)

    def topk(self, a, k: int, largest: bool = True) -> TopkResult:
        """Top-k (eigenvalue, signed unit eigenvector) pairs per matrix."""
        n = a.shape[-1]
        if k < 1 or k > n:
            raise ValueError(f"k={k} out of range for n={n}")
        return self._run(
            program(self.plan, ProgramSpec("topk", int(k), bool(largest))), a)

    def eigenvalues(self, a, k: Optional[int] = None,
                    largest: bool = True) -> torch.Tensor:
        """Eigenvalues ``(..., n)`` ascending, or with ``k`` the ``k``
        extremal ones ``(..., k)`` ascending via the windowed spectrum
        stage (bitwise-equal to the matching slice of the full one)."""
        n = a.shape[-1]
        if k is not None and (k < 1 or k > n):
            raise ValueError(f"k={k} out of range for n={n}")
        spec = ProgramSpec("eigenvalues", int(k or 0),
                           bool(largest) if k else True)
        return self._run(program(self.plan, spec), a)

    def open_session(self, a, k: int, largest: bool = True, config=None):
        """Open a :class:`~repro_torch.engine.session.SpectralSession` on
        one ``(n, n)`` matrix: a full solve seeds the retained Ritz window,
        and :meth:`update` maintains it under rank-1 drift."""
        from repro_torch.engine import session as session_mod

        return session_mod.open_session(self, a, int(k), bool(largest),
                                        config)

    def update(self, session, delta):
        """Apply ``A <- A + sign * u u^T`` to a session and return the
        refreshed :class:`TopkResult`.  ``delta`` is ``u``, ``(u, sign)``, a
        :class:`~repro_torch.engine.session.Rank1Update` or a sequence of
        them (applied in turn).  The warm path runs unless the session's
        drift monitor (accumulated ``|rho|``, verify flags, update cadence)
        asks for a full re-solve."""
        from repro_torch.engine import session as session_mod

        return session_mod.apply_update(self, session, delta)

    def _run(self, prog: Program, a):
        a = torch.as_tensor(a, device=self.device)
        if a.ndim not in (2, 3):
            raise ValueError(f"expected (n, n) or (b, n, n), got {tuple(a.shape)}")
        if self.plan.precision is not None:
            a = a.to(_DTYPES[self.plan.precision])
        if a.dtype not in _DTYPES.values():
            raise TypeError(f"expected float32 or float64, got {a.dtype}")
        squeeze = a.ndim == 2
        if squeeze:
            a = a.unsqueeze(0)
        b = a.shape[0]
        if b == 0:
            raise ValueError("cannot solve an empty matrix stack")
        step = self.plan.max_batch if self.plan.max_batch > 0 else b
        # Every chunk runs at the full `step` shape: the ragged tail is
        # padded with copies of its first matrix and sliced back.
        pad_to = step if b > step else 0
        outs = [self._run_chunk(prog, a[i0:i0 + step], pad_to)
                for i0 in range(0, b, step)]
        out = outs[0] if len(outs) == 1 else _concat(outs)
        return _map(lambda x: x[0], out) if squeeze else out

    def _run_chunk(self, prog: Program, a: torch.Tensor, pad_to: int = 0):
        # Pad up to `pad_to` (a microbatched run's tail) and to a multiple of
        # the mesh's batch axis (the sharded stages split the stack evenly)
        # with copies of the first matrix; slice back after.
        b = a.shape[0]
        target = max(b, pad_to)
        target += (-target) % self.plan.batch_axis_size
        pad = target - b
        if pad:
            a = torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])
        out = prog(a)
        return _map(lambda x: x[:b], out) if pad else out
