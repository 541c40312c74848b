"""Default stage libraries (reference, torch, cuda, sharded) and
compositions.

    reference   straightforward PyTorch: unfused log-space sums and the
                plain Sturm bisection.  The oracle the others are held to.
    torch       the fused-reduction twin of ``repro``'s ``jnp`` backend: the
                numerator and denominator sums written as contractions with
                a ones-vector (``identity.*_dot``).
    cuda        the hand-written kernels: Sturm bisection (full spectrum,
                k-window and all stacked minor bands, one launch each), the
                segmented Sturm bisection (the k-windows of every segment of
                packed rows, and warm per-lane brackets in the session
                update), the prod-diff numerator table (whole, or only
                the k selected rows) and the minor-determinant components
                (one launch for the window of every matrix).  On CPU tensors
                the kernel wrappers run their plain versions.
    sharded     the cuda stages split over the batch axis of a device mesh
                (``core.distributed``).

The Householder reduce, the Lanczos reduce, the dense ``eigvalsh`` (in
float64 for a float32 stack on the card, see :func:`_card_float64`), the
LU sign solves and the sign recurrence are plain PyTorch on every backend,
as ``repro`` leaves them to ``jnp``, XLA and LAPACK.  So is the
minor-determinant recurrence on ``reference`` and ``torch``; ``cuda`` (and
``sharded``, which runs ``cuda``'s stages) computes it with a kernel.

Compositions registered here:

    eigh                  ``torch.linalg.eigh`` (the oracle / small-n path)
    eei_dense             dense minor spectra -> full EEI table -> LU signs
    eei_dense_windowed    as eei_dense, but the components evaluate only the
                          k selected rows (kernel 2 with I = k), bitwise the
                          full table's rows
    eei_tridiag           Householder -> Sturm -> minor Sturm -> full EEI
                          table -> recurrence signs + back-transform
    eei_tridiag_windowed  Householder -> k-window Sturm -> minor-determinant
                          components -> recurrence signs + back-transform
    eei_krylov            Lanczos partial band (m ~ 16k) -> the windowed
                          chain on the m-band -> back-transform through the
                          partial basis (topk and eigenvalues only: a
                          partial basis has no full-table solve)
    eei_krylov_si         as eei_krylov on (A - sigma I)^{-1} through one
                          batched LU; a last stage undoes
                          theta = 1/(lambda - sigma)

``eigh`` and ``eei_tridiag_windowed`` also carry a ``packed_topk`` chain
for stacks of segment-packed block-diagonal rows: one ``eigh`` of each row
and a per-slot selection by in-segment mass, or Householder -> segmented
Sturm (each segment's k-window) -> minor-determinant components ->
recurrence signs + back-transform -> per-slot reshape.  Every composition
also carries the streaming rank-1 ``update`` chain (``_UPDATE_CHAIN``):
warm-project reduce -> bracketed Sturm -> minor-determinant components ->
recurrence signs -> update select.
"""

from __future__ import annotations

import torch

from repro_torch.core import identity, minors
from repro_torch.core.directions import (
    inverse_iteration_signs,
    inverse_iteration_signs_batched,
    tridiagonal_signs,
)
from repro_torch.engine.plan import SolverPlan
from repro_torch.engine.verify import verify_topk, verify_topk_packed
from repro_torch.engine.registry import (
    Composition,
    StageLibrary,
    StageSig,
    register_backend,
    register_composition,
)
from repro_torch.linalg import householder, sturm


def _card_float64(fn):
    """``fn`` of a float32 stack on the card, computed in float64 and
    returned in float32.  On the H100 cuSOLVER's float32 ``eigvalsh`` of
    small matrices is both less accurate and slower than its float64 one
    (``chip_smoke.py``'s dense phase prints both); far enough off that the
    inverse-iteration shifts miss, and small components take the wrong
    sign.  CPU stacks, and float64 ones, run ``fn`` as they are."""
    def wrapped(a: torch.Tensor) -> torch.Tensor:
        if a.is_cuda and a.dtype == torch.float32:
            return fn(a.double()).float()
        return fn(a)

    return wrapped


_dense_eigenvalues = _card_float64(torch.linalg.eigvalsh)
_dense_minor_spectra = _card_float64(identity.minor_spectra)


def _dense_signs_reference(a, lam_sel, mag_sel):
    """Signed dense eigenvectors, one inverse-iteration solve per (matrix,
    pair): the sign oracle."""
    return torch.stack([
        torch.stack([inverse_iteration_signs(a[b], lam_sel[b, i],
                                             mag_sel[b, i])
                     for i in range(lam_sel.shape[1])])
        for b in range(lam_sel.shape[0])])


def _make_krylov_stages(plan: SolverPlan) -> dict:
    """The two Krylov reduce stages, closing over the plan's band size.
    Every backend shares them: the Lanczos loop is dense matvecs and
    projections, and its residual check bisects through
    ``kernels.sturm.ops`` (kernel 1 on a CUDA tensor) and takes the
    magnitudes through ``kernels.minor_det.ops`` (its kernel on a CUDA
    tensor)."""
    from repro_torch.linalg import lanczos

    m = plan.krylov_m
    graphs = lanczos.LanczosGraphs()  # kept with the program that runs it

    def krylov_reduce(a, k, largest):
        return lanczos.krylov_reduce(a, int(k), bool(largest), m,
                                     graphs=graphs)

    def krylov_shift_invert_reduce(a, k, largest):
        return lanczos.krylov_shift_invert_reduce(a, int(k), bool(largest), m)

    return {"krylov_reduce": krylov_reduce,
            "krylov_shift_invert_reduce": krylov_shift_invert_reduce}


def _common_stages(plan: SolverPlan) -> dict:
    """Stages every backend shares: the reduces, the sign recurrence, the
    dense spectra of the eigh and dense chains, and the batched LU signs."""
    return {
        "tridiagonalize": householder.tridiagonalize,
        "dense_eigenvalues": _dense_eigenvalues,
        "dense_minor_spectra": _dense_minor_spectra,
        "tridiag_signs": tridiagonal_signs,
        "dense_signs": inverse_iteration_signs_batched,
        "verify_topk": verify_topk,
        "verify_topk_packed": verify_topk_packed,
        **_make_krylov_stages(plan),
    }


def _make_plain(name: str, reduce: str, plan: SolverPlan) -> StageLibrary:
    iters = plan.bisect_iters

    def tridiag_eigenvalues(d, e):
        return sturm.bisect_eigenvalues(d, e, n_iter=iters)

    def tridiag_eigenvalues_windowed(d, e, k, largest):
        return sturm.bisect_eigenvalues_windowed(
            d, e, k, largest=largest, n_iter=iters)

    def tridiag_eigenvalues_bracketed(d, e, lo, hi, k, largest):
        return sturm.bisect_eigenvalues_bracketed(
            d, e, lo, hi, int(k), largest=bool(largest), n_iter=iters)

    def tridiag_eigenvalues_segmented(d, e, seg_off, seg_len, k, largest):
        from repro_torch.kernels.sturm.ops import segmented_lanes

        lanes = segmented_lanes(d, e, seg_off, seg_len, k=int(k),
                                largest=bool(largest))
        out = sturm.bisect_lanes_segmented(
            d, e, **lanes, n_iter=iters or sturm.default_iters(d.dtype))
        return out.reshape(d.shape[0], seg_off.shape[1], int(k))

    def tridiag_minor_spectra(d, e):
        dm, em = minors.all_tridiagonal_minor_bands(d, e)
        return sturm.bisect_eigenvalues(dm, em, n_iter=iters)

    def magnitudes(lam, mu):
        return identity.magnitudes_from_spectra(lam, mu, reduce=reduce)

    def magnitudes_windowed(lam, mu, idx):
        return identity.magnitudes_from_spectra(lam, mu, reduce=reduce,
                                                rows=idx)

    stages = {
        **_common_stages(plan),
        "minor_det_components": identity.tridiag_windowed_magnitudes,
        "tridiag_eigenvalues": tridiag_eigenvalues,
        "tridiag_eigenvalues_windowed": tridiag_eigenvalues_windowed,
        "tridiag_eigenvalues_bracketed": tridiag_eigenvalues_bracketed,
        "tridiag_eigenvalues_segmented": tridiag_eigenvalues_segmented,
        "tridiag_minor_spectra": tridiag_minor_spectra,
        "magnitudes": magnitudes,
        "magnitudes_windowed": magnitudes_windowed,
    }
    if name == "reference":
        stages["dense_signs"] = _dense_signs_reference
    return StageLibrary(name, stages)


def make_reference_backend(plan: SolverPlan) -> StageLibrary:
    return _make_plain("reference", "sum", plan)


def make_torch_backend(plan: SolverPlan) -> StageLibrary:
    return _make_plain("torch", "dot", plan)


def make_cuda_backend(plan: SolverPlan) -> StageLibrary:
    from repro_torch.kernels.minor_det import ops as md_ops
    from repro_torch.kernels.prod_diff import ops as pd_ops
    from repro_torch.kernels.sturm import ops as sturm_ops

    iters = plan.bisect_iters

    def tridiag_eigenvalues(d, e):
        return sturm_ops.sturm_eigenvalues(d, e, n_iter=iters)

    def tridiag_eigenvalues_windowed(d, e, k, largest):
        return sturm_ops.sturm_eigenvalues(
            d, e, n_iter=iters, window=(int(k), bool(largest)))

    def tridiag_eigenvalues_bracketed(d, e, lo, hi, k, largest):
        return sturm_ops.sturm_eigenvalues_bracketed(
            d, e, lo, hi, k=int(k), largest=bool(largest), n_iter=iters)

    def tridiag_eigenvalues_segmented(d, e, seg_off, seg_len, k, largest):
        return sturm_ops.sturm_eigenvalues_segmented(
            d, e, seg_off, seg_len, k=int(k), largest=bool(largest),
            n_iter=iters)

    def tridiag_minor_spectra(d, e):
        dm, em = minors.all_tridiagonal_minor_bands(d, e)
        return sturm_ops.sturm_minor_spectra(dm, em, n_iter=iters)

    return StageLibrary("cuda", {
        **_common_stages(plan),
        "tridiag_eigenvalues": tridiag_eigenvalues,
        "tridiag_eigenvalues_windowed": tridiag_eigenvalues_windowed,
        "tridiag_eigenvalues_bracketed": tridiag_eigenvalues_bracketed,
        "tridiag_eigenvalues_segmented": tridiag_eigenvalues_segmented,
        "tridiag_minor_spectra": tridiag_minor_spectra,
        "magnitudes": pd_ops.eei_magnitudes_batched,
        "magnitudes_windowed": pd_ops.eei_magnitudes_windowed,
        "minor_det_components": md_ops.tridiag_windowed_magnitudes,
    })


def _sharded_factory(plan: SolverPlan) -> StageLibrary:
    from repro_torch.core.distributed import make_sharded_backend

    return make_sharded_backend(plan)


def register_default_backends() -> None:
    register_backend("reference", make_reference_backend)
    register_backend("torch", make_torch_backend)
    register_backend("cuda", make_cuda_backend)
    register_backend("sharded", _sharded_factory)


# Shared stage signatures.
_REDUCE = StageSig("reduce", "householder", ("a",), ("d", "e", "q"))
_REDUCE_NOQ = StageSig("reduce", "householder", ("a",), ("d", "e"))
_SPEC_DENSE = StageSig("spectrum", "dense_eigenvalues", ("a",), ("lam",))
_SPEC_TRI = StageSig("spectrum", "tridiag_full", ("d", "e"), ("lam",))
_SPEC_TRI_WIN = StageSig(
    "spectrum", "tridiag_windowed", ("d", "e"), ("lam_sel",))
_MINORS_DENSE = StageSig("minor_spectra", "dense_minors", ("a",), ("mu",))
_MINORS_TRI = StageSig("minor_spectra", "tridiag_minors", ("d", "e"), ("mu",))
_COMP_FULL = StageSig("components", "eei_full", ("lam", "mu"), ("mags",))
_COMP_SELECT = StageSig(
    "components", "eei_select", ("lam", "mu", "idx"), ("lam_sel", "mag_sel"))
_COMP_WIN = StageSig(
    "components", "eei_windowed", ("lam", "mu", "idx"),
    ("lam_sel", "mag_sel"))
_COMP_DET = StageSig(
    "components", "minor_det", ("d", "e", "lam_sel"), ("mag_sel",))
_REC_TRI = StageSig(
    "recover", "tridiag_signs", ("d", "e", "q", "lam_sel", "mag_sel"),
    ("vecs",))
_REC_TRI_SOLVE = StageSig(
    "recover", "tridiag_solve", ("d", "e", "q", "lam", "mags"), ("mags",))
_REC_DENSE = StageSig(
    "recover", "dense_signs", ("a", "lam_sel", "mag_sel"), ("vecs",))
# The Krylov reduce: a Lanczos band d (b, m), e (b, m-1) and the partial
# basis q (b, n, m).  Every later tridiagonal stage is band-size agnostic, so
# the windowed chain runs on the m-band unchanged and the back-transform
# through q lifts band vectors to the dense basis.
_REDUCE_KRYLOV = StageSig("reduce", "krylov", ("a",), ("d", "e", "q"))
_REDUCE_KRYLOV_NOQ = StageSig("reduce", "krylov", ("a",), ("d", "e"))
# Shift-and-invert: the band lives in theta = 1/(lambda - sigma) space, and
# the chain ends with a map stage that undoes it.
_REDUCE_SI = StageSig(
    "reduce", "krylov_shift_invert", ("a",), ("d", "e", "q", "sigma"))
_REDUCE_SI_NOQ = StageSig(
    "reduce", "krylov_shift_invert", ("a",), ("d", "e", "sigma"))
_SPEC_SI_WIN = StageSig(
    "spectrum", "tridiag_windowed_si", ("d", "e"), ("lam_sel",))
_MAP_SI = StageSig(
    "recover", "shift_invert_map", ("sigma", "lam_sel", "vecs"),
    ("lam_sel", "vecs"))
_MAP_SI_EIG = StageSig(
    "recover", "shift_invert_map", ("sigma", "lam_sel"), ("lam_sel",))
# The packed chains: a packed row is block-diagonal, so the full-chain
# stages apply to the packed matrix itself.  The eigh chain selects each
# slot's window among the row's eigenpairs by in-segment mass; the
# tridiagonal chain swaps the windowed Sturm for its segmented twin (per-lane
# bracket, segment and target) and runs the minor-determinant and sign
# stages unchanged on the flattened (b, S*k) window (an eigenvalue of one
# segment has ~0 minor-determinant mass outside it, and the sign recurrence
# restarts at every zero junction).
_SPEC_TRI_SEG = StageSig(
    "spectrum", "tridiag_segmented", ("d", "e", "seg_off", "seg_len"),
    ("lam_sel",))
_REC_PACKED_SELECT = StageSig(
    "recover", "packed_select", ("lam", "v", "seg_off", "seg_len"),
    ("lam_seg", "vecs_seg"))
_REC_PACKED_RESHAPE = StageSig(
    "recover", "packed_reshape", ("lam_sel", "vecs", "seg_off", "seg_len"),
    ("lam_seg", "vecs_seg"))
# The streaming rank-1 update chain, shared by every method: the reduce
# projects the updated matrix onto the session's retained Ritz basis, the
# update direction and a few Lanczos extensions and tridiagonalizes the small
# compression; its q lifts band vectors to the dense basis, so after it the
# chain is the windowed tridiagonal one, except that the spectrum bisects
# from interlacing + secular warm brackets and a last stage splits the
# caller's k-window from the refreshed (basis, theta).
_REDUCE_WARM = StageSig(
    "reduce", "warm_project", ("a", "basis", "u"), ("d", "e", "q", "z2"))
_SPEC_TRI_BRACKETED = StageSig(
    "spectrum", "tridiag_bracketed", ("a", "d", "e", "theta", "rho", "z2"),
    ("lam_sel",))
_REC_UPDATE_SELECT = StageSig(
    "recover", "update_select", ("lam_sel", "vecs", "idx"),
    ("lam_sel", "vecs", "basis", "theta"))
_UPDATE_CHAIN = (
    _REDUCE_WARM, _SPEC_TRI_BRACKETED, _COMP_DET, _REC_TRI,
    _REC_UPDATE_SELECT)


def register_default_compositions() -> None:
    register_composition(Composition(
        name="eigh", method="eigh", windowed=False,
        topk=(
            StageSig("spectrum", "eigh", ("a",), ("lam", "v")),
            StageSig("recover", "eigh_topk", ("lam", "v", "idx"),
                     ("lam_sel", "vecs")),
        ),
        solve=(
            StageSig("spectrum", "eigh", ("a",), ("lam", "v")),
            StageSig("recover", "eigh_solve", ("lam", "v"), ("mags",)),
        ),
        eigenvalues=(_SPEC_DENSE,),
        packed_topk=(
            StageSig("spectrum", "eigh", ("a",), ("lam", "v")),
            _REC_PACKED_SELECT,
        ),
        update=_UPDATE_CHAIN,
    ))
    register_composition(Composition(
        name="eei_dense", method="eei_dense", windowed=False,
        topk=(_SPEC_DENSE, _MINORS_DENSE, _COMP_SELECT, _REC_DENSE),
        solve=(_SPEC_DENSE, _MINORS_DENSE, _COMP_FULL),
        eigenvalues=(_SPEC_DENSE,),
        update=_UPDATE_CHAIN,
    ))
    register_composition(Composition(
        name="eei_dense_windowed", method="eei_dense", windowed=True,
        topk=(_SPEC_DENSE, _MINORS_DENSE, _COMP_WIN, _REC_DENSE),
        update=_UPDATE_CHAIN,
    ))
    register_composition(Composition(
        name="eei_tridiag", method="eei_tridiag", windowed=False,
        topk=(_REDUCE, _SPEC_TRI, _MINORS_TRI, _COMP_SELECT, _REC_TRI),
        solve=(_REDUCE, _SPEC_TRI, _MINORS_TRI, _COMP_FULL, _REC_TRI_SOLVE),
        eigenvalues=(_REDUCE_NOQ, _SPEC_TRI),
        update=_UPDATE_CHAIN,
    ))
    register_composition(Composition(
        name="eei_tridiag_windowed", method="eei_tridiag", windowed=True,
        topk=(_REDUCE, _SPEC_TRI_WIN, _COMP_DET, _REC_TRI),
        eigenvalues=(_REDUCE_NOQ, _SPEC_TRI_WIN),
        packed_topk=(
            _REDUCE, _SPEC_TRI_SEG, _COMP_DET, _REC_TRI,
            _REC_PACKED_RESHAPE),
        update=_UPDATE_CHAIN,
    ))
    # Krylov: the Lanczos band replaces Householder and the rest is the
    # windowed chain.  No solve chain: SolverEngine.solve on a Krylov plan
    # raises the registry's "declares no 'solve' chain" error.
    register_composition(Composition(
        name="eei_krylov", method="eei_krylov", windowed=False,
        topk=(_REDUCE_KRYLOV, _SPEC_TRI_WIN, _COMP_DET, _REC_TRI),
        eigenvalues=(_REDUCE_KRYLOV_NOQ, _SPEC_TRI_WIN),
        update=_UPDATE_CHAIN,
    ))
    register_composition(Composition(
        name="eei_krylov_si", method="eei_krylov_si", windowed=False,
        topk=(_REDUCE_SI, _SPEC_SI_WIN, _COMP_DET, _REC_TRI, _MAP_SI),
        eigenvalues=(_REDUCE_SI_NOQ, _SPEC_SI_WIN, _MAP_SI_EIG),
        update=_UPDATE_CHAIN,
    ))


register_default_backends()
register_default_compositions()
