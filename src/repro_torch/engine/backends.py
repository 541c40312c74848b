"""Default stage libraries (reference, torch, cuda) and compositions.

    reference   straightforward PyTorch: unfused log-space sums and the
                plain Sturm bisection.  The oracle the others are held to.
    torch       the fused-reduction twin of ``repro``'s ``jnp`` backend: the
                numerator and denominator sums written as contractions with
                a ones-vector (``identity.*_dot``).
    cuda        the hand-written kernels: Sturm bisection (full spectrum,
                k-window and all stacked minor bands, one launch each), the
                segmented Sturm bisection (the k-windows of every segment of
                packed rows, and warm per-lane brackets in the session
                update) and the prod-diff numerator table.  On CPU tensors
                the kernel wrappers run their plain versions.

The Householder reduce, the minor-determinant recurrence and the sign
recurrence are plain PyTorch on every backend, as ``repro`` leaves them to
``jnp``.

Compositions registered here:

    eigh                  ``torch.linalg.eigh`` (the oracle / small-n path)
    eei_tridiag           Householder -> Sturm -> minor Sturm -> full EEI
                          table -> recurrence signs + back-transform
    eei_tridiag_windowed  Householder -> k-window Sturm -> minor-determinant
                          components -> recurrence signs + back-transform

``eigh`` and ``eei_tridiag_windowed`` also carry a ``packed_topk`` chain
for stacks of segment-packed block-diagonal rows: one ``eigh`` of each row
and a per-slot selection by in-segment mass, or Householder -> segmented
Sturm (each segment's k-window) -> minor-determinant components ->
recurrence signs + back-transform -> per-slot reshape.  Each of them also
carries the streaming rank-1 ``update`` chain
(``_UPDATE_CHAIN``): warm-project reduce -> bracketed Sturm ->
minor-determinant components -> recurrence signs -> update select.
``eei_dense``, ``eei_krylov`` and ``eei_krylov_si`` wait for ROADMAP queue
1, item 8.
"""

from __future__ import annotations

import torch

from repro_torch.core import identity, minors
from repro_torch.core.directions import tridiagonal_signs
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


def _dense_eigenvalues(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.eigvalsh(a)


def _common_stages() -> dict:
    """Stages every backend shares: the reduce, the minor determinants, the
    sign recurrence and the dense eigenvalues of the eigh chain."""
    return {
        "tridiagonalize": householder.tridiagonalize,
        "dense_eigenvalues": _dense_eigenvalues,
        "minor_det_components": identity.tridiag_windowed_magnitudes,
        "tridiag_signs": tridiagonal_signs,
        "verify_topk": verify_topk,
        "verify_topk_packed": verify_topk_packed,
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

    return StageLibrary(name, {
        **_common_stages(),
        "tridiag_eigenvalues": tridiag_eigenvalues,
        "tridiag_eigenvalues_windowed": tridiag_eigenvalues_windowed,
        "tridiag_eigenvalues_bracketed": tridiag_eigenvalues_bracketed,
        "tridiag_eigenvalues_segmented": tridiag_eigenvalues_segmented,
        "tridiag_minor_spectra": tridiag_minor_spectra,
        "magnitudes": magnitudes,
    })


def make_reference_backend(plan: SolverPlan) -> StageLibrary:
    return _make_plain("reference", "sum", plan)


def make_torch_backend(plan: SolverPlan) -> StageLibrary:
    return _make_plain("torch", "dot", plan)


def make_cuda_backend(plan: SolverPlan) -> StageLibrary:
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
        **_common_stages(),
        "tridiag_eigenvalues": tridiag_eigenvalues,
        "tridiag_eigenvalues_windowed": tridiag_eigenvalues_windowed,
        "tridiag_eigenvalues_bracketed": tridiag_eigenvalues_bracketed,
        "tridiag_eigenvalues_segmented": tridiag_eigenvalues_segmented,
        "tridiag_minor_spectra": tridiag_minor_spectra,
        "magnitudes": pd_ops.eei_magnitudes_batched,
    })


def register_default_backends() -> None:
    register_backend("reference", make_reference_backend)
    register_backend("torch", make_torch_backend)
    register_backend("cuda", make_cuda_backend)


# Shared stage signatures.
_REDUCE = StageSig("reduce", "householder", ("a",), ("d", "e", "q"))
_REDUCE_NOQ = StageSig("reduce", "householder", ("a",), ("d", "e"))
_SPEC_DENSE = StageSig("spectrum", "dense_eigenvalues", ("a",), ("lam",))
_SPEC_TRI = StageSig("spectrum", "tridiag_full", ("d", "e"), ("lam",))
_SPEC_TRI_WIN = StageSig(
    "spectrum", "tridiag_windowed", ("d", "e"), ("lam_sel",))
_MINORS_TRI = StageSig("minor_spectra", "tridiag_minors", ("d", "e"), ("mu",))
_COMP_FULL = StageSig("components", "eei_full", ("lam", "mu"), ("mags",))
_COMP_SELECT = StageSig(
    "components", "eei_select", ("lam", "mu", "idx"), ("lam_sel", "mag_sel"))
_COMP_DET = StageSig(
    "components", "minor_det", ("d", "e", "lam_sel"), ("mag_sel",))
_REC_TRI = StageSig(
    "recover", "tridiag_signs", ("d", "e", "q", "lam_sel", "mag_sel"),
    ("vecs",))
_REC_TRI_SOLVE = StageSig(
    "recover", "tridiag_solve", ("d", "e", "q", "lam", "mags"), ("mags",))
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


register_default_backends()
register_default_compositions()
