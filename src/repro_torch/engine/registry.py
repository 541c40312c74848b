"""Stage-graph registry: the single dispatch point of the EEI pipeline.

The twin of ``repro.engine.registry`` for the five program kinds the port
runs (``solve``, ``topk``, ``eigenvalues``, ``packed_topk``, ``update``):

* a **stage library** per backend (:class:`StageLibrary`), a named bundle
  of batched stage implementations;
* **compositions** (:class:`Composition`): named stage chains
  ``reduce -> spectrum -> [minor_spectra] -> components -> recover`` per
  program kind, each stage declaring the state keys it ``requires`` and
  ``provides``, validated at registration.  The engine appends the
  ``verify`` role to a chain when the caller asks for verified output.

State keys: ``a (b, n, n)``, ``idx (k,)``, ``d, e, q`` (reduce), ``lam
(b, n)``, ``lam_sel (b, k)``, ``mu (b, n, n-1)``, ``mags (b, n, n)``,
``mag_sel (b, k, n)``, ``v (b, n, n)`` (eigh only), ``vecs (b, k, n)``,
``flags`` (verify); and for ``update``: ``basis (b, m, n)``, ``theta (b,
m)`` (the session's retained Ritz pairs), ``u (b, n)`` (the unit update
direction), ``rho (b,)`` (its signed squared norm) and ``z2 (b, m)`` (its
squared coefficients on the retained frame); and for ``packed_topk``:
``seg_off, seg_len (b, S)`` int32 (each row's segment start columns and
lengths, 0 for an empty slot), ``lam_seg (b, S, k)`` (per-slot windows,
ascending per slot) and ``vecs_seg (b, S, k, n)`` (per-slot vectors over
the full row width).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.engine.plan import SolverPlan

#: Stage roles in pipeline order; a chain may skip roles, not reorder them.
#: ``verify`` consumes the final state and provides per-matrix flags.
STAGE_ROLES = (
    "reduce", "spectrum", "minor_spectra", "components", "recover", "verify")

PROGRAM_KINDS = ("solve", "topk", "eigenvalues", "packed_topk", "update")
_INITIAL_KEYS = {
    "solve": frozenset({"a"}),
    "topk": frozenset({"a", "idx"}),
    "eigenvalues": frozenset({"a", "idx"}),
    # a stack of block-diagonal rows, each carrying up to S requests
    "packed_topk": frozenset({"a", "seg_off", "seg_len"}),
    # ``a`` is the already-updated stack.
    "update": frozenset({"a", "basis", "theta", "u", "rho", "idx"}),
}
_FINAL_KEYS = {
    "solve": ({"lam", "mags"},),
    "topk": ({"lam_sel", "vecs"},),
    # windowed eigenvalue chains end at the window, full ones at the spectrum
    "eigenvalues": ({"lam"}, {"lam_sel"}),
    "packed_topk": ({"lam_seg", "vecs_seg"},),
    # the refreshed session state rides out with the answer
    "update": ({"lam_sel", "vecs", "basis", "theta"},),
}


@dataclasses.dataclass(frozen=True)
class StageSig:
    """One stage of a chain: role, implementation name and dataflow keys."""

    role: str
    name: str
    requires: Tuple[str, ...]
    provides: Tuple[str, ...]

    def __post_init__(self):
        if self.role not in STAGE_ROLES:
            raise ValueError(
                f"unknown stage role {self.role!r}; expected one of "
                f"{STAGE_ROLES}")


@dataclasses.dataclass(frozen=True)
class Composition:
    """A named, validated stage chain per program kind.

    Every chain but ``topk`` may be ``None``: a windowed composition has no
    full-table solve, and the engine then takes the method's full one.
    """

    name: str
    method: str
    windowed: bool
    topk: Tuple[StageSig, ...]
    solve: Optional[Tuple[StageSig, ...]] = None
    eigenvalues: Optional[Tuple[StageSig, ...]] = None
    packed_topk: Optional[Tuple[StageSig, ...]] = None
    update: Optional[Tuple[StageSig, ...]] = None

    def chain(self, kind: str) -> Optional[Tuple[StageSig, ...]]:
        if kind not in PROGRAM_KINDS:
            raise ValueError(f"unknown program kind {kind!r}")
        return getattr(self, kind)

    def validate(self) -> None:
        """Check every chain for role order and dataflow: each stage's
        ``requires`` is provided upstream (or by the kind's initial state)
        and the final state carries the kind's outputs."""
        for kind in PROGRAM_KINDS:
            chain = self.chain(kind)
            if chain is None:
                continue
            have = set(_INITIAL_KEYS[kind])
            last_role = -1
            for sig in chain:
                role_i = STAGE_ROLES.index(sig.role)
                if role_i < last_role:
                    raise ValueError(
                        f"composition {self.name!r} ({kind}): stage "
                        f"{sig.name!r} role {sig.role!r} out of order")
                last_role = role_i
                missing = set(sig.requires) - have
                if missing:
                    raise ValueError(
                        f"composition {self.name!r} ({kind}): stage "
                        f"{sig.name!r} requires {sorted(missing)} not "
                        f"provided upstream (have {sorted(have)})")
                have |= set(sig.provides)
            if not any(alt <= have for alt in _FINAL_KEYS[kind]):
                raise ValueError(
                    f"composition {self.name!r} ({kind}): final state "
                    f"{sorted(have)} provides none of "
                    f"{[sorted(a) for a in _FINAL_KEYS[kind]]}")


class StageLibrary:
    """Named bundle of batched stage implementations for one backend;
    stages are reachable as attributes (``lib.tridiagonalize``)."""

    def __init__(self, name: str, stages: Dict[str, Callable]):
        self.name = name
        self._stages = dict(stages)

    def __getattr__(self, key: str) -> Callable:
        try:
            return self._stages[key]
        except KeyError:
            raise AttributeError(
                f"backend {self.name!r} has no stage {key!r}; available: "
                f"{sorted(self._stages)}") from None


BackendFactory = Callable[[SolverPlan], StageLibrary]

_REGISTRY: Dict[str, BackendFactory] = {}
_COMPOSITIONS: Dict[str, Composition] = {}
_BY_METHOD: Dict[Tuple[str, bool], str] = {}


def register_backend(name: str, factory: BackendFactory) -> None:
    """Register (or replace) the stage-library factory for ``name``."""
    _REGISTRY[name] = factory


def get_backend(plan: SolverPlan) -> StageLibrary:
    """Resolve ``plan.backend`` to its stage library."""
    try:
        factory = _REGISTRY[plan.backend]
    except KeyError:
        raise KeyError(
            f"no backend {plan.backend!r} registered; "
            f"available: {sorted(_REGISTRY)}") from None
    return factory(plan)


def available_backends() -> list:
    return sorted(_REGISTRY)


def register_composition(comp: Composition) -> None:
    """Validate and register (or replace) a composition."""
    comp.validate()
    _COMPOSITIONS[comp.name] = comp
    for key in [k for k, name in _BY_METHOD.items() if name == comp.name]:
        del _BY_METHOD[key]
    _BY_METHOD[(comp.method, comp.windowed)] = comp.name


def get_composition(name: str) -> Composition:
    """The composition registered under ``name``."""
    try:
        return _COMPOSITIONS[name]
    except KeyError:
        raise KeyError(
            f"no composition {name!r} registered; available: "
            f"{sorted(_COMPOSITIONS)}") from None


def available_compositions() -> list:
    return sorted(_COMPOSITIONS)


def composition_for(method: str, windowed: bool = False) -> Composition:
    """The composition serving ``method`` (its windowed variant if asked and
    registered, else its full one)."""
    name = _BY_METHOD.get((method, windowed))
    if name is None and windowed:
        name = _BY_METHOD.get((method, False))
    if name is None:
        raise KeyError(
            f"no composition registered for method {method!r}; "
            f"available: {sorted(_BY_METHOD)}")
    return _COMPOSITIONS[name]
