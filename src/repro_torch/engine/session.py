"""SpectralSession: streaming maintenance of a top-k window.

The twin of ``repro.engine.session``.  A covariance or Gram matrix drifts
by rank-1 updates ``A <- A + sign * u u^T`` and the caller wants the same
top-k window back after every step.  A session keeps, on the engine's
device:

* the current matrix ``a``;
* a retained Ritz window ``basis (m_keep, n)`` / ``theta (m_keep,)``, the
  ``m_keep = k + buffer`` extremal eigenpairs of the last solve;
* a **drift monitor**: accumulated ``|rho| / ||A||_F`` since the last full
  solve, an update-count cadence cap, and the verify flags of every fast
  update.

The fast path is the engine's ``update`` program (``backends._UPDATE_CHAIN``):
project the updated matrix onto the retained basis plus the update direction
and a few Lanczos extensions, tridiagonalize the small compression, bisect
its spectrum from warm brackets (on the ``cuda`` backend: the segmented
Sturm kernel) and recover vectors through the minor-determinant and sign
stages.  Any of the monitor's three triggers (drift past ``drift_bound``, a
failed verify, ``max_updates`` updates since the last solve) forces a full
re-solve through ``engine.topk``, so every answer is either verified against
the updated matrix or freshly solved.  :func:`host_reseed` is the last rung:
float64 LAPACK ``eigh`` on the host when a re-solve itself fails verify.

Spans and counters (``repro_torch.tracing``): ``session/fast`` around an
update's fast path, from the norm read to the state commit (or to the
monitor's call for a re-solve), and ``session/resolve`` around each full
re-solve, its host verify and host reseed included; ``session_fast_update``
at each fast commit, ``session_resolve`` at each re-solve of any cause but
``open``, ``session_host_reseed`` at each host reseed, and ``host_sync`` at
each wait: the norm's read, the verify flag's read, each copy to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.engine.verify import verify_topk_host
from repro_torch.tracing import count, span


class SessionVerifyError(RuntimeError):
    """A session's full re-solve failed verification even on the host: the
    matrix itself is pathological (non-finite, or not symmetric)."""


class Rank1Update(NamedTuple):
    """One symmetric rank-1 perturbation ``A <- A + sign * u u^T``."""

    u: np.ndarray
    sign: int = 1


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """A session's knobs.

    ``buffer``       Ritz pairs retained beyond ``k``, so that eigenvalues
                     can rotate into the window between full solves.
    ``ext``          Lanczos extension directions appended per update,
                     beyond the update direction itself.
    ``drift_bound``  accumulated ``sum |rho_i| / ||A||_F`` since the last
                     full solve that forces a re-solve.
    ``max_updates``  fast updates allowed between full solves.
    ``verify``       check the update program's verify flags on the host
                     after every fast update.
    """

    buffer: int = 4
    ext: int = 3
    drift_bound: float = 0.25
    max_updates: int = 128
    verify: bool = True

    def __post_init__(self):
        if self.buffer < 0:
            raise ValueError(f"buffer must be >= 0, got {self.buffer}")
        if self.ext < 0:
            raise ValueError(f"ext must be >= 0, got {self.ext}")
        if self.drift_bound <= 0:
            raise ValueError(
                f"drift_bound must be > 0, got {self.drift_bound}")
        if self.max_updates < 1:
            raise ValueError(
                f"max_updates must be >= 1, got {self.max_updates}")


class SpectralSession:
    """Mutable session state; open one with ``SolverEngine.open_session``.
    Not thread-safe."""

    def __init__(self, k: int, largest: bool, config: SessionConfig, n: int,
                 m_keep: int, n_aug: int, dtype: torch.dtype,
                 device: torch.device):
        self.k = k
        self.largest = largest
        self.config = config
        self.n = n
        self.m_keep = m_keep
        self.n_aug = n_aug
        self.dtype = dtype
        self.device = device
        # Device state, refreshed by every update and re-solve.
        self.a: Optional[torch.Tensor] = None
        self.basis: Optional[torch.Tensor] = None  # (m_keep, n)
        self.theta: Optional[torch.Tensor] = None  # (m_keep,)
        self.lam: Optional[torch.Tensor] = None  # (k,)
        self.vecs: Optional[torch.Tensor] = None  # (k, n)
        # Drift monitor.
        self.scale = 0.0  # ||A||_F at the last full solve
        self.drift = 0.0  # sum |rho| / scale since the last full solve
        self.updates_since_resolve = 0
        # Counters.
        self.updates_total = 0
        self.fast_updates = 0
        self.full_resolves = 0
        self.resolves_by_cause: dict = {}

    def result(self):
        """The current top-k window as a ``TopkResult``."""
        from repro_torch.engine.engine import TopkResult

        return TopkResult(self.lam, self.vecs)

    def stats(self) -> dict:
        return {
            "k": self.k, "n": self.n, "m_keep": self.m_keep,
            "updates_total": self.updates_total,
            "fast_updates": self.fast_updates,
            "full_resolves": self.full_resolves,
            "resolves_by_cause": dict(self.resolves_by_cause),
            "drift": self.drift,
            "updates_since_resolve": self.updates_since_resolve,
        }


def _plan_dtype(plan) -> torch.dtype:
    """The plan's precision, or float32 where it names none."""
    return {"float32": torch.float32, "float64": torch.float64,
            None: torch.float32}[plan.precision]


def _host(x: torch.Tensor) -> np.ndarray:
    """``x`` copied to the host: on the card the host waits for it."""
    count("host_sync")
    return x.detach().cpu().numpy()


def open_session(engine, a, k: int, largest: bool = True,
                 config: Optional[SessionConfig] = None) -> SpectralSession:
    """Seed a session with a full solve of the ``m_keep`` retained window."""
    cfg = config if config is not None else SessionConfig()
    dtype = _plan_dtype(engine.plan)
    a = torch.as_tensor(a, dtype=dtype, device=engine.device)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected one (n, n) matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for n={n}")
    m_keep = min(n, k + cfg.buffer)
    # u plus `ext` Lanczos extensions, clipped so that the augmented frame
    # never exceeds n (m_keep == n: the basis is the whole space).
    n_aug = min(n - m_keep, 1 + cfg.ext)
    session = SpectralSession(int(k), bool(largest), cfg, n, m_keep, n_aug,
                              dtype, a.device)
    _full_resolve(engine, session, a, cause="open")
    return session


def _slice_window(session, lam_m, vecs_m):
    k = session.k
    if session.largest:
        return lam_m[..., -k:], vecs_m[..., -k:, :]
    return lam_m[..., :k], vecs_m[..., :k, :]


def _host_eigh_window(session, a_new):
    """Last-rung exact solve: float64 LAPACK eigh on the host."""
    from repro_torch.engine.engine import TopkResult

    lam, v = np.linalg.eigh(_host(a_new).astype(np.float64))
    m = session.m_keep
    if session.largest:
        lam, v = lam[-m:], v[:, -m:]
    else:
        lam, v = lam[:m], v[:, :m]
    as_t = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x), dtype=session.dtype, device=session.device)
    return TopkResult(as_t(lam), as_t(v.T))


def _commit_resolve(session, a_new, res, cause: str) -> None:
    """Install a fresh full-solve window and reset the drift monitor."""
    session.a = a_new.to(session.dtype)
    session.basis = res.vectors
    session.theta = res.eigenvalues
    session.lam, session.vecs = _slice_window(
        session, res.eigenvalues, res.vectors)
    session.scale = float(np.linalg.norm(_host(a_new)))
    session.drift = 0.0
    session.updates_since_resolve = 0
    if cause != "open":
        count("session_resolve")
        session.full_resolves += 1
        session.resolves_by_cause[cause] = \
            session.resolves_by_cause.get(cause, 0) + 1


def host_reseed(session, a_new, cause: str = "degrade") -> None:
    """Rebuild the session on the host with float64 LAPACK ``eigh``: the
    terminal rung, usable when the engine's backend is broken.  Raises
    :class:`SessionVerifyError` only when even that window fails
    verification."""
    count("session_host_reseed")
    res = _host_eigh_window(session, a_new)
    flags = verify_topk_host(_host(a_new), _host(res.eigenvalues),
                             _host(res.vectors))
    if not bool(np.all(flags.ok)):
        raise SessionVerifyError(
            f"session host re-solve (cause={cause!r}) failed residual "
            "verification; the session matrix is pathological")
    _commit_resolve(session, a_new, res, cause)


def _full_resolve(engine, session, a_new, cause: str) -> None:
    """Rebuild the retained window from scratch and reset the monitor."""
    with span("session/resolve"):
        res = engine.topk(a_new, session.m_keep, session.largest)
        if session.config.verify:
            flags = verify_topk_host(_host(a_new), _host(res.eigenvalues),
                                     _host(res.vectors))
            if not bool(np.all(flags.ok)):
                # The plan's method missed tolerance on this matrix: escalate
                # to the host rather than surface a method artifact.
                host_reseed(session, a_new, cause)
                return
        _commit_resolve(session, a_new, res, cause)


def _pad_batch(engine, x: torch.Tensor) -> torch.Tensor:
    """Lift session state to the program's batch shape: one row, repeated
    up to the mesh's batch axis under a sharded plan."""
    return x[None].expand((engine.plan.batch_axis_size,) + x.shape)


def _normalize_deltas(delta):
    if isinstance(delta, Rank1Update):
        return [delta]
    if isinstance(delta, tuple) and len(delta) == 2 and \
            np.ndim(delta[1]) == 0:
        return [Rank1Update(delta[0], int(delta[1]))]
    if isinstance(delta, list) or (
            isinstance(delta, Sequence) and not hasattr(delta, "shape")):
        out = []
        for item in delta:
            out.extend(_normalize_deltas(item))
        return out
    return [Rank1Update(delta, 1)]


def apply_update(engine, session: SpectralSession,
                 delta: Union[Rank1Update, tuple, Sequence, np.ndarray]):
    """Apply rank-1 update(s) to a session and return the refreshed window.
    A rank-r update is r rank-1 updates in turn, each verified."""
    if session.a is None:
        raise ValueError("session is not seeded; use engine.open_session")
    for upd in _normalize_deltas(delta):
        _apply_rank1(engine, session, upd)
    return session.result()


def _apply_rank1(engine, session, upd: Rank1Update) -> None:
    from repro_torch.engine.engine import update_program

    cfg = session.config
    sign = int(upd.sign)
    if sign not in (-1, 1):
        raise ValueError(f"sign must be +1 or -1, got {upd.sign}")
    u = torch.as_tensor(upd.u, dtype=session.dtype, device=session.device)
    if tuple(u.shape) != (session.n,):
        raise ValueError(f"expected update vector of shape ({session.n},), "
                         f"got {tuple(u.shape)}")
    with span("session/fast"):
        nrm2_t = torch.dot(u, u)
        count("host_sync")
        nrm2 = float(nrm2_t)
        if not np.isfinite(nrm2):
            raise ValueError("update vector is not finite")
        session.updates_total += 1
        if nrm2 == 0.0:
            return  # A + 0 = A: nothing to do, nothing drifts
        rho = sign * nrm2
        new_drift = session.drift + abs(rho) / max(session.scale, 1e-30)

        # Drift monitor, legs 1 and 2: accumulated movement and cadence.
        if new_drift > cfg.drift_bound or \
                session.updates_since_resolve + 1 > cfg.max_updates:
            cause = "drift" if new_drift > cfg.drift_bound else "cadence"
            a_new = session.a + (sign * u)[:, None] * u[None, :]
        else:
            # Fast path: the warm-started update program on a batch of one,
            # lifted to the mesh's batch axis under a sharded plan; row 0 is
            # the session's.
            prog = update_program(engine.plan, session.k, session.largest,
                                  session.m_keep, session.n_aug)
            u_hat = u / torch.sqrt(nrm2_t)
            padded = [_pad_batch(engine, x) for x in
                      (session.a, session.basis, session.theta, u_hat)]
            rho_t = torch.full((padded[0].shape[0],), rho,
                               dtype=session.dtype, device=session.device)
            result, flags, a_new, basis, theta = prog(*padded, rho_t)

            # Drift monitor, leg 3: verification of the fast answer.
            verified = True
            if cfg.verify:
                count("host_sync")
                verified = bool(flags.ok[0])
            if not verified:
                cause, a_new = "verify", a_new[0]
            else:
                session.a = a_new[0]
                session.basis = basis[0]
                session.theta = theta[0]
                session.lam = result.eigenvalues[0]
                session.vecs = result.vectors[0]
                session.drift = new_drift
                session.updates_since_resolve += 1
                session.fast_updates += 1
                count("session_fast_update")
                return
    # A re-solve runs outside the fast path's span, in its own.
    _full_resolve(engine, session, a_new, cause=cause)
