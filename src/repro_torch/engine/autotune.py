"""Measured planner calibration: the method crossovers of one card.

The twin of ``repro.engine.autotune``.  The planner's crossovers (where
``eigh`` stops winning, where dense minors give way to the tridiagonal
path, where the windowed chain, the Krylov reduce and packing start to
win) depend on the hardware, so they are measured on it:

* :func:`calibrate` times the engine's top-k programs over a sweep of
  sizes and returns a :class:`CalibrationTable`;
* tables persist as JSON, per host under ``~/.cache/repro_torch/`` (or
  ``$REPRO_TORCH_CALIBRATION``), with a committed default
  (``calibration_default.json``, measured on an H100 by this module);
* :func:`get_table` is the process-wide table ``engine.plan``'s
  ``resolved_*`` functions read; the static constants of ``plan.py`` apply
  where no table resolves.

Resolution order: :func:`set_table` override > ``$REPRO_TORCH_CALIBRATION``
> ``~/.cache/repro_torch/calibration.json`` > the committed default.  The
cache and the committed default are skipped (with one warning) unless
their ``backend`` matches this process's (``cuda`` where a card is
visible, else ``cpu``), so a CPU process plans on the static constants.

Unlike ``repro``'s table this one carries no tile shapes
(``prod_diff_blocks``, ``sturm_blocks``, ``prod_diff_block_b``) and there
is no tile sweep: the port's CUDA kernels choose their launch geometry
from the shape (``kernels/sturm/kernel.py::_geometry``,
``_segmented_geometry``).  The backend-specific crossover pair is
``cuda_*`` (``repro``'s ``pallas_*``), and the windowed, Krylov and pack
sweeps time the ``cuda`` backend, the planner's default.  Regenerate with::

    PYTHONPATH=src python -m repro_torch.engine.autotune [--smoke] [--out PATH]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import platform
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.engine.plan import WINDOWED_K_FRAC

log = logging.getLogger("repro_torch.autotune")

CALIBRATION_ENV = "REPRO_TORCH_CALIBRATION"
CACHE_PATH = Path.home() / ".cache" / "repro_torch" / "calibration.json"
REPO_DEFAULT_PATH = Path(__file__).with_name("calibration_default.json")

#: ``repro``'s schema version 5 (crossovers, ``windowed_k_frac``,
#: ``krylov_n_min``, ``pack_n_max``, ``packed_eigh_n_max``), without tiles.
_SCHEMA_VERSION = 5


@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    """One card's measured pipeline constants (see the module docstring)."""

    eigh_crossover_n: int  # n at or below which eigh wins (torch backend)
    dense_crossover_n: int  # n up to which dense minors win (torch)
    cuda_eigh_crossover_n: Optional[int] = None  # None -> the torch value
    cuda_dense_crossover_n: Optional[int] = None  # None -> the torch value
    windowed_k_frac: float = WINDOWED_K_FRAC  # k/n the windowed chain wins
    krylov_n_min: Optional[int] = None  # n from which the Krylov reduce wins
    pack_n_max: Optional[int] = None  # largest request n worth packing
    packed_eigh_n_max: Optional[int] = None  # packed width eigh still wins
    host: str = ""  # host class the numbers were measured on
    backend: str = ""  # device type at measurement: cuda | cpu
    measured_at: str = ""  # ISO timestamp
    source: str = "memory"  # where the table was loaded from

    def crossovers_for(self, backend: Optional[str] = None) -> tuple:
        """``(eigh_crossover_n, dense_crossover_n)`` for a plan backend: the
        ``cuda`` pair where measured, else the ``torch`` pair."""
        if backend == "cuda" and self.cuda_eigh_crossover_n is not None:
            return (self.cuda_eigh_crossover_n,
                    self.cuda_dense_crossover_n
                    if self.cuda_dense_crossover_n is not None
                    else self.dense_crossover_n)
        return self.eigh_crossover_n, self.dense_crossover_n

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("source")
        d["schema_version"] = _SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict, source: str = "memory") -> "CalibrationTable":
        version = int(d.get("schema_version", _SCHEMA_VERSION))
        if version > _SCHEMA_VERSION:
            raise ValueError(
                f"calibration table schema_version {version} is newer than "
                f"this code understands ({_SCHEMA_VERSION})")
        if version < _SCHEMA_VERSION:
            _warn_once((source, version),
                       "calibration table %s has schema_version %d (current "
                       "%d); missing fields take the static fallbacks",
                       source, version, _SCHEMA_VERSION)

        def _opt_int(key):
            return int(d[key]) if d.get(key) is not None else None

        return cls(
            eigh_crossover_n=int(d["eigh_crossover_n"]),
            dense_crossover_n=int(d["dense_crossover_n"]),
            cuda_eigh_crossover_n=_opt_int("cuda_eigh_crossover_n"),
            cuda_dense_crossover_n=_opt_int("cuda_dense_crossover_n"),
            windowed_k_frac=float(d.get("windowed_k_frac", WINDOWED_K_FRAC)),
            krylov_n_min=_opt_int("krylov_n_min"),
            pack_n_max=_opt_int("pack_n_max"),
            packed_eigh_n_max=_opt_int("packed_eigh_n_max"),
            host=str(d.get("host", "")),
            backend=str(d.get("backend", "")),
            measured_at=str(d.get("measured_at", "")),
            source=source,
        )

    def save(self, path) -> Path:
        path = Path(path).expanduser()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2) + "\n")
        return path


#: Warnings already given in this process, by key: a table is re-loaded
#: freely, and one warning per source is enough.
_WARNED: set = set()


def _warn_once(key, msg: str, *args) -> None:
    if key in _WARNED:
        return
    _WARNED.add(key)
    log.warning(msg, *args)


def process_backend() -> str:
    """``cuda`` where this process sees a card, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def host_key(device=None) -> str:
    """Host class a calibration is keyed on: machine, device type and the
    card's name."""
    device = torch.device(device or process_backend())
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return f"{platform.machine()}-{device.type}-{kind}"


def load_table(path: Optional[os.PathLike] = None
               ) -> Optional[CalibrationTable]:
    """Load a table from ``path`` or the resolution chain (None if absent).

    An explicit ``path`` or ``$REPRO_TORCH_CALIBRATION`` is trusted as it is
    and must exist.  The user cache and the committed default are skipped,
    with one warning, unless their ``backend`` matches this process's.
    """
    candidates = []  # (path, source, explicit)
    if path is not None:
        candidates.append((Path(path), f"file:{path}", True))
    else:
        env = os.environ.get(CALIBRATION_ENV)
        if env:
            candidates.append((Path(env), f"env:{env}", True))
        candidates.append((CACHE_PATH, f"cache:{CACHE_PATH}", False))
        candidates.append((REPO_DEFAULT_PATH, "repo-default", False))
    for cand, source, explicit in candidates:
        cand = cand.expanduser()
        if not cand.is_file():
            if explicit:
                raise FileNotFoundError(f"calibration table not found: {cand}")
            continue
        try:
            table = CalibrationTable.from_dict(json.loads(cand.read_text()),
                                               source=source)
        except (json.JSONDecodeError, KeyError, ValueError) as exc:
            raise ValueError(f"malformed calibration table {cand}: {exc}")
        here = process_backend()
        if not explicit and table.backend and table.backend != here:
            _warn_once((source, "backend-mismatch", table.backend),
                       "calibration table %s was measured on backend %r but "
                       "this process runs %r; skipping it (planning falls "
                       "back to the next candidate or the static constants)",
                       source, table.backend, here)
            continue
        return table
    return None


# The process-wide table, resolved at the first lookup.  ``set_table``
# overrides it; ``set_table(None)`` resolves it again at the next lookup.
_ACTIVE: Optional[CalibrationTable] = None
_RESOLVED = False


def set_table(table: Optional[CalibrationTable]) -> None:
    global _ACTIVE, _RESOLVED
    _ACTIVE = table
    _RESOLVED = table is not None


def get_table() -> Optional[CalibrationTable]:
    """The active calibration table, or None (static fallbacks)."""
    global _ACTIVE, _RESOLVED
    if not _RESOLVED:
        _ACTIVE = load_table()
        _RESOLVED = True
    return _ACTIVE


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, repeat: int = 3, warmup: int = 1,
          device=torch.device("cpu")) -> float:
    """Mean wall seconds a call (after warm-up), synchronizing the card
    around the timed calls."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / repeat


def _sym_stack(b: int, n: int, device, seed: int = 0) -> torch.Tensor:
    """Seeded float32 stack of ``b`` symmetric ``n x n`` matrices."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n)).astype(np.float32)
    return torch.as_tensor((a + np.swapaxes(a, 1, 2)) / 2, device=device)


def _engine(device, **plan):
    from repro_torch.engine.engine import SolverEngine
    from repro_torch.engine.plan import SolverPlan

    return SolverEngine(SolverPlan(**plan), device=device)


def _measure_crossovers(sizes: Sequence[int], k: int, batch: int,
                        backend: str, device) -> tuple:
    """Smallest swept ``n`` where each EEI method beats its cheaper
    alternative on a batched top-k, recorded as the size before it (the
    planner routes ``n <= crossover`` to the cheaper method); the last size
    where none did.  The ``eigh`` leg is ``torch.linalg.eigh`` whatever the
    backend."""
    eigh_x = dense_x = None
    prev_n = max(sizes[0] - 1, 0)
    for n in sizes:
        a = _sym_stack(batch, n, device)
        times = {}
        for method in ("eigh", "eei_dense", "eei_tridiag"):
            eng = _engine(device, method=method, backend=backend)
            times[method] = _time(lambda eng=eng: eng.topk(a, k),
                                  device=device)
        best_eei = min(times["eei_dense"], times["eei_tridiag"])
        if eigh_x is None and best_eei < times["eigh"]:
            eigh_x = prev_n
        if dense_x is None and times["eei_tridiag"] < times["eei_dense"]:
            dense_x = prev_n
        prev_n = n
    return (eigh_x if eigh_x is not None else sizes[-1],
            dense_x if dense_x is not None else sizes[-1])


def _measure_windowed_crossover(n: int, batch: int, ks: Sequence[int],
                                device, backend: str = "cuda") -> float:
    """Largest swept ``k / n`` where the windowed tridiagonal chain still
    beats the full one on a batched top-k; 0.0 if it never does."""
    a = _sym_stack(batch, n, device)
    full = _engine(device, method="eei_tridiag", backend=backend)
    win = _engine(device, method="eei_tridiag", backend=backend,
                  spectrum="windowed")
    frac = 0.0
    for k in ks:
        if k > n:
            break
        t_full = _time(lambda: full.topk(a, k), device=device)
        t_win = _time(lambda: win.topk(a, k), device=device)
        if t_win < t_full:
            frac = k / n
        else:
            break  # windowed work grows with k: the first loss ends it
    return frac


#: ``krylov_n_min`` recorded when the Krylov reduce never won the sweep:
#: far above any real n, so the planner never routes through it.
KRYLOV_NEVER = 1 << 30


def _measure_krylov_crossover(sizes: Sequence[int], k: int, batch: int,
                              device, backend: str = "cuda") -> int:
    """Smallest swept ``n`` where the Krylov reduce beats the dense
    Householder reduce on a windowed batched top-k, or
    :data:`KRYLOV_NEVER`."""
    for n in sizes:
        if not 0 < k < n:
            continue
        a = _sym_stack(batch, n, device)
        dense = _engine(device, method="eei_tridiag", backend=backend,
                        spectrum="windowed")
        krylov = _engine(device, method="eei_krylov", backend=backend)
        t_dense = _time(lambda: dense.topk(a, k), device=device)
        t_krylov = _time(lambda: krylov.topk(a, k), device=device)
        if t_krylov < t_dense:
            return n
    return KRYLOV_NEVER


def _packed_uniform_layout(batch: int, row_n: int, seg_n: int, device):
    """A uniform packed stack: ``row_n // seg_n`` requests a row; returns
    the requests ``(batch * slots, seg_n, seg_n)``, the rows, and the
    layout ``off``, ``length`` ``(batch, slots)``."""
    slots = row_n // seg_n
    a = _sym_stack(batch * slots, seg_n, "cpu").numpy()
    rows = np.zeros((batch, row_n, row_n), np.float32)
    for b in range(batch):
        for s in range(slots):
            o = s * seg_n
            rows[b, o:o + seg_n, o:o + seg_n] = a[b * slots + s]
    off = np.tile(np.arange(slots, dtype=np.int32) * seg_n, (batch, 1))
    length = np.full((batch, slots), seg_n, np.int32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (a, rows, off, length))


def _measure_pack_crossovers(row_ns: Sequence[int], seg_ns: Sequence[int],
                             batch: int, k: int, device,
                             backend: str = "cuda") -> tuple:
    """``(pack_n_max, packed_eigh_n_max)`` on uniform packed rows.

    ``pack_n_max``: the largest segment ``n`` where one packed call of the
    eigh chain beats serving the same requests as ``slots`` separate
    bucketed top-k calls (0 when packing never wins).
    ``packed_eigh_n_max``: the largest swept row width where the packed
    eigh chain still beats the packed windowed tridiagonal chain.
    """
    from repro_torch.engine.engine import packed_topk_program, topk_program
    from repro_torch.engine.plan import SolverPlan

    eigh_plan = SolverPlan(method="eigh", backend=backend)
    row0 = row_ns[0]
    pack_n_max = 0
    for seg_n in seg_ns:
        if seg_n * 2 > row0:
            break
        a, rows, off, length = _packed_uniform_layout(batch, row0, seg_n,
                                                      device)
        slots = row0 // seg_n
        chunks = [a[s * batch:(s + 1) * batch] for s in range(slots)]
        bucketed = topk_program(eigh_plan, k, True)
        packed = packed_topk_program(eigh_plan, k, True)
        t_b = _time(lambda: [bucketed(c) for c in chunks], device=device)
        t_p = _time(lambda: packed(rows, off, length), device=device)
        if t_p < t_b:
            pack_n_max = seg_n
    seg_n = max(seg_ns[0], 8)
    packed_eigh_n_max = row_ns[-1]
    prev = max(row_ns[0] // 2, seg_n * 2)
    tri_plan = SolverPlan(method="eei_tridiag", backend=backend,
                          spectrum="windowed")
    for row_n in row_ns:
        _, rows, off, length = _packed_uniform_layout(batch, row_n, seg_n,
                                                      device)
        t_eigh = _time(lambda: packed_topk_program(eigh_plan, k, True)(
            rows, off, length), device=device)
        t_tri = _time(lambda: packed_topk_program(tri_plan, k, True)(
            rows, off, length), device=device)
        if t_tri < t_eigh:
            packed_eigh_n_max = prev  # the last width where eigh still won
            break
        prev = row_n
    return pack_n_max, packed_eigh_n_max


def calibrate(*, smoke: bool = False, batch: int = 16, k: int = 4,
              device=None) -> CalibrationTable:
    """Measure the crossovers on ``device`` (the card by default) and return
    the table.  ``smoke`` shrinks every sweep to a sanity pass."""
    from repro_torch.engine.engine import _resolve_device

    device = _resolve_device(device)
    if smoke:
        sizes = [8, 16, 32]
        win_n, win_ks = 32, (1, 4, 16, 32)
        krylov_sizes, krylov_k, krylov_b = [64, 128], 4, 2
        pack_rows, pack_segs, pack_b = [32, 64], (8, 16), 2
    else:
        sizes = [8, 16, 24, 32, 48, 64, 96, 128]
        win_n, win_ks = 64, (1, 2, 4, 8, 16, 32, 64)
        krylov_sizes, krylov_k, krylov_b = [256, 512, 1024], 8, 2
        pack_rows, pack_segs, pack_b = [64, 128, 256], (8, 16, 32), 4
    eigh_x, dense_x = _measure_crossovers(sizes, k, batch, "torch", device)
    cuda_eigh_x, cuda_dense_x = _measure_crossovers(sizes, k, batch, "cuda",
                                                    device)
    windowed_frac = _measure_windowed_crossover(win_n, batch, win_ks, device)
    krylov_n_min = _measure_krylov_crossover(krylov_sizes, krylov_k,
                                             krylov_b, device)
    pack_n_max, packed_eigh_n_max = _measure_pack_crossovers(
        pack_rows, pack_segs, pack_b, k, device)
    return CalibrationTable(
        eigh_crossover_n=int(eigh_x),
        dense_crossover_n=int(dense_x),
        cuda_eigh_crossover_n=int(cuda_eigh_x),
        cuda_dense_crossover_n=int(cuda_dense_x),
        windowed_k_frac=float(windowed_frac),
        krylov_n_min=int(krylov_n_min),
        pack_n_max=int(pack_n_max),
        packed_eigh_n_max=int(packed_eigh_n_max),
        host=host_key(device),
        backend=device.type,
        measured_at=time.strftime("%Y-%m-%dT%H:%M:%S"),
        source="measured",
    )


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="a small sweep (a sanity pass, not a calibration)")
    ap.add_argument("--out", default=str(CACHE_PATH),
                    help="where to write the table (default: user cache)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    table = calibrate(smoke=args.smoke, batch=args.batch, k=args.k)
    seconds = time.perf_counter() - t0
    path = table.save(Path(args.out))
    print(json.dumps(table.to_dict(), indent=2))
    print(f"sweep took {seconds:.1f} s; wrote {path}")


if __name__ == "__main__":
    main()
