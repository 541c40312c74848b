"""Run ``chip_smoke.py``'s fleet phase (12) alone on one card.

    python3 tools/fleet_phase.py

If no kernel library is built yet for the current sources, two fresh
subprocess replicas build it at once (both at their first requests) and the
build directory must then hold one library and no half-built directory:
the check that concurrent first builds are safe.  Then it builds (or loads)
the library in this process, serves stream 1 through a threaded single
``EeiServer`` for the comparison line (phase 11's threaded run), and runs
phase 12.  About two minutes on an H100; it exits non-zero if a check
fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402


def _fresh_build_by_two_workers(torch, build):
    """Two subprocess workers build the library concurrently; returns the
    seconds until both answered, or None when a library already exists."""
    from repro_torch.engine import EeiFleet
    from repro_torch.engine.server import make_eei_stream
    from repro_torch.runtime import route_key

    if (build.library_dir() / build.LIB_NAME).is_file():
        return None
    stream = make_eei_stream(*smoke.SERVE_MIXED, seed=0, mixed=True)
    firsts = {}
    for a, k in stream:
        firsts.setdefault(route_key((a.shape[0], True), [0, 1],
                                    smoke.FLEET_SALT), (a, k))
    smoke.check(len(firsts) == 2, f"fresh build: owners {sorted(firsts)}")
    t0 = time.perf_counter()
    with EeiFleet(2, replica_mode="subprocess", salt=smoke.FLEET_SALT,
                  server_kwargs=dict(max_batch=smoke.SERVE_BATCH)) as fleet:
        futs = [fleet.submit(a, k) for a, k in firsts.values()]
        results = [f.result(timeout=smoke.SERVE_WAIT_S) for f in futs]
        stats = fleet.stats()
    wall = time.perf_counter() - t0
    smoke.check(stats["requests_failed"] == stats["replicas_killed"] == 0,
                f"fresh build: {stats}")
    smoke._check_requests(torch, torch.device("cuda"), list(firsts.values()),
                          results, "fresh build")
    entries = sorted(p.name for p in build.BUILD_ROOT.iterdir())
    smoke.check(entries == [build.library_dir().name],
                f"fresh build: {build.BUILD_ROOT} holds {entries}")
    return wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fleet_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.engine import EeiServer
    from repro_torch.engine.server import make_eei_stream
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    fresh = _fresh_build_by_two_workers(torch, build)
    print("[fleet] fresh build by two workers at once: " + (
        "a library existed already" if fresh is None else
        f"one library, no half-built directory; both answered in "
        f"{fresh:.3f} s"))
    build.library()
    dev = torch.device("cuda")
    stack = smoke._stack(torch, dev)
    stream = make_eei_stream(*smoke.SERVE_MIXED, seed=0, mixed=True)
    server = EeiServer(None, max_batch=smoke.SERVE_BATCH, verify=True,
                       linger_ms=smoke.SERVE_LINGER_MS)
    _, results, wall = smoke._serve_stream(server, stream, True)
    smoke._check_requests(torch, dev, stream, results, "single server")
    stats = server.stats()
    served = dict(known={key: [] for key in smoke._PLAINS},
                  single=dict(wall=wall, p50=stats["p50_latency_ms"],
                              p99=stats["p99_latency_ms"],
                              stacks=stats["stacks_dispatched"]))
    launches = smoke._phase_fleet(torch, dev, stack, served)
    print(f"[fleet] launches by part: {launches}")
    print("nvidia-smi: " + smoke._gpu_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
