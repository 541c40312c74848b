"""Run ``chip_smoke.py``'s sharded phase (13) alone on one card.

    python3 tools/sharded_phase.py

Builds (or loads) the kernel library, runs phase 3 (the engine on the
``cuda`` backend, whose results the 1x1 mesh must reproduce bitwise) and
then phase 13: the engine on 1x1 and logical 2x1 meshes of the card, a
session on the 2x1 plan, ``EeiServer(mesh=)`` on the mixed stream, the
minor and term axes on a logical 1x2 mesh, and the paper's component
ladder.  It exits non-zero if a check fails.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    dev = torch.device("cuda")
    stack = smoke._stack(torch, dev)
    _, results = smoke._phase_engine(torch, dev, stack)
    launches = smoke._phase_sharded(torch, dev, stack, results,
                                    {key: [] for key in smoke._PLAINS})
    print(f"[sharded] launches by run: {launches}")
    print("nvidia-smi: " + smoke._gpu_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
